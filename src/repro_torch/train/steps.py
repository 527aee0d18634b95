"""Train-step builder: loss, grads, optimizer update.  Port of
``repro.train.steps``.

``train_step(state, batch)`` takes the state of ``init_train_state``,
``{"params": the model, "opt": the optimizer state, "step": int32 0-d}``,
and returns it updated in place with the step's metrics.  Gradient
accumulation runs the loss over the microbatches one after another, adds
their grads (``.grad`` accumulates across the backward passes, in each
parameter's dtype, as the reference's ``jnp.add``) and divides the sum by
``grad_accum``.  The reference's ``optimization_barrier`` (keeping one
microbatch's activations from overlapping the next's) and ``grad_shardings``
(a ZeRO layout constraint) have no eager counterpart and need none: eager
execution finishes microbatch i's backward before microbatch i+1's forward
begins, and one device has nothing to shard.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import forward_train, init_params
from repro_torch.models.losses import softmax_xent
from repro_torch.optim import Optimizer

AUX_COEF = 0.01  # MoE load-balance coefficient


def init_train_state(generator, cfg: ModelConfig, optimizer: Optimizer,
                     device="cuda", params=None) -> dict:
    """Random params from ``generator`` on ``device`` (or the given model
    ``params``, where they are) with gradients on, the optimizer's state and
    step 0 beside them."""
    if params is None:
        params = init_params(cfg, generator, device=resolve_device(device))
    model = params.requires_grad_(True)
    dev = next(model.parameters()).device
    return {"params": model,
            "opt": optimizer.init(dict(model.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_fn(params, cfg: ModelConfig, batch):
    logits, aux = forward_train(params, cfg, batch)
    loss, n = softmax_xent(logits, batch["labels"])
    total = loss + AUX_COEF * aux
    return total, {"loss": loss, "aux": aux, "tokens": n}


def build_train_step(cfg: ModelConfig, optimizer: Optimizer, lr_fn,
                     grad_accum: int = 1):
    def one_grad(model, batch):
        total, metrics = loss_fn(model, cfg, batch)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if grad_accum > 1:
            metrics = None
            for i in range(grad_accum):
                mb = {k: t.reshape(grad_accum, t.shape[0] // grad_accum,
                                   *t.shape[1:])[i] for k, t in batch.items()}
                met = one_grad(model, mb)
                metrics = met if metrics is None else \
                    {k: metrics[k] + met[k] for k in metrics}
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(grad_accum)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        else:
            metrics = one_grad(model, batch)

        lr = lr_fn(state["step"])
        with torch.profiler.record_function("optimizer"):
            _, _, gnorm = optimizer.update(
                {n: p.grad for n, p in params.items()}, state["opt"], params,
                lr)
        state["step"] += 1
        return state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step

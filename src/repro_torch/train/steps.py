"""Train-step builder: loss, grads, optimizer update.  Port of
``repro.train.steps``.

``train_step(state, batch)`` takes the state of ``init_train_state``,
``{"params": the model, "opt": the optimizer state, "step": int32 0-d}``,
and returns it updated in place with the step's metrics.  Gradient
accumulation runs the loss over the microbatches one after another, adds
their grads (``.grad`` accumulates across the backward passes, in each
parameter's dtype, as the reference's ``jnp.add``) and divides the sum by
``grad_accum``, after the sharded step's one reduction.  The
reference's ``optimization_barrier`` (keeping one microbatch's
activations from overlapping the next's) has no eager counterpart and
needs none: eager execution finishes microbatch i's backward before
microbatch i+1's forward begins.

The sharded step is this one on the DTensor model
(``distributed.layouts.shard_params``, the batch by
``distributed.layouts.distribute_tree``), under
``distributed.context.use_rules``; the step runs under
``replicate_made_tensors``, its backward too.  A microbatch is laid out as
the batch (rows over ``batch``) before it runs.  A microbatch's backward
reduces no parameter's gradient: each comes back as its use leaves it,
``Partial`` over the ranks that hold its partial sums (the batch's and
the residual stream's rows; ``context.weight_at``, ``on_rows``, the tied
table's vocab-parallel lookup), and ``.grad`` adds the microbatches'
where they lie.  The sum is then reduced once, to ``grad_shardings``
({parameter name: DTensor placements}, ``layouts.param_placements`` of
``opt_pspecs``: ZeRO) as the reference's ``with_sharding_constraint``
does, so that the update runs at the optimizer state's sharding (a
reduce-scatter of ``Partial`` grads), or without them to each
parameter's own placements; on plain grads nothing changes.

The step runs with cuBLAS's reduced-precision bf16 reductions off
(``full_bf16_reductions``; C19): left on (PyTorch's default), cuBLAS may
add a bf16 product's split-K partial sums in bf16, where the reference's
products reduce in f32, and at whisper-small's timed training shape every
bf16 grad leaf then lay ~6% from the reference's bf16 grads, four times
the reference's own bf16 distance from its f32 grads (1.1% with them off,
its distance 1.4%, as the reference's).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import context
from repro_torch.models import forward_train, init_params
from repro_torch.models.losses import softmax_xent
from repro_torch.optim import Optimizer

AUX_COEF = 0.01  # MoE load-balance coefficient


@contextlib.contextmanager
def full_bf16_reductions():
    """cuBLAS's bf16 products reduce in f32 within the block (module
    docstring); the caller's setting is restored after it."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


def init_train_state(generator, cfg: ModelConfig, optimizer: Optimizer,
                     device="cuda", params=None) -> dict:
    """Random params from ``generator`` on ``device`` (or the given model
    ``params``, where they are) with gradients on, the optimizer's state and
    step 0 beside them."""
    if params is None:
        params = init_params(cfg, generator, device=resolve_device(device))
    model = params.requires_grad_(True)
    dev = context.local_device(next(model.parameters()))
    return {"params": model,
            "opt": optimizer.init(dict(model.named_parameters())),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def loss_fn(params, cfg: ModelConfig, batch):
    logits, aux = forward_train(params, cfg, batch)
    loss, n = softmax_xent(logits, batch["labels"])
    total = loss + AUX_COEF * aux
    return total, {"loss": loss, "aux": aux, "tokens": n}


def _microbatch(t, grad_accum: int, i: int):
    """Microbatch ``i`` of ``t``: rows ``[i B / grad_accum, (i + 1) B /
    grad_accum)``, as the reference's reshape takes them.  Of a DTensor,
    laid out as the whole batch was (``batch_pspecs``: rows over
    ``batch``): a DTensor cannot split a row shard into microbatches unless
    ``grad_accum`` is a multiple of the ranks holding the rows, so the
    rows are gathered (``context.replicate_dim``), taken, and cut again
    where the rules say."""
    if not context.is_dtensor(t):
        return t.reshape(grad_accum, t.shape[0] // grad_accum,
                         *t.shape[1:])[i]
    rows = t.shape[0] // grad_accum
    t = context.replicate_dim(t, 0).narrow(0, i * rows, rows)
    return context.constrain(t, ("batch", "seq", *[None] * t.dim())[
        :t.dim()])


def build_train_step(cfg: ModelConfig, optimizer: Optimizer, lr_fn,
                     grad_accum: int = 1, grad_shardings=None):
    """``grad_shardings``: {parameter name: placements} of the summed grads
    (module docstring)."""
    def one_grad(model, batch):
        total, metrics = loss_fn(model, cfg, batch)
        total.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        with context.replicate_made_tensors(state["params"].embed), \
                full_bf16_reductions():
            return step(state, batch)

    def step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if grad_accum > 1:
            metrics = None
            for i in range(grad_accum):
                mb = {k: _microbatch(t, grad_accum, i)
                      for k, t in batch.items()}
                met = one_grad(model, mb)
                metrics = met if metrics is None else \
                    {k: metrics[k] + met[k] for k in metrics}
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        else:
            metrics = one_grad(model, batch)

        grads = {}
        for n, p in params.items():
            place = grad_shardings[n] if grad_shardings is not None else \
                getattr(p, "placements", None)
            grads[n] = context.redistribute(p.grad, place)
            if grad_accum > 1 and grads[n] is not None:
                grads[n].div_(grad_accum)
        lr = lr_fn(state["step"])
        with torch.profiler.record_function("optimizer"):
            _, _, gnorm = optimizer.update(grads, state["opt"], params, lr)
        state["step"] += 1
        return state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step

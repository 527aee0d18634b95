"""Carry parameters between the reference's pytree and the port's modules.

The reference's params tree stacks each superblock leaf over the R
superblocks: ``blocks`` is a tuple over pattern positions j of a layer's
tree whose leaves are ``(R, ...)``; ``tail`` is a tuple of unstacked layer
trees, an encoder's ``enc_blocks`` another, and ``embed``, ``final_norm``
... sit at the top.  The port keeps one ``Layer`` per layer, so its
parameter ``layers.<i>.<rest>`` is layer ``r`` of the stacked leaf
``blocks/<j>/<rest>`` where ``i = r * P + j`` (P the pattern length), or
the tail's ``tail/<i - R P>/<rest>``.  ``leaf_of`` says that for one name
and ``stacked_view`` for a model; the leaf's key is its tree path joined by
``/``.  Whatever works on the reference's stacked leaves goes through them:
``params_from_jax`` and ``params_to_numpy`` here, Adafactor's factored
moments (``optim.optimizers``) and the sharding specs
(``distributed.layouts``).

``params_from_jax`` takes the JAX package's params pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``), so bf16 leaves
arrive as numpy arrays of the ml_dtypes ``bfloat16`` type.  They go through
``np.float32``, which is exact, and then to ``torch.bfloat16``; f32 leaves
(the RG-LRU conv and gates, the RWKV mixes, LoRAs, ``u`` and ``w0``) stay
f32.

``params_to_numpy`` is the inverse: it turns the port's parameters, or any
dict of tensors keyed by their names (grads, AdamW's ``m``, ``v`` and
``master``), into the reference's layout, every leaf a numpy array (bf16
widened to f32, exactly).  ``reference_tree`` builds that layout from
leaves keyed by leaf key (Adafactor's state, the layout specs).

The flood workflow's convolution weights come across the same way, from
numpy, through ``repro_torch.serverless.workflow.flood_weights_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer, init_params


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(device=device,
                                                     dtype=torch.bfloat16)
    return torch.tensor(a).to(device)


# ---------------------------------------------------------------------------
# the stacked view
# ---------------------------------------------------------------------------
def leaf_of(name: str, cfg: ModelConfig | None) -> tuple[str, int | None]:
    """A port parameter name -> (its reference leaf's key, its layer index
    along the leaf's stacked axis, or None for an unstacked leaf).  Without
    a config every name is a leaf of its own (a flat tree)."""
    parts = name.split(".")
    if cfg is None or parts[0] not in ("layers", "enc_blocks"):
        return "/".join(parts), None
    i, rest = int(parts[1]), parts[2:]
    if parts[0] == "enc_blocks":
        return "/".join(["enc_blocks", str(i), *rest]), None
    R, P = cfg.n_superblocks, cfg.pattern_len
    if i < R * P:
        r, j = divmod(i, P)
        return "/".join(["blocks", str(j), *rest]), r
    return "/".join(["tail", str(i - R * P), *rest]), None


def stacked_view(names, cfg: ModelConfig | None) -> dict:
    """{leaf key: the port names of its layers, in layer order} (one name
    for an unstacked leaf), in the order of ``names``' first layers."""
    view: dict = {}
    for name in names:
        key, r = leaf_of(name, cfg)
        group = view.setdefault(key, [])
        if r is not None and r != len(group):
            raise ValueError(f"{name}: layer {r} of {key} out of order")
        group.append(name)
    return view


def is_stacked(key: str) -> bool:
    return key.split("/")[0] == "blocks"


def stack(key: str, tensors: list) -> torch.Tensor:
    """A leaf's layer tensors as the reference's leaf: ``(R, ...)`` on their
    device for a stacked leaf, the one tensor itself otherwise."""
    return torch.stack(tensors) if is_stacked(key) else tensors[0]


def unstack(key: str, leaf: torch.Tensor) -> list:
    """The inverse of ``stack``: views of the leaf's layers."""
    return list(leaf.unbind(0)) if is_stacked(key) else [leaf]


def reference_tree(leaves: dict, cfg: ModelConfig | None) -> dict:
    """{leaf key: leaf} -> the reference's nested tree: ``blocks`` a tuple
    over the P pattern positions (``()`` with no superblock), ``tail`` a
    tuple, ``enc_blocks`` a tuple where the model has an encoder."""
    out: dict = {}
    for key, leaf in leaves.items():
        d = out
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    if cfg is None:
        return out

    def seq(d: dict, n: int) -> tuple:
        return tuple(d[str(i)] for i in range(n))
    R, P = cfg.n_superblocks, cfg.pattern_len
    out["blocks"] = seq(out.get("blocks", {}), P) if R else ()
    out["tail"] = seq(out.get("tail", {}), len(cfg.tail_pattern))
    if "enc_blocks" in out:
        out["enc_blocks"] = seq(out["enc_blocks"], len(out["enc_blocks"]))
    return out


def _at(tree, key: str):
    for p in key.split("/"):
        tree = tree[int(p)] if isinstance(tree, (tuple, list)) else tree[p]
    return tree


# ---------------------------------------------------------------------------
# the reference's tree <-> the port's modules
# ---------------------------------------------------------------------------
def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> Transformer:
    """The reference's params (numpy leaves) as the port's model on
    ``device``: each parameter is its leaf's layer (``leaf_of``)."""
    dev = resolve_device(device)
    model = init_params(cfg, None, device="meta")
    state = {}
    for name, p in model.named_parameters():
        key, r = leaf_of(name, cfg)
        a = np.asarray(_at(tree, key))
        t = to_tensor(a if r is None else a[r], dev)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {tuple(t.shape)} in the tree, "
                             f"{tuple(p.shape)} in the model")
        state[name] = t
    model.load_state_dict(state, assign=True)
    return model


def _numpy(leaf):
    if isinstance(leaf, dict):
        return {k: _numpy(v) for k, v in leaf.items()}
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree, cfg: ModelConfig) -> dict:
    """``tree``: a ``Transformer`` or a dict keyed by its parameter names
    (``layers.<i>.<block>.<name>``, ``embed``, ...) whose values are tensors
    -> the reference's params pytree of numpy leaves."""
    named = dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree
    leaves = {key: _numpy(stack(key, [named[n] for n in names]))
              for key, names in stacked_view(named, cfg).items()}
    return reference_tree(leaves, cfg)

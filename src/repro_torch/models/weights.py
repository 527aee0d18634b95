"""Carry parameters between the reference's pytree and the port's modules.

``params_from_jax`` takes the JAX package's params pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``), so bf16 leaves
arrive as numpy arrays of the ml_dtypes ``bfloat16`` type.  They go through
``np.float32``, which is exact, and then to ``torch.bfloat16``; f32 leaves
(the RG-LRU conv and gates, the RWKV mixes, LoRAs, ``u`` and ``w0``) stay
f32.  The stacked superblock leaves (leading axis R) are cut into one
``Layer`` per layer; an encoder's ``enc_blocks`` (a tuple of layers) become
``Transformer.enc_blocks``.

``params_to_numpy`` is the inverse: it turns the port's parameters, or any
dict of tensors keyed by their names (grads, AdamW's ``m``, ``v`` and
``master``), into the reference's layout, superblocks stacked on axis 0 and
then ``tail``, ``enc_blocks`` as a tuple, every leaf a numpy array (bf16
widened to f32, exactly).

The flood workflow's convolution weights come across the same way, from
numpy, through ``repro_torch.serverless.workflow.flood_weights_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.modules import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv import ChannelMix, TimeMix
from repro_torch.models.transformer import Layer, Transformer, check_supported

_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2", "ln_x")
# a layer's sub-blocks, by the reference's names
_BLOCKS = {"attn": Attention, "mlp": MLP, "rec": RGLRU, "tm": TimeMix,
           "cm": ChannelMix, "xattn": Attention}
_TOP = ("embed", "final_norm", "lm_head", "enc_norm", "frontend_proj")


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(device=device,
                                                     dtype=torch.bfloat16)
    return torch.tensor(a).to(device)


def _layer(kind: str, tree: dict, take, device) -> Layer:
    def conv(d):
        return {name: to_tensor(take(a), device) for name, a in d.items()
                if not isinstance(a, dict)}
    norms = conv({n: tree[n] for n in _NORMS if n in tree})
    blocks = {name: cls(conv(tree[name]))
              for name, cls in _BLOCKS.items() if name in tree}
    if "moe" in tree:
        dense = tree["moe"].get("dense")
        blocks["moe"] = MoE(conv(tree["moe"]),
                            MLP(conv(dense)) if dense is not None else None)
    return Layer(kind, norms, blocks)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> Transformer:
    check_supported(cfg)
    dev = resolve_device(device)
    R, P = cfg.n_superblocks, cfg.pattern_len
    layers = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if i < R * P:
            r, j = divmod(i, P)
            layers.append(_layer(kind, tree["blocks"][j], lambda a: a[r], dev))
        else:
            layers.append(_layer(kind, tree["tail"][i - R * P], lambda a: a,
                                 dev))
    top = {name: to_tensor(tree[name], dev) for name in _TOP if name in tree}
    enc = [_layer(ATTN_GLOBAL, t, lambda a: a, dev)
           for t in tree.get("enc_blocks", ())]
    return Transformer(top, layers, enc)


def _numpy(leaf):
    if isinstance(leaf, dict):
        return {k: _numpy(v) for k, v in leaf.items()}
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(tree, cfg: ModelConfig) -> dict:
    """``tree``: a ``Transformer`` or a dict keyed by its parameter names
    (``layers.<i>.<block>.<name>``, ``embed``, ...) whose leaves are tensors
    or dicts of tensors -> the reference's params pytree of numpy leaves."""
    named = dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree
    out, stacks = {}, {"layers": {}, "enc_blocks": {}}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] not in stacks:
            out[name] = _numpy(leaf)
            continue
        d = stacks[parts[0]].setdefault(int(parts[1]), {})
        for key in parts[2:-1]:
            d = d.setdefault(key, {})
        d[parts[-1]] = _numpy(leaf)
    layers, enc = stacks["layers"], stacks["enc_blocks"]
    R, P = cfg.n_superblocks, cfg.pattern_len
    out["blocks"] = tuple(_stack([layers[r * P + j] for r in range(R)])
                          for j in range(P)) if R else ()
    out["tail"] = tuple(layers[i] for i in range(R * P, len(layers)))
    if enc:
        out["enc_blocks"] = tuple(enc[i] for i in range(len(enc)))
    return out

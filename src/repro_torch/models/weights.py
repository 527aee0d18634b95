"""Import the reference's parameters into the port's modules.

``params_from_jax`` takes the JAX package's params pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``), so bf16 leaves
arrive as numpy arrays of the ml_dtypes ``bfloat16`` type.  They go through
``np.float32``, which is exact, and then to ``torch.bfloat16``; f32 leaves
(the RG-LRU conv and gates, the RWKV mixes, LoRAs, ``u`` and ``w0``) stay
f32.  The stacked superblock leaves (leading axis R) are cut into one
``Layer`` per layer.

The flood workflow's convolution weights come across the same way, from
numpy, through ``repro_torch.serverless.workflow.flood_weights_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.modules import MLP
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv import ChannelMix, TimeMix
from repro_torch.models.transformer import Layer, Transformer, check_supported

_NORMS = ("ln1", "ln2", "post_ln1", "post_ln2")
# a layer's sub-blocks, by the reference's names
_BLOCKS = {"attn": Attention, "mlp": MLP, "rec": RGLRU, "tm": TimeMix,
           "cm": ChannelMix}


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(device=device,
                                                     dtype=torch.bfloat16)
    return torch.tensor(a).to(device)


def _layer(kind: str, tree: dict, take, device) -> Layer:
    def conv(d):
        return {name: to_tensor(take(a), device) for name, a in d.items()}
    norms = conv({n: tree[n] for n in _NORMS if n in tree})
    return Layer(kind, norms, {name: cls(conv(tree[name]))
                               for name, cls in _BLOCKS.items() if name in tree})


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
    top = {name: to_tensor(tree[name], dev)
           for name in ("embed", "final_norm", "lm_head") if name in tree}
    return Transformer(top, layers)

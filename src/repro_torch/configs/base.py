"""Config system of the PyTorch port: a copy of ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of the JAX package.
``ModelConfig`` keeps every field of the reference so that the two dataclasses
match.  ``ShapeConfig``, ``LM_SHAPES`` and ``shapes_for`` are the reference's input
shapes, which ``models.io`` and ``distributed.layouts`` take.  The registry holds all ten of the reference's
architectures.

Layer stacking: ``layer_pattern`` is the repeating unit of layer kinds (e.g.
``("local",)*5 + ("global",)`` for gemma3).  The reference scans over
``n_superblocks`` repetitions of the pattern and runs ``n_tail`` remainder
layers after them; the port walks the same order in a Python loop.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional

# Layer kinds understood by models/transformer.py
ATTN_GLOBAL = "global"     # full causal attention
ATTN_LOCAL = "local"       # sliding-window attention
RGLRU = "rglru"            # Griffin recurrent block
RWKV = "rwkv"              # RWKV-6 time-mix block


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    dense_residual: bool = False
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details ---
    layer_pattern: tuple = (ATTN_GLOBAL,)
    window_size: int = 0              # sliding window for ATTN_LOCAL
    attn_logit_softcap: float = 0.0   # 0 = disabled
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0    # gemma3: different base on global layers
    qk_norm: bool = False             # per-head RMSNorm on q/k

    # --- block details ---
    act: str = "silu"                 # silu (gated) | gelu (gated) | gelu_plain
    post_norms: bool = False          # gemma2: extra post-attn/post-ffn norms
    tie_embeddings: bool = True
    embedding_scale: bool = False     # gemma family: x *= sqrt(d_model)
    norm_eps: float = 1e-6

    # --- MoE ---
    moe: Optional[MoEConfig] = None

    # --- recurrent families ---
    d_rnn: int = 0
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_len_ratio: int = 4

    # --- modality frontend stubs ---
    frontend: str = ""
    n_prefix_tokens: int = 0

    # --- numerics / perf knobs ---
    param_dtype: str = "bfloat16"
    remat: str = "full"
    attn_q_block: int = 512
    rnn_chunk: int = 256
    optimizer: str = "adamw"
    kv_quant: bool = False
    attn_causal_pack: str = "auto"
    scan_reps_cap: int = 0

    # ----- derived layout helpers -----
    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_superblocks(self) -> int:
        r = self.n_layers // self.pattern_len
        if self.scan_reps_cap:
            r = min(r, self.scan_reps_cap)
        return r

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_superblocks * self.pattern_len

    @property
    def tail_pattern(self) -> tuple:
        reps = (self.n_tail + self.pattern_len - 1) // self.pattern_len
        return tuple((self.layer_pattern * max(reps, 1))[: self.n_tail])

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kinds(self) -> list:
        """Kind of every layer, in order."""
        kinds = list(self.layer_pattern) * self.n_superblocks
        kinds += list(self.tail_pattern)
        return kinds

    # ----- analytic parameter count (used for 6*N*D MODEL_FLOPS) -----
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        gated_ffn = 3 * d * self.d_ff
        for kind in self.layer_kinds():
            n += 2 * d  # norms
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                n += attn
                if self.moe is not None:
                    e = self.moe.experts_per_token if active_only \
                        else self.moe.n_experts
                    n += e * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
                    if self.moe.dense_residual:
                        n += 3 * d * (self.moe.d_ff_dense or self.d_ff)
                else:
                    n += gated_ffn
            elif kind == RGLRU:
                dr = self.d_rnn or d
                # in/out proj + conv + gates
                n += 2 * d * dr + dr * d + self.conv_width * dr + 2 * dr * dr + dr
                n += gated_ffn
            elif kind == RWKV:
                # time-mix: r,k,v,g,o + decay lora + channel-mix
                n += 5 * d * d + 2 * d * self.d_ff
        if self.encoder_decoder:
            # encoder layers: attn + plain ffn (no gating in whisper)
            enc = attn + 2 * d * self.d_ff + 2 * d
            n += self.n_enc_layers * enc
            # decoder cross-attention
            n += self.n_layers * (attn + d)
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


LM_SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Pure full-attention archs skip long_500k, as in the reference.
LONG_CONTEXT_OK = {
    "gemma3-1b", "gemma2-9b", "h2o-danube-1.8b", "recurrentgemma-2b",
    "rwkv6-7b",
}


def shapes_for(arch: str) -> list:
    out = []
    for s in LM_SHAPES.values():
        if s.name == "long_500k" and arch not in LONG_CONTEXT_OK:
            continue
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    cfg = get_config(name)
    pat = cfg.pattern_len
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_experts=8, experts_per_token=min(moe.experts_per_token, 2),
            d_ff_expert=64, d_ff_dense=64 if moe.dense_residual else 0)
    return dataclasses.replace(
        cfg,
        n_layers=2 * pat,
        n_enc_layers=2 if cfg.encoder_decoder else 0,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        d_rnn=64 if cfg.d_rnn else 0,
        vocab_size=512,
        window_size=min(cfg.window_size, 32) if cfg.window_size else 0,
        n_prefix_tokens=4 if cfg.n_prefix_tokens else 0,
        moe=moe,
        attn_q_block=16,
        rnn_chunk=16,
        rwkv_head_dim=16,
        remat="none",
    )


def list_archs() -> list:
    _load_all()
    return sorted(_REGISTRY)


# The architectures, in port order.
_ARCH_MODULES = ["gemma3_1b", "internlm2_20b", "h2o_danube_1_8b", "gemma2_9b",
                 "recurrentgemma_2b", "rwkv6_7b", "qwen3_moe_235b_a22b",
                 "arctic_480b", "whisper_small", "paligemma_3b"]


def _load_all():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")

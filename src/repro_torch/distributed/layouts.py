"""Layout selection: maps logical tensor axes onto a mesh.  Port of
``repro.distributed.layouts``.

``choose_layout`` consumes the mesh and the workload (arch x shape) and
emits the sharding rule set.  Heuristics, the reference's:

* TP shards heads/ff/vocab over ``model`` when divisible; GQA KV heads are
  replicated when ``n_kv_heads`` does not divide the model axis.
* Archs with fewer heads than the model axis keep attention replicated
  over ``model`` and use it for ff/rnn instead.
* Decode shapes shard the KV-cache sequence over ``model``.
* Optimizer state is additionally sharded over ``data`` (ZeRO-style).

The specs are the reference's, leaf for leaf.  The reference reads each
leaf's tree path and stacked shape; the port's parameters are per layer,
so ``param_pspecs`` and ``opt_pspecs`` run on the stacked view
(``models.weights.stacked_view``): they return one spec per reference leaf,
keyed by leaf key (``blocks/0/attn/wq``), computed on the leaf's stacked
shape ``(R, ...)``, and ``models.weights.leaf_of`` says which leaf a port
tensor is a layer of.  ``cache_pspecs`` and ``batch_pspecs`` take the
port's cache and batch, which keep the reference's layout, and return the
same nesting with a spec at each tensor.  A spec is a plain tuple
(``distributed.context``); ``to_shardings`` gives DTensor placements.
``choose_layout`` and ``opt_pspecs`` read only the mesh's names and sizes,
so they take a ``launch.mesh.AbstractMesh`` as well as a DeviceMesh.

Placing a model: ``shard_params`` turns each parameter into a DTensor at
its leaf's spec (``param_placements``), ``distribute_tree`` a batch or a
cache at ``batch_pspecs`` / ``cache_pspecs``.  A per-layer tensor takes its
stacked leaf's spec without the leading R entry (``layer_spec``).  Where
the reference shards R itself, a layer cannot: ``opt_pspecs`` puts
``data`` on R wherever R is the first free dim it divides, and that entry
moves to the layer's next free dim that it divides, or, where there is
none, the layer is replicated over it.  So the grad shardings and update
constraints built from ``opt_pspecs`` differ from the reference's at
every stacked leaf whose R it shards.  On the ``TRAIN_LOWERS`` cell
(smoke gemma2-9b, a 2 x 4 ``("data", "model")`` mesh) that is all 22
stacked leaves, and all 22 move ``data`` to a layer dim (``wo`` and
``w_down`` to d_model, the rest to their first dim); on the same mesh
recurrentgemma-2b's 39 all carry it and 8 (``conv_b``, ``ba``, ``bi``,
``lam``: one dim, already over ``model``) are replicated over ``data``
instead, and qwen3-moe's experts keep ``data`` on ``moe_ff`` (9 of 12
move).  ``tests/test_torch_sharded.py`` counts them.  No leaf of
``param_pspecs`` shards R.
"""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.context import (ShardingRules, axis_sizes,
                                             is_dtensor, placements, pspec)
from repro_torch.models import weights


def data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def choose_layout(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  overrides: dict | None = None) -> ShardingRules:
    sizes = axis_sizes(mesh)
    tp = sizes["model"]
    da = data_axes(mesh)
    dsize = 1
    for a in da:
        dsize *= sizes[a]

    heads_ok = cfg.n_heads % tp == 0
    flat_ok = (cfg.n_heads * cfg.head_dim) % tp == 0
    kv_ok = cfg.n_kv_heads % tp == 0
    vocab_ok = cfg.vocab_size % tp == 0

    rules = {
        "batch": da if shape.global_batch % dsize == 0 else None,
        "seq": None,
        # Megatron-SP: residual stream sharded over model between layers
        "act_seq": "model" if shape.kind != "decode" else None,
        "heads": "model" if heads_ok else None,
        "heads_flat": "model" if flat_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "ff": "model",
        "vocab": "model" if vocab_ok else None,
        "embed_d": "model",
        "experts": "model",
        "moe_ff": "data",      # FSDP dim of expert weights (ZeRO-3)
        "rnn": "model",
        "kv_seq": "model",
    }
    if rules["batch"] is None:
        # batch too small (long_500k): shard sequence over the data axes
        rules["seq"] = da
    if overrides:
        rules.update(overrides)
    return ShardingRules(mesh, rules, moe_axis="model")


# ---------------------------------------------------------------------------
# parameter partitioning (by leaf path)
# ---------------------------------------------------------------------------
_LAST = {"wq", "w_gate", "w_up", "wk", "wv", "wr", "wg", "w_y", "w_x",
         "conv_w", "conv_b", "lam", "ba", "bi", "wa", "wi"}
_SECOND_LAST = {"wo", "w_down", "w_out"}
_REPL = {"ln1", "ln2", "ln_x", "post_ln1", "post_ln2", "final_norm",
         "enc_norm", "q_norm", "k_norm", "router", "mu", "mu_x", "mu_k",
         "mu_r", "tm_w1", "tm_w2", "w0", "dw1", "dw2", "lnx_s", "lnx_b",
         "frontend_proj"}


def _leaf_logical(key: str, leaf_ndim: int, cfg: ModelConfig) -> tuple:
    """The reference's rule for the leaf at ``key`` (its tree path joined
    by ``/``, tuple indices as numbers) of ``leaf_ndim`` dims."""
    keys = key.split("/")
    name = keys[-1]

    def at(dim_from_end: int, ax: str) -> tuple:
        logical = [None] * leaf_ndim
        logical[leaf_ndim - 1 - dim_from_end] = ax
        return tuple(logical)

    if name == "embed" and not cfg.tie_embeddings:
        # untied: shard the table on the embedding dim
        return (None, "embed_d")
    if name in ("embed", "lm_head"):
        return ("vocab", None)
    if name in _REPL:
        return (None,) * leaf_ndim
    moe_expert = "moe" in key and "dense" not in key
    if moe_expert and name in ("w_gate", "w_up", "w_down"):
        # (R?, E, d, f): experts over model; the expert-ff dim additionally
        # over data (FSDP / ZeRO-3)
        logical = [None] * leaf_ndim
        logical[leaf_ndim - 3] = "experts"
        logical[leaf_ndim - (1 if name != "w_down" else 2)] = "moe_ff"
        return tuple(logical)
    if name == "u":
        return at(1, "heads")
    if "attn" in key or "xattn" in key:
        if name == "wq":
            return at(0, "heads_flat")
        if name in ("wk", "wv"):
            return at(0, "kv_heads_flat")
        if name == "wo":
            return at(1, "heads_flat")
    if "rec" in key:
        ax = "rnn"
        if name in _SECOND_LAST:
            return at(1, ax)
        return at(0, ax)
    if "tm" in keys:
        if name in ("wr", "wk", "wv", "wg"):
            return at(0, "heads_flat")
        if name == "wo":
            return at(1, "heads_flat")
    if "cm" in keys:
        if name == "wk":
            return at(0, "ff")
        if name == "wv":
            return at(1, "ff")
        if name == "wr":
            return (None,) * leaf_ndim
    if name in _SECOND_LAST:
        return at(1, "ff")
    if name in _LAST:
        return at(0, "ff")
    return (None,) * leaf_ndim


def _stacked_shapes(params, cfg: ModelConfig) -> dict:
    """{leaf key: the reference leaf's shape} of a model (any device, the
    meta device included) or a dict of its named tensors."""
    named = dict(params.named_parameters()) \
        if isinstance(params, nn.Module) else params
    return {key: ((len(names),) if weights.is_stacked(key) else ())
            + tuple(named[names[0]].shape)
            for key, names in weights.stacked_view(named, cfg).items()}


def param_pspecs(params, cfg: ModelConfig, rules: ShardingRules) -> dict:
    """{leaf key: spec} over the model's stacked view."""
    r = dict(rules.rules)
    r.setdefault("kv_heads_flat", r.get("kv_heads"))
    r.setdefault("heads_flat", r.get("heads"))
    return {key: pspec(*(r.get(ax) if ax else None
                         for ax in _leaf_logical(key, len(shape), cfg)))
            for key, shape in _stacked_shapes(params, cfg).items()}


def opt_pspecs(param_specs: dict, params, cfg: ModelConfig, mesh) -> dict:
    """ZeRO: additionally shard optimizer-state copies over ``data``, on
    the first free dim of the stacked leaf that ``data`` divides (the layer
    axis R may be that dim)."""
    dsize = axis_sizes(mesh)["data"]
    shapes = _stacked_shapes(params, cfg)

    def extend(spec, shape):
        used = {a for s in spec if s for a in
                ((s,) if isinstance(s, str) else s)}
        if "data" in used:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, (s, n) in enumerate(zip(dims, shape)):
            if s is None and n % dsize == 0 and n >= dsize:
                dims[i] = "data"
                return pspec(*dims)
        return spec

    return {key: extend(spec, shapes[key])
            for key, spec in param_specs.items()}


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def _map_tensors(fn, tree, path=()):
    """``fn(path, tensor)`` at every tensor of a nest of dicts and tuples,
    keeping the nesting (a path entry is a dict key or a tuple index as a
    string, as the reference's keys are read)."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tensors(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def batch_pspecs(batch: dict, rules: ShardingRules) -> dict:
    b = rules.rules.get("batch")
    s = rules.rules.get("seq")

    def spec(path, leaf):
        if leaf.dim() >= 2:
            return pspec(b, s, *(None,) * (leaf.dim() - 2))
        return pspec(b)

    return _map_tensors(spec, batch)


def cache_pspecs(cache: dict, cfg: ModelConfig, rules: ShardingRules,
                 stacked: bool = True) -> dict:
    """KV caches: batch over data, sequence over ``model`` (flash-decode);
    recurrent states: batch over data, heads/rnn over ``model``."""
    b = rules.rules.get("batch")
    kvseq = rules.rules.get("kv_seq", "model")
    seq_extra = rules.rules.get("seq")  # set when batch unshardable

    def spec(keys, leaf):
        name = keys[-1]
        off = 1 if (stacked and "blocks" in keys) else 0
        nd = leaf.dim() - off
        lead = (None,) * off
        if name in ("k", "v", "ck", "cv", "ksc", "vsc"):  # (B,S,K,hd?)
            sq = tuple(a for a in ((kvseq,) if isinstance(kvseq, str)
                                   else tuple(kvseq or ())))
            if b is None and seq_extra:
                ex = seq_extra if isinstance(seq_extra, tuple) \
                    else (seq_extra,)
                sq = tuple(ex) + sq
            return pspec(*lead, b, sq if sq else None, *(None,) * (nd - 2))
        if name == "state":                      # (B, H, hd, hd)
            return pspec(*lead, b, "model", None, None)
        if name in ("tm_x", "cm_x"):             # (B, D)
            return pspec(*lead, b, "model")
        if name == "h":                          # (B, dr)
            return pspec(*lead, b, "model")
        if name == "conv":                       # (B, cw-1, dr)
            return pspec(*lead, b, None, "model")
        return pspec(*lead, *(None,) * nd)

    return _map_tensors(spec, cache)


def to_shardings(specs, mesh):
    """The same nesting with each spec's DTensor placements on ``mesh``: a
    tuple that is empty or holds dicts is nesting (a cache's ``blocks`` and
    ``tail``), any other a spec."""
    if isinstance(specs, dict):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    if not specs or any(isinstance(s, dict) for s in specs):
        return tuple(to_shardings(v, mesh) for v in specs)
    return placements(specs, mesh)



# ---------------------------------------------------------------------------
# placing a model, a batch, a cache
# ---------------------------------------------------------------------------
def _axes_of(s) -> tuple:
    return (s,) if isinstance(s, str) else tuple(s or ())


def layer_spec(spec: tuple, layer_shape: tuple, stacked: bool,
               mesh) -> tuple:
    """The spec of one layer tensor of a leaf whose spec is ``spec``: the
    leaf's own where it is not stacked; else without the leading R entry,
    whose mesh axes (if any) move to the layer's first free dim they
    divide, or are dropped (replicated) where none does."""
    if not stacked:
        return spec
    dims = list(spec[1:]) + [None] * (len(layer_shape) - len(spec) + 1)
    lead = _axes_of(spec[0] if spec else None)
    if lead:
        sizes = axis_sizes(mesh)
        n = 1
        for a in lead:
            n *= sizes[a]
        for i, (s, size) in enumerate(zip(dims, layer_shape)):
            if s is None and size % n == 0 and size >= n:
                dims[i] = spec[0]
                break
    return pspec(*dims)


def param_placements(params, cfg: ModelConfig, specs: dict, mesh) -> dict:
    """{leaf key: spec} (``param_pspecs``, ``opt_pspecs``) -> {parameter
    name: DTensor placements} for the model's per-layer tensors on
    ``mesh``, each its leaf's ``layer_spec``."""
    named = dict(params.named_parameters()) \
        if isinstance(params, nn.Module) else params
    out = {}
    for key, names in weights.stacked_view(named, cfg).items():
        for n in names:
            out[n] = placements(layer_spec(specs[key], tuple(named[n].shape),
                                           weights.is_stacked(key), mesh),
                                mesh)
    return out


def shard_params(model: nn.Module, cfg: ModelConfig, rules: ShardingRules,
                 mesh) -> nn.Module:
    """Replaces each parameter of ``model`` (in place) by a DTensor on
    ``mesh`` placed by ``param_pspecs`` (``param_placements``); each rank
    passes the same full tensors.  Returns the model."""
    from torch.distributed.tensor import distribute_tensor
    place = param_placements(model, cfg, param_pspecs(model, cfg, rules),
                             mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod.register_parameter(leaf, nn.Parameter(
            distribute_tensor(p.detach(), mesh, place[name]),
            requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, specs, mesh):
    """A batch or a cache (``batch_pspecs``' or ``cache_pspecs``' nesting)
    with each tensor a DTensor at its spec: a plain tensor is distributed
    (each rank passes the same full tensor), a DTensor redistributed."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in
                tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(distribute_tree(v, s, mesh) for v, s in
                     zip(tree, specs))
    place = placements(specs, mesh)
    if is_dtensor(tree):
        return tree.redistribute(mesh, place)
    return distribute_tensor(tree, mesh, place)

"""Multi-pod dry-run: trace every (arch x shape x mesh) cell without data.

Port of ``repro.launch.dryrun``.  For each cell this builds the real step
function (train_step for train shapes, prefill/decode steps for serving
shapes) with its production sharding specs, runs it once on meta-device
inputs (no allocation) under ``roofline.trace.OpTrace``, and records memory,
cost and collectives to JSON under ``experiments/dryrun_torch/``.

Where the reference lowers and compiles with XLA, eager PyTorch has no
compiler: the trace counts operations, bytes, live memory and collectives
op by op (``roofline/trace.py``).  The MoE dispatch indexes by boolean
masks, whose sizes are known only at run time: the trace counts each at its
upper bound T*k, which is what the reference's static drop/fill dispatch
computes.

On a production mesh (``pod`` 16 x 16, ``multipod`` 2 x 16 x 16) the cell
is the sharded step (``build_cell``: DTensor parameters, ZeRO grads and
updates, the batch and caches at their specs, under the cell's rules),
traced as one rank of a fake world of 256 or 512 ranks
(``launch.mesh.fake_mesh``: torch's in-process ``"fake"`` process group
on a ``"cpu"`` mesh, every tensor on the meta device, no card): the rank
with the most work, ``traced_rank``.  The counts are that rank's local
work and the collectives it issues.  Ranks differ only on flash's q-rows
route (more ``model`` ranks than q heads: a block of rows further down a
head has more causal pairs), where the rank at ``model`` coordinate
tp - 1 is traced; elsewhere rank 0.  On a 1 x 1 mesh no group is started
and the model stays plain.  The record keeps the reference's keys where
they mean the same (``rankN``: the rank traced):

* ``memory``: ``argument_gb``, ``output_gb`` and ``alias_gb`` (the donated
  arguments) are per device and exact, each leaf's shard taken from its
  spec (a dim split n ways takes ceil(dim / n)).  ``temp_gb`` is the peak
  of the traced rank's live local storages made during the step
  (``temp_split: "rankN"``; on one chip the trace's peak, ``"even"``),
  ``peak_gb`` the reference's sum.
* ``cost``: ``flops_per_device``, ``transcendentals`` and
  ``bytes_accessed`` (eager traffic: each op's operand and result bytes)
  are the traced rank's own (``split: "rankN"``; on one chip ``"even"``);
  ``compulsory_bytes`` reads the arguments once and writes the outputs once
  (an argument updated in place counts the bytes written into it).
* ``collectives``: ``collective_stats`` of the traced rank's trace;
  ``n_ranks_traced``: 1 on a production mesh; ``rank_traced``: N.
* ``rankN`` (a production mesh only): ``op_flops``, the rank's flops by op
  name; ``kernel_shapes``, each hand-written kernel's local output shapes
  (flash's: q's, in its (B*K, S, G, hd) layout), and the local shapes of
  the routes that split a layer by hand (``roofline.trace.record_route``):
  ``q_rows:<kernel>``, a rank's q rows (B, S / n, H / g, hd) on the q-rows
  route (g head groups, n row blocks: ``distributed.heads.row_groups``)
  (``"attention"``: the plain dispatch's; ``"flash attention"``), and
  ``kv_columns``, the k and v projections' (D, local columns) where they
  are cut by columns; ``product_shapes``, the flops of the products
  (``aten.mm``) by their local operands' shapes, ``"MxK @ KxN"``, the
  largest first; ``largest_collective``, the
  largest operand and output bytes of one collective of each kind;
  ``collective_groups``, the count and operand bytes of each kind by the
  number of ranks of the group it runs over (on ``multipod``: 2 is
  ``pod`` alone, 32 ``pod`` and ``data`` flattened).
* ``hlo_ops``: the op census (top 12); ``hlo_len``: the ops traced;
  ``lower_s``: the trace's seconds (eager has no ``compile_s``);
  ``layers``: the depth a cell was cut to (``--layers``), where it was.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    ... --calibrate     # also trace the R=1/R=2 calibration models
    ... --layers 2      # cut every cell to 2 layers
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import traceback
from collections import Counter
from dataclasses import replace
from pathlib import Path

import torch
from torch import nn

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs, shapes_for)
from repro_torch.distributed.context import axis_sizes, pspec, use_rules
from repro_torch.distributed.heads import head_split
from repro_torch.distributed.layouts import (batch_pspecs, cache_pspecs,
                                             choose_layout, distribute_tree,
                                             opt_pspecs, param_placements,
                                             param_pspecs, shard_params)
from repro_torch.launch.mesh import (AbstractMesh, fake_mesh,
                                     make_production_mesh)
from repro_torch.models import init_cache, init_params, weights
from repro_torch.models.io import batch_specs, decode_specs
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.roofline.trace import OpTrace, collective_stats, op_census
from repro_torch.serving.steps import build_decode_step, build_prefill_step
from repro_torch.train.steps import build_train_step, init_train_state

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _opt_state_pspecs(abstract_opt, abstract_params, pspecs, mesh,
                      cfg: ModelConfig):
    """Specs of the optimizer state, keyed as ``pspecs`` (by leaf key):
    AdamW's ``m``, ``v``, ``master`` take the ZeRO specs, Adafactor's
    factored ``vr``/``vc`` the ZeRO spec without its last / second-last
    dim, a scalar none."""
    z = opt_pspecs(pspecs, abstract_params, cfg, mesh)
    out = {}
    for k, sub in abstract_opt.items():
        if k in ("m", "v", "master"):
            out[k] = z
        elif k == "vs":
            def per_leaf(ps, vs):
                ndim = vs["v"].dim() if "v" in vs else vs["vr"].dim() + 1
                dims = list(ps) + [None] * (ndim - len(ps))
                if "vr" in vs:
                    return {"vr": pspec(*dims[:-1]),
                            "vc": pspec(*(dims[:-2] + dims[-1:]))}
                return {"v": pspec(*dims)}
            out[k] = {key: per_leaf(z[key], vs) for key, vs in sub.items()}
        else:
            out[k] = ()
    return out


TRAIN_GRAD_ACCUM = 4


def _made(tree, device: str):
    """The meta tensors of ``tree`` as zeros on ``device`` (meta: as
    they are)."""
    if device == "meta":
        return tree
    if isinstance(tree, dict):
        return {k: _made(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_made(v, device) for v in tree)
    return torch.zeros_like(tree, device=device)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
               grad_accum: int = TRAIN_GRAD_ACCUM, device: str = "meta"):
    """Returns (fn, abstract_args, in_specs, out_specs, donate): the
    arguments on the meta device, the specs nested as the arguments (a
    model or a dict keyed by parameter names against specs keyed by leaf
    key).  On another ``device`` the arguments are real: seeded weights,
    zero inputs and caches (a run to hold the trace against).

    On a ``DeviceMesh`` the cell is the sharded one, as the reference's
    ``build_cell`` places it: the parameters DTensors at ``param_pspecs``
    (``shard_params``); a train step's summed grads and each update at
    ``opt_pspecs``' ZeRO placements (``grad_shardings``,
    ``update_constraint``), the optimizer state made there; the batch, and
    a decode step's cache and tokens, at their specs (``distribute_tree``);
    a step's cache and tokens laid out at their out specs before it
    returns.  On an ``AbstractMesh`` (a 1 x 1 mesh) everything stays
    plain."""
    sharded = not isinstance(mesh, AbstractMesh)
    gen = None if device == "meta" else \
        torch.Generator(device).manual_seed(0)

    def laid_out(tree, specs):
        return distribute_tree(tree, specs, mesh) if sharded else tree

    def placed(tree, specs):              # an input: made on ``device``
        return laid_out(_made(tree, device), specs)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer, cfg=cfg)
        lr = cosine_schedule(3e-4, 100, 10_000)
        state = init_train_state(gen, cfg, opt, device=device)
        model = state["params"]
        pspecs = param_pspecs(model, cfg, rules)
        state_specs = {
            "params": pspecs,
            "opt": _opt_state_pspecs(state["opt"], model, pspecs, mesh, cfg),
            "step": (),
        }
        gshard = None
        if sharded:
            shard_params(model, cfg, rules, mesh)
            gshard = param_placements(
                model, cfg, opt_pspecs(pspecs, model, cfg, mesh), mesh)
            opt = make_optimizer(cfg.optimizer, cfg=cfg,
                                 update_constraint=gshard)
            state = init_train_state(None, cfg, opt, params=model)
        step_fn = build_train_step(cfg, opt, lr, grad_accum=grad_accum,
                                   grad_shardings=gshard)
        batch = batch_specs(cfg, shape)
        bspecs = batch_pspecs(batch, rules)
        return (step_fn, (state, placed(batch, bspecs)), (state_specs, bspecs),
                (state_specs, None), (0,))

    params = init_params(cfg, gen, device=device)
    pspecs = param_pspecs(params, cfg, rules)
    if sharded:
        shard_params(params, cfg, rules, mesh)
    b = rules.rules.get("batch")

    if shape.kind == "prefill":
        prefill = build_prefill_step(cfg)
        batch = batch_specs(cfg, shape)
        bspecs = batch_pspecs(batch, rules)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        cspecs = cache_pspecs(cache, cfg, rules)
        tok_spec = pspec(b)

        def prefill_step(params, batch):
            tok, cache = prefill(params, batch)
            return laid_out(tok, tok_spec), laid_out(cache, cspecs)
        return (prefill_step, (params, placed(batch, bspecs)),
                (pspecs, bspecs), (tok_spec, cspecs), ())

    # decode
    decode = build_decode_step(cfg)
    dspec = decode_specs(cfg, shape)
    cspecs = cache_pspecs(dspec["cache"], cfg, rules)
    tok_spec = pspec(b, None)

    def decode_step(params, cache, tokens, pos):
        # pos is the reference's int32 scalar argument; a meta tensor holds
        # no value and a step's work does not depend on it, so the step
        # runs at the cache's last position
        tok, cache = decode(params, cache, tokens, shape.seq_len - 1)
        return laid_out(tok, tok_spec), laid_out(cache, cspecs)
    in_specs = (pspecs, cspecs, tok_spec, ())
    out_specs = (tok_spec, cspecs)
    abstract = (params, placed(dspec["cache"], cspecs),
                placed(dspec["tokens"], tok_spec), dspec["pos"])
    return decode_step, abstract, in_specs, out_specs, (1,)


def _shard_bytes(shape, itemsize: int, spec, sizes: dict) -> int:
    """Bytes of one device's block of a leaf under ``spec``."""
    n = itemsize
    for d, dim in enumerate(shape):
        s = spec[d] if spec is not None and d < len(spec) else None
        ways = 1
        for ax in ((s,) if isinstance(s, str) else (s or ())):
            ways *= sizes[ax]
        n *= -(-int(dim) // ways)
    return n


def tree_bytes(tree, specs, sizes: dict, cfg: ModelConfig) -> int:
    """Per-device bytes of a nest of tensors under specs of the same
    nesting (None: replicated).  A model, or a dict keyed by its parameter
    names, against specs keyed by leaf key counts on the reference's
    stacked leaves (``models.weights.stacked_view``)."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        return _shard_bytes(tree.shape, tree.element_size(), specs, sizes)
    if isinstance(tree, dict):
        if isinstance(specs, dict) and tree.keys() != specs.keys():
            return sum(
                _shard_bytes(((len(names),) if weights.is_stacked(key)
                              else ()) + tuple(tree[names[0]].shape),
                             tree[names[0]].element_size(), specs[key], sizes)
                for key, names in weights.stacked_view(tree, cfg).items())
        return sum(tree_bytes(v, None if specs is None else specs[k], sizes,
                              cfg) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v, None if specs is None else specs[i], sizes,
                              cfg) for i, v in enumerate(tree))
    return 0


def traced_rank(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """The rank of ``mesh`` (row-major over its dims) with the most work in
    the cell's step.  Ranks differ only on flash's q-rows route
    (``head_split``'s ``"q_rows"``, a train or prefill step; decode runs no
    flash), where the rank at ``model`` coordinate r runs rows
    ``[j S / n, (j + 1) S / n)`` of a group of heads, ``j = r % n``: the
    rank at coordinate tp - 1 (every other coordinate 0) runs the last
    block, the most causal pairs.  Elsewhere rank 0."""
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    if "model" not in names or shape.kind == "decode":
        return 0
    m = names.index("model")
    try:
        how = head_split(cfg.n_heads, cfg.n_kv_heads, sizes[m])
    except ValueError:
        return 0
    return (sizes[m] - 1) * math.prod(sizes[m + 1:]) if how == "q_rows" \
        else 0


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               grad_accum: int = TRAIN_GRAD_ACCUM) -> dict:
    """One call of the cell's step under ``OpTrace`` -> the record's
    ``n_chips``, ``lower_s``, ``memory``, ``cost``, ``collectives``,
    ``hlo_ops`` and ``hlo_len`` (module docstring).  On a mesh of more than
    one chip, the sharded step traced as ``traced_rank`` of a fake world of
    the mesh's ranks (``launch.mesh.fake_mesh``), ``n_ranks_traced``,
    ``rank_traced`` and ``rankN``."""
    sharded = mesh.size() > 1
    with fake_mesh(mesh, traced_rank(cfg, shape, mesh)) if sharded else \
            contextlib.nullcontext(mesh) as m:
        trace, cell = run_step(cfg, shape, m, grad_accum)
        return record(cfg, m, trace, *cell)


def run_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
             grad_accum: int = TRAIN_GRAD_ACCUM, device: str = "meta"):
    """One call of the cell's step (``build_cell``) under ``OpTrace``, under
    the cell's rules where ``mesh`` is a ``DeviceMesh`` -> (the trace, the
    ``build_cell`` tuple with the step's output in place of the step)."""
    rules = choose_layout(cfg, shape, mesh)
    fn, args, in_specs, out_specs, donate = build_cell(
        cfg, shape, mesh, rules, grad_accum=grad_accum, device=device)
    sharded = not isinstance(mesh, AbstractMesh)
    with use_rules(rules if sharded else None), OpTrace() as trace:
        out = fn(*args)
    return trace, (out, args, in_specs, out_specs, donate)


def record(cfg: ModelConfig, mesh, trace, out, args, in_specs, out_specs,
           donate) -> dict:
    """The record's ``n_chips``, ``lower_s``, ``memory``, ``cost``,
    ``collectives``, ``hlo_ops`` and ``hlo_len`` from one traced call
    (``run_step``): the traced rank's own on a mesh of more than one chip
    (``rankN``), else the whole program's."""
    sizes = axis_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    sharded = chips > 1
    arg_b = tree_bytes(args, in_specs, sizes, cfg)
    out_b = tree_bytes(out, out_specs, sizes, cfg)
    alias_b = sum(tree_bytes(args[i], in_specs[i], sizes, cfg)
                  for i in donate)
    made_out = trace.made_bytes(out)
    written = sum(trace.written_bytes.values())
    if sharded:
        # the traced rank's own: its shards of the arguments, what it made
        # and wrote
        compulsory, temp_b, split = arg_b + made_out + written, \
            max(trace.peak_bytes - made_out, 0), f"rank{mesh.get_rank()}"
    else:
        compulsory = tree_bytes(args, None, {}, cfg) + made_out + written
        temp_b, split = max(trace.peak_bytes - made_out, 0) / chips, "even"
    per = 1 if sharded else chips
    rec = {"n_chips": chips, "lower_s": trace.seconds}
    rec["memory"] = {
        "argument_gb": arg_b / 1e9,
        "output_gb": out_b / 1e9,
        "alias_gb": alias_b / 1e9,
        "temp_gb": temp_b / 1e9,
        "temp_split": split,
        "peak_gb": (arg_b + out_b + temp_b - alias_b) / 1e9,
    }
    rec["cost"] = {
        "flops_per_device": trace.flops / per,
        "transcendentals": trace.transcendentals / per,
        "bytes_accessed": trace.bytes_accessed / per,
        "compulsory_bytes": compulsory / per,
        "split": split,
    }
    rec["collectives"] = collective_stats(trace)
    if sharded:
        rec["n_ranks_traced"] = 1
        rec["rank_traced"] = mesh.get_rank()
        rec[split] = rank_work(trace)
    rec["hlo_ops"] = dict(op_census(trace, top=12))
    rec["hlo_len"] = len(trace.ops)
    return rec


def rank_work(trace) -> dict:
    """A sharded record's ``rankN`` (module docstring)."""
    flops, shapes, largest = Counter(), {}, {}
    products = Counter()
    for op in trace.ops:
        flops[op.name] += op.flops
        if op.shape:
            shapes.setdefault(op.name, set()).add(op.shape)
        if op.operands:
            products[" @ ".join("x".join(map(str, s))
                                for s in op.operands)] += op.flops
    groups = {}
    for kind, operand, output, _, ranks in trace.collectives:
        big = largest.setdefault(kind, {"operand_bytes": 0,
                                        "output_bytes": 0})
        big["operand_bytes"] = max(big["operand_bytes"], operand)
        big["output_bytes"] = max(big["output_bytes"], output)
        by = groups.setdefault(kind, {}).setdefault(
            str(ranks), {"count": 0, "operand_bytes": 0})
        by["count"] += 1
        by["operand_bytes"] += operand
    for name, s in trace.route_shapes.items():
        shapes.setdefault(name, set()).update(s)
    return {"op_flops": {n: f for n, f in flops.items() if f},
            "kernel_shapes": {n: sorted(map(list, s))
                              for n, s in shapes.items()},
            "product_shapes": dict(products.most_common()),
            "largest_collective": largest, "collective_groups": groups}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None, tag: str = "",
             grad_accum: int = TRAIN_GRAD_ACCUM, layers: int = 0) -> dict:
    """``layers``: the depth the cell is cut to (0: the config's own); the
    record keeps it under ``layers``."""
    cfg = cfg_override or get_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    shape = LM_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multipod" if multi_pod else "pod",
           "kind": shape.kind, "tag": tag}
    if layers:
        rec["layers"] = layers
    rec.update(trace_cell(cfg, shape, mesh, grad_accum=grad_accum))
    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "mesh", "lower_s")}), flush=True)
    return rec


def calibration_cells(arch: str) -> list:
    """The reference's two calibration configs: cal1 = 1 superblock, cal2 =
    1 superblock + 1 superblock as tail.  The eager trace runs every layer,
    so the roofline needs no correction from them
    (``roofline/analysis.py``); cost(cal2) - cost(cal1) is still one
    superblock's exact cost."""
    cfg = get_config(arch)
    pat = cfg.pattern_len
    c1 = replace(cfg, n_layers=pat, scan_reps_cap=1)
    c2 = replace(cfg, n_layers=2 * pat, scan_reps_cap=1)
    return [("cal1", c1), ("cal2", c2)]


def _save(rec: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("tag"):
        name += f"__{rec['tag']}"
    (OUT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--calibrate", action="store_true",
                    help="trace cal1/cal2 calibration variants too")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every cell to this many layers (0: full depth)")
    args = ap.parse_args()

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    meshes = [False, True] if args.mesh == "both" else \
        [args.mesh == "multipod"]
    failures = []
    for arch in archs:
        shapes = [s.name for s in shapes_for(arch)]
        if args.shape:
            shapes = [args.shape]
        for sn in shapes:
            for mp in meshes:
                name = f"{arch}__{sn}__{'multipod' if mp else 'pod'}"
                if args.skip_existing and (OUT_DIR / f"{name}.json").exists():
                    print("skip", name)
                    continue
                try:
                    rec = run_cell(arch, sn, mp, layers=args.layers)
                    _save(rec)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((name, repr(e)[:200]))
                    continue
                if args.calibrate and not mp:
                    for tag, ccfg in calibration_cells(arch):
                        cname = f"{name}__{tag}"
                        if args.skip_existing and \
                                (OUT_DIR / f"{cname}.json").exists():
                            continue
                        try:
                            rec = run_cell(arch, sn, mp, cfg_override=ccfg,
                                           tag=tag)
                            _save(rec)
                        except Exception as e:  # noqa: BLE001
                            traceback.print_exc()
                            failures.append((cname, repr(e)[:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("dry-run complete: all cells traced")


if __name__ == "__main__":
    main()

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

No sharding rules are set while tracing: the port's model is unsharded
apart from ``moe_sharded``, so a cell runs the whole program at global
shapes.  The record keeps the reference's keys where they mean the same:

* ``memory``: ``argument_gb``, ``output_gb`` and ``alias_gb`` (the donated
  arguments) are per device and exact, each leaf's shard taken from its
  spec (a dim split n ways takes ceil(dim / n)).  ``temp_gb`` is the trace's
  peak of live intermediates (``temp_split: "even"``: divided by the
  chips), ``peak_gb`` the reference's sum.
* ``cost``: ``flops_per_device``, ``transcendentals`` and
  ``bytes_accessed`` (eager traffic: each op's operand and result bytes)
  are the global counts over the chips (``split: "even"``);
  ``compulsory_bytes`` reads the arguments once and writes the outputs once
  (an argument updated in place counts the bytes written into it).
* ``collectives``: ``collective_stats`` of the trace on one device; null on
  a production mesh, where the unsharded program issues none of the
  collectives XLA's partitioner inserts (``collectives_note``).
* ``hlo_ops``: the op census (top 12); ``hlo_len``: the ops traced;
  ``lower_s``: the trace's seconds (eager has no ``compile_s``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    ... --calibrate     # also trace the R=1/R=2 calibration models
"""
from __future__ import annotations

import argparse
import json
import traceback
from dataclasses import replace
from pathlib import Path

import torch
from torch import nn

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs, shapes_for)
from repro_torch.distributed.context import axis_sizes, pspec
from repro_torch.distributed.layouts import (batch_pspecs, cache_pspecs,
                                             choose_layout, opt_pspecs,
                                             param_pspecs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_cache, init_params, weights
from repro_torch.models.io import batch_specs, decode_specs
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.roofline.trace import OpTrace, collective_stats, op_census
from repro_torch.serving.steps import build_decode_step, build_prefill_step
from repro_torch.train.steps import build_train_step, init_train_state

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
COLLECTIVES_NOTE = ("not counted: the port's model is unsharded apart from "
                    "moe_sharded, so it issues none of the collectives a "
                    "partitioner inserts on this mesh")


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


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
               grad_accum: int = TRAIN_GRAD_ACCUM):
    """Returns (fn, abstract_args, in_specs, out_specs, donate): the
    arguments on the meta device, the specs nested as the arguments (a
    model or a dict keyed by parameter names against specs keyed by leaf
    key)."""
    if shape.kind == "train":
        # unsharded: the sharded step (DTensor params from
        # layouts.shard_params, grad_shardings and update_constraint from
        # opt_pspecs through layouts.param_placements, as the reference's
        # build_cell passes them) exists, and tracing it on a fake mesh is
        # ROADMAP's A14
        opt = make_optimizer(cfg.optimizer, cfg=cfg)
        lr = cosine_schedule(3e-4, 100, 10_000)
        state = init_train_state(None, cfg, opt, device="meta")
        pspecs = param_pspecs(state["params"], cfg, rules)
        step_fn = build_train_step(cfg, opt, lr, grad_accum=grad_accum)
        state_specs = {
            "params": pspecs,
            "opt": _opt_state_pspecs(state["opt"], state["params"], pspecs,
                                     mesh, cfg),
            "step": (),
        }
        batch = batch_specs(cfg, shape)
        bspecs = batch_pspecs(batch, rules)
        return (step_fn, (state, batch), (state_specs, bspecs),
                (state_specs, None), (0,))

    params = init_params(cfg, None, device="meta")
    pspecs = param_pspecs(params, cfg, rules)

    if shape.kind == "prefill":
        step_fn = build_prefill_step(cfg)
        batch = batch_specs(cfg, shape)
        bspecs = batch_pspecs(batch, rules)
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        cspecs = cache_pspecs(cache, cfg, rules)
        tok_spec = pspec(rules.rules.get("batch"))
        return (step_fn, (params, batch), (pspecs, bspecs),
                (tok_spec, cspecs), ())

    # decode
    decode = build_decode_step(cfg)
    dspec = decode_specs(cfg, shape)
    cspecs = cache_pspecs(dspec["cache"], cfg, rules)
    b = rules.rules.get("batch")

    def decode_step(params, cache, tokens, pos):
        # pos is the reference's int32 scalar argument; a meta tensor holds
        # no value and a step's work does not depend on it, so the step
        # runs at the cache's last position
        return decode(params, cache, tokens, shape.seq_len - 1)
    in_specs = (pspecs, cspecs, pspec(b, None), ())
    out_specs = (pspec(b, None), cspecs)
    abstract = (params, dspec["cache"], dspec["tokens"], dspec["pos"])
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


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               grad_accum: int = TRAIN_GRAD_ACCUM) -> dict:
    """One call of the cell's step under ``OpTrace`` -> the record's
    ``n_chips``, ``lower_s``, ``memory``, ``cost``, ``collectives``,
    ``hlo_ops`` and ``hlo_len`` (module docstring)."""
    rules = choose_layout(cfg, shape, mesh)
    sizes = axis_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    fn, args, in_specs, out_specs, donate = build_cell(
        cfg, shape, mesh, rules, grad_accum=grad_accum)
    with OpTrace() as trace:
        out = fn(*args)
    arg_b = tree_bytes(args, in_specs, sizes, cfg)
    out_b = tree_bytes(out, out_specs, sizes, cfg)
    alias_b = sum(tree_bytes(args[i], in_specs[i], sizes, cfg)
                  for i in donate)
    made_out = trace.made_bytes(out)
    compulsory = tree_bytes(args, None, {}, cfg) + made_out + \
        sum(trace.written_bytes.values())
    temp_b = max(trace.peak_bytes - made_out, 0) / chips
    rec = {"n_chips": chips, "lower_s": trace.seconds}
    rec["memory"] = {
        "argument_gb": arg_b / 1e9,
        "output_gb": out_b / 1e9,
        "alias_gb": alias_b / 1e9,
        "temp_gb": temp_b / 1e9,
        "temp_split": "even",
        "peak_gb": (arg_b + out_b + temp_b - alias_b) / 1e9,
    }
    rec["cost"] = {
        "flops_per_device": trace.flops / chips,
        "transcendentals": trace.transcendentals / chips,
        "bytes_accessed": trace.bytes_accessed / chips,
        "compulsory_bytes": compulsory / chips,
        "split": "even",
    }
    if chips == 1:
        rec["collectives"] = collective_stats(trace)
    else:
        rec["collectives"] = None
        rec["collectives_note"] = COLLECTIVES_NOTE
    rec["hlo_ops"] = dict(op_census(trace, top=12))
    rec["hlo_len"] = len(trace.ops)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None, tag: str = "",
             grad_accum: int = TRAIN_GRAD_ACCUM) -> dict:
    cfg = cfg_override or get_config(arch)
    shape = LM_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multipod" if multi_pod else "pod",
           "kind": shape.kind, "tag": tag}
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
                    rec = run_cell(arch, sn, mp)
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

"""Dry-run records of train and serving cells on a production mesh, from
the reference or from the port, for tests/test_torch_dryrun_mesh.py and
the side-by-side of PERF.md §7 (not a test module: the reference's dry-run
forces 512 host devices before JAX starts, so each side runs in a process
of its own).

    python tests/dryrun_records_worker.py {reference,port} CELL[,CELL...] \
        {smoke,full} {pod,multipod} [--shape SHAPE] [--layers N] \
        [--seq S --batch B] [--accum A] [--rank R]

The step of each ARCH's smoke or full config cut to N layers (default:
one superblock, the fewest the reference's layer scan takes) on the
``--shape``: ``train_4k`` (the default; the train step), ``prefill_32k``
(the prefill step), ``decode_32k`` or ``long_500k`` (a decode step at the
cache's last position), at its own length and batch or S x B tokens.  A
CELL written ``ARCH@HxK[:PACK]`` takes H q heads and K kv heads (and the
config's ``attn_causal_pack`` PACK), ``.../L`` L layers in the place of
N, ``...~V`` (``whisper-small~515``) a vocab of V tokens (C14's cell: a
vocab that the 16 ``model`` ranks do not divide, so the head is not cut
on it), and ``...+SHAPE[:SxB]`` (``gemma3-1b/6+decode_32k``) its own
shape, at S x B tokens where given, so that one process compiles cells of
several shapes, and ``...#WIDTH[.MESH]``
(``rwkv6-7b/1+decode_32k#full.multipod``) its own width and mesh, at
its shape's own tokens (or its ``:SxB``), so that one process compiles
smoke and full-width cells on both meshes: the reference's compiled as its ``run_cell`` does
(``repro.launch.dryrun.build_cell``, XLA's cost analysis and HLO), the
port's traced as rank R (default 0) of a fake world
(``repro_torch.launch.dryrun.run_step``).  XLA compiles one program for
every device; the port's ranks differ where their work does (flash's
q-rows route).  Prints one JSON line a CELL (``cell``: as written), with
the same keys for both sides: ``shape``, ``flops_per_device``,
``collectives`` (each side's own ``collective_stats``),
``attention_flops`` and ``product_flops``.

The reference cannot compile some cells on ``pod``: the MoE smoke
configs (an Adafactor state of 8 experts does not split over 16 ranks),
rwkv6-7b's smoke prefill and decode (its state's 4 heads do not split
over 16), a decode step shorter than one superblock (gemma2-9b at 1
layer) and the smoke configs' ``long_500k`` with a ring cache (32 slots
over 256 ranks).

``attention_flops`` are the products of q.k and p.v: in the reference the
batched dots (its ``bskgd,btkd->bkgst`` einsums; its projections, MLPs and
head are unbatched dots; at a batch of 1 XLA drops the batch dim and
its attention dots count as products), in the port the
``flash_attention`` ops (``flash_flops``, the port's alone) and the eager
attention's ``bmm``.  ``product_flops`` are the other dots
(the reference's unbatched dots, the port's ``mm``).  The split holds for
the dense archs; a MoE's expert products are batched too.  XLA's cost
analysis counts a loop's body once per trip where the trip count is known;
one superblock keeps the layer scan to one trip.

Each side also reports ``products_by_shape``: its ``product_flops`` split
by the product's operand shapes, ``"MxK @ KxN"`` (the reference's dots by
their HLO operands, the port's ``mm`` by its local operands: the
record's ``rankN.product_shapes``), so that a product whole on every port
rank and split in the reference's record shows by name.  The port's side
also gives the record's ``rankN.collective_groups`` (each kind's count
and bytes by the size of the group it ran over: on ``multipod`` 2 is
``pod`` alone) and ``rankN.kernel_shapes`` (the routes' local shapes).
"""
import argparse
import collections
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

_SHAPE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
_DOT = re.compile(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%([\w.\-]+),\s*"
                  r"%([\w.\-]+)\)")
# the shapes a cell takes (``configs.base.LM_SHAPES``; ``long_500k`` is a
# decode too)
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
_DIMS = re.compile(r"(lhs_batch_dims|lhs_contracting_dims)=\{([\d,]*)\}")


def _dims(s: str) -> list:
    return [int(d) for d in s.split(",") if d]


def _shape_key(a, b) -> str:
    return " @ ".join("x".join(map(str, s)) for s in (a, b))


def dot_flops(hlo: str) -> dict:
    """{"attention_flops", "product_flops", "products_by_shape"}: 2 x
    output elements x contracted size of every dot of the HLO, batched and
    unbatched, and the unbatched ones by their operands' shapes."""
    lines = hlo.splitlines()
    shapes = {m.group(1): _dims(m.group(2))
              for m in map(_SHAPE.match, lines) if m}
    out = {"attention_flops": 0, "product_flops": 0}
    by_shape = collections.Counter()
    for line in lines:
        m = _DOT.search(line)
        if not m:
            continue
        dims = dict(_DIMS.findall(line))
        lhs, n = shapes[m.group(2)], 2
        for d in _dims(m.group(1)):
            n *= d
        for d in _dims(dims["lhs_contracting_dims"]):
            n *= lhs[d]
        batched = bool(_dims(dims.get("lhs_batch_dims", "")))
        out["attention_flops" if batched else "product_flops"] += n
        if not batched:
            by_shape[_shape_key(lhs, shapes[m.group(3)])] += n
    return {**out, "products_by_shape": dict(by_shape)}


def _cfg_shape(configs, arch, width, layers, seq, batch, heads="", vocab=0,
               shape_name="train_4k"):
    """The cell's config and shape; ``heads``: "HxK" or "HxK:PACK", the q
    and kv heads and the config's ``attn_causal_pack`` replaced;
    ``vocab``: the vocab's size, where it is not 0; ``shape_name``: the
    ``LM_SHAPES`` entry whose length and batch ``seq`` and ``batch``
    replace, where they are not 0."""
    base = configs.get_smoke_config(arch) if width == "smoke" \
        else configs.get_config(arch)
    cfg = dataclasses.replace(base, n_layers=layers or base.pattern_len,
                              vocab_size=vocab or base.vocab_size)
    if heads:
        hk, _, pack = heads.partition(":")
        H, K = (int(h) for h in hk.split("x"))
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K,
                                  attn_causal_pack=pack or
                                  cfg.attn_causal_pack)
    shape = configs.LM_SHAPES[shape_name]
    if seq:
        shape = dataclasses.replace(shape, seq_len=seq, global_batch=batch)
    return cfg, shape


def reference(arch, width, mesh_name, layers=0, seq=0, batch=0,
              accum=1, heads="", vocab=0, shape_name="train_4k") -> dict:
    from repro.launch import dryrun as ref    # first: forces 512 devices
    import jax
    from repro.configs import base as configs
    from repro.distributed import context as dctx
    from repro.distributed.layouts import choose_layout
    from repro.launch.mesh import make_production_mesh
    from repro.roofline.hlo import collective_stats
    cfg, shape = _cfg_shape(configs, arch, width, layers, seq, batch,
                            heads, vocab, shape_name)
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    rules = choose_layout(cfg, shape, mesh)
    t0 = time.perf_counter()
    with dctx.use_rules(rules):
        fn, abstract, in_sh, out_sh, donate = ref.build_cell(
            cfg, shape, mesh, rules, grad_accum=accum)
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*abstract).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    hlo = compiled.as_text()
    return {"side": "reference", "version": f"jax {jax.__version__}",
            "shape": shape.name, "layers": cfg.n_layers, "n_chips": int(mesh.devices.size),
            "seconds": time.perf_counter() - t0,
            "flops_per_device": float(ca.get("flops", 0.0)),
            "collectives": collective_stats(hlo), **dot_flops(hlo)}


def port(arch, width, mesh_name, layers=0, seq=0, batch=0, accum=1,
         heads="", vocab=0, rank=0, shape_name="train_4k") -> dict:
    import torch
    from repro_torch.configs import base as configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh
    cfg, shape = _cfg_shape(configs, arch, width, layers, seq, batch,
                            heads, vocab, shape_name)
    with fake_mesh(make_production_mesh(
            multi_pod=mesh_name == "multipod"), rank) as mesh:
        trace, cell = dryrun.run_step(cfg, shape, mesh, accum)
        rec = dryrun.record(cfg, mesh, trace, *cell)
    flops = collections.Counter()
    for op in trace.ops:
        flops[op.name] += op.flops
    return {"side": "port", "version": f"torch {torch.__version__}",
            "shape": shape.name, "layers": cfg.n_layers, "n_chips": rec["n_chips"],
            "rank": rec["rank_traced"],
            "seconds": trace.seconds,
            "flops_per_device": rec["cost"]["flops_per_device"],
            "collectives": rec["collectives"],
            "attention_flops": flops["flash_attention"] + flops["aten.bmm"],
            "flash_flops": flops["flash_attention"],
            "product_flops": flops["aten.mm"],
            "products_by_shape":
                rec[f"rank{rec['rank_traced']}"]["product_shapes"],
            "collective_groups":
                rec[f"rank{rec['rank_traced']}"]["collective_groups"],
            "kernel_shapes":
                rec[f"rank{rec['rank_traced']}"]["kernel_shapes"]}


def parse_cell(cell: str) -> tuple:
    """``ARCH[@HxK[:PACK]][/L][~V][+SHAPE[:SxB]][#WIDTH[.MESH]]`` -> (ARCH,
    "HxK[:PACK]", L, V, SHAPE, S, B, WIDTH, MESH); an absent L, V, S or B
    is 0, an absent SHAPE, WIDTH or MESH ""."""
    cell, _, place = cell.partition("#")
    width, _, mesh = place.partition(".")
    cell, _, shape = cell.partition("+")
    shape, _, size = shape.partition(":")
    seq, _, batch = size.partition("x")
    name, _, vocab = cell.partition("~")
    name, _, layers = name.partition("/")
    arch, _, heads = name.partition("@")
    return (arch, heads, int(layers or 0), int(vocab or 0), shape,
            int(seq or 0), int(batch or 0), width, mesh)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("side", choices=("reference", "port"))
    ap.add_argument("arch")
    ap.add_argument("width", choices=("smoke", "full"))
    ap.add_argument("mesh", choices=("pod", "multipod"))
    ap.add_argument("--shape", default="train_4k", choices=SHAPES)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    for cell in a.arch.split(","):
        arch, heads, layers, vocab, shape, seq, batch, width, mesh = \
            parse_cell(cell)
        shape = shape or a.shape
        if not width:
            # the process's width, mesh and tokens; a cell that names its
            # width takes its shape's own tokens, or its ``:SxB``
            width, seq, batch = a.width, seq or a.seq, batch or a.batch
        args = (arch, width, mesh or a.mesh, layers or a.layers, seq, batch,
                a.accum, heads, vocab)
        rec = reference(*args, shape_name=shape) if a.side == "reference" \
            else port(*args, rank=a.rank, shape_name=shape)
        print(json.dumps({"cell": cell, "arch": arch, "width": args[1],
                          "mesh": args[2], "accum": a.accum,
                          "heads": heads, **rec}),
              flush=True)


if __name__ == "__main__":
    main()

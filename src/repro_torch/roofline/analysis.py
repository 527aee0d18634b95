"""Three-term roofline from the dry-run records, on one NVIDIA H100.

    compute term    = flops / (chips * peak_FLOP/s)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

Port of ``repro.roofline.analysis``.  The records are ``launch/dryrun.py``'s
(``experiments/dryrun_torch/``): flops, bytes and collectives counted op by
op over an eager trace (``roofline.trace``), on a production mesh one
rank's own (``split: "rankN"``: the sharded step traced as the rank with
the most work, ``launch.dryrun.traced_rank``, of a fake world of the
mesh's ranks).  Two of the reference's corrections have no place
here:

* ``CPU_BYTES_ADJ``: XLA's CPU backend turns bf16 dots into f32, which
  inflates the reference's HLO bytes; the trace counts every tensor at its
  real dtype, so the factor is 1 and is left out.
* The scan correction: XLA counts a while-loop body once, so the reference
  rebuilds a cell's totals from two calibration cells; the eager trace runs
  every layer, so a cell is used as it is and ``corrected`` stays False.

A record written before the dry-run traced sharded cells has ``collectives``
null on a production mesh; only there is the collective term None (and
``dominant`` taken over the two known terms).

The H100 constants are ``roofline.bounds``'s: ``LINK_BW`` NVLink per card
within a node, ``DCN_BW`` one InfiniBand port per card between nodes.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import (LM_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs, shapes_for)
from repro_torch.roofline.bounds import (DCN_BW, LINK_BW, PEAK_BF16_FLOPS,
                                         PEAK_BYTES)

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# measured / predicted peak memory of a step (``max_memory_allocated`` on
# the card against a dry-run record's ``peak_gb``).  The 21 steps that
# ``chip_smoke.py`` times read 0.9965 (rwkv6-7b train) to 1.1270
# (h2o-danube-1.8b train), the same to four places on every run: the
# allocator's rounding and CUDA-side temporaries (cuBLAS workspaces, sort
# and nonzero buffers) that the trace does not see.  The band keeps about 5%
# on either side, so a state leaf left out of the count fails: without its
# 3.66 GB of parameters (or of gradients) h2o's train step reads 1.25.
PEAK_BAND = (0.95, 1.2)


# ---------------------------------------------------------------------------
# the dry-run records
# ---------------------------------------------------------------------------
def _load(name: str):
    p = DRYRUN / f"{name}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _coll_bytes(rec):
    """Operand bytes of the record's collectives; None in a record written
    before sharded cells were traced."""
    if rec["collectives"] is None:
        return None
    return sum(v["operand_bytes"] for v in rec["collectives"].values())


def step_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D for a train step, 2 N D for a prefill, 2 N B for one decode
    token (N the config's active parameters)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: one token


def model_flops(arch: str, shape_name: str) -> float:
    return step_model_flops(get_config(arch), LM_SHAPES[shape_name])


def analyze_cell(arch: str, shape_name: str, mesh: str = "pod") -> dict:
    rec = _load(f"{arch}__{shape_name}__{mesh}")
    if rec is None:
        return {}
    chips = rec["n_chips"]
    flops = rec["cost"]["flops_per_device"]
    bts = rec["cost"]["bytes_accessed"]
    coll = _coll_bytes(rec)

    compute_t = flops / PEAK_BF16_FLOPS
    memory_t = bts / PEAK_BYTES
    coll_t = None if coll is None else coll / LINK_BW
    terms = {"compute": compute_t, "memory": memory_t}
    if coll_t is not None:
        terms["collective"] = coll_t
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    mf = model_flops(arch, shape_name)
    traced_global = flops * chips
    ratio = mf / traced_global if traced_global else 0.0
    roofline_frac = (mf / chips / PEAK_BF16_FLOPS) / bound_s if bound_s \
        else 0.0
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips,
        "kind": rec["kind"], "corrected": False,
        "compute_s": compute_t, "memory_s_raw": memory_t,
        "memory_s": memory_t, "collective_s": coll_t,
        "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": traced_global,
        "useful_ratio": ratio,
        "roofline_fraction": roofline_frac,
        "peak_gb": rec["memory"]["peak_gb"],
        "recommendation": _recommend(dominant, arch, shape_name, ratio),
    }


def _recommend(dominant: str, arch: str, shape: str, ratio: float) -> str:
    if dominant == "collective":
        return ("coalesce/overlap boundary collectives (Databelt fusion) or "
                "reshard to keep state motion on-chip")
    if dominant == "memory":
        if "decode" in shape or "500k" in shape:
            return "KV/state layout: larger per-chip batch or quantized KV"
        return ("reduce activation traffic: fused kernels (flash attention) "
                "and less remat recompute")
    if ratio < 0.4:
        return ("compute-bound but low useful ratio: cut remat recompute / "
                "masked-attention waste (flash kernel block skipping)")
    return "compute-bound near roofline: scale batch or accept"


def analyze_all(mesh: str = "pod") -> list:
    rows = []
    for arch in list_archs():
        for s in shapes_for(arch):
            r = analyze_cell(arch, s.name, mesh)
            if r:
                rows.append(r)
    return rows


def _num(x, fmt: str) -> str:
    return "n/a" if x is None else format(x, fmt)


def to_markdown(rows) -> str:
    hdr = ("| arch | shape | comp s | mem s | coll s | bound | "
           "MODEL/HLO | roofline frac | peak GB |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {_num(r['collective_s'], '.4f')} | "
            f"{r['dominant'][:4]} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['peak_gb']:.1f} |\n")
    return "".join(out)


def main():
    rows = analyze_all()
    DRYRUN.mkdir(parents=True, exist_ok=True)
    (DRYRUN / "roofline.json").write_text(json.dumps(rows, indent=1))
    print(to_markdown(rows))
    worst = sorted((r for r in rows if r["roofline_fraction"] > 0),
                   key=lambda r: r["roofline_fraction"])[:5]
    print("\nworst roofline fractions:")
    for r in worst:
        print(f"  {r['arch']} {r['shape']}: {r['roofline_fraction']:.3f} "
              f"({r['dominant']})")
    coll = sorted((r for r in rows if r["collective_s"] is not None),
                  key=lambda r: -r["collective_s"])[:5]
    print("most collective-bound:")
    for r in coll:
        print(f"  {r['arch']} {r['shape']}: coll {r['collective_s']:.4f}s")


# ---------------------------------------------------------------------------
# multi-pod comparison: what the pod (inter-node) axis costs
# ---------------------------------------------------------------------------
def compare_meshes() -> list:
    """Per train/prefill cell: single-pod vs multi-pod collective picture.
    The pod axis is pure DP, so multi-pod adds a cross-node gradient
    reduction; everything else stays intra-pod.  The DCN term prices the
    growth of rank 0's collective bytes at ``DCN_BW``.  A record without
    collectives (written before sharded cells were traced) gives None."""
    rows = []
    for arch in list_archs():
        for s in shapes_for(arch):
            if s.kind == "decode":
                continue
            a = _load(f"{arch}__{s.name}__pod")
            b = _load(f"{arch}__{s.name}__multipod")
            if not a or not b:
                continue
            ca, cb = _coll_bytes(a), _coll_bytes(b)
            known = ca is not None and cb is not None
            rows.append({
                "arch": arch, "shape": s.name,
                "pod_coll_gb": None if ca is None else ca / 1e9,
                "multipod_coll_gb": None if cb is None else cb / 1e9,
                "delta_gb": (cb - ca) / 1e9 if known else None,
                "dcn_term_s": max(cb - ca, 0) / DCN_BW if known else None,
                "pod_peak_gb": a["memory"]["peak_gb"],
                "multipod_peak_gb": b["memory"]["peak_gb"],
            })
    return rows


def multipod_markdown() -> str:
    rows = compare_meshes()
    out = ["| arch | shape | pod coll GB | 2-pod coll GB | Δ GB | "
           "DCN term s |\n|---|---|---|---|---|---|\n"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {_num(r['pod_coll_gb'], '.2f')} "
            f"| {_num(r['multipod_coll_gb'], '.2f')} | "
            f"{_num(r['delta_gb'], '+.2f')} | "
            f"{_num(r['dcn_term_s'], '.3f')} |\n")
    return "".join(out)


if __name__ == "__main__":
    main()

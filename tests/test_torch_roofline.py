"""The port's roofline (repro_torch.roofline) against the reference's.

* ``trace.collective_stats`` against ``repro.roofline.hlo.collective_stats``
  on the collectives of the reference's own HLO snippet
  (tests/test_roofline_serving.py), issued on a 4-rank fake process group
  (torch's in-process ``"fake"`` backend: every rank's calls, no data
  moved) through both ``c10d`` and ``_c10d_functional``: equal kind by kind.
* ``analysis`` against the reference's on the same synthetic records, with
  the port's H100 constants set to the reference's and the reference's
  ``CPU_BYTES_ADJ`` to 1 (the port has none): equal rows and tables.
* ``ModelConfig.param_count``: equal for all ten archs.
* The reference's calibration premise on the trace: a cell's flops and
  bytes grow by the same amount with each superblock, exactly.
* The kernels' meta paths: the plain version's shapes and dtypes, and one
  op each of the moved bound formulas' work.
* The MoE dispatch traced on the meta device (its mask sizes at their
  upper bound T*k) counts what the real dispatch does on CPU tensors when
  nothing is dropped; a remat train step of a MoE config traces.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.roofline import analysis as jan  # noqa: E402
from repro.roofline.hlo import COLLECTIVES  # noqa: E402
from repro.roofline.hlo import collective_stats as hlo_stats  # noqa: E402
from repro_torch.configs.base import (ShapeConfig, get_config,  # noqa: E402
                                      get_smoke_config, list_archs)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bkg, flash_attention_ref)
from repro_torch.kernels.rglru_scan import rglru_scan_bsc  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import wkv6_bh, wkv6_ref  # noqa: E402
from repro_torch.launch.dryrun import trace_cell  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.roofline import analysis as tan  # noqa: E402
from repro_torch.roofline import bounds  # noqa: E402
from repro_torch.roofline.trace import (OpTrace, collective_stats,  # noqa: E402
                                        total_collective_bytes)
from test_roofline_serving import HLO_SNIPPET  # noqa: E402

ONE = AbstractMesh(("data", "model"), (1, 1))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_group():
    """Rank 0 of a 4-rank fake process group (no other process, no data
    moved); destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_c10d_collectives_match_the_reference_hlo(fake_group):
    """HLO_SNIPPET: all-reduce, all-gather (x4) and reduce-scatter of an f32
    (16, 128), and a permute of a bf16 (4, 8): a send to the next rank and a
    recv from the previous one."""
    x = torch.zeros(16, 128)
    y = torch.zeros(4, 8, dtype=torch.bfloat16)
    with OpTrace() as trace:
        dist.all_reduce(x)
        dist.all_gather_into_tensor(torch.empty(64, 128), x)
        dist.reduce_scatter_tensor(torch.empty(4, 128), x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, 1),
                dist.P2POp(dist.irecv, torch.empty_like(y), 3)]):
            req.wait()
    assert collective_stats(trace) == hlo_stats(HLO_SNIPPET)


def test_functional_collectives_match_the_reference_hlo(fake_group):
    import torch.distributed._functional_collectives as funcol
    x = torch.zeros(16, 128)
    with OpTrace() as trace:
        funcol.all_reduce(x, "sum", fake_group).wait()
        funcol.all_gather_tensor(x, 0, fake_group).wait()
        funcol.reduce_scatter_tensor(x, "sum", 0, fake_group).wait()
    want = hlo_stats(HLO_SNIPPET)
    want["collective-permute"] = {"count": 0, "operand_bytes": 0,
                                  "output_bytes": 0}
    assert collective_stats(trace) == want


def test_a_product_alone_has_no_collective_bytes():
    x = torch.zeros(8, 8)
    with OpTrace() as trace:
        x @ x.T
    assert total_collective_bytes(collective_stats(trace)) == 0
    assert trace.flops == 2 * 8 * 8 * 8


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------
def _record(arch, shape, mesh, kind, chips, i):
    """A synthetic dry-run record (numbers made from i)."""
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
            "tag": "", "n_chips": chips,
            "memory": {"argument_gb": 1.5 + i, "output_gb": 0.5 * i,
                       "alias_gb": 0.25 * i, "temp_gb": 3.0 + i,
                       "peak_gb": 5.0 + 2 * i},
            "cost": {"flops_per_device": 1e13 * (i + 1) ** 1.5,
                     "transcendentals": 1e9 * i,
                     "bytes_accessed": 1e11 * (7 - i) ** 2},
            "collectives": {k: {"count": i, "operand_bytes": 1e9 * i * (j + 1),
                                "output_bytes": 2e9 * i}
                            for j, k in enumerate(COLLECTIVES)}}


@pytest.fixture
def records(tmp_path, monkeypatch):
    """Both packages read the same synthetic records, the port on the
    reference's constants, the reference without its CPU byte correction."""
    cells = [("h2o-danube-1.8b", "train_4k", "train"),
             ("h2o-danube-1.8b", "prefill_32k", "prefill"),
             ("gemma3-1b", "decode_32k", "decode"),
             ("gemma3-1b", "long_500k", "decode"),
             ("qwen3-moe-235b-a22b", "train_4k", "train"),
             ("rwkv6-7b", "prefill_32k", "prefill")]
    i = 0
    for arch, shape, kind in cells:
        for mesh, chips in (("pod", 256), ("multipod", 512)):
            rec = _record(arch, shape, mesh, kind, chips, i % 6)
            i += 1
            (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
                json.dumps(rec))
    monkeypatch.setattr(jan, "DRYRUN", tmp_path)
    monkeypatch.setattr(tan, "DRYRUN", tmp_path)
    monkeypatch.setattr(jan, "CPU_BYTES_ADJ", 1.0)
    monkeypatch.setattr(tan, "PEAK_BF16_FLOPS", jan.PEAK_FLOPS)
    monkeypatch.setattr(tan, "PEAK_BYTES", jan.HBM_BW)
    monkeypatch.setattr(tan, "LINK_BW", jan.LINK_BW)
    monkeypatch.setattr(tan, "DCN_BW", jan.DCN_BW)
    return tmp_path


def test_analysis_rows_and_tables_match_the_reference(records):
    for mesh in ("pod", "multipod"):
        rows = tan.analyze_all(mesh)
        assert len(rows) == 6
        assert rows == jan.analyze_all(mesh)
        assert tan.to_markdown(rows) == jan.to_markdown(jan.analyze_all(mesh))
    assert tan.compare_meshes() == jan.compare_meshes()
    assert tan.multipod_markdown() == jan.multipod_markdown()


def test_null_collectives_leave_the_collective_term_out(records):
    p = records / "gemma3-1b__decode_32k__pod.json"
    rec = json.loads(p.read_text())
    rec["collectives"] = None
    rec["cost"]["flops_per_device"] = 1.0      # memory-bound
    p.write_text(json.dumps(rec))
    row = tan.analyze_cell("gemma3-1b", "decode_32k")
    assert row["collective_s"] is None and row["dominant"] == "memory"
    assert "| n/a |" in tan.to_markdown([row])
    p = records / "h2o-danube-1.8b__train_4k__multipod.json"
    rec = json.loads(p.read_text())
    rec["collectives"] = None
    p.write_text(json.dumps(rec))
    row = [r for r in tan.compare_meshes() if r["arch"] == "h2o-danube-1.8b"
           and r["shape"] == "train_4k"][0]
    assert row["multipod_coll_gb"] is None and row["dcn_term_s"] is None
    assert "n/a" in tan.multipod_markdown()


@pytest.mark.parametrize("arch", list_archs())
def test_param_count_matches_the_reference(arch):
    for active in (False, True):
        assert get_config(arch).param_count(active_only=active) == \
            jax_config(arch).param_count(active_only=active)


def test_model_flops_matches_the_reference():
    for arch in list_archs():
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert tan.model_flops(arch, shape) == jan.model_flops(arch, shape)


@pytest.mark.parametrize("S,window", [(1, 0), (7, 0), (64, 0), (64, 16),
                                      (64, 64), (64, 200), (100, 1)])
def test_causal_pairs_is_the_loop_it_replaces(S, window):
    loop = sum(min(s + 1, window) if window else s + 1 for s in range(S))
    assert bounds.causal_pairs(S, S, window) == loop


@pytest.mark.parametrize("Sq,Skv,window,q0", [(64, 256, 0, 192),
                                               (64, 256, 48, 64),
                                               (16, 40, 0, 32), (8, 64, 4, 0)])
def test_causal_pairs_at_a_row_offset(Sq, Skv, window, q0):
    """Rows at positions q0..q0 + Sq - 1: the loop over the mask's allowed
    pairs, and the flash meta path records them."""
    loop = sum(1 for p in range(q0, q0 + Sq) for c in range(Skv)
               if c <= p and (not window or c > p - window))
    assert bounds.causal_pairs(Sq, Skv, window, q0=q0) == loop
    with OpTrace() as trace:
        flash_attention_bkg(_meta(2, Sq, 3, 16), _meta(2, Skv, 16),
                            _meta(2, Skv, 16), scale=0.25, window=window,
                            q0=q0)
    assert _kernel_op(trace, "flash_attention").flops == \
        4 * 16 * 2 * 3 * loop


# ---------------------------------------------------------------------------
# the trace: linearity, the kernels' meta paths, the MoE count
# ---------------------------------------------------------------------------
def _counts(cfg, kind):
    rec = trace_cell(cfg, ShapeConfig(kind, kind, 32, 2), ONE, grad_accum=1)
    return rec["cost"]["flops_per_device"], rec["cost"]["bytes_accessed"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list_archs())
def test_cost_is_linear_in_superblocks(arch, kind):
    """count(R) = count(1) + (R - 1) (count(2) - count(1)), for R = 3: the
    premise of the reference's scan calibration."""
    smoke = get_smoke_config(arch)
    c1, c2, c3 = (_counts(dataclasses.replace(
        smoke, n_layers=r * smoke.pattern_len), kind) for r in (1, 2, 3))
    for a, b, c in zip(c1, c2, c3):
        assert c == a + 2 * (b - a)
        assert b > a


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kernel_op(trace, name):
    ops = [op for op in trace.ops if op.name == name]
    assert len(ops) == 1
    return ops[0]


@pytest.mark.parametrize("BK,S,G,hd,window,dtype", [
    (2, 64, 4, 16, 0, torch.bfloat16), (3, 48, 2, 32, 16, torch.float32),
    (1, 128, 1, 64, 128, torch.bfloat16)])
def test_flash_meta_path(BK, S, G, hd, window, dtype):
    kw = dict(scale=hd ** -0.5, window=window)
    with OpTrace() as trace:
        o = flash_attention_bkg(_meta(BK, S, G, hd, dtype=dtype),
                                _meta(BK, S, hd, dtype=dtype),
                                _meta(BK, S, hd, dtype=dtype), **kw)
    want = flash_attention_ref(torch.zeros(BK, S, G, hd, dtype=dtype),
                               torch.zeros(BK, S, hd, dtype=dtype),
                               torch.zeros(BK, S, hd, dtype=dtype), **kw)
    assert (o.shape, o.dtype, o.device.type) == (want.shape, want.dtype,
                                                 "meta")
    op = _kernel_op(trace, "flash_attention")
    flops, nbytes = bounds.flash_work(BK, S, S, G, hd, window,
                                   itemsize=o.element_size())
    assert (op.flops, op.bytes) == (flops, nbytes)
    if dtype == torch.bfloat16:
        assert bounds.bound(op.flops, bounds.PEAK_BF16_FLOPS, op.bytes) == \
            bounds.flash_bound(BK, S, G, hd, window)


def test_rglru_meta_path():
    B, S, C = 2, 24, 12
    with OpTrace() as trace:
        h = rglru_scan_bsc(_meta(B, S, C), _meta(B, S, C))
    want = rglru_scan_ref(torch.zeros(B, S, C), torch.zeros(B, S, C))
    assert (h.shape, h.dtype) == (want.shape, want.dtype)
    op = _kernel_op(trace, "rglru_scan")
    assert (op.flops, op.bytes) == bounds.rglru_work(B, S, C)
    assert bounds.bound(op.flops, bounds.PEAK_F32_FLOPS, op.bytes) == \
        bounds.rglru_bound(B, S, C)


def test_wkv6_meta_path():
    BH, S, hd = 3, 20, 16
    with OpTrace() as trace:
        y, st = wkv6_bh(*(_meta(BH, S, hd) for _ in range(4)), _meta(BH, hd))
    wy, wst = wkv6_ref(*(torch.zeros(BH, S, hd) for _ in range(4)),
                       torch.zeros(BH, hd))
    assert (y.shape, y.dtype, st.shape, st.dtype) == (wy.shape, wy.dtype,
                                                      wst.shape, wst.dtype)
    op = _kernel_op(trace, "wkv6")
    assert (op.flops, op.bytes) == bounds.wkv6_work(BH, S, hd)
    assert op.transcendentals == BH * S * hd
    assert bounds.bound(op.flops, bounds.PEAK_F32_FLOPS, op.bytes) == \
        bounds.wkv6_bound(BH, S, hd)


def test_trace_counts_live_storages_once():
    """A view adds no storage; a freed intermediate leaves the live bytes;
    an in-place write into an argument is kept in written_bytes."""
    x = torch.zeros(1024)
    with OpTrace() as trace:
        y = x * 2                      # 4096 bytes made
        y.view(32, 32).t()             # a view: nothing made
        del y
        z = x + 1                      # 4096 made, y freed: peak 4096
        x.add_(1)                      # 4096 written into the argument
    assert trace.peak_bytes == 4096
    assert list(trace.written_bytes.values()) == [4096]
    assert trace.made_bytes(z) == 4096


def _routed_dispatch(p, x, cfg):
    """``moe_dense``'s routing and dispatch of one capacity group (its
    load-balance aux aside: ``F.one_hot`` takes another decomposition on the
    meta device)."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    gate, idx, _ = moe._route(xf, p.router, m.experts_per_token)
    C = moe._capacity(xf.shape[0], m.experts_per_token, m.n_experts,
                      m.capacity_factor)
    return moe._dispatch_group(p, xf, gate, idx, C,
                               moe.activation(cfg.act))


def test_moe_trace_counts_the_real_dispatch():
    """With capacity for every route and every expert local, the kept
    count is T*k: the real dispatch on CPU tensors and its trace on the meta
    device (each boolean mask's size at its upper bound) count the same
    ops, flops and bytes."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    rng = np.random.default_rng(0)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model),
                                             dtype=np.float32)).bfloat16()
    with OpTrace() as real:
        _routed_dispatch(p, x, cfg)
    fp = moe.init_moe(cfg, None, "meta")
    fx = torch.empty(x.shape, dtype=x.dtype, device="meta")
    with OpTrace() as traced:
        _routed_dispatch(fp, fx, cfg)
    assert [op.name for op in traced.ops] == [op.name for op in real.ops]
    assert traced.ops == real.ops
    assert traced.flops == real.flops > 0
    assert traced.bytes_accessed == real.bytes_accessed


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_train_step_traces_under_remat(arch):
    """Remat's recompute checks that the recomputed tensors keep their
    shapes: the bounded mask sizes are the same in both runs."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full")
    rec = trace_cell(cfg, ShapeConfig("train", "train", 32, 2), ONE,
                     grad_accum=1)
    assert rec["cost"]["flops_per_device"] > 0

"""The dry-run's production-mesh records (``launch.dryrun.trace_cell`` on
the 16 x 16 ``pod`` and 2 x 16 x 16 ``multipod`` meshes): the sharded
DTensor step traced as rank 0 of a fake world (``launch.mesh.fake_mesh``:
torch's in-process ``"fake"`` process group, every collective issued and
none moving data; the mesh of device type ``"cpu"``, its tensors on the
meta device), on the CPU.

* The repairs it needed, one test each: ``train.steps._microbatch`` on a
  batch sharded 16 and 32 ways at ``grad_accum`` 4; DTensor's all-to-all
  (``_dtensor.shard_dim_alltoall``) counted as an all-to-all of its local
  bytes, never as the all-gather of DTensor's CPU fallback
  (``context.native_alltoall``), and every op of the collective namespaces
  mapped or refused; rank 0's local ops counted, not DTensor's global-shape
  sharding propagation nor its bookkeeping, the same on a cold and a warm
  trace, and a kernel's meta path at its local shapes; the optimizers'
  state made on the device of the parameters' shards.
* A hand-counted cell: one gated MLP on a fake 16 x 16 mesh, its products'
  flops and bytes and its one collective equal to the formula.
* A 1 x 1 mesh: the records of seven smoke cells equal the ones the
  dry-run wrote before it traced sharded cells, number for number.
* The reference's record properties (``tests/test_dryrun_records.py``,
  which skips here: the reference's records are not in the repository),
  on the port's own records: qwen3-moe-235b-a22b's ``train_4k`` step on
  ``pod`` reduce-scatters; gemma2-9b's and internlm2-20b's per-device
  collective bytes on ``multipod`` are at most 1.1 times ``pod``'s; every
  arch's train cell communicates on both meshes.  Full-width cells are cut
  to one layer (gemma2-9b's is a local one); the every-arch cells are the
  smoke configs at one layer, 64 x 256 tokens, ``grad_accum`` 1, traced
  by 4 spawned processes while the other tests run.

* The reference's own records of five smoke train cells on ``pod``
  (tests/dryrun_records_worker.py, in one process): wherever the
  reference gathers or reduces, rank 0's record does too.  In the same
  process, C3's cell (``HEADS_CELL``: 16 q heads over 8 kv heads on 16
  ``model`` ranks): rank 0's attention and other products at most 1.25
  times the reference's.
* C3 and C4 in rank 0's full-width records of gemma2-9b and internlm2-20b
  (one layer, both meshes): flash on the rank's H / 16 q heads, no
  all-gather of the logits.
* C6 and C7 beside the reference's own records: paligemma-3b's and
  whisper-small's smoke cells split their prefix-LM, bidirectional and
  cross-attention by q rows (attention at most the reference's a device),
  and their products, and C5's cell's, are at most 1.25 times its (the k
  and v projections cut by columns on that route).
* C9 and C10 beside the reference's own records: rwkv6-7b's smoke
  products at most 1.25 times its (the mixes on each rank's rows), and
  recurrentgemma-2b's smoke config with 10 × 1 heads at 3 layers split by
  head groups and row blocks (attention at most the reference's, products
  at most 1.25 times, the traced rank 15 the heaviest).
* C12 and C16 beside the reference's own records of the smoke serving
  cells (``SERVING_CELLS``: five archs' decode and prefill steps at one
  superblock, and a ``long_500k`` decode step at a batch of 1): a decode
  step's products at most 1.05 times the reference's and its attention at
  most 1.25 times (the residual stream reduced over ``model`` after each
  sublayer), a prefill step's products equal; and the same bounds on
  twelve full-width decode steps (``FULL_DECODE_CELLS``), rwkv6-7b's on
  both meshes among them (C17: its LoRAs on each rank's block of the
  model dim, its recurrence on each rank's rows and heads).
* C11 and C13 beside the reference's own records: 16 q heads over 8 kv
  heads under the prefix-LM and bidirectional masks and cross-attention
  (each rank the plain dispatch on its own q head), rwkv6-7b's 4 heads on
  16 ranks (each rank the wkv6 of its own rows, the state carried):
  attention at most 1.25 times, products at most 1.05 times.
* C15 in gemma2-9b's smoke record on ``multipod``: no collective over
  ``pod`` alone, one reduction over ``pod`` and ``data`` flattened a
  parameter.

Rank 0 of a fake world against rank 0 of 8 real gloo ranks is
tests/test_torch_sharded.py's (its 8-process spawn runs the real side).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import (LM_SHAPES, ShapeConfig,  # noqa: E402
                                      get_config, get_smoke_config,
                                      list_archs)
from repro_torch.distributed import context, layouts  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh, fake_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.modules import mlp  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.roofline import trace as rtrace  # noqa: E402
from repro_torch.roofline.bounds import flash_work  # noqa: E402
from repro_torch.roofline.trace import OpTrace, collective_stats  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

POD = AbstractMesh(("data", "model"), (16, 16))
WORKER = Path(__file__).resolve().parent / "dryrun_records_worker.py"


def _clear_dtensor_caches():
    """DTensor's sharding-propagation and redistribute-plan caches emptied,
    so that the next trace runs cold."""
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    _clear_sharding_prop_cache()
    _redistribute._gen_transform_infos.cache_clear()


# ---------------------------------------------------------------------------
# microbatches of a sharded batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("names,sizes", [(("data",), (16,)),
                                         (("pod", "data"), (2, 16))],
                         ids=["16", "32"])
def test_microbatch_splits_a_batch_sharded_16_and_32_ways(names, sizes):
    """``grad_accum`` 4 on a batch of 128 rows sharded over 16 or 32 data
    ranks (a DTensor reshape refuses it: 4 is not a multiple of the ranks).
    Each microbatch is the reference's rows ``t.reshape(4, 32, ...)[i]``
    (``repro/train/steps.py:55-59``), sharded as the batch was.  A fake
    all-gather hands every rank rank 0's rows, so the sharded batch holds
    rank 0's 8 (or 4) rows on every rank, and the gathered batch is that
    tile; a replicated batch shows rank 0 its own rows of each microbatch
    (rows 32 i to 32 i + 2, or + 1)."""
    B, S, accum = 128, 4, 4
    with fake_mesh(AbstractMesh(names, sizes)) as mesh:
        n = mesh.size()
        from torch.distributed.tensor import DTensor, Replicate, Shard
        rules = context.ShardingRules(mesh, {"batch": names})
        mine = torch.arange(B // n * S).reshape(B // n, S)
        tiled = mine.repeat(n, 1)
        rows = DTensor.from_local(mine, mesh, (Shard(0),) * len(names),
                                  run_check=False)
        full = torch.arange(B * S).reshape(B, S)
        whole = DTensor.from_local(full, mesh, (Replicate(),) * len(names),
                                   run_check=False)
        with context.use_rules(rules):
            for i in range(accum):
                want = tiled.reshape(accum, B // accum, S)[i]
                mb = tsteps._microbatch(rows, accum, i)
                assert mb.shape == (B // accum, S)
                assert mb.placements == (Shard(0),) * len(names)
                assert torch.equal(mb.to_local(), want[:B // accum // n])
                mb = tsteps._microbatch(whole, accum, i)
                assert torch.equal(
                    mb.to_local(),
                    full.reshape(accum, B // accum, S)[i][:B // accum // n])


def test_microbatch_of_a_plain_batch_is_the_reshape():
    t = torch.arange(8 * 3).reshape(8, 3)
    for i in range(4):
        assert torch.equal(tsteps._microbatch(t, 4, i),
                           t.reshape(4, 2, 3)[i])


# ---------------------------------------------------------------------------
# DTensor's all-to-all and the collective namespaces
# ---------------------------------------------------------------------------
def test_shard_to_shard_counts_one_all_to_all_of_its_local_bytes():
    """Shard(0) -> Shard(1) over ``data`` of a (64, 256) f32 on the fake
    16 x 16 ``"cpu"`` mesh: one all-to-all of rank 0's (4, 256) in and
    (64, 16) out, no all-gather (DTensor's fallback on a CPU mesh would
    gather (64, 256), 16 times the bytes, as an all-gather)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with fake_mesh(POD) as mesh:
        assert mesh.device_type == "cpu"
        x = distribute_tensor(torch.empty(64, 256, device="meta"), mesh,
                              (Shard(0), Replicate()))
        with OpTrace() as trace:
            y = x.redistribute(mesh, (Shard(1), Replicate()))
    assert tuple(y.to_local().shape) == (64, 16)
    stats = collective_stats(trace)
    assert stats["all-to-all"] == {"count": 1, "operand_bytes": 4 * 256 * 4,
                                   "output_bytes": 64 * 16 * 4}
    assert all(stats[k]["count"] == 0 for k in stats if k != "all-to-all")
    assert [op.name for op in trace.ops] == ["_dtensor.shard_dim_alltoall"]


def test_every_collective_op_is_mapped_or_refused():
    """Every op of ``_dtensor`` is a mapped collective or moves no data;
    a collective the trace cannot map (``_c10d_functional.broadcast``)
    raises instead of being dropped."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor  # noqa: F401 (defines _dtensor's ops)
    names = {n.split("::")[1].split(".")[0]
             for n in torch._C._dispatch_get_all_op_names()
             if n.startswith("_dtensor::")}
    assert "shard_dim_alltoall" in names
    assert names <= set(rtrace._DTENSOR) | rtrace._NOT_COLLECTIVE
    with fake_mesh(AbstractMesh(("data",), (4,))):
        with pytest.raises(NotImplementedError, match="broadcast"), \
                OpTrace():
            funcol.broadcast(torch.zeros(4), 0, dist.group.WORLD)


# ---------------------------------------------------------------------------
# rank 0's local work
# ---------------------------------------------------------------------------
def _mlp_trace(mesh, B, S, D, F):
    """One gated MLP on DTensors: x (B, S, D) rows over ``data``, w_gate
    and w_up (D, F) and w_down (F, D) split on F over ``model``; its
    output laid out (batch, seq, None), which sums w_down's partial
    products over ``model``."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def dt(shape, place):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 place)
    p = SimpleNamespace(w_gate=dt((D, F), (Replicate(), Shard(1))),
                        w_up=dt((D, F), (Replicate(), Shard(1))),
                        w_down=dt((F, D), (Replicate(), Shard(0))))
    x = dt((B, S, D), (Shard(0), Replicate()))
    rules = context.ShardingRules(mesh, {"batch": "data", "ff": "model"})
    with context.use_rules(rules), OpTrace() as trace:
        context.constrain(mlp(p, x, "silu"), ("batch", "seq", None))
    return trace


def test_hand_counted_mlp_on_a_16_by_16_mesh():
    """Rank 0 holds 2 of the 32 rows and 16 of the 256 ff columns: each of
    the three products is a local (16, 64) x (64, 16) or (16, 16) x
    (16, 64) ``mm`` of 2 * 16 * 64 * 16 flops and (1024 + 1024 + 256) or
    (256 + 1024 + 1024) f32 elements; the output's partial sums are one
    all-reduce of rank 0's (2, 8, 64) f32 over ``model``.  A cold trace
    (DTensor's caches emptied) and a warm one count the same ops."""
    B, S, D, F = 32, 8, 64, 256
    _clear_dtensor_caches()
    with fake_mesh(POD) as mesh:
        cold = _mlp_trace(mesh, B, S, D, F)
        warm = _mlp_trace(mesh, B, S, D, F)
    for trace in (cold, warm):
        mms = [op for op in trace.ops if op.name == "aten.mm"]
        assert len(mms) == 3
        assert all(op.flops == 2 * 16 * 64 * 16 for op in mms)
        assert sorted(op.in_bytes for op in mms) == [(16 * 16 + 16 * 64) * 4] \
            + [(16 * 64 + 64 * 16) * 4] * 2
        assert sorted(op.out_bytes for op in mms) == [16 * 16 * 4] * 2 + \
            [16 * 64 * 4]
        stats = collective_stats(trace)
        assert stats["all-reduce"] == {"count": 1,
                                       "operand_bytes": 2 * 8 * 64 * 4,
                                       "output_bytes": 2 * 8 * 64 * 4}
        assert sum(v["count"] for v in stats.values()) == 1
        assert trace.transcendentals == 2 * 8 * 16      # silu, local
    assert [(o.name, o.in_bytes, o.out_bytes, o.flops) for o in cold.ops] == \
        [(o.name, o.in_bytes, o.out_bytes, o.flops) for o in warm.ops]


def test_flash_records_its_local_shapes():
    """Flash on DTensors (batch over ``data``, kv heads over ``model``)
    runs its meta path on rank 0's shard through ``run_local``: one op of
    the work of (2, 16, 1 kv head, G 2, hd 16), not of the global
    (32, 16, 16, 2, 16)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import flash_attention
    B, S, K, G, hd = 32, 16, 16, 2, 16
    with fake_mesh(POD) as mesh:
        def dt(shape):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     (Shard(0), Shard(2)))
        q, k, v = dt((B, S, K, G, hd)), dt((B, S, K, hd)), dt((B, S, K, hd))
        with OpTrace() as trace:
            o = flash_attention(q, k, v, scale=0.25, q_block=512, pack=True)
    assert tuple(o.to_local().shape) == (2, S, 1, G, hd)
    ops = [op for op in trace.ops if op.name == "flash_attention"]
    flops, nbytes = flash_work(2, S, S, G, hd, 0, True, 4)
    assert [(op.flops, op.bytes) for op in ops] == [(flops, nbytes)]


def test_softmax_backward_holds_its_product_and_a_strided_copy():
    """``_softmax_backward_data`` holds grad * output while it runs, and a
    contiguous copy of it where the gradient is permuted (measured on the
    H100 by tests/test_torch_cuda.py: 2.147 GB a call at h2o-danube-1.8b's
    f32 microbatch); the trace's peak counts them beside the output."""
    s = torch.empty(2, 4, 64, 64, device="meta")
    peaks = []
    for strided in (False, True):
        g = torch.empty(2, 4, 64, 64, device="meta")
        if strided:
            g = torch.empty(2, 64, 4, 64, device="meta").transpose(1, 2)
        with OpTrace() as trace:
            out = torch.ops.aten._softmax_backward_data(g, s, -1, s.dtype)
        peaks.append(trace.peak_bytes)
        assert out.shape == s.shape
    nbytes = 2 * 4 * 64 * 64 * 4
    assert peaks == [2 * nbytes, 3 * nbytes]


def test_cold_and_warm_traces_of_a_train_cell_count_the_same():
    """The whole sharded train step of a smoke cell, traced with DTensor's
    caches emptied and then again: every count of the record is equal."""
    cfg = get_smoke_config("h2o-danube-1.8b")
    shape = ShapeConfig("s", "train", 64, 32)
    mesh = AbstractMesh(("data", "model"), (4, 4))
    recs = []
    _clear_dtensor_caches()
    for _ in ("cold", "warm"):
        rec = dryrun.trace_cell(cfg, shape, mesh, grad_accum=2)
        rec.pop("lower_s")
        recs.append(rec)
    assert recs[0] == recs[1]
    assert recs[0]["cost"]["flops_per_device"] > 0


# ---------------------------------------------------------------------------
# state made beside a DTensor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "h2o-danube-1.8b"])
def test_optimizer_state_takes_the_shards_device(arch):
    """Adafactor's (qwen3-moe) and AdamW's (h2o-danube) state and the
    step counter of a sharded model whose shards are on the meta device,
    at ``opt_pspecs``' ZeRO placements: every local tensor on the meta
    device, and the step traces."""
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("s", "train", 32, 8)
    with fake_mesh(AbstractMesh(("data", "model"), (2, 4))) as mesh:
        rules = layouts.choose_layout(cfg, shape, mesh)
        model = init_params(cfg, None, device="meta")
        layouts.shard_params(model, cfg, rules, mesh)
        gshard = layouts.param_placements(model, cfg, layouts.opt_pspecs(
            layouts.param_pspecs(model, cfg, rules), model, cfg, mesh), mesh)
        opt = make_optimizer(cfg.optimizer, cfg=cfg, update_constraint=gshard)
        state = tsteps.init_train_state(None, cfg, opt, params=model)
        leaves = [t for t in torch.utils._pytree.tree_leaves(state["opt"])
                  if isinstance(t, torch.Tensor)] + [state["step"]]
        assert leaves and all(context.local_device(t).type == "meta"
                              for t in leaves)
        trace, _ = dryrun.run_step(cfg, shape, mesh, grad_accum=1)
    assert trace.flops > 0


# ---------------------------------------------------------------------------
# the records
# ---------------------------------------------------------------------------
# the 1 x 1 records of smoke cells (ShapeConfig("s", kind, 32, 4), the
# default grad_accum 4), as the dry-run wrote them before it traced sharded
# cells: flops, transcendentals, bytes, compulsory bytes, temp GB, ops.  The
# train cells' bytes and ops since flash's backward recomputes through
# ``qk_scores``, whose backward casts the saved bf16 q and k to f32 where
# autograd of ``q.float()`` kept f32 copies (flops and temp memory equal)
ONE_BY_ONE = {
    "h2o-danube-1.8b/decode": (917504, 2132, 791712, 313636, 3.8424e-05, 291),
    "h2o-danube-1.8b/prefill": (20217856, 58372, 4886704, 313616,
                                0.000196848, 227),
    "h2o-danube-1.8b/train": (89161728, 329154, 53040194, 3910692,
                              0.000935452, 3632),
    "qwen3-moe-235b-a22b/train": (99385344, 226689, 81069858, 1227748,
                                  0.001277544, 5818),
    "recurrentgemma-2b/train": (224493568, 837570, 186184878, 8006692,
                                0.00184618, 12301),
    "rwkv6-7b/prefill": (36978688, 108036, 13541040, 567568, 0.000720112,
                         350),
    "whisper-small/decode": (933888, 2396, 861872, 397348, 3.8896e-05, 316),
}


@pytest.mark.parametrize("cell", sorted(ONE_BY_ONE))
def test_one_by_one_records_are_unchanged(cell):
    """No group is started and the model stays plain: the record's keys,
    its even splits, its zero collectives and its counts are the ones the
    dry-run wrote before it traced sharded cells."""
    arch, kind = cell.split("/")
    rec = dryrun.trace_cell(get_smoke_config(arch),
                            ShapeConfig("s", kind, 32, 4),
                            AbstractMesh(("data", "model"), (1, 1)))
    assert not dist.is_initialized()
    assert sorted(rec) == ["collectives", "cost", "hlo_len", "hlo_ops",
                           "lower_s", "memory", "n_chips"]
    assert rec["memory"]["temp_split"] == rec["cost"]["split"] == "even"
    assert all(v == {"count": 0, "operand_bytes": 0, "output_bytes": 0}
               for v in rec["collectives"].values())
    c = rec["cost"]
    assert (c["flops_per_device"], c["transcendentals"], c["bytes_accessed"],
            c["compulsory_bytes"], rec["memory"]["temp_gb"],
            rec["hlo_len"]) == ONE_BY_ONE[cell]


def _total(rec) -> int:
    return sum(v["operand_bytes"] for v in rec["collectives"].values())


def _full_width(arch: str, layers: int):
    return dataclasses.replace(get_config(arch), n_layers=layers)


@functools.cache
def _full_width_record(arch: str, layers: int, mesh: str) -> dict:
    """The record of ``arch``'s ``train_4k`` cell at full width, cut to
    ``layers`` layers, on ``pod`` or ``multipod`` (traced once a module)."""
    return dryrun.trace_cell(_full_width(arch, layers), LM_SHAPES["train_4k"],
                             make_production_mesh(multi_pod=mesh ==
                                                  "multipod"))


def test_moe_train_uses_reduce_scatter():
    """qwen3-moe-235b-a22b ``train_4k`` on ``pod`` at full width, 1 layer:
    the record is rank 0's of 256 and reduce-scatters."""
    rec = dryrun.trace_cell(_full_width("qwen3-moe-235b-a22b", 1),
                            LM_SHAPES["train_4k"], POD)
    assert (rec["n_chips"], rec["n_ranks_traced"]) == (256, 1)
    assert rec["cost"]["split"] == rec["memory"]["temp_split"] == "rank0"
    assert rec["collectives"]["reduce-scatter"]["count"] > 0


@pytest.mark.parametrize("arch,layers", [("gemma2-9b", 1),
                                         ("internlm2-20b", 1)])
def test_multipod_weak_scaling(arch, layers, tmp_path, monkeypatch):
    """2 pods = twice the data ranks: rank 0's collective operand bytes on
    ``multipod`` are at most 1.1 times ``pod``'s (full width, one layer).
    The batch is split over ("pod", "data") as the reference's is; DTensor
    reduces over ``pod`` and ``data`` one after the other where the
    reference's partitioner issues one collective, so a reduction over
    both counts twice, at its own bytes each time.  The roofline reads both
    records: a numeric collective term and DCN row."""
    from repro_torch.roofline import analysis
    recs = {mesh: dict(_full_width_record(arch, layers, mesh))
            for mesh in ("pod", "multipod")}
    pod, two = recs["pod"], recs["multipod"]
    assert two["n_chips"] == 512
    assert 0 < _total(two) <= 1.1 * _total(pod), (_total(pod), _total(two))
    for mesh, rec in recs.items():
        rec.update(arch=arch, shape="train_4k", mesh=mesh, kind="train")
        (tmp_path / f"{arch}__train_4k__{mesh}.json").write_text(
            json.dumps(rec))
    monkeypatch.setattr(analysis, "DRYRUN", tmp_path)
    for mesh, rec in recs.items():
        row = analysis.analyze_cell(arch, "train_4k", mesh)
        assert row["collective_s"] == _total(rec) / analysis.LINK_BW > 0
    [row] = analysis.compare_meshes()
    assert row["dcn_term_s"] == max(_total(two) - _total(pod), 0) / \
        analysis.DCN_BW
    assert "n/a" not in analysis.multipod_markdown()


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch,layers", [("gemma2-9b", 1),
                                         ("internlm2-20b", 1)])
def test_rank0_runs_its_q_heads_and_keeps_the_logits(arch, layers, mesh):
    """C3 and C4 in rank 0's record (full width, one layer, 16 ``model``
    ranks; 16 and 48 q heads over 8 kv heads): flash runs on the rank's
    H / 16 q heads of its rows of a microbatch (256 rows / 4 microbatches
    / 16 or 32 data ranks; the kernel's q (rows, 4096, H / 16, hd): one kv
    head), and no all-gather carries the f32 logits of those rows."""
    cfg = get_config(arch)
    rec = _full_width_record(arch, layers, mesh)
    rows = 256 // 4 // (16 if mesh == "pod" else 32)
    S = LM_SHAPES["train_4k"].seq_len
    assert rec["rank0"]["kernel_shapes"]["flash_attention"] == \
        [[rows, S, cfg.n_heads // 16, cfg.head_dim]]
    gathers = rec["rank0"]["largest_collective"]["all-gather"]
    assert 0 < gathers["output_bytes"] < rows * S * cfg.vocab_size * 4


def smoke_train_record(arch: str, multi_pod: bool) -> dict:
    """The record of ``arch``'s smoke train cell (one layer, 64 x 256
    tokens, ``grad_accum`` 1) on a production mesh."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=1)
    shape = dataclasses.replace(LM_SHAPES["train_4k"], seq_len=256,
                                global_batch=64)
    return dryrun.trace_cell(cfg, shape, make_production_mesh(
        multi_pod=multi_pod), grad_accum=1)


# C3's cell beside the reference's own record: the internlm2-20b smoke
# config with 16 q heads and 8 kv heads on ``pod`` (16 ``model`` ranks:
# the q-heads route, each rank 1 q head), one layer, 64 x 256 tokens; the
# reference's causal packing off (``attn_causal_pack``), which halves its
# causal products where the port's eager attention backward computes the
# whole square (PERF.md §7): the ratio then reads the partitioning
HEADS_CELL = "internlm2-20b@16x8:off"


# the same with packing on (``"auto"``: 16 heads over 16 ranks): the
# reference packs its causal products (``_causal_packed``), and so does the
# port's backward, which recomputes through the same dispatch
PACKED_CELL = "internlm2-20b@16x8"
# C5's cell: the internlm2-20b smoke config's 4 heads over 16 ``model``
# ranks (the q-rows route, 4 ranks a head), traced as rank 0 (rows 0-63 of
# head 0, the least work) and rank 3 (rows 192-255, the most)
ROWS_CELL, ROWS_RANKS = "internlm2-20b", (0, 3)
# C10's cell: the recurrentgemma-2b smoke config with 10 q heads and 1 kv
# head over 16 ``model`` ranks (2 groups of 5 heads, each group's rows over
# 8 ranks), at its superblock's 3 layers (the reference's layer scan takes
# no fewer); traced as rank 0 (rows 0-31 of group 0) and rank 15 (rows
# 224-255 of group 1, the most causal pairs)
GROUPS_CELL, GROUPS_RANKS = "recurrentgemma-2b@10x1/3", (0, 15)
# C14's cell: the whisper-small smoke config with a vocab of 515, which the
# 16 ``model`` ranks do not divide (the full config's 51865 does not
# either), traced at rank 15 (its heads take the q-rows route)
VOCAB_CELL, VOCAB_RANK = "whisper-small~515", 15
# C8's cells: gemma2-9b (its tied table, the vocab-parallel lookup and
# head) and rwkv6-7b (its mixes' weights gathered whole onto each rank's
# rows), at these ``grad_accum``
ACCUM_ARCHS, ACCUMS = ("gemma2-9b", "rwkv6-7b"), (1, 4)
# C12's and C16's serving cells: the smoke configs' decode and prefill
# steps at 64 x 256 (4 sequences a rank), at one superblock (gemma2-9b's
# local and global layers, gemma3-1b's five local and one global,
# recurrentgemma-2b's two RG-LRU and one local)
SERVING_ARCHS = ("h2o-danube-1.8b", "internlm2-20b", "gemma2-9b/2",
                 "gemma3-1b/6", "recurrentgemma-2b/3")
# and internlm2-20b's ``long_500k`` decode step at a batch of 1, 4096
# tokens (the rules cut the sequence over ``data``, the one new row
# whole), whose ring-free cache the reference splits over all 256 ranks
SERVING_CELLS = [f"{a}+{s}" for s in ("decode_32k", "prefill_32k")
                 for a in SERVING_ARCHS] + ["internlm2-20b+long_500k:4096x1"]
# C12's and C17's full-width decode steps at their own tokens (128
# sequences; 8 a ``data`` rank on ``pod``, 4 on ``multipod``), at one
# superblock: rwkv6-7b on both meshes (C17: it could not decode where
# ``model`` has more than one rank), internlm2-20b and the two MoEs on
# ``pod``, and every other arch's decode on ``multipod``
FULL_DECODE_CELLS = [
    f"{a}+decode_32k#full.{m}" for a, m in (
        ("rwkv6-7b/1", "pod"), ("rwkv6-7b/1", "multipod"),
        ("internlm2-20b/1", "pod"), ("qwen3-moe-235b-a22b/1", "pod"),
        ("arctic-480b/1", "pod"), ("gemma3-1b/6", "multipod"),
        ("gemma2-9b/2", "multipod"), ("recurrentgemma-2b/3", "multipod"),
        ("whisper-small/1", "multipod"), ("paligemma-3b/1", "multipod"),
        ("qwen3-moe-235b-a22b/1", "multipod"),
        ("arctic-480b/1", "multipod"))]
# C17's smoke cells, which the reference cannot compile (its state's 4
# heads do not split over 16 ``model`` ranks): rwkv6-7b's decode steps at
# 64 x 256 (4 rows a rank) and at ``long_500k``'s batch of 1
RWKV_SMOKE_SERVING_CELLS = ("rwkv6-7b+decode_32k", "rwkv6-7b+long_500k:4096x1")
# C11's cells: 16 q heads and 8 kv heads on the 16 ``model`` ranks (the
# q-heads route) under the prefix-LM mask (paligemma-3b) and the
# bidirectional encoder and cross-attention (whisper-small), off flash
Q_HEADS_CELLS = ("paligemma-3b@16x8", "whisper-small@16x8")


def heads_port_record(cell: str = HEADS_CELL, rank: int = 0) -> dict:
    """The port's side of a smoke cell on ``pod`` at 64 x 256 tokens,
    traced as ``rank`` (tests/dryrun_records_worker.py): one layer, or the
    cell's ``/L``; the train step, or the cell's ``+SHAPE`` (at its
    ``:SxB`` tokens, where it has them); a cell's ``#WIDTH.MESH`` at its
    shape's own tokens."""
    import dryrun_records_worker as worker
    arch, heads, layers, vocab, shape, seq, batch, width, mesh = \
        worker.parse_cell(cell)
    if not width:
        width, mesh, seq, batch = "smoke", "pod", seq or 256, batch or 64
    return worker.port(arch, width, mesh, layers or 1, seq, batch, 1, heads,
                       vocab, rank=rank, shape_name=shape or "train_4k")


def accum_port_record(arch: str, accum: int) -> dict:
    """The port's side of ``arch``'s smoke train cell on ``pod`` (one
    layer, 64 x 256 tokens) at ``grad_accum`` ``accum``, rank 0."""
    import dryrun_records_worker as worker
    return worker.port(arch, "smoke", "pod", 1, 256, 64, accum)


@pytest.fixture(scope="module", autouse=True)
def smoke_records():
    """Every arch's smoke train record on both meshes, and the port's side
    of ``HEADS_CELL``, traced by 4 spawned processes (each cell its own
    fake world) while the module's other tests run: {cell: future}.  A
    cell's cold sharding propagation on a 3-D mesh takes 1-17 s."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {HEADS_CELL: pool.submit(heads_port_record),
                   PACKED_CELL: pool.submit(heads_port_record, PACKED_CELL)}
        futures.update({("rows", r): pool.submit(heads_port_record,
                                                 ROWS_CELL, r)
                        for r in ROWS_RANKS})
        futures.update({("groups", r): pool.submit(heads_port_record,
                                                   GROUPS_CELL, r)
                        for r in GROUPS_RANKS})
        futures[VOCAB_CELL] = pool.submit(heads_port_record, VOCAB_CELL,
                                          VOCAB_RANK)
        futures.update({c: pool.submit(heads_port_record, c)
                        for c in (*SERVING_CELLS, *FULL_DECODE_CELLS,
                                  *RWKV_SMOKE_SERVING_CELLS,
                                  *Q_HEADS_CELLS)})
        futures.update({("accum", a, n): pool.submit(accum_port_record, a, n)
                        for a in ACCUM_ARCHS for n in ACCUMS})
        futures.update({(a, mp): pool.submit(smoke_train_record, a, mp)
                        for a in list_archs() for mp in (False, True)})
        yield futures
    finally:
        pool.shutdown(cancel_futures=True)


SMOKE_JOIN_S = 240


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_every_train_cell_communicates(smoke_records, arch, multi_pod):
    rec = smoke_records[arch, multi_pod].result(timeout=SMOKE_JOIN_S)
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["n_ranks_traced"] == 1
    assert _total(rec) > 0
    assert rec["cost"]["flops_per_device"] > 0
    # the record names the rank it traced, the heaviest
    name = f"rank{rec['rank_traced']}"
    assert rec["rank_traced"] == dryrun.traced_rank(
        get_smoke_config(arch), LM_SHAPES["train_4k"],
        make_production_mesh(multi_pod=multi_pod))
    assert rec["cost"]["split"] == rec["memory"]["temp_split"] == name
    assert set(rec[name]) == {"op_flops", "kernel_shapes",
                              "product_shapes", "largest_collective",
                              "collective_groups"}


# (arch, heads, mesh, shape) -> the rank the dry-run traces: rank 0, or
# on the q-rows route (more ``model`` ranks than q heads; train and
# prefill) model coordinate tp - 1
TRACED_RANKS = {("gemma3-1b", "smoke", "pod", "train_4k"): 15,
                ("gemma3-1b", "smoke", "multipod", "prefill_32k"): 15,
                ("gemma3-1b", "smoke", "multipod", "decode_32k"): 0,
                ("internlm2-20b", "smoke", "pod", "train_4k"): 15,
                ("internlm2-20b", "full", "pod", "train_4k"): 0,
                ("gemma2-9b", "full", "multipod", "train_4k"): 0,
                ("internlm2-20b", "2x2", "4x4", "train_4k"): 3,
                ("internlm2-20b", "2x2", "model4", "train_4k"): 6,
                ("internlm2-20b", "2x2", "data4", "train_4k"): 0,
                ("recurrentgemma-2b", "10x1", "pod", "train_4k"): 15,
                ("recurrentgemma-2b", "full", "pod", "train_4k"): 15,
                ("whisper-small", "full", "pod", "train_4k"): 15,
                ("arctic-480b", "full", "pod", "decode_32k"): 0}


@pytest.mark.parametrize("cell", sorted(TRACED_RANKS))
def test_traced_rank_is_the_heaviest(cell):
    arch, heads, mesh, shape = cell
    cfg = get_config(arch) if heads == "full" else get_smoke_config(arch)
    if "x" in heads:
        H, K = map(int, heads.split("x"))
        cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=K)
    meshes = {"4x4": AbstractMesh(("data", "model"), (4, 4)),
              "model4": AbstractMesh(("model", "data"), (4, 2)),
              "data4": AbstractMesh(("data",), (4,))}
    m = meshes.get(mesh) or make_production_mesh(multi_pod=mesh ==
                                                 "multipod")
    assert dryrun.traced_rank(cfg, LM_SHAPES[shape], m) == \
        TRACED_RANKS[cell]


def test_q_rows_record_is_the_heaviest_ranks(smoke_records):
    """C5's smoke cell on ``pod`` as the dry-run records it: the rank at
    ``model`` coordinate 15 (head 3's rows 192-255), whose work is rank
    3's (head 0's same rows), above rank 0's."""
    rec = smoke_records["internlm2-20b", False].result(timeout=SMOKE_JOIN_S)
    rows = {r: smoke_records["rows", r].result(timeout=SMOKE_JOIN_S)
            for r in ROWS_RANKS}
    assert rec["rank_traced"] == 15
    assert rec["cost"]["flops_per_device"] == rows[3]["flops_per_device"] > \
        rows[0]["flops_per_device"]
    assert rec["rank15"]["op_flops"]["flash_attention"] == \
        rows[3]["flash_flops"]


# the archs whose smoke train cell the reference compiles on ``pod`` (its
# Adafactor state of a MoE with 8 experts does not split over 16 ranks)
REFERENCE_ARCHS = ["internlm2-20b", "h2o-danube-1.8b", "rwkv6-7b",
                   "whisper-small", "paligemma-3b"]
# kinds that move the same data: a gather, a reduction
COLLECTIVE_CLASSES = {"gather": ("all-gather",),
                      "reduction": ("all-reduce", "reduce-scatter")}


@pytest.fixture(scope="module", autouse=True)
def reference_records():
    """The reference's records of ``REFERENCE_ARCHS``' smoke train cells on
    ``pod`` (tests/dryrun_records_worker.py: the cells of
    ``smoke_train_record``), of the module's other smoke cells and of the
    serving cells (each at its ``+SHAPE``), compiled one after the other
    by one process started while the module's other tests run."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen(
        [sys.executable, str(WORKER), "reference",
         ",".join(REFERENCE_ARCHS + [HEADS_CELL, PACKED_CELL, GROUPS_CELL,
                                     VOCAB_CELL, *SERVING_CELLS,
                                     *FULL_DECODE_CELLS, *Q_HEADS_CELLS]),
         "smoke", "pod",
         "--layers", "1", "--seq", "256", "--batch", "64"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    records = {}

    def get(cell: str) -> dict:
        if not records:
            out, err = proc.communicate(timeout=SMOKE_JOIN_S)
            assert proc.returncode == 0, err[-3000:]
            for line in out.splitlines():
                rec = json.loads(line)
                records[rec["cell"]] = rec
        return records[cell]
    try:
        yield get
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_collectives_cover_the_reference(smoke_records, reference_records,
                                         arch):
    """Rank 0's record of a smoke train cell on ``pod`` issues a gather and
    a reduction wherever the reference's compiled cell does: a kind the
    trace dropped would show.  The kinds within a class differ by design
    (the port reduce-scatters the ZeRO gradients where XLA all-reduces at
    these widths), and the re-layouts (XLA's all-to-all and
    collective-permute) are not held: DTensor has no permute, and its
    layouts differ (PERF.md §7)."""
    ref = reference_records(arch)
    rec = smoke_records[arch, False].result(timeout=SMOKE_JOIN_S)
    assert (ref["layers"], ref["n_chips"], rec["n_chips"]) == (1, 256, 256)
    for cls, kinds in COLLECTIVE_CLASSES.items():
        if sum(ref["collectives"][k]["count"] for k in kinds):
            assert sum(rec["collectives"][k]["count"] for k in kinds) > 0, \
                (cls, ref["collectives"], rec["collectives"])


def test_split_heads_hold_the_reference(smoke_records, reference_records):
    """C3 and C4 beside the reference's own record of ``HEADS_CELL``: rank
    0's attention products (flash and the eager backward's ``bmm``) and its
    other products (``mm``: the projections, with k's and v's split by
    columns, the MLP and the vocab-parallel head) at most 1.25 times the
    reference's a device (measured 1.167 and 1.000; replicated heads would
    be 16 times)."""
    ref = reference_records(HEADS_CELL)
    port = smoke_records[HEADS_CELL].result(timeout=SMOKE_JOIN_S)
    assert (ref["n_chips"], port["n_chips"]) == (256, 256)
    for key in ("attention_flops", "product_flops"):
        assert 0 < port[key] <= 1.25 * ref[key], (key, port[key], ref[key])


def test_packed_attention_holds_the_reference(smoke_records,
                                             reference_records):
    """``PACKED_CELL`` beside the reference's own record: the port's
    backward recomputes through the reference's packed dispatch, so its
    eager products (``bmm``) are exactly the reference's attention
    products, forward and backward; the flash forward's causal pairs come
    on top.  With no remat in the smoke config that forward is 0.297 of the
    reference's (half a square of two products, against 0.5625 of a square
    of six: 1.297 in all; 2.08 when the backward computed whole squares)."""
    ref = reference_records(PACKED_CELL)
    port = smoke_records[PACKED_CELL].result(timeout=SMOKE_JOIN_S)
    assert port["attention_flops"] - port["flash_flops"] == \
        ref["attention_flops"] > 0
    assert port["attention_flops"] <= 1.3 * ref["attention_flops"]


def test_q_rows_hold_the_reference(smoke_records, reference_records):
    """C5 beside the reference's own record of ``ROWS_CELL`` (4 heads on
    16 ``model`` ranks): rank 0's attention and rank 3's (the last row
    block of a head, the heaviest) at most the reference's a device (each
    rank runs a quarter of one head's rows: 0.117 and 0.517 of it;
    replicated heads were 7.5 times), rank 3's more than rank 0's."""
    ref = reference_records(ROWS_CELL)
    ports = [smoke_records["rows", r].result(timeout=SMOKE_JOIN_S)
             for r in ROWS_RANKS]
    assert [p["rank"] for p in ports] == list(ROWS_RANKS)
    for port in ports:
        assert 0 < port["attention_flops"] <= ref["attention_flops"], \
            (port["rank"], port["attention_flops"], ref["attention_flops"])
    assert ports[0]["attention_flops"] < ports[1]["attention_flops"]
    assert ports[0]["product_flops"] == ports[1]["product_flops"]


def _flops(rec) -> dict:
    """A sharded record's attention (flash and the eager ``bmm``) and other
    products (``mm``) at its traced rank, keyed as the worker's."""
    ops = rec[f"rank{rec['rank_traced']}"]["op_flops"]
    return {"attention_flops": ops.get("flash_attention", 0) +
            ops.get("aten.bmm", 0), "product_flops": ops.get("aten.mm", 0)}


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small"])
def test_plain_q_rows_hold_the_reference(smoke_records, reference_records,
                                         arch):
    """C6 and C7 beside the reference's own record of the smoke train cell
    (4 heads on 16 ``model`` ranks): at the traced rank, attention at most
    the reference's a device (each rank one head's quarter of the rows of
    the prefix-LM mask, the bidirectional encoder and cross-attention
    through the plain dispatch, whisper's decoder through flash: 0.400 and
    0.344 of it; replicated they were 6.40 and 5.31 times), and the other
    products at most 1.25 times (1.008 and 1.000: the k and v projections
    cut by columns, whisper's ``frontend_proj`` by rows as the residual
    stream; whole they were 1.46 and 3.95 times)."""
    ref = reference_records(arch)
    port = _flops(smoke_records[arch, False].result(timeout=SMOKE_JOIN_S))
    assert 0 < port["attention_flops"] <= ref["attention_flops"], \
        (port, ref["attention_flops"])
    assert 0 < port["product_flops"] <= 1.25 * ref["product_flops"], \
        (port, ref["product_flops"])


def test_q_rows_products_hold_the_reference(smoke_records,
                                            reference_records):
    """C7 on C5's cell: rank 0's and rank 3's products at most 1.25 times
    the reference's a device (1.000: the k and v projections cut by
    columns over ``model``; whole they were 1.88 times)."""
    ref = reference_records(ROWS_CELL)
    for r in ROWS_RANKS:
        port = smoke_records["rows", r].result(timeout=SMOKE_JOIN_S)
        assert 0 < port["product_flops"] <= 1.25 * ref["product_flops"], \
            (r, port["product_flops"], ref["product_flops"])


def test_rwkv_products_hold_the_reference(smoke_records, reference_records):
    """C9 beside the reference's own record of rwkv6-7b's smoke train cell:
    rank 0's products at most 1.25 times the reference's a device (1.000:
    the time mix's LoRAs and d x d projections and the channel mix's
    receptance on the rank's rows of the residual stream; on all the data
    shard's rows, whole on every rank, they were 4.67 times)."""
    ref = reference_records("rwkv6-7b")
    port = _flops(smoke_records["rwkv6-7b", False].result(
        timeout=SMOKE_JOIN_S))
    assert 0 < port["product_flops"] <= 1.25 * ref["product_flops"], \
        (port, ref["product_flops"])


def test_head_groups_hold_the_reference(smoke_records, reference_records):
    """C10 beside the reference's own record of ``GROUPS_CELL`` (10 heads,
    1 kv head, 16 ``model`` ranks): at rank 0 and at rank 15, the rank the
    dry-run traces, attention at most the reference's a device (each rank
    5 heads' 32 rows through flash, 0.098 and 0.694 of it; replicated
    heads were 2.42 times) and the other products at most 1.25 times
    (1.000; 1.18 with the k and v projections whole); rank 15 runs the
    most causal pairs."""
    ref = reference_records(GROUPS_CELL)
    ports = {r: smoke_records["groups", r].result(timeout=SMOKE_JOIN_S)
             for r in GROUPS_RANKS}
    for r, port in ports.items():
        assert port["rank"] == r
        assert 0 < port["attention_flops"] <= ref["attention_flops"], \
            (r, port["attention_flops"], ref["attention_flops"])
        assert 0 < port["product_flops"] <= 1.25 * ref["product_flops"], \
            (r, port["product_flops"], ref["product_flops"])
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              n_heads=10, n_kv_heads=1)
    assert dryrun.traced_rank(cfg, LM_SHAPES["train_4k"], POD) == 15
    assert ports[15]["flops_per_device"] > ports[0]["flops_per_device"]
    assert ports[15]["flash_flops"] > ports[0]["flash_flops"]


def test_unembedding_runs_on_each_ranks_rows(smoke_records,
                                            reference_records):
    """C14 beside the reference's own record of ``VOCAB_CELL`` (a vocab
    of 515 on 16 ``model`` ranks): at rank 15, the products at most 1.05
    times the reference's a device (0.665: the head's forward, dx and dW
    each on the rank's 16 of the 256 rows; whole on every rank they were
    1.671 times), and the products whose operands hold the vocab at most
    the reference's (its forward whole, its dx and dW cut)."""
    ref = reference_records(VOCAB_CELL)
    port = smoke_records[VOCAB_CELL].result(timeout=SMOKE_JOIN_S)
    assert port["rank"] == VOCAB_RANK
    assert 0 < port["product_flops"] <= 1.05 * ref["product_flops"], \
        (port["product_flops"], ref["product_flops"])

    def head(rec):
        return sum(f for k, f in rec["products_by_shape"].items()
                   if "515" in k.replace(" @ ", "x").split("x"))
    assert 0 < head(port) <= head(ref), (port["products_by_shape"],
                                         ref["products_by_shape"])


@pytest.mark.parametrize("cell", SERVING_CELLS + FULL_DECODE_CELLS)
def test_serving_records_hold_the_reference(smoke_records,
                                            reference_records, cell):
    """C12, C16 and C17 beside the reference's own records of the smoke
    serving cells on ``pod`` (64 x 256, 4 sequences a rank) and the
    full-width decode steps (``FULL_DECODE_CELLS``): a decode step's
    products at most 1.05 times the reference's a device (1.000, whisper-
    small's 0.999; 2.87-5.89 times when its residual stream was left
    ``Partial`` over ``model``, and DTensor gathered the MLP's gate and up
    weights whole onto every rank), its attention at most 1.25 times
    (1.000, whisper-small's 1.009; 7.67-7.92 times where a layer after a
    local one gathered the cache's slots); a prefill step's products equal
    to the reference's.  The ``long_500k`` step (1.000 and 1.000) did not
    trace: DTensor cut its one row over the 16 ``data`` ranks and refused
    to view it flat.  rwkv6-7b's decode (1.000 and 1.000 on both meshes)
    did not trace: DTensor left its LoRA's 160 columns cut over ``model``
    and refused to view them as 5 groups of 32."""
    ref = reference_records(cell)
    port = smoke_records[cell].result(timeout=SMOKE_JOIN_S)
    assert ref["shape"] == port["shape"] == \
        cell.split("+")[1].split(":")[0].split("#")[0]
    chips = 512 if cell.endswith(".multipod") else 256
    assert (ref["layers"], ref["n_chips"]) == (port["layers"], chips)
    if port["shape"] == "prefill_32k":
        assert port["product_flops"] == ref["product_flops"] > 0
        return
    assert 0 < port["product_flops"] <= 1.05 * ref["product_flops"], \
        (port["products_by_shape"], ref["products_by_shape"])
    assert 0 < port["attention_flops"] <= 1.25 * ref["attention_flops"], \
        (port["attention_flops"], ref["attention_flops"])


@pytest.mark.parametrize("cell", RWKV_SMOKE_SERVING_CELLS)
def test_rwkv_smoke_decode_runs_each_ranks_block(smoke_records, cell):
    """C17 where the reference has no record: rwkv6-7b's smoke decode
    steps on ``pod`` trace (the parent raised in the LoRA's reshape and in
    the state's in-place write), and a rank's batched products are its
    rows' LoRA second product on its D / 16 block of the model dim and the
    recurrence's r . S on every one of the 4 heads, which 16 ranks do not
    split."""
    rec = smoke_records[cell].result(timeout=SMOKE_JOIN_S)
    cfg = get_smoke_config("rwkv6-7b")
    shape = cell.split("+")[1].split(":")[0]
    rows = 64 // 16 if shape == "decode_32k" else 1
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    assert (rec["shape"], rec["n_chips"]) == (shape, 256)
    assert rec["attention_flops"] == rows * (2 * 5 * 32 * d // 16 +
                                             2 * d * hd)
    assert rec["product_flops"] > 0


@pytest.mark.parametrize("cell", [*Q_HEADS_CELLS, "rwkv6-7b"])
def test_split_attention_off_flash_holds_the_reference(
        smoke_records, reference_records, cell):
    """C11 and C13 beside the reference's own records of smoke train cells
    on ``pod``: attention at most 1.25 times the reference's a device and
    products at most 1.05 times.  C11 (``Q_HEADS_CELLS``): the plain
    dispatch on each rank's own q head against its one kv head
    (``q_heads:attention``; 1.000 and 1.005 of the reference's; every rank
    ran all 16 heads, 16.0 and 15.7 times).  C13 (rwkv6-7b's 4 heads on 16
    ranks): the wkv6 on each rank's block of rows, the state carried
    across the blocks (1.049; every rank ran all 4 heads on the whole
    sequence, 5.67 times)."""
    ref = reference_records(cell)
    if cell in Q_HEADS_CELLS:
        port = smoke_records[cell].result(timeout=SMOKE_JOIN_S)
        # each attention's q at the rank's 4 sequences, 1 head: prefix-LM
        # over 256 rows; the encoder's 256 and the decoder's 64
        assert {(b, h) for b, _, h, _ in
                port["kernel_shapes"]["q_heads:attention"]} == {(4, 1)}
    else:
        port = _flops(smoke_records[cell, False].result(
            timeout=SMOKE_JOIN_S))
    assert 0 < port["attention_flops"] <= 1.25 * ref["attention_flops"], \
        (port["attention_flops"], ref["attention_flops"])
    assert 0 < port["product_flops"] <= 1.05 * ref["product_flops"], \
        (port["product_flops"], ref["product_flops"])


def test_multipod_reduces_each_gradient_once(smoke_records):
    """C15: gemma2-9b's smoke train step on ``multipod`` (2 x 16 x 16)
    issues no collective over ``pod`` alone (a group of 2 ranks), and its
    reductions over ``pod`` and ``data`` flattened (32 ranks, or 512 with
    ``model``) are one for each parameter's gradient and one for the
    loss's token count: DTensor reduced them one mesh dim at a time, a
    reduce-scatter over ``data`` and an all-reduce over ``pod`` each."""
    rec = smoke_records["gemma2-9b", True].result(timeout=SMOKE_JOIN_S)
    groups = rec[f"rank{rec['rank_traced']}"]["collective_groups"]
    assert all("2" not in by for by in groups.values()), groups
    flat = sum(by.get(n, {"count": 0})["count"]
               for kind in ("all-reduce", "reduce-scatter")
               for by in (groups.get(kind, {}),) for n in ("32", "512"))
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), n_layers=1)
    n_params = len(list(init_params(cfg, None, device="meta").parameters()))
    assert flat == n_params + 1, (flat, n_params, groups)


# the all-reduces a microbatch adds, by operand (shape, dtype) -> bytes:
# the loss's token count (``models.losses.softmax_xent``: the labels' mask
# summed over the batch's ranks), no parameter's gradient
MICROBATCH_ALL_REDUCES = {"(), int64": 8}


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_gradients_reduce_once_a_step(smoke_records, arch):
    """C8: the step reduces each parameter's gradient once, after the
    microbatches' are summed, so at ``grad_accum`` 4 the reduce-scatter
    bytes are those at 1, and the all-reduce bytes those at 1 plus three
    microbatches' ``MICROBATCH_ALL_REDUCES``; the flops do not move.
    Reduced in every microbatch's backward, gemma2-9b's tied table
    (512 x 64) and rwkv6-7b's gathered mixes grew both (PERF.md §7)."""
    one, four = (smoke_records["accum", arch, n].result(
        timeout=SMOKE_JOIN_S) for n in ACCUMS)
    rs, ar = ([r["collectives"][k]["operand_bytes"] for r in (one, four)]
              for k in ("reduce-scatter", "all-reduce"))
    assert rs[0] == rs[1] > 0, rs
    extra = (ACCUMS[1] - ACCUMS[0]) * sum(MICROBATCH_ALL_REDUCES.values())
    assert ar[1] <= ar[0] + extra, (ar, extra)
    assert one["flops_per_device"] == four["flops_per_device"]


def test_one_rank_dtensor_step_traces_the_plain_step(tmp_path):
    """A smoke train step built by the dry-run on CPU tensors, as the
    DTensor step on a 1 x 1 gloo mesh and plain: equal flops, bytes and
    record memory (``chip_smoke.py`` ``[sharded]`` holds the same at full
    width on the card)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-1.8b"),
                              param_dtype="float32")
    shape = ShapeConfig("s", "train", 64, 4)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        runs = [(m, *dryrun.run_step(cfg, shape, m, grad_accum=2,
                                     device="cpu"))
                for m in (mesh, AbstractMesh(("data", "model"), (1, 1)))]
    finally:
        dist.destroy_process_group()
    (dm, dt, dcell), (pm, pt, pcell) = runs
    assert (dt.flops, dt.bytes_accessed) == (pt.flops, pt.bytes_accessed)
    assert dryrun.record(cfg, dm, dt, *dcell)["memory"] == \
        dryrun.record(cfg, pm, pt, *pcell)["memory"]


def test_fake_worlds_of_two_ranks_trace_in_one_process():
    """A train cell traced as rank 5 of a fake 4 x 4 world, then as rank 0
    in the same process: each record names its rank, and the work (no
    split depends on the rank here) is the same.  DTensor's cached plans
    hold the first world's mesh, whose group names follow its rank;
    ``fake_mesh`` empties them on every entry, else the second trace asks
    for a group its world does not have."""
    cfg = get_smoke_config("h2o-danube-1.8b")
    shape = ShapeConfig("s", "train", 64, 16)
    mesh = AbstractMesh(("data", "model"), (4, 4))
    recs = []
    for r in (5, 0):
        with fake_mesh(mesh, r) as m:
            trace, cell = dryrun.run_step(cfg, shape, m, grad_accum=1)
            recs.append(dryrun.record(cfg, m, trace, *cell))
    assert [r["rank_traced"] for r in recs] == [5, 0]
    assert [r["cost"]["split"] for r in recs] == ["rank5", "rank0"]
    assert "rank5" in recs[0] and "rank0" in recs[1]
    assert recs[0]["cost"]["flops_per_device"] == \
        recs[1]["cost"]["flops_per_device"] > 0
    with pytest.raises(ValueError, match="rank 16"):
        with fake_mesh(mesh, 16):
            pass


def test_fake_mesh_refuses_a_process_with_a_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo group of 1"):
            with fake_mesh(POD):
                pass
    finally:
        dist.destroy_process_group()
    with fake_mesh(POD) as mesh:
        assert mesh.size() == 256 and dist.get_world_size() == 256
    assert not dist.is_initialized()

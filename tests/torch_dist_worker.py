"""One rank of the multi-process checks in tests/test_torch_distributed.py
(not a test module: the test spawns it).

    python tests/torch_dist_worker.py RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD ranks through the FileStore at STORE, builds a
(2, 4) mesh ("data", "model") and a (2, 4) mesh ("data", "pp") with
``repro_torch.launch.mesh.make_mesh``, runs the port's ``moe_sharded``
(three paths, f32 and bf16), ``pipeline_apply``, ``compressed_psum`` and
``constrain`` on the numpy inputs in INPUTS, and writes what it computed to
OUT.  Rank 0
writes the sharded outputs gathered back to full tensors.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import LM_SHAPES, get_smoke_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context
from repro_torch.distributed.compression import compressed_psum
from repro_torch.distributed.layouts import choose_layout
from repro_torch.distributed.pipeline import pipeline_apply, pipeline_stages
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.modules import MLP

MOE_PATHS = {"prefill": ({"act_seq": None}, False), "sp": ({}, False),
             "decode": ({}, True)}


def gather_full(t, spec, mesh):
    for d, s in enumerate(spec):
        if s:
            t = coll.all_gather(t, s, d, mesh)
    return t


def moe_module(inp, arch, dtype, mesh, rules):
    """This rank's experts (experts over model, expert ff over data)."""
    def t(name):
        return torch.from_numpy(inp[f"{arch}/{name}"]).to(dtype)
    wg_spec = rules.spec(("experts", None, "moe_ff"))
    wd_spec = rules.spec(("experts", "moe_ff", None))
    p = {"router": torch.from_numpy(inp[f"{arch}/router"]),
         "w_gate": context.local_shard(t("w_gate"), wg_spec, mesh),
         "w_up": context.local_shard(t("w_up"), wg_spec, mesh),
         "w_down": context.local_shard(t("w_down"), wd_spec, mesh)}
    dense = None
    if f"{arch}/dense/w_gate" in inp:
        dense = MLP({n: t(f"dense/{n}") for n in ("w_gate", "w_up",
                                                   "w_down")})
    return tmoe.MoE(p, dense)


def main(rank, world, store, inputs, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    inp = dict(np.load(inputs))
    res = {}
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    for arch in ("qwen3-moe-235b-a22b", "arctic-480b"):
        cfg = get_smoke_config(arch)
        for dtype in (torch.float32, torch.bfloat16):
            for path, (over, decode) in MOE_PATHS.items():
                rules = choose_layout(cfg, LM_SHAPES["train_4k"], mesh, over)
                p = moe_module(inp, arch, dtype, mesh, rules)
                x = torch.from_numpy(inp[f"{arch}/x"]).to(dtype)
                if decode:
                    x = x[:, :1]
                sp = not decode and rules.rules["act_seq"] == "model" and \
                    cfg.n_heads % 4 == 0
                spec = rules.spec(("batch", "act_seq" if sp else "seq",
                                   None))
                with context.use_rules(rules):
                    y, aux = tmoe.moe_layer(
                        p, context.local_shard(x, spec, mesh), cfg,
                        decode=decode)
                tag = f"{arch}/{str(dtype)[6:]}/{path}"
                res[f"{tag}/y"] = gather_full(y, spec, mesh).float().numpy()
                res[f"{tag}/aux"] = aux.numpy()
                res[f"{tag}/local_shape"] = np.array(y.shape)

    # GPipe over the pp axis; each data row runs its own pipeline
    pmesh = make_mesh((2, 4), ("data", "pp"), device="cpu")
    stages = pipeline_stages(torch.from_numpy(inp["pipe/w"]), 4)
    mine = stages[pmesh.get_local_rank("pp")]

    def stage_fn(wg, x):
        for i in range(wg.shape[0]):
            x = torch.tanh(x @ wg[i])
        return x
    res["pipe/out"] = pipeline_apply(mine, torch.from_numpy(inp["pipe/x"]),
                                     stage_fn, pmesh, "pp",
                                     microbatches=4).numpy()

    # constrain: a DTensor laid out by the rules, redistributed
    from torch.distributed.tensor import distribute_tensor
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rules = context.ShardingRules(mesh, {"batch": "data", "embed": "model"})
    dt = distribute_tensor(full, mesh, rules.placements(("batch", None)))
    with context.use_rules(rules):
        c = context.constrain(dt, ("batch", "embed"))
        res["constrain/plain"] = context.constrain(full, ("batch",
                                                          "embed")).numpy()
    res["constrain/placements"] = np.array(str(c.placements))
    res["constrain/local"] = c.to_local().numpy()
    res["constrain/want"] = context.local_shard(
        full, rules.spec(("batch", "embed")), mesh).numpy()
    res["constrain/full"] = c.full_tensor().numpy()
    res["local_mesh"] = np.array(make_local_mesh(device="cpu").shape)

    # int8 error-feedback psum over the model axis (4 ranks)
    mean, resid = compressed_psum(torch.from_numpy(inp[f"psum/g{rank}"]),
                                  mesh.get_group("model"),
                                  torch.from_numpy(inp[f"psum/r{rank}"]))
    res["psum/mean"], res["psum/residual"] = mean.numpy(), resid.numpy()
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, inputs, out = sys.argv[1:]
    main(int(r), int(w), store, inputs, out)

"""One rank of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py).

    python tests/torch_parallel_worker.py RANK WORLD STORE INPUTS OUT CASE [CASE ...]

joins a gloo process group of WORLD ranks through a `FileStore` at STORE
(STORE "env" takes the rendezvous from the LRR_* environment through
`maybe_initialize_distributed`), runs each CASE with the arrays of INPUTS
(.npz, written by the test) on the CPU, or on the device its `device` entry
names, and saves what each case returns, with the kernels' launch counts,
to OUT/<case>_r<rank>.npz.  It imports torch, numpy and lrr_tpu_torch only:
never jax, lrr_tpu or the tests' conftest.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch.distributed as dist  # noqa: E402

from lrr_tpu_torch.parallel import distributed  # noqa: E402


DEVICE = "cpu"  # the device of the run's tensors (main sets it from INPUTS)


def _np(x):
    return x.detach().cpu().numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(DEVICE)


def _flat(prefix: str, obj, out: dict) -> dict:
    """Every tensor of a (nested) dataclass as `prefix.field` arrays."""
    if isinstance(obj, torch.Tensor):
        out[prefix] = _np(obj)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _flat(f"{prefix}.{f.name}", getattr(obj, f.name), out)
    return out


# ---------------------------------------------------------------------------
# cases: each takes the inputs and returns {name: array}
# ---------------------------------------------------------------------------


def case_mesh(inp):
    from lrr_tpu_torch.parallel import make_mesh

    m = make_mesh()
    m1 = make_mesh(dp=1)
    return {"dp_mp": np.array([m.shape["dp"], m.shape["mp"]]),
            "coords": np.array([m.axis_index("dp"), m.axis_index("mp")]),
            "dp1_mp": np.array([m1.shape["dp"], m1.shape["mp"]])}


def case_halo(inp):
    from lrr_tpu_torch.parallel import halo_exchange
    from lrr_tpu_torch.parallel.distributed import global_mesh

    mesh = global_mesh("sp")
    x = _t(inp["halo_x"])
    b = x.shape[0] // mesh.size
    block = x[mesh.rank * b : (mesh.rank + 1) * b]
    return {"ext": _np(halo_exchange(block, 2, mesh, "sp"))}


def case_score(inp):
    from lrr_tpu_torch.parallel import sharded_feature_score
    from lrr_tpu_torch.parallel.distributed import global_mesh

    score, outer = sharded_feature_score(
        _t(inp["score_vol"]), 1.0, (1.0, 1.0, 1.0), global_mesh("sp"))
    return {"score": _np(score), "outer": _np(outer)}


def case_voronoi(inp):
    from lrr_tpu_torch.ops.voronoi import build_feature_voronoi
    from lrr_tpu_torch.parallel.distributed import global_mesh

    vol, org, sp = build_feature_voronoi(
        _t(inp["vor_xyz"]), _t(inp["vor_mask"]),
        mesh=global_mesh("sp"))
    return {"vol": _np(vol), "origin": _np(org), "spacing": _np(sp)}


def case_voronoi_blocked(inp):
    from lrr_tpu_torch.ops.voronoi import build_feature_voronoi
    from lrr_tpu_torch.parallel.distributed import global_mesh

    vol, org, sp = build_feature_voronoi(
        _t(inp["big_xyz"]), _t(inp["big_mask"]),
        mesh=global_mesh("sp"))
    return {"vol": _np(vol), "origin": _np(org)}


def case_normal_equations(inp):
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.parallel import distributed_normal_equations, make_mesh

    out = {}
    for name, dp in (("dp1", 1), ("default", None)):
        mesh = make_mesh(dp=dp)
        n, i = mesh.shape["mp"], mesh.axis_index("mp")
        M = inp["ne_from"].shape[0]
        rows = slice(i * (M // n), (i + 1) * (M // n))
        AtA, Atb = distributed_normal_equations(
            mesh, Affine3D.identity(device=DEVICE),
            *(_t(inp[k][rows]) for k in ("ne_from", "ne_to", "ne_proj", "ne_w")))
        out[f"{name}.AtA"], out[f"{name}.Atb"] = _np(AtA), _np(Atb)
    return out


def case_shard(inp):
    from lrr_tpu_torch.parallel import make_mesh, shard_candidates

    x = torch.from_numpy(inp["cand_x"])
    tree = {"x": x, "pair": (x[:, :2], x[:, 2:] * 2)}
    got = shard_candidates(make_mesh(), tree)
    return {"x": _np(got["x"]), "pair0": _np(got["pair"][0]), "pair1": _np(got["pair"][1])}


def case_host_local(inp):
    from lrr_tpu_torch.parallel import (
        global_mesh, global_to_host_local, host_local_to_global,
    )
    from lrr_tpu_torch.parallel.distributed import process_info

    rank, world = process_info()
    local = np.arange(2 * 8, dtype=np.float32).reshape(2, 8) + 100 * rank
    garr = host_local_to_global(global_mesh("dp"), local)
    return {"global": _np(garr), "local": global_to_host_local(garr),
            "info": np.array([rank, world])}


def _small_pair():
    """The config and phantom pair of lrr_tpu's test_sharded_prepare_pair_matches."""
    from lrr_tpu_torch.config import (
        DescriptorConfig, EstimationConfig, FeatureConfig, IndexingConfig, KeypointConfig,
        PipelineConfig,
    )
    from lrr_tpu_torch.utils.synthetic import make_pair

    cfg = PipelineConfig(
        features=FeatureConfig(max_features=512, contrast_radius_mm=100.0),
        keypoints=KeypointConfig(max_keypoints=32),
        descriptors=DescriptorConfig(min_neighbors=8, max_neighbors=64),
        indexing=IndexingConfig(num_candidates=4, max_query_keypoints=8),
        estimation=EstimationConfig(max_matches=256, max_iterations=5, min_region_features=16),
    )
    fixed, moving, _ = make_pair((32, 32, 32), rotation_deg=4.0, translation=(2.0, -1.0, 0.5),
                                 device=DEVICE)
    return cfg, moving, fixed


def case_prepare(inp):
    from lrr_tpu_torch.parallel.distributed import global_mesh
    from lrr_tpu_torch.pipeline.registration import prepare_pair

    cfg, moving, fixed = _small_pair()
    ctx = prepare_pair(moving, fixed, cfg, mesh=global_mesh("sp"))
    out = {}
    for side in ("moving_features", "fixed_features", "moving_descriptors",
                 "fixed_descriptors", "moving_vor", "fixed_vor"):
        _flat(side, getattr(ctx, side), out)
    out["nn_table.0"], out["nn_table.1"] = _np(ctx.nn_table[0]), _np(ctx.nn_table[1])
    return out


def _small_context():
    from lrr_tpu_torch.config import pipeline_config_from_dict
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context

    with open(os.path.join(ROOT, "tests", "data", "torch_pair_small.json")) as f:
        meta = json.load(f)
    ctx = load_pair_context(os.path.join(ROOT, "tests", "data", "torch_pair_small.npz"), DEVICE)
    ctx = dataclasses.replace(ctx, moving_region_labels=None, fixed_region_labels=None)
    return ctx, pipeline_config_from_dict(meta["config"])


def _plan(inp, prefix: str = "plan."):
    from lrr_tpu_torch.sampling import SamplingPlan

    fields = {f.name: (_t(inp[prefix + f.name]) if prefix + f.name in inp else None)
              for f in dataclasses.fields(SamplingPlan)}
    return SamplingPlan(**fields)


def _serve(inp, fn_name: str):
    from lrr_tpu_torch.parallel.distributed import global_mesh
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.verify.svm import load_default_verifier

    ctx, cfg = _small_context()
    out = {}
    for label, key in (("q4", "queries"), ("q3", "queries3")):
        queries = _t(inp[key])
        plan = _plan(inp).take(slice(0, queries.shape[0]))
        res = getattr(registration, fn_name)(ctx, queries, cfg, load_default_verifier(), plan,
                                             mesh=global_mesh("dp"))
        _flat(label, res, out)
    return out


def case_staged(inp):
    return _serve(inp, "register_locations_staged")


def case_refine_all(inp):
    return _serve(inp, "register_locations")


def case_icp_mp(inp):
    from lrr_tpu_torch.parallel import make_mesh

    ctx, cfg = _small_context()
    res, cov = icp_lanes(ctx, cfg, inp, make_mesh())
    out = _flat("res", res, {})
    out["cov"] = _np(cov)
    return out


def icp_lanes(ctx, cfg, inp, mesh):
    """`register_candidate` and `backward_covariance` on the test's lanes
    (initial transforms, ROI masks and draws from INPUTS), with the matches
    split over `mesh`'s mp ranks (or whole with None)."""
    from lrr_tpu_torch.estimation.icp import register_candidate
    from lrr_tpu_torch.estimation.measurements import backward_covariance
    from lrr_tpu_torch.models.affine import Affine3D

    init = Affine3D(*(_t(inp[f"icp.init.{k}"]) for k in ("A", "t", "center")))
    plan = _plan(inp, "icp.plan.")
    moving = dataclasses.replace(ctx.moving_features, mask=_t(inp["icp.m_sel"]))
    fixed = dataclasses.replace(ctx.fixed_features, mask=_t(inp["icp.f_sel"]))
    kw = dict(moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features, mesh=mesh)
    res = register_candidate(moving, fixed, ctx.fixed_vor, ctx.moving_vor, init, cfg.estimation,
                             plan.icp(), **kw)
    cov = backward_covariance(res, moving, fixed, ctx.fixed_vor, ctx.moving_vor, cfg.estimation,
                              plan.covariance(), **kw)
    return res, cov


def case_gather(inp):
    """`gather_rows` on a tree of every dtype the port gathers."""
    from lrr_tpu_torch.parallel.distributed import gather_rows, global_mesh, process_info

    rank = process_info()[0]
    tree = {"f": torch.arange(6, dtype=torch.float32).reshape(3, 2) + 0.25 + rank,
            "i": torch.full((3, 4), -7 - rank, dtype=torch.int64),
            "b": torch.tensor([True, False, rank == 1]),
            "n": (torch.full((3, 1, 2), 2**40 + rank, dtype=torch.int64),)}
    got = gather_rows(global_mesh("dp"), tree)
    return {"f": _np(got["f"]), "i": _np(got["i"]), "b": _np(got["b"]), "n": _np(got["n"][0])}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def cli_batch(config_path: str, argv: list[str]) -> None:
    """`lrr_tpu_torch.cli.main(argv)` with `PipelineConfig()` standing for the
    config saved at `config_path` (the `batch` command has no config flag,
    as lrr_tpu's has none).  The rendezvous is the cli's own, from the
    LRR_* environment."""
    from lrr_tpu_torch import cli, config

    with open(config_path) as f:
        cfg = config.pipeline_config_from_dict(json.load(f))
    config.PipelineConfig = lambda: cfg
    cli.main(argv)
    print(f"RANK_OK {distributed.process_info()[0]}", flush=True)


def main(argv: list[str]) -> None:
    torch.set_num_threads(1)
    if argv[0] == "cli-batch":
        return cli_batch(argv[1], argv[2:])
    rank, world, store, inputs, out_dir, *cases = argv
    rank, world = int(rank), int(world)
    if store == "env":
        assert distributed.maybe_initialize_distributed(), "the environment did not initialise"
        assert distributed.maybe_initialize_distributed()  # idempotent
    else:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=90))
    assert distributed.process_info() == (rank, world)
    global DEVICE
    from lrr_tpu_torch.ops import kernels

    inp = dict(np.load(inputs)) if inputs != "-" else {}
    DEVICE = str(inp.pop("device", "cpu"))
    for case in cases:
        kernels.reset_launch_counts()
        result = CASES[case](inp)
        result.update({f"launches.{k}": np.array(n) for k, n in kernels.LAUNCHES.items()})
        result["backend"] = np.array(distributed.backend())
        np.savez(os.path.join(out_dir, f"{case}_r{rank}.npz"), **result)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(world: int, args, out_dir: str, env_route: str | None = None,
                per_rank_args=None) -> list:
    """Start `world` ranks of this script as subprocesses.  `args` follow
    RANK WORLD (STORE INPUTS OUT CASES); `per_rank_args(r)` gives a rank's
    whole argument list instead ("cli-batch CONFIG ...").  `env_route`
    "coordinator" or "torchrun" sets the LRR_* or torchrun environment."""
    import subprocess

    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    procs = []
    for r in range(world):
        e = dict(env)
        if env_route == "coordinator":
            e.update(LRR_COORDINATOR=f"127.0.0.1:{port}", LRR_NUM_PROCESSES=str(world),
                     LRR_PROCESS_ID=str(r))
        elif env_route == "torchrun":
            e.update(LRR_DISTRIBUTED="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
        a = list(per_rank_args(r)) if per_rank_args else [str(r), str(world), *args]
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *a], env=e, cwd=out_dir,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs: list, timeout: float = 240.0) -> list[str]:
    """Wait at most `timeout` seconds for every rank (then kill them all and
    fail); each must exit 0 and say RANK_OK.  Returns each rank's output."""
    import time

    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def run_ranks(world: int, args, out_dir: str, env_route: str | None = None,
              timeout: float = 240.0, per_rank_args=None) -> list[str]:
    """`start_ranks`, then `wait_ranks`."""
    return wait_ranks(start_ranks(world, args, out_dir, env_route, per_rank_args), timeout)


def load_results(out_dir: str, world: int, cases) -> dict:
    """{case: [rank 0's arrays, rank 1's, ...]}."""
    return {c: [dict(np.load(os.path.join(out_dir, f"{c}_r{r}.npz"))) for r in range(world)]
            for c in cases}


if __name__ == "__main__":
    main(sys.argv[1:])

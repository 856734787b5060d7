"""The port's multi-process runtime (lrr_tpu_torch.parallel.distributed) and
its data-parallel serving and batch paths, on the CPU.

Ranks are subprocesses (`torch_parallel_worker.py`) that rendezvous as a
user's processes would: through LRR_COORDINATOR / LRR_NUM_PROCESSES /
LRR_PROCESS_ID, or torchrun's environment with LRR_DISTRIBUTED=1.  The
serving runs are held against lrr_tpu's mesh runs (tests/test_pipeline.py's
bars) on the committed small pair context with lrr_tpu's own draws, and
against the port's one-process runs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_parallel_worker as worker
import torch_parity as tp
from lrr_tpu.pipeline.registration import register_locations as jall
from lrr_tpu.pipeline.registration import register_locations_staged as jstaged
from lrr_tpu.verify import load_default_verifier as jload_svm
from lrr_tpu_torch.io.mhd import write_mhd
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.parallel import distributed
from lrr_tpu_torch.pipeline import registration
from lrr_tpu_torch.utils.synthetic import make_pair
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm

KEY = jax.random.key(7)
SERVE = ("staged", "refine_all")


def _ranks(tmp_path, world, cases, inp, route):
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    outs = worker.run_ranks(world, ["env", os.path.join(d, "inputs.npz"), d, *cases], d,
                            env_route=route, timeout=150)
    return worker.load_results(d, world, cases), outs


def test_no_environment_means_one_process(monkeypatch):
    for name in ("LRR_COORDINATOR", "LRR_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_distributed() is False
    assert distributed.process_info() == (0, 1)
    assert distributed.backend() == "none"
    mesh = distributed.global_mesh()
    assert mesh.shape == {"dp": 1} and mesh.rank == 0
    x = torch.arange(6.0).reshape(3, 2)
    assert distributed.all_gather(mesh, x) is x and distributed.all_reduce_sum(mesh, x) is x


@pytest.mark.parametrize("route", ["coordinator", "torchrun"])
def test_environment_routes_initialise_and_gather(tmp_path, route):
    """Both environment routes bring two ranks up (idempotently: the worker
    asks twice); `host_local_to_global` gathers equal row blocks in process
    order and `global_to_host_local` gives each process its own rows."""
    res, _ = _ranks(tmp_path, 2, ["host_local"], {}, route)
    want = np.concatenate([np.arange(16, dtype=np.float32).reshape(2, 8) + 100 * r
                           for r in range(2)])
    for r in range(2):
        got = res["host_local"][r]
        np.testing.assert_array_equal(got["info"], [r, 2])
        np.testing.assert_array_equal(got["global"], want)
        np.testing.assert_array_equal(got["local"], want[2 * r : 2 * r + 2])


def test_gather_rows_round_trips_every_dtype(tmp_path):
    """One byte-packed all-gather carries float32, int64 (past 2^32), bool
    and nested trees, in rank order, bit for bit."""
    res, _ = _ranks(tmp_path, 2, ["gather"], {}, "coordinator")
    got = res["gather"][0]
    f = np.arange(6, dtype=np.float32).reshape(3, 2) + 0.25
    np.testing.assert_array_equal(got["f"], np.concatenate([f, f + 1]))
    np.testing.assert_array_equal(got["i"], np.concatenate([np.full((3, 4), -7),
                                                            np.full((3, 4), -8)]))
    np.testing.assert_array_equal(got["b"], [True, False, False, True, False, True])
    np.testing.assert_array_equal(got["n"][:, 0, 0], [2**40] * 3 + [2**40 + 1] * 3)
    np.testing.assert_array_equal(res["gather"][1]["f"], got["f"])


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """2 ranks serving the small context with lrr_tpu's draws (4 queries, and
    3 padded to 4), lrr_tpu's runs on a 2-device dp mesh, and the port's
    one-process runs."""
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    queries = tp.small_queries()
    _, m_sel, f_sel, _ = tp.jax_candidates(jctx, queries, jcfg)
    plan = tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg)
    inp = {"queries": queries, "queries3": queries[:3]}
    for name in plan.__dataclass_fields__:
        if getattr(plan, name) is not None:
            inp[f"plan.{name}"] = getattr(plan, name).numpy()
    d = tmp_path_factory.mktemp("serve")
    ranks, _ = _ranks(d, 2, list(SERVE), inp, "coordinator")

    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("dp",))
    svm = jload_svm()
    lrr = {"staged": jstaged(jctx, jnp.asarray(queries), jcfg, svm, KEY, mesh=jmesh),
           "refine_all": jall(jctx, jnp.asarray(queries), jcfg, svm, KEY, mesh=jmesh)}
    one = {}
    for case, fn in (("staged", registration.register_locations_staged),
                     ("refine_all", registration.register_locations)):
        for label, q in (("q4", queries), ("q3", queries[:3])):
            out = fn(tctx, torch.from_numpy(q), tcfg, tload_svm(), plan.take(slice(0, len(q))))
            one[case, label] = worker._flat(label, out, {})
    return ranks, lrr, one, queries


@pytest.mark.parametrize("case", SERVE)
def test_serving_on_two_ranks_matches_lrr_tpus_mesh_run(serving, case):
    """lrr_tpu's bars for its mesh runs (test_pipeline.py:353-430): rank,
    refined and selected equal, probability within 0.05, the selected
    transforms within a median of 0.5 mm on 50 points."""
    ranks, lrr, _, queries = serving
    got, want = ranks[case][0], lrr[case]
    sel = np.asarray(want.selected)
    assert (sel >= 0).sum() >= 2
    usable = np.asarray(want.candidate_mask & want.enough_features)
    for q in range(len(queries)):  # the unusable tail ties at +inf
        n = int(usable[q].sum())
        np.testing.assert_array_equal(got["q4.rank"][q, :n], np.asarray(want.rank)[q, :n])
    np.testing.assert_array_equal(got["q4.refined"], np.asarray(want.refined))
    np.testing.assert_array_equal(got["q4.selected"], sel)
    np.testing.assert_allclose(got["q4.probability"], np.asarray(want.probability), atol=0.05)
    pts = np.random.default_rng(1234).uniform(22.0, 42.0, (50, 3)).astype(np.float32)
    for q in range(len(queries)):
        if sel[q] < 0:
            continue
        mine = Affine3D(*(torch.from_numpy(got[f"q4.trans.{k}"][q, sel[q]])
                          for k in ("A", "t", "center")))
        theirs = Affine3D(*(torch.tensor(np.asarray(getattr(want.trans, k))[q, sel[q]])
                            for k in ("A", "t", "center")))
        d = (mine.apply(torch.from_numpy(pts)) - theirs.apply(torch.from_numpy(pts))).norm(dim=1)
        assert float(d.median()) < 0.5


@pytest.mark.parametrize("case", SERVE)
@pytest.mark.parametrize("label", ["q4", "q3"])
def test_serving_on_two_ranks_equals_the_one_process_run(serving, case, label):
    """On the CPU the lanes a rank refines give the bits the one-process run
    gives them, so every field is equal, with 4 queries and with 3 (padded
    to 4 by repeating query 0, then trimmed); both ranks hold it."""
    ranks, _, one, _ = serving
    want = one[case, label]
    for r in range(2):
        got = ranks[case][r]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _write_batch_inputs(d):
    """Two small phantom pairs as .mhd with the fixture's four queries, and
    the fixture's config (4 candidates: with 8 queries a batch, one rank's
    and two ranks' schedules both refine every candidate in wave 0)."""
    pair = tp.small_meta()["pair"]
    lines = []
    np.savetxt(os.path.join(d, "locs.txt"), tp.small_queries(), fmt="%.9g")
    for seed in (pair["seed"], pair["seed"] + 2):
        fixed, moving, _ = make_pair(tuple(pair["shape_zyx"]), rotation_deg=pair["rotation_deg"],
                                     translation=tuple(pair["translation"]), seed=seed,
                                     device="cpu")
        for name, v in (("moving", moving), ("fixed", fixed)):
            write_mhd(os.path.join(d, f"{name}{seed}.mhd"), v.data.numpy(),
                      tuple(v.origin.numpy()), tuple(v.spacing.numpy()))
        lines.append(f"pair{seed} {d}/moving{seed}.mhd {d}/fixed{seed}.mhd {d}/locs.txt")
    with open(os.path.join(d, "pairs.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(tp.small_meta()["config"], f)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f)) and f != "batch_report.json"}


def test_cli_batch_by_two_processes_writes_the_one_process_files(tmp_path):
    """`python -m lrr_tpu_torch.cli batch` (through `cli.main`) by 2
    processes joined through LRR_COORDINATOR: rank 0 writes result files and
    markers byte-equal to a one-process run's, rank 1 writes none, and both
    report the same selections."""
    d = str(tmp_path)
    _write_batch_inputs(d)

    def argv(out):
        return ["cli-batch", os.path.join(d, "config.json"), "batch",
                os.path.join(d, "pairs.txt"), "--out", out, "--device", "cpu"]

    one_process = worker.start_ranks(1, None, d, per_rank_args=lambda r: argv(
        os.path.join(d, "one")))
    two_ranks = worker.start_ranks(2, None, d, env_route="coordinator", per_rank_args=lambda r: argv(
        os.path.join(d, f"rank{r}")))
    outs = worker.wait_ranks(two_ranks, timeout=150) + worker.wait_ranks(one_process, timeout=60)
    for out in outs:
        assert "completed=2 failed=0 skipped=0" in out, out[-2000:]
    one, two = _files(os.path.join(d, "one")), _files(os.path.join(d, "rank0"))
    assert len(one) == 2 * (2 * 4 + 1) and one == two
    assert os.listdir(os.path.join(d, "rank1")) == ["artifacts"]
    assert not os.listdir(os.path.join(d, "rank1", "artifacts"))
    report = json.load(open(os.path.join(d, "rank0", "batch_report.json")))
    want = json.load(open(os.path.join(d, "one", "batch_report.json")))
    assert [p["locations"] for p in report["pairs"]] == [p["locations"] for p in want["pairs"]]
    assert any(loc["selected"] >= 0 for p in want["pairs"] for loc in p["locations"])

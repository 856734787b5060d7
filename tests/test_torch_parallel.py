"""lrr_tpu_torch.parallel and the spatial / match-parallel mesh branches
against lrr_tpu's, on the CPU.

The port's ranks are subprocesses (`torch_parallel_worker.py`, gloo over a
FileStore, one torch thread each); every case of a world size runs in one
launch, in a module fixture, and each rank saves what it computed.  The
lrr_tpu references run once, in module fixtures, on the 8-device virtual CPU
mesh that conftest.py sets up.  Tolerances are stated in each test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_worker as worker
from lrr_tpu.models import Affine3D as JAffine3D
from lrr_tpu.models.affine import normal_equations_terms as jterms
from lrr_tpu.parallel import distributed_normal_equations as jdne
from lrr_tpu.parallel import halo_exchange as jhalo
from lrr_tpu.parallel import make_mesh as jmake_mesh
from lrr_tpu.parallel import sharded_feature_score as jscore
from torch_parity import assert_equal_or_tie
from lrr_tpu_torch.features.extract import _score_and_outer
from lrr_tpu_torch.models.affine import Affine3D, normal_equations_terms
from lrr_tpu_torch.ops import filters
from lrr_tpu_torch.ops.voronoi import build_feature_voronoi
from lrr_tpu_torch.parallel import sharding, spatial
from lrr_tpu_torch.parallel.distributed import global_mesh
from lrr_tpu_torch.pipeline.registration import prepare_pair

FOUR = ("mesh", "halo", "score", "voronoi", "normal_equations", "shard")
TWO = ("voronoi_blocked", "prepare", "icp_mp")


def _inputs():
    rng = np.random.default_rng(1234)
    inp = {
        "halo_x": rng.standard_normal((16, 5)).astype(np.float32),
        "score_vol": rng.standard_normal((64, 24, 24)).astype(np.float32),
        "vor_xyz": rng.uniform(0, 60, (256, 3)).astype(np.float32),
        "vor_mask": rng.uniform(size=256) > 0.1,
        "ne_from": rng.uniform(0, 50, (512, 3)).astype(np.float32),
        "ne_w": rng.uniform(0.1, 1.0, 512).astype(np.float32),
        "cand_x": rng.standard_normal((8, 5)).astype(np.float32),
        # a map over 4M voxels: the blocked builder, a slab a rank
        "big_xyz": rng.uniform(0, 180, (256, 3)).astype(np.float32),
        "big_mask": rng.uniform(size=256) > 0.1,
    }
    inp["ne_to"] = inp["ne_from"] + np.float32([1.0, -0.5, 0.25])
    inp["ne_proj"] = np.broadcast_to(np.eye(3, dtype=np.float32), (512, 3, 3)).copy()
    return inp


def _icp_inputs(inp):
    """Lanes for the match-parallel ICP: every candidate of the small
    fixture's four queries, from the port's own PASS 1 and a seeded plan."""
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.sampling import draw_sampling_plan

    ctx, cfg = worker._small_context()
    q = torch.from_numpy(np.asarray(worker_meta()["queries"], np.float32))
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), q.shape[0], cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    cmask, inits, *_ = registration._pass1_fn(ctx, q, cfg, plan)
    Q, C = cmask.shape
    lanes, cands = torch.arange(Q).repeat_interleave(C), torch.arange(C).repeat(Q)
    init = Affine3D(inits.A[lanes, cands], inits.t[lanes, cands], inits.center[lanes, cands])
    m_sel, f_sel, *_ = registration._candidate_rois(ctx, init, q[lanes], cfg)
    inp.update({f"icp.init.{k}": getattr(init, k).numpy() for k in ("A", "t", "center")})
    inp["icp.m_sel"], inp["icp.f_sel"] = m_sel.numpy(), f_sel.numpy()
    lane_plan = plan.select(lanes, cands)
    for f in dataclasses.fields(lane_plan):
        if getattr(lane_plan, f.name) is not None:
            inp[f"icp.plan.{f.name}"] = getattr(lane_plan, f.name).numpy()


def worker_meta():
    import torch_parity as tp

    return tp.small_meta()


def _launch(tmp_path_factory, world, cases, inp):
    d = str(tmp_path_factory.mktemp(f"ranks{world}"))
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    worker.run_ranks(world, [os.path.join(d, "store"), os.path.join(d, "inputs.npz"), d, *cases],
                     d, timeout=150)
    return worker.load_results(d, world, cases)


@pytest.fixture(scope="module")
def inp():
    out = _inputs()
    _icp_inputs(out)
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory, inp):
    return _launch(tmp_path_factory, 4, FOUR, inp)


@pytest.fixture(scope="module")
def two(tmp_path_factory, inp):
    return _launch(tmp_path_factory, 2, TWO, inp)


@pytest.fixture(scope="module")
def jmesh4():
    return JMesh(np.asarray(jax.devices()[:4]), ("sp",))


def test_every_rank_holds_the_same_result(four, two):
    """Lockstep: whatever a collective hands back is the same on every rank
    (the halo and shard cases are per rank by design)."""
    for results in (four, two):
        for case, ranks in results.items():
            assert all(str(r["backend"]) == "gloo" for r in ranks)
            if case in ("halo", "shard", "mesh"):
                continue
            for r in ranks[1:]:
                for k in ranks[0]:
                    np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=f"{case}.{k}")


def test_halo_exchange_equals_lrr_tpus(four, inp, jmesh4):
    """Interior slabs from the neighbours and edge replication at the outer
    ranks, bit for bit as lrr_tpu's shard_map version (the
    test_halo_exchange_roundtrip case)."""
    x = jnp.asarray(inp["halo_x"])
    want = jax.shard_map(lambda b: jhalo(b, 2, "sp"), mesh=jmesh4, in_specs=P("sp"),
                         out_specs=P("sp"))(x)
    want = np.asarray(want).reshape(4, 8, 5)
    for r in range(4):
        np.testing.assert_array_equal(four["halo"][r]["ext"], want[r])
    xs = inp["halo_x"].reshape(4, 4, 5)
    np.testing.assert_array_equal(four["halo"][1]["ext"][:2], xs[0, -2:])
    np.testing.assert_array_equal(four["halo"][1]["ext"][-2:], xs[2, :2])
    np.testing.assert_array_equal(four["halo"][0]["ext"][:2], xs[0, :1].repeat(2, 0))
    np.testing.assert_array_equal(four["halo"][3]["ext"][-2:], xs[3, -1:].repeat(2, 0))


def test_halo_wider_than_the_block_raises():
    with pytest.raises(ValueError, match="exceeds"):
        spatial.halo_exchange(torch.zeros(2, 3), 3, global_mesh("sp"))


def test_one_rank_halo_replicates_both_edges():
    x = torch.arange(12.0).reshape(4, 3)
    ext = spatial.halo_exchange(x, 2, global_mesh("sp"), "sp", axis=1)
    np.testing.assert_array_equal(ext[:, :2].numpy(), x[:, :1].repeat(1, 2).numpy())
    np.testing.assert_array_equal(ext[:, -2:].numpy(), x[:, -1:].repeat(1, 2).numpy())
    assert spatial.score_halo(1.0) == 4 and spatial.score_halo(0.3, 3.0) == 1


def test_sharded_score_equals_the_one_process_score_bit_for_bit(four, inp):
    """The z-split score stage on 4 ranks (64 x 24 x 24, sigma 1): the filters
    are shift-and-add in a fixed order, so the slabs give the same bits."""
    grad = filters.gaussian_gradient(torch.from_numpy(inp["score_vol"]), 1.0, (1.0, 1.0, 1.0))
    score, outer = _score_and_outer(grad)
    np.testing.assert_array_equal(four["score"][0]["score"], score.numpy())
    np.testing.assert_array_equal(four["score"][0]["outer"], outer.numpy())


def test_sharded_score_matches_lrr_tpus(four, inp, jmesh4):
    """Against lrr_tpu's sharded score on 4 devices, at lrr_tpu's own bar
    (rtol 1e-4, atol 1e-5)."""
    want_s, want_o = jscore(jnp.asarray(inp["score_vol"]), 1.0, (1.0, 1.0, 1.0), jmesh4)
    np.testing.assert_allclose(four["score"][0]["score"], np.asarray(want_s), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(four["score"][0]["outer"], np.asarray(want_o), rtol=1e-4, atol=1e-5)


def test_sharded_voronoi_equals_lrr_tpus_and_the_one_process_map(four, inp, jmesh4):
    """The z-slab exact build on 4 ranks over 256 points
    (test_sharded_voronoi_build_bitexact's case): voxel for voxel lrr_tpu's
    sharded map and the port's one-process map."""
    from lrr_tpu.ops.voronoi import build_feature_voronoi as jbuild

    xyz, mask = inp["vor_xyz"], inp["vor_mask"]
    jvol, jorg, _ = jbuild(jnp.asarray(xyz), jnp.asarray(mask), mesh=jmesh4)
    vol, org, _ = build_feature_voronoi(torch.from_numpy(xyz), torch.from_numpy(mask))
    got = four["voronoi"][0]
    assert got["vol"].shape[0] % 4 == 0
    np.testing.assert_array_equal(got["vol"], np.asarray(jvol))
    np.testing.assert_array_equal(got["vol"], vol.numpy())
    np.testing.assert_array_equal(got["origin"], np.asarray(jorg))


def test_sharded_blocked_voronoi_equals_the_one_process_map(two, inp):
    """Above `_BLOCKED_MIN_VOXELS` each of 2 ranks runs the blocked builder on
    its slab (slab depth a multiple of the 16-voxel block): the one-process
    blocked map, except at proven ties (4 ulp) from the slab origin's
    rounding."""
    from lrr_tpu_torch.ops.voronoi import _BLOCKED_MIN_VOXELS

    xyz, mask = inp["big_xyz"], inp["big_mask"]
    vol, org, sp = build_feature_voronoi(torch.from_numpy(xyz), torch.from_numpy(mask))
    got = two["voronoi_blocked"][0]["vol"]
    assert vol.numel() > _BLOCKED_MIN_VOXELS and (got.shape[0] // 2) % 16 == 0
    assert_equal_or_tie(got, vol.numpy(), xyz, org.numpy(), sp.numpy())


def test_default_dp_rule_as_lrr_tpus():
    """dp = the largest power of two <= sqrt(n) dividing n: as lrr_tpu's
    make_mesh on 1-8 devices, and by brute force up to 64."""
    for n in range(1, 9):
        assert sharding.default_dp(n) == jmake_mesh(n).devices.shape[0], n
    for n in range(1, 65):
        want = max(p for p in (1, 2, 4, 8) if n % p == 0 and p * p <= n)
        assert sharding.default_dp(n) == want, n


def test_make_mesh_refuses_what_the_process_group_cannot_hold():
    with pytest.raises(ValueError, match="ranks"):
        sharding.make_mesh(2)  # one process, no group
    with pytest.raises(ValueError, match="does not divide"):
        sharding.make_mesh(1, dp=2)
    m = sharding.make_mesh()
    assert m.shape == {"dp": 1, "mp": 1} and m.size == 1 and m.axis_index("mp") == 0


def test_four_rank_mesh_is_two_by_two(four):
    for r in range(4):
        got = four["mesh"][r]
        np.testing.assert_array_equal(got["dp_mp"], [2, 2])
        np.testing.assert_array_equal(got["coords"], [r // 2, r % 2])
        np.testing.assert_array_equal(got["dp1_mp"], [1, 4])


@pytest.mark.parametrize("name, mp", [("dp1", 4), ("default", 2)])
def test_distributed_normal_equations(four, inp, name, mp):
    """The match axis over mp = 4 (dp 1) and mp = 2 (the default 2 x 2 mesh):
    against the one-process sum and lrr_tpu's distributed system to
    reduction-order tolerance (H1: 1e-5 of the largest entry)."""
    args = [inp[k] for k in ("ne_from", "ne_to", "ne_proj", "ne_w")]
    AtA, Atb = normal_equations_terms(Affine3D.identity(device="cpu"),
                                      *(torch.from_numpy(a) for a in args))
    jm = jmake_mesh(4, dp=4 // mp)
    spec = NamedSharding(jm, P("mp"))
    jA, jb = jdne(jm, JAffine3D.identity(), *(jax.device_put(jnp.asarray(a), spec) for a in args))
    got_A, got_b = four["normal_equations"][0][f"{name}.AtA"], four["normal_equations"][0][f"{name}.Atb"]
    for got, want in ((got_A, AtA.numpy()), (got_A, np.asarray(jA)), (got_b, Atb.numpy()),
                      (got_b, np.asarray(jb))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    want_A, _ = jterms(JAffine3D.identity(), *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got_A, np.asarray(want_A), rtol=0, atol=1e-5 * np.abs(got_A).max())


def test_shard_candidates_gives_each_rank_its_block(four, inp):
    """The leading axis over the 4 ranks (dp, mp flattened), every tensor of
    the tree: the blocks in rank order are the whole array."""
    x = inp["cand_x"]
    np.testing.assert_array_equal(np.concatenate([four["shard"][r]["x"] for r in range(4)]), x)
    np.testing.assert_array_equal(four["shard"][2]["pair0"], x[4:6, :2])
    np.testing.assert_array_equal(four["shard"][3]["pair1"], x[6:8, 2:] * 2)
    with pytest.raises(ValueError, match="split"):
        sharding.shard_candidates(_FakeMesh(3), {"x": torch.zeros(4, 2)})


class _FakeMesh:
    """A mesh's size and rank, for the pure block arithmetic."""

    def __init__(self, size):
        self.size, self.rank = size, 0


@pytest.fixture(scope="module")
def small_pair_contexts():
    """The port's one-process context and lrr_tpu's single-device context of
    lrr_tpu's test_sharded_prepare_pair_matches pair."""
    from lrr_tpu.config import (
        DescriptorConfig, EstimationConfig, FeatureConfig, IndexingConfig, KeypointConfig,
        PipelineConfig,
    )
    from lrr_tpu.pipeline import prepare_pair as jprepare
    from lrr_tpu.utils.synthetic import make_pair as jmake

    cfg, moving, fixed = worker._small_pair()
    one = prepare_pair(moving, fixed, cfg)
    jcfg = PipelineConfig(
        features=FeatureConfig(max_features=512, contrast_radius_mm=100.0),
        keypoints=KeypointConfig(max_keypoints=32),
        descriptors=DescriptorConfig(min_neighbors=8, max_neighbors=64),
        indexing=IndexingConfig(num_candidates=4, max_query_keypoints=8),
        estimation=EstimationConfig(max_matches=256, max_iterations=5, min_region_features=16),
    )
    jfixed, jmoving, _ = jmake((32, 32, 32), rotation_deg=4.0, translation=(2.0, -1.0, 0.5))
    return one, jprepare(jmoving, jfixed, jcfg)


def test_sharded_prepare_pair_equals_the_one_process_context(two, small_pair_contexts):
    """prepare_pair(mesh=) on 2 ranks (the dense stage and both Voronoi builds
    a z-slab a rank): features, descriptors, maps and the NN table equal the
    one-process context bit for bit."""
    one = small_pair_contexts[0]
    got = two["prepare"][0]
    want = worker._flat("x", one, {})
    for k, v in got.items():
        if k.startswith("launches") or k == "backend":
            continue
        if k.startswith("nn_table"):
            np.testing.assert_array_equal(v, one.nn_table[int(k[-1])].numpy())
        else:
            np.testing.assert_array_equal(v, want["x." + k], err_msg=k)
    assert got["moving_vor.index_vol"].shape[0] % 2 == 0


def test_sharded_prepare_pair_features_match_lrr_tpus_context(two, small_pair_contexts):
    """Against lrr_tpu's single-device context of the same pair, at
    lrr_tpu's bar for its own sharded run (xyz to 1e-4, the same mask)."""
    jctx = small_pair_contexts[1]
    got = two["prepare"][0]
    for side in ("moving_features", "fixed_features"):
        np.testing.assert_array_equal(got[f"{side}.mask"], np.asarray(getattr(jctx, side).mask))
        np.testing.assert_allclose(got[f"{side}.xyz"], np.asarray(getattr(jctx, side).xyz),
                                   rtol=1e-4, atol=1e-4)


def test_match_parallel_icp_equals_the_one_process_run(two, inp):
    """register_candidate and backward_covariance with the matches of 16
    lanes split over 2 mp ranks, against the one-process run: the order
    statistics see every match and the sums add in another order, so the
    decisions (iterations, match counts, flags) are equal and the values
    agree to the order of the sums: transforms to 1e-4 of their largest
    parameter, errors to 1e-4 mm, the final RMS to 1e-3 of itself (its
    sample is matched at the final transform, and a change in the last bit
    of the transform can move a match to the next voxel), angles to 2e-3
    rad (an angle near 0 is
    the acos of a cosine near 1, which turns a change dc of the cosine into
    sqrt(2 dc): a few ulp give ~1e-3), covariances to 2e-3 of a lane's
    largest entry (pinv amplifies the sum's rounding)."""
    ctx, cfg = worker._small_context()
    res, cov = worker.icp_lanes(ctx, cfg, inp, None)
    got = two["icp_mp"][0]
    for f in ("converged", "valid", "oscillated", "iterations", "number_matches"):
        np.testing.assert_array_equal(got[f"res.{f}"], getattr(res, f).numpy(), err_msg=f)
    np.testing.assert_allclose(got["res.trans.A"], res.trans.A.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["res.trans.t"], res.trans.t.numpy(), rtol=0,
                               atol=1e-4 * max(1.0, float(res.trans.t.abs().max())))
    for f, tol in (("weighted_error", 1e-4), ("weighted_error_backward", 1e-4),
                   ("initial_rms", 1e-4), ("final_rms", 1e-3 * float(res.final_rms.max())),
                   ("sheet_angles", 2e-3),
                   ("tube_angles", 2e-3), ("sheet_angles_backward", 2e-3),
                   ("tube_angles_backward", 2e-3)):
        np.testing.assert_allclose(got[f"res.{f}"], getattr(res, f).numpy(), rtol=0, atol=tol,
                                   err_msg=f)
    for name, want in (("res.covar", res.covar.numpy()), ("cov", cov.numpy())):
        scale = np.abs(want).max(axis=(1, 2), keepdims=True)
        assert (np.abs(got[name] - want) <= 2e-3 * scale).all(), name

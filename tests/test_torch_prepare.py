"""The second half of the port's stage 1 against lrr_tpu on the CPU:
descriptors, the Voronoi map builds, `prepare_pair`, and the slice as a whole
(volume -> context -> verified transforms) with the draws lrr_tpu makes.

Arithmetic is held to a stated tolerance, selections on equal inputs to
equality, the exact Voronoi builds to bit equality with each other and to
lrr_tpu's map except at proven ties.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import assert_equal_or_tie
from lrr_tpu.features.extract import extract_keypoints as jkeypoints
from lrr_tpu.ops import descriptors as jdesc
from lrr_tpu.ops import voronoi as jvor
from lrr_tpu.pipeline.registration import prepare_pair as jprepare
from lrr_tpu.pipeline.registration import register_locations_staged as jstaged
from lrr_tpu.utils.synthetic import make_pair as jmake_pair
from lrr_tpu.verify import load_default_verifier as jload_svm
from lrr_tpu_torch.config import DescriptorConfig
from lrr_tpu_torch.estimation.icp import bake_target_grid
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import descriptors as tdesc
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.ops import voronoi as tvor
from lrr_tpu_torch.pipeline import registration as treg
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.types import Volume
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm

KEY = jax.random.key(7)


@functools.lru_cache(maxsize=None)
def small_pair():
    """lrr_tpu's volumes of the small fixture's pair, its stage 1 on them,
    and the port's stage 1 on the same volumes: (fixed, moving, true,
    lrr_tpu context, port context)."""
    pair = tp.small_meta()["pair"]
    fixed, moving, true = jmake_pair(
        tuple(pair["shape_zyx"]), rotation_deg=pair["rotation_deg"],
        translation=tuple(pair["translation"]), seed=pair["seed"],
    )
    jcfg, tcfg = tp.small_configs()
    jctx = jprepare(moving, fixed, jcfg)
    tctx = treg.prepare_pair(tp.torch_volume(moving), tp.torch_volume(fixed), tcfg)
    return fixed, moving, true, jctx, tctx


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


def test_wedge_norms_are_lrr_tpus():
    for cfg in (DescriptorConfig(), DescriptorConfig(radius_mm=20.0, radius_bins=4, orient_bins=3)):
        np.testing.assert_array_equal(tdesc._wedge_norms(cfg), jdesc._wedge_norms(tp.jax_config(cfg)))


@pytest.mark.parametrize("comp", [1, 2])
def test_angles_wrt_match(comp):
    """Folded relative angles to 1e-5 rad, including vectors on the axes
    and references at both ends of [0, 2 pi]."""
    rng = np.random.default_rng(comp)
    v = rng.standard_normal((300, 3)).astype(np.float32)
    v[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, 1], [0, -1, 0], [-1, -1e-8, 0]]
    ref = rng.uniform(0, 2 * math.pi, 300).astype(np.float32)
    ref[:4] = [0.0, 2 * math.pi, math.pi, 1e-7]
    got = tdesc._angles_wrt(torch.from_numpy(v), torch.from_numpy(ref), comp).numpy()
    want = np.asarray(jdesc._angles_wrt(jnp.asarray(v), jnp.asarray(ref), comp))
    # an angle a hair under pi in one package may fold to ~0 in the other
    diff = np.abs(got - want)
    np.testing.assert_allclose(np.minimum(diff, np.abs(diff - math.pi)), 0.0, atol=1e-5)
    assert (got >= 0).all() and (got < math.pi + 1e-6).all()


@pytest.mark.parametrize("nbins,wrap,clamp_hi", [(6, False, 5), (4, True, 3)])
def test_soft_bin_1d_equal(nbins, wrap, clamp_hi):
    """Bins equal and weights bit-equal on the same fractions (values on
    bin edges and half-way points included): floor, mod and clamp only."""
    frac = np.concatenate([
        np.random.default_rng(0).uniform(-1.0, nbins + 1.0, 200),
        np.arange(-1, nbins + 2) * 1.0, np.arange(-1, nbins + 1) + 0.5,
    ]).astype(np.float32)
    got = tdesc._soft_bin_1d(torch.from_numpy(frac), nbins, wrap, clamp_hi)
    want = jdesc._soft_bin_1d(jnp.asarray(frac), nbins, wrap, clamp_hi)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nearest_features_equal_on_ties():
    """Neighbour selection on a lattice (many equal distances) with masked
    features: the same indices in the same order as `lax.top_k` of the
    negated distances, and the same in-radius flags."""
    g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    f_xyz = (g * 2.0).astype(np.float32)
    f_mask = np.random.default_rng(1).uniform(size=len(f_xyz)) > 0.2
    kp = np.array([[4.0, 4.0, 4.0], [5.0, 5.0, 5.0], [0.0, 0.0, 0.0], [4.0, 5.0, 6.0]], np.float32)
    M, radius = 60, 5.0
    idx, valid = tdesc._nearest_features(
        torch.from_numpy(kp), torch.from_numpy(f_xyz), torch.from_numpy(f_mask), M, radius
    )
    d2 = sum((kp[:, c][:, None] - f_xyz[:, c][None, :]) ** 2 for c in range(3))
    neg, want_idx = jax.lax.top_k(-jnp.where(jnp.asarray(f_mask)[None, :], jnp.asarray(d2), jnp.inf), M)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray((-neg <= radius**2) & jnp.isfinite(neg)))
    assert 0 < int(valid.sum()) < valid.numel()


def test_compute_descriptors_match():
    """On lrr_tpu's features and keypoints: the same valid set, descriptors
    to 1e-4 absolute (unit norm), keypoint frames to 1e-5."""
    _, _, _, jctx, _ = small_pair()
    jcfg, tcfg = tp.small_configs()
    for fs in (jctx.fixed_features, jctx.moving_features):
        kp = jkeypoints(fs, jcfg.keypoints)
        want = jdesc.compute_descriptors(kp, fs, jcfg.descriptors)
        got = tdesc.compute_descriptors(tp.torch_keypoints(kp), tp.torch_features(fs), tcfg.descriptors)
        m = np.asarray(want.keypoints.mask)
        assert m.sum() >= 3
        np.testing.assert_array_equal(got.keypoints.mask.numpy(), m)
        np.testing.assert_allclose(got.descriptors.numpy()[m], np.asarray(want.descriptors)[m], atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(got.descriptors.numpy()[m], axis=1), 1.0, atol=1e-5)
        for f in ("normal", "binormal"):
            np.testing.assert_allclose(
                getattr(got.keypoints, f).numpy()[m], np.asarray(getattr(want.keypoints, f))[m], atol=1e-5
            )


def test_descriptor_nn_table_matches_on_lrr_tpu_descriptors():
    """lrr_tpu's descriptor sets through the port's table (K2's plain
    version here): the same nearest moving keypoint for every live fixed
    one, distances to 1e-4 relative."""
    from lrr_tpu_torch.matching.indexing import descriptor_nn_table

    _, _, _, jctx, _ = small_pair()
    idx, dist = descriptor_nn_table(
        tp.torch_descriptors(jctx.fixed_descriptors), tp.torch_descriptors(jctx.moving_descriptors)
    )
    live = np.asarray(jctx.fixed_descriptors.keypoints.mask)
    np.testing.assert_array_equal(idx.numpy()[live], np.asarray(jctx.nn_table[0])[live])
    np.testing.assert_allclose(dist.numpy()[live], np.asarray(jctx.nn_table[1])[live], rtol=1e-4)


def test_port_features_through_lrr_tpus_keypoints():
    """The way back: the port's feature set as an lrr_tpu FeatureSet gives
    lrr_tpu's `extract_keypoints` the keypoints the port extracts from it."""
    from lrr_tpu.types import FeatureSet as JFeatureSet
    from lrr_tpu_torch.features.extract import extract_keypoints

    _, _, _, _, tctx = small_pair()
    jcfg, tcfg = tp.small_configs()
    got = extract_keypoints(tctx.fixed_features, tcfg.keypoints)
    want = jkeypoints(tp.jax_like(tctx.fixed_features, JFeatureSet), jcfg.keypoints)
    assert int(got.count()) >= 3
    for f in ("xyz", "strength", "normal", "binormal", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_compute_descriptors_chunking_and_gates():
    """Chunk size does not change a bit; a keypoint with too few neighbours
    or only sheets around it is masked out."""
    _, _, _, _, tctx = small_pair()
    _, tcfg = tp.small_configs()
    fs = tctx.fixed_features
    kp = tctx.fixed_descriptors.keypoints
    a = tdesc.compute_descriptors(kp, fs, tcfg.descriptors, chunk=128)
    b = tdesc.compute_descriptors(kp, fs, tcfg.descriptors, chunk=5)
    assert torch.equal(a.descriptors, b.descriptors) and torch.equal(a.keypoints.mask, b.keypoints.mask)
    assert int(a.keypoints.count()) > 0
    many = DescriptorConfig(min_neighbors=10**6, max_neighbors=128)
    assert int(tdesc.compute_descriptors(kp, fs, many).keypoints.count()) == 0
    sheets = type(fs)(**{**vars(fs), "shape": torch.full_like(fs.shape, 2)})
    assert int(tdesc.compute_descriptors(kp, sheets, tcfg.descriptors).keypoints.count()) == 0


# ---------------------------------------------------------------------------
# Voronoi maps
# ---------------------------------------------------------------------------

VORONOI_CASES = {
    "dense": (700, 90, (96, 96, 96), [-2.0, 1.0, 0.5], [1.0, 1.0, 1.0]),
    # sparse: wide radii, mixed capacity buckets
    "sparse": (40, 110, (128, 64, 96), [-2.0, 1.0, 0.5], [1.0, 1.0, 1.0]),
    # non-dyadic origin and spacing: where a block-relative coordinate
    # derivation differs by an ulp from the plain build's
    "non_dyadic": (700, 60, (96, 96, 96), [-1.7300001, 2.9333334, 0.1234567], [0.7, 0.7, 0.7]),
    # integer lattice: exactly equal distances, ties to the lowest index
    "lattice": (None, 60, (64, 64, 64), [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}


def voronoi_case(name):
    n, ext, shape, origin, spacing = VORONOI_CASES[name]
    rng = np.random.default_rng(11)
    if n is None:
        g = np.stack(np.meshgrid(*[np.arange(0.0, ext, 6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        pts = rng.permutation(g).astype(np.float32)
    else:
        pts = rng.uniform(0, ext, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=len(pts)) > 0.2
    return pts, mask, np.asarray(origin, np.float32), np.asarray(spacing, np.float32), shape


@pytest.mark.parametrize("name", list(VORONOI_CASES))
@pytest.mark.parametrize("block", [32, 16])
def test_exact_voronoi_builds_are_bit_equal(name, block):
    pts, mask, origin, spacing, shape = voronoi_case(name)
    args = (torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(origin),
            torch.from_numpy(spacing), shape)
    plain = tvor.voronoi_map_exact(*args)
    blocked = tvor.voronoi_map_exact_blocked(*args, block=block)
    assert plain.dtype == torch.int32 and tuple(plain.shape) == shape
    assert torch.equal(plain, blocked)
    assert bool(mask[plain.numpy()].all())  # never a masked feature


@pytest.mark.parametrize("name", ["dense", "non_dyadic", "lattice"])
def test_exact_voronoi_matches_lrr_tpu_except_at_ties(name):
    """Against lrr_tpu's exact map on a 48^3 corner of the case's grid:
    every differing voxel is a proven tie (XLA may contract the distance
    sum into FMAs), and there are few (at most 0.1 %)."""
    pts, mask, origin, spacing, _ = voronoi_case(name)
    shape = (48, 48, 48)
    got = tvor.voronoi_map_exact(torch.from_numpy(pts), torch.from_numpy(mask),
                                 torch.from_numpy(origin), torch.from_numpy(spacing), shape).numpy()
    want = np.asarray(jvor.voronoi_map_exact(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin),
                                             jnp.asarray(spacing), shape))
    n_ties = assert_equal_or_tie(got, want, pts, origin, spacing)
    assert n_ties <= 0.001 * got.size
    if name == "lattice":  # exact arithmetic on both sides: no difference at all
        assert n_ties == 0


def test_exact_voronoi_with_no_valid_feature():
    pts = torch.zeros((4, 3))
    out = tvor.voronoi_map_exact(pts, torch.zeros(4, dtype=torch.bool), torch.zeros(3), torch.ones(3), (4, 4, 4))
    assert bool((out == -1).all())
    out = tvor.voronoi_map(pts, torch.zeros(4, dtype=torch.bool), torch.zeros(3), torch.ones(3), (4, 4, 4))
    assert bool((out == -1).all())


def test_jfa_voronoi_against_exact():
    """As tests/test_matching.py holds lrr_tpu's: the flooded map's distance
    is essentially optimal everywhere; and it equals lrr_tpu's flooded map
    voxel for voxel (the same probes in the same order)."""
    rng = np.random.default_rng(1234)
    pts = rng.uniform(2, 30, (60, 3)).astype(np.float32)
    mask = rng.uniform(size=60) > 0.1
    shape = (32, 32, 32)
    args = (torch.from_numpy(pts), torch.from_numpy(mask), torch.zeros(3), torch.ones(3), shape)
    jfa = tvor.voronoi_map(*args).numpy()
    exact = tvor.voronoi_map_exact(*args).numpy()
    zz, yy, xx = np.meshgrid(*[np.arange(32.0)] * 3, indexing="ij")
    q = np.stack([xx, yy, zz], -1)
    d_jfa = ((q - pts[jfa]) ** 2).sum(-1)
    d_exact = ((q - pts[exact]) ** 2).sum(-1)
    np.testing.assert_allclose(d_jfa, d_exact, rtol=1e-3, atol=1e-3)
    assert (jfa == exact).mean() > 0.99
    want = np.asarray(jvor.voronoi_map(jnp.asarray(pts), jnp.asarray(mask), jnp.zeros(3), jnp.ones(3), shape))
    np.testing.assert_array_equal(jfa, want)


def test_jfa_seed_collisions_go_to_the_lowest_index():
    """Several features in one voxel: the seed is the lowest index, on every
    run (a minimum, not a racing write)."""
    pts = torch.tensor([[5.2, 5.1, 5.0], [5.0, 5.0, 5.0], [4.9, 5.2, 5.1], [1.0, 1.0, 1.0]])
    out = tvor.voronoi_map(pts, torch.tensor([False, True, True, True]), torch.zeros(3), torch.ones(3), (8, 8, 8))
    assert int(out[5, 5, 5]) == 1  # nearest of the two valid ones there, and the lower index
    assert int(out[1, 1, 1]) == 3


def test_build_feature_voronoi_matches_lrr_tpu():
    """Shape bucketing, origin and spacing as lrr_tpu's; the map equal
    except at proven ties."""
    _, _, _, jctx, _ = small_pair()
    fs = jctx.fixed_features
    jvol, jorigin, jspacing = jvor.build_feature_voronoi(fs.xyz, fs.mask)
    tfs = tp.torch_features(fs)
    vol, origin, spacing = tvor.build_feature_voronoi(tfs.xyz, tfs.mask)
    assert tuple(vol.shape) == jvol.shape and all(s % 32 == 0 for s in vol.shape)
    np.testing.assert_array_equal(origin.numpy(), np.asarray(jorigin))
    np.testing.assert_array_equal(spacing.numpy(), np.asarray(jspacing))
    assert_equal_or_tie(vol.numpy(), np.asarray(jvol), np.asarray(fs.xyz), origin.numpy(), spacing.numpy())


@pytest.mark.parametrize(
    "n_vox_limit,blocked_min,want", [(10**9, 10**9, "voronoi_map_exact"),
                                      (10**9, 1, "voronoi_map_exact_blocked"), (1, 1, "voronoi_map")]
)
def test_build_feature_voronoi_picks_by_size(monkeypatch, n_vox_limit, blocked_min, want):
    called = []
    for name in ("voronoi_map_exact", "voronoi_map_exact_blocked", "voronoi_map"):
        real = getattr(tvor, name)
        monkeypatch.setattr(tvor, name, lambda *a, _n=name, _r=real, **k: (called.append(_n), _r(*a, **k))[1])
    monkeypatch.setattr(tvor, "_BLOCKED_MIN_VOXELS", blocked_min)
    pts = torch.tensor(np.random.default_rng(2).uniform(0, 20, (30, 3)), dtype=torch.float32)
    vol, _, _ = tvor.build_feature_voronoi(pts, torch.ones(30, dtype=torch.bool), exact_max_voxels=n_vox_limit)
    assert called[0] == want and tuple(vol.shape) == (32, 32, 32)


@pytest.mark.parametrize("name,shape", [("dense", (48, 64, 32)), ("non_dyadic", (48, 48, 48)),
                                        ("lattice", (32, 64, 48)), ("non_dyadic", (37, 50, 21)),
                                        ("sparse", (1, 17, 70))])
@pytest.mark.parametrize("blocked_min", [1 << 22, 1])
def test_voronoi_kernel_wrapper_on_the_cpu_is_the_plain_build(monkeypatch, name, shape, blocked_min):
    """K4's wrapper on CPU tensors gives the plain exact build's bits, on
    shapes a multiple of the 16-voxel block and ragged ones, whichever
    plain build the size picks; no K4 counter moves."""
    pts, mask, origin, spacing, _ = voronoi_case(name)
    args = (torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(origin),
            torch.from_numpy(spacing), shape)
    monkeypatch.setattr(tvor, "_BLOCKED_MIN_VOXELS", blocked_min)
    before = kernels.counts()
    got = kernels.voronoi_nearest(*args)
    assert kernels.counts() == before
    assert torch.equal(got, tvor.voronoi_map_exact(*args))


def test_no_voronoi_kernel_counter_moves_on_the_cpu():
    """`build_feature_voronoi` on the CPU, exact and by jump flooding: the
    K4 launch count and shape log stay as they were."""
    pts = torch.tensor(np.random.default_rng(5).uniform(0, 20, (30, 3)), dtype=torch.float32)
    before = (kernels.LAUNCHES["voronoi"], dict(kernels.VORONOI_SHAPES))
    for limit in (10**9, 1):
        tvor.build_feature_voronoi(pts, torch.ones(30, dtype=torch.bool), exact_max_voxels=limit)
    assert (kernels.LAUNCHES["voronoi"], kernels.VORONOI_SHAPES) == before


def test_lookup_reads_the_built_map():
    pts, mask, origin, spacing, shape = voronoi_case("dense")
    tpts, tmask = torch.from_numpy(pts), torch.from_numpy(mask)
    vol = tvor.voronoi_map_exact(tpts, tmask, torch.from_numpy(origin), torch.from_numpy(spacing), (32, 32, 32))
    q = torch.tensor([[3.2, 4.9, 7.5], [-50.0, 0.0, 0.0], [29.4, 31.6, 30.5]])
    got = tvor.lookup(vol, torch.from_numpy(origin), torch.from_numpy(spacing), q)
    assert got.tolist() == [int(vol[7, 4, 5]), int(vol[0, 0, 0]), int(vol[30, 31, 31])]


# ---------------------------------------------------------------------------
# prepare_pair and the slice as a whole
# ---------------------------------------------------------------------------


def test_prepare_pair_matches_lrr_tpu():
    """lrr_tpu's volumes through both stage 1s.  Measured: feature and
    keypoint sets equal in order and mask.  Asserted: masks equal; feature
    positions to 1e-3 mm; descriptors to 1e-4; the maps equal except at
    proven ties; the NN table equal on live rows; the rows
    `icp.bake_target_grid` bakes from the map equal to what the map and the
    features give."""
    _, _, _, jctx, tctx = small_pair()
    for side in ("moving", "fixed"):
        jf, tf = getattr(jctx, side + "_features"), getattr(tctx, side + "_features")
        m = np.asarray(jf.mask)
        np.testing.assert_array_equal(tf.mask.numpy(), m)
        np.testing.assert_array_equal(tf.shape.numpy()[m], np.asarray(jf.shape)[m])
        np.testing.assert_allclose(tf.xyz.numpy()[m], np.asarray(jf.xyz)[m], atol=1e-3)
        jd, td = getattr(jctx, side + "_descriptors"), getattr(tctx, side + "_descriptors")
        km = np.asarray(jd.keypoints.mask)
        assert km.sum() >= 3
        np.testing.assert_array_equal(td.keypoints.mask.numpy(), km)
        np.testing.assert_allclose(td.descriptors.numpy()[km], np.asarray(jd.descriptors)[km], atol=1e-4)
        jv, tv = getattr(jctx, side + "_vor"), getattr(tctx, side + "_vor")
        assert tuple(tv.index_vol.shape) == jv.index_vol.shape
        n_ties = assert_equal_or_tie(tv.index_vol.numpy(), np.asarray(jv.index_vol),
                                     np.asarray(jf.xyz), np.asarray(jv.origin), np.asarray(jv.spacing))
        assert n_ties <= 0.001 * tv.index_vol.numel()
    live = np.asarray(jctx.fixed_descriptors.keypoints.mask)
    np.testing.assert_array_equal(tctx.nn_table[0].numpy()[live], np.asarray(jctx.nn_table[0])[live])
    np.testing.assert_allclose(tctx.nn_table[1].numpy()[live], np.asarray(jctx.nn_table[1])[live], rtol=1e-4)
    grid = bake_target_grid(tctx.fixed_features, tctx.fixed_vor)
    assert grid.shape == (tctx.fixed_vor.index_vol.numel(), 8)
    flat = tctx.fixed_vor.index_vol.reshape(-1).long()
    np.testing.assert_array_equal(grid[:, :3].numpy(), tctx.fixed_features.xyz[flat].numpy())


def test_prepare_pair_refuses_volumes_on_two_devices():
    vol = Volume(torch.zeros((8, 8, 8)), torch.zeros(3), torch.ones(3))
    _, tcfg = tp.small_configs()
    with pytest.raises(ValueError, match="volumes on"):
        treg.prepare_pair(vol.to("meta"), vol, tcfg)


def _tensors(obj):
    """Every tensor a context holds, through its dataclasses and tuples."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for x in obj:
            yield from _tensors(x)


@pytest.mark.parametrize("source", ["prepare_pair", "load_pair_context"])
def test_pair_context_holds_maps_not_grids(source):
    """A context, from the port's stage 1 or from a saved file, holds each
    side's bare int32 Voronoi map over its feature set and no baked NN-row
    grid: no field names one, and nothing in it is larger than a map."""
    if source == "prepare_pair":
        ctx = small_pair()[4]
    else:
        ctx = load_pair_context(tp.SMALL + ".npz", device="cpu")
    assert not [f.name for f in dataclasses.fields(ctx) if "grid" in f.name]
    maps = []
    for side in ("moving", "fixed"):
        vor, fs = getattr(ctx, side + "_vor"), getattr(ctx, side + "_features")
        assert vor.index_vol.dtype == torch.int32 and vor.index_vol.dim() == 3
        assert -1 <= int(vor.index_vol.min()) and int(vor.index_vol.max()) < fs.capacity
        maps.append(vor.index_vol.numel())
    assert max(t.numel() for t in _tensors(ctx)) == max(maps)


def gt_errors(trans_A, trans_t, trans_c, selected, queries, true):
    """Per verified query, the median error of the selected transform
    against the true one on 20 probes around the query."""
    errs = []
    inv = true.inverse()
    for q in np.nonzero(selected >= 0)[0]:
        c = int(selected[q])
        tr = Affine3D(tp.t_(trans_A[q, c]), tp.t_(trans_t[q, c]), tp.t_(trans_c[q, c]))
        probe = torch.as_tensor(queries[q][None, :] + np.random.default_rng(int(q)).uniform(
            -10, 10, (20, 3)).astype(np.float32))
        src = inv.apply(probe)
        errs.append(float(torch.linalg.norm(tr.apply(src) - true.apply(src), dim=1).median()))
    return np.asarray(errs)


def test_slice_from_volumes_matches_lrr_tpu():
    """The slice as a whole: lrr_tpu-made volumes -> the port's
    `prepare_pair` -> `register_locations_staged`, against lrr_tpu's own
    two steps, with the sampling plan built from lrr_tpu's key tree: equal
    `selected` and `verified`; the selected transforms within 0.5 % where the
    feature sets came out equal (they do here), else ground-truth error
    within max(1.0 mm, 1.5 x) of lrr_tpu's."""
    _, _, jtrue, jctx, tctx = small_pair()
    jcfg, tcfg = tp.small_configs()
    queries = tp.small_queries()
    _, m_sel, f_sel, _ = tp.jax_candidates(jctx, queries, jcfg)
    plan = tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg)

    want = jstaged(jctx, jnp.asarray(queries), jcfg, jload_svm(), KEY)
    got = treg.register_locations_staged(tctx, torch.from_numpy(queries), tcfg, tload_svm(), plan)

    sel = np.asarray(want.selected)
    assert (sel >= 0).sum() >= 2, "the fixture should verify most queries"
    np.testing.assert_array_equal(got.selected.numpy(), sel)
    np.testing.assert_array_equal(got.verified.numpy(), np.asarray(want.verified))
    sets_equal = all(
        np.array_equal(getattr(tctx, s).mask.numpy(), np.asarray(getattr(jctx, s).mask))
        for s in ("moving_features", "fixed_features")
    )
    if sets_equal:
        for q in np.nonzero(sel >= 0)[0]:
            for g, w in ((got.trans.A, want.trans.A), (got.trans.t, want.trans.t)):
                g, w = g[q, sel[q]].numpy(), np.asarray(w)[q, sel[q]]
                assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()
    true = tp.torch_affine(jtrue)
    e_got = gt_errors(got.trans.A.numpy(), got.trans.t.numpy(), got.trans.center.numpy(),
                      got.selected.numpy(), queries, true)
    e_want = gt_errors(np.asarray(want.trans.A), np.asarray(want.trans.t), np.asarray(want.trans.center),
                       sel, queries, true)
    assert np.median(e_got) <= max(1.0, 1.5 * np.median(e_want))

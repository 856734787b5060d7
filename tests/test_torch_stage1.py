"""Stage 1 of the port against lrr_tpu, stage by stage on the CPU: filters,
resampling, `eigh3`, contrast filtering, sparsification, the detector's
parts, keypoints and the phantoms.

Each stage is fed lrr_tpu's own output of the stage before (as numpy), so a
last-bit difference (XLA:CPU contracts multiply-add chains into FMAs,
PyTorch on the CPU does not) cannot grow into another feature set.
Arithmetic stages are held to a stated tolerance; selection stages on equal
inputs are held to equality, index for index.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lrr_tpu import types as jtypes
from lrr_tpu.features import extract as jx
from lrr_tpu.ops import contrast as jcontrast
from lrr_tpu.ops import eig3 as jeig
from lrr_tpu.ops import filters as jfilters
from lrr_tpu.ops import resample as jresample
from lrr_tpu.ops.sparsify import sparsify_mask as jsparsify
from lrr_tpu.utils import synthetic as jsyn
from lrr_tpu_torch.config import FeatureConfig, KeypointConfig
from lrr_tpu_torch.features import extract as tx
from lrr_tpu_torch.ops import contrast as tcontrast
from lrr_tpu_torch.ops import eig3 as teig
from lrr_tpu_torch.ops import filters as tfilters
from lrr_tpu_torch.ops import resample as tresample
from lrr_tpu_torch.ops.sparsify import sparsify_mask as tsparsify
from lrr_tpu_torch.types import Volume
from lrr_tpu_torch.utils import synthetic as tsyn


def close(got, want, rtol=1e-5, atol_of_scale=1e-6):
    """allclose with atol a fraction of the field's scale (its largest
    magnitude)."""
    got, want = tp.np_(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_of_scale * max(float(np.abs(want).max()), 1e-30)
    )


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma,order", [(1.0, 0), (1.0, 1), (0.7, 0), (2.5, 1), (0.0, 0), (0.0, 1)])
def test_gaussian_kernel_is_lrr_tpus(sigma, order):
    np.testing.assert_array_equal(
        tfilters.gaussian_kernel(sigma, order), jfilters.gaussian_kernel(sigma, order)
    )


@pytest.mark.parametrize("name", ["smooth", "smooth_aniso", "gradient", "box_mean", "downsample2"])
def test_filters_match(name):
    """rtol 1e-5, atol 1e-6 of the field's scale: the same taps in the same
    order, up to FMA contraction."""
    vol = np.random.default_rng(0).standard_normal((12, 10, 14)).astype(np.float32) * 50
    calls = {
        "smooth": lambda f, v: f.gaussian_smooth(v, 1.0),
        "smooth_aniso": lambda f, v: f.gaussian_smooth(v, (0.0, 1.3, 0.6)),
        "gradient": lambda f, v: f.gaussian_gradient(v, (1.0, 0.5, 0.5), (2.0, 2.0, 1.0)),
        "box_mean": lambda f, v: f.box_mean(v, 1),
        "downsample2": lambda f, v: f.downsample2(v),
    }
    got = calls[name](tfilters, torch.from_numpy(vol))
    want = calls[name](jfilters, jnp.asarray(vol))
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_correlate1d_pads_with_the_edge_value():
    x = torch.arange(5, dtype=torch.float32).reshape(1, 1, 5).expand(2, 3, 5).contiguous()
    out = tfilters.correlate1d(x, np.array([1.0, 0.0, 0.0], np.float32), 2)
    assert out[0, 0].tolist() == [0.0, 0.0, 1.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [0, 3])
def test_sample_trilinear_matches(channels):
    """Scalar and vector volumes; points inside, on the last voxel (the
    clamp at W-2), exactly on voxels and outside."""
    rng = np.random.default_rng(1)
    shape = (6, 7, 8) + ((channels,) if channels else ())
    vol = rng.standard_normal(shape).astype(np.float32)
    pts = rng.uniform(-1.5, 9.0, (400, 3)).astype(np.float32)
    pts[:8] = [[7, 6, 5], [7.0, 0, 0], [0, 6, 0], [0, 0, 5], [3, 2, 1], [-0.0, 0, 0],
               [7.0001, 3, 3], [6.9999, 5.9999, 4.9999]]
    got, got_in = tresample.sample_trilinear(torch.from_numpy(vol), torch.from_numpy(pts))
    want, want_in = jresample.sample_trilinear(jnp.asarray(vol), jnp.asarray(pts))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    assert 0 < int(got_in.sum()) < len(pts)
    close(got, want)


def test_sample_trilinear_on_a_flat_axis():
    vol = np.random.default_rng(2).standard_normal((1, 4, 5)).astype(np.float32)
    pts = np.array([[1.5, 2.25, 0.0], [4.0, 3.0, 0.0], [2.0, 1.0, 0.5]], np.float32)
    got, got_in = tresample.sample_trilinear(torch.from_numpy(vol), torch.from_numpy(pts))
    want, want_in = jresample.sample_trilinear(jnp.asarray(vol), jnp.asarray(pts))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    close(got, want)


def test_warp_and_resample_isotropic_match():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((9, 16, 14)).astype(np.float32) * 10
    origin, spacing = np.array([1.0, -2.0, 0.5], np.float32), np.array([0.7, 0.8, 2.0], np.float32)
    jvol = jtypes.Volume(jnp.asarray(data), jnp.asarray(origin), jnp.asarray(spacing))
    tvol = tp.torch_volume(jvol)
    want = jresample.resample_isotropic(jvol, 1.0)
    got = tresample.resample_isotropic(tvol, 1.0)
    assert tuple(got.data.shape) == want.data.shape
    np.testing.assert_array_equal(got.spacing.numpy(), np.asarray(want.spacing))
    close(got.data, want.data)

    def shift(p):
        return p + 4.0

    want = jresample.warp_volume(jvol.data, (5, 6, 7), jvol.origin, jvol.spacing * 1.5, shift,
                                 jvol.origin, jvol.spacing, fill=-1.0)
    got = tresample.warp_volume(tvol.data, (5, 6, 7), tvol.origin, tvol.spacing * 1.5, shift,
                                tvol.origin, tvol.spacing, fill=-1.0)
    assert float((got == -1.0).float().mean()) > 0.05  # some of the grid lies outside
    close(got, want)


# ---------------------------------------------------------------------------
# eigh3
# ---------------------------------------------------------------------------


def test_eigh3_matches_with_equal_signs():
    """Well-separated spectra: eigenvalues to 1e-5 of the scale, eigenvectors
    to 1e-4 with the SAME sign (the construction leaves no sign free)."""
    rng = np.random.default_rng(4)
    B = rng.standard_normal((500, 3, 3)).astype(np.float32)
    S = B @ B.transpose(0, 2, 1) + np.diag([0.0, 2.0, 5.0]).astype(np.float32)
    w_t, V_t = teig.eigh3(torch.from_numpy(S))
    w_j, V_j = jeig.eigh3(jnp.asarray(S))
    close(w_t, w_j, rtol=1e-4, atol_of_scale=1e-5)
    gaps = np.diff(np.asarray(w_j), axis=-1).min(-1)
    sep = gaps > 0.05 * np.asarray(w_j)[:, 2]
    assert sep.sum() > 300
    np.testing.assert_allclose(V_t.numpy()[sep], np.asarray(V_j)[sep], atol=2e-4)
    # and it is a decomposition: S V = V diag(w), V orthonormal, det +1
    V = V_t.numpy()[sep].astype(np.float64)
    w = w_t.numpy()[sep].astype(np.float64)
    np.testing.assert_allclose(S[sep] @ V, V * w[:, None, :], atol=2e-3)
    np.testing.assert_allclose(np.linalg.det(V), 1.0, atol=1e-4)


@pytest.mark.parametrize(
    "S",
    [np.eye(3), np.zeros((3, 3)), np.diag([2.0, 2.0, 5.0]), np.diag([1.0, 4.0, 4.0]),
     np.outer([1.0, 2.0, 2.0], [1.0, 2.0, 2.0])],
    ids=["identity", "zero", "low_pair", "high_pair", "rank1"],
)
def test_eigh3_degenerate_cases_match(S):
    """Repeated eigenvalues go through the fallback directions and the
    first-index `argmax`: the same frame as lrr_tpu's."""
    S = S.astype(np.float32)[None]
    w_t, V_t = teig.eigh3(torch.from_numpy(S))
    w_j, V_j = jeig.eigh3(jnp.asarray(S))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5)
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), atol=1e-5)


# ---------------------------------------------------------------------------
# contrast filtering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,radius", [((24, 20, 22), 5), ((16, 16, 16), 4), ((13, 18, 12), 6), ((7, 30, 30), 3)]
)
def test_contrast_keep_mask_equal(shape, radius):
    """A size where the filter is not skipped (and pads every axis): the
    mask equals lrr_tpu's voxel for voxel, with some valid-masked voxels
    left out of the statistics."""
    rng = np.random.default_rng(5)
    score = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    valid = rng.uniform(size=shape) > 0.1
    got = tcontrast.contrast_keep_mask(torch.from_numpy(score), torch.from_numpy(valid), radius)
    want = np.asarray(jcontrast.contrast_keep_mask(jnp.asarray(score), jnp.asarray(valid), radius))
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,radius", [((8, 8, 8), 0), ((8, 8, 8), 5), ((7, 30, 30), 4)])
def test_contrast_keep_mask_early_returns(shape, radius):
    """Radius 0 and volumes under two radii along some axis: everything
    survives, as in lrr_tpu."""
    score = np.random.default_rng(6).uniform(size=shape).astype(np.float32)
    ones = np.ones(shape, bool)
    got = tcontrast.contrast_keep_mask(torch.from_numpy(score), torch.from_numpy(ones), radius)
    want = np.asarray(jcontrast.contrast_keep_mask(jnp.asarray(score), jnp.asarray(ones), radius))
    assert got.numpy().all() and want.all()


def test_masked_median_is_the_lower_one():
    v = np.array([[4.0, 1.0, 3.0, 2.0, 9.0, 9.0], [5.0, 1.0, 2.0, 9.0, 9.0, 9.0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    med, mad = tcontrast._masked_median_and_mad(torch.from_numpy(v), torch.from_numpy(valid))
    jmed, jmad = jcontrast._masked_median_and_mad(jnp.asarray(v), jnp.asarray(valid))
    assert med.tolist() == [3.0, 2.0]  # entry n // 2 of the sorted valid values
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    np.testing.assert_allclose(mad.numpy(), np.asarray(jmad), rtol=1e-6)


# ---------------------------------------------------------------------------
# sparsification
# ---------------------------------------------------------------------------


def greedy_oracle(xyz, strength, mask, min_distance):
    """The sequential greedy, in float32 with lrr_tpu's distance sum."""
    order = np.argsort(-np.where(mask, strength, -np.inf), kind="stable")
    kept = []
    keep = np.zeros(len(xyz), bool)
    d2max = np.float32(min_distance * min_distance)
    for i in order:
        if not mask[i]:
            continue
        if kept:
            d = xyz[i][None, :] - xyz[kept]
            d2 = (np.float32(0) + d[:, 0] ** 2 + d[:, 1] ** 2) + d[:, 2] ** 2
            if (d2 < d2max).any():
                continue
        kept.append(i)
        keep[i] = True
    return keep


def sparsify_case(name):
    rng = np.random.default_rng(7)
    if name == "uniform":
        xyz = rng.uniform(0, 20, (600, 3))
        strength = rng.uniform(0, 1, 600)
    elif name == "tied_strengths":  # ties go to the lower index
        xyz = rng.uniform(0, 12, (500, 3))
        strength = rng.integers(0, 4, 500).astype(np.float64)
    elif name == "lattice":  # distances exactly at and around the radius, equal strengths
        g = np.stack(np.meshgrid(*[np.arange(7.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = g * 1.0
        strength = np.ones(len(xyz))
    elif name == "chain":  # a long dependency chain: decreasing strength along a line
        xyz = np.stack([np.arange(300) * 1.5, np.zeros(300), np.zeros(300)], -1)
        strength = -np.arange(300.0)
    elif name == "duplicates":
        xyz = np.repeat(rng.uniform(0, 10, (100, 3)), 3, axis=0)
        strength = rng.uniform(0, 1, 300)
    elif name == "far_offset":  # CT-like coordinates, negative too
        xyz = rng.uniform(-8, 8, (400, 3)) + np.array([-250.0, 310.0, 120.0])
        strength = rng.uniform(0, 1, 400)
    mask = rng.uniform(size=len(xyz)) > 0.15
    return xyz.astype(np.float32), strength.astype(np.float32), mask


@pytest.mark.parametrize(
    "name", ["uniform", "tied_strengths", "lattice", "chain", "duplicates", "far_offset"]
)
@pytest.mark.parametrize("min_distance", [2.0, 6.0])
def test_sparsify_mask_is_the_greedy_keep_set(name, min_distance):
    """Exactly the strength-greedy keep set: equal to the sequential oracle
    and to lrr_tpu's mask."""
    xyz, strength, mask = sparsify_case(name)
    got = tsparsify(torch.from_numpy(xyz), torch.from_numpy(strength), torch.from_numpy(mask),
                    min_distance).numpy()
    np.testing.assert_array_equal(got, greedy_oracle(xyz, strength, mask, min_distance))
    want = np.asarray(jsparsify(jnp.asarray(xyz), jnp.asarray(strength), jnp.asarray(mask),
                                min_distance, batch=128))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0 and not got[~mask].any()


def test_sparsify_mask_with_nothing_valid():
    xyz = torch.zeros((5, 3))
    keep = tsparsify(xyz, torch.ones(5), torch.zeros(5, dtype=torch.bool), 2.0)
    assert keep.shape == (5,) and not keep.any()


# ---------------------------------------------------------------------------
# the detector, part by part, on lrr_tpu's intermediates
# ---------------------------------------------------------------------------

SMALL_PAIR = dict(shape_zyx=(32, 32, 32), rotation_deg=4.0, translation=(2.0, -1.0, 0.5), seed=3)


@functools.lru_cache(maxsize=None)
def jax_pair():
    return jsyn.make_pair(**SMALL_PAIR)


@functools.lru_cache(maxsize=None)
def jax_level():
    """lrr_tpu's intermediates of one detection level on the fixed 32^3
    phantom: gradient, score, outer products, the candidates its own slab
    budget picks, and what its sparse pass makes of them."""
    vol = jax_pair()[0]
    grad = jfilters.gaussian_gradient(vol.data, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    score, outer6 = jx._score_and_outer(grad)
    flat = jnp.where(score >= jx.SCORE_FLOOR, score, -jnp.inf).reshape(-1)
    top, idx = jax.lax.top_k(flat, 600)
    D, H, W = score.shape
    cand = jnp.stack([idx // (H * W), (idx // W) % H, idx % W], -1)
    num_maxima, shape, dirs = jx._nms_classify(score, outer6, cand, top)
    xyz, strength, ok = jx._subvoxel_fit(score, cand, vol.origin, vol.spacing)
    rdirs, proj = jx._refine_directions(grad, xyz, shape, dirs, vol.origin, vol.spacing)
    return dict(vol=vol, grad=grad, score=score, outer6=outer6, cand=cand, top=top,
                num_maxima=num_maxima, shape=shape, dirs=dirs, xyz=xyz, strength=strength,
                ok=ok, rdirs=rdirs, proj=proj)


def test_score_and_outer_match():
    lv = jax_level()
    score, outer6 = tx._score_and_outer(tp.t_(lv["grad"]))
    close(score, lv["score"])
    close(outer6, lv["outer6"])


def test_nms_classify_matches():
    """On lrr_tpu's score volume and candidates: the same maxima counts and
    classes; the compacted directions to 1e-3 where the outer product's
    spectrum is separated (an eigenvector of a near-degenerate matrix moves
    with the last bit of its entries)."""
    lv = jax_level()
    num_maxima, shape, dirs = tx._nms_classify(
        tp.t_(lv["score"]), tp.t_(lv["outer6"]), tp.t_(lv["cand"]).long(), tp.t_(lv["top"])
    )
    np.testing.assert_array_equal(num_maxima.numpy(), np.asarray(lv["num_maxima"]))
    np.testing.assert_array_equal(shape.numpy(), np.asarray(lv["shape"]))
    assert len(set(shape.tolist())) == 3  # corners, tubes and sheets all occur
    c = np.asarray(lv["cand"])
    w = np.asarray(jeig.eigvalsh3(jx._sym_from_6(lv["outer6"][c[:, 0], c[:, 1], c[:, 2]])))
    sep = np.diff(w, axis=-1).min(-1) > 0.05 * w[:, 2]
    assert sep.sum() > 100
    np.testing.assert_allclose(dirs.numpy()[sep], np.asarray(lv["dirs"])[sep], atol=1e-3)


def test_subvoxel_fit_matches():
    """Positions to 5e-4 mm (1e-5 of the coordinates' scale), strengths to
    1e-4 of their scale, the same accepted set."""
    lv = jax_level()
    vol = tp.torch_volume(lv["vol"])
    xyz, strength, ok = tx._subvoxel_fit(
        tp.t_(lv["score"]), tp.t_(lv["cand"]).long(), vol.origin, vol.spacing
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(lv["ok"]))
    assert 0.2 < ok.float().mean() < 1.0
    np.testing.assert_allclose(xyz.numpy(), np.asarray(lv["xyz"]), atol=5e-4)
    close(strength, lv["strength"], rtol=1e-4, atol_of_scale=1e-4)


def test_refine_directions_match():
    """Fed lrr_tpu's positions, classes and NMS directions: frames and
    projectors to 1e-4."""
    lv = jax_level()
    vol = tp.torch_volume(lv["vol"])
    dirs, proj = tx._refine_directions(
        tp.t_(lv["grad"]), tp.t_(lv["xyz"]), tp.t_(lv["shape"]), tp.t_(lv["dirs"]),
        vol.origin, vol.spacing,
    )
    np.testing.assert_allclose(dirs.numpy(), np.asarray(lv["rdirs"]), atol=1e-4)
    np.testing.assert_allclose(proj.numpy(), np.asarray(lv["proj"]), atol=1e-4)


def jax_slab_candidates(flat_score, D, H, W, k):
    """The slab budget of lrr_tpu's `_detect_level_jit`, with `lax.top_k`."""
    nb = max(1, min(16, D // 16))
    if nb == 1:
        return jax.lax.top_k(flat_score, k)
    k_b = -(-k // nb)
    padded = jnp.pad(flat_score.reshape(D, H * W), ((0, (-D) % nb), (0, 0)),
                     constant_values=-jnp.inf).reshape(nb, -1)
    slab_scores, slab_idx = jax.lax.top_k(padded, k_b)
    flat_idx = (slab_idx + (jnp.arange(nb) * padded.shape[1])[:, None]).reshape(-1)[:k]
    return slab_scores.reshape(-1)[:k], jnp.minimum(flat_idx, D * H * W - 1)


@pytest.mark.parametrize(
    "D,k", [(12, 50), (32, 64), (35, 61), (50, 200), (50, 3000)],
    ids=["one_slab", "two_slabs", "two_slabs_padded", "three_slabs_padded", "more_than_live"],
)
def test_slab_candidates_equal(D, k):
    """The slab top-k on equal scores with many ties and -inf entries: the
    same voxels in the same order as `lax.top_k` gives (lowest index first
    among equals), for one slab, several, and a z extent that needs padding
    rows."""
    H, W = 5, 6
    rng = np.random.default_rng(D)
    score = rng.integers(0, 6, D * H * W).astype(np.float32)  # heavy ties
    score[rng.uniform(size=score.shape) < 0.4] = -np.inf
    got_s, got_i = tx._slab_candidates(torch.from_numpy(score), D, min(k, score.size))
    want_s, want_i = jax_slab_candidates(jnp.asarray(score), D, H, W, min(k, score.size))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def tied_feature_set(n=400, seed=8):
    """An lrr_tpu FeatureSet with few distinct strengths (ties everywhere),
    all three classes and a partial mask."""
    rng = np.random.default_rng(seed)
    return jtypes.FeatureSet(
        xyz=jnp.asarray(rng.uniform(0, 30, (n, 3)).astype(np.float32)),
        strength=jnp.asarray(rng.integers(1, 6, n).astype(np.float32)),
        shape=jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
        projector=jnp.asarray(rng.standard_normal((n, 3, 3)).astype(np.float32)),
        directions=jnp.asarray(rng.standard_normal((n, 3, 3)).astype(np.float32)),
        mask=jnp.asarray(rng.uniform(size=n) > 0.2),
    )


@pytest.mark.parametrize("capacity", [100, 400, 500])
def test_compact_top_equal(capacity):
    """Below, at and above the set's size, with tied strengths: the same
    rows in the same order as lrr_tpu's `lax.top_k`."""
    fs = tied_feature_set()
    got = tx._compact_top(tp.torch_features(fs), capacity)
    want = jx._compact_top(fs, capacity)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(tp.np_(getattr(got, f.name)), np.asarray(getattr(want, f.name)))


@pytest.mark.parametrize("max_keypoints", [16, 64, 512])
def test_extract_keypoints_equal(max_keypoints):
    fs = tied_feature_set()
    got = tx.extract_keypoints(tp.torch_features(fs), KeypointConfig(max_keypoints=max_keypoints))
    want = jx.extract_keypoints(fs, tp.jax_config(KeypointConfig(max_keypoints=max_keypoints)))
    assert int(got.count()) > 5
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(tp.np_(getattr(got, f.name)), np.asarray(getattr(want, f.name)))


# ---------------------------------------------------------------------------
# detect_features as a whole
# ---------------------------------------------------------------------------


def feature_agreement(a, b, tol_mm=1e-3):
    """Share of a's valid features with a valid feature of b within `tol_mm`
    and of the same class."""
    ax, bx = tp.np_(a.xyz)[tp.np_(a.mask)], tp.np_(b.xyz)[tp.np_(b.mask)]
    ash, bsh = tp.np_(a.shape)[tp.np_(a.mask)], tp.np_(b.shape)[tp.np_(b.mask)]
    d = np.linalg.norm(ax[:, None, :] - bx[None, :, :], axis=-1)
    j = d.argmin(1)
    return float(((d[np.arange(len(ax)), j] <= tol_mm) & (ash == bsh[j])).mean())


def dense_volume(shape, seed):
    """A small dense phantom from lrr_tpu (structure of all three classes
    through the whole volume)."""
    return jsyn.make_dense_phantom(shape, seed=seed, noise=0.5)


DETECT_CASES = {
    # 32 // 16 = 2 slabs; contrast filtering skipped (radius 100 mm)
    "phantom32_two_slabs": (lambda: jax_pair()[0],
                            FeatureConfig(max_features=1024, contrast_radius_mm=100.0)),
    # 24 // 16 = 1 slab, anisotropic extents
    "dense_one_slab": (lambda: dense_volume((24, 40, 36), 5),
                       FeatureConfig(max_features=2048, contrast_radius_mm=100.0)),
    # contrast filtering active at level 2 (radius 6 voxels) and level 1 (3)
    "dense_contrast": (lambda: dense_volume((40, 40, 40), 6),
                       FeatureConfig(max_features=2048, contrast_radius_mm=6.0)),
}


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_detect_features_matches(case):
    """Whole `detect_features` on an lrr_tpu-made volume.  Measured on this
    machine: the two sets come out equal in order and mask in all three
    cases.  Asserted: every port feature has an lrr_tpu feature within
    1e-3 mm of the same class, and the reverse, for at least 99 % of both
    sets; counts within 1 %; and where the masks are equal, positions to
    1e-3 mm and strengths to 1e-3 of their scale row for row."""
    make, cfg = DETECT_CASES[case]
    jvol = make()
    want = jx.detect_features(jvol, tp.jax_config(cfg))
    got = tx.detect_features(tp.torch_volume(jvol), cfg)
    n_want, n_got = int(want.count()), int(got.count())
    assert n_want > 100
    assert abs(n_got - n_want) <= 0.01 * n_want
    assert feature_agreement(got, want) >= 0.99
    assert feature_agreement(want, got) >= 0.99
    m = np.asarray(want.mask)
    if np.array_equal(got.mask.numpy(), m):
        np.testing.assert_array_equal(got.shape.numpy()[m], np.asarray(want.shape)[m])
        np.testing.assert_allclose(got.xyz.numpy()[m], np.asarray(want.xyz)[m], atol=1e-3)
        close(got.strength.numpy()[m], np.asarray(want.strength)[m], rtol=1e-3, atol_of_scale=1e-3)


def test_detect_features_masks_equal_on_the_small_phantom():
    """On the 32^3 phantom the port's set equals lrr_tpu's in order and mask
    (what the slice tests rely on to share one sampling plan)."""
    cfg = DETECT_CASES["phantom32_two_slabs"][1]
    jvol = jax_pair()[0]
    want = jx.detect_features(jvol, tp.jax_config(cfg))
    got = tx.detect_features(tp.torch_volume(jvol), cfg)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_detect_features_on_a_constant_volume_finds_nothing():
    vol = Volume(torch.full((16, 16, 16), 3.0), torch.zeros(3), torch.ones(3))
    fs = tx.detect_features(vol, FeatureConfig(max_features=256))
    assert int(fs.count()) == 0 and fs.capacity == 256
    assert all(bool(torch.isfinite(getattr(fs, f)).all()) for f in ("xyz", "strength", "projector"))
    kp = tx.extract_keypoints(fs, KeypointConfig(max_keypoints=8))
    assert int(kp.count()) == 0 and kp.capacity == 8


def test_detect_features_on_a_tiny_volume_does_not_crash():
    vol = tsyn.make_phantom((8, 8, 8), seed=1, device="cpu")
    fs = tx.detect_features(vol, FeatureConfig(max_features=64, max_candidates_per_level=4096))
    assert fs.capacity == 64 and fs.xyz.shape == (64, 3)
    assert bool(torch.isfinite(fs.xyz).all())


# ---------------------------------------------------------------------------
# phantoms, and the device rule
# ---------------------------------------------------------------------------


def test_make_phantom_is_bit_equal():
    want = jsyn.make_phantom((12, 14, 16), origin=(1.0, 2.0, 3.0), spacing=(1.0, 0.8, 1.5),
                             seed=5, noise=0.3)
    got = tsyn.make_phantom((12, 14, 16), origin=(1.0, 2.0, 3.0), spacing=(1.0, 0.8, 1.5),
                            seed=5, noise=0.3, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_array_equal(got.spacing.numpy(), np.asarray(want.spacing))


def test_make_pair_matches():
    """The same seed names the same pair: the fixed volume bit for bit (it
    is numpy's), the moving one to 1e-5 of its scale, the same transform."""
    jf, jm, jt = jax_pair()
    tf, tm, tt = tsyn.make_pair(**SMALL_PAIR, device="cpu")
    np.testing.assert_array_equal(tf.data.numpy(), np.asarray(jf.data))
    close(tm.data, jm.data, rtol=1e-5, atol_of_scale=1e-5)
    for k in ("A", "t", "center"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(jt, k)))


def test_make_dense_pair_matches():
    """The dense phantom (device-assembled fields, host-added impulses) and
    its warped partner, with noise: to 1e-4 of the volume's scale."""
    kw = dict(rotation_deg=5.0, translation=(1.0, -1.0, 0.5), seed=2, noise=0.5, dense=True)
    jf, jm, _ = jsyn.make_pair((28, 30, 26), **kw)
    tf, tm, _ = tsyn.make_pair((28, 30, 26), **kw, device="cpu")
    assert float(np.asarray(jf.data).max()) > 50
    close(tf.data, jf.data, rtol=1e-4, atol_of_scale=1e-4)
    close(tm.data, jm.data, rtol=1e-4, atol_of_scale=1e-4)


def test_dense_phantom_adds_impulses_that_share_a_voxel(monkeypatch):
    """Two impulses on one voxel are both added (a racing write would keep
    one): the volume's sum grows by both amplitudes' smoothed mass."""
    seen = {}
    real = tsyn._assemble_dense

    def spy(A, B, C, impulses, noise_vol, **kw):
        seen["impulses"] = impulses.clone()
        return real(A, B, C, impulses, noise_vol, **kw)

    monkeypatch.setattr(tsyn, "_assemble_dense", spy)
    tsyn.make_dense_phantom((12, 12, 12), blobs_per_mm3=0.3, seed=0, device="cpu")
    imp = seen["impulses"]
    assert float(imp.max()) > 220.0  # above any single amplitude: a shared voxel
    rng = np.random.default_rng(0)
    n_try = int(12 * 12 * 12 * 0.3 / 0.31)
    cand = np.stack([rng.integers(2, 10, n_try) for _ in range(3)], 0)
    semi, ctr = 0.42 * 12, 0.5 * 11
    inside = (((cand - ctr) / semi) ** 2).sum(0) <= 1.0
    amp = rng.uniform(80.0, 220.0, int(inside.sum())).astype(np.float32)
    np.testing.assert_allclose(float(imp.sum()), float(amp.astype(np.float64).sum()), rtol=1e-5)


@pytest.mark.parametrize("make", ["make_pair", "make_phantom", "make_dense_phantom"])
def test_creators_raise_without_a_card(monkeypatch, make):
    """`device=None` means the CUDA card: with none, the functions that
    create data raise and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tsyn, make)((8, 8, 8))


def test_detect_features_follows_the_volumes_device():
    """A CPU volume is detected on the CPU; a volume on another device is
    not quietly moved (the meta device refuses the first host read)."""
    vol = tsyn.make_phantom((16, 16, 16), seed=1, device="cpu")
    fs = tx.detect_features(vol, FeatureConfig(max_features=64))
    assert fs.xyz.device.type == "cpu"
    with pytest.raises((RuntimeError, NotImplementedError)):
        tx.detect_features(vol.to("meta"), FeatureConfig(max_features=64))

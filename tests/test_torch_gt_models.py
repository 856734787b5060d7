"""Ground-truth models, subsampling and intensity registration in the
PyTorch port against lrr_tpu on the same inputs (the cases of
tests/test_eval.py and tests/test_intensity.py, from numpy seeds): B-spline
and dense deformation fields, the affine fit to a field, grid decimation,
mutual information and NCC, `register_intensity` with lrr_tpu's own draws,
and the result files with a real deformation field.  Every lrr_tpu
registration of the file runs once, in a module fixture.

Tolerances: displacements within 1e-6 (of the largest), the affine fit
within 1e-5 (its translation of the ROI's extent), decimation masks bit for
bit, the metrics within 1e-6 relative (MI of the entropies it subtracts),
the 1 % / 99 % percentiles bit for bit; `register_intensity` with NCC
within 1e-4 of the largest parameter, with MI equal for two Adam steps
(1e-4) and then held to test_intensity.py's 1.5 mm bar on both sides: Adam
turns a gradient component at rounding level into a full +-lr step, and on
this pair the two MI runs are 6e-5 apart after step 2 and 0.05 after step 5
at one level."""

from __future__ import annotations

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.pipeline.intensity as jint
import lrr_tpu.pipeline.results as jres
from lrr_tpu.models.affine import Affine3D as JAffine
from lrr_tpu.models.bspline import BSplineTransform as JBSpline
from lrr_tpu.models.bspline import DeformationField as JField
from lrr_tpu.models.bspline import fit_affine_to_field as jfit
from lrr_tpu.ops.subsample import grid_decimate_mask as jdecimate
from lrr_tpu.ops.subsample import multiresolution_masks as jmultires
from lrr_tpu.pipeline.registration import LocationResult as JLocationResult
from lrr_tpu.types import FeatureSet as JFeatureSet
from lrr_tpu.utils.synthetic import make_pair

import lrr_tpu_torch.pipeline.intensity as tint
import lrr_tpu_torch.pipeline.results as tres
from lrr_tpu_torch.models.bspline import BSplineTransform, DeformationField, fit_affine_to_field
from lrr_tpu_torch.ops.subsample import grid_decimate_mask, multiresolution_masks

from tests import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and many small ops on a full thread pool in each
    worker spin against each other and slow a file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_points(seed: int, shapes, iterations: int, samples: int) -> list[torch.Tensor]:
    """The sample points lrr_tpu's register_intensity draws at each step
    (intensity.py:150-152: one split of the running key a step, uniform
    over each level's index box), as the port's per-level plan."""
    key = jax.random.key(seed)
    out = []
    for D, H, W in shapes:
        steps = []
        hi = jnp.asarray([W - 1, H - 1, D - 1], jnp.float32)
        for _ in range(iterations):
            key, k = jax.random.split(key)
            steps.append(np.asarray(jax.random.uniform(k, (samples, 3), maxval=hi)))
        out.append(torch.from_numpy(np.stack(steps)))
    return out


INTENSITY = dict(levels=2, iterations_per_level=60, samples=8192, learning_rate=0.05)


@pytest.fixture(scope="module")
def ref():
    """test_intensity.py::test_recovers_translation's pair and runs, by
    lrr_tpu; and MI runs cut after two steps."""
    fixed, moving, true = make_pair((40, 40, 40), rotation_deg=0.0,
                                    translation=(3.0, -2.0, 1.0), seed=2)
    out = {"pair": (fixed, moving, true)}
    for metric in ("ncc", "mi"):
        out[metric] = jint.register_intensity(fixed, moving, metric=metric, **INTENSITY)
    out["mi_2"] = jint.register_intensity(fixed, moving, metric="mi", levels=1,
                                          iterations_per_level=2, samples=8192,
                                          learning_rate=0.05)
    return out


# ---------------------------------------------------------------------------
# deformation models
# ---------------------------------------------------------------------------


def smooth_bspline(rng, scale=2.0):
    """test_eval.py::test_smooth_field's transform."""
    tr = JBSpline.identity(grid_shape=(8, 8, 8), origin=(-40.0,) * 3, spacing=(20.0,) * 3)
    coeff = scale * rng.standard_normal(tr.coefficients.shape).astype(np.float32)
    return tr.replace(coefficients=jnp.asarray(coeff))


def test_bspline_displacement_matches():
    rng = np.random.default_rng(1234)
    jt = smooth_bspline(rng)
    x = rng.uniform(-60, 120, (500, 3)).astype(np.float32)  # inside and past the grid
    want = np.asarray(jt.displacement(jnp.asarray(x)))
    got = tp.torch_bspline(jt).displacement(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # constant coefficients give a constant displacement (partition of unity)
    const = BSplineTransform.identity((10, 10, 10), (-40.0,) * 3, (20.0,) * 3, device="cpu")
    const = dataclasses.replace(const, coefficients=const.coefficients + torch.tensor([1.0, -2.0, 3.0]))
    d = const.displacement(torch.from_numpy(rng.uniform(0, 50, (20, 3)).astype(np.float32)))
    np.testing.assert_allclose(d.numpy(), np.broadcast_to([1.0, -2.0, 3.0], d.shape), atol=1e-4)
    ident = BSplineTransform.identity(device="cpu")
    assert torch.equal(ident.apply(torch.ones(4, 3)), torch.ones(4, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BSplineTransform.identity()


def affine_field_case(rng):
    """test_eval.py::test_fit_affine_to_field's field."""
    aff = JAffine(
        A=jnp.asarray(np.eye(3, dtype=np.float32)
                      + 0.05 * rng.standard_normal((3, 3)).astype(np.float32)),
        t=jnp.asarray([3.0, 1.0, -2.0]), center=jnp.zeros(3))
    return aff, JField.from_transform(aff.apply, (20, 20, 20), jnp.zeros(3), jnp.ones(3) * 2.0)


def test_deformation_field_matches():
    rng = np.random.default_rng(1234)
    aff, jf = affine_field_case(rng)
    tf = DeformationField.from_transform(tp.torch_affine(aff).apply, (20, 20, 20), torch.zeros(3),
                                         torch.ones(3) * 2.0)
    np.testing.assert_allclose(tf.field.numpy(), np.asarray(jf.field), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jf.field)).max())
    x = rng.uniform(-5, 45, (300, 3)).astype(np.float32)  # some outside: zero displacement
    want = np.asarray(jf.displacement(jnp.asarray(x)))
    got = tp.torch_deformation_field(jf).displacement(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tp.torch_deformation_field(jf).apply(torch.from_numpy(x)).numpy(),
                               np.asarray(jf.apply(jnp.asarray(x))), rtol=0, atol=2e-5)


@pytest.mark.parametrize("model", ["field", "bspline"])
def test_fit_affine_to_field_matches(model):
    rng = np.random.default_rng(1234)
    if model == "field":
        aff, jdef = affine_field_case(rng)
        tdef = tp.torch_deformation_field(jdef)
        lo, hi = np.ones(3, np.float32) * 4, np.ones(3, np.float32) * 30
    else:
        jdef = smooth_bspline(rng)
        tdef = tp.torch_bspline(jdef)
        lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32) * 60
    jaff, jrms = jfit(jdef, jnp.asarray(lo), jnp.asarray(hi))
    taff, trms = fit_affine_to_field(tdef, torch.from_numpy(lo), torch.from_numpy(hi))
    # A within 1e-5; t within 1e-5 of the ROI's extent (an error e in A
    # moves t by e times the coordinates, up to 60 mm here)
    np.testing.assert_allclose(taff.A.numpy(), np.asarray(jaff.A), rtol=0, atol=1e-5)
    np.testing.assert_allclose(taff.t.numpy(), np.asarray(jaff.t), rtol=0,
                               atol=1e-5 * np.abs(hi).max())
    np.testing.assert_allclose(float(trms), float(jrms), rtol=1e-4, atol=1e-5)
    if model == "field":
        assert float(trms) < 0.05
        np.testing.assert_allclose(taff.A.numpy(), np.asarray(aff.A), atol=1e-2)


# ---------------------------------------------------------------------------
# subsampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["density", "strongest", "negative_cells", "ties_and_mask"])
def test_grid_decimate_mask_bit_equal(case):
    rng = np.random.default_rng(1234)
    if case == "density":  # test_eval.py::test_decimation_density
        xyz = rng.uniform(0, 20, (2000, 3)).astype(np.float32)
        strength = rng.uniform(1, 5, 2000).astype(np.float32)
        mask, spacing = np.ones(2000, bool), 5.0
    elif case == "strongest":  # test_eval.py::test_strongest_kept
        xyz = np.zeros((5, 3), np.float32)
        strength = np.asarray([1.0, 5.0, 3.0, 2.0, 4.0], np.float32)
        mask, spacing = np.ones(5, bool), 2.0
    elif case == "negative_cells":  # cells below 0 and far out: the hash wraps in int32
        xyz = rng.uniform(-3e4, 3e4, (3000, 3)).astype(np.float32)
        strength = rng.uniform(1, 5, 3000).astype(np.float32)
        mask, spacing = np.ones(3000, bool), 3.0
    else:  # equal strengths within a cell (ties to the lowest index), masked rows
        xyz = rng.uniform(-10, 10, (1500, 3)).astype(np.float32)
        strength = rng.integers(0, 3, 1500).astype(np.float32)
        mask, spacing = rng.uniform(size=1500) < 0.7, 4.0
    want = np.asarray(jdecimate(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(strength), spacing))
    got = grid_decimate_mask(torch.from_numpy(xyz), torch.from_numpy(mask),
                             torch.from_numpy(strength), spacing).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "strongest":
        np.testing.assert_array_equal(got, [False, True, False, False, False])
    if case == "negative_cells":
        cell = np.floor(xyz / spacing).astype(np.int32)
        assert (cell < 0).any() and got.sum() > 100


def test_multiresolution_masks_bit_equal():
    rng = np.random.default_rng(1234)
    xyz = rng.uniform(0, 40, (1000, 3)).astype(np.float32)
    n = len(xyz)
    jfs = JFeatureSet(
        xyz=jnp.asarray(xyz), strength=jnp.asarray(rng.uniform(1, 5, n).astype(np.float32)),
        shape=jnp.zeros(n, jnp.int32), projector=jnp.zeros((n, 3, 3)),
        directions=jnp.zeros((n, 3, 3)), mask=jnp.asarray(rng.uniform(size=n) < 0.9))
    want = jmultires(jfs, (8.0, 4.0, 0.0))
    got = multiresolution_masks(tp.torch_features(jfs), (8.0, 4.0, 0.0))
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[0].sum()) < int(got[1].sum()) < int(got[2].sum())


# ---------------------------------------------------------------------------
# intensity registration
# ---------------------------------------------------------------------------


def test_metrics_match():
    """test_intensity.py::TestMetrics's inputs."""
    rng = np.random.default_rng(1234)
    a = rng.uniform(0, 1, 4000).astype(np.float32)
    b = rng.uniform(0, 1, 4000).astype(np.float32)
    m = rng.uniform(size=4000) < 0.9
    for x, y in ((a, a), (a, b), (a, np.sqrt(a))):
        want = float(jint.mutual_information(jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)))
        got = float(tint.mutual_information(torch.from_numpy(x), torch.from_numpy(y),
                                            torch.from_numpy(m)))
        # MI is h_f + h_m - h_j: 1e-6 relative to the entropies (2 log 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 2 * np.log(32))
    g = rng.standard_normal(1000).astype(np.float32)
    for y in (2.0 * g + 1.0, -g, rng.standard_normal(1000).astype(np.float32)):
        want = float(jint.ncc(jnp.asarray(g), jnp.asarray(y), jnp.ones(1000, bool)))
        got = float(tint.ncc(torch.from_numpy(g), torch.from_numpy(y), torch.ones(1000, dtype=bool)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_percentiles_equal_jnp_percentile():
    """`_normalize_intensity`'s percentiles by a sort (no torch.quantile,
    which refuses inputs over 2^24 elements), bit for bit."""
    rng = np.random.default_rng(3)
    for n in (10, 1001, 1 << 20):
        v = rng.gamma(2.0, 100.0, n).astype(np.float32)
        for p in (1.0, 50.0, 99.0):
            want = np.asarray(jnp.percentile(jnp.asarray(v), p))
            assert tint.percentile(torch.from_numpy(v), p).numpy().tobytes() == want.tobytes()
    vol = rng.normal(0, 1, (20, 30, 40)).astype(np.float32)
    np.testing.assert_array_equal(tint._normalize_intensity(torch.from_numpy(vol)).numpy(),
                                  np.asarray(jint._normalize_intensity(jnp.asarray(vol))))


def test_intensity_points_are_one_plan_per_seed():
    a = tint.draw_intensity_points(5, [(10, 12, 14), (20, 24, 28)], 3, 100, "cpu")
    b = tint.draw_intensity_points(5, [(10, 12, 14), (20, 24, 28)], 3, 100, "cpu")
    assert [x.shape for x in a] == [(3, 100, 3)] * 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    hi = torch.tensor([13.0, 11.0, 9.0])
    assert bool((a[0] >= 0).all()) and bool((a[0] <= hi).all())


def gt_median_error(res, true) -> float:
    pts = np.random.default_rng(0).uniform(10, 30, (30, 3)).astype(np.float32)
    got = res.trans.apply(torch.from_numpy(pts)).numpy() if isinstance(
        res.trans.A, torch.Tensor) else np.asarray(res.trans.apply(jnp.asarray(pts)))
    return float(np.median(np.linalg.norm(got - np.asarray(true.apply(jnp.asarray(pts))), axis=1)))


@pytest.mark.parametrize("metric", ["ncc", "mi"])
def test_register_intensity_with_lrr_tpus_draws(ref, metric):
    fixed, moving, true = ref["pair"]
    pts = jax_points(0, [(20, 20, 20), (40, 40, 40)], 60, 8192)
    got = tint.register_intensity(tp.torch_volume(fixed), tp.torch_volume(moving), metric=metric,
                                  points=pts, **INTENSITY)
    want = ref[metric]
    assert got.levels_run == want.levels_run == 2
    w = np.asarray(want.resample_trans.theta)
    if metric == "ncc":
        np.testing.assert_allclose(got.resample_trans.theta.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(float(got.metric_value), float(want.metric_value), rtol=1e-5)
    else:
        two = tint.register_intensity(tp.torch_volume(fixed), tp.torch_volume(moving),
                                      metric="mi", levels=1, iterations_per_level=2,
                                      samples=8192, learning_rate=0.05,
                                      points=jax_points(0, [(40, 40, 40)], 2, 8192))
        w2 = np.asarray(ref["mi_2"].resample_trans.theta)
        np.testing.assert_allclose(two.resample_trans.theta.numpy(), w2, rtol=0,
                                   atol=1e-4 * np.abs(w2).max())
    # test_intensity.py's bar, on both sides
    assert gt_median_error(got, true) < 1.5
    assert gt_median_error(want, true) < 1.5


def test_register_intensity_draws_its_own_plan():
    fixed, moving, _ = make_pair((24, 24, 24), rotation_deg=0.0, translation=(1.0, 0.0, 0.0),
                                 seed=3)
    kw = dict(levels=2, iterations_per_level=3, samples=512, metric="ncc")
    a = tint.register_intensity(tp.torch_volume(fixed), tp.torch_volume(moving), seed=4, **kw)
    b = tint.register_intensity(tp.torch_volume(fixed), tp.torch_volume(moving), seed=4, **kw)
    assert torch.equal(a.resample_trans.theta, b.resample_trans.theta)
    inv = a.resample_trans.inverse()
    assert torch.allclose(inv.A, a.trans.A) and torch.allclose(inv.t, a.trans.t)


# ---------------------------------------------------------------------------
# result files with a real deformation field
# ---------------------------------------------------------------------------


def synthetic_result(rng, C: int = 2) -> JLocationResult:
    """One query's [C] result with refined candidates, the numbers of a
    served run in kind."""
    A = np.eye(3, dtype=np.float32) + 0.02 * rng.standard_normal((C, 3, 3)).astype(np.float32)
    B = rng.standard_normal((C, 12, 12)).astype(np.float32)
    f = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    return JLocationResult(
        trans=JAffine(A=f(A), t=f(rng.uniform(-3, 3, (C, 3))), center=f(rng.uniform(20, 40, (C, 3)))),
        covar=f(1e-4 * B @ B.transpose(0, 2, 1) + 1e-4 * np.eye(12)),
        measurements=f(rng.uniform(0, 1, (C, 8))), probability=f(rng.uniform(0, 1, C)),
        verified=jnp.asarray([True, False]), converged=jnp.ones(C, bool), valid=jnp.ones(C, bool),
        oscillated=jnp.zeros(C, bool), enough_features=jnp.ones(C, bool),
        candidate_mask=jnp.ones(C, bool), initial_angle=f(rng.uniform(0, 0.3, C)),
        rank=jnp.arange(C, dtype=jnp.int32), selected=jnp.asarray(0, jnp.int32),
        query_mapped=f(rng.uniform(20, 40, (C, 3))), refined=jnp.ones(C, bool),
        keypoint_moving=f(rng.uniform(20, 40, (C, 3))), keypoint_fixed=f(rng.uniform(20, 40, (C, 3))),
        initial_rms=f(rng.uniform(0.5, 2, C)), final_rms=f(rng.uniform(0.1, 0.5, C)))


def test_reference_artifacts_with_a_real_deformation_field(tmp_path):
    """write_reference_artifacts of both packages with a `DeformationField`
    rasterised from a smooth B-spline (each package's own): the same files,
    the ground-truth block's numbers within 1e-4 relative (the field is
    float32 on both sides), the transfer-covariance lines within 1e-4 as
    test_torch_results.py holds them, everything else byte for byte."""
    rng = np.random.default_rng(1234)
    jb = smooth_bspline(rng, scale=1.5)
    origin, spacing = jnp.zeros(3), jnp.ones(3) * 2.0
    jfield = JField.from_transform(jb.apply, (32, 32, 32), origin, spacing)
    tfield = DeformationField.from_transform(tp.torch_bspline(jb).apply, (32, 32, 32),
                                             torch.zeros(3), torch.ones(3) * 2.0)
    res = synthetic_result(rng)
    q = np.array([31.0, 30.0, 29.0])
    jpaths = jres.write_reference_artifacts(str(tmp_path / "j"), 0, res, q, roi_mm=30.0,
                                            gt_field=jfield)
    tpaths = tres.write_reference_artifacts(str(tmp_path / "t"), 0, tp.torch_location_result(res),
                                            q, roi_mm=30.0, gt_field=tfield)
    assert [os.path.basename(p) for p in jpaths] == [os.path.basename(p) for p in tpaths]
    assert len(tpaths) == 6
    num = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")
    for jp, tpth in zip(jpaths, tpaths):
        jl, tl = open(jp).read().split("\n"), open(tpth).read().split("\n")
        assert len(jl) == len(tl)
        if "transform" in os.path.basename(jp):
            assert jl == tl
            continue
        assert jl[0].startswith("Affine Approximation Squared Error: ")
        body = jl.index("Final estimated transform: ")
        covj = jl.index("Final estimated covarianceJ from moving points: ")
        for i, (a, b) in enumerate(zip(jl, tl)):
            if i < body or covj <= i <= covj + 4:
                assert num.sub("#", a) == num.sub("#", b), (jp, i)
                fa = np.array([float(v) for v in num.findall(a)])
                fb = np.array([float(v) for v in num.findall(b)])
                np.testing.assert_allclose(fb, fa, rtol=1e-4, atol=1e-4 * max(np.abs(fa).max(initial=0), 1e-3))
            else:
                assert a == b, (jp, i)

"""The estimate family's leaves and point-set estimators in the PyTorch port
against lrr_tpu on the same inputs: robust weights and scales, the affine
model's helpers and normal equations, the feature-set helpers, geometry,
the chunked spatial k-NN and radius count, classic ICP, the 2-D similarity
model and its ICP, and L-BFGS.  Inputs come from numpy seeds (the cases of
tests/test_robust.py, test_transforms.py, test_matching.py, test_eval.py and
test_cdc.py); every lrr_tpu run is made once, in a module fixture.

Tolerances: elementwise robust and geometry functions within 1 ulp of
lrr_tpu's op-by-op results (rho_bt within 1 ulp of its scale, since
1 - x^3 cancels), sums within 1e-6 of the size of their terms (another
order), selections (medians, indices, counts, masks) exactly; ICP match
indices equal at every iteration, equal iteration counts, final parameters
within 1e-3 of the largest |parameter| (the float32 error of lrr_tpu's own
uncentred solves, measured in the tests); L-BFGS within 1e-5 of the largest |x| with
the same stop."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.estimation.icp_classic as jicp
import lrr_tpu.models.affine as jaff
import lrr_tpu.ops.geometry as jgeo
import lrr_tpu.ops.knn as jknn
import lrr_tpu.ops.robust as jrob
import lrr_tpu.types as jtypes
from lrr_tpu.estimation.lbfgs import lbfgs as jlbfgs
from lrr_tpu.estimation.similarity2d import icp_similarity2d as jsim_icp
from lrr_tpu.models.similarity import Similarity2D as JSim
from lrr_tpu.models.similarity import similarity2d_normal_equations as jsim_neq
from lrr_tpu.ops.subsample import multiresolution_masks as jmultires

import lrr_tpu_torch.estimation.icp_classic as ticp
import lrr_tpu_torch.models.affine as taff
import lrr_tpu_torch.ops.geometry as tgeo
import lrr_tpu_torch.ops.knn as tknn
import lrr_tpu_torch.ops.robust as trob
import lrr_tpu_torch.types as ttypes
from lrr_tpu_torch.estimation.lbfgs import lbfgs as tlbfgs
from lrr_tpu_torch.estimation.similarity2d import icp_similarity2d as tsim_icp
from lrr_tpu_torch.models.similarity import Similarity2D as TSim
from lrr_tpu_torch.models.similarity import similarity2d_normal_equations as tsim_neq
from lrr_tpu_torch.ops.subsample import multiresolution_masks as tmultires

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

R2 = np.array([0.0, 1e-3, 0.5, 4.0, 9.0, 15.9, 16.0, 16.1, 100.0, np.inf], np.float32)


def jaffine(rng, center=True) -> jaff.Affine3D:
    A = (np.eye(3) + 0.05 * rng.standard_normal((3, 3))).astype(np.float32)
    t = rng.uniform(-5, 5, 3).astype(np.float32)
    c = rng.uniform(0, 30, 3).astype(np.float32) if center else np.zeros(3, np.float32)
    return jaff.Affine3D(A=jnp.asarray(A), t=jnp.asarray(t), center=jnp.asarray(c))


def icp_case(rng, n=800):
    """test_eval.py::TestIcpClassic's translation case, with 0.1 mm of noise
    on the fixed points: without noise the RMS ends at float32 noise (1e-4)
    and the convergence test (a change below 1e-4) decides on noise."""
    xyz = rng.uniform(0, 40, (n, 3)).astype(np.float32)
    t = np.array([2.0, -1.0, 1.0], np.float32)
    return xyz, (xyz + t + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)


def multires_case(rng):
    """test_eval.py::test_multiresolution (two levels of grid-decimated
    masks), with noise as `icp_case`."""
    xyz = rng.uniform(0, 40, (1000, 3)).astype(np.float32)
    n = len(xyz)
    fs = jtypes.FeatureSet(
        xyz=jnp.asarray(xyz), strength=jnp.ones(n), shape=jnp.zeros(n, jnp.int32),
        projector=jnp.zeros((n, 3, 3)), directions=jnp.zeros((n, 3, 3)), mask=jnp.ones(n, bool))
    t = np.array([1.5, 1.0, -0.5], np.float32)
    return fs, (xyz + t + 0.1 * rng.standard_normal((n, 3))).astype(np.float32)


def sim2d_case(rng, n=1000):
    """A 2-D point set under a known similarity (scale 1.02, 3 degrees,
    t = (1, -0.5)) with 0.05 mm of noise and 5 % outliers in the fixed set.
    The RMS steps at convergence are 5.5e-5 then 1.2e-6 against the 1e-5
    test, so the stop is not decided by rounding (at 8 degrees it is: the
    runs wander for 25-30 iterations and stop a few iterations apart)."""
    mov = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    phi = np.deg2rad(3.0)
    A = 1.02 * np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]])
    fix = mov @ A.T + np.array([1.0, -0.5]) + 0.05 * rng.standard_normal((n, 2))
    fix[: n // 20] = rng.uniform(0, 50, (n // 20, 2))
    return mov, fix.astype(np.float32)


class Recorder:
    """Wraps an nn1 so that each call's indices are kept: under jit through
    `jax.debug.callback`, in the port directly."""

    def __init__(self, fn, jax_side: bool):
        self.fn, self.jax_side, self.idx = fn, jax_side, []

    def __call__(self, *args, **kwargs):
        d2, idx = self.fn(*args, **kwargs)
        if self.jax_side:
            jax.debug.callback(lambda i: self.idx.append(np.asarray(i)), idx)
        else:
            self.idx.append(idx.numpy().copy())
        return d2, idx


def quad(x, xp):
    A = xp.asarray([[3.0, 1.0], [1.0, 2.0]])
    b = xp.asarray([1.0, -2.0])
    return 0.5 * x @ A @ x - b @ x


def rosenbrock(x, xp):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


LBFGS_CASES = {
    "quadratic": (quad, [0.0, 0.0], dict(max_iters=30, improvement_stop=float("inf"))),
    "rosenbrock": (rosenbrock, [-1.0, 1.0], dict(max_iters=50, improvement_stop=float("inf"))),
    "early_stop": (lambda x, xp: xp.sum(x * x), [1.0, 1.0, 1.0],
                   dict(max_iters=50, improvement_stop=0.05)),
}


@pytest.fixture(scope="module")
def ref():
    """Every lrr_tpu run of this file, once."""
    rng = np.random.default_rng(1234)
    out = {}

    # classic ICP, one level and two, recording the matches of each iteration
    mov, fix = icp_case(rng)
    fs, fix2 = multires_case(rng)
    masks = [np.asarray(m) for m in jmultires(fs, (8.0, 0.0))]
    out["icp"] = (mov, fix, None)
    out["icp_multires"] = (np.asarray(fs.xyz), fix2, masks)
    orig = jicp.nn1
    for name in ("icp", "icp_multires"):
        m, f, lv = out[name]
        rec = Recorder(orig, True)
        jicp.nn1 = rec
        try:
            res = jicp.icp_classic(
                jnp.asarray(m), jnp.ones(len(m), bool), jnp.asarray(f), jnp.ones(len(f), bool),
                jaff.Affine3D.identity(),
                level_masks=None if lv is None else [(jnp.asarray(k), jnp.asarray(k)) for k in lv])
            jax.effects_barrier()
        finally:
            jicp.nn1 = orig
        out[name] = (m, f, lv, res, rec.idx)

    mov2, fix2d = sim2d_case(rng)
    out["sim2d"] = (mov2, fix2d, jsim_icp(
        jnp.asarray(mov2), jnp.ones(len(mov2), bool), jnp.asarray(fix2d),
        jnp.ones(len(fix2d), bool), JSim.identity()))

    for name, (fn, x0, kw) in LBFGS_CASES.items():
        out["lbfgs_" + name] = jlbfgs(lambda x: fn(x, jnp), jnp.asarray(x0), **kw)
    return out


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["weight_bt", "rho_bt", "rho_p_bt", "weight_bt_scaled",
                                  "weight_cauchy", "spatial_weight"])
def test_robust_weights_within_one_ulp(name):
    """Op by op against lrr_tpu's.  rho_bt's 1 - x^3 cancels near r2 = 0,
    and lrr_tpu's pow(x, 3.0) is XLA's pow eagerly but x * (x * x) under
    jit (the port's): it is held within 1 ulp of its scale BT_F * 16 / 6."""
    r2 = np.concatenate([R2, np.random.default_rng(0).uniform(0, 20, 200).astype(np.float32)])
    want = np.asarray(getattr(jrob, name)(jnp.asarray(r2)))
    got = getattr(trob, name)(torch.from_numpy(r2)).numpy()
    if name == "rho_bt":
        for ref in (want, np.asarray(jax.jit(jrob.rho_bt)(jnp.asarray(r2)))):
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=np.spacing(np.float32(trob.BT_F * 16 / 6)))
        return
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_gauss_weight_within_one_ulp():
    d = np.random.default_rng(1).standard_normal((50, 3)).astype(np.float32)
    for sigma in (0.5, 2.0):
        want = np.asarray(jrob.gauss_weight(jnp.asarray(d), jnp.float32(sigma)))
        got = trob.gauss_weight(torch.from_numpy(d), sigma).numpy()
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_masked_median_is_the_lower_median_exactly():
    v = np.asarray([5.0, 1.0, 3.0, 100.0, 200.0], np.float32)
    m = np.asarray([True, True, True, False, False])
    assert float(trob.masked_median(torch.from_numpy(v), torch.from_numpy(m))) == 3.0
    rng = np.random.default_rng(2)
    for n, valid in ((400, 400), (400, 257), (400, 0), (7, 6)):
        x = np.abs(rng.standard_normal(n)).astype(np.float32)
        mask = np.arange(n) < valid
        rng.shuffle(mask)
        for fn in ("masked_median", "mad_scale"):
            want = np.asarray(getattr(jrob, fn)(jnp.asarray(x), jnp.asarray(mask)))
            got = getattr(trob, fn)(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
            assert got.tobytes() == want.tobytes(), (fn, n, valid)
    # an even count takes element n // 2, not the mean of the middle pair
    even = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(trob.masked_median(even, torch.ones(4, dtype=torch.bool))) == 3.0


def test_weighted_scale_matches():
    rng = np.random.default_rng(3)
    r2 = rng.uniform(0, 4, 64).astype(np.float32)
    w = rng.uniform(0, 1, 64).astype(np.float32)
    m = rng.uniform(size=64) < 0.8
    want = np.asarray(jrob.weighted_scale(jnp.asarray(r2), jnp.asarray(w), jnp.asarray(m)))
    got = trob.weighted_scale(torch.from_numpy(r2), torch.from_numpy(w), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_affine_helpers_match():
    rng = np.random.default_rng(4)
    ja, jb = jaffine(rng), jaffine(rng)
    ta, tb = tp.torch_affine(ja), tp.torch_affine(jb)
    x = rng.uniform(0, 40, (30, 3)).astype(np.float32)
    assert ta.theta.numpy().tobytes() == np.asarray(ja.theta).tobytes()
    assert ta.homogeneous(torch.from_numpy(x)).numpy().tobytes() == \
        np.asarray(ja.homogeneous(jnp.asarray(x))).tobytes()
    np.testing.assert_array_equal(
        taff.jacobian_wrt_par(ta, torch.from_numpy(x)).numpy(),
        np.asarray(jaff.jacobian_wrt_par(ja, jnp.asarray(x))))
    c = rng.uniform(0, 30, 3).astype(np.float32)
    for got, want in ((ta.with_center(torch.from_numpy(c)), ja.with_center(jnp.asarray(c))),
                      (ta.compose(tb), ja.compose(jb))):
        for f in ("A", "t", "center"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-6, atol=1e-6)
    # with_center keeps the map
    moved = ta.with_center(torch.from_numpy(c))
    np.testing.assert_allclose(moved.apply(torch.from_numpy(x)).numpy(),
                               ta.apply(torch.from_numpy(x)).numpy(), atol=2e-5)


def test_affine_identity_defaults_to_the_card():
    c = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(taff.Affine3D.identity(center=c).center, c)
    if torch.cuda.is_available():
        assert taff.Affine3D.identity().A.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taff.Affine3D.identity()


def test_covariance_terms_and_normal_equations_match():
    rng = np.random.default_rng(5)
    ja = jaffine(rng)
    ta = tp.torch_affine(ja)
    B = rng.standard_normal((12, 12)).astype(np.float32)
    cov = (0.01 * B @ B.T).astype(np.float32)
    x = rng.uniform(0, 40, (200, 3)).astype(np.float32)
    want = np.asarray(jaff.transfer_covariance(ja, jnp.asarray(cov), jnp.asarray(x)))
    got = taff.transfer_covariance(ta, torch.from_numpy(cov), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())

    arm, arf = np.float32(12.5), np.float32(9.0)
    cm, cf = (rng.uniform(0, 30, 3).astype(np.float32) for _ in range(2))
    want = np.asarray(jaff.covariance_normalize(jnp.asarray(cov), arm, arf, jnp.asarray(cm),
                                                jnp.asarray(cf)))
    got = taff.covariance_normalize(torch.from_numpy(cov), torch.tensor(arm), torch.tensor(arf),
                                    torch.from_numpy(cm), torch.from_numpy(cf)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())

    to = rng.uniform(0, 40, (200, 3)).astype(np.float32)
    P = rng.standard_normal((200, 3, 3)).astype(np.float32)
    P = P @ P.transpose(0, 2, 1)
    w = rng.uniform(0, 1, 200).astype(np.float32)
    jAtA, jAtb = jaff.normal_equations_terms(ja, jnp.asarray(x), jnp.asarray(to), jnp.asarray(P),
                                             jnp.asarray(w))
    tAtA, tAtb = taff.normal_equations_terms(ta, *(torch.from_numpy(a) for a in (x, to, P, w)))
    for got, want in ((tAtA, jAtA), (tAtb, jAtb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_match_set_and_feature_set_from_numpy():
    rng = np.random.default_rng(6)
    n, cap = 5, 8
    arrays = (rng.standard_normal((n, 3)), rng.uniform(0, 1, n), np.arange(n) % 3,
              rng.standard_normal((n, 3, 3)), rng.standard_normal((n, 3, 3)))
    want = jtypes.feature_set_from_numpy(*arrays, capacity=cap)
    got = ttypes.feature_set_from_numpy(*arrays, capacity=cap, device="cpu")
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    np.testing.assert_array_equal(ttypes.pad_to(np.ones((2, 3)), 4, axis=0, fill=-1),
                                  jtypes.pad_to(np.ones((2, 3)), 4, axis=0, fill=-1))
    with pytest.raises(ValueError):
        ttypes.pad_to(np.ones(3), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttypes.feature_set_from_numpy(*arrays)
    assert [f.name for f in dataclasses.fields(ttypes.MatchSet)] == \
        list(jtypes.MatchSet.__dataclass_fields__)


def test_geometry_matches():
    rng = np.random.default_rng(7)
    a = rng.uniform(-180, 180, (70, 3)).astype(np.float32)
    b = rng.uniform(-180, 180, (50, 3)).astype(np.float32)
    m = rng.uniform(size=70) < 0.7
    ta_, tm = torch.from_numpy(a), torch.from_numpy(m)
    np.testing.assert_array_max_ulp(
        tgeo.pairwise_sq_dists(ta_, torch.from_numpy(b)).numpy(),
        np.asarray(jgeo.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b))), maxulp=1)
    # the means and the radius are sums in another order: 1e-6 of their terms
    scale = np.abs(a).max()
    np.testing.assert_allclose(tgeo.masked_mean(ta_, tm).numpy(),
                               np.asarray(jgeo.masked_mean(jnp.asarray(a), jnp.asarray(m))),
                               rtol=0, atol=1e-6 * scale)
    tc, tr = tgeo.center_and_radius(ta_, tm)
    jc, jr = jgeo.center_and_radius(jnp.asarray(a), jnp.asarray(m))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6 * scale)
    tc, tr = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(jr))
    n = tgeo.normalize_points(ta_, tc, tr)
    np.testing.assert_array_max_ulp(n.numpy(), np.asarray(jgeo.normalize_points(
        jnp.asarray(a), jc, jr)), maxulp=1)
    np.testing.assert_allclose(tgeo.unnormalize_points(n, tc, tr).numpy(), a, atol=1e-4)


# ---------------------------------------------------------------------------
# the chunked spatial k-NN and the radius count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [7, 1024])
def test_chunked_nn1_and_knn_equal_lrr_tpu(chunk):
    rng = np.random.default_rng(8)
    pts = rng.integers(0, 6, (400, 3)).astype(np.float32)  # a lattice: many exact ties
    q = rng.integers(0, 6, (100, 3)).astype(np.float32) + 0.5 * (rng.uniform(size=(100, 3)) < 0.5)
    mask = rng.uniform(size=400) < 0.8
    jd, ji = jknn.nn1(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(mask), query_chunk=chunk)
    td, ti = tknn.nn1(torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(mask),
                      query_chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ti.dtype == torch.int32
    jd5, ji5 = jknn.knn(jnp.asarray(q), jnp.asarray(pts), jnp.asarray(mask), 5, query_chunk=chunk)
    td5, ti5 = tknn.knn(torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(mask), 5,
                        query_chunk=chunk)
    np.testing.assert_array_equal(ti5.numpy(), np.asarray(ji5))
    np.testing.assert_array_equal(td5.numpy(), np.asarray(jd5))


def test_radius_count_equals_lrr_tpu():
    """test_matching.py::test_radius_count's case, and a masked 5-d one."""
    rng = np.random.default_rng(1234)
    pts = rng.uniform(0, 10, (500, 3)).astype(np.float32)
    q = rng.uniform(0, 10, (20, 3)).astype(np.float32)
    got = tknn.radius_count(torch.from_numpy(q), torch.from_numpy(pts), torch.ones(500, dtype=bool),
                            2.0, query_chunk=4)
    want = np.asarray(jknn.radius_count(jnp.asarray(q), jnp.asarray(pts), jnp.ones(500, bool), 2.0,
                                        query_chunk=4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (((q[:, None] - pts[None]) ** 2).sum(-1) <= 4.0).sum(1))
    p5 = rng.uniform(0, 4, (300, 5)).astype(np.float32)
    q5 = rng.uniform(0, 4, (30, 5)).astype(np.float32)
    m5 = rng.uniform(size=300) < 0.6
    got = tknn.radius_count(torch.from_numpy(q5), torch.from_numpy(p5), torch.from_numpy(m5), 1.5)
    want = jknn.radius_count(jnp.asarray(q5), jnp.asarray(p5), jnp.asarray(m5), 1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------


def assert_params_close(got: torch.Tensor, want, rel: float):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", ["icp", "icp_multires"])
def test_icp_classic_matches_each_iteration(ref, name, monkeypatch):
    mov, fix, levels, want, want_idx = ref[name]
    rec = Recorder(ticp.nn1, False)
    monkeypatch.setattr(ticp, "nn1", rec)
    ones = torch.ones(len(mov), dtype=torch.bool)
    got = ticp.icp_classic(
        torch.from_numpy(mov), ones, torch.from_numpy(fix), torch.ones(len(fix), dtype=torch.bool),
        taff.Affine3D.identity(device="cpu"),
        level_masks=None if levels is None else [(torch.from_numpy(k),) * 2 for k in levels])
    assert got.iterations == int(want.iterations) == len(want_idx) == len(rec.idx)
    assert got.converged == bool(want.converged)
    for it, (a, b) in enumerate(zip(rec.idx, want_idx)):
        np.testing.assert_array_equal(a, b, err_msg=f"iteration {it}")
    # 1e-3 of the largest |parameter|, not 1e-5: lrr_tpu's normal equations
    # are uncentred (coordinates up to 40 mm), and on this input both float32
    # runs lie 1.1e-4 to 2.7e-4 from a float64 run of the same iterations,
    # so summation order alone moves the solve by 3e-4
    assert_params_close(got.trans.theta, want.trans.theta, 1e-3)
    np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=1e-4)
    assert_params_close(got.covar, want.covar, 1e-3)
    err = np.abs(got.trans.apply(torch.zeros(1, 3)).numpy()[0] - (fix[0] - mov[0]))
    assert err.max() < 0.2


def test_similarity2d_model_matches():
    rng = np.random.default_rng(9)
    th = np.array([1.02, 0.1, 3.0, -2.0], np.float32)
    c = np.array([5.0, -4.0], np.float32)
    js, ts = JSim.from_theta(jnp.asarray(th), jnp.asarray(c)), TSim.from_theta(
        torch.from_numpy(th), torch.from_numpy(c))
    x = rng.uniform(-20, 20, (40, 2)).astype(np.float32)
    # lrr_tpu maps by a matmul, which fuses one product into the other's
    # sum: within 2 ulp of the largest coordinate
    np.testing.assert_allclose(ts.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(js.apply(jnp.asarray(x))), rtol=0,
                               atol=2 * np.spacing(np.float32(40.0)))
    for f in ("scale", "angle", "A", "theta"):
        np.testing.assert_array_max_ulp(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                        maxulp=1)
    ji, ti = js.inverse(), ts.inverse()
    for f in ("a", "b", "t", "center"):
        np.testing.assert_allclose(getattr(ti, f).numpy(), np.asarray(getattr(ji, f)), rtol=1e-6,
                                   atol=1e-6)
    to = rng.uniform(-20, 20, (40, 2)).astype(np.float32)
    w = rng.uniform(0, 1, 40).astype(np.float32)
    jA, jb = jsim_neq(jnp.asarray(x), jnp.asarray(to), jnp.asarray(w), jnp.asarray(c))
    tA, tb = tsim_neq(torch.from_numpy(x), torch.from_numpy(to), torch.from_numpy(w),
                      torch.from_numpy(c))
    assert_params_close(tA, jA, 1e-6)
    assert_params_close(tb, jb, 1e-6)


def test_icp_similarity2d_matches(ref):
    """Equal iterations and stop; parameters within 1e-3 of the largest:
    the 4 x 4 system is uncentred too, and both float32 runs lie 3.4e-4 and
    4.1e-4 from a float64 run on this input."""
    mov, fix, want = ref["sim2d"]
    got = tsim_icp(torch.from_numpy(mov), torch.ones(len(mov), dtype=torch.bool),
                   torch.from_numpy(fix), torch.ones(len(fix), dtype=torch.bool),
                   TSim.identity(device="cpu"))
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert_params_close(got.trans.theta, want.trans.theta, 1e-3)
    np.testing.assert_allclose(float(got.rms), float(want.rms), rtol=1e-3)
    assert abs(float(got.trans.scale) - 1.02) < 0.002
    assert abs(np.rad2deg(float(got.trans.angle)) - 3.0) < 0.05


@pytest.mark.parametrize("name", list(LBFGS_CASES))
def test_lbfgs_matches(ref, name):
    fn, x0, kw = LBFGS_CASES[name]
    want = ref["lbfgs_" + name]
    got = tlbfgs(lambda x: fn(x, torch), torch.tensor(x0), **kw)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-5 * max(np.abs(np.asarray(want.x)).max(), 1.0))
    np.testing.assert_allclose(float(got.f), float(want.f), rtol=1e-5, atol=1e-7)
    if name == "quadratic":
        np.testing.assert_allclose(got.x.numpy(), np.linalg.solve([[3.0, 1.0], [1.0, 2.0]],
                                                                  [1.0, -2.0]), atol=1e-3)
    if name == "early_stop":  # stopped early, with more than 5 % gained
        assert float(got.f) < 0.95 * 3.0 and got.converged

"""EM-CDC and `cli estimate` in the PyTorch port against lrr_tpu on the same
inputs (the cases of tests/test_cdc.py: uniform points in a 30 mm cube with
isotropic feature covariances, a translated copy as the fixed set).  Every
lrr_tpu run of the file is made once, in a module fixture.

Tolerances, by what can be held:
  * compute_weights: the candidate sets equal, except proven ties (the two
    candidates' distances within 4 ulp), the weights within 1e-5 relative;
  * the objective's value and autograd gradient against jax.value_and_grad
    at fixed points within 1e-5 relative (H6);
  * one EM step from lrr_tpu's state (matching, parameter step, covariance
    step) within 1e-4 relative, except a step that L-BFGS takes or refuses
    on a change of the objective within float32 rounding: there the
    objective is flat, and the two packages' steps end at points whose
    objectives agree to 1e-6 relative;
  * a whole run: equal iterations and `converged`; parameters within 5e-3
    of the largest |parameter| (the target, 1e-3, is missed by the flat
    steps above: the first one is at iteration 9 of the plain variant,
    where lrr_tpu refuses every trial and the port accepts one that lowers
    the objective by 7e-8 relative, which moves the parameters by 1.5e-3);
  * `cli estimate`: the printed lines and `--output` files with lrr_tpu's
    text and integers, their numbers within the estimator's tolerance (the
    `.6g` digits show the float32 error of lrr_tpu's own solves)."""

from __future__ import annotations

import os
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.cli as jcli
import lrr_tpu.estimation.cdc as jcdc
import lrr_tpu.models.affine as jaff

import lrr_tpu_torch.cli as tcli
import lrr_tpu_torch.estimation.cdc as tcdc
import lrr_tpu_torch.models.affine as taff
from lrr_tpu_torch.estimation.lbfgs import value_and_grad

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

VARIANTS = {
    "cdc": dict(),
    "transfer": dict(use_transfer=True),
    "symmetric": dict(symmetric=True),
    "symmetric_transfer": dict(use_transfer=True, symmetric=True),
}


def cov_points(rng, n, iso=0.5):
    """test_cdc.py::make_cov_features as numpy (xyz, cov)."""
    xyz = rng.uniform(0, 30, (n, 3)).astype(np.float32)
    return xyz, np.broadcast_to(iso * np.eye(3, dtype=np.float32), (n, 3, 3)).copy()


def pair(xyz, cov, t):
    """(moving, fixed) CovFeatures of both packages: fixed = moving + t."""
    fix = (xyz + np.asarray(t, np.float32)).astype(np.float32)
    n = len(xyz)
    j = [jcdc.CovFeatures(jnp.asarray(x), jnp.asarray(cov), jnp.ones(n, bool)) for x in (xyz, fix)]
    return j, [tp.torch_cov_features(f) for f in j]


def run_case(name: str):
    """test_cdc.py::TestRunCdc's cases: (points, cov, t, init t, iterations)."""
    rng = np.random.default_rng({"cdc": 1, "transfer": 2, "symmetric": 3,
                                 "symmetric_transfer": 4}[name])
    n = 250 if name == "cdc" else 200
    xyz, cov = cov_points(rng, n, iso=0.3)
    t = {"cdc": [1.5, -1.0, 0.8], "transfer": [1.0, 0.5, -0.5], "symmetric": [1.2, -0.7, 0.4],
         "symmetric_transfer": [0.8, 0.9, -0.6]}[name]
    t0 = [0.3, 0.2, -0.2] if name == "cdc" else [0.0, 0.0, 0.0]
    return xyz, cov, np.asarray(t, np.float32), np.asarray(t0, np.float32), 12 if name == "cdc" else 10


def jinit(t0):
    return jaff.Affine3D(A=jnp.eye(3), t=jnp.asarray(t0), center=jnp.zeros(3))


def write_points(path, pts):
    np.savetxt(path, pts, fmt="%.9g")


def cli_cases(tmp):
    """Point files for `estimate`: 3-d (test_cdc's generation, 200 points,
    translated) and 2-d (1,000 points under a similarity, 5 % outliers)."""
    rng = np.random.default_rng(11)
    xyz, _ = cov_points(rng, 200)
    write_points(os.path.join(tmp, "m3.txt"), xyz)
    write_points(os.path.join(tmp, "f3.txt"), xyz + np.array([1.2, -0.8, 0.5]))
    mov = rng.uniform(0, 50, (1000, 2)).astype(np.float32)
    phi = np.deg2rad(3.0)
    A = 1.02 * np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]])
    fix = mov @ A.T + np.array([1.0, -0.5]) + 0.05 * rng.standard_normal((1000, 2))
    fix[:50] = rng.uniform(0, 50, (50, 2))
    write_points(os.path.join(tmp, "m2.txt"), mov)
    write_points(os.path.join(tmp, "f2.txt"), fix.astype(np.float32))


CLI_RUNS = {
    "icp": ["m3.txt", "f3.txt", "--method", "icp"],
    "cdc_symmetric": ["m3.txt", "f3.txt", "--method", "cdc-symmetric", "--iterations", "7"],
    "similarity2d": ["m2.txt", "f2.txt", "--model", "similarity2d"],
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every lrr_tpu run of this file, once."""
    out = {}
    for name, kw in VARIANTS.items():
        xyz, cov, t, t0, iters = run_case(name)
        (jm, jf), _ = pair(xyz, cov, t)
        out["run_" + name] = jcdc.run_cdc(jm, jf, jinit(t0), max_iterations=iters,
                                          max_candidates=16, **kw)

    tmp = str(tmp_path_factory.mktemp("estimate"))
    cli_cases(tmp)
    for name, argv in CLI_RUNS.items():
        outp = os.path.join(tmp, f"{name}_jax.txt")
        printed = capture(lambda: jcli.main(
            ["estimate"] + [os.path.join(tmp, a) if a.endswith(".txt") else a for a in argv]
            + ["--output", outp]))
        out["cli_" + name] = (tmp, printed, outp)
    return out


def capture(fn) -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


# ---------------------------------------------------------------------------
# compute_weights
# ---------------------------------------------------------------------------


def assert_matches_equal_or_tie(got, want, mapped, fixed_xyz):
    """Equal candidate sets and masks, except where the two candidates tie
    within 4 ulp of the float32 distance; weights within 1e-5 relative."""
    gt, wt = got.to_xyz.numpy(), np.asarray(want.to_xyz)
    differ = np.argwhere((gt != wt).any(-1))
    for n, k in differ:
        q = mapped[n].astype(np.float64)
        da = ((q - gt[n, k]) ** 2).sum()
        db = ((q - wt[n, k]) ** 2).sum()
        assert abs(da - db) <= 4 * np.spacing(np.float32(max(da, db))), (n, k, da, db)
    rows = np.ones(len(gt), bool)
    rows[differ[:, 0]] = False
    np.testing.assert_array_equal(got.mask.numpy()[rows], np.asarray(want.mask)[rows])
    w, ww = got.weight.numpy()[rows], np.asarray(want.weight)[rows]
    np.testing.assert_allclose(w, ww, rtol=1e-5, atol=1e-5 * np.abs(ww).max())
    return len(differ)


@pytest.mark.parametrize("case", ["within_radius", "small_covar", "large_covar", "transfer"])
def test_compute_weights_matches(case):
    """test_cdc.py::TestComputeWeights's cases, and one with a transfer
    covariance and a transform that is not the identity."""
    rng = np.random.default_rng(1234)
    if case == "within_radius":
        xyz, cov = cov_points(rng, 100)
        fix = xyz + np.float32([0.5, 0.0, 0.0])
        covar, k, tr, transfer = 1e-2 * np.eye(12, dtype=np.float32), 16, None, None
    else:
        xyz, cov = cov_points(rng, 50)
        fix, _ = cov_points(rng, 50)
        covar = {"small_covar": 1e-6, "large_covar": 1e-1, "transfer": 1e-2}[case] * np.eye(
            12, dtype=np.float32)
        k, tr, transfer = 32, None, None
        if case == "transfer":
            tr = jaff.Affine3D(A=jnp.asarray(np.eye(3, dtype=np.float32) * 1.02),
                               t=jnp.asarray([0.4, -0.3, 0.2]), center=jnp.asarray([15.0] * 3))
            transfer = np.float32(0.3) * np.eye(3, dtype=np.float32)
    n, nf = len(xyz), len(fix)
    jm = jcdc.CovFeatures(jnp.asarray(xyz), jnp.asarray(cov), jnp.ones(n, bool))
    jf = jcdc.CovFeatures(jnp.asarray(fix.astype(np.float32)), jnp.asarray(cov[:nf]),
                          jnp.ones(nf, bool))
    tr = tr if tr is not None else jaff.Affine3D.identity()
    want = jax.jit(partial(jcdc.compute_weights, max_candidates=k))(
        tr, jnp.asarray(covar), jm, jf, transfer=None if transfer is None else jnp.asarray(transfer))
    got = tcdc.compute_weights(tp.torch_affine(tr), torch.from_numpy(covar),
                               tp.torch_cov_features(jm), tp.torch_cov_features(jf), k,
                               None if transfer is None else torch.from_numpy(transfer))
    mapped = np.asarray(tr.apply(jnp.asarray(xyz)))
    ties = assert_matches_equal_or_tie(got, want, mapped, fix)
    assert ties <= 2
    assert int(got.mask.sum()) > 0


def test_column_sums_are_fixed_order_sums():
    """The scatter-add of lrr_tpu (`.at[idx].add`) as sorted segments: the
    same table, and every run gives the same bits."""
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 40, (60, 16)))
    w = torch.from_numpy(rng.uniform(0, 1, (60, 16)).astype(np.float32))
    want = np.asarray(jnp.zeros(40).at[jnp.asarray(idx.numpy()).reshape(-1)].add(
        jnp.asarray(w.numpy()).reshape(-1)))
    got = tcdc._column_sums(idx, w, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert torch.equal(got, tcdc._column_sums(idx, w, 40))
    assert torch.equal(tcdc._column_sums(idx[:0], w[:0], 5), torch.zeros(5))


# ---------------------------------------------------------------------------
# the objective and the Cholesky parameterisation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def objective_case():
    """lrr_tpu's normalised matches at the start of the plain case, and a
    parameter point off the optimum."""
    xyz, cov, t, t0, _ = run_case("cdc")
    (jm, jf), _ = pair(xyz, cov, t)
    tr = jinit(t0)
    covar = 1e-2 * jnp.eye(12)
    m = jax.jit(partial(jcdc.compute_weights, max_candidates=16))(tr, covar, jm, jf)
    cm, rm, cf, rf = jcdc._normalization(m)
    mn = jcdc._normalize_matches(m, cm, rm, cf, rf)
    theta = tr.normalize(rm, rf, cm, cf).theta
    cn = jaff.covariance_normalize(covar, rm, rf, cm, cf)
    return mn, theta + 0.01 * jnp.arange(12, dtype=jnp.float32) / 12, cn, rf


@pytest.mark.parametrize("what", ["theta", "theta_transfer", "chol12", "chol3", "symmetric"])
def test_objective_value_and_gradient_match(objective_case, what):
    mn, theta, cn, rf = objective_case
    tm = tp.torch_cdc_matches(mn)
    z3, tz3 = jnp.zeros(3), torch.zeros(3)
    tr_n = jnp.eye(3, dtype=jnp.float32) * 0.1 / (rf * rf)
    if what in ("theta", "theta_transfer"):
        tr = None if what == "theta" else tr_n
        jfun = lambda th: jcdc._objective_terms(th, cn, mn, tr, z3)  # noqa: E731
        tfun = lambda th: tcdc._objective_terms(  # noqa: E731
            th, tp.t_(cn), tm, None if tr is None else tp.t_(tr), tz3)
        x = theta
    elif what == "symmetric":
        def jfun(th):
            inv = jaff.Affine3D.from_theta(th, z3).inverse()
            return (jcdc._objective_terms(th, cn, mn, None, z3)
                    + jcdc._objective_terms(inv.theta, cn, mn, None, z3))

        def tfun(th):
            inv = taff.Affine3D.from_theta(th, tz3).inverse()
            return (tcdc._objective_terms(th, tp.t_(cn), tm, None, tz3)
                    + tcdc._objective_terms(inv.theta, tp.t_(cn), tm, None, tz3))
        x = theta
    else:
        dof = 12 if what == "chol12" else 3
        x = jcdc._chol_pack(cn if dof == 12 else tr_n, dof) * 1.1
        if dof == 12:
            jfun = lambda v: jcdc._objective_terms(theta, jcdc._chol_unpack(v, 12), mn, None, z3)  # noqa: E731
            tfun = lambda v: tcdc._objective_terms(  # noqa: E731
                tp.t_(theta), tcdc._chol_unpack(v, 12), tm, None, tz3)
        else:
            jfun = lambda v: jcdc._objective_terms(theta, cn, mn, jcdc._chol_unpack(v, 3), z3)  # noqa: E731
            tfun = lambda v: tcdc._objective_terms(  # noqa: E731
                tp.t_(theta), tp.t_(cn), tm, tcdc._chol_unpack(v, 3), tz3)
    jv, jg = jax.jit(jax.value_and_grad(jfun))(x)
    tv, tg = value_and_grad(tfun, tp.t_(x))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_cholesky_pack_round_trip_and_the_non_pd_case():
    rng = np.random.default_rng(1234)
    A = rng.standard_normal((12, 12)).astype(np.float32)
    cov = A @ A.T + 0.1 * np.eye(12, dtype=np.float32)
    want = np.asarray(jcdc._chol_pack(jnp.asarray(cov), 12))
    got = tcdc._chol_pack(torch.from_numpy(cov), 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tcdc._chol_unpack(got, 12).numpy(), cov, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tcdc._chol_unpack(got, 12).numpy(),
                               np.asarray(jcdc._chol_unpack(jnp.asarray(want), 12)),
                               rtol=1e-5, atol=1e-5 * np.abs(cov).max())
    # H7: a matrix that is not positive definite packs the identity in both
    for bad in (-np.eye(3, dtype=np.float32), np.diag([1.0, -2.0, 3.0]).astype(np.float32),
                np.full((3, 3), np.nan, np.float32)):
        want = np.asarray(jcdc._chol_pack(jnp.asarray(bad), 3))
        got = tcdc._chol_pack(torch.from_numpy(bad), 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), [1, 0, 0, 1, 0, 1])


# ---------------------------------------------------------------------------
# EM steps and whole runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cdc", "symmetric_transfer"])
def test_em_steps_from_lrr_tpus_state_agree(name):
    """Each piece of run_cdc's loop from lrr_tpu's own state, so that what
    one step does is held apart from how steps compound."""
    kw = VARIANTS[name]
    xyz, cov, t, t0, iters = run_case(name)
    (jm, jf), (tm, tf) = pair(xyz, cov, t)
    match_fn = jax.jit(partial(jcdc.compute_weights, max_candidates=16))
    par_fn = jax.jit(partial(jcdc.estimate_parameters, symmetric=kw.get("symmetric", False)))
    cov_fn = jax.jit(jcdc.estimate_covariance)
    trans = jinit(t0)
    covar = 1e-2 * jnp.eye(12, dtype=jnp.float32)
    transfer = 1e-1 * jnp.eye(3, dtype=jnp.float32) if kw.get("use_transfer") else None

    def tt(x):
        return None if x is None else tp.t_(x)

    def rel(got, want):
        want = np.asarray(want)
        return float(np.abs(got.numpy() - want).max() / np.abs(want).max())

    flat_steps = 0
    for it in range(iters):
        m = match_fn(trans, covar, jm, jf, transfer=transfer)
        tmm = tcdc.compute_weights(tp.torch_affine(trans), tt(covar), tm, tf, 16, tt(transfer))
        assert rel(tmm.weight, m.weight) < 1e-4, it
        if it > jcdc.START_EM:
            m_bwd = None
            if kw.get("symmetric"):
                m_bwd = match_fn(trans.inverse(), covar, jf, jm, transfer=transfer)
            new, _ = par_fn(trans, covar, m, transfer, m_bwd=m_bwd)
            tnew, _ = tcdc.estimate_parameters(
                tp.torch_affine(trans), tt(covar), tp.torch_cdc_matches(m), tt(transfer),
                kw.get("symmetric", False),
                None if m_bwd is None else tp.torch_cdc_matches(m_bwd))
            if rel(tnew.theta, new.theta) >= 1e-4:
                # a flat step: the objective at the two end points agrees
                # to float32 rounding
                f_j = objective_at(new, covar, m, transfer)
                f_t = objective_at(tnew, covar, m, transfer)
                assert abs(f_t - f_j) <= 1e-6 * abs(f_j), (it, f_t, f_j)
                flat_steps += 1
            trans = new
            m = match_fn(trans, covar, jm, jf, transfer=transfer)
        covar2, transfer2, _ = cov_fn(trans, covar, m, transfer)
        tcov, ttransfer, _ = tcdc.estimate_covariance(
            tp.torch_affine(trans), tt(covar), tp.torch_cdc_matches(m), tt(transfer))
        if rel(tcov, covar2) >= 1e-4 or (
                transfer is not None and rel(ttransfer, transfer2) >= 1e-4):
            f_j = objective_at(trans, covar2, m, transfer2)
            f_t = objective_at(trans, tcov, m, ttransfer)
            assert abs(f_t - f_j) <= 1e-6 * abs(f_j), (it, f_t, f_j)
            flat_steps += 1
        covar, transfer = covar2, transfer2
    assert flat_steps <= iters // 2


def objective_at(trans, covar, m, transfer) -> float:
    """The port's normalised objective of `trans` on lrr_tpu's matches."""
    tm = tp.torch_cdc_matches(m)
    cm, rm, cf, rf = tcdc._normalization(tm)
    mn = tcdc._normalize_matches(tm, cm, rm, cf, rf)
    tr = trans if isinstance(trans, taff.Affine3D) else tp.torch_affine(trans)
    theta = tr.normalize(rm, rf, cm, cf).theta
    cov = covar if isinstance(covar, torch.Tensor) else tp.t_(covar)
    cn = taff.covariance_normalize(cov, rm, rf, cm, cf)
    if transfer is not None and not isinstance(transfer, torch.Tensor):
        transfer = tp.t_(transfer)
    trn = None if transfer is None else transfer / (rf * rf)
    return float(tcdc._objective_terms(theta, cn, mn, trn, torch.zeros(3)))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_run_cdc_matches(ref, name):
    xyz, cov, t, t0, iters = run_case(name)
    _, (tm, tf) = pair(xyz, cov, t)
    want = ref["run_" + name]
    got = tcdc.run_cdc(tm, tf, tp.torch_affine(jinit(t0)), max_iterations=iters,
                       max_candidates=16, **VARIANTS[name])
    assert got.iteration == int(want.iteration)
    assert got.converged == bool(want.converged)
    w = np.asarray(want.trans.theta)
    np.testing.assert_allclose(got.trans.theta.numpy(), w, rtol=0, atol=5e-3 * np.abs(w).max())
    assert (got.transfer is None) == (want.transfer is None)
    # and the translation is found, as test_cdc.py holds lrr_tpu to it
    np.testing.assert_allclose(got.trans.apply(torch.zeros(1, 3)).numpy()[0], t, atol=0.4)


# ---------------------------------------------------------------------------
# cli estimate
# ---------------------------------------------------------------------------


NUM = re.compile(r"-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?|-?inf|nan")
# each estimator's parity tolerance, as a share of the largest |parameter|
# (test_torch_estimate.py for ICP and the 2-D similarity, this file for CDC)
CLI_TOL = {"icp": 1e-3, "cdc_symmetric": 5e-3, "similarity2d": 1e-3}


def assert_same_lines(got: str, want: str, scale: float, tol: float):
    """Equal text and iteration count; every other number equal as printed
    or within tol * scale."""
    assert NUM.sub("#", got) == NUM.sub("#", want), (got, want)
    assert re.findall(r"iterations=(\d+)", got) == re.findall(r"iterations=(\d+)", want)
    for a, b in zip(NUM.findall(got), NUM.findall(want)):
        assert a == b or abs(float(a) - float(b)) <= tol * scale, (a, b, got, want)


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_estimate_prints_lrr_tpus_lines(ref, name):
    """The port's `estimate` prints lrr_tpu's three lines (`.6g` numbers)
    and writes its `--output` row, up to the estimator's parity tolerance:
    on these inputs the numbers differ from the fifth significant digit on
    (ICP 4e-5 on 1.2, the similarity 2.3e-4 on 1.0), which is the float32
    error of lrr_tpu's own solves."""
    tmp, want_printed, want_out = ref["cli_" + name]
    out = os.path.join(tmp, f"{name}_torch.txt")
    argv = ["estimate"] + [os.path.join(tmp, a) if a.endswith(".txt") else a
                           for a in CLI_RUNS[name]] + ["--output", out, "--device", "cpu"]
    printed = capture(lambda: tcli.main(argv))
    want_p, got_p = np.loadtxt(want_out), np.loadtxt(out)
    scale = np.abs(want_p).max()
    assert len(printed.splitlines()) == len(want_printed.splitlines()) == 3
    for a, b in zip(printed.splitlines(), want_printed.splitlines()):
        assert_same_lines(a, b, scale, CLI_TOL[name])
    assert got_p.shape == want_p.shape == ((6,) if name == "similarity2d" else (12,))
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=CLI_TOL[name] * scale)


def test_cli_estimate_takes_the_card_by_default(tmp_path):
    cli_cases(str(tmp_path))
    argv = ["estimate", str(tmp_path / "m3.txt"), str(tmp_path / "f3.txt")]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


def test_cli_estimate_flags_and_defaults_are_lrr_tpus():
    args = tcli.build_parser().parse_args(["estimate", "m.txt", "f.txt"])
    assert (args.method, args.model, args.iterations, args.feature_cov, args.output,
            args.device) == ("icp", "affine3d", 30, 0.5, None, None)
    sub = next(a for a in tcli.build_parser()._actions if a.dest == "cmd").choices["estimate"]
    methods = next(a for a in sub._actions if a.dest == "method").choices
    assert list(methods) == ["icp", "cdc", "cdc-transfer", "cdc-symmetric",
                             "cdc-symmetric-transfer"]

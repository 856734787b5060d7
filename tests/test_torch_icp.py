"""Parity of the port's ICP, its ops and the measurements with lrr_tpu.

Inputs are numpy arrays (from a seed, or the committed small pair context)
fed to both packages; the ICP runs take their random draws from a plan
built by walking lrr_tpu's own key tree (tests/torch_parity.py).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lrr_tpu.estimation import icp as jicp
from lrr_tpu.estimation import measurements as jmeas
from lrr_tpu.models.affine import Affine3D as JAffine
from lrr_tpu.models.affine import covariance_unnormalize as j_cov_unnormalize
from lrr_tpu.ops import robust as jrobust
from lrr_tpu.ops.eig3 import eigvalsh3 as j_eigvalsh3
from lrr_tpu.ops.voronoi import lookup as jlookup
from lrr_tpu.verify import load_default_verifier as jload_svm
from lrr_tpu.verify import predict_probability as jprob
from lrr_tpu.verify import scale_measurements as jscale
from lrr_tpu_torch.estimation import icp as ticp
from lrr_tpu_torch.estimation import measurements as tmeas
from lrr_tpu_torch.models.affine import Affine3D as TAffine
from lrr_tpu_torch.models.affine import covariance_unnormalize as t_cov_unnormalize
from lrr_tpu_torch.models.affine import pinv_hermitian
from lrr_tpu_torch.ops import robust as trobust
from lrr_tpu_torch.ops.eig3 import eigvalsh3 as t_eigvalsh3
from lrr_tpu_torch.ops.voronoi import lookup as tlookup
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm
from lrr_tpu_torch.verify.svm import predict_probability as tprob
from lrr_tpu_torch.verify.svm import scale_measurements as tscale

KEY = jax.random.key(3)


def _rand_affines(rng, n):
    A = np.eye(3) + 0.1 * rng.standard_normal((n, 3, 3))
    t = rng.uniform(-20, 20, (n, 3))
    c = rng.uniform(0, 40, (n, 3))
    return [x.astype(np.float32) for x in (A, t, c)]


def test_affine_ops_match():
    rng = np.random.default_rng(0)
    A, t, c = _rand_affines(rng, 6)
    x = rng.uniform(0, 40, (6, 5, 3)).astype(np.float32)
    tt = TAffine(torch.from_numpy(A), torch.from_numpy(t), torch.from_numpy(c))
    rm, rf = rng.uniform(5, 15, 6).astype(np.float32), rng.uniform(5, 15, 6).astype(np.float32)
    cm, cf = rng.uniform(0, 40, (6, 3)).astype(np.float32), rng.uniform(0, 40, (6, 3)).astype(np.float32)
    cov = rng.standard_normal((6, 12, 12)).astype(np.float32)
    for i in range(6):
        jt = JAffine(A=jnp.asarray(A[i]), t=jnp.asarray(t[i]), center=jnp.asarray(c[i]))
        np.testing.assert_allclose(tt[i].apply(torch.from_numpy(x[i])).numpy(),
                                   np.asarray(jt.apply(jnp.asarray(x[i]))), rtol=1e-6, atol=1e-5)
        ji, ti = jt.inverse(), tt.inverse()
        np.testing.assert_allclose(ti.A[i].numpy(), np.asarray(ji.A), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ti.t[i].numpy(), np.asarray(ji.t), rtol=1e-5, atol=1e-4)
        jn = jt.normalize(rm[i], rf[i], jnp.asarray(cm[i]), jnp.asarray(cf[i]))
        tn = tt.normalize(*(torch.from_numpy(v) for v in (rm, rf, cm, cf)))
        np.testing.assert_allclose(tn.t[i].numpy(), np.asarray(jn.t), rtol=1e-5, atol=1e-5)
        ju = jn.unnormalize(rm[i], rf[i], jnp.asarray(cm[i]), jnp.asarray(cf[i]))
        tu = tn.unnormalize(*(torch.from_numpy(v) for v in (rm, rf, cm, cf)))
        np.testing.assert_allclose(tu.t[i].numpy(), np.asarray(ju.t), rtol=1e-5, atol=1e-4)
        assert bool(tt.is_valid()[i]) == bool(jt.is_valid())
        np.testing.assert_allclose(
            t_cov_unnormalize(*(torch.from_numpy(v) for v in (cov, rm, rf, cm, cf)))[i].numpy(),
            np.asarray(j_cov_unnormalize(jnp.asarray(cov[i]), rm[i], rf[i],
                                         jnp.asarray(cm[i]), jnp.asarray(cf[i]))),
            rtol=1e-4, atol=1e-3,
        )
    squash = TAffine(torch.diag(torch.tensor([0.05, 1.0, 1.0]))[None], torch.zeros(1, 3), torch.zeros(1, 3))
    assert not bool(squash.is_valid()[0])


def test_pinv_cutoff_matches_jax():
    """H5: jnp.linalg.pinv(hermitian=True) cuts at 10 * max(M, N) * eps."""
    rng = np.random.default_rng(1)
    U = np.linalg.qr(rng.standard_normal((12, 12)))[0]
    s = np.logspace(0, -9, 12)  # the tail sits between torch's and JAX's cutoffs
    a = (U * s) @ U.T
    a = ((a + a.T) / 2).astype(np.float32)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(a), hermitian=True))
    got = pinv_hermitian(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_eigvalsh3_matches():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((50, 3, 3)).astype(np.float32)
    s = m + np.swapaxes(m, 1, 2)
    s[:5] = np.eye(3)  # degenerate: p == 0
    np.testing.assert_allclose(t_eigvalsh3(torch.from_numpy(s)).numpy(),
                               np.asarray(j_eigvalsh3(jnp.asarray(s))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_valid", [37, 700, 1000])
def test_muse_scale_matches(n_valid):
    rng = np.random.default_rng(n_valid)
    r = np.abs(rng.standard_normal((3, 1024))).astype(np.float32)
    r[:, :50] *= 20.0  # outliers
    mask = np.zeros((3, 1024), bool)
    mask[:, :n_valid] = True
    want = [float(jrobust.muse_scale(jnp.asarray(r[i]), jnp.asarray(mask[i]))) for i in range(3)]
    got = trobust.muse_scale(torch.from_numpy(r), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_array_equal(
        trobust.linspace_f32(0.1, 0.9, 41).numpy(), np.asarray(jnp.linspace(0.1, 0.9, 41))
    )
    r2 = np.linspace(0, 20, 101).astype(np.float32)
    np.testing.assert_allclose(trobust.weight_bt(torch.from_numpy(r2)).numpy(),
                               np.asarray(jrobust.weight_bt(jnp.asarray(r2))), rtol=1e-6)


def test_lookup_matches_and_rounds_half_to_even():
    jctx, tctx = tp.small_contexts()
    vor = jctx.fixed_vor
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 80, (500, 3)).astype(np.float32)
    pts[:20] = np.floor(pts[:20]) + 0.5 + np.asarray(vor.origin)  # exact half-voxel ties
    want = np.asarray(jlookup(vor.index_vol, vor.origin, vor.spacing, jnp.asarray(pts)))
    got = tlookup(tctx.fixed_vor.index_vol, tctx.fixed_vor.origin,
                  tctx.fixed_vor.spacing, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_rows_and_grid_match():
    jctx, tctx = tp.small_contexts()
    np.testing.assert_allclose(
        ticp._pack_features(tctx.moving_features).numpy(),
        np.asarray(jicp._pack_features(jctx.moving_features)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        ticp.bake_target_grid(tctx.fixed_features, tctx.fixed_vor).numpy(),
        np.asarray(jicp.bake_target_grid(jctx.fixed_features, jctx.fixed_vor)),
        rtol=1e-6, atol=1e-6,
    )


# ---------------------------------------------------------------------------
# register_candidate, measurements and P(aligned) on the small context
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lanes():
    """The small context's usable (query, candidate) lanes, lrr_tpu's
    refinement of them, and the draws it made."""
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    queries = tp.small_queries(2)
    inits, m_sel, f_sel, usable = tp.jax_candidates(jctx, queries, jcfg)
    plan = tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg)
    k1s, k2s = tp.lane_keys(KEY, len(queries), jcfg.indexing.num_candidates)
    C = jcfg.indexing.num_candidates
    sel = [(q, c) for q in range(len(queries)) for c in range(C) if usable[q][c]]
    assert len(sel) >= 4
    qi = torch.tensor([q for q, _ in sel])
    ci = torch.tensor([c for _, c in sel])
    init = tp.stack_affines([inits[q][c] for q, c in sel])
    ms = jnp.asarray(np.stack([m_sel[q][c] for q, c in sel]))
    fs = jnp.asarray(np.stack([f_sel[q][c] for q, c in sel]))
    k1 = jnp.stack([k1s[q * C + c] for q, c in sel])
    k2 = jnp.stack([k2s[q * C + c] for q, c in sel])
    ecfg = jcfg.estimation

    def refine(init, m, f, k1, k2):
        mov = jctx.moving_features.replace(mask=m)
        fix = jctx.fixed_features.replace(mask=f)
        res = jicp.register_candidate(
            mov, fix, jctx.fixed_vor, jctx.moving_vor, init, ecfg, k1,
            moving_targets=jctx.moving_features, fixed_targets=jctx.fixed_features,
            fixed_grid=jctx.fixed_grid, moving_grid=jctx.moving_grid,
        )
        cov_b = jmeas.backward_covariance(
            res, mov, fix, jctx.fixed_vor, jctx.moving_vor, ecfg, k2,
            moving_targets=jctx.moving_features, fixed_targets=jctx.fixed_features,
        )
        return res, cov_b

    jres, jcov = jax.jit(jax.vmap(refine))(init, ms, fs, k1, k2)
    return dict(jcfg=jcfg, tcfg=tcfg, jctx=jctx, tctx=tctx, plan=plan.select(qi, ci),
                init=init, ms=ms, fs=fs, k1=k1, jres=jres, jcov=jcov,
                query=queries[qi.numpy()])


def _torch_sets(L):
    tctx = L["tctx"]
    return (dataclasses.replace(tctx.moving_features, mask=tp.t_(L["ms"])),
            dataclasses.replace(tctx.fixed_features, mask=tp.t_(L["fs"])))


def _theta_close(got: TAffine, want, rel: float):
    """Normwise: |d theta| <= rel * max|theta| per lane, for A and t."""
    for g, w in ((got.A, want.A), (got.t, want.t)):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w).reshape(len(w), -1).max(1)
        err = np.abs(g - w).reshape(len(w), -1).max(1)
        assert np.all(err <= rel * scale), (err / scale)


def test_register_candidate_iteration0_matches(lanes):
    """The peeled MUSE iteration from the same windows: rtol 1e-4."""
    L = lanes
    jctx, ecfg, tcfg = L["jctx"], L["jcfg"].estimation, L["tcfg"].estimation
    cap0 = ticp._staged_caps(tcfg)[0]
    T = ecfg.max_iterations + 1

    def it0(init, m, f, k1):
        mov = jctx.moving_features.replace(mask=m)
        fix = jctx.fixed_features.replace(mask=f)
        _, kpm, kpf, kof, kob = jax.random.split(k1, 5)
        src_m = jicp._pack_source(kpm, mov)
        src_f = jicp._pack_source(kpf, fix)
        off_f = jax.random.randint(kof, (T,), 0, jnp.maximum(src_m.valid_count, 1))[0]
        off_b = jax.random.randint(kob, (T,), 0, jnp.maximum(src_f.valid_count, 1))[0]
        n = jnp.asarray(ecfg.initial_matches)
        fwd = jicp._sample_matches_packed(
            None, src_m, jicp._pack_features(jctx.fixed_features), jctx.fixed_vor,
            init, n, cap0, offset=off_f, dst_grid=jctx.fixed_grid)
        bwd = jicp._sample_matches_packed(
            None, src_f, jicp._pack_features(jctx.moving_features), jctx.moving_vor,
            init.inverse(), n, cap0, offset=off_b, dst_grid=jctx.moving_grid)
        return jicp._estimate_ls_packed(init, fwd, bwd, True, ecfg)[0]

    want = jax.jit(jax.vmap(it0))(L["init"], L["ms"], L["fs"], L["k1"])

    tctx = L["tctx"]
    mov, fix = _torch_sets(L)
    draws = L["plan"].icp()
    init = tp.torch_affine(L["init"])
    src_m = ticp._pack_source(draws.scores_m, ticp._pack_features(tctx.moving_features), mov.mask)
    src_f = ticp._pack_source(draws.scores_f, ticp._pack_features(tctx.fixed_features), fix.mask)
    n = torch.full((init.A.shape[0],), tcfg.initial_matches)
    fwd = ticp._sample_matches_packed(src_m, tctx.fixed_vor, init, n, cap0,
                                      draws.offsets_f[:, 0], dst_rows=src_f.rows)
    bwd = ticp._sample_matches_packed(src_f, tctx.moving_vor, init.inverse(), n, cap0,
                                      draws.offsets_b[:, 0], dst_rows=src_m.rows)
    got = ticp._estimate_ls_packed(init, fwd, bwd, True, tcfg)[0]
    _theta_close(got, want, 1e-4)


def test_register_candidate_matches(lanes):
    """Final transform within the reference's own ~0.5 % spread; the
    convergence flags equal."""
    L = lanes
    tctx = L["tctx"]
    mov, fix = _torch_sets(L)
    res = ticp.register_candidate(
        mov, fix, tctx.fixed_vor, tctx.moving_vor, tp.torch_affine(L["init"]),
        L["tcfg"].estimation, L["plan"].icp(),
        moving_targets=tctx.moving_features, fixed_targets=tctx.fixed_features,
    )
    jres = L["jres"]
    _theta_close(res.trans, jres.trans, 5e-3)
    for name in ("converged", "valid", "oscillated"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(jres, name)))


def _torch_result(jres) -> ticp.ICPResult:
    kw = {f.name: tp.t_(getattr(jres, f.name)) for f in dataclasses.fields(ticp.ICPResult)
          if f.name != "trans"}
    kw["number_matches"] = kw["number_matches"].long()
    return ticp.ICPResult(trans=tp.torch_affine(jres.trans), **kw)


def test_measurements_and_probability_match(lanes):
    """The backward covariance, the 8 decision measurements and P(aligned)
    of the same ICPResult: rtol 1e-4."""
    L = lanes
    tctx, ecfg = L["tctx"], L["jcfg"].estimation
    jres, jcov = L["jres"], L["jcov"]
    half = ecfg.roi_mm / 2.0
    mlo = (np.asarray(L["init"].center) - half).astype(np.float32)
    flo = (L["query"] - half).astype(np.float32)

    mov, fix = _torch_sets(L)
    res_t = _torch_result(jres)
    cov_t = tmeas.backward_covariance(
        res_t, mov, fix, tctx.fixed_vor, tctx.moving_vor, L["tcfg"].estimation,
        L["plan"].covariance(), moving_targets=tctx.moving_features,
        fixed_targets=tctx.fixed_features,
    )
    err = np.abs(cov_t.numpy() - np.asarray(jcov)).reshape(len(mlo), -1).max(1)
    scale = np.abs(np.asarray(jcov)).reshape(len(mlo), -1).max(1)
    assert np.all(err <= 1e-4 * scale), err / scale

    jm = jax.vmap(partial(jmeas.decision_measurements, roi_size_mm=ecfg.roi_mm))
    jmv = np.asarray(jm(jres, jcov, jnp.asarray(mlo), jnp.asarray(flo)))
    tmv = tmeas.decision_measurements(res_t, cov_t, torch.from_numpy(mlo),
                                      torch.from_numpy(flo), ecfg.roi_mm).numpy()
    np.testing.assert_allclose(tmv, jmv, rtol=1e-4, atol=1e-6)
    pj = np.asarray(jprob(jload_svm(), jscale(jnp.asarray(jmv))))
    pt = tprob(tload_svm(), tscale(torch.from_numpy(tmv))).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-7)

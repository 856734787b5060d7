"""The port's rigid model (6 dof, small-angle increments), its ICP step and
the two entry points built on single lanes, `register_location_rigid` and
`watch_candidate`, against lrr_tpu on the same inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lrr_tpu.estimation import icp as jicp
from lrr_tpu.models import rigid as jrigid
from lrr_tpu.pipeline import registration as jreg
from lrr_tpu_torch.estimation import icp as ticp
from lrr_tpu_torch.models import rigid as trigid
from lrr_tpu_torch.pipeline import registration as treg
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm

KEY = jax.random.key(5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rotation(rng, angle: float) -> np.ndarray:
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K).astype(np.float32)


# ---------------------------------------------------------------------------
# models/rigid.py
# ---------------------------------------------------------------------------


def test_skew_matches():
    w = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(trigid.skew(_t(w)).numpy(), np.asarray(jrigid.skew(jnp.asarray(w))))


@pytest.mark.parametrize("case", ["near_rotation", "general", "reflection", "rank_deficient"])
def test_orthogonalize_matches(case):
    """U V^T of the SVD, which no sign choice of the factors changes: 1e-5.
    A matrix of negative determinant gives the reflection lrr_tpu gives."""
    rng = np.random.default_rng(1)
    R = np.stack([_rotation(rng, a) for a in (0.05, 0.7, 2.5)])
    if case == "near_rotation":
        M = R + 0.01 * rng.standard_normal((3, 3, 3))
    elif case == "general":
        M = rng.standard_normal((3, 3, 3))
    elif case == "reflection":
        M = R @ np.diag([1.0, 1.0, -1.0]) + 0.01 * rng.standard_normal((3, 3, 3))
    else:
        M = R @ np.diag([1.0, 0.5, 0.0]) @ np.swapaxes(R, 1, 2)[::-1]
    M = M.astype(np.float32)
    got = trigid.orthogonalize(_t(M)).numpy()
    np.testing.assert_allclose(got @ np.swapaxes(got, 1, 2), np.broadcast_to(np.eye(3), (3, 3, 3)),
                               atol=1e-5)
    if case == "rank_deficient":
        return  # the null direction's sign is the SVD's choice: only orthogonality holds
    want = np.stack([np.asarray(jrigid.orthogonalize(jnp.asarray(m))) for m in M])
    np.testing.assert_allclose(got, want, atol=1e-5)
    sign = -1.0 if case == "reflection" else 1.0
    if case != "general":
        np.testing.assert_allclose(np.linalg.det(got), sign, atol=1e-5)


def test_rigid3d_methods_match():
    rng = np.random.default_rng(2)
    R, t, c = _rotation(rng, 0.4), rng.uniform(-5, 5, 3).astype(np.float32), \
        rng.uniform(0, 30, 3).astype(np.float32)
    x = rng.uniform(0, 30, (9, 3)).astype(np.float32)
    omega, dt = (0.02 * rng.standard_normal(3)).astype(np.float32), \
        rng.uniform(-1, 1, 3).astype(np.float32)
    jr = jrigid.Rigid3D(R=jnp.asarray(R), t=jnp.asarray(t), center=jnp.asarray(c))
    tr = trigid.Rigid3D(R=_t(R), t=_t(t), center=_t(c))
    np.testing.assert_allclose(tr.apply(_t(x)).numpy(), np.asarray(jr.apply(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    ji, ti = jr.inverse(), tr.inverse()
    np.testing.assert_allclose(ti.R.numpy(), np.asarray(ji.R), atol=1e-6)
    np.testing.assert_allclose(ti.t.numpy(), np.asarray(ji.t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.apply(tr.apply(_t(x))).numpy(), x, atol=1e-4)
    jn = jr.recompose_increment(jnp.asarray(omega), jnp.asarray(dt))
    tn = tr.recompose_increment(_t(omega), _t(dt))
    np.testing.assert_allclose(tn.R.numpy(), np.asarray(jn.R), atol=1e-6)
    np.testing.assert_allclose(tn.t.numpy(), np.asarray(jn.t), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.euler_angles().numpy(), np.asarray(jr.euler_angles()), atol=1e-6)
    back = trigid.Rigid3D.from_euler(tr.euler_angles(), tr.t, tr.center)
    np.testing.assert_allclose(back.R.numpy(), R, atol=1e-6)
    np.testing.assert_allclose(
        back.R.numpy(),
        np.asarray(jrigid.Rigid3D.from_euler(jr.euler_angles(), jr.t, jr.center).R), atol=1e-6)
    ident = trigid.Rigid3D.identity(center=c, device="cpu")
    np.testing.assert_array_equal(ident.apply(_t(x)).numpy(), (x - c) + 0 * c)
    assert isinstance(tr.as_affine(), treg.Affine3D)


def _projectors(rng, m: int) -> np.ndarray:
    d = rng.standard_normal((m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    outer = d[:, :, None] * d[:, None, :]
    kind = rng.integers(0, 3, m)  # corner: I, sheet: d d^T, tube: I - d d^T
    eye = np.broadcast_to(np.eye(3), (m, 3, 3))
    P = np.where(kind[:, None, None] == 0, eye,
                 np.where(kind[:, None, None] == 1, outer, eye - outer))
    return P.astype(np.float32)


def test_rigid_increment_normal_equations_and_solve_match():
    """The 6 x 6 system of the small-angle increment and its solution
    against lrr_tpu (1e-5 of the largest entry), and a planted motion is
    recovered."""
    rng = np.random.default_rng(3)
    m = 300
    y = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    omega = np.asarray([0.004, -0.003, 0.002], np.float32)
    dt = np.asarray([0.3, -0.2, 0.1], np.float32)
    q = (y + np.cross(omega, y) + dt).astype(np.float32)
    P = _projectors(rng, m)
    w = rng.uniform(0, 2, m).astype(np.float32)
    jA, jb = jrigid.rigid_increment_normal_equations(*(jnp.asarray(a) for a in (y, q, P, w)))
    tA, tb = trigid.rigid_increment_normal_equations(*(_t(a) for a in (y, q, P, w)))
    assert np.abs(tA.numpy() - np.asarray(jA)).max() <= 1e-5 * np.abs(np.asarray(jA)).max()
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-5 * np.abs(np.asarray(jb)).max()
    jo, jd = jrigid.solve_rigid_increment(jA, jb)
    to, td = trigid.solve_rigid_increment(tA, tb)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-4)
    np.testing.assert_allclose(to.numpy(), omega, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), dt, atol=1e-3)
    # batched over leading dims
    bo, bd = trigid.solve_rigid_increment(tA[None].repeat(2, 1, 1), tb[None].repeat(2, 1))
    assert bo.shape == (2, 3) and bd.shape == (2, 3)
    np.testing.assert_allclose(bo[1].numpy(), to.numpy(), atol=1e-6)
    np.testing.assert_allclose(bd[0].numpy(), td.numpy(), atol=1e-4)


def test_packed_rigid_normal_equations_match():
    """The ICP's component-major form over L lanes, against lrr_tpu lane by
    lane: 1e-5 of the largest entry."""
    rng = np.random.default_rng(4)
    L, M = 3, 200
    z = rng.uniform(-20, 20, (L, 3, M)).astype(np.float32)
    b = rng.uniform(-1, 1, (L, 3, M)).astype(np.float32)
    d = rng.standard_normal((L, 3, M))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tag = rng.integers(0, 4, (L, M)).astype(np.float32)
    w = rng.uniform(-0.1, 2, (L, M)).astype(np.float32)
    c1, c2 = ticp.kernels.c1c2(_t(tag))
    tA, tb = ticp._normal_equations_rigid_packed(_t(z), _t(b), _t(d), c1, c2, _t(w))
    assert tA.shape == (L, 6, 6) and tb.shape == (L, 6)
    for lane in range(L):
        jc1, jc2 = jicp._c1c2(jnp.asarray(tag[lane]))
        jA, jb = jicp._normal_equations_rigid_packed(
            jnp.asarray(z[lane]), jnp.asarray(b[lane]), jnp.asarray(d[lane]), jc1, jc2,
            jnp.asarray(w[lane]))
        assert np.abs(tA[lane].numpy() - np.asarray(jA)).max() <= 1e-5 * np.abs(np.asarray(jA)).max()
        assert np.abs(tb[lane].numpy() - np.asarray(jb)).max() <= 1e-5 * np.abs(np.asarray(jb)).max()


# ---------------------------------------------------------------------------
# the rigid ICP step and the single-lane entry points on the small pair
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    queries = tp.small_queries()
    inits, m_sel, f_sel, usable = tp.jax_candidates(jctx, queries, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jctx=jctx, tctx=tctx, queries=queries, inits=inits,
                m_sel=m_sel, f_sel=f_sel, usable=usable)


def test_estimate_ls_rigid_step_matches(small):
    """One rigid step (the peeled MUSE iteration) from the same windows, on
    every usable candidate of two queries: 1e-4 of the largest entry; the
    result is a rotation and the covariance sits in the 6 x 6 corner."""
    S = small
    jctx, tctx, ecfg, tcfg = S["jctx"], S["tctx"], S["jcfg"].estimation, S["tcfg"].estimation
    C = S["jcfg"].indexing.num_candidates
    sel = [(q, c) for q in range(2) for c in range(C) if S["usable"][q][c]]
    plan = tp.plan_from_jax_keys(KEY, S["m_sel"], S["f_sel"], S["jcfg"])
    k1s, _ = tp.lane_keys(KEY, len(S["queries"]), C)
    init = tp.stack_affines([S["inits"][q][c] for q, c in sel])
    init = init.replace(A=jax.vmap(jrigid.orthogonalize)(init.A))
    ms = np.stack([S["m_sel"][q][c] for q, c in sel])
    fs = np.stack([S["f_sel"][q][c] for q, c in sel])
    k1 = jnp.stack([k1s[q * C + c] for q, c in sel])
    cap0 = ticp._staged_caps(tcfg)[0]
    T = ecfg.max_iterations + 1

    def step(init, m, f, k1):
        mov = jctx.moving_features.replace(mask=m)
        fix = jctx.fixed_features.replace(mask=f)
        _, kpm, kpf, kof, kob = jax.random.split(k1, 5)
        src_m, src_f = jicp._pack_source(kpm, mov), jicp._pack_source(kpf, fix)
        off_f = jax.random.randint(kof, (T,), 0, jnp.maximum(src_m.valid_count, 1))[0]
        off_b = jax.random.randint(kob, (T,), 0, jnp.maximum(src_f.valid_count, 1))[0]
        n = jnp.asarray(ecfg.initial_matches)
        fwd = jicp._sample_matches_packed(
            None, src_m, jicp._pack_features(jctx.fixed_features), jctx.fixed_vor,
            init, n, cap0, offset=off_f, dst_grid=jctx.fixed_grid)
        bwd = jicp._sample_matches_packed(
            None, src_f, jicp._pack_features(jctx.moving_features), jctx.moving_vor,
            init.inverse(), n, cap0, offset=off_b, dst_grid=jctx.moving_grid)
        new, cov, _, _ = jicp._estimate_ls_rigid_packed(init, fwd, bwd, True, ecfg)
        return new, cov

    want, want_cov = jax.jit(jax.vmap(step))(init, jnp.asarray(ms), jnp.asarray(fs), k1)

    draws = plan.select(torch.tensor([q for q, _ in sel]), torch.tensor([c for _, c in sel])).icp()
    tinit = tp.torch_affine(init)
    src_m = ticp._pack_source(draws.scores_m, ticp._pack_features(tctx.moving_features), _t(ms))
    src_f = ticp._pack_source(draws.scores_f, ticp._pack_features(tctx.fixed_features), _t(fs))
    n = torch.full((len(sel),), tcfg.initial_matches)
    fwd = ticp._sample_matches_packed(src_m, tctx.fixed_vor, tinit, n, cap0,
                                      draws.offsets_f[:, 0], dst_rows=src_f.rows)
    bwd = ticp._sample_matches_packed(src_f, tctx.moving_vor, tinit.inverse(), n, cap0,
                                      draws.offsets_b[:, 0], dst_rows=src_m.rows)
    got, cov, _, _ = ticp._estimate_ls_rigid_packed(tinit, fwd, bwd, True, tcfg)
    for g, w in ((got.A, want.A), (got.t, want.t)):
        g, w = g.numpy(), np.asarray(w)
        err = np.abs(g - w).reshape(len(sel), -1).max(1)
        assert np.all(err <= 1e-4 * np.abs(w).reshape(len(sel), -1).max(1)), err
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), got.A.shape)
    np.testing.assert_allclose((got.A @ got.A.transpose(1, 2)).numpy(), eye, atol=1e-5)
    assert not bool(cov[:, 6:, :].any()) and not bool(cov[:, :, 6:].any())
    wc = np.asarray(want_cov)
    assert np.abs(cov.numpy() - wc).max() <= 1e-3 * np.abs(wc).max()


def test_register_candidate_refuses_unknown_model(small):
    S = small
    with pytest.raises(ValueError):
        ticp.register_candidate(
            S["tctx"].moving_features, S["tctx"].fixed_features, S["tctx"].fixed_vor,
            S["tctx"].moving_vor, tp.torch_affine(tp.stack_affines([S["inits"][0][0]])),
            S["tcfg"].estimation, None, moving_targets=S["tctx"].moving_features,
            fixed_targets=S["tctx"].fixed_features, model="similarity")


@pytest.mark.parametrize("q", [0, 1])
def test_register_location_rigid_matches(small, q):
    """BASELINE config 3 for one query with lrr_tpu's draws: the same best
    candidate, the refined transform within the 0.5 % that the affine
    refinement is held to, and a rotation to 1e-5."""
    S = small
    key = jax.random.fold_in(KEY, q)
    jres, jbest, jany = jreg.register_location_rigid(
        S["jctx"], jnp.asarray(S["queries"][q]), S["jcfg"], key)
    assert bool(jany)
    plan = tp.rigid_plan_from_jax_key(
        key, S["m_sel"][q], S["f_sel"][q], S["jcfg"], int(jbest))
    res, best, any_usable = treg.register_location_rigid(
        S["tctx"], _t(S["queries"][q]), S["tcfg"], plan)
    assert bool(any_usable) and int(best) == int(jbest)
    assert res.trans.A.shape == (3, 3) and res.iterations.dim() == 0
    for g, w in ((res.trans.A, jres.trans.A), (res.trans.t, jres.trans.t)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 5e-3 * np.abs(np.asarray(w)).max()
    A = res.trans.A.numpy()
    np.testing.assert_allclose(A @ A.T, np.eye(3), atol=1e-5)
    assert bool(res.valid) == bool(jres.valid) and bool(res.converged) == bool(jres.converged)
    # a plan built without the rigid stream is refused, not served from another
    with pytest.raises(ValueError):
        treg.register_location_rigid(
            S["tctx"], _t(S["queries"][q]), S["tcfg"],
            tp.plan_from_query_key(key, S["m_sel"][q], S["f_sel"][q], S["jcfg"]))


def test_drawn_plan_carries_one_rigid_stream_per_query(small):
    """`draw_sampling_plan` draws the rigid stream after the per-candidate
    ones; `query` keeps it, a plan of lanes drops it."""
    from lrr_tpu_torch.sampling import draw_sampling_plan

    cfg = small["tcfg"]
    Q, C, T = 3, cfg.indexing.num_candidates, cfg.estimation.max_iterations + 1
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), Q, cfg, 40, 50)
    draws = plan.rigid()
    assert draws.scores_m.shape == (Q, 40) and draws.scores_f.shape == (Q, 50)
    assert draws.offsets_f.shape == draws.offsets_b.shape == (Q, T)
    assert draws.stats_offset_f.shape == draws.stats_offset_b.shape == (Q,)
    assert not torch.equal(draws.scores_m[0], plan.icp_scores_m[0, 0])
    one = plan.query(1)
    assert one.rank_offset.shape == (1, C)
    assert torch.equal(one.rigid().scores_f[0], draws.scores_f[1])
    assert torch.equal(one.icp_offsets_b[0], plan.icp_offsets_b[1])
    lanes = plan.select(torch.tensor([2, 0]), torch.tensor([1, 0]))
    assert torch.equal(lanes.cov_scores_m[0], plan.cov_scores_m[2, 1])
    assert lanes.rigid_scores_m is None and plan.flatten().rigid_offsets_f is None


def test_watch_candidate_is_the_production_refinement(small):
    """The replay samples with the candidate's own stream: its result is
    `register_location`'s for that candidate, the callback runs once an
    iteration with (iteration, weighted error, matches), and lrr_tpu's
    replay opens with the same numbers."""
    S = small
    q = 1
    key = jax.random.split(KEY, len(S["queries"]))[q]
    plan = tp.plan_from_query_key(key, S["m_sel"][q], S["f_sel"][q], S["jcfg"])
    query = _t(S["queries"][q])
    served = treg.register_location(S["tctx"], query, S["tcfg"], tload_svm(), plan)
    c = int(served.selected)
    assert c >= 0

    calls = []
    res = treg.watch_candidate(S["tctx"], query, S["tcfg"], plan, c, lambda *a: calls.append(a))
    assert len(calls) == int(res.iterations) >= 2
    assert [a[0] for a in calls] == list(range(len(calls)))
    assert all(isinstance(a[1], float) and isinstance(a[2], int) for a in calls)
    assert calls[-1][1] == pytest.approx(float(res.weighted_error), rel=1e-6)
    np.testing.assert_allclose(res.trans.A.numpy(), served.trans.A[c].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.trans.t.numpy(), served.trans.t[c].numpy(), rtol=1e-4, atol=1e-4)
    # the callback changes nothing: the same lane without it gives the same bits
    init, moving_roi, fixed_roi, draws = treg._one_candidate(
        S["tctx"], query, S["tcfg"], plan, c, tp.torch_affine(tp.stack_affines(
            [tp.stack_affines(S["inits"][q])])))
    plain = ticp.register_candidate(
        moving_roi, fixed_roi, S["tctx"].fixed_vor, S["tctx"].moving_vor, init,
        S["tcfg"].estimation, draws, moving_targets=S["tctx"].moving_features,
        fixed_targets=S["tctx"].fixed_features)
    assert int(plain.iterations[0]) == int(res.iterations)
    np.testing.assert_allclose(plain.trans.A[0].numpy(), res.trans.A.numpy(), rtol=1e-5, atol=1e-6)

    jcalls = []
    jres = jreg.watch_candidate(
        S["jctx"], jnp.asarray(S["queries"][q]), S["jcfg"], key, c,
        lambda *a: jcalls.append(tuple(np.asarray(v).item() for v in a)))
    jax.block_until_ready(jres.trans.A)
    jax.effects_barrier()
    jcalls.sort()
    assert len(jcalls) == int(jres.iterations)
    assert jcalls[0][0] == calls[0][0] == 0 and jcalls[0][2] == calls[0][2]
    assert calls[0][1] == pytest.approx(jcalls[0][1], rel=1e-3)
    assert np.abs(res.trans.A.numpy() - np.asarray(jres.trans.A)).max() <= 5e-3

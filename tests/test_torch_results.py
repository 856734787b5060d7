"""Result artifacts, the staged schedule's parameters, calibration labels and
`run_batch` of the PyTorch port, against lrr_tpu on the small fixture
with lrr_tpu's own draws.  One file, so that lrr_tpu's compiled serving
programs (one set per query count, verifier size and first-wave width) are
built once: every lrr_tpu run here serves 4 queries with the seed-7
surrogate verifier."""

from __future__ import annotations

import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.pipeline.batch as jbatch
import lrr_tpu.pipeline.results as jres
from lrr_tpu.pipeline.registration import register_locations_staged as jstaged
from lrr_tpu.verify.surrogate import collect_labeled_measurements as jcollect
from lrr_tpu.verify.surrogate import surrogate_verifier as jsurrogate

import lrr_tpu_torch.pipeline.batch as tbatch
import lrr_tpu_torch.pipeline.results as tres
from lrr_tpu_torch.io.mhd import write_mhd
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.pipeline.artifacts import save_pair_context
from lrr_tpu_torch.pipeline.registration import register_locations_staged as tstaged
from lrr_tpu_torch.pipeline.registration import result_at
from lrr_tpu_torch.verify import surrogate as tsurrogate

from tests import torch_parity as tp

KEY = jax.random.key(7)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    queries = tp.small_queries()
    _, m_sel, f_sel, _ = tp.jax_candidates(jctx, queries, jcfg)
    plan = tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg)
    jsvm = jsurrogate(seed=7)
    return jcfg, tcfg, jctx, tctx, queries, plan, jsvm, tp.torch_svm(jsvm)


@functools.lru_cache(maxsize=None)
def served():
    """lrr_tpu's staged result on the fixture, and the same numbers as the
    port's `LocationResult`."""
    jcfg, _, jctx, _, queries, _, jsvm, _ = setup()
    want = jstaged(jctx, jnp.asarray(queries), jcfg, jsvm, KEY)
    return want, tp.torch_location_result(want)


# ---------------------------------------------------------------------------
# results files
# ---------------------------------------------------------------------------


def test_params_reference_order_and_back():
    want, got = served()
    np.testing.assert_array_equal(
        got.trans.params_reference_order().numpy(),
        np.asarray(jax.vmap(jax.vmap(lambda tr: tr.params_reference_order()))(want.trans)))
    back = Affine3D.from_params_reference_order(
        got.trans.params_reference_order(), got.trans.center)
    assert torch.equal(back.A, got.trans.A) and torch.equal(back.t, got.trans.t)
    eye = Affine3D.identity(device="cpu")
    assert torch.equal(eye.apply(torch.ones(2, 3)), torch.ones(2, 3))


def test_result_at_takes_one_query():
    want, got = served()
    one = result_at(got, 2)
    ref = jax.tree.map(lambda x: x[2], want)
    assert one.selected.ndim == 0 and int(one.selected) == int(ref.selected)
    np.testing.assert_array_equal(one.trans.A.numpy(), np.asarray(ref.trans.A))
    np.testing.assert_array_equal(one.measurements.numpy(), np.asarray(ref.measurements))


@pytest.mark.parametrize("t", [0, 1, 2, 3])
def test_write_results_equal_bytes(tmp_path, t):
    want, got = served()
    q = setup()[4][t]
    jres.write_results(str(tmp_path / "j"), jax.tree.map(lambda x: x[t], want), q)
    tres.write_results(str(tmp_path / "t"), result_at(got, t), q)
    for ext in (".txt", ".json"):
        assert filecmp.cmp(str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext)), shallow=False)
    rec = json.load(open(str(tmp_path / "t.json")))
    assert rec["selected"] == int(want.selected[t]) and len(rec["candidates"]) == 4


class StubField:
    """A smooth ground-truth deformation, the same numbers for either
    package (numpy in, numpy out)."""

    def displacement(self, pts):
        p = np.asarray(pts, np.float32)
        return np.stack([0.8 + 0.02 * p[:, 1], -0.5 + 0.01 * p[:, 0] - 0.015 * p[:, 2],
                         0.3 + 0.0002 * p[:, 0] * p[:, 1]], -1).astype(np.float32)


def _is_covj_line(lines: list[str], i: int) -> bool:
    head = "Final estimated covarianceJ from moving points: "
    return lines[i].startswith("covarianceJ from points evalues") or any(
        i - k >= 0 and lines[i - k] == head for k in (1, 2, 3))


@pytest.mark.parametrize("gt,initial", [(False, False), (True, False), (True, True)],
                         ids=["plain", "gt_field", "gt_field_initial"])
def test_reference_artifacts_equal_but_for_covj(tmp_path, gt, initial):
    """Byte-equal files except the transfer-covariance lines, which the port
    computes in float32 on the device: those within 1e-4 relative."""
    want, got = served()
    jcfg, _, jctx, _, queries, _, _, _ = setup()
    t = 1
    q = queries[t]
    field = StubField() if gt else None
    jinit = tinit = None
    if initial:
        from lrr_tpu.matching import generate_candidates, initial_transforms

        c = generate_candidates(jnp.asarray(q), jctx.moving_descriptors, jctx.fixed_descriptors,
                                jcfg.indexing, nn_table=jctx.nn_table)
        jinit = initial_transforms(c, jctx.moving_descriptors, jctx.fixed_descriptors,
                                   jnp.asarray(q))
        tinit = tp.torch_affine(jinit)
    jpaths = jres.write_reference_artifacts(
        str(tmp_path / "j"), t, jax.tree.map(lambda x: x[t], want), q,
        roi_mm=jcfg.estimation.roi_mm, gt_field=field, initial_trans=jinit)
    tpaths = tres.write_reference_artifacts(
        str(tmp_path / "t"), t, result_at(got, t), q,
        roi_mm=jcfg.estimation.roi_mm, gt_field=field, initial_trans=tinit)
    assert [os.path.basename(p) for p in jpaths] == [os.path.basename(p) for p in tpaths]
    assert len(tpaths) == 3 * int(np.asarray(want.refined[t]).sum()) > 0
    covj_lines = 0
    for jp, tpth in zip(jpaths, tpaths):
        if "transform" in os.path.basename(jp):
            assert filecmp.cmp(jp, tpth, shallow=False), jp
            continue
        jl, tl = open(jp).read().split("\n"), open(tpth).read().split("\n")
        assert len(jl) == len(tl)
        if gt:
            assert jl[0].startswith("Affine Approximation Squared Error: ")
            assert any(line.startswith("Query point deformed: ") for line in jl)
        for i, (a, b) in enumerate(zip(jl, tl)):
            if not _is_covj_line(jl, i):
                assert a == b, (jp, i)
                continue
            covj_lines += 1
            fa = np.array([float(v) for v in a.split(":")[-1].split()])
            fb = np.array([float(v) for v in b.split(":")[-1].split()])
            np.testing.assert_allclose(fb, fa, rtol=1e-4, atol=1e-4 * np.abs(fa).max())
    assert covj_lines == 4 * len(tpaths) // 3


# ---------------------------------------------------------------------------
# the staged schedule's parameters
# ---------------------------------------------------------------------------


def test_accept_override_and_max_unproductive_match_lrr_tpu():
    """Calibration's settings (nothing verifies, no jump to full width) at a
    lane budget of one rank a wave: the same candidates refined in the same
    waves; no candidate verified or selected; the measurements within the
    staged parity test's tolerance."""
    jcfg, tcfg, jctx, tctx, queries, plan, jsvm, tsvm = setup()
    kw = dict(accept_override=2.0, max_unproductive=10**9, lane_budget=4)
    want = jstaged(jctx, jnp.asarray(queries), jcfg, jsvm, KEY, **kw)
    got = tstaged(tctx, torch.from_numpy(queries), tcfg, tsvm, plan, **kw)
    usable = np.asarray(want.candidate_mask & want.enough_features)
    refined = np.asarray(want.refined)
    np.testing.assert_array_equal(refined, usable)  # every usable candidate, no other
    np.testing.assert_array_equal(got.refined.numpy(), refined)
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))
    assert (got.selected.numpy() == -1).all()
    np.testing.assert_array_equal(got.verified.numpy(), np.asarray(want.verified))
    assert not got.verified.any()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    ok = refined & np.asarray(want.valid) & ~np.asarray(want.oscillated)
    assert ok.sum() >= 6
    for g, w in ((got.trans.A, want.trans.A), (got.trans.t, want.trans.t)):
        g, w = g.numpy()[ok], np.asarray(w)[ok]
        assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()
    np.testing.assert_allclose(got.measurements.numpy()[ok], np.asarray(want.measurements)[ok],
                               rtol=5e-2, atol=5e-2)
    # the default bar on the same draws does verify: the override is what held it
    normal = tstaged(tctx, torch.from_numpy(queries), tcfg, tsvm, plan, lane_budget=4)
    assert bool((normal.selected >= 0).any())
    assert int(normal.refined.sum()) < int(got.refined.sum())


def test_max_unproductive_widens_the_waves():
    """With nothing verifying, `max_unproductive=1` jumps to all C ranks
    after one low-yield wave: fewer, wider waves, the same candidates."""
    from lrr_tpu_torch.pipeline import registration

    _, tcfg, _, tctx, queries, plan, _, tsvm = setup()
    waves = []
    wave_fn = registration._wave_fn

    def counted(ctx, q, cfg, svm, inits, plan_, lanes, cand):
        # the (query, candidate) pairs refined: a wave is padded to its lane
        # bucket by repeating its first pair
        waves[-1].append(len(set(zip(lanes.tolist(), cand.tolist()))))
        return wave_fn(ctx, q, cfg, svm, inits, plan_, lanes, cand)

    registration._wave_fn = counted
    try:
        outs = []
        for mu in (10**9, 1):
            waves.append([])
            outs.append(tstaged(tctx, torch.from_numpy(queries), tcfg, tsvm, plan, lane_budget=4,
                                accept_override=2.0, max_unproductive=mu))
    finally:
        registration._wave_fn = wave_fn
    assert len(waves[1]) < len(waves[0]) and sum(waves[1]) == sum(waves[0])
    assert torch.equal(outs[0].refined, outs[1].refined)


# ---------------------------------------------------------------------------
# calibration labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("good_mm,bad_mm,both", [(2.0, 6.0, False), (0.5, 1.0, True)],
                         ids=["default_2mm_6mm", "tight_0.5mm_1mm"])
def test_collect_labeled_measurements_labels_match_lrr_tpu(good_mm, bad_mm, both):
    """The default thresholds label every refined candidate of the fixture
    aligned; the tight pair gives both classes."""
    from lrr_tpu.models import Affine3D as JAffine

    jcfg, tcfg, jctx, tctx, queries, plan, _, _ = setup()
    true = tp.small_meta()["true"]
    jtrue = JAffine(*(jnp.asarray(true[k], jnp.float32) for k in ("A", "t", "center")))
    ttrue = Affine3D(*(torch.tensor(true[k]) for k in ("A", "t", "center")))
    jX, jy = jcollect(jctx, jcfg, jtrue, queries, KEY, good_mm, bad_mm)
    tX, ty = tsurrogate.collect_labeled_measurements(
        tctx, tcfg, ttrue, queries, plan, good_mm, bad_mm)
    assert len(jy) >= 6 and jy.sum() > 0
    assert (jy.sum() < len(jy)) == both
    np.testing.assert_array_equal(ty, jy)
    assert tX.shape == jX.shape and tX.dtype == np.float32
    np.testing.assert_allclose(tX, jX, rtol=5e-2, atol=5e-2)


def test_median_of_even_probe_count_is_the_mean_of_the_middle_pair():
    """20 probes: `jnp.median` averages the 10th and 11th error, and the
    labels at 2 mm / 6 mm depend on it."""
    from lrr_tpu_torch.ops.robust import nanmedian

    x = np.random.default_rng(0).uniform(0, 8, (5, 20)).astype(np.float32)
    np.testing.assert_allclose(nanmedian(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=-1)), rtol=1e-6)
    assert not np.allclose(torch.from_numpy(x).median(-1).values.numpy(), np.median(x, -1))


# ---------------------------------------------------------------------------
# run_batch against lrr_tpu's
# ---------------------------------------------------------------------------


def test_run_batch_selects_what_lrr_tpu_selects(tmp_path):
    """Three queries in a batch of four (the last one repeated as padding),
    lrr_tpu resuming from the context the port saved; the port draws what
    lrr_tpu draws from `key(seed + b0)`."""
    jcfg, tcfg, jctx, tctx, queries, _, jsvm, tsvm = setup()
    vol = np.random.default_rng(0).normal(size=(8, 8, 8)).astype(np.float32)
    for name in ("m.mha", "f.mha"):
        write_mhd(str(tmp_path / name), vol)
    qs = [[float(v) for v in q] for q in queries[:3]]
    seed = 5
    for side in ("j", "t"):
        os.makedirs(str(tmp_path / side / "artifacts"))
        save_pair_context(str(tmp_path / side / "artifacts" / "pair.npz"), tctx)

    def plan_for(ctx, b0, n):
        padded = np.asarray(qs + [qs[-1]] * (n - len(qs)), np.float32)
        _, m_sel, f_sel, _ = tp.jax_candidates(jctx, padded, jcfg)
        return tp.plan_from_jax_keys(jax.random.key(seed + b0), m_sel, f_sel, jcfg)

    jrep = jbatch.run_batch(
        [jbatch.PairJob("pair", str(tmp_path / "m.mha"), str(tmp_path / "f.mha"), qs)],
        jcfg, jsvm, str(tmp_path / "j"), seed=seed, query_batch=4)
    trep = tbatch.run_batch(
        [tbatch.PairJob("pair", str(tmp_path / "m.mha"), str(tmp_path / "f.mha"), qs)],
        tcfg, tsvm, str(tmp_path / "t"), seed=seed, query_batch=4, device="cpu",
        plan_for=plan_for)
    assert jrep["completed"] == trep["completed"] == 1, (jrep["pairs"], trep["pairs"])
    jl, tl = jrep["pairs"][0]["locations"], trep["pairs"][0]["locations"]
    assert [x["selected"] for x in tl] == [x["selected"] for x in jl]
    assert len(tl) == 3 and any(x["selected"] >= 0 for x in tl)
    assert sorted(os.listdir(str(tmp_path / "t"))) == sorted(os.listdir(str(tmp_path / "j")))
    for i, loc in enumerate(tl):
        if loc["selected"] < 0:
            continue
        jr = json.load(open(str(tmp_path / "j" / f"pair_results{i:06d}.json")))
        tr = json.load(open(str(tmp_path / "t" / f"pair_results{i:06d}.json")))
        a = np.asarray(jr["candidates"][loc["selected"]]["params_reference_order"])
        b = np.asarray(tr["candidates"][loc["selected"]]["params_reference_order"])
        assert np.abs(a[:9] - b[:9]).max() <= 5e-3 * np.abs(a[:9]).max()
        assert np.abs(a[9:] - b[9:]).max() <= 5e-3 * np.abs(a[9:]).max()
    assert set(trep["timers"]) == set(jrep["timers"]) == {"load", "prepare", "register"}

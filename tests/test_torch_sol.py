"""The port's speed-of-light accounting (lrr_tpu_torch/utils/sol.py) against
lrr_tpu's (lrr_tpu/utils/sol.py), on the CPU.

What a CPU run can hold is what does not depend on the card: the synthetic
iteration inputs (drawn in lrr_tpu's order from one numpy seed), one ICP
iteration of every lane on them (the port's `_sample_matches_packed` and
`_estimate_ls_packed` against lrr_tpu's `lane_iter`, rebuilt here from its
pieces as lrr_tpu/utils/sol.py:165-189 writes it), the light-bound arithmetic
and the report's keys (lrr_tpu's report computed with its timing replaced by
given seconds, so nothing of it is compiled or timed).  The times themselves
come from the card (`chip_smoke.py` phase 15).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrr_tpu.utils import sol as jsol
from lrr_tpu_torch.utils import sol as tsol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(lanes=4, n_features=256, map_side=16, cap=128)
K = 2
ITER_REL = 1e-4  # one ICP iteration, normwise (tests/test_torch_icp.py's stated tolerance)
# lrr_tpu's report rounds; the port's does not (key: decimals lrr_tpu keeps)
ROUNDED = {"time_ms_per_iter": 3, "sample_ms": 3, "estimate_ls_ms": 3,
           "light_ms_streaming_peak": 4, "achieved_gather_gb_s": 1, "light_ms": 4,
           "fraction_of_light": 3, "sample_fraction_of_gather_roofline": 3}


def _jax_lane_iter(inputs, cap, i):
    """lrr_tpu's `lane_iter` (with_ls=True) on every lane at iteration i:
    (A, t) after the 1e-3 step, and the estimate (A, t)."""
    from lrr_tpu.config import EstimationConfig
    from lrr_tpu.estimation.icp import (
        VoronoiGrid, _estimate_ls_packed, _grid_rows, _PackedSource, _sample_matches_packed,
    )
    from lrr_tpu.models import Affine3D

    cfg = EstimationConfig(max_matches=cap)
    n = inputs["dst_f"].shape[0]
    zero3, one3 = jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32)
    dst_f, dst_m = jnp.asarray(inputs["dst_f"]), jnp.asarray(inputs["dst_m"])
    vor_f = VoronoiGrid(jnp.asarray(inputs["vor_f"]), zero3, one3)
    vor_m = VoronoiGrid(jnp.asarray(inputs["vor_m"]), zero3, one3)
    grid_f, grid_m = _grid_rows(dst_f, vor_f), _grid_rows(dst_m, vor_m)
    order, nvalid = jnp.arange(n), jnp.asarray(n)
    number = jnp.asarray(cap, jnp.int32)
    off_f, off_b = jnp.asarray(inputs["offs"][0, i]), jnp.asarray(inputs["offs"][1, i])

    def lane(A, t, tab_m, tab_f):
        trans = Affine3D(A=A, t=t, center=zero3)
        fwd = _sample_matches_packed(None, _PackedSource(tab_m, nvalid, order), dst_f, vor_f,
                                     trans, number, cap, offset=off_f, dst_grid=grid_f)
        bwd = _sample_matches_packed(None, _PackedSource(tab_f, nvalid, order), dst_m, vor_m,
                                     trans.inverse(), number, cap, offset=off_b, dst_grid=grid_m)
        new = _estimate_ls_packed(trans, fwd, bwd, False, cfg)[0]
        return A + 1e-3 * (new.A - A), t + 1e-3 * (new.t - t), new.A, new.t

    L = inputs["tabs_m"].shape[0]
    A0 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (L, 3, 3))
    out = jax.jit(jax.vmap(lane))(A0, jnp.asarray(inputs["t0"]), jnp.asarray(inputs["tabs_m"]),
                                  jnp.asarray(inputs["tabs_f"]))
    return [np.asarray(x) for x in out]


def _jax_report(monkeypatch, shape, t_full, t_samp, gather_gbs):
    """lrr_tpu's `icp_iteration_sol` at `shape` with its two slopes replaced
    by the given seconds, the port's peaks, and `gather_gbs` as its measured
    ceiling (None: none measured)."""
    times = iter([t_full, t_samp])
    monkeypatch.setattr(jsol, "_time_fn_slope", lambda *a, **k: next(times))
    monkeypatch.setattr(jsol, "PEAK_F32_TFLOPS", tsol.PEAK_F32_TFLOPS)
    monkeypatch.setattr(jsol, "PEAK_HBM_GBS", tsol.PEAK_HBM_GBS)
    roof = None if gather_gbs is None else {
        "gather_gb_s_padded_small": gather_gbs, "gather_gb_s_dense_big": gather_gbs}
    monkeypatch.setattr(jsol, "measured_gather_roofline", lambda: roof)
    return jsol.icp_iteration_sol(**shape, K=K, seed=0)


@pytest.fixture(scope="module")
def reference():
    """The port's inputs at the small shape and lrr_tpu's iterations 0 and 1
    on them (one compile)."""
    inputs = tsol.synthetic_iteration_inputs(SMALL["lanes"], SMALL["n_features"],
                                             SMALL["map_side"], K, seed=0)
    return inputs, {i: _jax_lane_iter(inputs, SMALL["cap"], i) for i in (0, 1)}


def test_inputs_are_lrr_tpus_draws(reference):
    """The same numpy stream in lrr_tpu's order (sol.py:119-163): the last
    draw, the offsets, comes out equal only if every draw before it did."""
    inputs, _ = reference
    rng = np.random.default_rng(0)
    n, L, S = SMALL["n_features"], SMALL["lanes"], SMALL["map_side"]
    for rows in (n, n):
        rng.uniform(2, S - 2, (rows, 3)), rng.uniform(0.5, 5.0, (rows, 1))
        rng.standard_normal((rows, 3)), rng.integers(1, 4, (rows, 1))
    np.testing.assert_array_equal(inputs["vor_f"], rng.integers(0, n, (S, S, S)))
    np.testing.assert_array_equal(inputs["vor_m"], rng.integers(0, n, (S, S, S)))
    for rows in (L * 2 * n, L * 2 * n):
        rng.uniform(2, S - 2, (rows, 3)), rng.uniform(0.5, 5.0, (rows, 1))
        rng.standard_normal((rows, 3)), rng.integers(1, 4, (rows, 1))
    np.testing.assert_array_equal(inputs["t0"], rng.uniform(-1, 1, (L, 3)).astype(np.float32))
    np.testing.assert_array_equal(inputs["offs"], rng.integers(0, n, (2, 5 * K + 1)))
    assert inputs["tabs_m"].shape == (L, 2 * n, 8) and inputs["tabs_m"].dtype == np.float32
    d = inputs["tabs_f"][..., 4:7]
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("i", [0, 1])
def test_one_iteration_matches_lrr_tpus_lane_iter(reference, i):
    """Every lane's estimate from the same windows and matches within the ICP's
    one-iteration tolerance (normwise 1e-4 of the largest parameter, the
    uncentred 12x12 solve in float32 in both packages), and the stepped
    transform, which moves 1e-3 of the way to it, to 1e-6."""
    inputs, want = reference
    w = tsol.iteration_wave(inputs, SMALL["cap"], "cpu")
    L = SMALL["lanes"]
    A0 = torch.eye(3).expand(L, 3, 3).contiguous()
    A, t, new = tsol.iterate(w, A0, torch.from_numpy(inputs["t0"]), i)
    jA, jt, jnewA, jnewt = want[i]
    for got, exp, rel in ((new.A, jnewA, ITER_REL), (new.t, jnewt, ITER_REL),
                          (A, jA, 1e-6), (t, jt, 1e-6)):
        got = got.numpy()
        scale = np.abs(exp).reshape(L, -1).max(1)
        err = np.abs(got - exp).reshape(L, -1).max(1)
        assert np.all(err <= rel * scale), err / scale
    # the estimate moved: the windows matched something
    assert float((new.A - A0).abs().max()) > 1e-3


def test_sampling_alone_keeps_the_transform(reference):
    inputs, _ = reference
    w = tsol.iteration_wave(inputs, SMALL["cap"], "cpu")
    A0 = torch.eye(3).expand(SMALL["lanes"], 3, 3).contiguous()
    t0 = torch.from_numpy(inputs["t0"])
    A, t, new = tsol.iterate(w, A0, t0, 0, with_ls=False)
    assert new is None and torch.equal(A, A0)
    torch.testing.assert_close(t, t0, rtol=0, atol=1e-20)


CASES = [  # (shape, t_full, t_samp, gather GB/s)
    (SMALL, 4e-8, 2e-8, 50.0),
    (SMALL, 1.5e-8, 1e-8, 400.0),  # faster than the ceiling: the note
    (SMALL, 4e-8, 2e-8, None),  # nothing measured: the streaming peak
    (dict(lanes=64, n_features=8192, map_side=96, cap=4096), 2.3e-3, 1.1e-3, 120.0),
    (dict(lanes=20, n_features=16384, map_side=192, cap=8000), 1.7e-3, 0.9e-3, None),
]


@pytest.mark.parametrize("shape,t_full,t_samp,gbs", CASES,
                         ids=["measured", "over_ceiling", "streaming", "bench", "reference"])
def test_light_bound_arithmetic_is_lrr_tpus(monkeypatch, shape, t_full, t_samp, gbs):
    """For the same shape, seconds, peaks and gather ceiling, every number
    of the port's report rounds to lrr_tpu's (lrr_tpu rounds, the port
    does not), and the keys are lrr_tpu's plus `device_ms_per_iter`."""
    want = _jax_report(monkeypatch, shape, t_full, t_samp, gbs)
    got = tsol.iteration_light(shape["lanes"], shape["n_features"], shape["map_side"],
                               shape["cap"], t_full, t_samp, gbs)
    assert set(got) == set(want) | {"device_ms_per_iter"}
    assert got["device_ms_per_iter"] is None
    for key, digits in ROUNDED.items():
        if key in want:
            assert round(got[key], digits) == want[key], key
    for key in ("peak_gb_s", "shape", "gather_roofline_gb_s"):
        if key in want:
            assert got[key] == want[key], key
    # the bound names the same limit; the port says fp32 where lrr_tpu says mxu
    assert got["bound"].split()[0] == want["bound"].split()[0].replace("mxu", "fp32")
    assert ("note" in got) == (got["fraction_of_light"] > 1)


def test_light_bound_counts():
    """The bytes and operations behind `light_ms`, written out for the
    bench wave: 64 lanes x 2 directions x 4096 rows x 32 B for the window
    and again for the gather, and lrr_tpu's normal-equation count."""
    lanes, cap = 64, 4096
    assert tsol._flops_min(lanes, cap) == lanes * 2 * (2 * 12 * 12 * 3 * cap
                                                       + 2 * 12 * 3 * cap + 72 * cap)
    rep = tsol.iteration_light(lanes, 8192, 96, cap, 1e-3, 5e-4, None)
    nbytes = 2 * lanes * 2 * cap * 32
    t_bytes = nbytes / (tsol.PEAK_HBM_GBS * 1e9)
    t_ops = tsol._flops_min(lanes, cap) / (tsol.PEAK_F32_TFLOPS * 1e12)
    assert rep["light_ms"] == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert rep["fraction_of_light"] == pytest.approx(max(t_bytes, t_ops) / 1e-3, rel=1e-12)


def test_kernel_bounds():
    """K1's and K2's bounds over the published peaks (the counts chip_smoke's
    phase 3 held its kernels to before they moved here)."""
    L, mf, mb = 2, 5, 3
    w_f = torch.tensor([[1.0, 0.0, 2.0, -1.0, 0.5], [0.0, 0.0, 0.0, 0.0, 3.0]])
    w_b = torch.ones(L, mb)
    fwd = (None,) * 4 + (w_f,)
    bwd = (None,) * 4 + (w_b,)
    ms, by = tsol.k1_bound_ms(fwd, bwd)
    nbytes = 4 * (L * (mf + mb) * 11 + L * 11 + L * 156)
    ops = 225 * (4 + 6)
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)
    assert by == "bytes"
    ms, by = tsol.knn_bound_ms(4096, 4096, 195, 1, 3500)
    ops = 3 * 4096 * 3500 * 195
    assert ms == pytest.approx(ops / 67e12 * 1e3, rel=1e-12) and by == "operations"


def test_icp_iteration_sol_runs_on_the_cpu():
    """The whole measurement at the small shape on the CPU: finite times,
    nothing of the card (no ceiling, no device time), a share in (0, 1]."""
    rep = tsol.icp_iteration_sol(**SMALL, K=1, seed=0, device="cpu")
    assert rep["device_ms_per_iter"] is None and "gather_roofline_gb_s" not in rep
    assert rep["bound"].startswith("hbm-streaming")
    assert np.isfinite(rep["time_ms_per_iter"]) and rep["time_ms_per_iter"] > 0
    assert 0 < rep["fraction_of_light"] <= 1


def test_report_keys_are_lrr_tpus(monkeypatch):
    """`kernel_sol_report`'s structure: lrr_tpu's kernels and keys (its
    iteration and timing stubbed, so nothing compiles), the port's at a
    small size on the CPU.  The descriptor variants are the port's own
    (fp32 / TF32 expansions, lrr_tpu's were HIGHEST / bf16) with lrr_tpu's
    fields."""
    monkeypatch.setattr(jsol, "icp_iteration_sol", lambda **kw: {"stub": kw})
    monkeypatch.setattr(jsol, "_time_fn_slope", lambda *a, **k: 1e-3)
    want = jsol.kernel_sol_report(n_desc_q=8, n_desc_p=8, K=1)
    calls = []

    def small_iteration(lanes, n_features, map_side, cap, K_, seed, device):
        calls.append((lanes, n_features, map_side, cap))
        return {"shape": "small"}

    monkeypatch.setattr(tsol, "icp_iteration_sol", small_iteration)
    got = tsol.kernel_sol_report(n_desc_q=24, n_desc_p=40, K=1, device="cpu")
    assert calls == [(64, 8192, 96, 4096), (20, 16384, 192, 8000)]
    assert set(got) == set(want)
    nn, jnn = got["descriptor_nn"], want["descriptor_nn"]
    assert set(nn) == set(jnn)
    assert nn["shape"] == "24x40x195"
    assert 0 < nn["fraction_of_peak"] and nn["time_ms"] > 0
    jfields = {k for v in jnn["variants"].values() for k in v}
    assert len(nn["variants"]) == len(jnn["variants"]) == 4
    for v in nn["variants"].values():
        assert set(v) == jfields and v["time_ms"] > 0


def test_gather_roofline_is_none_on_the_cpu_and_the_card_is_the_default():
    assert tsol.measured_gather_roofline("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsol.measured_gather_roofline()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsol.kernel_sol_report()


def test_sol_imports_no_jax():
    code = ("import sys; import lrr_tpu_torch.utils.sol; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'lrr_tpu' or m.startswith('lrr_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": ROOT})

"""The ICP's robust weighting on the CPU: `kernels.robust_weights` and
`kernels.weighted_error` (kernel K6's wrappers) take their plain versions
there, bit for bit; the ICP keeps the plain chain for the MUSE iteration and
for a split match axis; `_mad_scale_dof`'s edge cases, the written oracle
of K6's order statistic; K6's counters and bound.  K6 itself runs only on
the card (tests/test_torch_gpu.py)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from lrr_tpu_torch.config import EstimationConfig, pipeline_config_from_dict
from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.pipeline import registration
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.pipeline.wave_graph import first_difference
from lrr_tpu_torch.sampling import draw_sampling_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(ROOT, "tests", "data", "torch_pair_small")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (K6's input maker, shared with the card's checks)

CPU = torch.device("cpu")


def _inputs(stride, seed=0, L=8, m_f=300, m_b=280):
    return chip_smoke.k6_inputs(np.random.default_rng(seed), L, m_f, m_b, stride, CPU)


def _chain(fwd, bwd, trans, inv, falloff):
    """The weighting as the ICP composed it from its steps before K6."""
    fwd = icp._scale_and_bt_weights_packed(trans, fwd, None)
    bwd = icp._scale_and_bt_weights_packed(inv, bwd, None)
    cm = icp._masked_mean_rows(fwd.fxyz, fwd.mask)
    cf = icp._masked_mean_rows(fwd.txyz, fwd.mask)
    dm, df = fwd.fxyz - cm[:, :, None], fwd.txyz - cf[:, :, None]
    rm = torch.clamp(icp._masked_mean_rows(
        torch.sqrt(dm[:, 0] ** 2 + dm[:, 1] ** 2 + dm[:, 2] ** 2)[:, None], fwd.mask)[:, 0],
        min=1e-6)
    rf = torch.clamp(icp._masked_mean_rows(
        torch.sqrt(df[:, 0] ** 2 + df[:, 1] ** 2 + df[:, 2] ** 2)[:, None], fwd.mask)[:, 0],
        min=1e-6)
    fwd = icp._weight_by_strength_packed(fwd)
    bwd = icp._weight_by_strength_packed(bwd)
    fwd = icp._weight_spatially_packed((fwd.txyz - cf[:, :, None]) / rf[:, None, None], fwd,
                                       falloff)
    bwd = icp._weight_spatially_packed((bwd.txyz - cm[:, :, None]) / rm[:, None, None], bwd,
                                       falloff)
    floor = [torch.where(pm.weight >= icp.WEIGHT_FLOOR, pm.weight, torch.zeros_like(pm.weight))
             for pm in (fwd, bwd)]
    return (*floor, cm, cf, rm, rf)


@pytest.mark.parametrize("stride", [8, 16])
def test_robust_weights_on_the_cpu_is_the_plain_chain(stride):
    """The wrapper's CPU path is `icp.robust_weights_plain`, the chain of
    the weighting's steps, bit for bit (the sampler's rows and the
    statistics sample's), and launches nothing; `_weighted_matches_packed`
    hands its weights and frame on."""
    fwd, bwd, trans, inv, falloff = _inputs(stride)
    before = kernels.counts()
    got = kernels.robust_weights(fwd, bwd, trans, inv, falloff)
    assert kernels.counts() == before
    assert first_difference(got, icp.robust_weights_plain(fwd, bwd, trans, inv, falloff)) is None
    assert first_difference(got, _chain(fwd, bwd, trans, inv, falloff)) is None
    fw, bw, *frame = icp._weighted_matches_packed(trans, fwd, bwd, False, EstimationConfig())
    assert first_difference((fw.weight, bw.weight, *frame), got) is None
    assert fw.fxyz is fwd.fxyz and bw.mask is bwd.mask
    assert bool((got[0] > 0).any()) and bool((got[1] > 0).any())


def test_weighted_error_on_the_cpu_is_the_plain_chain():
    """The wrapper's CPU path is two `_weighted_error_packed` calls, bit for
    bit, and launches nothing."""
    fwd, bwd, trans, inv, falloff = _inputs(8, seed=1)
    w_f, w_b, *_ = icp.robust_weights_plain(fwd, bwd, trans, inv, falloff)
    fwd, bwd = dataclasses.replace(fwd, weight=w_f), dataclasses.replace(bwd, weight=w_b)
    before = kernels.counts()
    got = kernels.weighted_error(fwd, bwd, trans, inv)
    assert kernels.counts() == before
    want = (icp._weighted_error_packed(trans, fwd), icp._weighted_error_packed(inv, bwd))
    assert first_difference(got, want) is None
    assert got[0].shape == got[1].shape == (8,) and bool(torch.isfinite(got[0][5:]).all())


def test_every_weight_is_zero_after_beaton_tukey_when_every_residual_overflows():
    """Lane 4 of the inputs (targets at 1e20, the corner tag): its RMS scale
    is infinite, r2 / s^2 NaN, so every Beaton-Tukey weight is 0; no match
    is left for the strength MAD, whose order statistic is float max and
    whose scale overflows; every final weight is 0.  Lanes 0 and 1 (n = 0,
    1) end with no weight as well."""
    fwd, bwd, trans, inv, falloff = _inputs(8, seed=2)
    bt = icp._scale_and_bt_weights_packed(trans, fwd, None)
    assert bool(fwd.mask[4].any()) and not bool(bt.weight[4].any())
    gw = torch.clamp(fwd.fstr * fwd.tstr, max=90000.0)
    scale = icp._mad_scale_dof(gw, fwd.mask & (bt.weight != 0))
    assert float(scale[4]) == float("inf")
    w_f, w_b, *_ = icp.robust_weights_plain(fwd, bwd, trans, inv, falloff)
    for lane in (0, 1, 4):
        assert not bool(w_f[lane].any()) and not bool(w_b[lane].any())


def _f32(x):
    return np.float32(x)


def _mad_value(med, n):
    """1.4826 (1 + 5 / max(n - 1, 1)) med in float32, in the plain
    version's order of operations."""
    f = _f32(1.0) + (_f32(1.0) / _f32(max(n - 1, 1))) * _f32(5.0)
    with np.errstate(over="ignore"):  # float max overflows, as in float32 on the card
        return float(_f32(1.4826) * f * _f32(med))


BIG = float(np.finfo(np.float32).max)


@pytest.mark.parametrize("case,values,mask,element,n,stated", [
    # no match: element 0 of an all-max row; 1.4826 x 6 x max overflows
    ("n0", [1.0, 2.0, 3.0, 4.0], [0, 0, 0, 0], BIG, 0, float("inf")),
    # one match: element 1, the first masked entry's max
    ("n1", [5.0, 2.0, 3.0, 4.0], [1, 0, 0, 0], BIG, 1, float("inf")),
    # one match of one: the element is clamped to M - 1 = 0
    ("n1_alone", [5.0], [1], 5.0, 1, 44.478),
    # two matches: element 1 of |values|, the larger
    ("n2", [-5.0, 2.0, 9.0, 1.0], [1, 0, 0, 1], 5.0, 2, 44.478),
    # ties at the order statistic: element 3 of [1, 3, 3, 3, 5]
    ("ties", [3.0, -3.0, 3.0, 1.0, 5.0], [1, 1, 1, 1, 1], 3.0, 5, 10.00755),
    # a masked tail: element 2 of [1, 2, 7, max, max]
    ("masked_tail", [2.0, 7.0, 1.0, 9.0, 4.0], [1, 1, 1, 0, 0], 7.0, 3, 36.3237),
])
def test_mad_scale_dof_edge_cases(case, values, mask, element, n, stated):
    """`_mad_scale_dof`: the element at floor((n - 1) / 2) + 1 (clamped to
    M - 1) of |values| sorted with float max for the masked entries, times
    1.4826 (1 + 5 / max(n - 1, 1)) in float32.  The values stated here are
    what K6's order statistic must give."""
    v = torch.tensor([values], dtype=torch.float32)
    m = torch.tensor([mask], dtype=torch.bool)
    got = float(icp._mad_scale_dof(v, m)[0])
    assert got == _mad_value(element, n)
    assert got == pytest.approx(stated, rel=1e-6)


class _SplitButWhole(icp._MatchAxis):
    """A match axis that reports two ranks but holds every match: its sums
    and gathers are the whole axis's."""

    def __init__(self):
        super().__init__()
        self.n = 2

    def block(self, cap):
        return 0, cap

    def reduce(self, *xs):
        return list(xs)

    def gather(self, x, mask):
        return x, mask


def _refuse(*args, **kwargs):
    raise AssertionError("K6's wrapper called")


@pytest.fixture(scope="module")
def wave():
    """A 16-lane wave of the small context on the CPU after its MUSE
    iteration: (refinement, carry)."""
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    ctx = load_pair_context(SMALL + ".npz", device="cpu")
    q = torch.as_tensor(np.asarray(meta["queries"], np.float32))
    plan = draw_sampling_plan(torch.Generator().manual_seed(7), len(q), cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    cmask, inits, _, enough, *_ = registration._pass1_fn(ctx, q, cfg, plan)
    usable = (cmask & enough).nonzero()[:16]
    r, c, _ = registration._wave_prologue(
        ctx, cfg, *registration._wave_inputs(q, inits, plan, usable[:, 0], usable[:, 1]))
    return r, c


def test_the_muse_iteration_and_a_split_axis_keep_the_plain_chain(wave, monkeypatch):
    """With K6's wrappers made to raise: the MUSE weighting and a split
    match axis's weighting and weighted errors run (the plain chain, the
    split axis's equal to the whole axis's here); the RMS weighting and a
    whole axis's iteration reach the wrapper."""
    fwd, bwd, trans, inv, falloff = _inputs(8, seed=3)
    cfg = EstimationConfig()
    whole = icp._weighted_matches_packed(trans, fwd, bwd, False, cfg)
    monkeypatch.setattr(kernels, "robust_weights", _refuse)
    monkeypatch.setattr(kernels, "weighted_error", _refuse)
    muse = icp._weighted_matches_packed(trans, fwd, bwd, True, cfg)
    want = icp.robust_weights_plain(fwd, bwd, trans, inv, falloff,
                                    muse=(cfg.muse_min_frac, cfg.muse_max_frac))
    assert first_difference((muse[0].weight, muse[1].weight, *muse[2:]), want) is None
    split = icp._weighted_matches_packed(trans, fwd, bwd, False, cfg, _SplitButWhole())
    assert first_difference(split, whole) is None
    with pytest.raises(AssertionError, match="K6"):
        icp._weighted_matches_packed(trans, fwd, bwd, False, cfg)

    r, c = wave
    r.mx = _SplitButWhole()
    try:
        r.body(r.caps[0], False, c)
    finally:
        r.mx = icp._WHOLE
    with pytest.raises(AssertionError, match="K6"):
        r.body(r.caps[0], False, c)


def test_robust_shapes_survive_the_counter_round_trip():
    """`ROBUST_SHAPES` moves through `counts()` -> `counts_since()` ->
    `add_counts()` as the other logs do, and K6's two launch counters with
    it."""
    kernels.reset_launch_counts()
    before = kernels.counts()
    assert len(before) == 7 and before[6] == {}
    assert before[0]["robust_weights"] == before[0]["weighted_error"] == 0
    kernels.LAUNCHES["robust_weights"] += 2
    kernels.LAUNCHES["weighted_error"] += 2
    kernels.ROBUST_SHAPES[(512, 2048, 2048)] = 2
    delta = kernels.counts_since(before)
    assert delta == ({"robust_weights": 2, "weighted_error": 2}, {}, {}, {}, {}, {},
                     {(512, 2048, 2048): 2})
    kernels.add_counts(delta, -1)
    assert kernels.counts() == before
    kernels.add_counts(delta, 3)
    assert kernels.ROBUST_SHAPES == {(512, 2048, 2048): 6}
    kernels.reset_launch_counts()
    assert kernels.counts()[6] == {} and kernels.LAUNCHES["robust_weights"] == 0


def test_robust_bound_counts_each_byte_once():
    """K6's least times: a match's source columns 0-3 and target columns
    0-7 in whole 32-byte sectors of their rows (one each at stride 8 and
    16, more where a row straddles sectors), its mask byte, and its weight
    written (weights) or read (errors) once, at the streaming peak."""
    from lrr_tpu_torch.utils import sol

    for stride in (8, 16):
        ms, by = sol.robust_bound_ms(512, 2048, 1024, stride)
        nbytes = 512 * 3072 * (64 + 1 + 4) + 4 * 512 * 38
        assert by == "bytes" and ms == pytest.approx(nbytes / (sol.PEAK_HBM_GBS * 1e9) * 1e3)
        err, _ = sol.weighted_error_bound_ms(512, 2048, 1024, stride)
        nbytes = 512 * 3072 * (64 + 1 + 4) + 4 * 512 * 32
        assert err == pytest.approx(nbytes / (sol.PEAK_HBM_GBS * 1e9) * 1e3)
    assert sol.robust_bound_ms(512, 2048, 1024, 12)[0] > sol.robust_bound_ms(512, 2048, 1024,
                                                                               8)[0]

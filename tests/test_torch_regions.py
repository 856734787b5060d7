"""The port's watershed, region selection and the entry points that use
them, against lrr_tpu on the same inputs (CPU).

Inputs are numpy arrays from a seed or the committed small pair (its
phantom volumes are remade from the seed by each package's own `make_pair`
and come out equal).  The label tests run on lrr_tpu's own height array,
where the labels are defined exactly; the end-to-end segmentation is
compared as a partition, with the measured agreement stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from lrr_tpu.ops import watershed as jw
from lrr_tpu.pipeline import regions as jregions
from lrr_tpu.pipeline import registration as jreg
from lrr_tpu.types import FeatureSet as JFeatureSet
from lrr_tpu.verify import load_default_verifier as jload_svm
from lrr_tpu_torch.estimation import icp as ticp
from lrr_tpu_torch.ops import watershed as tw
from lrr_tpu_torch.pipeline import regions as tregions
from lrr_tpu_torch.pipeline import registration as treg
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm

KEY = jax.random.key(7)
REGION_TARGET = 120  # the small pair's 50 mm boxes hold ~340 features


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) diffusion and gradient
# ---------------------------------------------------------------------------


def _volumes():
    rng = np.random.default_rng(5)
    return {
        "phantom": np.asarray(tp.small_volumes()[0][0].data),
        "random_7x12x9": rng.uniform(0, 3, (7, 12, 9)).astype(np.float32),
        "slab_1x10x11": rng.uniform(0, 3, (1, 10, 11)).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["phantom", "random_7x12x9", "slab_1x10x11"])
def test_diffusion_and_gradient_match(name):
    """`exp` differs in the last ulp between the two: 1e-6 of the largest
    value after 10 iterations (measured 6e-8); the gradient of the same
    array likewise."""
    vol = _volumes()[name]
    want = np.asarray(jw.anisotropic_diffusion(jnp.asarray(vol)))
    got = tw.anisotropic_diffusion(_t(vol)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    g_want = np.asarray(jw.gradient_magnitude(jnp.asarray(want)))
    g_got = tw.gradient_magnitude(_t(want)).numpy()
    assert np.abs(g_got - g_want).max() <= 1e-6 * max(np.abs(g_want).max(), 1e-30)


# ---------------------------------------------------------------------------
# (b) labels on lrr_tpu's own height: exactly equal
# ---------------------------------------------------------------------------


def _phantom_height() -> np.ndarray:
    vol = tp.small_volumes()[0][0].data
    return np.asarray(jw.gradient_magnitude(jw.anisotropic_diffusion(vol)))


def _planted(name: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if name == "phantom":
        return _phantom_height()
    if name == "constant":
        return np.full((5, 6, 7), 2.5, np.float32)
    if name == "wide_plateau":
        # a U-shaped flat valley between walls: along row 0, down the last
        # column, back along row 2, 49 voxels end to end.  Labels fall
        # towards voxel 0 along the first arm and towards the far end along
        # the second (it runs against the flat index), so the two ends are
        # two basins and the sweeps decide where the second arm is cut: a
        # sweep carries the smaller label one voxel further round the bend
        h = np.full((1, 3, 24), 9.0, np.float32)
        h[0, 0, :] = h[0, 2, :] = h[0, 1, 23] = 8.0
        return h
    if name == "lattice_ties":
        return rng.integers(0, 4, (6, 7, 8)).astype(np.float32)
    if name == "slab_1xHxW":
        return rng.standard_normal((1, 9, 11)).astype(np.float32)
    if name == "border_minimum":
        h = rng.uniform(1, 2, (6, 6, 6)).astype(np.float32)
        h[0, 0, 0], h[5, 3, 5] = 0.0, 0.1
        return h
    if name == "random":
        return rng.standard_normal((6, 7, 8)).astype(np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("args", [(0.001, 0.10, 8), (0.0, 0.0, 8), (0.0, 0.0, 2)],
                         ids=["canonical", "no_flood", "two_sweeps"])
@pytest.mark.parametrize("name", ["phantom", "constant", "wide_plateau", "lattice_ties",
                                  "slab_1xHxW", "border_minimum", "random"])
def test_watershed_labels_equal_on_the_same_height(name, args):
    h = _planted(name)
    want = np.asarray(jw.watershed_labels(jnp.asarray(h), *args))
    got = tw.watershed_labels(_t(h), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_plateau_shows_the_sweep_count():
    """The planted valley is not merged whole: the basin of voxel 0 reaches
    as far round the bend as the sweeps carry it, so the count is part of
    the result."""
    h = _t(_planted("wide_plateau"))
    eight = tw.watershed_labels(h, 0.0, 0.0, 8)
    twelve = tw.watershed_labels(h, 0.0, 0.0, 12)
    assert sorted(torch.unique(eight).tolist()) == [0, 48]
    assert int((twelve == 0).sum()) > int((eight == 0).sum())


def test_preflood_level_is_fused_like_xla(monkeypatch):
    """level = hmin + frac * (hmax - hmin) as one rounding: heights where the
    two-rounding form gives another float32 still label equal."""
    rng = np.random.default_rng(0)
    differing = 0
    for _ in range(60):
        h = (rng.standard_normal((4, 5, 6)) * rng.uniform(0.1, 100)
             + rng.uniform(-5, 5)).astype(np.float32)
        hmin, hmax, m = h.min(), h.max(), np.float32(0.10)
        unfused = np.float32(hmin + np.float32(m * np.float32(hmax - hmin)))
        fused = np.float32(np.float64(hmin) + np.float64(m) * np.float64(np.float32(hmax - hmin)))
        differing += int(unfused != fused)
        got = tw._preflood(_t(h), 0.001, 0.10).numpy()
        assert got.min() == fused
        np.testing.assert_array_equal(
            tw.watershed_labels(_t(h)).numpy(), np.asarray(jw.watershed_labels(jnp.asarray(h))))
    assert differing >= 1, "no draw told the two forms apart"


def test_one_path_equals_lrr_tpu_large_path(monkeypatch):
    """lrr_tpu's large-volume machinery (composed shifts, slab rounds,
    compacted tables) is documented as exact; the port's one path equals it
    as it equals the plain path."""
    h = _phantom_height()
    plain = np.asarray(jw.watershed_labels(jnp.asarray(h)))
    monkeypatch.setattr(jw, "_ROOT_JUMP_MIN_VOXELS", 1)
    large = np.asarray(jw.watershed_labels(jnp.asarray(h)))
    got = tw.watershed_labels(_t(h)).numpy()
    np.testing.assert_array_equal(large, plain)
    np.testing.assert_array_equal(got, large)


def test_watershed_labels_refuses_tables_over_int32():
    with pytest.raises(ValueError):
        tw.watershed_labels(torch.empty((2**11, 2**10, 2**10), device="meta"))


# ---------------------------------------------------------------------------
# (c) the segmentation end to end, as a partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [0, 1], ids=["fixed", "moving"])
def test_watershed_segmentation_partition_agrees(side):
    """Each package from the volume, its own `exp` included.  Labels are
    basin-minimum flat indices, so equal partitions carry equal labels.
    Measured on this pair: 100 % of voxels and of features agree; the bars
    leave room for a descent that an ulp flips on another machine."""
    jvol, tvol = tp.small_volumes()[0][side], tp.small_volumes()[1][side]
    want = np.asarray(jw.watershed_segmentation(jvol.data))
    got = tw.watershed_segmentation(tvol.data).numpy()
    assert (got == want).mean() >= 0.995
    assert abs(len(np.unique(got)) - len(np.unique(want))) <= 2
    jctx, tctx = tp.small_region_contexts()
    jfs = (jctx.fixed_features, jctx.moving_features)[side]
    tfs = (tctx.fixed_features, tctx.moving_features)[side]
    f_want = np.asarray(jregions.feature_region_labels(
        jfs, jnp.asarray(want), jvol.origin, jvol.spacing))
    f_got = tregions.feature_region_labels(tfs, _t(got), tvol.origin, tvol.spacing).numpy()
    live = np.asarray(jfs.mask)
    assert (f_got == f_want)[live].mean() >= 0.99


# ---------------------------------------------------------------------------
# (d) region selection on lrr_tpu's labels
# ---------------------------------------------------------------------------


def _feature_sets(xyz: np.ndarray, mask: np.ndarray | None = None):
    n = xyz.shape[0]
    mask = np.ones(n, bool) if mask is None else mask
    jfs = JFeatureSet(
        xyz=jnp.asarray(xyz, jnp.float32), strength=jnp.ones(n), shape=jnp.zeros(n, jnp.int32),
        projector=jnp.zeros((n, 3, 3)), directions=jnp.zeros((n, 3, 3)), mask=jnp.asarray(mask))
    return jfs, tp.torch_features(jfs)


def _two_half_spaces(rng):
    labels = np.zeros((4, 4, 16), np.int32)
    labels[:, :, 8:] = 77
    xyz = np.concatenate([
        rng.uniform([0, 0, 0], [7.4, 3.9, 3.9], (30, 3)),
        rng.uniform([8, 0, 0], [15.4, 3.9, 3.9], (30, 3)),
    ]).astype(np.float32)
    return labels, xyz


# the cases of tests/test_regions.py: (target, box, expected near / far)
REGION_CASES = {
    "whole_regions": (10, None, (True, False)),
    "several_regions": (40, None, (True, True)),
    "box_restriction": (10, ([0.0, 0.0, 0.0], [7.5, 4.0, 4.0]), (True, False)),
    "box_exhaustion": (40, ([0.0, 0.0, 0.0], [7.5, 4.0, 4.0]), (True, False)),
}


@pytest.mark.parametrize("case", list(REGION_CASES))
def test_select_features_in_regions_matches(case):
    target, box, (near, far) = REGION_CASES[case]
    labels, xyz = _two_half_spaces(np.random.default_rng(0))
    jfs, tfs = _feature_sets(xyz)
    query = np.asarray([2.0, 2.0, 2.0], np.float32)
    jbox = {} if box is None else dict(box_lo=jnp.asarray(box[0]), box_hi=jnp.asarray(box[1]))
    tbox = {} if box is None else dict(box_lo=torch.tensor(box[0]), box_hi=torch.tensor(box[1]))
    want = np.asarray(jregions.select_features_in_regions(
        jfs, jnp.asarray(labels), jnp.zeros(3), jnp.ones(3), jnp.asarray(query), target, **jbox))
    got = tregions.select_features_in_regions(
        tfs, _t(labels), torch.zeros(3), torch.ones(3), _t(query), target, **tbox).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:30].all() == near and got[30:].any() == far
    by_labels = tregions.select_features_by_labels(
        tfs, tregions.compact_feature_labels(tfs, _t(labels), torch.zeros(3), torch.ones(3)),
        _t(query), target, **tbox).numpy()
    np.testing.assert_array_equal(by_labels, want)


def test_masked_features_are_ignored():
    rng = np.random.default_rng(1)
    labels = np.zeros((4, 4, 8), np.int32)
    mask = np.ones(20, bool)
    mask[10:] = False
    jfs, tfs = _feature_sets(rng.uniform(0, 4, (20, 3)).astype(np.float32), mask)
    query = np.asarray([2.0, 2.0, 2.0], np.float32)
    want = np.asarray(jregions.select_features_in_regions(
        jfs, jnp.asarray(labels), jnp.zeros(3), jnp.ones(3), jnp.asarray(query), 5))
    got = tregions.select_features_in_regions(
        tfs, _t(labels), torch.zeros(3), torch.ones(3), _t(query), 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[10:].any()


@pytest.mark.parametrize("side", ["moving", "fixed"])
def test_feature_labels_match_on_lrr_tpu_labels(side):
    """Nearest-voxel gather (half-to-even) and compaction, on lrr_tpu's
    label volume, with features planted on exact half-voxel ties; and the
    labels the context loader carried across are these."""
    jctx, tctx = tp.small_region_contexts()
    (jf, jm), _ = tp.small_volumes()
    jvol = jm if side == "moving" else jf
    jfs, tfs = getattr(jctx, side + "_features"), getattr(tctx, side + "_features")
    labels = jw.watershed_segmentation(jvol.data)
    xyz = np.asarray(jfs.xyz).copy()
    xyz[:12] = np.floor(xyz[:12]) + 0.5
    jfs, tfs = jfs.replace(xyz=jnp.asarray(xyz)), dataclasses.replace(tfs, xyz=_t(xyz))
    np.testing.assert_array_equal(
        tregions.feature_region_labels(
            tfs, _t(labels), _t(jvol.origin), _t(jvol.spacing)).numpy(),
        np.asarray(jregions.feature_region_labels(jfs, labels, jvol.origin, jvol.spacing)))
    want = np.asarray(jregions.compact_feature_labels(jfs, labels, jvol.origin, jvol.spacing))
    got = tregions.compact_feature_labels(tfs, _t(labels), _t(jvol.origin), _t(jvol.spacing))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    carried = getattr(tctx, side + "_region_labels")
    assert carried.dtype == torch.int32
    np.testing.assert_array_equal(
        carried.numpy(), np.asarray(getattr(jctx, side + "_region_labels")))


def _assert_equal_or_tie(got, want, features, labels, query, sel, target):
    """Selections equal, or differing only in regions whose distance to the
    query ties the threshold within 2 ulp (the port's distance and
    `jnp.linalg.norm` may round differently)."""
    if np.array_equal(got, want):
        return
    xyz = features.xyz.numpy()
    d = np.sqrt(((xyz - query) ** 2).sum(-1, dtype=np.float64))
    region_d = np.full(labels.max() + 1, np.inf)
    np.minimum.at(region_d, labels[sel], d[sel])
    tau = np.sort(np.where(sel, region_d[labels], np.inf))[min(target, len(d)) - 1]
    odd = region_d[labels[got != want]]
    assert np.all(np.abs(odd - tau) <= 4 * np.spacing(np.float32(tau))), (odd, tau)


@pytest.mark.parametrize("target", [40, REGION_TARGET, 5000])
@pytest.mark.parametrize("boxed", [True, False], ids=["box", "unbounded"])
def test_batched_select_features_by_labels_matches(target, boxed):
    """[L, N] lanes at once against lrr_tpu lane by lane, on the small
    pair's features and lrr_tpu's region ids."""
    jctx, tctx = tp.small_region_contexts()
    rng = np.random.default_rng(target)
    queries = rng.uniform(6, 26, (7, 3)).astype(np.float32)
    half = rng.uniform(8, 25, (7, 1)).astype(np.float32)
    lo, hi = queries - half, queries + half
    tbox = dict(box_lo=_t(lo), box_hi=_t(hi)) if boxed else {}
    got = tregions.select_features_by_labels(
        tctx.moving_features, tctx.moving_region_labels, _t(queries), target, **tbox).numpy()
    assert got.shape == (7, tctx.moving_features.capacity)
    labels = tctx.moving_region_labels.numpy()
    mask = tctx.moving_features.mask.numpy()
    xyz = tctx.moving_features.xyz.numpy()
    for i in range(7):
        jbox = dict(box_lo=jnp.asarray(lo[i]), box_hi=jnp.asarray(hi[i])) if boxed else {}
        want = np.asarray(jregions.select_features_by_labels(
            jctx.moving_features, jctx.moving_region_labels, jnp.asarray(queries[i]), target,
            **jbox))
        sel = mask & (((xyz >= lo[i]) & (xyz <= hi[i])).all(-1) if boxed else True)
        _assert_equal_or_tie(got[i], want, tctx.moving_features, labels, queries[i], sel, target)
        one = tregions.select_features_by_labels(
            tctx.moving_features, tctx.moving_region_labels, _t(queries[i]), target,
            **({k: v[i] for k, v in tbox.items()})).numpy()
        np.testing.assert_array_equal(one, got[i])


# ---------------------------------------------------------------------------
# (e)-(h) the entry points with regions
# ---------------------------------------------------------------------------


def _region_configs():
    """The small pair's configs with a region target below the box count,
    so that growth stops inside the boxes."""
    return tuple(
        dataclasses.replace(cfg, estimation=dataclasses.replace(
            cfg.estimation, target_region_features=REGION_TARGET))
        for cfg in tp.small_configs())


@pytest.fixture(scope="module")
def region_slice():
    """Both packages' contexts with the regions of their OWN `segment_pair`
    on their own volumes, lrr_tpu's candidates and region-grown masks, and
    the plan of lrr_tpu's draws."""
    jcfg, tcfg = _region_configs()
    jctx, tctx = tp.small_contexts()
    (jf, jm), (tf, tm) = tp.small_volumes()
    jctx, tctx = jreg.segment_pair(jm, jf, jctx), treg.segment_pair(tm, tf, tctx)
    queries = tp.small_queries()
    inits, m_sel, f_sel, usable = tp.jax_candidates(jctx, queries, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jctx=jctx, tctx=tctx, queries=queries, inits=inits,
                m_sel=m_sel, f_sel=f_sel, usable=usable,
                plan=tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg))


def test_segment_pair_attaches_lrr_tpu_regions(region_slice):
    S = region_slice
    for side in ("moving_region_labels", "fixed_region_labels"):
        got, want = getattr(S["tctx"], side), np.asarray(getattr(S["jctx"], side))
        assert got.dtype == torch.int32 and int(got.max()) + 1 >= 20
        np.testing.assert_array_equal(got.numpy(), want)


def test_candidate_rois_with_regions_match_per_lane(region_slice):
    S = region_slice
    Q, C = len(S["queries"]), S["jcfg"].indexing.num_candidates
    flat = tp.torch_affine(tp.stack_affines([S["inits"][q][c] for q in range(Q) for c in range(C)]))
    q_lanes = _t(np.repeat(S["queries"], C, axis=0))
    m_sel, f_sel, _, _, enough, _ = treg._candidate_rois(S["tctx"], flat, q_lanes, S["tcfg"])
    want_m = np.stack([S["m_sel"][q][c] for q in range(Q) for c in range(C)])
    want_f = np.stack([S["f_sel"][q][c] for q in range(Q) for c in range(C)])
    np.testing.assert_array_equal(m_sel.numpy(), want_m)
    np.testing.assert_array_equal(f_sel.numpy(), want_f)
    # regions cut the boxes here, and every lane still reaches the target
    box = dataclasses.replace(S["tctx"], moving_region_labels=None, fixed_region_labels=None)
    b_m, b_f, *_ = treg._candidate_rois(box, flat, q_lanes, S["tcfg"])
    assert bool((m_sel != b_m).any()) and bool((f_sel != b_f).any())
    assert not bool((m_sel & ~b_m).any()) and not bool((f_sel & ~b_f).any())
    assert bool((f_sel.sum(-1) >= REGION_TARGET).all()) and bool(enough.all())


def _assert_results_match(got, want, usable_pre, *, rank_over):
    sel = np.asarray(want.selected)
    assert (sel >= 0).sum() >= 2, "fixture should verify most queries"
    np.testing.assert_array_equal(got.selected.numpy(), sel)
    np.testing.assert_array_equal(got.verified.numpy(), np.asarray(want.verified))
    np.testing.assert_array_equal(got.refined.numpy(), np.asarray(want.refined))
    np.testing.assert_array_equal(got.enough_features.numpy(), np.asarray(want.enough_features))
    # ranks are compared over the candidates that carry a finite key
    for q in range(len(sel)):
        n = int(rank_over[q].sum())
        np.testing.assert_array_equal(got.rank[q, :n].numpy(), np.asarray(want.rank)[q, :n])
    np.testing.assert_allclose(got.initial_angle.numpy()[usable_pre],
                               np.asarray(want.initial_angle)[usable_pre], rtol=1e-4, atol=1e-5)
    for q in np.nonzero(sel >= 0)[0]:
        for g, w in ((got.trans.A, want.trans.A), (got.trans.t, want.trans.t)):
            g, w = g[q, sel[q]].numpy(), np.asarray(w)[q, sel[q]]
            assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()


def test_staged_with_regions_matches_lrr_tpu(region_slice):
    """The slice as a whole, regions attached: `selected`, `verified`,
    `refined` and `rank` equal, the selected transforms within the 0.5 % of
    tests/test_torch_slice.py."""
    S = region_slice
    want = jreg.register_locations_staged(
        S["jctx"], jnp.asarray(S["queries"]), S["jcfg"], jload_svm(), KEY)
    got = treg.register_locations_staged(
        S["tctx"], _t(S["queries"]), S["tcfg"], tload_svm(), S["plan"])
    usable = np.asarray(want.candidate_mask & want.enough_features)
    _assert_results_match(got, want, usable, rank_over=usable)


def test_refine_all_matches_lrr_tpu(region_slice):
    """`register_locations` (every candidate refined) on the same plan: the
    same equalities, ranks over the candidates still usable after
    refinement; and `register_location` is its one-query form."""
    S = region_slice
    want = jreg.register_locations(S["jctx"], jnp.asarray(S["queries"]), S["jcfg"], jload_svm(), KEY)
    got = treg.register_locations(S["tctx"], _t(S["queries"]), S["tcfg"], tload_svm(), S["plan"])
    assert bool(got.refined.all())
    pre = np.asarray(want.candidate_mask & want.enough_features)
    post = pre & np.asarray(want.valid) & ~np.asarray(want.oscillated)
    np.testing.assert_array_equal(got.valid.numpy()[pre], np.asarray(want.valid)[pre])
    np.testing.assert_array_equal(got.oscillated.numpy()[pre], np.asarray(want.oscillated)[pre])
    _assert_results_match(got, want, pre, rank_over=post)

    staged = treg.register_locations_staged(
        S["tctx"], _t(S["queries"]), S["tcfg"], tload_svm(), S["plan"])
    both = (staged.selected >= 0) & (got.selected >= 0)
    assert torch.equal(staged.selected[both], got.selected[both])

    q = 1
    qkey = jax.random.split(KEY, len(S["queries"]))[q]
    plan1 = tp.plan_from_query_key(qkey, S["m_sel"][q], S["f_sel"][q], S["jcfg"])
    one = treg.register_location(S["tctx"], _t(S["queries"][q]), S["tcfg"], tload_svm(), plan1)
    assert one.selected.dim() == 0 and int(one.selected) == int(got.selected[q])
    assert one.verified.shape == got.verified.shape[1:]
    np.testing.assert_array_equal(one.verified.numpy(), got.verified[q].numpy())
    np.testing.assert_allclose(one.trans.A.numpy(), got.trans.A[q].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rank_key", [None, "angle"])
def test_rank_key_matches(region_slice, monkeypatch, rank_key):
    """PASS 1's key for every candidate of one query: the angle plus the
    median residual, or with LRR_RANK_KEY=angle the reference's pure angle
    (radians)."""
    if rank_key is None:
        monkeypatch.delenv("LRR_RANK_KEY", raising=False)
    else:
        monkeypatch.setenv("LRR_RANK_KEY", rank_key)
    S = region_slice
    q, C = 0, S["jcfg"].indexing.num_candidates
    ckeys = jax.random.split(jax.random.split(KEY, len(S["queries"]))[q], C)
    want = []
    for c in range(C):
        k0, k0b, _, _ = jax.random.split(ckeys[c], 4)
        want.append(float(jreg._candidate_initial_angle(
            S["jctx"], S["inits"][q][c], jnp.asarray(S["m_sel"][q][c]), S["jcfg"], k0, k0b)))
    lanes = S["plan"].select(torch.full((C,), q), torch.arange(C))
    got = treg._candidate_initial_angle(
        S["tctx"], tp.torch_affine(tp.stack_affines(S["inits"][q])),
        _t(np.stack(S["m_sel"][q])), S["tcfg"], lanes.rank_scores, lanes.rank_offset).numpy()
    use = np.asarray(S["usable"][q])
    np.testing.assert_allclose(got[use], np.asarray(want)[use], rtol=1e-4, atol=1e-5)
    if rank_key == "angle":
        assert np.all(got[use] <= np.pi / 2 + 1e-6)


def test_serving_never_bakes_a_grid(region_slice, monkeypatch):
    """Staged serving and refine-all match through the bare index maps: with
    `icp.bake_target_grid` (the JAX package's NN-row bake) made to raise,
    both serve and give the bits of the unpatched runs."""
    S = region_slice
    args = (S["tctx"], _t(S["queries"]), S["tcfg"], tload_svm(), S["plan"])
    staged = treg.register_locations_staged(*args)
    every = treg.register_locations(*args)

    def refuse(*_):
        raise AssertionError("a grid was baked")

    monkeypatch.setattr(ticp, "bake_target_grid", refuse)
    for want, got in ((staged, treg.register_locations_staged(*args)),
                      (every, treg.register_locations(*args))):
        for name in ("selected", "verified", "probability", "measurements", "covar", "rank"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(got.trans.A, want.trans.A) and torch.equal(got.trans.t, want.trans.t)

"""The port's CUDA kernels, its stage 1, its regions and its entry points on
the card.

Every test here needs a CUDA GPU and skips without one.  The file imports
neither JAX nor lrr_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lrr_tpu_torch.config import (
    DescriptorConfig, FeatureConfig, KeypointConfig, pipeline_config_from_dict,
)
from lrr_tpu_torch.features.extract import detect_features, extract_keypoints
from lrr_tpu_torch.ops import contrast, filters, kernels, resample, voronoi
from lrr_tpu_torch.ops.descriptors import compute_descriptors
from lrr_tpu_torch.ops.sparsify import sparsify_mask
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.pipeline.registration import prepare_pair, register_locations_staged
from lrr_tpu_torch.sampling import draw_sampling_plan
from lrr_tpu_torch.utils.synthetic import make_pair
from lrr_tpu_torch.verify.svm import load_default_verifier

K1_TOL = 2e-5  # x the largest entry: fp32 sums in another order
SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_pair_small")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _k1_direction(rng, L, M, dev, pad=0):
    """(from, to, dir, tag, w) of one direction in world coordinates; with
    `pad` the tensors are views of buffers `pad` matches longer."""
    d = rng.standard_normal((L, 3, M + pad))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.uniform(-0.2, 2, (L, M + pad))
    w[:, ::7] = 0.0
    arrays = [rng.uniform(-40, 40, (L, 3, M + pad)), rng.uniform(-40, 40, (L, 3, M + pad)), d,
              rng.integers(0, 4, (L, M + pad)).astype(np.float64), w]
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)[..., :M] for a in arrays)


def _k1_frame(rng, L, dev):
    arrays = [rng.uniform(-5, 5, (L, 3)), rng.uniform(-5, 5, (L, 3)), rng.uniform(20, 30, L),
              rng.uniform(20, 30, L), rng.uniform(-0.1, 0.1, (L, 3))]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def _as_row_views(direction):
    """The same values as views of [L, M, 8] rows, as the ICP's gathers give."""
    fx, ty, d, tag, w = direction
    rows_a = torch.cat([fx, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
    rows_b = torch.cat([ty, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
    va, vb = rows_a.permute(0, 2, 1), rows_b.permute(0, 2, 1)
    return va[:, 0:3], vb[:, 0:3], va[:, 4:7], vb[:, 7], w


def _assert_k1_matches_plain(fwd, bwd, frame):
    n0 = kernels.LAUNCHES["normal_equations"]
    ata, atb = kernels.normal_equations_sym(fwd, bwd, *frame)
    assert kernels.LAUNCHES["normal_equations"] == n0 + 1
    ata_p, atb_p = kernels.normal_equations_sym_plain(fwd, bwd, *frame)
    assert float((ata - ata_p).abs().max()) <= K1_TOL * float(ata_p.abs().max()) + 1e-30
    assert float((atb - atb_p).abs().max()) <= K1_TOL * float(atb_p.abs().max()) + 1e-30
    assert torch.equal(ata, ata.transpose(1, 2))
    ata2, atb2 = kernels.normal_equations_sym(fwd, bwd, *frame)
    assert torch.equal(ata, ata2) and torch.equal(atb, atb2)  # fixed order: same bits


@pytest.mark.gpu
@pytest.mark.parametrize("L,M", [(1, 500), (128, 4096), (3, 1)])
def test_normal_equations_kernel_matches_plain(cuda, L, M):
    rng = np.random.default_rng(L)
    _assert_k1_matches_plain(_k1_direction(rng, L, M, cuda), _k1_direction(rng, L, M, cuda),
                             _k1_frame(rng, L, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "L,m_f,m_b", [(64, 1024, 1024), (64, 4096, 2048), (1, 500, 400), (5, 1023, 77), (2, 64, 0)]
)
def test_normal_equations_sym_kernel_shapes(cuda, L, m_f, m_b):
    """The main path's levels, unequal directions, a ragged M (the match-by-
    match path: rows are not 16-byte aligned) and an empty direction."""
    rng = np.random.default_rng(m_f)
    _assert_k1_matches_plain(_k1_direction(rng, L, m_f, cuda), _k1_direction(rng, L, m_b, cuda),
                             _k1_frame(rng, L, cuda))


@pytest.mark.gpu
def test_normal_equations_sym_kernel_ragged_tail_of_aligned_rows(cuda):
    """Aligned rows with M % 4 != 0 (views of longer buffers): the float4
    path with its tail read match by match."""
    rng = np.random.default_rng(3)
    _assert_k1_matches_plain(_k1_direction(rng, 4, 1021, cuda, pad=3),
                             _k1_direction(rng, 4, 510, cuda, pad=2), _k1_frame(rng, 4, cuda))


@pytest.mark.gpu
def test_normal_equations_sym_kernel_reads_row_views(cuda):
    rng = np.random.default_rng(4)
    fwd, bwd = _k1_direction(rng, 8, 1024, cuda), _k1_direction(rng, 8, 640, cuda)
    frame = _k1_frame(rng, 8, cuda)
    _assert_k1_matches_plain(_as_row_views(fwd), _as_row_views(bwd), frame)
    got = kernels.normal_equations_sym(_as_row_views(fwd), _as_row_views(bwd), *frame)
    want = kernels.normal_equations_sym(fwd, bwd, *frame)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= K1_TOL * float(w.abs().max())


@pytest.mark.gpu
def test_normal_equations_sym_kernel_refuses_bad_inputs(cuda):
    rng = np.random.default_rng(5)
    fwd, bwd = _k1_direction(rng, 2, 64, cuda), _k1_direction(rng, 2, 64, cuda)
    frame = _k1_frame(rng, 2, cuda)
    with pytest.raises(ValueError):  # a tensor on the CPU among CUDA ones
        kernels.normal_equations_sym((fwd[0].cpu(), *fwd[1:]), bwd, *frame)
    with pytest.raises(ValueError):  # wrong dtype
        kernels.normal_equations_sym((fwd[0].double(), *fwd[1:]), bwd, *frame)
    with pytest.raises(ValueError):  # wrong shape
        kernels.normal_equations_sym((fwd[0][:, :2], *fwd[1:]), bwd, *frame)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "q_n,p_n,k",
    [(37, 129, 1), (200, 700, 20), (128, 128, 1), (50, 300, 128), (9, 5, 8),
     # wide tiles with split points; N not a multiple of the tile or the split
     (1100, 1190, 1), (1100, 1190, 20), (1030, 1100, 70)],
)
def test_knn_kernel_matches_plain(cuda, q_n, p_n, k):
    rng = np.random.default_rng(q_n)
    q = torch.tensor(rng.standard_normal((q_n, 195)), dtype=torch.float32, device=cuda)
    p = torch.tensor(rng.standard_normal((p_n, 195)), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.uniform(size=p_n) > 0.15, device=cuda)
    n0 = kernels.LAUNCHES["knn"]
    d, i = kernels.knn(q, p, mask, k)
    assert kernels.LAUNCHES["knn"] == n0 + 1
    d_p, i_p = kernels.knn_plain(q, p, mask, k)
    live = torch.isfinite(d_p)
    # same arithmetic in the same order: equal bits, so equal tie order
    assert torch.equal(d, d_p)
    assert torch.equal(i[live].long(), i_p[live].long())


@pytest.mark.gpu
def test_knn_kernel_all_masked_and_ties(cuda):
    p = torch.zeros((70, 16), device=cuda)
    p[3] = 1.0
    mask = torch.ones(70, dtype=torch.bool, device=cuda)
    mask[0] = False
    d, i = kernels.knn(torch.zeros((2, 16), device=cuda), p, mask, 3)
    assert i.tolist() == [[1, 2, 4], [1, 2, 4]]
    d, _ = kernels.knn(torch.zeros((2, 16), device=cuda), p, torch.zeros_like(mask), 3)
    assert bool(torch.isinf(d).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("q_n,p_n", [(4, 100), (1100, 1200)])
def test_knn_kernel_ties_across_a_split_boundary(cuda, q_n, p_n, k):
    """Equal distances on both sides of a tile and split boundary go to the
    lower index, through the narrow (16-point) and wide (64-point) tiles."""
    p = torch.ones((p_n, 195), device=cuda)
    same = [5, 15, 16, 63, 64, 65, p_n - 1]  # straddle the 16- and 64-point boundaries
    p[same] = 0.0
    mask = torch.ones(p_n, dtype=torch.bool, device=cuda)
    mask[5] = False
    _, splits = kernels.knn_plan(q_n, p_n, 195, k, cuda)
    assert splits > 1
    d, i = kernels.knn(torch.zeros((q_n, 195), device=cuda), p, mask, k)
    assert i.tolist() == [[15, 16, 63][:k]] * q_n
    assert not d.any()
    d_p, i_p = kernels.knn_plain(torch.zeros((q_n, 195), device=cuda), p, mask, k)
    assert torch.equal(i, i_p) and torch.equal(d, d_p)


@pytest.mark.gpu
def test_slice_on_gpu_matches_cpu(cuda):
    """The same plan through the port on the CPU (plain versions) and on the
    card (kernels): the same selections and verified candidates."""
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    queries = torch.tensor(meta["queries"], dtype=torch.float32)
    svm = load_default_verifier()
    ctx_c = load_pair_context(SMALL + ".npz", "cpu")
    plan = draw_sampling_plan(torch.Generator().manual_seed(0), len(queries), cfg,
                              ctx_c.moving_features.capacity, ctx_c.fixed_features.capacity)
    want = register_locations_staged(ctx_c, queries, cfg, svm, plan)
    n0 = dict(kernels.LAUNCHES)
    ctx_g = load_pair_context(SMALL + ".npz", cuda)
    plan_g = type(plan)(**{k: v.to(cuda) for k, v in vars(plan).items()})
    got = register_locations_staged(ctx_g, queries.to(cuda), cfg, svm, plan_g)
    assert kernels.LAUNCHES["knn"] > n0["knn"]
    assert kernels.LAUNCHES["normal_equations"] > n0["normal_equations"]
    assert torch.equal(got.selected.cpu(), want.selected)
    assert torch.equal(got.verified.cpu(), want.verified)
    sel = want.selected
    for q in range(len(queries)):
        if int(sel[q]) >= 0:
            a, b = got.trans.A[q, sel[q]].cpu(), want.trans.A[q, sel[q]]
            assert float((a - b).abs().max()) <= 5e-3 * float(b.abs().max())


# ---------------------------------------------------------------------------
# stage 1 on the card: against the CPU, run to run, and on planted ties
# ---------------------------------------------------------------------------

STAGE1_FEATURES = FeatureConfig(max_features=4096, contrast_radius_mm=6.0)


def _dense_pair(device):
    return make_pair((48, 44, 40), rotation_deg=5.0, translation=(1.0, -1.0, 0.5), seed=4,
                     noise=0.5, dense=True, device=device)


def _fields_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()) for f in vars(a))


@pytest.mark.gpu
def test_dense_stages_on_gpu_match_cpu(cuda):
    """Filters, trilinear sampling and contrast filtering on the card
    against the CPU on the same volume: values to 1e-5 of the scale (the
    card fuses multiply-adds), the contrast mask but for a handful of
    voxels at their threshold."""
    fixed_c, _, _ = _dense_pair("cpu")
    vol = fixed_c.data
    grad_c = filters.gaussian_gradient(vol, (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    grad_g = filters.gaussian_gradient(vol.to(cuda), (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    scale = float(grad_c.abs().max())
    assert float((grad_g.cpu() - grad_c).abs().max()) <= 1e-5 * scale
    pts = torch.tensor(np.random.default_rng(0).uniform(-1, 45, (500, 3)), dtype=torch.float32)
    val_c, in_c = resample.sample_trilinear(grad_c, pts)
    val_g, in_g = resample.sample_trilinear(grad_c.to(cuda), pts.to(cuda))
    assert torch.equal(in_g.cpu(), in_c)
    assert float((val_g.cpu() - val_c).abs().max()) <= 1e-5 * scale
    score = filters.box_mean((grad_c * grad_c).sum(-1), 1)
    ones = torch.ones_like(score, dtype=torch.bool)
    keep_c = contrast.contrast_keep_mask(score, ones, 6)
    keep_g = contrast.contrast_keep_mask(score.to(cuda), ones.to(cuda), 6)
    assert 0.05 < float(keep_c.float().mean()) < 0.95
    assert torch.equal(keep_g.cpu(), keep_c)  # the same input: sorts and comparisons only


@pytest.mark.gpu
def test_stage1_on_gpu_matches_cpu(cuda):
    """`prepare_pair` on the card against the CPU on the same pair: at least
    99 % of the features within 1e-3 mm and of the same class, both ways;
    K2 launched once inside it."""
    cfg = pipeline_config_from_dict(json.load(open(SMALL + ".json"))["config"])
    fixed_c, moving_c, _ = _dense_pair("cpu")
    want = prepare_pair(moving_c, fixed_c, cfg)
    n0 = kernels.LAUNCHES["knn"]
    got = prepare_pair(moving_c.to(cuda), fixed_c.to(cuda), cfg)
    assert kernels.LAUNCHES["knn"] == n0 + 1
    assert got.device.type == "cuda"
    for side in ("moving_features", "fixed_features"):
        a, b = getattr(got, side).to("cpu"), getattr(want, side)
        assert abs(int(a.count()) - int(b.count())) <= 0.01 * int(b.count())
        for x, y in ((a, b), (b, a)):
            d = torch.cdist(x.xyz[x.mask].double(), y.xyz[y.mask].double())
            dmin, j = d.min(1)
            ok = (dmin <= 1e-3) & (x.shape[x.mask] == y.shape[y.mask][j])
            assert float(ok.float().mean()) >= 0.99
    assert tuple(got.fixed_vor.index_vol.shape) == tuple(want.fixed_vor.index_vol.shape)


@pytest.mark.gpu
def test_stage1_is_bit_identical_run_to_run(cuda):
    """`detect_features`, `compute_descriptors` and both exact Voronoi
    builds twice on the card: the same bits."""
    fixed, _, _ = _dense_pair(cuda)
    fs = detect_features(fixed, STAGE1_FEATURES)
    assert int(fs.count()) > 500
    assert _fields_equal(fs, detect_features(fixed, STAGE1_FEATURES))
    kp = extract_keypoints(fs, KeypointConfig(max_keypoints=64))
    dcfg = DescriptorConfig(min_neighbors=20, max_neighbors=256)
    ds = compute_descriptors(kp, fs, dcfg)
    assert int(ds.keypoints.count()) > 5
    again = compute_descriptors(kp, fs, dcfg)
    assert torch.equal(ds.descriptors, again.descriptors)
    assert _fields_equal(ds.keypoints, again.keypoints)
    origin = torch.tensor([-1.7300001, 2.9333334, 0.1234567], device=cuda)
    spacing = torch.full((3,), 0.7, device=cuda)
    args = (fs.xyz, fs.mask, origin, spacing, (64, 64, 64))
    plain = voronoi.voronoi_map_exact(*args)
    assert torch.equal(plain, voronoi.voronoi_map_exact(*args))
    for block in (32, 16):
        assert torch.equal(plain, voronoi.voronoi_map_exact_blocked(*args, block=block))
    # and the CPU builds the same map but for last-bit ties
    cpu = voronoi.voronoi_map_exact(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    assert float((plain.cpu() != cpu).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_voronoi_ties_go_to_the_lowest_index_on_gpu(cuda):
    """An integer lattice of features in shuffled order: voxels half-way
    between features see exactly equal distances, and `torch.min` on the card
    must return the lowest index, as on the CPU, in the arg-min of all three map builds."""
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(*[np.arange(0.0, 60.0, 6.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = torch.tensor(rng.permutation(g), dtype=torch.float32)
    mask = torch.tensor(rng.uniform(size=len(pts)) > 0.2)
    origin, spacing, shape = torch.zeros(3), torch.ones(3), (64, 64, 64)
    want = voronoi.voronoi_map_exact(pts, mask, origin, spacing, shape)
    args = (pts.to(cuda), mask.to(cuda), origin.to(cuda), spacing.to(cuda), shape)
    assert torch.equal(voronoi.voronoi_map_exact(*args).cpu(), want)
    assert torch.equal(voronoi.voronoi_map_exact_blocked(*args).cpu(), want)
    assert torch.equal(voronoi.voronoi_map_exact_blocked(*args, block=16).cpu(), want)
    jfa_c = voronoi.voronoi_map(pts, mask, origin, spacing, shape)
    assert torch.equal(voronoi.voronoi_map(*args).cpu(), jfa_c)


def _k4_case(name, cuda):
    """(xyz, mask, origin, spacing, shape) on the card for K4's cases."""
    rng = np.random.default_rng(7)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=cuda)
    if name == "phantom_odd_origin":  # test_stage1_is_bit_identical_run_to_run's map
        fixed, _, _ = _dense_pair(cuda)
        fs = detect_features(fixed, STAGE1_FEATURES)
        return (fs.xyz, fs.mask, t([-1.7300001, 2.9333334, 0.1234567]), t([0.7] * 3),
                (64, 64, 64))
    if name == "tie_lattice":  # test_voronoi_ties_go_to_the_lowest_index_on_gpu's lattice
        rng = np.random.default_rng(11)
        g = np.stack(np.meshgrid(*[np.arange(0.0, 60.0, 6.0)] * 3, indexing="ij"), -1)
        pts = rng.permutation(g.reshape(-1, 3))
        return t(pts), t(rng.uniform(size=len(pts)) > 0.2, torch.bool), t([0.0] * 3), \
            t([1.0] * 3), (64, 64, 64)
    pts = rng.uniform(0, 50, (900, 3))
    mask = rng.uniform(size=900) > 0.2
    if name == "ragged":
        return t(pts), t(mask, torch.bool), t([-2.0, 1.0, 0.5]), t([0.9, 1.1, 1.3]), (37, 50, 21)
    if name == "ragged_thin":
        return t(pts), t(mask, torch.bool), t([3.0, -4.0, 9.0]), t([1.0] * 3), (1, 17, 70)
    if name == "all_masked":
        return t(pts), t(np.zeros(900, bool), torch.bool), t([0.0] * 3), t([1.0] * 3), (40, 33, 48)
    if name == "z_slab":  # rank 1 of 2 of a 64-deep map: build_feature_voronoi's slab origin
        origin, spacing = t([-2.0, 1.0, 0.5]), t([1.0] * 3)
        origin = origin + torch.tensor([0.0, 0.0, 1.0], device=cuda) * (32 * spacing[2] * 1)
        return t(pts), t(mask, torch.bool), origin, spacing, (32, 64, 48)
    raise KeyError(name)


K4_CASES = ["phantom_odd_origin", "tie_lattice", "ragged", "ragged_thin", "all_masked", "z_slab"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", K4_CASES)
def test_voronoi_kernel_equals_the_plain_builds(cuda, name):
    """K4 against the card's brute force bit for bit (and the blocked build
    where the shape is a multiple of its 16-voxel block), two runs alike."""
    args = _k4_case(name, cuda)
    want = voronoi.voronoi_map_exact(*args)
    got = kernels.voronoi_nearest(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == args[4]
    assert torch.equal(got, want)
    assert torch.equal(kernels.voronoi_nearest(*args), got)
    if all(n % 16 == 0 for n in args[4]):
        assert torch.equal(voronoi.voronoi_map_exact_blocked(*args, block=16), got)
    if name == "all_masked":
        assert bool((got == -1).all())
    else:
        assert bool(args[1][got[got >= 0].long()].all())


@pytest.mark.gpu
def test_voronoi_kernel_at_copd512_size_equals_the_blocked_build(cuda):
    """A copd512-sized map: 65,536 features (15 % masked) in an ellipsoid,
    a 352 x 352 x 320 box at 1 mm with empty corners; K4 against the
    card's blocked build, bit for bit, and K4's pair count."""
    rng = np.random.default_rng(512)
    u = rng.standard_normal((65536, 3))
    u *= (rng.uniform(size=(65536, 1)) ** (1 / 3)) / np.linalg.norm(u, axis=1, keepdims=True)
    pts = torch.tensor(u * [160.0, 160.0, 150.0] + [175.0, 175.0, 158.0], dtype=torch.float32,
                       device=cuda)
    mask = torch.tensor(rng.uniform(size=65536) > 0.15, device=cuda)
    args = (pts, mask, torch.zeros(3, device=cuda), torch.ones(3, device=cuda), (320, 352, 352))
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = kernels.voronoi_nearest(*args, stats=stats)
    assert torch.equal(got, voronoi.voronoi_map_exact_blocked(*args))
    pairs, kept = (int(v) for v in stats.cpu())
    assert 320 * 352 * 352 <= pairs and 0 < kept


@pytest.mark.gpu
def test_voronoi_kernel_refuses_bad_inputs(cuda):
    xyz = torch.rand(50, 3, device=cuda)
    mask = torch.ones(50, dtype=torch.bool, device=cuda)
    o, s = torch.zeros(3, device=cuda), torch.ones(3, device=cuda)
    for bad in ((xyz.double(), mask, o, s), (xyz.t().contiguous().t(), mask, o, s),
                (xyz, mask, o.cpu(), s), (xyz, mask.float(), o, s), (xyz[:, :2], mask, o, s)):
        with pytest.raises(ValueError):
            kernels.voronoi_nearest(*bad, (8, 8, 8))
    with pytest.raises(ValueError):
        kernels.voronoi_nearest(xyz, mask, o, s, (8, 0, 8))


@pytest.mark.gpu
def test_build_feature_voronoi_is_one_kernel_launch_a_map_on_the_card(cuda, monkeypatch):
    """Every exact map on the card is one K4 launch, whichever plain build
    its size would pick on the CPU: no plain build runs; the map equals the
    card's brute force."""
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(0, 60, (400, 3)), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.uniform(size=400) > 0.1, device=cuda)
    exact = voronoi.voronoi_map_exact

    def refuse(*a, **k):
        raise AssertionError("a plain exact build ran on the card")

    monkeypatch.setattr(voronoi, "voronoi_map_exact", refuse)
    monkeypatch.setattr(voronoi, "voronoi_map_exact_blocked", refuse)
    for blocked_min in (1 << 22, 1):
        monkeypatch.setattr(voronoi, "_BLOCKED_MIN_VOXELS", blocked_min)
        before = kernels.counts()
        vol, origin, spacing = voronoi.build_feature_voronoi(pts, mask)
        launches, shapes = (kernels.counts_since(before)[i] for i in (0, 4))
        assert launches == {"voronoi": 1} and shapes == {(*vol.shape, 400): 1}
        assert torch.equal(vol, exact(pts, mask, origin, spacing, tuple(vol.shape)))


@pytest.mark.gpu
def test_prepare_pair_on_the_card_builds_both_maps_with_k4(cuda, monkeypatch):
    """`prepare_pair` on the card: two K4 launches, one a map, and neither
    plain exact build."""
    cfg = pipeline_config_from_dict(json.load(open(SMALL + ".json"))["config"])
    fixed, moving, _ = _dense_pair(cuda)

    def refuse(*a, **k):
        raise AssertionError("a plain exact build ran on the card")

    monkeypatch.setattr(voronoi, "voronoi_map_exact", refuse)
    monkeypatch.setattr(voronoi, "voronoi_map_exact_blocked", refuse)
    n0 = kernels.LAUNCHES["voronoi"]
    ctx = prepare_pair(moving, fixed, cfg)
    assert kernels.LAUNCHES["voronoi"] == n0 + 2
    assert ctx.fixed_vor.index_vol.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("min_distance", [2.0, 6.0])
def test_sparsify_ties_on_gpu(cuda, min_distance):
    """Equal strengths and lattice distances exactly at the radius: the keep
    set on the card is the CPU's (stable sort, strict comparison)."""
    rng = np.random.default_rng(7)
    g = np.stack(np.meshgrid(*[np.arange(9.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    xyz = torch.tensor(np.concatenate([g, rng.uniform(0, 8, (600, 3))]), dtype=torch.float32)
    strength = torch.tensor(rng.integers(0, 3, len(xyz)), dtype=torch.float32)
    mask = torch.tensor(rng.uniform(size=len(xyz)) > 0.1)
    want = sparsify_mask(xyz, strength, mask, min_distance)
    got = sparsify_mask(xyz.to(cuda), strength.to(cuda), mask.to(cuda), min_distance)
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 3


@pytest.mark.gpu
def test_topk_ties_on_gpu(cuda):
    """Keypoint selection with few distinct strengths: the card's stable
    descending sort gives the CPU's rows in the CPU's order."""
    from lrr_tpu_torch.types import FeatureSet

    rng = np.random.default_rng(8)
    n = 3000
    fs = FeatureSet(
        xyz=torch.tensor(rng.uniform(0, 60, (n, 3)), dtype=torch.float32),
        strength=torch.tensor(rng.integers(1, 5, n), dtype=torch.float32),
        shape=torch.tensor(rng.integers(0, 3, n), dtype=torch.int32),
        projector=torch.zeros((n, 3, 3)), directions=torch.tensor(rng.standard_normal((n, 3, 3)),
                                                                  dtype=torch.float32),
        mask=torch.tensor(rng.uniform(size=n) > 0.2),
    )
    want = extract_keypoints(fs, KeypointConfig(max_keypoints=128))
    got = extract_keypoints(fs.to(cuda), KeypointConfig(max_keypoints=128))
    assert _fields_equal(got, want) and int(want.count()) == 128


# ---------------------------------------------------------------------------
# watershed regions and the entry points built on them
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_watershed_labels_on_gpu_equal_cpu(cuda):
    """On one height array the labels are defined exactly: the card gives
    the CPU's, on the phantom and on a lattice of tied heights; the
    diffusion and gradient agree to 1e-6 of the largest value."""
    from lrr_tpu_torch.ops import watershed

    fixed, _, _ = _dense_pair("cpu")
    smooth = watershed.anisotropic_diffusion(fixed.data)
    smooth_g = watershed.anisotropic_diffusion(fixed.data.to(cuda))
    assert float((smooth_g.cpu() - smooth).abs().max()) <= 1e-6 * float(smooth.abs().max())
    height = watershed.gradient_magnitude(smooth)
    height_g = watershed.gradient_magnitude(smooth.to(cuda))
    assert float((height_g.cpu() - height).abs().max()) <= 1e-6 * float(height.abs().max())
    ties = torch.tensor(np.random.default_rng(2).integers(0, 4, (12, 9, 14)), dtype=torch.float32)
    for h, args in ((height, ()), (height, (0.0, 0.0, 3)), (ties, (0.0, 0.0, 8)), (ties, ())):
        want = watershed.watershed_labels(h, *args)
        got = watershed.watershed_labels(h.to(cuda), *args)
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    assert len(torch.unique(want)) > 1


@pytest.mark.gpu
def test_segmentation_and_region_selection_are_bit_identical_run_to_run(cuda):
    """`watershed_segmentation` twice on the card, then the batched region
    selection twice: the same bits; the selection also equals the CPU's on
    the same labels."""
    from lrr_tpu_torch.ops import watershed
    from lrr_tpu_torch.pipeline import regions

    fixed, _, _ = _dense_pair(cuda)
    labels = watershed.watershed_segmentation(fixed.data)
    assert torch.equal(labels, watershed.watershed_segmentation(fixed.data))
    fs = detect_features(fixed, STAGE1_FEATURES)
    feat = regions.compact_feature_labels(fs, labels, fixed.origin, fixed.spacing)
    assert torch.equal(
        feat, regions.compact_feature_labels(fs, labels, fixed.origin, fixed.spacing))
    assert int(feat.max()) + 1 >= 20
    rng = np.random.default_rng(3)
    queries = torch.tensor(rng.uniform(10, 34, (33, 3)), dtype=torch.float32, device=cuda)
    lo, hi = queries - 12.0, queries + 12.0
    for target in (50, 400, 100000):
        got = regions.select_features_by_labels(fs, feat, queries, target, box_lo=lo, box_hi=hi)
        again = regions.select_features_by_labels(fs, feat, queries, target, box_lo=lo, box_hi=hi)
        assert torch.equal(got, again)
        want = regions.select_features_by_labels(
            fs.to("cpu"), feat.cpu(), queries.cpu(), target, box_lo=lo.cpu(), box_hi=hi.cpu())
        assert torch.equal(got.cpu(), want)
        assert bool(got.any(-1).all())


@pytest.mark.gpu
def test_region_entry_points_on_gpu(cuda):
    """On the card: `segment_pair` attaches the CPU's region ids; the staged
    run and the refine-all run select the same candidates; the rigid
    refinement gives a rotation; the replay calls back once an iteration."""
    import dataclasses

    from lrr_tpu_torch.pipeline import registration

    with open(SMALL + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    cfg = dataclasses.replace(cfg, estimation=dataclasses.replace(
        cfg.estimation, target_region_features=120))
    pair = meta["pair"]
    fixed, moving, _ = make_pair(
        tuple(pair["shape_zyx"]), rotation_deg=pair["rotation_deg"],
        translation=tuple(pair["translation"]), seed=pair["seed"], device=cuda)
    loaded = load_pair_context(SMALL + ".npz", cuda)
    ctx = registration.segment_pair(moving, fixed, loaded)
    # the artifact carries the ids lrr_tpu's segmentation gave on the CPU
    assert torch.equal(ctx.moving_region_labels, loaded.moving_region_labels)
    assert torch.equal(ctx.fixed_region_labels, loaded.fixed_region_labels)

    queries = torch.tensor(meta["queries"], dtype=torch.float32, device=cuda)
    plan = draw_sampling_plan(
        torch.Generator().manual_seed(0), len(queries), cfg,
        ctx.moving_features.capacity, ctx.fixed_features.capacity, cuda)
    svm = load_default_verifier()
    n0 = kernels.LAUNCHES["normal_equations"]
    staged = register_locations_staged(ctx, queries, cfg, svm, plan)
    assert kernels.LAUNCHES["normal_equations"] > n0
    assert int((staged.selected >= 0).sum()) >= len(queries) - 1
    every = registration.register_locations(ctx, queries, cfg, svm, plan)
    both = (staged.selected >= 0) & (every.selected >= 0)
    assert bool(every.refined.all()) and torch.equal(staged.selected[both], every.selected[both])

    one = plan.query(0)
    n0 = kernels.LAUNCHES["normal_equations"]
    res, best, usable = registration.register_location_rigid(ctx, queries[0], cfg, one)
    assert kernels.LAUNCHES["normal_equations"] == n0  # the 6 x 6 system is not K1's
    assert bool(usable) and bool(res.valid)
    eye = torch.eye(3, device=cuda)
    assert float((res.trans.A @ res.trans.A.T - eye).abs().max()) <= 1e-5
    calls = []
    c = int(staged.selected[0])
    watched = registration.watch_candidate(
        ctx, queries[0], cfg, one, c, lambda *a: calls.append(a))
    assert len(calls) == int(watched.iterations) >= 2
    assert float((watched.trans.A - staged.trans.A[0, c]).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the file-based pipeline on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_stage_commands_take_the_card_by_default(cuda, tmp_path, capsys):
    """The stage commands with no `--device`: K2 launches once in `register`
    and K1 in every ICP iteration; `--device cpu` launches neither; both
    verify every query."""
    from lrr_tpu_torch import cli
    from lrr_tpu_torch.io import read_features, write_mhd

    fixed, moving, _ = make_pair((32, 32, 32), rotation_deg=4.0, translation=(2.0, -1.0, 0.5),
                                 seed=3)
    assert fixed.data.is_cuda
    p = lambda name: str(tmp_path / name)  # noqa: E731
    for side, vol in (("moving", moving), ("fixed", fixed)):
        write_mhd(p(f"{side}.mhd"), vol.data.cpu().numpy(), tuple(vol.origin.cpu().numpy()),
                  tuple(vol.spacing.cpu().numpy()))
        cli.main(["extract-features", p(f"{side}.mhd"), p(f"{side}_00.vtk"),
                  "--max-features", "1024"])
        cli.main(["extract-keypoints", p(f"{side}_00.vtk"), p(f"{side}_kp.vtk"),
                  "--max-keypoints", "32"])
        cli.main(["compute-descriptors", p(f"{side}_kp.vtk"), p(f"{side}_00.vtk"),
                  p(f"{side}_desc.vtk"), "--min-neighbors", "8"])
    assert read_features(p("moving_00.vtk")).xyz.is_cuda
    with open(p("locs.txt"), "w") as f:
        f.write("14 16 15\n18 15 17\n")
    register = ["register", p("moving_00.vtk"), p("fixed_00.vtk"), p("moving_desc.vtk"),
                p("fixed_desc.vtk"), "--locs", p("locs.txt"), "--candidates", "4",
                "--max-matches", "512", "--max-iterations", "12", "--min-region-features", "32"]
    kernels.reset_launch_counts()
    cli.main(register + ["--out", p("on_card")])
    assert kernels.LAUNCHES["knn"] == 1 and kernels.LAUNCHES["normal_equations"] > 0
    kernels.reset_launch_counts()
    cli.main(register + ["--out", p("on_cpu"), "--device", "cpu"])
    assert not any(kernels.LAUNCHES.values())
    for out in ("on_card", "on_cpu"):  # each device draws its own plan from the seed
        for t in range(2):
            with open(p(f"{out}/results{t:06d}.json")) as f:
                assert json.load(f)["selected"] >= 0


@pytest.mark.gpu
def test_fit_rbf_classifier_on_the_card_matches_the_cpu(cuda):
    from lrr_tpu_torch.verify.svm import fit_rbf_classifier, predict_probability

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(-0.4, 0.3, (60, 8)), rng.normal(0.4, 0.3, (20, 8))])
    y = np.concatenate([np.ones(60), np.zeros(20)])
    x = x.astype(np.float32)
    on_card, on_cpu = fit_rbf_classifier(x, y), fit_rbf_classifier(x, y, device="cpu")
    assert not on_card.sv.is_cuda  # a trained model comes back on the host
    xt = torch.from_numpy(x)
    p_card, p_cpu = predict_probability(on_card, xt), predict_probability(on_cpu, xt)
    assert float((p_card - p_cpu).abs().max()) < 2e-3


@pytest.mark.gpu
def test_stage_timers_wait_for_the_card(cuda):
    """A timed stage ends in a synchronise: work queued inside it counts."""
    from lrr_tpu_torch.utils.timers import StageTimers

    a = torch.ones(4096, 4096, device=cuda)
    a @ a
    torch.cuda.synchronize()
    synced, loose = StageTimers(), StageTimers(sync=False)
    for timers in (loose, synced):
        with timers.time("matmul"):
            for _ in range(20):
                a @ a
        torch.cuda.synchronize()
    assert synced.totals["matmul"] > 2 * loose.totals["matmul"]


# ---------------------------------------------------------------------------
# the estimate family and the sampling plans
# ---------------------------------------------------------------------------


def _cov_pair(device, n=400, seed=1):
    from lrr_tpu_torch.estimation.cdc import CovFeatures

    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.uniform(0, 30, (n, 3)).astype(np.float32)).to(device)
    cov = (0.3 * torch.eye(3, device=device)).expand(n, 3, 3)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    t = torch.tensor([1.2, -0.7, 0.4], device=device)
    return CovFeatures(xyz, cov, mask), CovFeatures(xyz + t, cov, mask)


@pytest.mark.gpu
def test_compute_weights_and_run_cdc_bit_identical_run_to_run(cuda):
    """No atomic scatter-add, stable sorts: two runs give the same bits."""
    from lrr_tpu_torch.estimation.cdc import compute_weights, run_cdc
    from lrr_tpu_torch.models.affine import Affine3D

    mov, fix = _cov_pair(cuda)
    covar = 1e-2 * torch.eye(12, device=cuda)
    a = compute_weights(Affine3D.identity(device=cuda), covar, mov, fix, 100)
    b = compute_weights(Affine3D.identity(device=cuda), covar, mov, fix, 100)
    assert torch.equal(a.weight, b.weight) and torch.equal(a.mask, b.mask)
    assert torch.equal(a.to_xyz, b.to_xyz)
    for kw in ({}, {"use_transfer": True, "symmetric": True}):
        r1 = run_cdc(mov, fix, Affine3D.identity(device=cuda), max_iterations=8, **kw)
        r2 = run_cdc(mov, fix, Affine3D.identity(device=cuda), max_iterations=8, **kw)
        assert r1.iteration == r2.iteration
        assert torch.equal(r1.trans.A, r2.trans.A) and torch.equal(r1.trans.t, r2.trans.t)
        assert torch.equal(r1.covar, r2.covar)
        assert (r1.transfer is None) or torch.equal(r1.transfer, r2.transfer)


@pytest.mark.gpu
def test_plan_drawn_for_the_card_equals_the_cpus(cuda):
    from lrr_tpu_torch.config import pipeline_config_from_dict
    from lrr_tpu_torch.pipeline.intensity import draw_intensity_points

    with open(SMALL + ".json") as f:
        cfg = pipeline_config_from_dict(json.load(f)["config"])
    on_cpu = draw_sampling_plan(torch.Generator().manual_seed(3), 2, cfg, 50, 60)
    on_card = draw_sampling_plan(torch.Generator().manual_seed(3), 2, cfg, 50, 60, cuda)
    for name, v in vars(on_cpu).items():
        assert getattr(on_card, name).device.type == "cuda"
        assert torch.equal(getattr(on_card, name).cpu(), v), name
    with pytest.raises(ValueError, match="CPU generator"):
        draw_sampling_plan(torch.Generator(device=cuda), 2, cfg, 50, 60)
    a = draw_intensity_points(7, [(8, 9, 10)], 2, 64, "cpu")
    b = draw_intensity_points(7, [(8, 9, 10)], 2, 64, cuda)
    assert torch.equal(a[0], b[0].cpu())


@pytest.mark.gpu
def test_intensity_percentile_past_two_to_the_24(cuda):
    """`register_intensity` normalises by a sort: a volume of 16,778,000
    voxels, past 2^24 (torch.quantile refuses it), gives numpy's
    linear-interpolated 1 % and 99 % percentiles on the card."""
    from lrr_tpu_torch.pipeline.intensity import _normalize_intensity, percentile

    n = 16778 * 1000
    assert n > 1 << 24
    rng = np.random.default_rng(0)
    v = rng.gamma(2.0, 100.0, n).astype(np.float32)
    t = torch.from_numpy(v).to(cuda)
    for p in (1.0, 99.0):
        got = float(percentile(t, p))
        want = float(np.percentile(v.astype(np.float64), p))
        assert abs(got - want) <= 1e-5 * abs(want), (p, got, want)
    out = _normalize_intensity(t.reshape(-1, 1000))
    assert out.shape == (n // 1000, 1000) and float(out.min()) == 0.0 and float(out.max()) == 1.0


def _ranks_on_the_card(tmp_path, cases, inp):
    """Two ranks of tests/torch_parallel_worker.py sharing the card (gloo,
    LRR_COORDINATOR), with the kernels built here first so the ranks only
    load them."""
    import torch_parallel_worker as worker
    from lrr_tpu_torch.ops import native

    native.build()
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), device="cuda", **inp)
    worker.run_ranks(2, ["env", os.path.join(d, "inputs.npz"), d, *cases], d,
                     env_route="coordinator", timeout=300)
    return worker.load_results(d, 2, cases)


@pytest.mark.gpu
def test_two_ranks_split_the_score_stage_on_the_card(cuda, tmp_path):
    """Halo exchange, the z-split score stage and the distributed normal
    equations with CUDA tensors over gloo (through host memory): the score
    equals the one-process score on the card bit for bit; the normal
    equations agree to 1e-5 of the largest entry."""
    from lrr_tpu_torch.features.extract import _score_and_outer
    from lrr_tpu_torch.models.affine import normal_equations_terms
    from lrr_tpu_torch.models.affine import Affine3D

    rng = np.random.default_rng(1234)
    inp = {"halo_x": rng.standard_normal((16, 5)).astype(np.float32),
           "score_vol": rng.standard_normal((64, 24, 24)).astype(np.float32),
           "ne_from": rng.uniform(0, 50, (512, 3)).astype(np.float32),
           "ne_w": rng.uniform(0.1, 1.0, 512).astype(np.float32)}
    inp["ne_to"] = inp["ne_from"] + np.float32([1.0, -0.5, 0.25])
    inp["ne_proj"] = np.broadcast_to(np.eye(3, dtype=np.float32), (512, 3, 3)).copy()
    res = _ranks_on_the_card(tmp_path, ["halo", "score", "normal_equations"], inp)
    grad = filters.gaussian_gradient(torch.from_numpy(inp["score_vol"]).to(cuda), 1.0,
                                     (1.0, 1.0, 1.0))
    score, outer = _score_and_outer(grad)
    for r in range(2):
        np.testing.assert_array_equal(res["score"][r]["score"], score.cpu().numpy())
        np.testing.assert_array_equal(res["score"][r]["outer"], outer.cpu().numpy())
    xs = inp["halo_x"].reshape(2, 8, 5)
    np.testing.assert_array_equal(res["halo"][0]["ext"][-2:], xs[1, :2])
    np.testing.assert_array_equal(res["halo"][1]["ext"][:2], xs[0, -2:])
    AtA, _ = normal_equations_terms(Affine3D.identity(device="cpu"), *(
        torch.from_numpy(inp[k]) for k in ("ne_from", "ne_to", "ne_proj", "ne_w")))
    got = res["normal_equations"][0]["dp1.AtA"]
    np.testing.assert_allclose(got, AtA.numpy(), rtol=0, atol=1e-5 * float(AtA.abs().max()))


@pytest.mark.gpu
def test_two_ranks_serve_and_split_the_matches_on_the_card(cuda, tmp_path):
    """The staged serving path with the lanes split over 2 ranks on the card,
    and 16 lanes' ICP with the matches split: K1 launches on each rank;
    selections equal the one-process run on the card (lane counts differ, so
    bits are not promised: decisions are), the ICP within the CPU test's
    bars."""
    import torch_parallel_worker as worker
    from lrr_tpu_torch.pipeline.registration import register_locations_staged

    with open(SMALL + ".json") as f:
        meta = json.load(f)
    ctx, cfg = worker._small_context()
    q = np.asarray(meta["queries"], np.float32)
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), 4, cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    inp = {"queries": q, "queries3": q[:3]}
    inp.update({f"plan.{k}": v.numpy() for k, v in vars(plan).items() if v is not None})
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.models.affine import Affine3D

    cmask, inits, *_ = registration._pass1_fn(ctx, torch.from_numpy(q), cfg, plan)
    lanes, cands = torch.arange(4).repeat_interleave(4), torch.arange(4).repeat(4)
    init = Affine3D(inits.A[lanes, cands], inits.t[lanes, cands], inits.center[lanes, cands])
    m_sel, f_sel, *_ = registration._candidate_rois(ctx, init, torch.from_numpy(q)[lanes], cfg)
    inp.update({f"icp.init.{k}": getattr(init, k).numpy() for k in ("A", "t", "center")})
    inp.update({"icp.m_sel": m_sel.numpy(), "icp.f_sel": f_sel.numpy()})
    inp.update({f"icp.plan.{k}": v.numpy() for k, v in vars(plan.select(lanes, cands)).items()
                if v is not None})
    res = _ranks_on_the_card(tmp_path, ["staged", "icp_mp"], inp)
    worker.DEVICE = "cuda"
    try:
        ctx_c, _ = worker._small_context()
        one = register_locations_staged(ctx_c, torch.from_numpy(q).to(cuda), cfg,
                                        load_default_verifier(), worker._plan(inp))
        res_one, _ = worker.icp_lanes(ctx_c, cfg, inp, None)
    finally:
        worker.DEVICE = "cpu"
    for r in range(2):
        assert int(res["staged"][r]["launches.normal_equations"]) > 0
        assert int(res["icp_mp"][r]["launches.normal_equations"]) > 0
        np.testing.assert_array_equal(res["staged"][r]["q4.selected"], one.selected.cpu().numpy())
        got = res["icp_mp"][r]
        np.testing.assert_array_equal(got["res.iterations"], res_one.iterations.cpu().numpy())
        np.testing.assert_allclose(got["res.trans.A"], res_one.trans.A.cpu().numpy(), atol=1e-4)


@pytest.mark.gpu
def test_four_ranks_with_a_card_each_over_nccl(cuda, tmp_path):
    """Four ranks, one card each (skips with fewer cards): CUDA tensors go
    over NCCL.  The z-split score equals the one-process score on a card bit
    for bit, the z-slab Voronoi map the one-process map, the (2, 2) mesh's
    mp all-reduce the one-process normal equations to 1e-5 of the largest
    entry, and the staged path with one query a rank selects as one process
    does."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import torch_parallel_worker as worker
    from lrr_tpu_torch.features.extract import _score_and_outer
    from lrr_tpu_torch.models.affine import Affine3D, normal_equations_terms
    from lrr_tpu_torch.ops import native

    native.build()
    rng = np.random.default_rng(1234)
    inp = {"score_vol": rng.standard_normal((64, 24, 24)).astype(np.float32),
           "vor_xyz": rng.uniform(0, 60, (256, 3)).astype(np.float32),
           "vor_mask": rng.uniform(size=256) > 0.1,
           "ne_from": rng.uniform(0, 50, (512, 3)).astype(np.float32),
           "ne_w": rng.uniform(0.1, 1.0, 512).astype(np.float32)}
    inp["ne_to"] = inp["ne_from"] + np.float32([1.0, -0.5, 0.25])
    inp["ne_proj"] = np.broadcast_to(np.eye(3, dtype=np.float32), (512, 3, 3)).copy()
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    ctx, cfg = worker._small_context()
    q = np.asarray(meta["queries"], np.float32)
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), 4, cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    inp.update({"queries": q, "queries3": q[:3]})
    inp.update({f"plan.{k}": v.numpy() for k, v in vars(plan).items() if v is not None})
    d = str(tmp_path)
    np.savez(os.path.join(d, "inputs.npz"), device="cuda", **inp)
    cases = ["mesh", "score", "voronoi", "normal_equations", "staged"]
    worker.run_ranks(4, ["env", os.path.join(d, "inputs.npz"), d, *cases], d,
                     env_route="coordinator", timeout=300)
    res = worker.load_results(d, 4, cases)
    assert all("nccl" in str(res["score"][r]["backend"]) for r in range(4))
    grad = filters.gaussian_gradient(torch.from_numpy(inp["score_vol"]).to(cuda), 1.0,
                                     (1.0, 1.0, 1.0))
    score, _ = _score_and_outer(grad)
    vol, _, _ = voronoi.build_feature_voronoi(torch.from_numpy(inp["vor_xyz"]).to(cuda),
                                              torch.from_numpy(inp["vor_mask"]).to(cuda))
    AtA, _ = normal_equations_terms(Affine3D.identity(device="cpu"), *(
        torch.from_numpy(inp[k]) for k in ("ne_from", "ne_to", "ne_proj", "ne_w")))
    worker.DEVICE = "cuda"
    try:
        ctx_c, _ = worker._small_context()
        one = register_locations_staged(ctx_c, torch.from_numpy(q).to(cuda), cfg,
                                        load_default_verifier(), worker._plan(inp))
    finally:
        worker.DEVICE = "cpu"
    for r in range(4):
        np.testing.assert_array_equal(res["mesh"][r]["dp_mp"], [2, 2])
        np.testing.assert_array_equal(res["score"][r]["score"], score.cpu().numpy())
        np.testing.assert_array_equal(res["voronoi"][r]["vol"], vol.cpu().numpy())
        for name in ("dp1.AtA", "default.AtA"):
            np.testing.assert_allclose(res["normal_equations"][r][name], AtA.numpy(), rtol=0,
                                       atol=1e-5 * float(AtA.abs().max()))
        np.testing.assert_array_equal(res["staged"][r]["q4.selected"], one.selected.cpu().numpy())
        assert int(res["staged"][r]["launches.normal_equations"]) > 0


def _to_cpu(x):
    """A tensor, or a dataclass / tuple of them (a context, a plan, a
    transform), on the CPU."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to_cpu(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


@pytest.mark.gpu
def test_training_pair_collected_on_the_card_labels_as_the_cpu(cuda, monkeypatch):
    """The first bench-scale training pair (`train_default.BENCH_SPECS[0]`,
    16 of its queries) collected through `collect_bench_pair` on the card,
    and the same context and plan collected on the CPU, twice: as it is, and
    with K1's sums perturbed by 1.2e-7 relative (rounding in another order).
    The same candidates refined everywhere; the median candidate's
    ground-truth error within 1e-3 mm of the CPU's.  The ICP amplifies
    rounding: a lane whose match windows change on one flipped nearest
    neighbour converges elsewhere, up to ~1.6 mm away, converged or not.  So
    the card may move no more candidates beyond 0.1 mm, and relabel no more,
    than the perturbation does on the CPU, with a slack of 2x + 3 for the
    draw of the noise (measured on an H100, 700 W: 158 candidates; the card
    moved 15 and relabeled 5, its largest move 1.63 mm; the perturbation on
    its host moved 15 and relabeled 2, its largest move 0.72 mm).  The
    printed line gives this run's figures."""
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.verify import surrogate, train_default

    seen, outs = {}, []
    real_collect, real_staged = surrogate.collect_labeled_measurements, registration.register_locations_staged
    plain = kernels.normal_equations_sym_plain

    def spy(ctx, cfg, true, queries, plan):
        seen.update(ctx=ctx, cfg=cfg, true=true, queries=queries, plan=plan)
        return real_collect(ctx, cfg, true, queries, plan)

    def staged(*args, **kwargs):
        outs.append(real_staged(*args, **kwargs))
        return outs[-1]

    noise = torch.Generator().manual_seed(0)

    def perturbed(*args):
        ata, atb = plain(*args)
        ata = ata * (1 + 1.2e-7 * torch.randn(ata.shape, generator=noise))
        return 0.5 * (ata + ata.transpose(-1, -2)), atb * (1 + 1.2e-7 * torch.randn(
            atb.shape, generator=noise))

    monkeypatch.setattr(surrogate, "collect_labeled_measurements", spy)
    monkeypatch.setattr(registration, "register_locations_staged", staged)
    n0 = dict(kernels.LAUNCHES)
    X, y = train_default.collect_bench_pair(*train_default.BENCH_SPECS[0], n_queries=16)
    assert seen["ctx"].device.type == "cuda" and seen["plan"].rank_scores.device.type == "cuda"
    assert kernels.LAUNCHES["knn"] == n0["knn"] + 1
    assert kernels.LAUNCHES["normal_equations"] > n0["normal_equations"]
    args = (_to_cpu(seen["ctx"]), seen["cfg"], _to_cpu(seen["true"]), seen["queries"],
            _to_cpu(seen["plan"]))
    _, yc = real_collect(*args)
    monkeypatch.setattr(kernels, "normal_equations_sym_plain", perturbed)
    _, yp = real_collect(*args)
    out_g, out_c, out_p = outs
    for name in ("candidate_mask", "enough_features", "valid", "refined"):
        for out in (out_g, out_p):
            assert torch.equal(getattr(out, name).cpu(), getattr(out_c, name)), name
    queries = torch.as_tensor(seen["queries"])
    err_c = surrogate.candidate_gt_errors(out_c, queries, args[2])
    usable = (out_c.candidate_mask & out_c.enough_features & out_c.valid & out_c.refined).numpy()
    label = lambda e: np.where(e < 2.0, 1, np.where(e > 6.0, 0, -1))
    figures = {"usable": int(usable.sum()), "rows": [len(y), len(yc), len(yp)]}
    for name, out, q in (("card", out_g, queries.to(cuda)), ("perturbed", out_p, queries)):
        err = surrogate.candidate_gt_errors(out, q, seen["true"] if name == "card" else args[2])
        moved = np.abs(err - err_c)[usable]
        figures[name] = {"median_mm": float(np.median(moved)), "max_mm": float(moved.max()),
                         "moved_over_0.1mm": int((moved > 0.1).sum()),
                         "relabeled": int((usable & (label(err) != label(err_c))).sum())}
    print(json.dumps(figures))
    card, ref = figures["card"], figures["perturbed"]
    assert len(y) >= 20 and figures["usable"] >= 100
    assert card["median_mm"] <= 1e-3
    assert card["moved_over_0.1mm"] <= 2 * ref["moved_over_0.1mm"] + 3
    assert card["relabeled"] <= 2 * ref["relabeled"] + 3


@pytest.mark.gpu
def test_sol_iteration_on_gpu_matches_cpu(cuda):
    """One ICP iteration of `utils/sol.py`'s synthetic wave (small shape) on
    the card through K1 against the CPU's plain version: the estimate within
    1e-4 normwise (the sums' order), K1 launched once."""
    from lrr_tpu_torch.utils import sol

    inputs = sol.synthetic_iteration_inputs(4, 256, 16, 2, seed=0)
    A0 = torch.eye(3).expand(4, 3, 3).contiguous()
    t0 = torch.from_numpy(inputs["t0"])
    _, _, want = sol.iterate(sol.iteration_wave(inputs, 128, "cpu"), A0, t0, 0)
    n0 = kernels.LAUNCHES["normal_equations"]
    _, _, got = sol.iterate(sol.iteration_wave(inputs, 128, cuda), A0.to(cuda), t0.to(cuda), 0)
    assert kernels.LAUNCHES["normal_equations"] == n0 + 1
    for g, w in ((got.A, want.A), (got.t, want.t)):
        g, w = g.cpu().numpy(), w.numpy()
        scale = np.abs(w).reshape(4, -1).max(1)
        assert np.all(np.abs(g - w).reshape(4, -1).max(1) <= 1e-4 * scale)


@pytest.mark.gpu
def test_sol_gather_roofline_on_gpu(cuda):
    """The card's measured gather rates: positive, under the streaming peak,
    kept for the process."""
    from lrr_tpu_torch.utils import sol

    roof = sol.measured_gather_roofline(cuda)
    for key in ("gather_gb_s_padded_small", "gather_gb_s_dense_big"):
        assert 0 < roof[key] < sol.PEAK_HBM_GBS
        assert roof[key] == max(roof["gather_gb_s_by_op"][key].values())
    assert 0 < roof["window_copy_gb_s"] < sol.PEAK_HBM_GBS
    assert sol.measured_gather_roofline(cuda) is roof


# ---------------------------------------------------------------------------
# K3 (csrc/pinv_sym.cu) and the waves served from captured CUDA graphs
# ---------------------------------------------------------------------------

PINV_KAPPA = 1e3  # condition number of the synthetic batches
PINV_TOL_PLAIN = 100 * PINV_KAPPA * 2**-23  # x max |entry|: float32 eigensolver error ~ kappa eps
PINV_TOL_F64 = 1e-6  # x max |entry|: the kernel against float64 on the same inputs


def _pinv_batch(rng, L, n, kind):
    """[L, n, n] float32 symmetric: V diag(lam) V^T with |lam| spread over
    PINV_KAPPA; "rank" zeroes two eigenvalues; "nonfinite" puts a NaN or an
    inf into every third matrix."""
    out = np.empty((L, n, n), np.float32)
    for i in range(L):
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.logspace(0, -np.log10(PINV_KAPPA), n) * 10.0 ** rng.uniform(-2, 2)
        if kind == "rank":
            lam[-2:] = 0.0
        a = (v * lam) @ v.T
        out[i] = (a + a.T) / 2
    if kind == "nonfinite":
        out[::3, 1, n - 1] = np.nan
        out[1::3, 0, 0] = np.inf
    return torch.tensor(out, device="cuda")


def _pinv_f64(a: torch.Tensor) -> np.ndarray:
    """The plain version's cut on the float32 input, solved in float64."""
    x = a.double().cpu().numpy()
    n = x.shape[-1]
    w, v = np.linalg.eigh(x)
    keep = np.abs(w) > 10 * n * 2**-23 * np.abs(w).max(-1, keepdims=True)
    inv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
    return (v * inv[:, None, :]) @ np.swapaxes(v, 1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["spd", "rank", "nonfinite"])
@pytest.mark.parametrize("n", [4, 6, 12])
@pytest.mark.parametrize("L", [1, 8, 24, 64])
def test_pinv_kernel_matches_plain(cuda, L, n, kind):
    rng = np.random.default_rng(L * 100 + n)
    a = _pinv_batch(rng, L, n, kind)
    n0 = kernels.LAUNCHES["pinv_sym"]
    got = kernels.pinv_hermitian_small(a)
    assert kernels.LAUNCHES["pinv_sym"] == n0 + 1 and kernels.PINV_SHAPES[(L, n)] >= 1
    want = kernels.pinv_hermitian_plain(a)
    bits = got.view(torch.int32)  # NaN-safe
    assert torch.equal(bits, kernels.pinv_hermitian_small(a).view(torch.int32))  # same bits
    assert torch.equal(bits, bits.transpose(1, 2))
    bad = ~torch.isfinite(a).flatten(1).all(1)
    assert bool(torch.isnan(got[bad]).all()) and bool(torch.isnan(want[bad]).all())
    g, w = got[~bad], want[~bad]
    if g.numel():
        f64 = _pinv_f64(a[~bad])
        scale = np.abs(f64).max()
        assert np.abs(g.cpu().numpy() - f64).max() <= PINV_TOL_F64 * scale
        assert float((g - w).abs().max()) <= PINV_TOL_PLAIN * float(w.abs().max())


@pytest.mark.gpu
def test_pinv_kernel_refuses_bad_inputs(cuda):
    from lrr_tpu_torch.models.affine import pinv_hermitian

    with pytest.raises(ValueError):
        kernels.pinv_hermitian_small(torch.zeros(2, 13, 13, device=cuda))
    with pytest.raises(ValueError):  # the port's solve: no plain version on the card
        pinv_hermitian(torch.zeros(2, 13, 13, device=cuda))
    with pytest.raises(ValueError):
        kernels.pinv_hermitian_small(torch.zeros(2, 4, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.pinv_hermitian_small(torch.zeros(2, 4, 5, device=cuda))


def _bench(cuda):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = os.path.join(root, "lrr_tpu_torch", "data", "bench_pair_s64")
    with open(bench + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    ctx = load_pair_context(bench + ".npz", cuda)
    q = torch.tensor(meta["queries"], dtype=torch.float32, device=cuda)
    plan = draw_sampling_plan(torch.Generator().manual_seed(3), len(q), cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity, cuda)
    return ctx, q, cfg, plan


@pytest.mark.gpu
def test_graph_waves_equal_eager_waves_on_the_card(cuda, monkeypatch):
    """The bench context served from captured graphs and by the eager
    `_wave_fn` (the oracle): the same bits in every field; K3 on both paths;
    one host read a chunk."""
    from lrr_tpu_torch.pipeline import registration, wave_graph

    ctx, q, cfg, plan = _bench(cuda)
    svm = load_default_verifier()
    wave_graph.drop()
    kernels.reset_launch_counts()
    got = register_locations_staged(ctx, q, cfg, svm, plan)
    again = register_locations_staged(ctx, q, cfg, svm, plan)  # replayed, nothing captured
    st = wave_graph.stats()
    assert kernels.LAUNCHES["pinv_sym"] > 0 and kernels.LAUNCHES["normal_equations"] > 0
    assert st["waves"] >= 2 and st["syncs"] >= st["waves"]
    assert st["replays"] == st["syncs"] + 2 * st["waves"]  # prologue + chunks + epilogue
    with monkeypatch.context() as m:
        m.setattr(registration, "_wave_runner", registration._eager_wave_runner)
        kernels.reset_launch_counts()
        want = register_locations_staged(ctx, q, cfg, svm, plan)
        assert kernels.LAUNCHES["pinv_sym"] > 0
    assert wave_graph.first_difference(got, want) is None
    assert wave_graph.first_difference(again, want) is None
    assert float((want.selected >= 0).float().mean()) >= 0.95

    # every candidate refined: the last wave is ragged and padded to its bucket
    small = load_pair_context(SMALL + ".npz", cuda)
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    scfg = pipeline_config_from_dict(meta["config"])
    sq = torch.tensor(meta["queries"], dtype=torch.float32, device=cuda)
    splan = draw_sampling_plan(torch.Generator().manual_seed(4), len(sq), scfg,
                               small.moving_features.capacity, small.fixed_features.capacity,
                               cuda)
    got = registration.register_locations(small, sq, scfg, svm, splan, lane_budget=12)
    with monkeypatch.context() as m:
        m.setattr(registration, "_wave_runner", registration._eager_wave_runner)
        want = registration.register_locations(small, sq, scfg, svm, splan, lane_budget=12)
    assert wave_graph.first_difference(got, want) is None
    wave_graph.drop()


@pytest.mark.gpu
def test_capture_runs_with_sync_errors(cuda):
    """A bucket's graphs are built (warm-up and capture) with the sync debug
    mode at "error", and that mode does raise on a host read."""
    from lrr_tpu_torch.pipeline import wave_graph

    with wave_graph._sync_errors():
        assert torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError):
            torch.ones(1, device=cuda).item()
    assert torch.cuda.get_sync_debug_mode() == 0
    ctx, q, cfg, plan = _bench(cuda)
    svm = load_default_verifier()
    wave_graph.drop()
    from lrr_tpu_torch.pipeline.registration import WAVE_STEPS, _pass1_fn

    graphs = wave_graph.wave_graphs(ctx, cfg, svm, WAVE_STEPS)

    _, inits, *_ = _pass1_fn(ctx, q, cfg, plan)
    lanes = torch.arange(8, device=cuda)
    rows = graphs.run(q, inits, plan, lanes, torch.zeros_like(lanes))
    assert rows.shape == (8, 174) and rows.dtype == torch.float32
    assert list(wave_graph.stats()["build_s"]) == [8]
    wave_graph.drop()


@pytest.mark.gpu
def test_a_traced_bucket_gives_the_rows_of_an_untraced_one(cuda):
    """A bucket built (warm-up and capture under the sync debug mode
    "error") and replayed with the program's trace on and an annotation
    prefix, under the profiler, gives the bits of the same waves with the
    trace off; its spans count what `wave_graph.stats()` counts, and a span
    is legal inside the "error" mode and inside a capture."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline import wave_graph
    from lrr_tpu_torch.pipeline.registration import WAVE_STEPS, _pass1_fn
    from lrr_tpu_torch.utils import timers

    ctx, q, cfg, plan = _bench(cuda)
    svm = load_default_verifier()
    _, inits, *_ = _pass1_fn(ctx, q, cfg, plan)
    lanes = torch.arange(8, device=cuda)

    def two_waves():
        """A new bucket's first wave (built) and a second (replayed)."""
        wave_graph.drop()
        graphs = wave_graph.wave_graphs(ctx, cfg, svm, WAVE_STEPS)
        first = graphs.run(q, inits, plan, lanes, torch.zeros_like(lanes))
        return first, graphs.run(q, inits, plan, lanes.flip(0), torch.ones_like(lanes))

    off = two_waves()
    timers.trace_on(annotate="lrr_test.")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            on = two_waves()
            st = wave_graph.stats()
            with wave_graph._sync_errors(), timers.span("inside_error_mode"):
                x = torch.ones(4, device=cuda) + 1
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g), timers.span("inside_capture"):
                y = x * 2
            g.replay()
        got = timers.drain()
    finally:
        timers.trace_off()
        wave_graph.drop()
    assert wave_graph.first_difference(on, off) is None
    assert torch.equal(y, torch.full((4,), 4.0, device=cuda))
    names = [s.name for s in got.spans]
    assert names.count("wave.build") == names.count("wave.build.warmup") == 1
    assert names.count("wave.build.capture") == 2 + len(icp._staged_caps(cfg.estimation))
    assert names.count("wave.inputs") == 2 and names.count("wave.flags") == st["syncs"]
    assert names.count("wave.replay") == st["replays"]
    assert {"inside_error_mode", "inside_capture"} <= set(names) and got.dropped == 0
    ranges = {e.name for e in prof.events()}
    for n in ("wave.build.capture", "wave.replay", "wave.flags", "inside_capture"):
        assert "lrr_test." + n in ranges


# ---------------------------------------------------------------------------
# K5 (csrc/sample_matches.cu): the ICP's match sampler
# ---------------------------------------------------------------------------


def _k5_case(cuda, L=24, n_src=3000, n_dst=2500, shape=(40, 48, 56), seed=0):
    """(src, vor, trans, number, offset, dst_rows) on the card: rows
    with every tag (0 = padding), a quarter of the sources on exact half-
    voxel coordinates (ties for the half-to-even rounding); lane 0's mask
    empty (valid count 0), lane 1's one feature; an index map with 20 %
    empty voxels; transforms near the identity, lane 2's
    the identity (the ties stay ties), lane 3's far outside the map (every
    voxel clamped); offsets up to 2^62."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.models.affine import Affine3D

    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=cuda)
    D, H, W = shape
    origin, spacing = np.array([0.25, -1.0, 2.0]), np.array([0.5, 1.0, 2.0])
    top = origin + (np.array([W, H, D]) - 1) * spacing

    def rows(n, ties):
        xyz = rng.uniform(origin - 3, top + 3, (n, 3))
        k = rng.integers(0, [W - 1, H - 1, D - 1], (ties, 3))
        xyz[:ties] = origin + (k + 0.5) * spacing
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return t(np.concatenate([xyz, rng.uniform(0, 5, (n, 1)), d,
                                 rng.integers(0, 4, (n, 1))], 1))

    src_rows, dst_rows = rows(n_src, n_src // 4), rows(n_dst, 0)
    lane_mask = rng.uniform(size=(L, n_src)) < 0.7
    lane_mask[0] = False
    lane_mask[1] = False
    lane_mask[1, 17] = True
    src = icp._pack_source(t(rng.uniform(size=(L, n_src))), src_rows, t(lane_mask, torch.bool))
    index = rng.integers(0, n_dst, shape)
    index[rng.uniform(size=shape) < 0.2] = -1
    vor = icp.VoronoiGrid(t(index, torch.int32), t(origin), t(spacing))
    A = np.eye(3) + 0.03 * rng.standard_normal((L, 3, 3))
    tr = rng.uniform(-2, 2, (L, 3))
    center = rng.uniform(origin, top, (L, 3))
    A[2], tr[2], center[2] = np.eye(3), 0.0, 0.0
    tr[3] = [900.0, -700.0, 1e4]
    trans = Affine3D(A=t(A), t=t(tr), center=t(center))
    number = t(rng.integers(0, 10000, L), torch.int64)
    number[-1] = 1 << 40
    offset = t(rng.integers(0, 1 << 62, L), torch.int64)
    return src, vor, trans, number, offset, dst_rows


@pytest.mark.gpu
@pytest.mark.parametrize("cap,n_src,ranks,rank", [
    (1024, 3000, 1, 0), (2048, 3000, 1, 0), (4096, 3000, 1, 0), (8000, 9000, 1, 0),
    (8000, 9000, 3, 1), (8000, 9000, 3, 2), (2048, 3000, 2, 1)])
def test_sample_matches_kernel_equals_the_plain_sampler(cuda, cap, n_src, ranks, rank):
    """K5 against `icp.sample_matches_plain` on the card, bit for bit in the
    four outputs: capacities of 1,024 to
    8,000 (4,096 over 3,000 sources is cut to 3,000; 8,000 is ragged at 256
    threads a block), mesh blocks with p0 > 0 (the last padded past the
    capacity), valid counts 0 and 1, offsets up to 2^62, points mapped
    outside the map, empty voxels and half-voxel ties.  One launch a call,
    logged at its shape; two launches alike."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline.wave_graph import first_difference

    src, vor, trans, number, offset, dst_rows = _k5_case(cuda, n_src=n_src)
    c = min(cap, n_src)
    m = -(-c // ranks)
    args = (src, vor, trans, number, c, offset)
    before = kernels.counts()
    got = kernels.sample_matches(*args, dst_rows=dst_rows, p0=rank * m, m=m)
    launches, shapes = (kernels.counts_since(before)[i] for i in (0, 5))
    assert launches == {"sample_matches": 1} and shapes == {(24, m): 1}
    want = icp.sample_matches_plain(*args, dst_rows=dst_rows, p0=rank * m, m=m)
    assert first_difference(got, want) is None
    assert first_difference(kernels.sample_matches(*args, dst_rows=dst_rows, p0=rank * m, m=m),
                            got) is None
    s, d, weight, ok = got
    assert not bool(ok[0].any()) and int(ok[1].sum()) <= 1
    assert bool(ok.any()) == (rank * m < c)
    assert bool((d[..., 7] == 0).any())  # empty voxels (tag 0) met


@pytest.mark.gpu
def test_sample_matches_kernel_refuses_bad_inputs(cuda):
    """Wrong dtype, device, shape or contiguity raises before a launch, as
    does a window past the permutation."""
    import dataclasses

    from lrr_tpu_torch.models.affine import Affine3D

    src, vor, trans, number, offset, dst_rows = _k5_case(cuda, L=4)
    ok = (src, vor, trans, number, 1024, offset, dst_rows)
    kernels.sample_matches(*ok[:-1], dst_rows=dst_rows, p0=0, m=1024)
    bad = [
        (dataclasses.replace(src, order=src.order.int()),) + ok[1:],
        (dataclasses.replace(src, lane_mask=src.lane_mask.float()),) + ok[1:],
        (dataclasses.replace(src, rows=src.rows.cpu()),) + ok[1:],
        (dataclasses.replace(src, rows=src.rows[:, :7]),) + ok[1:],
        ok[:1] + (dataclasses.replace(vor, index_vol=vor.index_vol.long()),) + ok[2:],
        ok[:2] + (Affine3D(trans.A.transpose(1, 2), trans.t, trans.center),) + ok[3:],
        ok[:2] + (Affine3D(trans.A[:3], trans.t[:3], trans.center[:3]),) + ok[3:],
        ok[:3] + (number.int(),) + ok[4:],
        ok[:4] + (5000,) + ok[5:],
        ok[:5] + (torch.stack([offset, offset], 1)[:, 0],) + ok[6:],
        ok[:6] + (dst_rows.double(),),
        ok[:6] + (dst_rows[:, :7],),
        ok[:6] + (dst_rows.cpu(),),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.sample_matches(*args[:-1], dst_rows=args[-1], p0=0, m=1024)


@pytest.mark.gpu
def test_sample_matches_kernel_on_both_transforms_of_a_wave(cuda, monkeypatch):
    """A bench wave's refinement after its MUSE iteration: K5 equals the
    plain sampler on the forward transform (moving sources, fixed map) and
    the inverse (fixed sources, moving map).  One `Refinement.step` launches
    K5 twice, one a direction; over an eager served run every sampler call
    is one launch."""
    from lrr_tpu_torch.estimation import icp, measurements
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.pipeline.wave_graph import first_difference

    ctx, q, cfg, plan = _bench(cuda)
    _, inits, *_ = registration._pass1_fn(ctx, q, cfg, plan)
    lanes = torch.arange(16, device=cuda)
    cands = torch.zeros_like(lanes)
    r, c, _ = registration._wave_prologue(
        ctx, cfg, *registration._wave_inputs(q, inits, plan, lanes, cands))
    cap = r.caps[-1]
    offs = r.draws.offsets_f[:, 3].contiguous()
    for src, vor, trans, dst in (
            (r.src_m, r.fixed_vor, c.trans, r.src_f.rows),
            (r.src_f, r.moving_vor, c.trans.inverse(), r.src_m.rows)):
        trans = icp.Affine3D(trans.A.contiguous(), trans.t.contiguous(),
                             trans.center.contiguous())
        m = min(cap, src.order.shape[1])
        args = (src, vor, trans, c.number_matches, m, offs)
        got = kernels.sample_matches(*args, dst_rows=dst, p0=0, m=m)
        assert first_difference(got, icp.sample_matches_plain(
            *args, dst_rows=dst, p0=0, m=m)) is None
        assert bool(got[3].any())

    before = kernels.counts()
    r.step(c, 0)
    delta = kernels.counts_since(before)
    assert delta[0]["sample_matches"] == 2 and sum(delta[5].values()) == 2

    calls = [0]
    for mod in (icp, measurements):
        real = mod._sample_matches_packed

        def counted(*a, _real=real, **k):
            calls[0] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, "_sample_matches_packed", counted)
    monkeypatch.setattr(registration, "_wave_runner", registration._eager_wave_runner)
    n0 = kernels.LAUNCHES["sample_matches"]
    register_locations_staged(ctx, q, cfg, load_default_verifier(), plan)
    assert calls[0] > 0 and kernels.LAUNCHES["sample_matches"] - n0 == calls[0]


@pytest.mark.gpu
def test_a_copd512_sized_bucket_replays_the_eager_waves_bits(cuda):
    """A 512-lane wave at the reference constants (65,536 features, 8,000
    matches) on a dense phantom of copd512's map size (320 x 320 x 302 at
    1 mm): the captured bucket's rows equal `_wave_fn`'s eager rows bit for
    bit; each chunk graph records 2 x ITERATIONS_PER_CHECK K5 launches, the
    prologue and the epilogue two each."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline import registration, wave_graph
    from lrr_tpu_torch.verify import train_default

    cfg = train_default.reference_cfg()
    fixed, moving, _ = make_pair((302, 320, 320), rotation_deg=6.0,
                                 translation=(3.0, -2.0, 1.5), seed=5, noise=0.5, dense=True,
                                 device=cuda)
    ctx = prepare_pair(moving, fixed, cfg)
    del fixed, moving
    svm = load_default_verifier()
    q = torch.tensor(np.random.default_rng(2).uniform([100, 100, 90], [220, 220, 210], (64, 3)),
                     dtype=torch.float32, device=cuda)
    plan = draw_sampling_plan(torch.Generator().manual_seed(6), len(q), cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity, cuda)
    cmask, inits, _, enough, *_ = registration._pass1_fn(ctx, q, cfg, plan)
    usable = (cmask & enough).nonzero()
    assert len(usable) >= 512
    lanes, cands = usable[:512, 0], usable[:512, 1]
    wave_graph.drop()
    graphs = wave_graph.wave_graphs(ctx, cfg, svm, registration.WAVE_STEPS)
    got = graphs.run(q, inits, plan, lanes, cands)
    want = registration._wave_fn(ctx, q, cfg, svm.to(cuda), inits, plan, lanes, cands)
    assert wave_graph.first_difference(got, want) is None
    b = graphs.buckets[512]
    assert b.prologue.launches[0]["sample_matches"] == 2
    assert b.epilogue.launches[0]["sample_matches"] == 2
    for g in b.chunks:
        assert g.launches[0]["sample_matches"] == 2 * icp.ITERATIONS_PER_CHECK
    wave_graph.drop()


# ---------------------------------------------------------------------------
# K6 (csrc/robust_weights.cu): the ICP's robust weights and weighted errors
# ---------------------------------------------------------------------------


def _chip_smoke():
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("L,M,stride", [(L, M, s) for L in (16, 64, 512)
                                        for M in (1024, 2048, 4096, 8000) for s in (8, 16)])
def test_robust_weights_kernel_equals_the_plain_chain(cuda, L, M, stride):
    """K6 against `icp.robust_weights_plain` and `_weighted_error_packed` at
    the ICP's shapes (`chip_smoke.k6_against_plain`): the frame to 1e-6
    relative, weights to 1e-5 of the lane's largest and errors to 1e-5
    relative; from the kernel's own scales and frame the plain chain's
    operations give its weights and both MAD scales bit for bit; two
    launches alike.  The edge lanes: no match (n = 0) and one give the
    order statistic float max, an infinite scale and no weight; every
    residual overflowing leaves no weight."""
    cs = _chip_smoke()
    inputs = cs.k6_inputs(np.random.default_rng(L + M + stride), L, M, M, stride, cuda)
    before = kernels.counts()
    rec = cs.k6_against_plain(*inputs)
    assert kernels.counts() == before  # the check takes its launches back
    scales = rec["scales"]
    inf = torch.tensor(float("inf"), device=cuda)
    for lane in (0, 1):
        assert bool((scales[lane, :, 1:] == inf).all())
    assert bool((scales[4, :, 0] == inf).all()) and bool((scales[4, :, 1] == inf).all())
    w = kernels.robust_weights(*inputs)[:2]
    for lane in (0, 1, 4):
        assert not bool(w[0][lane].any()) and not bool(w[1][lane].any())
    assert bool((w[0][6:] > 0).any(1).all()) and not bool(w[0][5, M // 2:].any())


@pytest.mark.gpu
@pytest.mark.parametrize("m_f,m_b", [(3000, 7999), (12000, 11000), (10, 9)])
def test_robust_weights_kernel_at_unequal_and_large_match_counts(cuda, m_f, m_b):
    """Directions of different match counts; past one block's shared memory
    (12,000 matches: the per-match arrays in global scratch); a handful of
    matches."""
    cs = _chip_smoke()
    cs.k6_against_plain(*cs.k6_inputs(np.random.default_rng(m_f), 16, m_f, m_b, 8, cuda))


@pytest.mark.gpu
def test_a_lane_gives_the_same_bits_in_any_bucket(cuda):
    """Lanes 0-15 of a 512-lane launch and the same lanes launched alone:
    the same weights, frame and errors, bit for bit."""
    from lrr_tpu_torch.pipeline.wave_graph import first_difference

    cs = _chip_smoke()
    fwd, bwd, trans, inv, falloff = cs.k6_inputs(np.random.default_rng(5), 512, 2048, 2048, 8,
                                                 cuda)

    def lanes(pm, n):
        return type(pm)(**{f: getattr(pm, f)[:n] for f in pm.__dataclass_fields__})

    big = kernels.robust_weights(fwd, bwd, trans, inv, falloff)
    small = kernels.robust_weights(lanes(fwd, 16), lanes(bwd, 16), trans[:16], inv[:16], falloff)
    assert first_difference(tuple(t[:16] for t in big), small) is None
    fw, bw = (dataclasses.replace(pm, weight=w) for pm, w in ((fwd, big[0]), (bwd, big[1])))
    err_big = kernels.weighted_error(fw, bw, trans, inv)
    err_small = kernels.weighted_error(lanes(fw, 16), lanes(bw, 16), trans[:16], inv[:16])
    assert first_difference(tuple(t[:16] for t in err_big), err_small) is None


@pytest.mark.gpu
def test_robust_weights_kernel_refuses_bad_inputs(cuda):
    """Wrong dtype, device or shape, matches that are not views of 16-byte
    aligned rows, a mask that is not bool, a wrong `scales`: each raises
    before a launch."""
    cs = _chip_smoke()
    fwd, bwd, trans, inv, falloff = cs.k6_inputs(np.random.default_rng(6), 8, 256, 256, 8, cuda)
    kernels.robust_weights(fwd, bwd, trans, inv, falloff)
    kernels.weighted_error(fwd, bwd, trans, inv)
    rep = dataclasses.replace
    planar = rep(fwd, fxyz=fwd.fxyz.contiguous())
    bad = [
        (rep(fwd, mask=fwd.mask.float()), bwd, trans, inv),
        (rep(fwd, fstr=fwd.fstr.double()), bwd, trans, inv),
        (rep(fwd, txyz=fwd.txyz.cpu()), bwd, trans, inv),
        (planar, bwd, trans, inv),
        (rep(fwd, tdir=fwd.tdir.contiguous()), bwd, trans, inv),
        (rep(fwd, fxyz=fwd.fxyz[:, :, 1:], fstr=fwd.fstr[:, 1:]), bwd, trans, inv),
        (fwd, rep(bwd, mask=bwd.mask[:4]), trans, inv),
        (fwd, bwd, trans[:4], inv),
        (fwd, bwd, trans, type(inv)(inv.A.double(), inv.t, inv.center)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            kernels.robust_weights(*args, falloff)
        with pytest.raises(ValueError):
            kernels.weighted_error(*args)
    with pytest.raises(ValueError):
        kernels.robust_weights(fwd, bwd, trans, inv, falloff,
                               scales=torch.empty((8, 3, 2), device=cuda))
    with pytest.raises(ValueError):
        kernels.weighted_error(rep(fwd, weight=fwd.weight.double()), bwd, trans, inv)


@pytest.mark.gpu
def test_every_rms_weighting_of_a_served_wave_is_one_k6_launch(cuda, monkeypatch):
    """Over the bench context served from graphs and eagerly, K6's weights
    launch as often as K1 (the MUSE iteration has K1 and not K6, the final
    statistics K6 and not K1) and its weighted errors once an iteration; a
    bucket's prologue records no weights launch, each chunk
    ITERATIONS_PER_CHECK, its epilogue two."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline import registration, wave_graph

    ctx, q, cfg, plan = _bench(cuda)
    svm = load_default_verifier()
    wave_graph.drop()
    for runner in (registration._wave_runner, registration._eager_wave_runner):
        monkeypatch.setattr(registration, "_wave_runner", runner)
        kernels.reset_launch_counts()
        register_locations_staged(ctx, q, cfg, svm, plan)
        n = kernels.LAUNCHES
        assert n["robust_weights"] == n["normal_equations"] > 0
        assert n["weighted_error"] > 0 and sum(kernels.ROBUST_SHAPES.values()) == n["robust_weights"]
    graphs = wave_graph.wave_graphs(ctx, cfg, svm, registration.WAVE_STEPS)
    assert graphs.buckets
    for b in graphs.buckets.values():
        assert b.prologue.launches[0].get("robust_weights", 0) == 0
        assert b.epilogue.launches[0]["robust_weights"] == 2
        for g in b.chunks:
            assert g.launches[0]["robust_weights"] == icp.ITERATIONS_PER_CHECK
            assert g.launches[0]["weighted_error"] == icp.ITERATIONS_PER_CHECK
    wave_graph.drop()

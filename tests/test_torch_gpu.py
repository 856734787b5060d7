"""The port's CUDA kernels and its serving slice on the card.

Every test here needs a CUDA GPU and skips without one.  The file imports
neither JAX nor lrr_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import json
import os

import numpy as np
import pytest
import torch

from lrr_tpu_torch.config import pipeline_config_from_dict
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.pipeline.registration import register_locations_staged
from lrr_tpu_torch.sampling import draw_sampling_plan
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

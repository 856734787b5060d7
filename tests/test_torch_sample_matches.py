"""The ICP's match sampler on the CPU: `kernels.sample_matches` (kernel K5's
wrapper) takes its plain version there, the plain version gives the bits
and the layout of the row-gather formulation it replaced, through the bare
map the rows of the baked NN-row grid, and K5's counters move as the other
kernels' do.  K5 itself runs only on the card
(tests/test_torch_gpu.py)."""

import math
import os

import pytest
import torch

from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.ops.voronoi import voxel_ids
from lrr_tpu_torch.pipeline.artifacts import load_pair_context

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_pair_small")


@pytest.fixture(scope="module")
def case():
    """Six lanes on the small context's moving source and fixed target:
    random lane masks (one lane empty, one with a single feature), offsets
    up to 2^62, transforms near the identity, one mapping far outside the
    map (every voxel clamped), and the target's rows."""
    ctx = load_pair_context(SMALL + ".npz", device="cpu")
    g = torch.Generator().manual_seed(19)
    fs = ctx.moving_features
    L, N = 6, fs.capacity
    lane_mask = (torch.rand((L, N), generator=g) < 0.6) & fs.mask[None, :]
    lane_mask[1] = False
    lane_mask[2] = False
    lane_mask[2, int(fs.mask.nonzero()[7])] = True
    src = icp._pack_source(torch.rand((L, N), generator=g), icp._pack_features(fs), lane_mask)
    angle = 0.05 * torch.randn(L, generator=g)
    A = torch.eye(3).repeat(L, 1, 1)
    A[:, 0, 0], A[:, 0, 1] = torch.cos(angle), -torch.sin(angle)
    A[:, 1, 0], A[:, 1, 1] = torch.sin(angle), torch.cos(angle)
    t = 2.0 * torch.randn((L, 3), generator=g)
    t[3] = torch.tensor([1e3, -1e3, 40.0])
    trans = Affine3D(A=A, t=t, center=torch.full((L, 3), 15.0))
    offset = torch.randint(0, 2**62, (L,), generator=g, dtype=torch.int64)
    number = torch.tensor([64, 512, 512, 200, 100000, 1000])
    return dict(ctx=ctx, src=src, trans=trans, offset=offset, number=number,
                dst_rows=icp._pack_features(ctx.fixed_features))


def _row_gather_reference(src, grid, vor, trans, number, cap, offset, dst_rows, p0, m):
    """The sampler as it was written before K5: [L, m, 8] row gathers and
    component-major views of them; the target row from `grid` (a baked
    NN-row grid) or, for None, from the map and `dst_rows`."""
    pos = torch.arange(p0, p0 + m)
    idx = icp._window(src.order, src.valid_count, offset, pos)
    rows = src.rows[idx]
    tag = torch.where(src.lane_mask.gather(1, idx), rows[..., 7], torch.zeros_like(rows[..., 7]))
    win = rows.permute(0, 2, 1)
    limit = torch.clamp(torch.minimum(number, src.valid_count), max=cap)
    sel = (pos[None, :] < limit[:, None]) & (tag > 0.5)
    mapped = icp._apply_packed(trans, win[:, 0:3])
    ids = voxel_ids(tuple(vor.index_vol.shape), vor.origin, vor.spacing, mapped.transpose(1, 2))
    if grid is not None:
        to_rows = grid[ids]
    else:
        nn = vor.index_vol.reshape(-1)[ids]
        to_rows = dst_rows[torch.clamp(nn, min=0).long()]
        to_rows = torch.where((nn >= 0)[..., None], to_rows, torch.zeros_like(to_rows))
    to_row = to_rows.permute(0, 2, 1)
    ok = sel & (to_row[:, 7] > 0.5)
    return dict(fxyz=win[:, 0:3], fstr=win[:, 3], fdir=win[:, 4:7], ftag=tag,
                txyz=to_row[:, 0:3], tstr=to_row[:, 3], tdir=to_row[:, 4:7], ttag=to_row[:, 7],
                weight=ok.to(rows.dtype), mask=ok)


@pytest.mark.parametrize("oracle", ["grid", "map"])
@pytest.mark.parametrize("cap,ranks,rank", [(1024, 1, 0), (640, 1, 0), (300, 3, 1), (1000, 3, 2)])
def test_sampler_gives_the_row_gathers_bits(case, oracle, cap, ranks, rank):
    """`_sample_matches_packed` (through `kernels.sample_matches`, the plain
    version on the CPU) against the row-gather formulation, bit for bit in
    every field, with the target rows gathered from the map and the rows or
    from `icp.bake_target_grid`'s grid at the same voxel ids, for the whole
    window and a mesh rank's block (p0 > 0; the last rank's window padded
    past the capacity, and past every lane's valid count, so nothing of it
    is kept); the fields are views of [L, m, 8] rows, as the row gathers'
    were, so the sums over the matches after the sampler keep their order."""
    ctx, src = case["ctx"], case["src"]
    grid = None
    if oracle == "grid":
        grid = icp.bake_target_grid(ctx.fixed_features, ctx.fixed_vor)
    mx = icp._WHOLE
    if ranks > 1:
        mx = icp._MatchAxis()
        mx.n, mx.i = ranks, rank
    pm = icp._sample_matches_packed(src, ctx.fixed_vor, case["trans"], case["number"], cap,
                                    case["offset"], dst_rows=case["dst_rows"], mx=mx)
    p0, m = mx.block(min(cap, src.order.shape[1]))
    assert (p0 > 0) == (rank > 0) and m == math.ceil(min(cap, 1024) / ranks)
    want = _row_gather_reference(src, grid, ctx.fixed_vor, case["trans"], case["number"],
                                 min(cap, 1024), case["offset"], case["dst_rows"], p0, m)
    for name, w in want.items():
        got = getattr(pm, name)
        assert got.shape == w.shape and got.stride(-1) == (1 if name in ("weight", "mask")
                                                            else 8), name
        assert torch.equal(got, w), name
    assert not bool(pm.mask[1].any()) and int(pm.mask[2].sum()) <= 1
    assert bool(pm.mask.any()) == (p0 < 300)


def test_sample_matches_on_the_cpu_is_the_plain_version(case):
    """The wrapper's CPU path is `icp.sample_matches_plain`, bit for bit, and
    launches nothing."""
    ctx, src = case["ctx"], case["src"]
    args = (src, ctx.fixed_vor, case["trans"], case["number"], 1024, case["offset"])
    before = kernels.counts()
    got = kernels.sample_matches(*args, dst_rows=case["dst_rows"], p0=0, m=1024)
    assert kernels.counts() == before
    want = icp.sample_matches_plain(*args, dst_rows=case["dst_rows"], p0=0, m=1024)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s, d, weight, ok = got
    assert s.shape == d.shape == (6, 1024, 8) and weight.shape == ok.shape == (6, 1024)
    assert torch.equal(weight, ok.float())


def test_sample_shapes_survive_the_counter_round_trip():
    """`SAMPLE_SHAPES` moves through `counts()` -> `counts_since()` ->
    `add_counts()` as the other logs do: a capture's K5 launches are taken
    back and each replay adds them."""
    kernels.reset_launch_counts()
    before = kernels.counts()
    assert len(before) == 7 and before[5] == {}
    kernels.LAUNCHES["sample_matches"] += 4
    kernels.SAMPLE_SHAPES[(512, 2048)] = 4
    kernels.SAMPLE_SHAPES[(8, 8000)] = 1
    kernels.LAUNCHES["sample_matches"] += 1
    delta = kernels.counts_since(before)
    assert delta == ({"sample_matches": 5}, {}, {}, {}, {},
                     {(512, 2048): 4, (8, 8000): 1}, {})
    kernels.add_counts(delta, -1)
    assert kernels.counts() == before
    kernels.add_counts(delta, 3)
    assert kernels.LAUNCHES["sample_matches"] == 15
    assert kernels.SAMPLE_SHAPES == {(512, 2048): 12, (8, 8000): 3}
    kernels.reset_launch_counts()
    assert kernels.counts()[5] == {} and kernels.LAUNCHES["sample_matches"] == 0


def test_sample_matches_bound_counts_each_byte_once():
    """K5's least time: 77 bytes a window position (its permutation entry
    read, two rows, weight and mask written), the source table and each
    distinct target read (map sector or feature row) once, at the streaming
    peak; the target reads priced at a slower random-row rate cost more."""
    from lrr_tpu_torch.utils import sol

    ms, by = sol.sample_matches_bound_ms(512, 2048, 65536, 300_000)
    nbytes = 512 * 2048 * 77 + 65536 * 32 + 300_000 * 32
    assert by == "bytes" and ms == pytest.approx(nbytes / (sol.PEAK_HBM_GBS * 1e9) * 1e3)
    slow, _ = sol.sample_matches_bound_ms(512, 2048, 65536, 300_000, gather_gb_s=430.0)
    assert slow > ms

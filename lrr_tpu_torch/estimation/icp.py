"""Symmetric robust feature-shape-aware affine ICP (lrr_tpu/estimation/icp.py).

One call refines L candidate lanes at once: every per-candidate tensor has a
leading lane dim (what `vmap` gives in the JAX package), and the JAX
`lax.while_loop` is a Python loop over iterations with a per-lane `active`
mask; finished lanes keep their carry through `torch.where`, which is what
`vmap(while_loop)` does.  The loop reads "any lane active" back once every
`ITERATIONS_PER_CHECK` iterations (`Refinement`, whose parts
pipeline/wave_graph.py captures as CUDA graphs on the card).

Per iteration (see the JAX package for the reference citations): forward
and backward matches from a rolling window of each lane's random source
permutation, nearest neighbour by the voxel's feature index in the target's
bare Voronoi index map, then that feature's packed row (on the card both
directions' sampling is kernel K5); robust scale
(MUSE on iteration 0, RMS after), Beaton-Tukey weights, strength and
spatial weights with MAD normalisation, weight floor (after iteration 0,
kernel K6 on the card, which also computes the weighted errors); one
12x12 normal-equation system for the forward parameters from both
directions (kernel K1, which also normalises the coordinates and reads
the projector coefficients off the row tag), pseudo-inverse solve;
convergence, oscillation and the match-count doubling schedule.

Per-match tensors are component-major, [L, C, M].  The JAX package bakes
the lookup into an NN-row grid, one packed target row a voxel, in TPU-only
layouts (the [V/16, 128] packed grid, `_take_rows8`, `flat_take`); the port
serves every match from the bare map and the [N, 8] target rows, which give
the same rows (`bake_target_grid`, the port of the JAX bake, is the oracle
the tests hold them against).

`model="rigid"` swaps the 12-dof solve for a 6-dof small-angle increment on
the mapped points (cdcl_estimation.txx:111-165); its 6x6 system is plain
PyTorch and does not go through K1.

With a mesh (`register_candidate(mesh=, match_axis="mp")`) the match axis
is split over the `match_axis` ranks (`_MatchAxis`): a rank samples,
matches and weighs its block of each window's positions and runs K1 on it;
the statistics over all of a lane's matches see every match (the MAD and
MUSE scales gather the per-match values, means and sums add the ranks'
partial sums), and an all-reduce adds the normal equations.  Every rank then
holds the same carry and takes the same host decisions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lrr_tpu_torch.config import EstimationConfig
from lrr_tpu_torch.models.affine import (
    Affine3D, covariance_unnormalize, mm3, mv3, pinv_hermitian,
)
from lrr_tpu_torch.models.rigid import orthogonalize, skew
from lrr_tpu_torch.ops import kernels, robust
from lrr_tpu_torch.ops.voronoi import lookup, voxel_ids
from lrr_tpu_torch.parallel.distributed import all_gather, all_reduce_sum
from lrr_tpu_torch.sampling import ICPDraws
from lrr_tpu_torch.types import SHEET, TUBE, FeatureSet

WEIGHT_FLOOR = 1e-4  # accumulation skip threshold (symmetric .txx:469,576)
SCALE_FLOOR = 0.005  # (symmetric .txx:701,704)


@dataclasses.dataclass
class VoronoiGrid:
    index_vol: torch.Tensor  # int32 [D, H, W], -1 = empty
    origin: torch.Tensor  # [3]
    spacing: torch.Tensor  # [3]


@dataclasses.dataclass
class ICPResult:
    """Per-lane results; every field has a leading lane dim [L]."""

    trans: Affine3D  # forward transform (world, zero-centered)
    covar: torch.Tensor  # [L, 12, 12] theta-order parameter covariance
    converged: torch.Tensor
    valid: torch.Tensor
    oscillated: torch.Tensor
    iterations: torch.Tensor
    weighted_error: torch.Tensor
    weighted_error_backward: torch.Tensor
    sheet_angles: torch.Tensor
    tube_angles: torch.Tensor
    sheet_angles_backward: torch.Tensor
    tube_angles_backward: torch.Tensor
    number_matches: torch.Tensor
    initial_rms: torch.Tensor
    final_rms: torch.Tensor


@dataclasses.dataclass
class _Carry:
    trans: Affine3D
    covar: torch.Tensor
    weighted_error: torch.Tensor
    we_bwd: torch.Tensor
    error_difference: torch.Tensor
    oscillation_count: torch.Tensor
    number_matches: torch.Tensor
    finest_level: torch.Tensor
    iteration: torch.Tensor
    converged: torch.Tensor
    valid: torch.Tensor
    initial_rms: torch.Tensor


def _where(active: torch.Tensor, new, old):
    """Per-lane select over a carry (dataclass of tensors, nested)."""
    if isinstance(new, torch.Tensor):
        a = active.reshape(active.shape + (1,) * (new.dim() - 1))
        return torch.where(a, new, old)
    return type(new)(
        **{
            f.name: _where(active, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        }
    )


class _MatchAxis:
    """The match axis of a refinement: whole (no mesh), or split over the
    ranks of `axis` of `mesh`, each holding one contiguous block of every
    window's positions (the window padded to a multiple of the rank count;
    padded positions are masked out).  With one rank every method is the
    plain operation, bit for bit."""

    def __init__(self, mesh=None, axis: str = "mp"):
        self.mesh, self.axis = mesh, axis
        self.n = 1 if mesh is None else mesh.axis_size(axis)
        self.i = 0 if mesh is None else mesh.axis_index(axis)

    def block(self, cap: int) -> tuple[int, int]:
        """(first, count) of this rank's window positions of a length-`cap`
        window."""
        m = -(-cap // self.n)
        return self.i * m, m

    def positions(self, cap: int, device) -> torch.Tensor:
        """This rank's window positions of a length-`cap` window."""
        p0, m = self.block(cap)
        return torch.arange(p0, p0 + m, device=device)

    def reduce(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """Each partial sum x added over the ranks, in one all-reduce."""
        if self.n == 1:
            return list(xs)
        flat = all_reduce_sum(self.mesh, torch.cat([x.reshape(-1) for x in xs]), self.axis)
        return [t.reshape(x.shape) for t, x in zip(torch.split(flat, [x.numel() for x in xs]), xs)]

    def sums(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """Each x summed over its last (match) dim and over the ranks."""
        return self.reduce(*[x.sum(-1) for x in xs])

    def gather(self, x: torch.Tensor, mask: torch.Tensor):
        """(x, mask) [L, m] of every rank as one window [L, n * m], for the
        order statistics: its padded positions are masked, so they sort
        after every match and change no scale."""
        if self.n == 1:
            return x, mask
        both = all_gather(self.mesh, torch.stack([x, mask.to(x.dtype)]), self.axis, dim=-1)
        return both[0], both[1] > 0.5


_WHOLE = _MatchAxis()


def _mad_scale_dof(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rrel_util_median_abs_dev_scale with dof=1: 1.4826*(1+5/(n-1)) * upper
    median of |values| along the last dim."""
    big = torch.finfo(values.dtype).max
    n = mask.sum(-1)
    v = torch.sort(
        torch.where(mask, values.abs(), torch.full_like(values, big)), dim=-1
    ).values
    loc = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor") + 1, 0, values.shape[-1] - 1)
    med = v.gather(-1, loc[..., None])[..., 0]
    nf = torch.clamp(n - 1, min=1).to(values.dtype)
    return 1.4826 * (1.0 + 5.0 / nf) * med


def _source_permutation(scores: torch.Tensor, mask: torch.Tensor):
    """Per-lane random permutation of the valid source indices (valid
    first); `scores` are the lane's uniform draws.  Stable sort, as JAX's."""
    s = torch.where(mask, scores, torch.full_like(scores, math.inf))
    order = torch.sort(s, dim=-1, stable=True).indices
    return order, mask.sum(-1)


# Hot-loop row: 0:3 xyz | 3 strength | 4:7 projector direction d | 7 tag,
# with P = c1*I + c2*d d^T (sheet: d = normal, c = (0, +1); tube: d =
# tangent, c = (1, -1); corner: c = (1, 0)); tag 0 = invalid/padding,
# 1 = corner, 2 = sheet, 3 = tube.


def _proj_rows_to_dir_tag(proj9: torch.Tensor, valid: torch.Tensor):
    """Row-major projector components [9, M] -> (d [3, M], tag [M]) with
    P = c1*I + c2*d d^T (classified by trace; d from the rank-1 part)."""
    tr = proj9[0] + proj9[4] + proj9[8]
    is_sheet = tr < 1.5
    is_tube = (~is_sheet) & (tr < 2.5)
    eye9 = torch.zeros(9, dtype=proj9.dtype, device=proj9.device)
    eye9[::4] = 1.0  # made on the device: no host value inside a CUDA graph
    s = torch.where(is_sheet[None, :], proj9, eye9[:, None] - proj9)
    diag = torch.stack([s[0], s[4], s[8]])
    j = torch.argmax(diag, dim=0)
    col = torch.stack(
        [sum((j == c) * s[3 * r + c] for c in range(3)) for r in range(3)]
    )
    d = col / torch.clamp(
        torch.sqrt(col[0] ** 2 + col[1] ** 2 + col[2] ** 2), min=1e-20
    )[None, :]
    rank1 = is_sheet | is_tube
    d = torch.where(rank1[None, :], d, torch.zeros_like(d))
    tag = torch.where(
        valid,
        torch.where(
            is_sheet, torch.full_like(tr, 2.0),
            torch.where(is_tube, torch.full_like(tr, 3.0), torch.ones_like(tr)),
        ),
        torch.zeros_like(tr),
    )
    return d, tag


def _pack_features(fs: FeatureSet) -> torch.Tensor:
    """[N, 8] hot-loop rows (layout above)."""
    n = fs.capacity
    proj9 = fs.projector.float().reshape(n, 9).T
    d, tag = _proj_rows_to_dir_tag(proj9, fs.mask)
    return torch.cat(
        [fs.xyz.float(), fs.strength.float()[:, None], d.T, tag[:, None]], dim=1
    )


# Wide rows for the statistics passes (counterpart of `_pack_features32`):
# 0:8 the hot-loop row | 8 shape | 9:12 dir0 | 12:15 dir1 | 15 mask.


def _pack_features_wide(fs: FeatureSet) -> torch.Tensor:
    return torch.cat(
        [
            _pack_features(fs),
            fs.shape.float()[:, None],
            fs.directions[:, 0, :].float(),
            fs.directions[:, 1, :].float(),
            fs.mask.float()[:, None],
        ],
        dim=1,
    )


def bake_target_grid(targets: FeatureSet, vor: VoronoiGrid) -> torch.Tensor:
    """The NN lookup baked into the Voronoi grid: [V, 8], each voxel's row
    is the packed row of its nearest feature (zeros, tag 0, for empty
    voxels): the JAX package's pair-level grid.  Nothing in the program
    calls it; the tests hold the map lookup of `sample_matches_plain` and
    K5 against its rows."""
    flat = vor.index_vol.reshape(-1).long()
    rows = _pack_features(targets)[torch.clamp(flat, min=0)]
    return torch.where((flat >= 0)[:, None], rows, torch.zeros_like(rows))


@dataclasses.dataclass
class _PackedSource:
    """Per-lane sampling state: the lane's permutation of the source set,
    whose packed rows are `rows` (of the full set) under the lane's mask."""

    rows: torch.Tensor  # [N, 8]
    lane_mask: torch.Tensor  # [L, N]
    order: torch.Tensor  # [L, N]
    valid_count: torch.Tensor  # [L]


def _pack_source(scores: torch.Tensor, rows: torch.Tensor, lane_mask: torch.Tensor):
    order, valid = _source_permutation(scores, lane_mask)
    return _PackedSource(rows, lane_mask, order, valid)


def _window(order, valid, offset, pos: torch.Tensor) -> torch.Tensor:
    """Indices at window positions `pos` [m] of each lane's cyclic window
    of its permutation starting at `offset` (taken modulo the lane's valid
    count): the JAX package's dynamic_slice of the cyclically extended
    table, at positions arange(cap) for the whole window."""
    v = torch.clamp(valid, min=1)
    at = torch.remainder((offset % v)[:, None] + pos[None, :], v[:, None])
    return order.gather(1, at)


@dataclasses.dataclass
class PackedMatches:
    """Single-direction match set, component-major [L, C, M]."""

    fxyz: torch.Tensor  # [L, 3, M] source (from) locations
    fstr: torch.Tensor  # [L, M]
    txyz: torch.Tensor  # [L, 3, M] target (to) locations
    tstr: torch.Tensor
    tdir: torch.Tensor  # [L, 3, M] target projector direction
    ttag: torch.Tensor
    fdir: torch.Tensor  # [L, 3, M] source projector direction
    ftag: torch.Tensor
    weight: torch.Tensor  # [L, M]
    mask: torch.Tensor  # [L, M] bool


def _apply_packed(trans: Affine3D, x: torch.Tensor) -> torch.Tensor:
    """trans.apply for component-major points x [L, 3, M]; unrolled
    multiply-adds (never a matmul that could run in TF32)."""
    xc = x - trans.center[:, :, None]
    A = trans.A
    return torch.stack(
        [
            A[:, r, 0, None] * xc[:, 0]
            + A[:, r, 1, None] * xc[:, 1]
            + A[:, r, 2, None] * xc[:, 2]
            + trans.t[:, r, None]
            for r in range(3)
        ],
        dim=1,
    )


def sample_matches_plain(src: _PackedSource, vor: VoronoiGrid, trans: Affine3D,
                         number: torch.Tensor, cap: int, offset: torch.Tensor, *,
                         dst_rows: torch.Tensor, p0: int, m: int):
    """Kernel K5's plain version (`kernels.sample_matches`, which the CPU
    takes): window positions [p0, p0 + m) of each lane's cyclic window of
    capacity `cap` (at most the permutation's length), the source rows under
    the lane's mask, mapped through `trans` and matched by the voxel's
    feature index read from the map and that feature's row of `dst_rows`
    (an empty voxel gets the zero row, tag 0).  Returns the matches' rows
    src, dst [L, m, 8] (src column 7 the tag under the lane's mask), the
    weight and the mask [L, m] of the kept matches."""
    pos = torch.arange(p0, p0 + m, device=src.order.device)
    idx = _window(src.order, src.valid_count, offset, pos)
    s = src.rows[idx]  # [L, m, 8]
    s[..., 7] = torch.where(src.lane_mask.gather(1, idx), s[..., 7],
                            torch.zeros_like(s[..., 7]))
    limit = torch.clamp(torch.minimum(number, src.valid_count), max=cap)
    sel = (pos[None, :] < limit[:, None]) & (s[..., 7] > 0.5)

    mapped = _apply_packed(trans, s.permute(0, 2, 1)[:, 0:3])
    ids = voxel_ids(tuple(vor.index_vol.shape), vor.origin, vor.spacing,
                    mapped.transpose(1, 2))
    nn = vor.index_vol.reshape(-1)[ids]
    to_rows = dst_rows[torch.clamp(nn, min=0).long()]
    to_rows = torch.where((nn >= 0)[..., None], to_rows, torch.zeros_like(to_rows))
    ok = sel & (to_rows[..., 7] > 0.5)
    return s, to_rows, ok.to(s.dtype), ok


def _sample_matches_packed(
    src: _PackedSource,
    vor: VoronoiGrid,
    trans: Affine3D,
    number: torch.Tensor,  # [L]
    cap: int,
    offset: torch.Tensor,  # [L] raw offsets
    *,
    dst_rows: torch.Tensor,  # [N, 8] the target rows `vor` indexes
    mx: _MatchAxis = _WHOLE,
) -> PackedMatches:
    """A window of `cap` source rows per lane, mapped through `trans` and
    matched through the target's map (`sample_matches_plain`): one K5
    launch on the card.  With `mx` split over ranks, this rank's block of
    the window.  The fields are component-major views of the [L, M, 8]
    rows: the later sums over the matches take their order from that
    layout."""
    cap = min(cap, src.order.shape[1])
    p0, m = mx.block(cap)
    trans = Affine3D(A=trans.A.contiguous(), t=trans.t.contiguous(),
                     center=trans.center.contiguous())
    s, d, weight, ok = kernels.sample_matches(
        src, vor, trans, number.to(torch.int64).contiguous(), cap,
        offset.to(torch.int64).contiguous(), dst_rows=dst_rows, p0=p0, m=m,
    )
    s, d = s.permute(0, 2, 1), d.permute(0, 2, 1)  # [L, 8, M] views
    return PackedMatches(
        fxyz=s[:, 0:3], fstr=s[:, 3], txyz=d[:, 0:3], tstr=d[:, 3], tdir=d[:, 4:7],
        ttag=d[:, 7], fdir=s[:, 4:7], ftag=s[:, 7], weight=weight, mask=ok,
    )


def _residual2_packed(trans: Affine3D, pm: PackedMatches) -> torch.Tensor:
    """e^T P e per match, [L, M]."""
    e = _apply_packed(trans, pm.fxyz) - pm.txyz
    c1, c2 = kernels.c1c2(pm.ttag)
    a = e[:, 0] ** 2 + e[:, 1] ** 2 + e[:, 2] ** 2
    b = pm.tdir[:, 0] * e[:, 0] + pm.tdir[:, 1] * e[:, 1] + pm.tdir[:, 2] * e[:, 2]
    return torch.clamp(c1 * a + c2 * b * b, min=0.0)


def _replace(pm: PackedMatches, weight: torch.Tensor) -> PackedMatches:
    return dataclasses.replace(pm, weight=weight)


def _scale_and_bt_weights_packed(
    trans: Affine3D, pm: PackedMatches, muse: tuple[float, float] | None,
    mx: _MatchAxis = _WHOLE,
) -> PackedMatches:
    """Beaton-Tukey weights at the MUSE scale (`muse` = its (min, max)
    inlier fractions) or, for None, the RMS scale."""
    r2 = _residual2_packed(trans, pm)
    msk = pm.mask
    zero = torch.zeros_like(r2)
    if muse is not None:
        scale = robust.muse_scale(*mx.gather(torch.sqrt(r2), msk), *muse)
    else:
        r2_sum, count = mx.sums(torch.where(msk, r2, zero), msk.to(r2.dtype))
        scale = torch.sqrt(r2_sum / torch.clamp(count, min=1))
    scale = torch.clamp(scale, min=SCALE_FLOOR)
    s2 = (scale * scale)[:, None]
    w = robust.weight_bt(r2 / s2) / s2
    return _replace(pm, torch.where(msk, w, zero))


def _weight_by_strength_packed(pm: PackedMatches, mx: _MatchAxis = _WHOLE) -> PackedMatches:
    gw = torch.clamp(pm.fstr * pm.tstr, max=90000.0)
    nz = pm.mask & (pm.weight != 0.0)
    w = torch.where(nz, pm.weight * gw, pm.weight)
    scale = _mad_scale_dof(*mx.gather(gw, nz))
    return _replace(pm, w / torch.clamp(scale, min=1e-30)[:, None])


def _weight_spatially_packed(to_norm, pm: PackedMatches, falloff: float,
                             mx: _MatchAxis = _WHOLE):
    d2 = to_norm[:, 0] ** 2 + to_norm[:, 1] ** 2 + to_norm[:, 2] ** 2
    sw = 1.0 / (1.0 + falloff * d2)
    scale = _mad_scale_dof(*mx.gather(sw, pm.mask))
    return _replace(pm, pm.weight * sw / torch.clamp(scale, min=1e-30)[:, None])


def _weighted_error_packed(trans: Affine3D, pm: PackedMatches,
                           mx: _MatchAxis = _WHOLE) -> torch.Tensor:
    r2 = _residual2_packed(trans, pm)
    w = torch.where(pm.mask, pm.weight, torch.zeros_like(pm.weight))
    err_sum, w_sum = mx.sums(torch.sqrt(r2) * w, w)
    return err_sum / torch.clamp(w_sum, min=1e-30)


def _feature_rms_packed(trans: Affine3D, pm: PackedMatches,
                        mx: _MatchAxis = _WHOLE) -> torch.Tensor:
    """Unweighted RMS sqrt(mean e^T P e) over the current matches."""
    r2 = _residual2_packed(trans, pm)
    r2_sum, count = mx.sums(torch.where(pm.mask, r2, torch.zeros_like(r2)), pm.mask.to(r2.dtype))
    return torch.sqrt(r2_sum / torch.clamp(count, min=1))


@dataclasses.dataclass
class StatsSample:
    """Full-payload match sample for the statistics passes: both sides'
    wide rows [L, 16, M] plus selection."""

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor


def _sample_stats_packed(
    offset: torch.Tensor,  # [L] raw
    order: torch.Tensor,  # [L, n]
    valid: torch.Tensor,  # [L]
    wide_src: torch.Tensor,  # [n, 16]
    wide_dst: torch.Tensor,  # [n, 16]
    vor: VoronoiGrid,
    trans: Affine3D,
    number: torch.Tensor,  # [L]
    cap: int,
    mx: _MatchAxis = _WHOLE,
) -> StatsSample:
    """A random cyclic window of the permutation, Voronoi NN, one wide row
    gather per side (this rank's block of the window with `mx` split)."""
    cap = min(cap, order.shape[1])
    pos = mx.positions(cap, order.device)
    idx = _window(order, valid, offset, pos)
    src = wide_src[idx].permute(0, 2, 1)
    limit = torch.clamp(torch.minimum(number, valid), max=cap)
    sel = (pos[None, :] < limit[:, None]) & (src[:, 15] > 0.5)
    mapped = _apply_packed(trans, src[:, 0:3])
    nn = lookup(vor.index_vol, vor.origin, vor.spacing, mapped.transpose(1, 2))
    ok = sel & (nn >= 0)
    dst = wide_dst[torch.clamp(nn, min=0).long()].permute(0, 2, 1)
    return StatsSample(
        src=src, dst=dst, weight=ok.to(src.dtype), mask=ok & (dst[:, 15] > 0.5)
    )


def _as_packed_matches(s: StatsSample) -> PackedMatches:
    return PackedMatches(
        fxyz=s.src[:, 0:3], fstr=s.src[:, 3], txyz=s.dst[:, 0:3],
        tstr=s.dst[:, 3], tdir=s.dst[:, 4:7], ttag=s.dst[:, 7],
        fdir=s.src[:, 4:7], ftag=s.src[:, 7], weight=s.weight, mask=s.mask,
    )


def _norm_rows(d):
    n = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2)
    return d / torch.clamp(n, min=1e-12)[:, None]


def _cross_rows(a, b):
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=1,
    )


def _angle_stats_packed(trans: Affine3D, s: StatsSample, weight: torch.Tensor,
                        mx: _MatchAxis = _WHOLE):
    """Weighted mean sheet-normal / tube-tangent angle disagreement, [L]
    each.  For an affine map the mapped direction is A d."""
    A = trans.A

    def mat3(x):
        return torch.stack(
            [
                A[:, r, 0, None] * x[:, 0] + A[:, r, 1, None] * x[:, 1]
                + A[:, r, 2, None] * x[:, 2]
                for r in range(3)
            ],
            dim=1,
        )

    def wmean_angle(p_dir, q_dir, pair_mask):
        pm = _norm_rows(mat3(p_dir))
        c = torch.clamp((pm * q_dir).sum(1), -1.0, 1.0)
        ang = torch.acos(c)
        ang = torch.where(ang > math.pi / 2, math.pi - ang, ang)
        w = torch.where(pair_mask & s.mask, weight, torch.zeros_like(weight))
        ang_sum, w_sum = mx.sums(w * ang, w)
        return ang_sum / torch.clamp(w_sum, min=1e-30)

    f_shape = s.src[:, 8].to(torch.int32)
    t_shape = s.dst[:, 8].to(torch.int32)
    sheet = wmean_angle(
        s.src[:, 9:12], s.dst[:, 9:12], (f_shape == SHEET) & (t_shape == SHEET)
    )
    p_tan = _cross_rows(s.src[:, 9:12], s.src[:, 12:15])
    q_tan = _norm_rows(_cross_rows(s.dst[:, 9:12], s.dst[:, 12:15]))
    tube = wmean_angle(p_tan, q_tan, (f_shape == TUBE) & (t_shape == TUBE))
    return sheet, tube


def _masked_mean_rows(x: torch.Tensor, mask: torch.Tensor,
                      mx: _MatchAxis = _WHOLE) -> torch.Tensor:
    """Mean of [L, C, M] over valid lanes -> [L, C]."""
    total, n = mx.sums(torch.where(mask[:, None, :], x, torch.zeros_like(x)), mask.to(x.dtype))
    return total / torch.clamp(n, min=1)[:, None]


def robust_weights_plain(fwd: PackedMatches, bwd: PackedMatches, trans: Affine3D,
                         inv: Affine3D, falloff: float, *,
                         muse: tuple[float, float] | None = None, mx: _MatchAxis = _WHOLE):
    """The robust-weighting pipeline of estimate_LS (symmetric .txx:698-728)
    as PyTorch ops: `fwd` under `trans`, `bwd` under `inv` (its inverse),
    the MUSE scale with `muse` (its inlier fractions) or else the RMS
    scale, Beaton-Tukey, strength and spatial weights with MAD
    normalisation, the weight floor.  Returns the weights (w_f, w_b) and the
    normalisation frame (cm, cf [L, 3], rm, rf [L]).  With the RMS scale and
    the match axis whole it is kernel K6's plain version
    (`kernels.robust_weights`, which the CPU takes)."""
    fwd = _scale_and_bt_weights_packed(trans, fwd, muse, mx)
    bwd = _scale_and_bt_weights_packed(inv, bwd, muse, mx)

    cm = _masked_mean_rows(fwd.fxyz, fwd.mask, mx)
    cf = _masked_mean_rows(fwd.txyz, fwd.mask, mx)
    dm = fwd.fxyz - cm[:, :, None]
    df = fwd.txyz - cf[:, :, None]
    rm = torch.clamp(
        _masked_mean_rows(
            torch.sqrt(dm[:, 0] ** 2 + dm[:, 1] ** 2 + dm[:, 2] ** 2)[:, None], fwd.mask, mx
        )[:, 0],
        min=1e-6,
    )
    rf = torch.clamp(
        _masked_mean_rows(
            torch.sqrt(df[:, 0] ** 2 + df[:, 1] ** 2 + df[:, 2] ** 2)[:, None], fwd.mask, mx
        )[:, 0],
        min=1e-6,
    )

    def norm_m(x):
        return (x - cm[:, :, None]) / rm[:, None, None]

    def norm_f(x):
        return (x - cf[:, :, None]) / rf[:, None, None]

    fwd = _weight_by_strength_packed(fwd, mx)
    bwd = _weight_by_strength_packed(bwd, mx)
    fwd = _weight_spatially_packed(norm_f(fwd.txyz), fwd, falloff, mx)
    bwd = _weight_spatially_packed(norm_m(bwd.txyz), bwd, falloff, mx)

    zero = torch.zeros_like(fwd.weight)
    w_f = torch.where(fwd.weight >= WEIGHT_FLOOR, fwd.weight, zero)
    w_b = torch.where(bwd.weight >= WEIGHT_FLOOR, bwd.weight, torch.zeros_like(bwd.weight))
    return w_f, w_b, cm, cf, rm, rf


def _weighted_matches_packed(trans, fwd, bwd, use_muse: bool, cfg: EstimationConfig,
                             mx: _MatchAxis = _WHOLE):
    """The shared robust-weighting pipeline of estimate_LS: the weighted
    match sets and the normalisation frame (cm, cf [L, 3], rm, rf [L]).
    With the RMS scale and the match axis whole, one K6 launch on the card
    (`kernels.robust_weights`); the MUSE iteration, whose scale reads the
    whole sorted row, and a split match axis, whose statistics gather
    across ranks, run the plain chain."""
    inv = trans.inverse()
    if use_muse or mx.n > 1:
        muse = (cfg.muse_min_frac, cfg.muse_max_frac) if use_muse else None
        w_f, w_b, cm, cf, rm, rf = robust_weights_plain(
            fwd, bwd, trans, inv, cfg.spatial_falloff, muse=muse, mx=mx)
    else:
        w_f, w_b, cm, cf, rm, rf = kernels.robust_weights(fwd, bwd, trans, inv,
                                                          cfg.spatial_falloff)
    return _replace(fwd, w_f), _replace(bwd, w_b), cm, cf, rm, rf


def _estimate_ls_packed(trans, fwd, bwd, use_muse: bool, cfg: EstimationConfig,
                        mx: _MatchAxis = _WHOLE):
    """Component-major estimate_LS (symmetric .txx:698-918).  Both
    directions constrain the FORWARD parameters: a backward match (fixed p
    -> moving q) contributes forward(q) ~ p under p's projector.  K1 takes
    the weighted match sets as they are (un-normalised, each direction with
    its own match count) with the frame, and returns the summed system; with
    `mx` split, of this rank's block, and an all-reduce adds the blocks'."""
    fwd, bwd, cm, cf, rm, rf = _weighted_matches_packed(trans, fwd, bwd, use_muse, cfg, mx)
    trans_n = trans.normalize(rm, rf, cm, cf)
    AtA, Atb = mx.reduce(*kernels.normal_equations_sym(
        (fwd.fxyz, fwd.txyz, fwd.tdir, fwd.ttag, fwd.weight),
        (bwd.txyz, bwd.fxyz, bwd.fdir, bwd.ftag, bwd.weight),
        cm, cf, rm, rf, trans_n.center,
    ))

    cov_n = pinv_hermitian(AtA)
    theta = (cov_n * Atb[:, None, :]).sum(-1)
    new_n = Affine3D.from_theta(theta, torch.zeros_like(cm))
    new_w = new_n.unnormalize(rm, rf, cm, cf)
    cov_w = covariance_unnormalize(cov_n, rm, rf, cm, cf)
    return new_w, cov_w, fwd, bwd


def _normal_equations_rigid_packed(
    z: torch.Tensor,  # [L, 3, M] mapped source points, centred at the rotation centre
    b: torch.Tensor,  # [L, 3, M] residual targets (q - mapped)
    pdir: torch.Tensor,  # [L, 3, M] projector direction (decomposed P)
    c1: torch.Tensor,  # [L, M]
    c2: torch.Tensor,  # [L, M]
    weight: torch.Tensor,  # [L, M]
) -> tuple[torch.Tensor, torch.Tensor]:
    """6x6 normal equations [L, 6, 6], [L, 6] for a small-angle rigid
    increment (omega, dt) on already-mapped points (cdcl_estimation.txx:
    111-134; cdcl_trans_rigid3d.cxx:157-160).  Residual model
    e = (omega x z + dt) - b with J = [-[z]x | I]; with P idempotent,
    AtA = G G^T for G = sqrt(w) P J.  Multiply-adds only."""
    zero, one = torch.zeros_like(z[:, 0]), torch.ones_like(z[:, 0])
    jcols = [
        torch.stack([zero, -z[:, 2], z[:, 1]], 1),
        torch.stack([z[:, 2], zero, -z[:, 0]], 1),
        torch.stack([-z[:, 1], z[:, 0], zero], 1),
        torch.stack([one, zero, zero], 1),
        torch.stack([zero, one, zero], 1),
        torch.stack([zero, zero, one], 1),
    ]
    sw = torch.sqrt(torch.clamp(weight, min=0.0))
    rows = []
    for col in jcols:
        dot = pdir[:, 0] * col[:, 0] + pdir[:, 1] * col[:, 1] + pdir[:, 2] * col[:, 2]
        pj = c1[:, None] * col + (c2 * dot)[:, None] * pdir
        rows.append(sw[:, None] * pj)
    G = torch.stack(rows, 1).flatten(2)  # [L, 6, 3M]
    AtA = (G[:, :, None, :] * G[:, None, :, :]).sum(-1)
    y = (sw[:, None] * b).flatten(1)
    Atb = (G * y[:, None, :]).sum(-1)
    return AtA, Atb


def _estimate_ls_rigid_packed(trans, fwd, bwd, use_muse: bool, cfg: EstimationConfig,
                              mx: _MatchAxis = _WHOLE):
    """Rigid (6-dof) twin of `_estimate_ls_packed`: the same robust
    weighting, then one small-angle increment on the mapped points,
    orthogonalised and recomposed onto the current transform
    (cdcl_estimation.txx:111-165, cdcl_trans_rigid3d.h:103-104).  Both
    directions constrain the same forward increment.  The 6x6 system is
    plain PyTorch: K1 computes the 12x12 affine one only."""
    fwd, bwd, *_ = _weighted_matches_packed(trans, fwd, bwd, use_muse, cfg, mx)
    y_f = _apply_packed(trans, fwd.fxyz)
    y_b = _apply_packed(trans, bwd.txyz)

    # rotation centre: the weighted centroid of all mapped points
    w_f, w_b, wy_f, wy_b = mx.sums(
        fwd.weight, bwd.weight, y_f * fwd.weight[:, None], y_b * bwd.weight[:, None]
    )
    c = (wy_f + wy_b) / torch.clamp(w_f + w_b, min=1e-30)[:, None]

    AtA_f, Atb_f, AtA_b, Atb_b = mx.reduce(
        *_normal_equations_rigid_packed(
            y_f - c[:, :, None], fwd.txyz - y_f, fwd.tdir, *kernels.c1c2(fwd.ttag), fwd.weight
        ),
        *_normal_equations_rigid_packed(
            y_b - c[:, :, None], bwd.fxyz - y_b, bwd.fdir, *kernels.c1c2(bwd.ftag), bwd.weight
        ),
    )
    cov6 = pinv_hermitian(AtA_f + AtA_b)
    x = (cov6 * (Atb_f + Atb_b)[:, None, :]).sum(-1)
    omega, dt = x[:, :3], x[:, 3:]

    # recompose: new(x) = Rinc (T(x) - c) + c + dt
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    Rinc = orthogonalize(eye + skew(omega))
    new = Affine3D(
        A=mm3(Rinc, trans.A), t=mv3(Rinc, trans.t - c) + c + dt, center=trans.center
    )
    # the 6-dof increment covariance sits in the top-left of the [12, 12] slot
    cov12 = torch.zeros(x.shape[:1] + (12, 12), dtype=x.dtype, device=x.device)
    cov12[:, :6, :6] = cov6
    return new, cov12, fwd, bwd


def _staged_caps(cfg: EstimationConfig) -> list[int]:
    """Static per-level match capacities of the doubling schedule
    (1000 -> 2000 -> ... -> all, symmetric .txx:423-433), 128-aligned."""
    caps: list[int] = []
    level = max(cfg.initial_matches, 1)
    while level < cfg.max_matches:
        caps.append(min(-(-level // 128) * 128, cfg.max_matches))
        level *= 2
    if not caps or caps[-1] != cfg.max_matches:
        caps.append(cfg.max_matches)
    return caps


# Iterations a level runs between two host reads of "is any lane still
# active" (`register_candidate`, and each chunk graph of
# pipeline/wave_graph.py).  A lane that is done is frozen by the mask, so the
# results are the same bits for every value; a larger one costs up to
# ITERATIONS_PER_CHECK - 1 masked iterations a level, a smaller one a host
# read each.
ITERATIONS_PER_CHECK = 2

# chunks of ITERATIONS_PER_CHECK masked iterations run so far: one a pass of
# `Refinement.levels`' loop, one a chunk graph replayed (wave_graph.py adds
# them, as it adds the kernels' counts).  A Python counter, read as a
# difference around a wave.
_CHUNKS = [0]


def chunks_run() -> int:
    return _CHUNKS[0]


def add_chunks(n: int = 1) -> None:
    _CHUNKS[0] += n


class Refinement:
    """`register_candidate` cut into the parts a CUDA graph captures: the
    sampling sources and the iteration body are built once (`__init__`);
    `start` is the carry after the peeled MUSE iteration, `step` one masked
    iteration of a level, `flags` whether any lane is active at each level,
    `finish` the final statistics pass.  Arguments as `register_candidate`."""

    def __init__(self, moving: FeatureSet, fixed: FeatureSet, fixed_vor: VoronoiGrid,
                 moving_vor: VoronoiGrid, cfg: EstimationConfig, draws: ICPDraws, *,
                 moving_targets: FeatureSet, fixed_targets: FeatureSet,
                 model: str = "affine", mesh=None, match_axis: str = "mp"):
        if model not in ("affine", "rigid"):
            raise ValueError(f"unknown transform model {model!r}")
        self.model, self.cfg, self.draws = model, cfg, draws
        self.fixed_vor, self.moving_vor = fixed_vor, moving_vor
        self.moving_targets, self.fixed_targets = moving_targets, fixed_targets
        self.estimate_ls = _estimate_ls_packed if model == "affine" else _estimate_ls_rigid_packed
        self.mx = _WHOLE if mesh is None else _MatchAxis(mesh, match_axis)
        self.src_m = _pack_source(draws.scores_m, _pack_features(moving_targets), moving.mask)
        self.src_f = _pack_source(draws.scores_f, _pack_features(fixed_targets), fixed.mask)
        self.caps = _staged_caps(cfg)

    def initial(self, init: Affine3D) -> _Carry:
        """The carry before iteration 0."""
        if self.model == "rigid":
            # keypoint-frame initialisations are only approximately
            # orthogonal: project onto the nearest rotation before refining
            init = dataclasses.replace(init, A=orthogonalize(init.A))
        L, dev = init.A.shape[0], init.A.device
        zf = torch.zeros(L, dtype=init.A.dtype, device=dev)
        zi = torch.zeros(L, dtype=torch.int64, device=dev)
        return _Carry(
            trans=init, covar=torch.zeros((L, 12, 12), dtype=init.A.dtype, device=dev),
            weighted_error=zf, we_bwd=zf, error_difference=zf, oscillation_count=zi,
            number_matches=torch.full_like(zi, self.cfg.initial_matches),
            finest_level=torch.zeros(L, dtype=torch.bool, device=dev), iteration=zi,
            converged=torch.zeros(L, dtype=torch.bool, device=dev),
            valid=torch.ones(L, dtype=torch.bool, device=dev), initial_rms=zf,
        )

    def start(self, init: Affine3D) -> _Carry:
        """Iteration 0, with the MUSE scale, on every lane."""
        return self.body(self.caps[0], True, self.initial(init))

    def body(self, cap: int, use_muse: bool, c: _Carry) -> _Carry:
        """One iteration of every lane at match capacity `cap`."""
        cfg, draws, mx = self.cfg, self.draws, self.mx
        n_offsets = cfg.max_iterations + 1
        it = torch.clamp(c.iteration, max=n_offsets - 1)[:, None]
        fwd = _sample_matches_packed(
            self.src_m, self.fixed_vor, c.trans, c.number_matches, cap,
            draws.offsets_f.gather(1, it)[:, 0], dst_rows=self.src_f.rows, mx=mx,
        )
        bwd = _sample_matches_packed(
            self.src_f, self.moving_vor, c.trans.inverse(), c.number_matches,
            cap, draws.offsets_b.gather(1, it)[:, 0], dst_rows=self.src_m.rows, mx=mx,
        )
        new_trans, cov_w, fwd_w, bwd_w = self.estimate_ls(c.trans, fwd, bwd, use_muse, cfg, mx)
        if mx.n > 1:
            we_after = _weighted_error_packed(new_trans, fwd_w, mx)
            we_bwd = _weighted_error_packed(new_trans.inverse(), bwd_w, mx)
        else:  # one K6 launch on the card
            we_after, we_bwd = kernels.weighted_error(fwd_w, bwd_w, new_trans,
                                                      new_trans.inverse())

        curr_diff = we_after - c.weighted_error
        rate = curr_diff / torch.where(
            we_after == 0, torch.full_like(we_after, 1e-30), we_after
        )
        converged = rate.abs() < cfg.convergence_tol

        osc = c.oscillation_count
        # oscillation logic (.txx:388-421), active from iteration 1
        not_finest_switch = (~c.finest_level) & ((osc > 1) | (rate.abs() < 0.01))
        sign_change = curr_diff * c.error_difference < 0.0
        osc_mode1 = torch.where(sign_change, osc + 1, torch.clamp(osc - 1, min=0))
        conv_mode1 = osc_mode1 > cfg.max_oscillations
        osc_mode2 = torch.where(curr_diff > 0.0, osc + 1, osc)
        conv_mode2 = osc_mode2 > 3
        big_error = we_after > 1.5
        osc_new = torch.where(big_error, osc_mode1, osc_mode2)
        conv_osc = torch.where(big_error, conv_mode1, conv_mode2)

        started = c.iteration > 0
        active = started & ~converged
        converged = converged | (started & not_finest_switch)
        osc_new = torch.where(active & ~not_finest_switch, osc_new, osc)
        converged = converged | (active & ~not_finest_switch & conv_osc)

        initial_rms = _feature_rms_packed(new_trans, fwd_w, mx) if use_muse else c.initial_rms

        # resolution switching: double the match count (.txx:423-433)
        do_switch = converged & ~c.finest_level
        new_number = torch.where(do_switch, c.number_matches * 2, c.number_matches)
        at_max = (new_number >= self.src_m.valid_count) & (new_number >= self.src_f.valid_count)
        new_finest = torch.where(do_switch, at_max, c.finest_level)
        osc_new = torch.where(do_switch, torch.zeros_like(osc_new), osc_new)
        new_err_diff = torch.where(do_switch, torch.zeros_like(curr_diff), curr_diff)
        converged = converged & ~do_switch

        return _Carry(
            trans=new_trans, covar=cov_w, weighted_error=we_after, we_bwd=we_bwd,
            error_difference=new_err_diff, oscillation_count=osc_new,
            number_matches=new_number, finest_level=new_finest,
            iteration=c.iteration + 1, converged=converged & new_finest,
            valid=new_trans.is_valid(*cfg.singular_value_bounds),
            initial_rms=initial_rms,
        )

    def active(self, c: _Carry, k: int) -> torch.Tensor:
        """[L] lanes that run at level k: not done, and (below the last
        level) within the level's match capacity."""
        act = (~c.converged) & (c.iteration < self.cfg.max_iterations) & c.valid
        if k < len(self.caps) - 1:
            act = act & (c.number_matches <= self.caps[k])
        return act

    def flags(self, c: _Carry) -> torch.Tensor:
        """[levels] bool: whether any lane runs at each level."""
        return torch.stack([self.active(c, k).any() for k in range(len(self.caps))])

    def step(self, c: _Carry, k: int) -> _Carry:
        """One iteration of level k; lanes not active there keep their carry."""
        return _where(self.active(c, k), self.body(self.caps[k], False, c), c)

    def levels(self, c: _Carry) -> _Carry:
        """Every level after iteration 0, ITERATIONS_PER_CHECK iterations
        between two host reads."""
        for k in range(len(self.caps)):
            while bool(self.active(c, k).any()):
                for _ in range(ITERATIONS_PER_CHECK):
                    c = self.step(c, k)
                add_chunks()
        return c

    def finish(self, c: _Carry) -> ICPResult:
        """Final angle statistics from one full-payload weighted pass at the
        final transform (the JAX package solves the system here too and
        discards it; only the weights are used, so only the weighting
        runs)."""
        cfg, draws, mx = self.cfg, self.draws, self.mx
        wide_m = _pack_features_wide(self.moving_targets)
        wide_f = _pack_features_wide(self.fixed_targets)
        inv = c.trans.inverse()
        fwd_s = _sample_stats_packed(
            draws.stats_offset_f, self.src_m.order, self.src_m.valid_count, wide_m, wide_f,
            self.fixed_vor, c.trans, c.number_matches, cfg.max_matches, mx,
        )
        bwd_s = _sample_stats_packed(
            draws.stats_offset_b, self.src_f.order, self.src_f.valid_count, wide_f, wide_m,
            self.moving_vor, inv, c.number_matches, cfg.max_matches, mx,
        )
        fwd_pm = _as_packed_matches(fwd_s)
        fwd_w, bwd_w, *_ = _weighted_matches_packed(
            c.trans, fwd_pm, _as_packed_matches(bwd_s), False, cfg, mx
        )
        sheet_f, tube_f = _angle_stats_packed(c.trans, fwd_s, fwd_w.weight, mx)
        sheet_b, tube_b = _angle_stats_packed(inv, bwd_s, bwd_w.weight, mx)
        final_rms = _feature_rms_packed(c.trans, fwd_pm, mx)

        return ICPResult(
            trans=c.trans, covar=c.covar, converged=c.converged, valid=c.valid,
            oscillated=c.oscillation_count > cfg.max_oscillations,
            iterations=c.iteration, weighted_error=c.weighted_error,
            weighted_error_backward=c.we_bwd, sheet_angles=sheet_f, tube_angles=tube_f,
            sheet_angles_backward=sheet_b, tube_angles_backward=tube_b,
            number_matches=c.number_matches, initial_rms=c.initial_rms,
            final_rms=final_rms,
        )


def register_candidate(
    moving: FeatureSet,
    fixed: FeatureSet,
    fixed_vor: VoronoiGrid,
    moving_vor: VoronoiGrid,
    init: Affine3D,  # [L]
    cfg: EstimationConfig,
    draws: ICPDraws,
    *,
    moving_targets: FeatureSet,
    fixed_targets: FeatureSet,
    model: str = "affine",
    progress_callback=None,
    mesh=None,
    match_axis: str = "mp",
) -> ICPResult:
    """Run the full symmetric robust ICP from L initialisations at once.

    `moving`/`fixed` are the SAMPLING sources: the target sets under a
    per-lane mask [L, N] (the candidate's ROI).  `moving_targets`/
    `fixed_targets` are the match TARGET sets the Voronoi maps index into
    (itkLocationRegistration.cxx:1645-1650); a match reads the voxel's
    feature index there and that target's packed row.

    `model` is "affine" (12 dof, kernel K1) or "rigid" (6-dof small-angle
    increments, BASELINE config 3); sampling, robust weighting, convergence
    and the doubling schedule are the same.  Iteration 0 (with the MUSE
    scale) is peeled off and runs on every lane; then each doubling level
    runs with its static capacity, reading "any lane active" back every
    ITERATIONS_PER_CHECK iterations.  `progress_callback(iteration,
    weighted_error, number_matches)` is called with Python numbers once for
    every iteration a lane runs (the reference's per-iteration display
    callback, cdcl_estimation_abs.h:50-55): an observability tool, one
    device read an iteration.

    `mesh` (`parallel.distributed.Mesh`, with `match_axis` naming one of its
    axes) splits the match axis of every lane over the ranks of that axis
    (match-parallel estimation; module docstring).  Every rank passes the
    same arguments and gets the same result, equal to the one-process run up
    to the order of the sums.  With a callback or a mesh every iteration is
    read back (the callback reads each; the mesh's exchanges stay eager)."""
    r = Refinement(
        moving, fixed, fixed_vor, moving_vor, cfg, draws, moving_targets=moving_targets,
        fixed_targets=fixed_targets, model=model, mesh=mesh, match_axis=match_axis,
    )
    if progress_callback is None and mesh is None:
        return r.finish(r.levels(r.start(init)))

    def report(active: torch.Tensor, before: _Carry, after: _Carry) -> None:
        if progress_callback is None:
            return
        for lane in torch.nonzero(active)[:, 0].tolist():
            progress_callback(
                int(before.iteration[lane]), float(after.weighted_error[lane]),
                int(before.number_matches[lane]),
            )

    c0 = r.initial(init)
    c = r.body(r.caps[0], True, c0)
    report(c0.valid, c0, c)
    for k, cap in enumerate(r.caps):
        while True:
            active = r.active(c, k)
            if not bool(active.any()):
                break
            new = r.body(cap, False, c)
            report(active, c, new)
            c = _where(active, new, c)
    return r.finish(c)

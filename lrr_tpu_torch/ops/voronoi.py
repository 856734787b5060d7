"""Nearest-feature-index (Voronoi) volumes: the build functions and the O(1) lookup
(lrr_tpu/ops/voronoi.py; reference rrl/examples/compute_distance_map.cxx).

Three functions build an int32 [D, H, W] volume of nearest-valid-feature
indices (-1 where there is no feature at all):

  `voronoi_map_exact`          brute-force 1-NN over voxel centres;
  `voronoi_map_exact_blocked`  the same answers, bit for bit, searching per
                               16-voxel block only the features that can be
                               nearest to one of its voxels;
  `voronoi_map`                jump flooding (JFA+1) for maps too large for
                               an exact build; validated against the exact
                               map in the tests.

In all of them a voxel's coordinates are origin + index * spacing from its
GLOBAL index, the squared distance is (dx*dx + dy*dy) + dz*dz in fp32, and
equal distances go to the lowest feature index.  The two exact builds are
the plain versions of the card's kernel K4 (`ops.kernels.voronoi_nearest`,
csrc/voronoi.cu), which gives their bits.  `build_feature_voronoi` picks by
device and size: K4 for every exact map on the card, the brute force or the
blocked build on the CPU, jump flooding for a map too large for either.
The JAX package's custom-vmap `flat_take` exists for the TPU's gather
lowering; here the lookup is plain indexing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lrr_tpu_torch.ops import ieee, kernels
from lrr_tpu_torch.parallel.distributed import all_gather

_OFFSETS = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if not (dz == 0 and dy == 0 and dx == 0)
]

BIG = 1e30
FAR = 1e18  # coordinate of the sentinel feature behind index -1

# exact maps above this voxel count build via per-block candidate pruning
_BLOCKED_MIN_VOXELS = 1 << 22


def _tile_elems(device: torch.device) -> int:
    """Elements of one distance tile of the exact builds: 512 MB in fp32
    on the card, 64 MB on the CPU."""
    return 1 << (27 if device.type == "cuda" else 24)


def _nearest(qx, qy, qz, cx, cy, cz) -> tuple[torch.Tensor, torch.Tensor]:
    """(least squared distance [..., V], its first index [..., V]) from
    voxel coordinates [..., V] to candidate coordinates [..., C]: the one
    arithmetic both exact builds share."""
    d = qx[..., :, None] - cx[..., None, :]
    d.mul_(d)
    t = qy[..., :, None] - cy[..., None, :]
    d.add_(t.mul_(t))
    t = qz[..., :, None] - cz[..., None, :]
    d.add_(t.mul_(t))
    return torch.min(d, dim=-1)


def _shift(arr: torch.Tensor, dz: int, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift the last three axes by (dz, dy, dx) voxels with constant fill
    (no wrap-around): out[z, y, x] = arr[z - dz, y - dy, x - dx]."""
    out = torch.full_like(arr, fill)
    src, dst = [slice(None)] * arr.dim(), [slice(None)] * arr.dim()
    for ax, s in zip(range(arr.dim() - 3, arr.dim()), (dz, dy, dx)):
        n = arr.shape[ax]
        if abs(s) >= n:
            return out
        dst[ax] = slice(max(s, 0), n + min(s, 0))
        src[ax] = slice(max(-s, 0), n + min(-s, 0))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def voronoi_map(
    xyz: torch.Tensor,  # [N, 3] feature locations (physical)
    mask: torch.Tensor,  # [N]
    origin: torch.Tensor,  # [3] (x, y, z) of the map
    spacing: torch.Tensor,  # [3]
    shape_zyx: tuple[int, int, int],
    extra_passes: int = 1,
) -> torch.Tensor:
    """Jump flooding: log2(n) passes of 26 shifted probes with a halving
    step, then `extra_passes` more at step 1.  Besides the index volume the
    passes carry the best feature's coordinates and squared distance, so a
    probe shifts volumes and never gathers."""
    D, H, W = shape_zyx
    n = xyz.shape[0]
    dev = xyz.device

    def axis(m, o, s, shape):
        return (o + torch.arange(m, dtype=torch.float32, device=dev) * s).reshape(shape)

    vox_x = axis(W, origin[0], spacing[0], (1, 1, W))
    vox_y = axis(H, origin[1], spacing[1], (1, H, 1))
    vox_z = axis(D, origin[2], spacing[2], (D, 1, 1))

    # seed pass: each feature goes to its containing voxel; where several
    # land in one voxel the lowest index wins (a minimum, not a racing write)
    gi = torch.round((xyz - origin) / spacing).long()  # (x, y, z)
    inb = (
        mask
        & (gi[:, 0] >= 0) & (gi[:, 0] < W)
        & (gi[:, 1] >= 0) & (gi[:, 1] < H)
        & (gi[:, 2] >= 0) & (gi[:, 2] < D)
    )
    flat = (gi[:, 2] * H + gi[:, 1]) * W + gi[:, 0]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    seed = torch.full((D * H * W,), n, dtype=torch.int32, device=dev)
    seed.scatter_reduce_(0, flat[inb], ids[inb], "amin", include_self=True)
    best_i = torch.where(seed == n, -1, seed).to(torch.int32).reshape(D, H, W)

    # feature table with a far sentinel behind index -1
    table = torch.cat([xyz.float(), torch.full((1, 3), FAR, dtype=torch.float32, device=dev)])
    bxyz = table[torch.where(best_i < 0, n, best_i).long()].permute(3, 0, 1, 2).contiguous()
    best_d = torch.where(
        best_i < 0,
        torch.full((), BIG, device=dev),
        (bxyz[0] - vox_x) ** 2 + (bxyz[1] - vox_y) ** 2 + (bxyz[2] - vox_z) ** 2,
    )

    levels = max(1, math.ceil(math.log2(max(D, H, W, 2))))
    step = 1 << (levels - 1)
    for _ in range(levels + extra_passes):
        for dz, dy, dx in _OFFSETS:
            cand_i = _shift(best_i, dz * step, dy * step, dx * step, -1)
            cand_c = _shift(bxyz, dz * step, dy * step, dx * step, FAR)
            ex, ey, ez = cand_c[0] - vox_x, cand_c[1] - vox_y, cand_c[2] - vox_z
            cd = torch.where(cand_i < 0, torch.full((), BIG, device=dev), ex * ex + ey * ey + ez * ez)
            take = cd < best_d
            best_i = torch.where(take, cand_i, best_i)
            bxyz = torch.where(take[None], cand_c, bxyz)
            best_d = torch.where(take, cd, best_d)
        step = max(step // 2, 1)
    return best_i


def voronoi_map_exact(
    xyz: torch.Tensor,  # [N, 3]
    mask: torch.Tensor,  # [N]
    origin: torch.Tensor,  # [3] (x, y, z)
    spacing: torch.Tensor,  # [3]
    shape_zyx: tuple[int, int, int],
) -> torch.Tensor:
    """Exact nearest-feature-index volume by brute-force 1-NN over voxel
    centres, exact like the reference's Danielsson map.  Streamed over
    chunks of voxels whose coordinates come from their flat indices; the
    only large buffer is one [chunk, N] distance tile."""
    D, H, W = shape_zyx
    n_vox = D * H * W
    N = xyz.shape[0]
    dev = xyz.device
    # masked features move out to the sentinel distance: never the minimum
    # unless nothing is valid, and then the voxel reads -1
    p = torch.where(mask[:, None], xyz.float(), torch.full_like(xyz, FAR, dtype=torch.float32))
    cx, cy, cz = p[:, 0].contiguous(), p[:, 1].contiguous(), p[:, 2].contiguous()
    chunk = max(256, min(n_vox, _tile_elems(dev) // max(N, 1)))
    out = torch.empty(n_vox, dtype=torch.int32, device=dev)
    for c0 in range(0, n_vox, chunk):
        flat = torch.arange(c0, min(c0 + chunk, n_vox), device=dev)
        qx = origin[0] + (flat % W).float() * spacing[0]
        qy = origin[1] + ((flat // W) % H).float() * spacing[1]
        qz = origin[2] + (flat // (H * W)).float() * spacing[2]
        dmin, best = _nearest(qx, qy, qz, cx, cy, cz)
        out[c0 : c0 + chunk] = torch.where(dmin < BIG, best, -1).to(torch.int32)
    return out.reshape(D, H, W)


def _block_flags(xyz, mask, origin, spacing, shape_zyx, block: int, blocks: torch.Tensor):
    """Candidate flags [m, N] for blocks [m]: the features within (least
    feature-to-bbox distance + block diagonal) of the block's bounding box.
    Any voxel's true NN lies in that set (triangle inequality through the
    block's nearest feature)."""
    D, H, W = shape_zyx
    nby, nbx = H // block, W // block
    diam = ieee.sqrt((((block - 1) * spacing) ** 2).sum())
    bxyz = torch.stack([blocks % nbx, (blocks // nbx) % nby, blocks // (nby * nbx)], -1)
    lo = origin + bxyz.float() * block * spacing  # [m, 3]
    hi = lo + (block - 1) * spacing
    d = torch.clamp(torch.maximum(lo[:, None, :] - xyz, xyz - hi[:, None, :]), min=0.0)
    d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
    d2 = torch.where(mask[None, :], d2, torch.full_like(d2, torch.inf))
    r = ieee.sqrt(d2.min(-1, keepdim=True).values) + diam
    return mask[None, :] & (ieee.sqrt(d2) <= r * (1.0 + 1e-6) + 1e-3)


def _block_candidate_counts(xyz, mask, origin, spacing, shape_zyx, block: int) -> torch.Tensor:
    """Per-block candidate counts [nb] (see `_block_flags`)."""
    D, H, W = shape_zyx
    nb = (D // block) * (H // block) * (W // block)
    step = max(1, _tile_elems(xyz.device) // (8 * max(xyz.shape[0], 1)))
    ids = torch.arange(nb, device=xyz.device)
    return torch.cat([
        _block_flags(xyz, mask, origin, spacing, shape_zyx, block, ids[b0 : b0 + step]).sum(-1)
        for b0 in range(0, nb, step)
    ])


def _pruned_exact_blocks(xyz, mask, origin, spacing, shape_zyx, blocks, block: int, cap: int):
    """Exact NN indices int32 [m, block^3] for blocks [m], each searched
    over its own candidate set (at most `cap` features, the caller's
    promise).  Bit-identical to the full brute force: candidates keep their
    ascending global order, so equal fp32 distances go to the lowest global
    index in both, and voxel coordinates come from global indices by the
    same arithmetic (deriving them from the block's corner adds one
    rounding, which flips near-ties)."""
    D, H, W = shape_zyx
    n = xyz.shape[0]
    dev = xyz.device
    nby, nbx = H // block, W // block
    flag = _block_flags(xyz, mask, origin, spacing, shape_zyx, block, blocks)
    # the flagged features of each block, in ascending order, then the
    # sentinel (index n, far away) in the unused slots
    cand = torch.sort(
        torch.where(flag, torch.arange(n, device=dev), n), dim=1, stable=True
    ).values[:, :cap]
    table = torch.cat([xyz.float(), torch.full((1, 3), FAR, dtype=torch.float32, device=dev)])
    cx, cy, cz = (table[:, c][cand] for c in range(3))  # [m, cap]

    v = torch.arange(block**3, device=dev)
    bx, by, bz = blocks % nbx, (blocks // nbx) % nby, blocks // (nby * nbx)
    qx = origin[0] + (bx[:, None] * block + v % block).float() * spacing[0]  # [m, block^3]
    qy = origin[1] + (by[:, None] * block + (v // block) % block).float() * spacing[1]
    qz = origin[2] + (bz[:, None] * block + v // (block * block)).float() * spacing[2]
    dmin, best = _nearest(qx, qy, qz, cx, cy, cz)
    idx = cand.gather(1, best)
    return torch.where((dmin < BIG) & (idx < n), idx, -1).to(torch.int32)


def voronoi_map_exact_blocked(xyz, mask, origin, spacing, shape_zyx, block: int = 16):
    """Exact nearest-feature-index volume via per-block candidate pruning:
    the same answers as `voronoi_map_exact` at a fraction of the work.  A
    cheap pass bounds each block's search radius, the host groups the
    blocks by the power-of-two capacity that holds their candidates, and
    each group is brute-forced together, as many blocks at a time as one
    distance tile holds.

    The block size does not change a bit of the map, only the work: the
    search radius grows with the block's diagonal.  The JAX package takes 32
    (few large programs suit the TPU); on an H100 16 needs a sixth of the
    distance evaluations at CT feature density and builds a 61M-voxel map
    in 1.0 s against 4.3-5.0 s (scripts/profile_torch_stage1.py)."""
    D, H, W = shape_zyx
    if D % block or H % block or W % block:
        return voronoi_map_exact(xyz, mask, origin, spacing, shape_zyx)
    dev = xyz.device
    counts = _block_candidate_counts(xyz, mask, origin, spacing, shape_zyx, block).cpu().numpy()
    n = xyz.shape[0]
    nbz, nby, nbx = D // block, H // block, W // block
    vol_b = torch.empty((nbz * nby * nbx, block**3), dtype=torch.int32, device=dev)
    # the smallest power-of-two capacity that fits each block's candidates
    block_cap = np.minimum(
        1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64), max(n, 1)
    )
    for cap in np.unique(block_cap):
        ids = np.nonzero(block_cap == cap)[0]
        step = max(1, _tile_elems(dev) // (block**3 * int(cap)))
        for i0 in range(0, ids.size, step):
            ids_t = torch.as_tensor(ids[i0 : i0 + step], device=dev)
            vol_b[ids_t] = _pruned_exact_blocks(
                xyz, mask, origin, spacing, shape_zyx, ids_t, block, int(cap)
            )
    return (
        vol_b.reshape(nbz, nby, nbx, block, block, block)
        .permute(0, 3, 1, 4, 2, 5)
        .reshape(D, H, W)
    )


def _plain_exact(n_vox: int):
    """The exact build for a map of `n_vox` voxels on the CPU: the brute
    force, or above `_BLOCKED_MIN_VOXELS` the blocked build (the same bits
    at a fraction of the work)."""
    return voronoi_map_exact_blocked if n_vox > _BLOCKED_MIN_VOXELS else voronoi_map_exact


def voronoi_map_exact_plain(xyz, mask, origin, spacing, shape_zyx):
    """K4's plain version: the exact build for this map's size."""
    return _plain_exact(math.prod(shape_zyx))(xyz, mask, origin, spacing, shape_zyx)


def voxel_ids(
    shape_zyx: tuple[int, int, int],
    origin: torch.Tensor,  # [3] (x, y, z)
    spacing: torch.Tensor,  # [3]
    query_xyz: torch.Tensor,  # [..., 3]
) -> torch.Tensor:
    """Clamped flat voxel index of each query point (int64 [...]).
    `torch.round` rounds half to even, as `jnp.round` does."""
    D, H, W = shape_zyx
    gi = torch.round((query_xyz - origin) / spacing).to(torch.int32)
    x = torch.clamp(gi[..., 0], 0, W - 1)
    y = torch.clamp(gi[..., 1], 0, H - 1)
    z = torch.clamp(gi[..., 2], 0, D - 1)
    return ((z * H + y) * W + x).long()


def lookup(
    index_vol: torch.Tensor,  # int32 [D, H, W]
    origin: torch.Tensor,
    spacing: torch.Tensor,
    query_xyz: torch.Tensor,  # [..., 3]
) -> torch.Tensor:
    """Nearest-feature index of each query point (-1 = empty voxel)."""
    ids = voxel_ids(tuple(index_vol.shape), origin, spacing, query_xyz)
    return index_vol.reshape(-1)[ids]


def build_feature_voronoi(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    spacing_mm: float = 1.0,
    margin_mm: float = 2.0,
    max_shape: int = 512,
    shape_bucket: int = 32,
    exact_max_voxels: int = 64 * 1024 * 1024,
    mesh=None,
    axis_name: str = "sp",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A Voronoi map over the feature bounding box at `spacing_mm` (the
    reference uses a 1 mm grid, compute_distance_map.cxx:100-104), on the
    features' device.  Returns (index_vol, origin, spacing).  The shape
    comes from the bounds on the host, rounded up to `shape_bucket`
    multiples.  Maps up to `exact_max_voxels` are exact: on the card one K4
    launch (`kernels.voronoi_nearest`), on the CPU its plain versions
    (blocked above `_BLOCKED_MIN_VOXELS`); larger ones are built by jump
    flooding.

    With `mesh`, an exact map whose z extent divides over the `axis_name`
    ranks (more than one) is built a z-slab a rank, and one all-gather along
    z gives every rank the whole map.  The slab's origin is lrr_tpu's own
    arithmetic (lrr_tpu/ops/voronoi.py:510-513): its voxel coordinates then
    round as lrr_tpu's sharded build rounds them, which may differ from the
    one-process map's in the last bit and flip an exact tie.  On the card a
    slab is one K4 launch at the slab's origin; on the CPU it goes through
    the blocked builder when the whole map would (block boundaries fall on
    slab boundaries when the slab depth is a multiple of 16)."""
    dev = xyz.device
    xyz_h = xyz.cpu().numpy()
    mask_h = mask.cpu().numpy()
    pts = xyz_h[mask_h] if mask_h.any() else np.zeros((1, 3), np.float32)
    lo = pts.min(0) - margin_mm
    hi = pts.max(0) + margin_mm
    shape = np.ceil((hi - lo) / spacing_mm).astype(int) + 1
    shape = (np.ceil(shape / shape_bucket) * shape_bucket).astype(int)
    shape = np.minimum(np.maximum(shape, 2), max_shape)
    origin = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    spacing = torch.full((3,), spacing_mm, dtype=torch.float32, device=dev)
    shape_zyx = (int(shape[2]), int(shape[1]), int(shape[0]))
    n_vox = int(np.prod(shape))
    if n_vox > exact_max_voxels:
        build = voronoi_map
    elif dev.type == "cuda":
        build = kernels.voronoi_nearest
    else:  # the whole map's size picks a slab's build too
        build = _plain_exact(n_vox)
    n = 1 if mesh is None else mesh.axis_size(axis_name)
    D, H, W = shape_zyx
    if build is not voronoi_map and n > 1 and D % n == 0:
        dz = D // n
        i = mesh.axis_index(axis_name)
        org = origin + torch.tensor([0.0, 0.0, 1.0], device=dev) * (dz * spacing[2] * i)
        slab = build(xyz, mask, org, spacing, (dz, H, W))
        return all_gather(mesh, slab, axis_name), origin, spacing
    return build(xyz, mask, origin, spacing, shape_zyx), origin, spacing

"""Local contrast filtering of the score volume (lrr_tpu/ops/contrast.py).

Windows of radius R step across the volume at stride R; per window the
lower median and the MAD scale of the valid scores are computed, and a voxel
survives only if its score reaches median - 0.5 * scale in every window that
covers it (features/itkFeatureImageFilter.txx:482-617).

The volume is cut into blocks of side R; a window is 2 x 2 x 2 adjacent
blocks.  Window statistics come from batched sorts, a bounded number of
windows at a time; the per-voxel threshold is the maximum over the up to
eight windows covering the voxel's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# values sorted at once: bounds the window tile (and torch.sort's int64
# index output, twice its size) whatever the volume
_SORT_TILE = 1 << 26


def _block_view(x: torch.Tensor, r: int) -> torch.Tensor:
    """[D, H, W] -> [nz, ny, nx, r^3] blocks (D, H, W multiples of r)."""
    D, H, W = x.shape
    nz, ny, nx = D // r, H // r, W // r
    return (
        x.reshape(nz, r, ny, r, nx, r)
        .permute(0, 2, 4, 1, 3, 5)
        .reshape(nz, ny, nx, r * r * r)
    )


def _masked_median_and_mad(v: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last dim) lower median and 1.4826 * MAD over valid entries:
    entry n // 2 of the sorted valid values."""
    big = torch.finfo(v.dtype).max
    cap = v.shape[-1]
    mid = torch.clamp(valid.sum(-1) // 2, 0, cap - 1)[..., None]
    vs = torch.sort(torch.where(valid, v, torch.full_like(v, big)), dim=-1).values
    med = vs.gather(-1, mid)
    del vs
    dev = torch.where(valid, (v - med).abs(), torch.full_like(v, big))
    mad = torch.sort(dev, dim=-1).values.gather(-1, mid)
    return med[..., 0], 1.4826 * mad[..., 0]


def contrast_keep_mask(
    score: torch.Tensor,
    valid: torch.Tensor,
    radius_vox: int,
    ratio_of_std_dev: float = -0.5,
) -> torch.Tensor:
    """bool [D, H, W]: True where the voxel survives contrast filtering.
    `valid` marks the voxels whose score counts in the statistics."""
    D, H, W = score.shape
    r = int(radius_vox)
    if r < 1 or min(D, H, W) // 2 < r:
        # the reference skips filtering for small images (txx:492-498)
        return torch.ones_like(score, dtype=torch.bool)

    pad = (0, (-W) % r, 0, (-H) % r, 0, (-D) % r)
    blocks = _block_view(F.pad(score, pad), r)  # [nz, ny, nx, r^3]
    bvalid = _block_view(F.pad(valid, pad), r)
    nz, ny, nx, _ = blocks.shape
    if min(nz, ny, nx) < 2:
        return torch.ones_like(score, dtype=torch.bool)

    # window w in [0, n - 1) covers blocks w and w + 1 along each axis; the
    # eight blocks are concatenated in the JAX package's order (z, then y,
    # then x innermost), which does not matter to the statistics
    def windows(arr, z0, z1):
        a = torch.cat([arr[z0:z1], arr[z0 + 1 : z1 + 1]], dim=-1)
        a = torch.cat([a[:, :-1], a[:, 1:]], dim=-1)
        return torch.cat([a[:, :, :-1], a[:, :, 1:]], dim=-1)

    per_z = (ny - 1) * (nx - 1) * 8 * r**3
    step = max(1, _SORT_TILE // per_z)
    parts = []
    for z0 in range(0, nz - 1, step):
        z1 = min(z0 + step, nz - 1)
        med, scale = _masked_median_and_mad(windows(blocks, z0, z1), windows(bvalid, z0, z1))
        parts.append(med + ratio_of_std_dev * scale)
    thresh = torch.cat(parts)  # [nz-1, ny-1, nx-1]

    # block b is covered by windows b-1 and b along each axis; surviving all
    # of them means reaching the largest of their thresholds
    tp = F.pad(thresh, (1, 1, 1, 1, 1, 1), value=-torch.inf)
    block_thresh = torch.full((nz, ny, nx), -torch.inf, dtype=thresh.dtype, device=thresh.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                block_thresh = torch.maximum(
                    block_thresh, tp[dz : dz + nz, dy : dy + ny, dx : dx + nx]
                )
    vox_thresh = (
        block_thresh.repeat_interleave(r, 0).repeat_interleave(r, 1).repeat_interleave(r, 2)
    )[:D, :H, :W]
    return score >= vox_thresh

"""Multiresolution subsampling of point sets (lrr_tpu/ops/subsample.py;
cdcl's `subsample_data`, cdcl/cdcl_utils.h:98-112): each level keeps the
strongest point of each grid cell of the level's spacing, found through a
fixed-size cell-hash table.
"""

from __future__ import annotations

import torch

from lrr_tpu_torch.types import FeatureSet


def grid_decimate_mask(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    strength: torch.Tensor,
    spacing: float,
    hash_size: int = 1 << 20,
) -> torch.Tensor:
    """bool [N]: the strongest point in each spacing-sized cell (ties to the
    lowest index).  The cell hash wraps in int32 and takes a floor modulo,
    as lrr_tpu's does; masked points go to a slot past the table, which is
    dropped."""
    cell = torch.floor(xyz / spacing).to(torch.int32)
    h = torch.remainder(
        (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791), hash_size
    ).long()
    h = torch.where(mask, h, torch.full_like(h, hash_size))
    n = xyz.shape[0]
    idx = torch.arange(n, device=xyz.device)
    key = strength.to(torch.float32)
    table = torch.full((hash_size + 1,), float("-inf"), device=xyz.device)
    table = table.scatter_reduce(0, h, key, "amax")[:hash_size]
    slot = torch.clamp(h, max=hash_size - 1)
    is_best = mask & (key >= table[slot])
    # exact ties: the lowest index among the best
    itable = torch.full((hash_size + 1,), n, dtype=torch.int64, device=xyz.device)
    itable = itable.scatter_reduce(
        0, torch.where(is_best, h, torch.full_like(h, hash_size)), idx, "amin")[:hash_size]
    return is_best & (itable[slot] == idx)


def multiresolution_masks(fs: FeatureSet, spacings: tuple[float, ...]) -> list[torch.Tensor]:
    """One keep-mask per level (coarse to fine); a spacing <= 0 keeps the
    whole set."""
    return [
        fs.mask if sp <= 0 else fs.mask & grid_decimate_mask(fs.xyz, fs.mask, fs.strength, sp)
        for sp in spacings
    ]

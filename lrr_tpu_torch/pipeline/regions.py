"""Watershed-region-based feature selection (lrr_tpu/pipeline/regions.py).

FeaturesInRegions (rrl/itkLocationRegistration.cxx:1363-1522): when
oversegmentation labels are available, the estimation's feature subset is
not the plain ROI box but a union of whole watershed regions around the
query, grown in order of each region's nearest feature until at least
`target` features are collected (>= 1500, .cxx:1487) or the box is
exhausted: growth never leaves the ROI box (.cxx:1400-1404, 1432-1436).

Each feature's label is gathered once (stage 1) and compacted to
[0, n_distinct), so the per-candidate work is a scatter-min over a
capacity-sized table.  The selection is batched over L lanes ([L, N]
masks).  The scatter is `scatter_reduce(amin)`, which gives the same bits
in any order; distances are written out component by component.
"""

from __future__ import annotations

import math

import torch

from lrr_tpu_torch.types import FeatureSet


def feature_region_labels(
    features: FeatureSet, labels: torch.Tensor, origin: torch.Tensor, spacing: torch.Tensor
) -> torch.Tensor:
    """Nearest-voxel gather of watershed labels [D, H, W] at the feature
    locations (`torch.round` rounds half to even, as `jnp.round`)."""
    D, H, W = labels.shape
    gi = torch.round((features.xyz - origin) / spacing).to(torch.int32)
    x = torch.clamp(gi[:, 0], 0, W - 1).long()
    y = torch.clamp(gi[:, 1], 0, H - 1).long()
    z = torch.clamp(gi[:, 2], 0, D - 1).long()
    return labels[z, y, x]


def compact_feature_labels(
    features: FeatureSet, labels: torch.Tensor, origin: torch.Tensor, spacing: torch.Tensor
) -> torch.Tensor:
    """Per-feature watershed region ids compacted to [0, n_distinct), int32
    [N], in the order of the label values.  Padding rows take the smallest
    label first; they are masked out of every reduction downstream."""
    lab = feature_region_labels(features, labels, origin, spacing)
    if lab.numel() == 0:
        return lab.to(torch.int32)
    lab = torch.where(features.mask, lab, lab.min())
    _, compact = torch.unique(lab, sorted=True, return_inverse=True)
    return compact.to(torch.int32)


def select_features_by_labels(
    features: FeatureSet,
    feat_labels: torch.Tensor,  # int32 [N] compact per-feature region ids
    query_xyz: torch.Tensor,  # [L, 3], or [3] for one lane
    target: int,
    max_distance_mm: float = 100.0,
    box_lo: torch.Tensor | None = None,  # [L, 3] / [3]
    box_hi: torch.Tensor | None = None,
) -> torch.Tensor:
    """bool [L, N] ([N] for one lane): whole regions enter in order of their
    nearest in-box feature's distance to the lane's query until the count
    reaches `target`; the threshold is the region distance of the
    `target`-th feature in that order, capped at `max_distance_mm`.  With
    `box_lo`/`box_hi` only in-box features are collected and grouped, so a
    box that holds fewer than `target` features is simply exhausted."""
    one_lane = query_xyz.dim() == 1
    q = torch.atleast_2d(query_xyz)
    L, n = q.shape[0], feat_labels.shape[0]
    xyz = features.xyz
    sel = features.mask[None].expand(L, n)
    if box_lo is not None:
        lo, hi = torch.atleast_2d(box_lo), torch.atleast_2d(box_hi)
        sel = sel & ((xyz[None] >= lo[:, None]) & (xyz[None] <= hi[:, None])).all(-1)
    dx = xyz[None, :, 0] - q[:, 0, None]
    dy = xyz[None, :, 1] - q[:, 1, None]
    dz = xyz[None, :, 2] - q[:, 2, None]
    inf = torch.full((), math.inf, dtype=xyz.dtype, device=xyz.device)
    d = torch.where(sel, torch.sqrt(dx * dx + dy * dy + dz * dz), inf)
    del dx, dy, dz

    index = feat_labels.long()[None].expand(L, n)
    region_min = torch.full_like(d, math.inf).scatter_reduce(1, index, d, "amin")
    region_d = torch.where(sel, region_min.gather(1, index), inf)
    del d, region_min

    k = min(target, n)
    tau = torch.clamp(torch.kthvalue(region_d, k, dim=1).values, max=max_distance_mm)
    keep = sel & (region_d <= tau[:, None])
    return keep[0] if one_lane else keep


def select_features_in_regions(
    features: FeatureSet,
    labels: torch.Tensor,  # int32 [D, H, W] watershed labels
    origin: torch.Tensor,
    spacing: torch.Tensor,
    query_xyz: torch.Tensor,
    target: int,
    max_distance_mm: float = 100.0,
    box_lo: torch.Tensor | None = None,
    box_hi: torch.Tensor | None = None,
) -> torch.Tensor:
    """`select_features_by_labels` straight from a label volume: the labels
    are gathered and compacted here (the JAX package scatters into a table
    of the volume's size instead; the regions and so the selection are the
    same)."""
    feat_labels = compact_feature_labels(features, labels, origin, spacing)
    return select_features_by_labels(
        features, feat_labels, query_xyz, target, max_distance_mm, box_lo, box_hi
    )

"""Descriptor comparison evaluation (lrr_tpu/eval/compare.py;
rrl/examples/compare_descriptors.cxx:45): for keypoints present in two
descriptor sets (matched by location nearest-neighbor), report
descriptor-space distance statistics, the A/B test harness for descriptor
changes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lrr_tpu_torch.ops.knn import nn1
from lrr_tpu_torch.ops.robust import nanmedian
from lrr_tpu_torch.types import DescriptorSet


class DescriptorComparison(NamedTuple):
    mean_distance: torch.Tensor
    median_distance: torch.Tensor
    max_distance: torch.Tensor
    n_pairs: torch.Tensor


def compare_descriptor_sets(
    a: DescriptorSet,
    b: DescriptorSet,
    location_tol_mm: float = 1.0,
) -> DescriptorComparison:
    d2, idx = nn1(a.keypoints.xyz, b.keypoints.xyz, b.keypoints.mask)
    paired = a.keypoints.mask & (d2 <= location_tol_mm**2)

    dd = torch.linalg.norm(a.descriptors - b.descriptors[idx.long()], dim=-1)
    dd_valid = torch.where(paired, dd, torch.full_like(dd, math.nan))
    return DescriptorComparison(
        mean_distance=torch.nanmean(dd_valid),
        median_distance=nanmedian(dd_valid),
        max_distance=torch.where(paired, dd, torch.full_like(dd, -math.inf)).max(),
        n_pairs=paired.sum(),
    )

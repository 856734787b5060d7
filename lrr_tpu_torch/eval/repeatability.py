"""Feature repeatability evaluation (lrr_tpu/eval/repeatability.py).

Re-implements rrl/examples/feature_repeatability.cxx (:48,580-737): map each
fixed feature through a known ground-truth transform and count features that
have a moving feature within `dist_mm` (2 mm) whose normal agrees within
`angle_deg` (20 deg); report the fraction plus failure histograms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lrr_tpu_torch.ops.knn import nn1
from lrr_tpu_torch.types import FeatureSet


class RepeatabilityResult(NamedTuple):
    fraction_repeatable: torch.Tensor  # scalar
    fraction_distance_ok: torch.Tensor
    n_evaluated: torch.Tensor
    distance_hist: torch.Tensor  # [nbins] histogram of NN distances (mm)
    angle_hist: torch.Tensor  # [nbins] histogram of normal angles (deg)


def feature_repeatability(
    fixed: FeatureSet,
    moving: FeatureSet,
    gt_apply,  # callable mapping fixed-space points -> moving-space points
    dist_mm: float = 2.0,
    angle_deg: float = 20.0,
    hist_bins: int = 20,
    hist_max_dist: float = 10.0,
) -> RepeatabilityResult:
    mapped = gt_apply(fixed.xyz)
    d2, idx = nn1(mapped, moving.xyz, moving.mask)  # chunked: two 65,536 sets fit
    d = torch.sqrt(d2)

    n_fix = fixed.directions[:, 0, :]
    n_mov = moving.directions[idx, 0, :]
    cosang = (n_fix * n_mov).sum(-1).abs()
    ang = torch.rad2deg(torch.acos(torch.clamp(cosang, -1.0, 1.0)))

    ok_dist = fixed.mask & (d <= dist_mm)
    ok = ok_dist & (ang <= angle_deg)
    n = torch.clamp(fixed.mask.sum(), min=1)

    minus_one = torch.full_like(d, -1.0)  # outside every bin
    dist_hist = torch.histc(
        torch.where(fixed.mask, d, minus_one), bins=hist_bins, min=0.0, max=hist_max_dist
    )
    angle_hist = torch.histc(
        torch.where(ok_dist, ang, minus_one), bins=hist_bins, min=0.0, max=90.0
    )

    return RepeatabilityResult(
        fraction_repeatable=ok.sum() / n,
        fraction_distance_ok=ok_dist.sum() / n,
        n_evaluated=fixed.mask.sum(),
        distance_hist=dist_hist.long(),
        angle_hist=angle_hist.long(),
    )

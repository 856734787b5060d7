"""Alignment-quality decision measurements (lrr_tpu/estimation/measurements.py).

The 8-vector fed to the SVM verifier (itkLocationRegistration.cxx:1816-1871),
from the transfer-error covariance sampled on a 5 mm grid over the ROI and
the backward-direction covariance (the least-squares accumulation re-run
with the directions swapped).  Batched over lanes.
"""

from __future__ import annotations

import torch

from lrr_tpu_torch.config import EstimationConfig
from lrr_tpu_torch.estimation.icp import (
    _WHOLE,
    ICPResult,
    VoronoiGrid,
    _MatchAxis,
    _estimate_ls_packed,
    _pack_features,
    _pack_source,
    _sample_matches_packed,
)
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops.eig3 import eigvalsh3
from lrr_tpu_torch.sampling import CovarianceDraws
from lrr_tpu_torch.types import FeatureSet


def transfer_error_stats(
    trans: Affine3D,  # [L]
    covar: torch.Tensor,  # [L, 12, 12]
    roi_start: torch.Tensor,  # [L, 3]
    roi_size_mm: float,
    interval_mm: float = 5.0,
):
    """Mean transfer covariance [L, 3, 3], max trace [L], max eigenvalue
    [L] over the sampled ROI grid (itkLocationRegistration.cxx:2824-2858).
    J C J^T contracts to h^T C_blk h per (row, col) block."""
    n = max(int(roi_size_mm // interval_mm) + 1, 2)
    ax = torch.arange(n, dtype=torch.float32, device=covar.device) * interval_mm
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    grid = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    pts = roi_start[:, None, :] + grid[None]  # [L, P, 3]
    xc = pts - trans.center[:, None, :]
    h = torch.cat([xc, torch.ones_like(xc[..., :1])], dim=-1)  # [L, P, 4]
    Cb = covar.reshape(-1, 3, 4, 3, 4)
    covJ = torch.einsum("bpj,bijkl,bpl->bpik", h, Cb, h)  # [L, P, 3, 3]
    mean_covJ = covJ.mean(1)
    traces = covJ[..., 0, 0] + covJ[..., 1, 1] + covJ[..., 2, 2]
    max_trace = traces.max(1).values
    max_eval = eigvalsh3(covJ)[..., 2].max(1).values
    return mean_covJ, max_trace, max_eval


def backward_covariance(
    result: ICPResult,
    moving: FeatureSet,
    fixed: FeatureSet,
    fixed_vor: VoronoiGrid,
    moving_vor: VoronoiGrid,
    cfg: EstimationConfig,
    draws: CovarianceDraws,
    *,
    moving_targets: FeatureSet,
    fixed_targets: FeatureSet,
    mesh=None,
    match_axis: str = "mp",
) -> torch.Tensor:
    """Covariance [L, 12, 12] of the backward (fixed->moving) transform
    parameters: swap the directions, accumulate the normal equations about
    the inverse transform (kernel K1), keep (AtA)^{-1}.  A fresh random
    subsample at the final match count.  Sources and targets as in
    `register_candidate`, matched through the maps as there.  `mesh` splits
    the matches over the `match_axis` ranks, as in `register_candidate`."""
    mx = _WHOLE if mesh is None else _MatchAxis(mesh, match_axis)
    inv = result.trans.inverse()
    src_f = _pack_source(draws.scores_f, _pack_features(fixed_targets), fixed.mask)
    src_m = _pack_source(draws.scores_m, _pack_features(moving_targets), moving.mask)
    fwd_sw = _sample_matches_packed(
        src_f, moving_vor, inv, result.number_matches, cfg.max_matches,
        draws.offset_b, dst_rows=src_m.rows, mx=mx,
    )
    bwd_sw = _sample_matches_packed(
        src_m, fixed_vor, result.trans, result.number_matches,
        cfg.max_matches, draws.offset_f, dst_rows=src_f.rows, mx=mx,
    )
    _, cov_bwd, _, _ = _estimate_ls_packed(inv, fwd_sw, bwd_sw, False, cfg, mx)
    return cov_bwd


def decision_measurements(
    result: ICPResult,
    cov_backward: torch.Tensor,
    roi_moving_start: torch.Tensor,  # [L, 3]
    roi_fixed_start: torch.Tensor,  # [L, 3]
    roi_size_mm: float,
) -> torch.Tensor:
    """[L, 8] = [max_we, max_maxTrace, max_sheet_deg, max_tube_deg,
    min_we, min_maxTrace, min_sheet_deg, min_tube_deg]
    (itkLocationRegistration.cxx:1857-1868)."""
    _, max_trace_f, _ = transfer_error_stats(
        result.trans, result.covar, roi_moving_start, roi_size_mm
    )
    _, max_trace_b, _ = transfer_error_stats(
        result.trans.inverse(), cov_backward, roi_fixed_start, roi_size_mm
    )
    deg = 180.0 / torch.pi
    we_f = result.weighted_error
    we_b = result.weighted_error_backward
    sh_f = result.sheet_angles * deg
    sh_b = result.sheet_angles_backward * deg
    tu_f = result.tube_angles * deg
    tu_b = result.tube_angles_backward * deg
    return torch.stack(
        [
            torch.maximum(we_f, we_b),
            torch.maximum(max_trace_f, max_trace_b),
            torch.maximum(sh_f, sh_b),
            torch.maximum(tu_f, tu_b),
            torch.minimum(we_f, we_b),
            torch.minimum(max_trace_f, max_trace_b),
            torch.minimum(sh_f, sh_b),
            torch.minimum(tu_f, tu_b),
        ],
        dim=-1,
    )

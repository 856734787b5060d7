"""Classic multiresolution ICP (lrr_tpu/estimation/icp_classic.py;
cdcl/cdcl_estimation_ICP.{h,txx}).

Per resolution level: Euclidean closest-point matching (exact chunked 1-NN),
MAD robust scale with Beaton-Tukey weights, and the closed-form weighted
least-squares parameter and covariance estimate each iteration; a level ends
when the weighted RMS stops moving.  This is the reference `estimate` demo's
"ICP" method (cdcl/examples/estimate.cxx:86-110); the serving path is
estimation/icp.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lrr_tpu_torch.models.affine import (
    Affine3D,
    normal_equations_terms,
    solve_normal_equations,
)
from lrr_tpu_torch.ops.knn import nn1
from lrr_tpu_torch.ops.robust import mad_scale, weight_bt
from lrr_tpu_torch.types import no_tf32


class IcpClassicResult(NamedTuple):
    trans: Affine3D
    covar: torch.Tensor  # [12, 12]
    rms: torch.Tensor
    iterations: int
    converged: bool


def icp_classic(
    moving_xyz: torch.Tensor,  # [N, 3]
    moving_mask: torch.Tensor,
    fixed_xyz: torch.Tensor,  # [M, 3]
    fixed_mask: torch.Tensor,
    init: Affine3D,
    level_masks: list[tuple[torch.Tensor, torch.Tensor]] | None = None,
    max_iterations_per_level: int = 30,
    tol: float = 1e-4,
) -> IcpClassicResult:
    """Run ICP through resolution levels (a list of (moving_mask, fixed_mask)
    pairs, coarse to fine; default one full-resolution level).  Runs on the
    device of its inputs; the convergence test reads the RMS on the host
    each iteration."""
    no_tf32()
    if level_masks is None:
        level_masks = [(moving_mask, fixed_mask)]
    dt, dev = moving_xyz.dtype, moving_xyz.device
    trans = init
    covar = torch.zeros((12, 12), dtype=dt, device=dev)
    rms = torch.full((), float("inf"), dtype=dt, device=dev)
    total_iters = 0
    converged = False
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(moving_xyz.shape[0], 3, 3)

    for m_mask, f_mask in level_masks:
        prev_rms = torch.full((), float("inf"), dtype=dt, device=dev)
        for _ in range(max_iterations_per_level):
            mapped = trans.apply(moving_xyz)
            d2, idx = nn1(mapped, fixed_xyz, f_mask)
            to = fixed_xyz[idx]
            r = torch.sqrt(torch.clamp(d2, min=0.0))
            valid = m_mask & torch.isfinite(d2)
            scale = torch.clamp(mad_scale(r, valid), min=1e-3)
            w = weight_bt((r / scale) ** 2) / (scale * scale)
            w = torch.where(valid, w, torch.zeros_like(w))
            AtA, Atb = normal_equations_terms(trans, moving_xyz, to, eye3, w)
            trans, covar = solve_normal_equations(AtA, Atb, trans.center)
            rms = torch.sqrt(torch.sum(w * d2) / torch.clamp(torch.sum(w), min=1e-30))
            total_iters += 1
            if bool(torch.abs(prev_rms - rms) < tol):
                converged = True
                break
            prev_rms = rms

    return IcpClassicResult(trans=trans, covar=covar, rms=rms, iterations=total_iters,
                            converged=converged)

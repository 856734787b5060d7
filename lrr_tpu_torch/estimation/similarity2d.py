"""2-D similarity ICP, the reference's 2-D demo path
(lrr_tpu/estimation/similarity2d.py; cdcl/examples/estimate.cxx:86-110).

Per iteration: exact 1-NN matching over the [M, N] distance tile, robust
scale (MUSE on the first iteration, RMS after, annealed 8x -> 1x over the
first iterations), Beaton-Tukey weights and the closed-form weighted
similarity least squares.  The loop runs on the host, one device sync an
iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lrr_tpu_torch.models.affine import pinv_hermitian
from lrr_tpu_torch.models.similarity import Similarity2D, similarity2d_normal_equations
from lrr_tpu_torch.ops import robust
from lrr_tpu_torch.ops.geometry import expanded_sq_dists
from lrr_tpu_torch.types import no_tf32

SCALE_FLOOR = 0.005


class Sim2DResult(NamedTuple):
    trans: Similarity2D
    covar: torch.Tensor  # [4, 4]
    converged: bool
    iterations: int
    rms: torch.Tensor


def icp_similarity2d(
    moving_xy: torch.Tensor,  # [M, 2]
    moving_mask: torch.Tensor,  # [M]
    fixed_xy: torch.Tensor,  # [N, 2]
    fixed_mask: torch.Tensor,  # [N]
    init: Similarity2D,
    max_iterations: int = 50,
    convergence_tol: float = 1e-5,
) -> Sim2DResult:
    no_tf32()
    inf = torch.full((), float("inf"), dtype=moving_xy.dtype, device=moving_xy.device)
    zero = torch.zeros((), dtype=moving_xy.dtype, device=moving_xy.device)
    msk = moving_mask
    n_valid = torch.clamp(torch.sum(msk), min=1)

    def match(mapped):
        # lrr_tpu's |a|^2 + |b|^2 - 2ab expansion, rounded as it rounds it;
        # the first index on ties
        d2 = torch.where(fixed_mask[None, :], expanded_sq_dists(mapped, fixed_xy), inf)
        return fixed_xy[torch.argmin(d2, dim=-1)]

    def one_iteration(trans, prev_rms, iteration: int, use_muse: bool):
        mapped = trans.apply(moving_xy)
        to = match(mapped)
        r2 = torch.sum((mapped - to) ** 2, -1)
        if use_muse:
            scale = robust.muse_scale(torch.sqrt(r2), msk)
        else:
            scale = torch.sqrt(torch.sum(torch.where(msk, r2, zero)) / n_valid)
        # anneal the robust scale 8x -> 1x over the first iterations so the
        # similarity cannot collapse onto nearest-neighbour noise before
        # coarse alignment
        anneal = max(8.0 * 0.5**iteration, 1.0)
        scale = torch.clamp(scale * anneal, min=SCALE_FLOOR)
        w = robust.weight_bt(r2 / (scale * scale)) / (scale * scale)
        w = torch.where(msk, w, zero)
        AtA, Atb = similarity2d_normal_equations(moving_xy, to, w, trans.center)
        cov = pinv_hermitian(AtA)
        new = Similarity2D.from_theta((cov * Atb[None, :]).sum(-1), trans.center)
        mapped2 = new.apply(moving_xy)
        rms = torch.sqrt(
            torch.sum(torch.where(msk, torch.sum((mapped2 - to) ** 2, -1), zero)) / n_valid)
        # no convergence while the annealing schedule is still active
        converged = bool(torch.abs(rms - prev_rms) < convergence_tol) and iteration >= 4
        return new, cov, rms, converged

    rms = torch.full((), float("inf"), dtype=moving_xy.dtype, device=moving_xy.device)
    trans, covar, rms, converged = one_iteration(init, rms, 0, True)  # the MUSE iteration
    iteration = 1
    while not converged and iteration < max_iterations:
        trans, covar, rms, converged = one_iteration(trans, rms, iteration, False)
        iteration += 1
    return Sim2DResult(trans=trans, covar=covar, converged=converged, iterations=iteration,
                       rms=rms)

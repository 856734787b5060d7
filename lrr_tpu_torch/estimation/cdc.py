"""EM Covariance-Driven Correspondences (lrr_tpu/estimation/cdc.py;
cdcl/cdcl_estimation.{h,txx} and its objective functions).

  * matching: each moving point matches the fixed points within radius
    5 sqrt(lambda_max(Jth C Jth^T + Jp Cp Jp^T)) of its mapped location, the
    100 nearest of them (:342-475), weighted by the f-scaled Beaton-Tukey
    weight of the Mahalanobis residual and normalised w0^2 / (w_i w_j) over
    row and column sums (:527-539);
  * objective: f = (1/N) sum w (rho(e^T Cij^-1 e) + log det Cij), gated by
    rho' > 0 (cdcl_obj_fun_par.txx:44-144), differentiated by autograd;
  * EM: from iteration 5 on, L-BFGS over the parameters, then over the
    upper Cholesky factor of the parameter covariance, in unit-radius
    normalised coordinates;
  * transfer variant: one 3 x 3 transfer covariance replaces Jth C Jth^T;
    symmetric variant: the forward parameters drive both directions.

Runs on the device of its inputs with a host loop (the demo path, not the
serving loop).  Every step is deterministic on the card: the k nearest are
a stable sort (ties to the lower index), the column sums a fixed-order sum
over stably sorted indices, never an atomic scatter-add.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from lrr_tpu_torch.estimation.lbfgs import lbfgs
from lrr_tpu_torch.models.affine import (
    Affine3D,
    covariance_normalize,
    covariance_unnormalize,
    mm3,
    transfer_covariance,
)
from lrr_tpu_torch.ops.eig3 import eigvalsh3
from lrr_tpu_torch.ops.geometry import expanded_sq_dists, masked_mean
from lrr_tpu_torch.ops.robust import rho_bt, rho_p_bt, weight_bt_scaled
from lrr_tpu_torch.types import no_tf32

EVAL_MULTIPLIER = 5.0  # radius = 5 sqrt(lambda_max) (cdcl_estimation.txx:350)
MAX_CANDIDATES = 100  # (:355)
START_EM = 5  # (:96)
MAX_ITERATIONS = 85  # (:195)
# Floor added to U^T U when a covariance is rebuilt: the ML objective is
# unbounded below as C -> 0 (log det -> -inf).
COV_FLOOR = 1e-6


class CovFeatures(NamedTuple):
    """Point set with per-point covariances (cdcl_feature<3>)."""

    xyz: torch.Tensor  # [N, 3]
    cov: torch.Tensor  # [N, 3, 3]
    mask: torch.Tensor  # [N]


@dataclasses.dataclass
class CdcMatches:
    from_xyz: torch.Tensor  # [N, 3]
    from_cov: torch.Tensor  # [N, 3, 3]
    to_xyz: torch.Tensor  # [N, K, 3]
    to_cov: torch.Tensor  # [N, K, 3, 3]
    weight: torch.Tensor  # [N, K]
    mask: torch.Tensor  # [N, K]


def _point_cov(trans: Affine3D, covar, xyz, cov, transfer):
    """Jth C Jth^T (or the transfer covariance) + Jp Cp Jp^T [N, 3, 3]."""
    if transfer is None:
        Cth = transfer_covariance(trans, covar, xyz)
    else:
        Cth = transfer.expand(xyz.shape[0], 3, 3)
    return Cth + mm3(mm3(trans.A, cov), trans.A.T)


def _column_sums(idx: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """table[j] = sum of w where idx == j, in a fixed order on every device:
    the flat indices sorted stably, each run of equal indices laid out as a
    row of a dense table and summed (no atomic scatter-add)."""
    flat_i, flat_w = idx.reshape(-1), w.reshape(-1)
    order = torch.argsort(flat_i, stable=True)
    si, sw = flat_i[order], flat_w[order]
    counts = torch.bincount(si, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(si.shape[0], device=si.device) - starts[si]
    width = int(counts.max()) if si.numel() else 0
    dense = w.new_zeros((n, max(width, 1)))
    dense[si, pos] = sw
    return dense.sum(1)


def compute_weights(
    trans: Affine3D,
    covar: torch.Tensor,  # [12, 12] theta-order parameter covariance
    moving: CovFeatures,
    fixed: CovFeatures,
    max_candidates: int = MAX_CANDIDATES,
    transfer: Optional[torch.Tensor] = None,  # [3, 3], replaces Jth C Jth^T
) -> CdcMatches:
    """Mahalanobis matching within a radius set by the current uncertainty
    (cdcl_estimation.txx:342-545)."""
    no_tf32()
    mapped = trans.apply(moving.xyz)
    Cij_p = _point_cov(trans, covar, moving.xyz, moving.cov, transfer)
    radius2 = EVAL_MULTIPLIER**2 * eigvalsh3(Cij_p)[:, 2]

    # the k nearest fixed candidates by lrr_tpu's |a|^2 + |b|^2 - 2ab,
    # rounded as it rounds it, a stable ascending sort for its top_k
    f = fixed.xyz
    d2 = expanded_sq_dists(mapped, f)
    d2 = torch.where(fixed.mask[None, :], d2, torch.full_like(d2, float("inf")))
    k = min(max_candidates, f.shape[0])
    d2k, idx = torch.sort(d2, dim=1, stable=True)
    d2k, idx = d2k[:, :k], idx[:, :k]
    pair_mask = (d2k <= radius2[:, None]) & torch.isfinite(d2k) & moving.mask[:, None]

    to_xyz = f[idx]
    to_cov = fixed.cov[idx]
    Cij = Cij_p[:, None] + to_cov
    e = mapped[:, None, :] - to_xyz
    sol = torch.linalg.solve_ex(Cij, e[..., None])[0][..., 0]
    r2 = torch.clamp(torch.sum(e * sol, -1), min=0.0)
    w0 = torch.where(pair_mask, weight_bt_scaled(r2), torch.zeros_like(r2))

    # normalisation w0^2 / (w_i w_j) (:527-539)
    wi = torch.sum(w0, dim=1)
    wj = _column_sums(idx, w0, f.shape[0])[idx]
    denom = wi[:, None] * wj
    w = torch.where(denom > 0, w0 * w0 / torch.clamp(denom, min=1e-30), torch.zeros_like(w0))
    return CdcMatches(from_xyz=moving.xyz, from_cov=moving.cov, to_xyz=to_xyz, to_cov=to_cov,
                      weight=w, mask=pair_mask & (w0 > 0))


def _objective_terms(theta, covar, m: CdcMatches, transfer, center) -> torch.Tensor:
    """f = (1/N) sum w (rho(r2) + log det Cij), inlier-gated
    (cdcl_obj_fun_par.txx:44-144)."""
    trans = Affine3D.from_theta(theta, center)
    Cij = _point_cov(trans, covar, m.from_xyz, m.from_cov, transfer)[:, None] + m.to_cov
    e = trans.apply(m.from_xyz)[:, None, :] - m.to_xyz
    sol = torch.linalg.solve_ex(Cij, e[..., None])[0][..., 0]
    r2 = torch.sum(e * sol, -1)
    r2 = torch.maximum(r2, torch.zeros_like(r2))
    inlier = (rho_p_bt(r2) > 0) & m.mask
    logdet = torch.linalg.slogdet(Cij)[1]
    terms = m.weight * (rho_bt(r2) + logdet)
    n = torch.clamp(torch.sum(torch.any(m.mask, dim=1)), min=1)
    return torch.sum(torch.where(inlier, terms, torch.zeros_like(terms))) / n


def _chol_pack(cov: torch.Tensor, dof: int) -> torch.Tensor:
    """Upper Cholesky factor packed row-major (cdcl_estimation.txx:283-296),
    jittered for float32 PSD round-off.  Where the factorisation fails the
    factor is the identity (H7: lrr_tpu's cholesky gives NaN there, which
    it replaces; torch's `cholesky` would raise)."""
    eye = torch.eye(dof, dtype=cov.dtype, device=cov.device)
    jitter = 1e-6 * torch.clamp(torch.trace(cov) / dof, min=1e-6)
    L, info = torch.linalg.cholesky_ex(cov + jitter * eye)
    L = torch.where((info == 0) & torch.isfinite(L), L, eye)
    iu = torch.triu_indices(dof, dof, device=cov.device)
    return L.T[iu[0], iu[1]]


def _chol_unpack(x: torch.Tensor, dof: int, floor: float = COV_FLOOR) -> torch.Tensor:
    iu = torch.triu_indices(dof, dof, device=x.device)
    U = x.new_zeros((dof, dof)).index_put((iu[0], iu[1]), x)
    return mm3(U.T, U) + floor * torch.eye(dof, dtype=x.dtype, device=x.device)


class CdcState(NamedTuple):
    trans: Affine3D
    covar: torch.Tensor  # [12, 12]
    transfer: Optional[torch.Tensor]  # [3, 3] or None
    iteration: int
    converged: bool


def _normalization(m: CdcMatches):
    any_match = torch.any(m.mask, dim=1)
    cm = masked_mean(m.from_xyz, any_match)
    rm = masked_mean(torch.linalg.norm(m.from_xyz - cm, dim=-1), any_match)
    to_flat = m.to_xyz.reshape(-1, 3)
    to_mask = m.mask.reshape(-1)
    cf = masked_mean(to_flat, to_mask)
    rf = masked_mean(torch.linalg.norm(to_flat - cf, dim=-1), to_mask)
    return cm, torch.clamp(rm, min=1e-6), cf, torch.clamp(rf, min=1e-6)


def _normalize_matches(m: CdcMatches, cm, rm, cf, rf) -> CdcMatches:
    return dataclasses.replace(
        m, from_xyz=(m.from_xyz - cm) / rm, from_cov=m.from_cov / (rm * rm),
        to_xyz=(m.to_xyz - cf) / rf, to_cov=m.to_cov / (rf * rf),
    )


def estimate_parameters(
    trans: Affine3D, covar, m: CdcMatches, transfer, symmetric: bool = False,
    m_bwd: Optional[CdcMatches] = None,
):
    """One L-BFGS parameter step in normalised coordinates
    (cdcl_estimation.txx:209-258): (new transform, converged)."""
    cm, rm, cf, rf = _normalization(m)
    mn = _normalize_matches(m, cm, rm, cf, rf)
    tn = trans.normalize(rm, rf, cm, cf)
    cn = covariance_normalize(covar, rm, rf, cm, cf)
    tr_n = None if transfer is None else transfer / (rf * rf)
    zero = torch.zeros(3, dtype=covar.dtype, device=covar.device)

    if symmetric and m_bwd is not None:
        mbn = _normalize_matches(m_bwd, cf, rf, cm, rm)

        def fun(theta):
            f_fwd = _objective_terms(theta, cn, mn, tr_n, zero)
            inv = Affine3D.from_theta(theta, zero).inverse()
            return f_fwd + _objective_terms(inv.theta, cn, mbn, tr_n, zero)
    else:
        def fun(theta):
            return _objective_terms(theta, cn, mn, tr_n, zero)

    res = lbfgs(fun, tn.theta, max_iters=5)
    new_w = Affine3D.from_theta(res.x, zero).unnormalize(rm, rf, cm, cf)
    improved = fun(tn.theta) - res.f
    return new_w, bool(improved < 1e-4)


def estimate_covariance(trans: Affine3D, covar, m: CdcMatches, transfer):
    """One L-BFGS covariance step over the Cholesky factor
    (cdcl_estimation.txx:263-337): (covar, transfer, converged)."""
    cm, rm, cf, rf = _normalization(m)
    mn = _normalize_matches(m, cm, rm, cf, rf)
    theta_n = trans.normalize(rm, rf, cm, cf).theta
    zero = torch.zeros(3, dtype=covar.dtype, device=covar.device)

    if transfer is None:
        x0 = _chol_pack(covariance_normalize(covar, rm, rf, cm, cf), 12)

        def fun(x):
            return _objective_terms(theta_n, _chol_unpack(x, 12), mn, None, zero)

        res = lbfgs(fun, x0, max_iters=5)
        new_cov = covariance_unnormalize(_chol_unpack(res.x, 12), rm, rf, cm, cf)
        return new_cov, None, bool((fun(x0) - res.f) < 1e-5)

    x0 = _chol_pack(transfer / (rf * rf), 3)

    def fun(x):
        return _objective_terms(theta_n, covar, mn, _chol_unpack(x, 3), zero)

    res = lbfgs(fun, x0, max_iters=5)
    new_tr = _chol_unpack(res.x, 3) * (rf * rf)
    return covar, new_tr, bool((fun(x0) - res.f) < 1e-5)


def run_cdc(
    moving: CovFeatures,
    fixed: CovFeatures,
    init: Affine3D,
    init_covar: torch.Tensor | None = None,
    max_iterations: int = MAX_ITERATIONS,
    use_transfer: bool = False,
    symmetric: bool = False,
    max_candidates: int = MAX_CANDIDATES,
) -> CdcState:
    """A full EM-CDC run (cdcl_estimation::run, .txx:188-205) on the device of
    the point sets."""
    no_tf32()
    dev = moving.xyz.device
    covar = init_covar if init_covar is not None else 1e-2 * torch.eye(12, device=dev)
    transfer = 1e-1 * torch.eye(3, device=dev) if use_transfer else None
    trans = init
    converged = False
    it = 0
    for it in range(max_iterations):
        m = compute_weights(trans, covar, moving, fixed, max_candidates, transfer)
        pc = True
        if it > START_EM:
            m_bwd = None
            if symmetric:
                m_bwd = compute_weights(trans.inverse(), covar, fixed, moving, max_candidates,
                                        transfer)
            trans, pc = estimate_parameters(trans, covar, m, transfer, symmetric, m_bwd)
            m = compute_weights(trans, covar, moving, fixed, max_candidates, transfer)
        covar, transfer, cc = estimate_covariance(trans, covar, m, transfer)
        fro = float(torch.linalg.norm(covar if transfer is None else transfer))
        converged = pc and cc and fro < 1e-3 and it > START_EM
        if converged:
            break
    return CdcState(trans=trans, covar=covar, transfer=transfer, iteration=it,
                    converged=converged)

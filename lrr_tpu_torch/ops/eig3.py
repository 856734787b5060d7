"""Closed-form eigendecomposition of symmetric 3x3 matrices
(lrr_tpu/ops/eig3.py).

Branch-free trigonometric (Smith's method) eigenvalues and eigenvectors by
cross products, batched over leading dims.  The eigenvalues serve the
singular-value sanity check of every ICP iteration and the transfer-error
statistics; the full decomposition serves the detector's NMS directions and
sub-voxel fit.  Square roots go through `ieee.sqrt`: correctly rounded,
and the same bits in every process, on the CPU as on the card.
"""

from __future__ import annotations

import math

import torch

from lrr_tpu_torch.ops import ieee


def eigvalsh3(S: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending [..., 3]."""
    a00 = S[..., 0, 0]
    a11 = S[..., 1, 1]
    a22 = S[..., 2, 2]
    a01 = S[..., 0, 1]
    a02 = S[..., 0, 2]
    a12 = S[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = ieee.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))

    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detB / (2.0 * safe_p**3), -1.0, 1.0)

    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    zero_p = p2 <= 1e-30 * torch.clamp(q * q, min=1.0)
    e_lo = torch.where(zero_p, q, e_lo)
    e_mid = torch.where(zero_p, q, e_mid)
    e_hi = torch.where(zero_p, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec(S: torch.Tensor, lam: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of S for eigenvalue lam: the largest of the three
    cross products of rows of (S - lam I) (the first of equal ones, as
    `jnp.argmax` picks), or `fallback` where all three vanish."""
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    M = S - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cand = torch.stack(
        [torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2), torch.linalg.cross(r1, r2)],
        dim=-2,
    )
    n = (cand * cand).sum(-1)
    nmax, best = torch.max(n, dim=-1, keepdim=True)
    v = cand.gather(-2, best[..., None].expand(best.shape + (3,)))[..., 0, :]
    return torch.where(nmax > 1e-24, v / ieee.sqrt(torch.clamp(nmax, min=1e-30)), fallback)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return ieee.sqrt((v * v).sum(-1, keepdim=True))


def unit(v: torch.Tensor) -> torch.Tensor:
    """Rows of v [..., 3] scaled to unit length (a zero row stays zero)."""
    return v / torch.clamp(_norm(v), min=1e-12)


def eigh3(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric 3x3 eigendecomposition: (w [..., 3] ascending,
    V [..., 3, 3]) with V[..., :, i] the unit eigenvector of w[..., i], a
    right-handed orthonormal frame (v_mid = v_hi x v_lo)."""
    w = eigvalsh3(S)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=S.dtype, device=S.device).expand(w.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=S.dtype, device=S.device).expand(w.shape)
    v_hi = _eigvec(S, w[..., 2], ex)
    # make lo orthogonal to hi even when eigenvalues cluster
    v_lo = _eigvec(S, w[..., 0], ey)
    v_lo = v_lo - (v_lo * v_hi).sum(-1, keepdim=True) * v_hi
    norm = _norm(v_lo)
    alt = torch.linalg.cross(v_hi, ey)
    alt_n = _norm(alt)
    alt2 = torch.linalg.cross(v_hi, ex)
    alt2_n = _norm(alt2)
    alt = torch.where(
        alt_n > 1e-6, alt / torch.clamp(alt_n, min=1e-30), alt2 / torch.clamp(alt2_n, min=1e-30)
    )
    v_lo = torch.where(norm > 1e-6, v_lo / torch.clamp(norm, min=1e-30), alt)
    v_mid = torch.linalg.cross(v_hi, v_lo)
    return w, torch.stack([v_lo, v_mid, v_hi], dim=-1)

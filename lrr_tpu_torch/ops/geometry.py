"""Coordinate normalisation and masked point statistics
(lrr_tpu/ops/geometry.py; cdcl's normalisation, cdcl_utils.h:36-85).

Distances are exact component-wise differences, never the
|a|^2 + |b|^2 - 2ab expansion, which cancels at CT coordinates.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Mean over the valid rows; the mask broadcasts over trailing dims."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    num = torch.sum(x * m, dim=axis)
    den = torch.clamp(torch.sum(m, dim=axis), min=1.0)
    return num / den


def center_and_radius(xyz: torch.Tensor, mask: torch.Tensor):
    """Centroid and RMS radius sqrt(mean ||x - c||^2) of a masked set [N, 3]."""
    c = masked_mean(xyz, mask)
    d2 = torch.sum(torch.square(xyz - c), dim=-1)
    m = mask.to(xyz.dtype)
    r2 = torch.sum(d2 * m) / torch.clamp(torch.sum(m), min=1.0)
    return c, torch.sqrt(torch.clamp(r2, min=1e-30))


def normalize_points(xyz: torch.Tensor, center, radius) -> torch.Tensor:
    return (xyz - center) / radius


def unnormalize_points(xyz: torch.Tensor, center, radius) -> torch.Tensor:
    return xyz * radius + center


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [M, 3] -> [N, M] squared distances, exact component-wise."""
    d2 = sum((a[:, c][:, None] - b[:, c][None, :]) ** 2 for c in range(3))
    return torch.clamp(d2, min=0.0)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 values is
    exact in float64, so only the float64 sum (53 bits) rounds before the
    float32 result."""
    return (a.double() * b.double() + c.double()).float()


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last dim as fused multiply-adds, x0 x0 first."""
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = _fma(x[..., c], x[..., c], s)
    return s


def expanded_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] as lrr_tpu's matching computes them under
    jit: |a|^2 + |b|^2 - (2a) . b in float32, each sum of products fused
    into multiply-adds as XLA contracts it, no matmul (so no TF32).  The
    expansion cancels at large coordinates; lrr_tpu's nearest-neighbour
    decisions (CDC's candidates, the 2-D similarity ICP) are made on exactly
    these numbers, so the port makes them on the same."""
    a2 = 2.0 * a
    ab = a2[:, None, 0] * b[None, :, 0]
    for c in range(1, a.shape[-1]):
        ab = _fma(a2[:, None, c], b[None, :, c], ab)
    return (_sq_norm(a)[:, None] + _sq_norm(b)[None, :]) - ab

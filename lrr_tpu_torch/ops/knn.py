"""Exact brute-force nearest neighbours (lrr_tpu/ops/knn.py).

Spatial coordinates (D <= 8) use exact component-wise differences, 1,024
queries at a time, so that whole feature sets fit.  Wider points (the 195-d
descriptors) go to kernel K2 (`ops.kernels.knn`), which also computes
differences directly.  `torch.cdist` is not used: it switches to the
|a|^2 + |b|^2 - 2ab expansion on larger inputs, which cancels.
"""

from __future__ import annotations

import torch

from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.types import no_tf32

QUERY_CHUNK = 1024


def _sq_dists(q: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[q, N] squared distances, summed component by component in order."""
    d2 = torch.zeros((q.shape[0], points.shape[0]), dtype=q.dtype, device=q.device)
    for c in range(q.shape[1]):
        diff = q[:, c][:, None] - points[:, c][None, :]
        d2 = d2 + diff * diff
    return d2


def knn(
    queries: torch.Tensor,  # [Q, D]
    points: torch.Tensor,  # [N, D]
    point_mask: torch.Tensor,  # [N] bool
    k: int,
    query_chunk: int = QUERY_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2.  Returns (sq_dists [Q, k], indices [Q, k]
    int32); masked points never match (distance +inf); ties go to the lower
    index (the first minimum for k = 1, a stable sort otherwise)."""
    if queries.shape[1] > 8:
        return kernels.knn(queries, points, point_mask, k)
    inf = torch.full((), float("inf"), dtype=queries.dtype, device=queries.device)
    vals, idx = [], []
    for q0 in range(0, queries.shape[0], query_chunk):
        d2 = torch.where(point_mask[None, :], _sq_dists(queries[q0 : q0 + query_chunk], points), inf)
        if k == 1:
            m = d2.min(dim=1)
            v, i = m.values[:, None], m.indices[:, None]
        else:
            v, i = torch.sort(d2, dim=1, stable=True)
            v, i = v[:, :k], i[:, :k]
        vals.append(v)
        idx.append(i.to(torch.int32))
    if not vals:
        return (queries.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int32, device=queries.device))
    return torch.cat(vals), torch.cat(idx)


def nn1(
    queries: torch.Tensor, points: torch.Tensor, point_mask: torch.Tensor,
    query_chunk: int = QUERY_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN convenience wrapper. Returns (sq_dist [Q], index [Q])."""
    d2, idx = knn(queries, points, point_mask, 1, query_chunk)
    return d2[:, 0], idx[:, 0]


def radius_count(
    queries: torch.Tensor, points: torch.Tensor, point_mask: torch.Tensor, radius: float,
    query_chunk: int = QUERY_CHUNK,
) -> torch.Tensor:
    """Number of masked-in points within `radius` of each query [Q] int32.
    D <= 8 by exact differences; wider points by lrr_tpu's expansion
    |q|^2 + |p|^2 - 2 q.p (its float32 product, TF32 off)."""
    r2 = radius * radius
    wide = queries.shape[1] > 8
    if wide:
        no_tf32()
        p2 = torch.sum(points * points, -1)
    out = []
    for q0 in range(0, queries.shape[0], query_chunk):
        q = queries[q0 : q0 + query_chunk]
        if wide:
            d2 = torch.sum(q * q, -1, keepdim=True) + p2[None, :] - 2.0 * (q @ points.T)
        else:
            d2 = _sq_dists(q, points)
        out.append(((d2 <= r2) & point_mask[None, :]).sum(-1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=queries.device)

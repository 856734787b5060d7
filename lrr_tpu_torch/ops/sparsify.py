"""Strength-greedy spatial sparsification (lrr_tpu/ops/sparsify.py).

Reference: itkMeshSpatialFilterClean: process points in descending
strength; keep a point iff no already-kept point lies within min-distance.
Used with 2 mm for features and 6 mm for keypoints.

The result is exactly the sequential greedy's keep set, in its order
(descending strength, ties by ascending index).  The JAX package walks that
order in batches of dense [B, N] distance tiles.  Here the conflict graph is
built sparsely instead: points are hashed into cells a little wider than the
radius, each point meets only the points of its 27 neighbouring cells, and
the pairs closer than the radius (the same component-wise fp32 test) become
edges from the earlier point to the later one.  The greedy is then the
fixed point of one monotone rule over those edges: a point is KEPT once all
its earlier neighbours are DEAD, and DEAD once any of them is KEPT.  Every
round settles at least the earliest unsettled point, so it ends, and the
fixed point is unique, so it is the greedy's answer.  Cost: one sort, nine
range searches, and a few rounds over a shrinking edge list with one host
read each.
"""

from __future__ import annotations

import torch

UNKNOWN = 0
KEPT = 1
DEAD = 2


def _conflict_edges(xs: torch.Tensor, min_distance: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Edges (earlier, later) between points [n, 3] closer than
    `min_distance`; a point's index is its place in the greedy's order."""
    n = xs.shape[0]
    dev = xs.device
    # cells 0.1 % wider than the radius: two points within the radius are in
    # neighbouring cells whatever the rounding of the division
    cell = torch.floor((xs - xs.min(0).values) / (min_distance * 1.001)).long() + 1
    dims = cell.max(0).values + 2  # one empty layer all round: no aliasing
    key = (cell[:, 2] * dims[1] + cell[:, 1]) * dims[0] + cell[:, 0]
    skey, by_cell = torch.sort(key)
    d2max = torch.tensor(min_distance * min_distance, dtype=xs.dtype, device=dev)
    arange_n = torch.arange(n, device=dev)
    earlier, later = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # x is the fastest axis of the key: the three x-neighbours of a
            # cell row are one contiguous key range
            mid = key + (dz * dims[1] + dy) * dims[0]
            start = torch.searchsorted(skey, mid - 1, right=False)
            count = torch.searchsorted(skey, mid + 1, right=True) - start
            a = torch.repeat_interleave(arange_n, count)
            first = torch.cumsum(count, 0) - count
            b = by_cell[start[a] + (torch.arange(a.shape[0], device=dev) - first[a])]
            d = xs[a] - xs[b]
            d2 = d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2
            hit = (d2 < d2max) & (a < b)
            earlier.append(a[hit])
            later.append(b[hit])
    return torch.cat(earlier), torch.cat(later)


def sparsify_mask(
    xyz: torch.Tensor, strength: torch.Tensor, mask: torch.Tensor, min_distance: float
) -> torch.Tensor:
    """bool [N] keep-mask: the strength-greedy sparsification of the masked
    points."""
    N = xyz.shape[0]
    dev = xyz.device
    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    # the greedy's processing order: descending strength, ties by ascending
    # index (stable sort); masked points sink to the tail and are cut
    key = torch.where(mask, strength, torch.full_like(strength, -torch.inf))
    perm = torch.sort(-key, stable=True).indices
    perm = perm[mask[perm]]
    n = perm.shape[0]
    if n == 0:
        return keep
    ea, eb = _conflict_edges(xyz[perm], min_distance)

    state = torch.full((n,), UNKNOWN, dtype=torch.int32, device=dev)
    while True:
        # per later point: 2 if an earlier neighbour is KEPT, 1 if one is
        # still UNKNOWN, 0 if all are DEAD (or there is none)
        sa = state[ea]
        vote = torch.where(sa == KEPT, 2, torch.where(sa == UNKNOWN, 1, 0)).to(torch.int32)
        worst = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
            0, eb, vote, "amax", include_self=True
        )
        new = torch.where(
            state != UNKNOWN, state,
            torch.where(worst == 2, DEAD, torch.where(worst == 1, UNKNOWN, KEPT)).to(torch.int32),
        )
        if torch.equal(new, state):
            break
        state = new
        # an edge still matters while its later end is unsettled and its
        # earlier end is not DEAD
        live = (state[eb] == UNKNOWN) & (state[ea] != DEAD)
        ea, eb = ea[live], eb[live]
    keep[perm[state == KEPT]] = True
    return keep

"""Watershed oversegmentation (lrr_tpu/ops/watershed.py).

Replaces features/WatershedSegmentation1.cxx: gradient anisotropic
diffusion (conductance 2.0, 10 iterations) -> gradient magnitude -> basin
labels with lower-threshold and scale-level parameters (canonical
`2.0 10 0.001 0.10`).

The labels are defined exactly, by the parallel descent-pointer
formulation:

  1. pre-flood the height at max(lower_threshold, scale_level) of its range;
  2. each voxel points to its strictly lower 6-neighbour of least height,
     ties to the smallest flat index, neighbours visited in the order axis
     0, 1, 2 and offset -1 then +1 along each (a border voxel's missing
     neighbour is itself, which never wins); a voxel with none points to
     itself;
  3. p <- p[p] until nothing changes: every voxel holds its basin minimum;
  4. exactly `plateau_sweeps` rounds of min-label propagation across
     6-neighbours of equal height, then p <- p[p] again.

The JAX package reaches the same labels on large volumes through composed
shifts, slab-windowed rounds and compacted tables, all documented there as
exact; here there is one path, over the whole volume.  Neighbour access is
by slice views, pointers are int32 (`index_select` takes them as they are),
and no scatter with duplicate indices is used anywhere.
"""

from __future__ import annotations

import math

import torch

from lrr_tpu_torch.ops import ieee


def _pair(n: int, d: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(start, length) of the voxels that have a neighbour at offset -d
    along an axis of size n, and of those neighbours."""
    return ((1, n - 1), (0, n - 1)) if d == 1 else ((0, n - 1), (1, n - 1))


def anisotropic_diffusion(
    vol: torch.Tensor, conductance: float = 2.0, iterations: int = 10,
    time_step: float = 0.0625,
) -> torch.Tensor:
    """Perona-Malik gradient anisotropic diffusion (the behaviour of
    itk::GradientAnisotropicDiffusionImageFilter), zero flux across the
    border.  The flux between two neighbours is computed once and added to
    one, subtracted from the other: the sums of the JAX package in its
    order."""
    k2 = conductance * conductance
    v = vol
    for _ in range(iterations):
        acc = torch.zeros_like(v)
        for ax in range(3):
            n = v.shape[ax]
            if n < 2:
                continue
            d = v.narrow(ax, 1, n - 1) - v.narrow(ax, 0, n - 1)
            flux = torch.exp(-(d * d) / k2) * d
            acc.narrow(ax, 0, n - 1).add_(flux)
            acc.narrow(ax, 1, n - 1).sub_(flux)
        v = v + time_step * acc
    return v


def gradient_magnitude(vol: torch.Tensor) -> torch.Tensor:
    """Central differences, zero on the border planes of each axis."""
    acc = torch.zeros_like(vol)
    for ax in range(3):
        n = vol.shape[ax]
        if n < 3:
            continue
        g = (vol.narrow(ax, 2, n - 2) - vol.narrow(ax, 0, n - 2)) * 0.5
        acc.narrow(ax, 1, n - 2).add_(g * g)
    return ieee.sqrt(acc)


def _pointer_jump(p: torch.Tensor, max_rounds: int) -> tuple[torch.Tensor, int]:
    """p <- p[p] over the whole table until a round changes nothing or
    `max_rounds`; returns the table and the rounds run.  One host sync a
    round (about log2 of the longest descent chain rounds)."""
    rounds = 0
    while rounds < max_rounds:
        p2 = torch.index_select(p, 0, p)
        rounds += 1
        changed = bool((p2 != p).any())
        p = p2
        if not changed:
            break
    return p, rounds


def _preflood(height: torch.Tensor, lower_threshold: float, scale_level: float) -> torch.Tensor:
    """max(height, level), level = hmin + max(thresholds) * (hmax - hmin)
    with the product and the sum fused into one rounding, as the JAX
    reference computes it on the CPU (the float64 sum of an exact product
    rounds once more to float32; the two agree except on a 2^-29 sliver).
    An ulp of `level` moves voxels in and out of the pre-flood plateau."""
    f64 = torch.float64
    hmin, hmax = height.min(), height.max()
    frac = torch.tensor(max(lower_threshold, scale_level), dtype=height.dtype,
                        device=height.device)
    level = (hmin.to(f64) + frac.to(f64) * (hmax - hmin).to(f64)).to(height.dtype)
    return torch.maximum(height, level)


def _descent_pointers(h: torch.Tensor) -> torch.Tensor:
    """int32 [D, H, W]: flat index of each voxel's strictly lower
    6-neighbour of least height (ties to the smallest flat index), itself
    where there is none."""
    D, H, W = h.shape
    dev = h.device
    idx3 = (
        torch.arange(D, dtype=torch.int32, device=dev)[:, None, None] * (H * W)
        + torch.arange(H, dtype=torch.int32, device=dev)[None, :, None] * W
        + torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    )
    best_i = idx3.clone()
    best_h = h.clone()
    for axis in (0, 1, 2):
        n = h.shape[axis]
        if n < 2:
            continue
        for d in (1, -1):
            (d0, dn), (s0, sn) = _pair(n, d)
            nb_h, nb_i = h.narrow(axis, s0, sn), idx3.narrow(axis, s0, sn)
            bh, bi = best_h.narrow(axis, d0, dn), best_i.narrow(axis, d0, dn)
            lower = (nb_h < bh) | ((nb_h == bh) & (nb_i < bi))
            bi.copy_(torch.where(lower, nb_i, bi))
            bh.copy_(torch.where(lower, nb_h, bh))
    return best_i


def _plateau_sweeps(labels: torch.Tensor, h: torch.Tensor, sweeps: int) -> torch.Tensor:
    """`sweeps` Jacobi rounds of min-label propagation across 6-neighbours
    of equal height."""
    same = {
        axis: h.narrow(axis, 1, n - 1) == h.narrow(axis, 0, n - 1)
        for axis, n in enumerate(h.shape) if n >= 2
    }
    for _ in range(sweeps):
        new = labels.clone()
        for axis, eq in same.items():
            n = h.shape[axis]
            for d in (1, -1):
                (d0, dn), (s0, sn) = _pair(n, d)
                nv = new.narrow(axis, d0, dn)
                nv.copy_(torch.where(eq, torch.minimum(nv, labels.narrow(axis, s0, sn)), nv))
        labels = new
    return labels


def watershed_labels(
    height: torch.Tensor,
    lower_threshold: float = 0.001,
    scale_level: float = 0.10,
    plateau_sweeps: int = 8,
) -> torch.Tensor:
    """int32 [D, H, W] basin labels (values are basin-minimum flat indices),
    on the device of `height`."""
    D, H, W = height.shape
    n = D * H * W
    if n >= 2**31:
        raise ValueError(f"watershed_labels: {n} voxels do not fit int32 pointers")
    rounds = max(1, math.ceil(math.log2(max(n, 2))))
    h = _preflood(height, lower_threshold, scale_level)
    p, _ = _pointer_jump(_descent_pointers(h).reshape(-1), rounds)
    labels = _plateau_sweeps(p.reshape(D, H, W), h, plateau_sweeps)
    out, _ = _pointer_jump(labels.reshape(-1), rounds)
    return out.reshape(D, H, W)


def watershed_segmentation(
    vol: torch.Tensor,
    conductance: float = 2.0,
    iterations: int = 10,
    lower_threshold: float = 0.001,
    scale_level: float = 0.10,
) -> torch.Tensor:
    smoothed = anisotropic_diffusion(vol, conductance, iterations)
    grad = gradient_magnitude(smoothed)
    return watershed_labels(grad, lower_threshold, scale_level)

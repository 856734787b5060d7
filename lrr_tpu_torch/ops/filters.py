"""Separable volume filters: Gaussian smoothing and derivatives, box mean,
pyramid downsampling (lrr_tpu/ops/filters.py).

FIR separable correlations written as shift-and-add over an edge-padded
copy, one multiply and one add per tap in tap order.  The order of the sum
fixes the bits of the score volume, and the score feeds strict comparisons
(the noise floor, the axis-max filter, the NMS), so this is not handed to
`conv3d`: a library convolution sums in another order (and in TF32 unless
told otherwise).

Volumes are [D, H, W] in (z, y, x) storage; sigmas are per axis in voxels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(sigma: float, order: int = 0, truncate: float = 4.0) -> np.ndarray:
    """FIR Gaussian (order 0) or its first derivative (order 1), normalised.

    order=1 returns d/dx of the Gaussian, signed so that correlating a ramp
    +x yields +1."""
    if sigma <= 0:
        if order == 0:
            return np.array([1.0], np.float32)
        return np.array([0.5, 0.0, -0.5], np.float32)[::-1]
    r = max(1, int(math.ceil(truncate * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    if order == 0:
        return g.astype(np.float32)
    d = -x / sigma**2 * g
    # the response to a unit ramp is exactly 1: slope = sum(x * d)
    d = d / np.sum(x * d)
    return d.astype(np.float32)


def _pad_edge(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Edge-pad one of the three spatial axes of [D, H, W] by r on both
    sides (`F.pad` replicates only over the spatial dims of a 5-D input)."""
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r
    return F.pad(x[None, None], pad, mode="replicate")[0, 0]


def correlate1d(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate [D, H, W] along `axis` with a static kernel, edge-padded:
    out[i] = sum_k kernel[k + r] * x[i + k]."""
    k = np.asarray(kernel)
    r = (len(k) - 1) // 2
    if r == 0:
        return x * float(k[0])
    xp = _pad_edge(x, axis, r)
    n = x.shape[axis]
    out = None
    for i, w in enumerate(k):
        if w == 0.0:
            continue
        term = xp.narrow(axis, i, n) * float(w)
        out = term if out is None else out.add_(term)
    return out if out is not None else torch.zeros_like(x)


def gaussian_smooth(vol: torch.Tensor, sigma_vox, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian smoothing; sigma_vox is a scalar or per axis (z, y, x)."""
    sigmas = np.broadcast_to(np.asarray(sigma_vox, np.float64), (3,))
    out = vol
    for ax in range(3):
        out = correlate1d(out, gaussian_kernel(float(sigmas[ax]), 0, truncate), ax)
    return out


def gaussian_gradient(vol: torch.Tensor, sigma_vox, spacing, truncate: float = 4.0) -> torch.Tensor:
    """Gradient of the Gaussian-smoothed volume in physical units (1/mm):
    [D, H, W, 3] with components ordered (gx, gy, gz)."""
    sigmas = np.broadcast_to(np.asarray(sigma_vox, np.float64), (3,))
    sp = np.broadcast_to(np.asarray(spacing, np.float64), (3,))  # (x, y, z)
    comps = []
    for comp, ax in ((0, 2), (1, 1), (2, 0)):  # axis 2 = x, 1 = y, 0 = z
        out = vol
        for a in range(3):
            order = 1 if a == ax else 0
            out = correlate1d(out, gaussian_kernel(float(sigmas[a]), order, truncate), a)
        comps.append(out / float(sp[comp]))
    return torch.stack(comps, dim=-1)


def box_mean(vol: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Mean over a (2r+1)^3 neighbourhood, edge-padded."""
    k = np.ones(2 * radius + 1, np.float32) / (2 * radius + 1)
    out = vol
    for ax in range(3):
        out = correlate1d(out, k, ax)
    return out


def downsample2(vol: torch.Tensor) -> torch.Tensor:
    """Pyramid shrink by 2: Gaussian presmooth at sigma 1 voxel, then every
    second voxel."""
    return gaussian_smooth(vol, 1.0)[::2, ::2, ::2]

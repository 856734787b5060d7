"""Trilinear sampling and warping of volumes (lrr_tpu/ops/resample.py).

Used by the NMS stepping, the sub-voxel fit, the direction refinement and
volume warping.  Written out as eight gathers and seven lerps in the JAX
package's order; `F.grid_sample` is not used, because its coordinate
convention and its rounding differ.  Out-of-bounds samples are clamped and
flagged.
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.ops import filters
from lrr_tpu_torch.types import Volume


def sample_trilinear(vol: torch.Tensor, idx_xyz: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trilinear interpolation of vol [D, H, W] or [D, H, W, C] (z, y, x
    storage) at continuous indices [..., 3] in (x, y, z) order.

    Returns (values [...] or [..., C], inside [...] bool); outside samples
    are clamped (values still returned) with inside=False."""
    D, H, W = vol.shape[:3]
    x, y, z = idx_xyz[..., 0], idx_xyz[..., 1], idx_xyz[..., 2]
    inside = (
        (x >= 0.0) & (x <= W - 1.0)
        & (y >= 0.0) & (y <= H - 1.0)
        & (z >= 0.0) & (z <= D - 1.0)
    )

    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    z = torch.clamp(z, 0.0, D - 1.0)

    def base(v, n):
        if n == 1:
            return torch.zeros_like(v, dtype=torch.int64)
        return torch.clamp(torch.floor(v).long(), 0, n - 2)

    x0, y0, z0 = base(x, W), base(y, H), base(z, D)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    if vol.dim() > 3:
        fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]

    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)

    flat = vol.reshape((D * H * W,) + tuple(vol.shape[3:]))

    def at(zz, yy, xx):
        return flat[(zz * H + yy) * W + xx]

    c00 = at(z0, y0, x0) * (1 - fx) + at(z0, y0, x1) * fx
    c01 = at(z0, y1, x0) * (1 - fx) + at(z0, y1, x1) * fx
    c10 = at(z1, y0, x0) * (1 - fx) + at(z1, y0, x1) * fx
    c11 = at(z1, y1, x0) * (1 - fx) + at(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz, inside


def warp_volume(
    moving: torch.Tensor,
    out_shape_zyx: tuple[int, int, int],
    out_origin: torch.Tensor,
    out_spacing: torch.Tensor,
    inverse_map,
    moving_origin: torch.Tensor,
    moving_spacing: torch.Tensor,
    fill: float = 0.0,
) -> torch.Tensor:
    """Resample `moving` onto an output grid through `inverse_map` (output
    physical points [n, 3] -> moving physical points), trilinear; `fill`
    outside.  One z-slab of the output at a time, which bounds the
    temporaries at any volume size."""
    D, H, W = out_shape_zyx
    dev = moving.device
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    out = torch.empty((D, H, W), dtype=moving.dtype, device=dev)
    slab = max(1, (1 << 22) // max(H * W, 1))
    for z0 in range(0, D, slab):
        z = torch.arange(z0, min(z0 + slab, D), dtype=torch.float32, device=dev)
        idx = torch.stack(
            [xx.expand(len(z), H, W), yy.expand(len(z), H, W),
             z[:, None, None].expand(len(z), H, W)], dim=-1,
        )
        phys = out_origin + idx * out_spacing
        src = inverse_map(phys.reshape(-1, 3)).reshape(phys.shape)
        vals, inside = sample_trilinear(moving, (src - moving_origin) / moving_spacing)
        out[z0 : z0 + len(z)] = torch.where(inside, vals, torch.full_like(vals, fill))
    return out


def resample_isotropic(vol: Volume, spacing_mm: float = 1.0, presmooth: bool = True) -> Volume:
    """Resample a volume to isotropic spacing: Gaussian presmooth along the
    axes that get coarser, then trilinear resampling."""
    sp = vol.spacing.cpu().numpy().astype(np.float64)  # (x, y, z)
    D, H, W = vol.data.shape
    size_mm = np.asarray([W, H, D]) * sp
    new_dims = np.maximum(np.round(size_mm / spacing_mm).astype(int), 1)
    data = vol.data
    if presmooth:
        sigmas_vox = []
        for s in (sp[2], sp[1], sp[0]):  # (z, y, x)
            ratio = spacing_mm / s
            sigmas_vox.append(0.5 * ratio if ratio > 1.0 else 0.0)
        data = filters.gaussian_smooth(data, sigmas_vox)
    out_shape = (int(new_dims[2]), int(new_dims[1]), int(new_dims[0]))
    new_spacing = torch.full((3,), spacing_mm, dtype=torch.float32, device=vol.device)
    out = warp_volume(
        data, out_shape, vol.origin, new_spacing, lambda p: p, vol.origin, vol.spacing
    )
    return Volume(data=out, origin=vol.origin, spacing=new_spacing)

"""Ground-truth deformation models: cubic B-spline FFD and dense fields
(lrr_tpu/models/bspline.py).

The reference reads ground truth as an ITK BSpline transform or a dense
deformation-field volume (rrl/itkLocationRegistration.cxx:931-1069) and fits
an affine transform to a deformation over an ROI by least squares for error
analysis (:2604-2790).
"""

from __future__ import annotations

import dataclasses

import torch

from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops.resample import sample_trilinear
from lrr_tpu_torch.ops.robust import linspace_f32
from lrr_tpu_torch.types import no_tf32, resolve_device


def _bspline_weights(t: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline basis at fractional offsets t [...] -> [..., 4]."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return torch.stack([w0, w1, w2, w3], dim=-1)


@dataclasses.dataclass
class BSplineTransform:
    """Cubic B-spline free-form deformation y = x + sum B(u) c_ijk.

    coefficients [Gz, Gy, Gx, 3] are control-point displacements (x, y, z
    components); the grid origin and spacing [3] (x, y, z) are in mm.  The
    grid pads the domain by one control point below and two above."""

    coefficients: torch.Tensor
    grid_origin: torch.Tensor
    grid_spacing: torch.Tensor

    def displacement(self, x: torch.Tensor) -> torch.Tensor:
        """[..., 3] -> [..., 3] displacement, cubic B-spline interpolation of
        the coefficient grid (64 taps, clamped at the grid's edge)."""
        Gz, Gy, Gx, _ = self.coefficients.shape
        u = (x - self.grid_origin) / self.grid_spacing
        fl = torch.floor(u)
        base = fl.to(torch.int64) - 1
        frac = u - fl
        wx, wy, wz = (_bspline_weights(frac[..., i]) for i in range(3))
        disp = torch.zeros_like(x)
        for iz in range(4):
            for iy in range(4):
                for ix in range(4):
                    gx = torch.clamp(base[..., 0] + ix, 0, Gx - 1)
                    gy = torch.clamp(base[..., 1] + iy, 0, Gy - 1)
                    gz = torch.clamp(base[..., 2] + iz, 0, Gz - 1)
                    w = wx[..., ix] * wy[..., iy] * wz[..., iz]
                    disp = disp + w[..., None] * self.coefficients[gz, gy, gx]
        return disp

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.displacement(x)

    @classmethod
    def identity(cls, grid_shape=(8, 8, 8), origin=(-20.0,) * 3, spacing=(20.0,) * 3,
                 device=None) -> "BSplineTransform":
        """Zero coefficients on `device` (default: the CUDA card)."""
        device = resolve_device(device, "BSplineTransform.identity")
        return cls(
            coefficients=torch.zeros(tuple(grid_shape) + (3,), device=device),
            grid_origin=torch.tensor(origin, dtype=torch.float32, device=device),
            grid_spacing=torch.tensor(spacing, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass
class DeformationField:
    """Dense displacement field y = x + D(x), trilinear; field [D, H, W, 3]
    (x, y, z components), zero outside."""

    field: torch.Tensor
    origin: torch.Tensor  # [3]
    spacing: torch.Tensor  # [3]

    def displacement(self, x: torch.Tensor) -> torch.Tensor:
        d, inside = sample_trilinear(self.field, (x - self.origin) / self.spacing)
        return torch.where(inside[..., None], d, torch.zeros_like(d))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.displacement(x)

    @classmethod
    def from_transform(cls, fn, shape_zyx, origin: torch.Tensor, spacing: torch.Tensor):
        """Rasterise any point map onto the grid (on origin's device)."""
        D, H, W = shape_zyx
        dev = origin.device
        zz, yy, xx = torch.meshgrid(
            torch.arange(D, dtype=torch.float32, device=dev),
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        pts = origin + torch.stack([xx, yy, zz], -1) * spacing
        disp = fn(pts.reshape(-1, 3)).reshape(pts.shape) - pts
        return cls(field=disp, origin=origin, spacing=spacing)


def fit_affine_to_field(deform, roi_lo: torch.Tensor, roi_hi: torch.Tensor,
                        samples_per_axis: int = 8):
    """Least-squares affine fit to a deformation (anything with `.apply`)
    over an ROI grid of samples_per_axis^3 points, on roi_lo's device:
    (affine, rms residual).  `torch.linalg.lstsq` (QR on the card, which
    needs full rank: the ROI grid has it)."""
    no_tf32()
    dev = roi_lo.device
    ax = linspace_f32(0.0, 1.0, samples_per_axis, device=dev)
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
    pts = roi_lo + torch.stack([gx, gy, gz], -1).reshape(-1, 3) * (roi_hi - roi_lo)
    mapped = deform.apply(pts)
    H = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)  # [N, 4]
    sol = torch.linalg.lstsq(H, mapped).solution
    aff = Affine3D(A=sol[:3].T.contiguous(), t=sol[3], center=torch.zeros(3, device=dev))
    res = aff.apply(pts) - mapped
    return aff, torch.sqrt(torch.mean(torch.sum(res * res, -1)))

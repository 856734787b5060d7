"""3D rigid transform (6 dof) with small-angle incremental estimation
(lrr_tpu/models/rigid.py).

Covers cdcl_trans_rigid3d: y = R (x - c) + t, Euler-angle extraction with
the gimbal-lock guard (.cxx:88-105), the small-angle increment
parameterisation (.cxx:157-160) and `recompose_increment` with SVD
re-orthogonalisation (.cxx:309-325).  The increment acts on already-mapped
points: R <- orth(I + [w]x) R, t <- orth(I + [w]x) t + dt.

Batched over leading dims.  Products that map coordinates are written out
as multiply-adds, never a matmul that could run in TF32.
"""

from __future__ import annotations

import dataclasses

import torch

from lrr_tpu_torch.models.affine import Affine3D, mm3, mv3, pinv_hermitian


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        dim=-2,
    )


def orthogonalize(R: torch.Tensor) -> torch.Tensor:
    """Nearest orthogonal matrix: singular values set to one
    (cdcl_trans_rigid3d.cxx:317-320).  U V^T does not depend on the SVD's
    sign choice; a matrix of negative determinant gives a reflection, as in
    the JAX package."""
    u, _, vt = torch.linalg.svd(R)
    return mm3(u, vt)


@dataclasses.dataclass
class Rigid3D:
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    center: torch.Tensor  # [..., 3]

    @classmethod
    def identity(cls, center=None, dtype=torch.float32, device=None) -> "Rigid3D":
        c = (
            torch.zeros(3, dtype=dtype, device=device) if center is None
            else torch.as_tensor(center, dtype=dtype, device=device)
        )
        return cls(R=torch.eye(3, dtype=dtype, device=device),
                   t=torch.zeros(3, dtype=dtype, device=device), center=c)

    def as_affine(self) -> Affine3D:
        return Affine3D(A=self.R, t=self.t, center=self.center)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Map points [..., P, 3], unrolled like `Affine3D.apply`."""
        return self.as_affine().apply(x)

    def inverse(self) -> "Rigid3D":
        """(cdcl_trans_rigid3d.cxx:111-117)"""
        Rt = self.R.transpose(-1, -2)
        return Rigid3D(R=Rt, t=-mv3(Rt, self.t) + self.center,
                       center=torch.zeros_like(self.t))

    def recompose_increment(self, omega: torch.Tensor, dt: torch.Tensor) -> "Rigid3D":
        """Apply a small-angle increment estimated on mapped points."""
        eye = torch.eye(3, dtype=self.R.dtype, device=self.R.device)
        dR = orthogonalize(eye + skew(omega))
        return Rigid3D(R=mm3(dR, self.R), t=mv3(dR, self.t) + dt, center=self.center)

    def euler_angles(self) -> torch.Tensor:
        """(alpha, beta, gamma) [..., 3] for R = Rx Ry Rz with the
        reference's gimbal-lock convention (cdcl_trans_rigid3d.cxx:88-105)."""
        R = self.R
        beta = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
        c = torch.cos(beta)
        safe = c.abs() > 1e-6
        cs = torch.where(safe, c, torch.ones_like(c))
        zero = torch.zeros_like(c)
        alpha = torch.where(safe, torch.atan2(-R[..., 1, 2] / cs, R[..., 2, 2] / cs), zero)
        gamma = torch.where(
            safe,
            torch.atan2(-R[..., 0, 1] / cs, R[..., 0, 0] / cs),
            torch.atan2(R[..., 1, 0], R[..., 1, 1]),
        )
        return torch.stack([alpha, beta, gamma], -1)

    @classmethod
    def from_euler(cls, angles: torch.Tensor, t: torch.Tensor, center: torch.Tensor) -> "Rigid3D":
        """R = Rx(alpha) Ry(beta) Rz(gamma), angles [..., 3]."""
        a, b, g = angles[..., 0], angles[..., 1], angles[..., 2]
        ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
        cg, sg = torch.cos(g), torch.sin(g)
        one, zero = torch.ones_like(a), torch.zeros_like(a)

        def mat(rows):
            return torch.stack([torch.stack(r, -1) for r in rows], -2).to(t.dtype)

        Rx = mat([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
        Ry = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
        Rz = mat([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
        return cls(R=mm3(mm3(Rx, Ry), Rz), t=t, center=center)


def rigid_increment_normal_equations(
    mapped_xyz: torch.Tensor,  # [M, 3] current mapped moving points
    to_xyz: torch.Tensor,  # [M, 3]
    projector: torch.Tensor,  # [M, 3, 3]
    weight: torch.Tensor,  # [M]
) -> tuple[torch.Tensor, torch.Tensor]:
    """6x6 normal equations for the increment (omega, dt) on mapped points.
    Residual e = y + omega x y + dt - q with Jacobian J = [-[y]x | I];
    returns (AtA [6, 6], Atb [6]) for sum_m w e^T P e."""
    eye = torch.eye(3, dtype=mapped_xyz.dtype, device=mapped_xyz.device)
    J = torch.cat([-skew(mapped_xyz), eye.expand(mapped_xyz.shape[:-1] + (3, 3))], dim=-1)
    PJ = (projector[..., :, :, None] * J[..., None, :, :]).sum(-2)  # [M, 3, 6]
    AtA = (weight[:, None, None, None] * J[:, :, :, None] * PJ[:, :, None, :]).sum((0, 1))
    r = to_xyz - mapped_xyz
    Atb = (weight[:, None, None] * PJ * r[:, :, None]).sum((0, 1))
    return AtA, Atb


def solve_rigid_increment(AtA: torch.Tensor, Atb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve for (omega, dt); returns both 3-vectors ([..., 3] each)."""
    x = (pinv_hermitian(AtA) * Atb[..., None, :]).sum(-1)
    return x[..., :3], x[..., 3:]

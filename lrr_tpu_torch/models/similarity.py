"""2-D similarity transform, 4 dof (lrr_tpu/models/similarity.py;
cdcl/cdcl_trans_similarity2d.{h,cxx}).

y = s R(phi) (x - c) + t, parameterised as (a, b, tx, ty) with
A = [[a, -b], [b, a]] so that estimation is linear.
"""

from __future__ import annotations

import dataclasses

import torch

from lrr_tpu_torch.types import resolve_device


@dataclasses.dataclass
class Similarity2D:
    a: torch.Tensor  # s cos(phi)
    b: torch.Tensor  # s sin(phi)
    t: torch.Tensor  # [2]
    center: torch.Tensor  # [2]

    @classmethod
    def identity(cls, center=None, dtype=torch.float32, device=None) -> "Similarity2D":
        """The identity about `center` (default 0) on `device` (default: the
        CUDA card, or the device of a `center` tensor)."""
        if device is None and isinstance(center, torch.Tensor):
            device = center.device
        device = resolve_device(device, "Similarity2D.identity")
        z = torch.zeros(2, dtype=dtype, device=device)
        c = z.clone() if center is None else torch.as_tensor(center, dtype=dtype).to(device)
        return cls(a=torch.ones((), dtype=dtype, device=device),
                   b=torch.zeros((), dtype=dtype, device=device), t=z, center=c)

    @property
    def A(self) -> torch.Tensor:
        return torch.stack([torch.stack([self.a, -self.b]), torch.stack([self.b, self.a])])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Map points [..., 2], as multiply-adds."""
        d = x - self.center
        return torch.stack(
            [self.a * d[..., 0] - self.b * d[..., 1], self.b * d[..., 0] + self.a * d[..., 1]],
            dim=-1,
        ) + self.t

    @property
    def scale(self) -> torch.Tensor:
        return torch.sqrt(self.a**2 + self.b**2)

    @property
    def angle(self) -> torch.Tensor:
        return torch.atan2(self.b, self.a)

    def inverse(self) -> "Similarity2D":
        s2 = self.a**2 + self.b**2
        ai, bi = self.a / s2, -self.b / s2
        t = -torch.stack([ai * self.t[0] - bi * self.t[1], bi * self.t[0] + ai * self.t[1]])
        return Similarity2D(a=ai, b=bi, t=t + self.center, center=torch.zeros_like(self.t))

    @property
    def theta(self) -> torch.Tensor:
        return torch.stack([self.a, self.b, self.t[0], self.t[1]])

    @classmethod
    def from_theta(cls, th: torch.Tensor, center: torch.Tensor) -> "Similarity2D":
        return cls(a=th[0], b=th[1], t=th[2:4], center=center)


def similarity2d_normal_equations(from_xy, to_xy, weight, center):
    """Weighted least squares for theta = (a, b, tx, ty), residual
    e = A (x - c) + t - q, J = [[dx, -dy, 1, 0], [dy, dx, 0, 1]]; returns
    (AtA [4, 4], Atb [4]) summed over the matches as multiply-adds."""
    d = from_xy - center
    dx, dy = d[:, 0], d[:, 1]
    one, zero = torch.ones_like(dx), torch.zeros_like(dx)
    J = torch.stack(
        [torch.stack([dx, -dy, one, zero], -1), torch.stack([dy, dx, zero, one], -1)], dim=-2
    )  # [M, 2, 4]
    wJ = weight[:, None, None] * J
    AtA = (wJ[:, :, :, None] * J[:, :, None, :]).sum((0, 1))
    Atb = (wJ * to_xy[:, :, None]).sum((0, 1))
    return AtA, Atb

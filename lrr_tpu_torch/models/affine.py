"""3D affine transform y = A (x - c) + t (lrr_tpu/models/affine.py).

Batched over leading dims: A [..., 3, 3], t [..., 3], center [..., 3].  The
estimation parameterisation is theta = vec_row([A | t]).  Every product that
maps coordinates is written out as multiply-adds, so no transform ever goes
through a matmul that could run in TF32.
"""

from __future__ import annotations

import dataclasses

import torch

from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.ops.eig3 import eigvalsh3
from lrr_tpu_torch.types import resolve_device


def mv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3] as multiply-adds."""
    return (A * v[..., None, :]).sum(-1)


def mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] @ [..., 3, 3] as multiply-adds."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate (batched over leading dims)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


@dataclasses.dataclass
class Affine3D:
    A: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]
    center: torch.Tensor  # [..., 3]

    def __getitem__(self, idx) -> "Affine3D":
        return Affine3D(self.A[idx], self.t[idx], self.center[idx])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Map points [..., P, 3] by a transform batched over [...]
        (cdcl_trans_affine.txx:112-117), unrolled."""
        xc = x - self.center[..., None, :]
        A = self.A[..., None, :, :]
        return torch.stack(
            [
                A[..., 0, 0] * xc[..., 0] + A[..., 0, 1] * xc[..., 1] + A[..., 0, 2] * xc[..., 2],
                A[..., 1, 0] * xc[..., 0] + A[..., 1, 1] * xc[..., 1] + A[..., 1, 2] * xc[..., 2],
                A[..., 2, 0] * xc[..., 0] + A[..., 2, 1] * xc[..., 1] + A[..., 2, 2] * xc[..., 2],
            ],
            dim=-1,
        ) + self.t[..., None, :]

    @classmethod
    def identity(cls, center=None, dtype=torch.float32, device=None) -> "Affine3D":
        """The identity about `center` (default 0), on `device` (default: the
        CUDA card, or the device of a `center` tensor)."""
        if device is None and isinstance(center, torch.Tensor):
            device = center.device
        device = resolve_device(device, "Affine3D.identity")
        z = torch.zeros(3, dtype=dtype, device=device)
        c = z.clone() if center is None else torch.as_tensor(center, dtype=dtype).to(device)
        return cls(A=torch.eye(3, dtype=dtype, device=device), t=z, center=c)

    @property
    def theta(self) -> torch.Tensor:
        """vec_row([A | t]), the estimation parameter vector [..., 12]."""
        return torch.cat([self.A, self.t[..., None]], dim=-1).flatten(-2)

    def homogeneous(self, x: torch.Tensor) -> torch.Tensor:
        """h = [x - center; 1] for points [..., 3] -> [..., 4]."""
        return torch.cat([x - self.center, torch.ones_like(x[..., :1])], dim=-1)

    def params_reference_order(self) -> torch.Tensor:
        """[A row-major (9), t (3)] (cdcl_trans_affine.txx:68-84)."""
        return torch.cat([self.A.reshape(self.A.shape[:-2] + (9,)), self.t], dim=-1)

    @classmethod
    def from_params_reference_order(cls, p: torch.Tensor, center: torch.Tensor) -> "Affine3D":
        return cls(A=p[..., :9].reshape(p.shape[:-1] + (3, 3)), t=p[..., 9:12], center=center)

    @classmethod
    def from_theta(cls, theta: torch.Tensor, center: torch.Tensor) -> "Affine3D":
        th = theta.reshape(theta.shape[:-1] + (3, 4))
        return cls(A=th[..., :3], t=th[..., 3], center=center)

    def inverse(self) -> "Affine3D":
        """x = A^{-1}(y - t) + c, with zero center."""
        Ainv = inv3(self.A)
        return Affine3D(
            A=Ainv, t=-mv3(Ainv, self.t) + self.center,
            center=torch.zeros_like(self.t),
        )

    def compose(self, inner: "Affine3D") -> "Affine3D":
        """self after inner: z = self(inner(x)), with inner's center."""
        return Affine3D(
            A=mm3(self.A, inner.A), t=mv3(self.A, inner.t - self.center) + self.t,
            center=inner.center,
        )

    def with_center(self, new_center: torch.Tensor) -> "Affine3D":
        """The same map about another center."""
        return Affine3D(A=self.A, t=self.t + mv3(self.A, new_center - self.center),
                        center=new_center)

    def normalize(self, avg_rad_moving, avg_rad_fixed, center_moving, center_fixed):
        """To unit-radius coordinates (cdcl_trans_affine.txx:217-255); radii
        [...], centers [..., 3]; returns a zero-centered transform."""
        A = (avg_rad_moving / avg_rad_fixed)[..., None, None] * self.A
        t = (
            self.t / avg_rad_fixed[..., None]
            + mv3(A, center_moving - self.center) / avg_rad_moving[..., None]
            - center_fixed / avg_rad_fixed[..., None]
        )
        return Affine3D(A=A, t=t, center=torch.zeros_like(t))

    def unnormalize(self, avg_rad_moving, avg_rad_fixed, center_moving, center_fixed):
        """Inverse of `normalize`, returning a zero-centered transform."""
        A = (avg_rad_fixed / avg_rad_moving)[..., None, None] * self.A
        t = avg_rad_fixed[..., None] * self.t + center_fixed - mv3(A, center_moving)
        return Affine3D(A=A, t=t, center=torch.zeros_like(t))

    def is_valid(self, lo: float = 0.1, hi: float = 10.0) -> torch.Tensor:
        """Singular values within [lo, hi] (itkLocationRegistration.cxx:
        2914-2926), from the closed-form eigenvalues of A^T A."""
        w = eigvalsh3(mm3(self.A.transpose(-1, -2), self.A))
        w = torch.clamp(w, min=0.0)
        return (w[..., 0] > lo * lo) & (w[..., 2] < hi * hi)


def _covar_transform_matrix(s_A, s_t, c):
    """L [..., 12, 12] with dtheta_out = L dtheta_in for A_out = s_A A_in,
    t_out = s_t t_in + const - A_out c (theta ordering)."""
    batch = s_A.shape
    L = torch.zeros(batch + (12, 12), dtype=s_A.dtype, device=s_A.device)
    for i in range(3):
        for j in range(3):
            L[..., 4 * i + j, 4 * i + j] = s_A
        L[..., 4 * i + 3, 4 * i + 3] = s_t
        for j in range(3):
            L[..., 4 * i + 3, 4 * i + j] = -s_A * c[..., j]
    return L


def jacobian_wrt_par(trans: Affine3D, x: torch.Tensor) -> torch.Tensor:
    """J [..., 3, 12] of y = Theta h with respect to theta: J[d, 4d:4d+4] = h
    = [x - c, 1] (rrl_estimation_symmetric_ICP_matching_all.txx:475-536)."""
    h = trans.homogeneous(x)
    J = h.new_zeros(x.shape[:-1] + (3, 3, 4))
    for d in range(3):
        J[..., d, d, :] = h
    return J.flatten(-2)


def transfer_covariance(trans: Affine3D, covar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """J C J^T [..., 3, 3] for a theta-order covariance C [12, 12], by its
    block structure (h^T C_ik h per entry), as multiply-adds."""
    h = trans.homogeneous(x)
    Cb = covar.reshape(3, 4, 3, 4)
    u = (h[..., None, :, None, None] * Cb).sum(-3)  # [..., i, k, l]
    return (u * h[..., None, None, :]).sum(-1)


def covariance_normalize(cov_w, arm, arf, cm, cf):
    """Parameter covariance world -> normalised coordinates for a zero-center
    world transform (cdcl_trans_affine.txx:217-255): A_n = (arm/arf) A_w,
    t_n = (t_w + A_w cm - cf) / arf."""
    s = arm / arf
    L = torch.zeros((12, 12), dtype=cov_w.dtype, device=cov_w.device)
    for i in range(3):
        for j in range(3):
            L[4 * i + j, 4 * i + j] = s
        L[4 * i + 3, 4 * i + 3] = 1.0 / arf
        for j in range(3):
            L[4 * i + 3, 4 * i + j] = s * cm[j] / arm
    return mm3(mm3(L, cov_w), L.T)


def covariance_unnormalize(cov_n, arm, arf, cm, cf):
    """Parameter covariance normalized -> world: A_w = (arf/arm) A_n,
    t_w = arf t_n + cf - A_w cm.  cov_n [..., 12, 12], radii [...]."""
    L = _covar_transform_matrix(arf / arm, arf, cm)
    return L @ cov_n @ L.transpose(-1, -2)


def normal_equations_terms(trans: Affine3D, from_xyz, to_xyz, projector, weight):
    """Weighted normal equations for theta = vec_row([A | t]): minimises
    sum_m w_m (Theta h_m - q_m)^T P_m (Theta h_m - q_m), h = [x - c; 1].
    Returns (AtA [12, 12], Atb [12]), summed over the matches as
    multiply-adds (no matmul, so no TF32)."""
    h = trans.homogeneous(from_xyz)  # [M, 4]
    wP = weight[:, None, None] * projector  # [M, i, k]
    hh = h[:, :, None] * h[:, None, :]  # [M, j, l]
    AtA = (wP[:, :, None, :, None] * hh[:, None, :, None, :]).sum(0).reshape(12, 12)
    Pq = (projector * to_xyz[:, None, :]).sum(-1)  # [M, i]
    Atb = ((weight[:, None] * Pq)[:, :, None] * h[:, None, :]).sum(0).reshape(12)
    return AtA, Atb


def pinv_hermitian(a: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.pinv(a, hermitian=True)` of [..., n, n] float32, n <= 12:
    kernel K3 on the card (no host round trip, so a CUDA graph can capture
    it), its plain version `kernels.pinv_hermitian_plain` on the CPU."""
    return kernels.pinv_hermitian_small(a)


def solve_normal_equations(AtA, Atb, center, ridge: float = 0.0):
    """Solve AtA theta = Atb by the SVD pseudo-inverse; returns
    (transform, covariance = (AtA)^-1) (symmetric .txx:880-897)."""
    eye = torch.eye(12, dtype=AtA.dtype, device=AtA.device)
    cov = pinv_hermitian(AtA + ridge * eye)
    theta = (cov * Atb[..., None, :]).sum(-1)
    return Affine3D.from_theta(theta, center), cov

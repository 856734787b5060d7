"""Robust weights and scale estimators (lrr_tpu/ops/robust.py).

All functions are batched over leading dims and mask-aware: statistics run
along the last dim, and padded entries never contaminate them.
"""

from __future__ import annotations

import functools
import math

import torch

# Beaton-Tukey constant b = 4 and the f-multiplier for k = 3.0
# (cdcl/cdcl_utils.h:160-166).
BT_B2 = 16.0
BT_F = 2.9872


def weight_bt(r2: torch.Tensor) -> torch.Tensor:
    """Beaton-Tukey weight of a squared residual (cdcl_utils.h:142-152):
    (1 - r2/16)^2 for r2 <= 16 else 0."""
    w = torch.square(1.0 - r2 / BT_B2)
    return torch.where(r2 <= BT_B2, w, torch.zeros_like(w))


def rho_bt(r2: torch.Tensor) -> torch.Tensor:
    """Modified Beaton-Tukey rho of a squared residual (cdcl_utils.h:158-178).
    `torch.maximum` (not `clamp`) so that the gradient at r2 = 16 splits as
    JAX's does."""
    c = BT_B2 / 6.0
    inner = 1.0 - torch.pow(torch.maximum(1.0 - r2 / BT_B2, torch.zeros_like(r2)), 3.0)
    return torch.where(r2 > BT_B2, torch.full_like(r2, BT_F * c), BT_F * c * inner)


def rho_p_bt(r2: torch.Tensor) -> torch.Tensor:
    """d rho / d r2 (cdcl_utils.h:183-204)."""
    temp = 1.0 - r2 / BT_B2
    return torch.where(r2 > BT_B2, torch.zeros_like(r2), BT_F * 0.5 * temp * temp)


def weight_bt_scaled(r2: torch.Tensor) -> torch.Tensor:
    """The f-scaled BT weight of the EM-CDC objective (cdcl_utils.h:209-228)."""
    return BT_F * weight_bt(r2)


def weight_cauchy(r2: torch.Tensor) -> torch.Tensor:
    """Cauchy weight, b^2 = 9 (cdcl_utils.h:232-237)."""
    return 1.0 / (1.0 + r2 / 9.0)


def gauss_weight(d: torch.Tensor, sigma, dim: int = 3) -> torch.Tensor:
    """Isotropic Gaussian weight of offset vectors [..., dim]
    (cdcl_utils.h:240-245, with its sqrt(sigma) normaliser quirk)."""
    sigma = torch.as_tensor(sigma, dtype=d.dtype, device=d.device)
    k = (2.0 * math.pi) ** (dim / 2.0) * torch.sqrt(sigma)
    return torch.exp(-0.5 * torch.sum(d * d, -1) / (sigma * sigma)) / k


def spatial_weight(d2: torch.Tensor, falloff: float = 5.0) -> torch.Tensor:
    """Cauchy-like falloff on the squared normalised distance to the query
    (cdcl_estimation_ICP_matching_all.txx:972-1004)."""
    return 1.0 / (1.0 + falloff * d2)


def _masked_sort(values: torch.Tensor, mask: torch.Tensor):
    """Sort ascending along the last dim with invalid entries pushed to the
    tail (float max), and count the valid ones."""
    big = torch.finfo(values.dtype).max
    v = torch.where(mask, values, torch.full_like(values, big))
    return torch.sort(v, dim=-1).values, mask.sum(-1)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The lower median of the valid entries along the last dim (element
    n // 2 of the sorted valid ones, as nth_element gives it).  Not
    `nanmedian`, which averages the middle pair."""
    v, n = _masked_sort(values, mask)
    idx = torch.clamp(n // 2, 0, v.shape[-1] - 1)
    return v.gather(-1, idx[..., None])[..., 0]


def mad_scale(abs_residuals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median absolute deviation about zero with the half-normal consistency
    constant 1.4826 (rrel_util_median_abs_dev_scale)."""
    return 1.4826 * masked_median(abs_residuals, mask)


def weighted_scale(r2: torch.Tensor, weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sqrt(sum w r^2 / sum w) over the last dim, the scale after the first
    iteration (cdcl_estimation_ICP_matching_all.txx:731-733)."""
    w = torch.where(mask, weight, torch.zeros_like(weight))
    return torch.sqrt(torch.sum(w * r2, -1) / torch.clamp(torch.sum(w, -1), min=1e-30))


def _half_normal_quantile(p: torch.Tensor) -> torch.Tensor:
    """Quantile of |N(0,1)|: sqrt(2) erfinv(p)."""
    return math.sqrt(2.0) * torch.special.erfinv(torch.clamp(p, 0.0, 0.999999))


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32, bit for bit as the JAX
    reference computes it on the CPU: start*(1 - i*r) + i*(stop*r) with the
    reciprocal r = 1/div folded and the last product fused (XLA's
    rewrite), then the exact endpoint.  MUSE truncates these fractions
    times n to integers, so an ulp here can move an order statistic.

    Every tensor is made on `device` (IEEE float32 / float64 operations
    there give the CPU's bits), so no host value is copied inside a CUDA
    graph; the result is built once per (start, stop, num, device) and
    shared, so it must not be written to."""
    return _linspace_f32(float(start), float(stop), int(num), torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _linspace_f32(start: float, stop: float, num: int, device: torch.device) -> torch.Tensor:
    f32, f64 = torch.float32, torch.float64
    s = torch.full((1,), start, dtype=f32, device=device)
    if num == 1:
        return s
    e = torch.full((1,), stop, dtype=f32, device=device)
    div = num - 1
    it = torch.arange(div, dtype=f32, device=device)
    r = torch.full((), 1.0, dtype=f32, device=device) / torch.full(
        (), float(div), dtype=f32, device=device)
    er = (e * r).to(f64)
    head = (s * (1.0 - it * r)).to(f64)
    out = (it.to(f64) * er + head).to(f32)
    return torch.cat([out, e])


def muse_scale(
    abs_residuals: torch.Tensor,
    mask: torch.Tensor,
    min_frac: float = 0.1,
    max_frac: float = 0.9,
    num_k: int = 41,
) -> torch.Tensor:
    """Minimum Unbiased Scale Estimator over order statistics (see the JAX
    package's docstring for the derivation): min over inlier fractions k/n
    of sqrt(sum_{i<=k} r_(i)^2 / sum_{i<=k} E[u_(i:n)^2]).  [..., M] -> [...]."""
    r_sorted, n = _masked_sort(abs_residuals, mask)
    n = torch.clamp(n, min=2)
    cap = abs_residuals.shape[-1]
    dt = r_sorted.dtype

    idx = torch.arange(1, cap + 1, dtype=dt, device=r_sorted.device)
    nf = n.to(dt)[..., None]
    p = idx / (nf + 1.0)
    q = _half_normal_quantile(p)
    pdf = math.sqrt(2.0 / math.pi) * torch.exp(-0.5 * q * q)
    eu2 = q * q + (
        p * (1.0 - p) / (nf + 2.0) * (1.0 + q * q)
        / torch.clamp(pdf * pdf, min=1e-12)
    )
    valid_row = idx <= nf
    zero = torch.zeros((), dtype=dt, device=r_sorted.device)
    r2c = torch.cumsum(torch.where(valid_row, r_sorted * r_sorted, zero), dim=-1)
    eu2c = torch.cumsum(torch.where(valid_row, eu2, zero), dim=-1)

    fracs = linspace_f32(min_frac, max_frac, num_k, device=r_sorted.device)
    ks = torch.clamp(
        (fracs * n.to(dt)[..., None]).to(torch.int32) - 1, 1, cap - 1
    ).long()
    s2 = r2c.gather(-1, ks) / torch.clamp(eu2c.gather(-1, ks), min=1e-30)
    return torch.sqrt(s2.min(dim=-1).values)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` along the last dim: the mean of the two middle values
    for an even count (torch.nanmedian returns the lower one)."""
    nan = torch.isnan(x)
    v = torch.sort(torch.where(nan, torch.full_like(x, math.inf), x), dim=-1).values
    n = (~nan).sum(-1)
    q = 0.5 * (n - 1).to(x.dtype)
    lo = torch.floor(q)
    hi_w = q - lo
    last = x.shape[-1] - 1
    lo_i = torch.clamp(lo.long(), 0, last)
    hi_i = torch.clamp(torch.ceil(q).long(), 0, last)
    lo_v = v.gather(-1, lo_i[..., None])[..., 0]
    hi_v = v.gather(-1, hi_i[..., None])[..., 0]
    out = lo_v * (1.0 - hi_w) + hi_v * hi_w
    return torch.where(n > 0, out, torch.full_like(out, math.nan))

"""Intensity-based multi-resolution affine registration
(lrr_tpu/pipeline/intensity.py; the reference's ground-truth generators
NoduleRegistration2 / MultiResImageRegistration2, rrl/examples/*.cxx).

Mattes-style mutual information from a soft-binned joint histogram (linear
Parzen windows, one matrix product, TF32 off) or NCC, maximised by Adam over
a pyramid, coarse first.  The sample points of every step come from an
explicit plan (`draw_intensity_points`), as serving's draws come from a
`SamplingPlan`: drawn on the CPU from a seeded generator and moved to the
volumes' device, so one seed gives one plan on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lrr_tpu_torch.estimation.lbfgs import value_and_grad
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import filters
from lrr_tpu_torch.ops.resample import sample_trilinear
from lrr_tpu_torch.types import Volume, no_tf32


def percentile(v: torch.Tensor, p: float) -> torch.Tensor:
    """`jnp.percentile(v, p)` (linear interpolation, numpy's default) of all
    entries, with its float32 index arithmetic.  A sort, not
    `torch.quantile`, which refuses inputs over 2^24 elements."""
    a = torch.sort(v.reshape(-1)).values
    f32 = dict(dtype=torch.float32, device=v.device)
    n = torch.tensor(float(a.shape[0]), **f32)
    q = torch.tensor(p, **f32) / 100.0 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo_i = torch.clamp(low, 0.0, n - 1.0).long()
    hi_i = torch.clamp(high, 0.0, n - 1.0).long()
    return a[lo_i] * lw + a[hi_i] * hw


def _normalize_intensity(v: torch.Tensor) -> torch.Tensor:
    lo = percentile(v, 1.0)
    hi = percentile(v, 99.0)
    return torch.clamp((v - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def _sample_pair(fixed: Volume, moving: Volume, trans: Affine3D, pts_idx: torch.Tensor):
    """Fixed sampled at grid points, moving at their mapped positions."""
    fvals, _ = sample_trilinear(fixed.data, pts_idx)
    mapped = trans.apply(fixed.origin + pts_idx * fixed.spacing)
    mvals, inside = sample_trilinear(moving.data, (mapped - moving.origin) / moving.spacing)
    return fvals, mvals, inside


def mutual_information(fvals, mvals, mask, bins: int = 32) -> torch.Tensor:
    """Differentiable Parzen-window MI of two [N] samples in [0, 1]."""
    centers = (torch.arange(bins, device=fvals.device) + 0.5) / bins

    def soft_hist_weights(v):
        d = (v[:, None] - centers[None, :]) * bins
        w = 1.0 - torch.abs(d)
        return torch.maximum(torch.zeros_like(w), w)  # JAX's gradient at 0

    wf = soft_hist_weights(fvals) * mask[:, None]
    wm = soft_hist_weights(mvals) * mask[:, None]
    joint = wf.T @ wm  # [bins, bins]
    pj = joint / torch.clamp(torch.sum(joint), min=1e-6)
    pf = torch.sum(pj, dim=1)
    pm = torch.sum(pj, dim=0)
    eps = 1e-10
    h_f = -torch.sum(pf * torch.log(pf + eps))
    h_m = -torch.sum(pm * torch.log(pm + eps))
    h_j = -torch.sum(pj * torch.log(pj + eps))
    return h_f + h_m - h_j


def ncc(fvals, mvals, mask) -> torch.Tensor:
    m = mask.to(fvals.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    fc = (fvals - torch.sum(fvals * m) / n) * m
    mc = (mvals - torch.sum(mvals * m) / n) * m
    return torch.sum(fc * mc) / (torch.sqrt(torch.sum(fc * fc) * torch.sum(mc * mc)) + 1e-8)


class IntensityResult(NamedTuple):
    trans: Affine3D  # moving -> fixed physical map (the GT convention)
    resample_trans: Affine3D  # fixed -> moving, the optimised sampling map
    metric_value: torch.Tensor
    levels_run: int


def _pyramid(fixed: Volume, moving: Volume, levels: int) -> list[tuple[Volume, Volume]]:
    pyr = [(fixed, moving)]
    for _ in range(levels - 1):
        f, m = pyr[0]
        pyr.insert(0, (Volume(filters.downsample2(f.data), f.origin, f.spacing * 2),
                       Volume(filters.downsample2(m.data), m.origin, m.spacing * 2)))
    return pyr


def draw_intensity_points(seed: int, shapes_zyx, iterations: int, samples: int,
                          device) -> list[torch.Tensor]:
    """The sample points of every step, one [iterations, samples, 3] tensor of
    continuous (x, y, z) indices a level, uniform over each level's volume
    of shape `shapes_zyx[level]`: drawn on the CPU from a generator seeded
    with `seed`, then moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for D, H, W in shapes_zyx:
        hi = torch.tensor([W - 1, H - 1, D - 1], dtype=torch.float32)
        out.append((torch.rand((iterations, samples, 3), generator=g) * hi).to(device))
    return out


def register_intensity(
    fixed: Volume,
    moving: Volume,
    init: Affine3D | None = None,
    levels: int = 3,
    iterations_per_level: int = 80,
    samples: int = 16384,
    metric: str = "mi",
    learning_rate: float = 0.02,
    seed: int = 0,
    points: list[torch.Tensor] | None = None,
) -> IntensityResult:
    """Multi-resolution affine registration maximising MI (or NCC), on the
    volumes' device.  Adam (optax's update, written out) starts afresh at
    each level with the learning rate halved a level.  `points` is the
    per-level plan of sample points (`draw_intensity_points`, from `seed`
    when None)."""
    no_tf32()
    dev = fixed.data.device
    fixed = Volume(_normalize_intensity(fixed.data), fixed.origin, fixed.spacing)
    moving = Volume(_normalize_intensity(moving.data), moving.origin, moving.spacing)
    pyr = _pyramid(fixed, moving, levels)
    if points is None:
        points = draw_intensity_points(
            seed, [f.data.shape for f, _ in pyr], iterations_per_level, samples, dev)

    trans = init if init is not None else Affine3D.identity(device=dev)
    # theta is optimised about the volume center, for conditioning
    D, H, W = fixed.data.shape
    center = fixed.origin + torch.tensor(
        [W - 1, H - 1, D - 1], dtype=torch.float32, device=dev) * fixed.spacing / 2.0
    trans = trans.with_center(center)
    value = torch.zeros((), device=dev)
    b1, b2, eps = 0.9, 0.999, 1e-8

    for lvl, (f, m) in enumerate(pyr):
        lr = learning_rate * (0.5**lvl)

        def loss_fn(theta, pts):
            fv, mv, inside = _sample_pair(f, m, Affine3D.from_theta(theta, center), pts)
            if metric == "mi":
                return -mutual_information(fv, mv, inside)
            return -ncc(fv, mv, inside)

        theta = trans.theta
        mu = torch.zeros_like(theta)
        nu = torch.zeros_like(theta)
        for it in range(iterations_per_level):
            value, g = value_and_grad(lambda th: loss_fn(th, points[lvl][it]), theta)
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            count = torch.tensor(float(it + 1), device=dev)
            mu_hat = mu / (1 - torch.pow(torch.tensor(b1, device=dev), count))
            nu_hat = nu / (1 - torch.pow(torch.tensor(b2, device=dev), count))
            theta = theta + (mu_hat / (torch.sqrt(nu_hat) + eps)) * (-lr)
        trans = Affine3D.from_theta(theta, center)

    return IntensityResult(trans=trans.inverse(), resample_trans=trans, metric_value=-value,
                           levels_run=len(pyr))

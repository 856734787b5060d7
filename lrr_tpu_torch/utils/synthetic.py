"""Synthetic CT-like phantoms with known geometry and ground-truth motion
(lrr_tpu/utils/synthetic.py).

The reference ships no image data, so tests and smoke runs use phantoms
built to exercise each feature class: spherical shells (sheets), cylinders
(tubes) and small blobs (corners), with a known transform as ground truth.
Every random draw is numpy's `default_rng(seed)`, in the JAX package's
order, so a seed names the same phantom in both packages.  `device=None`
means the CUDA card (`types.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import filters
from lrr_tpu_torch.ops.resample import warp_volume
from lrr_tpu_torch.types import Volume, resolve_device


def _grid(shape_zyx, origin, spacing):
    D, H, W = shape_zyx
    z, y, x = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing="ij")
    return origin[0] + x * spacing[0], origin[1] + y * spacing[1], origin[2] + z * spacing[2]


def _volume(data: torch.Tensor, origin, spacing) -> Volume:
    dev = data.device
    return Volume(
        data=data,
        origin=torch.tensor(origin, dtype=torch.float32, device=dev),
        spacing=torch.tensor(spacing, dtype=torch.float32, device=dev),
    )


def make_phantom(
    shape_zyx=(64, 64, 64),
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    num_blobs: int = 20,
    seed: int = 0,
    noise: float = 0.0,
    device=None,
) -> Volume:
    """Piecewise-smooth phantom: one spherical shell, two cylinders, blobs.
    Computed with numpy on the host (as the JAX package does), then moved to
    `device`."""
    device = resolve_device(device, "make_phantom")
    rng = np.random.default_rng(seed)
    px, py, pz = _grid(shape_zyx, origin, spacing)
    D, H, W = shape_zyx
    cx = origin[0] + (W - 1) * spacing[0] / 2
    cy = origin[1] + (H - 1) * spacing[1] / 2
    cz = origin[2] + (D - 1) * spacing[2] / 2
    extent = min((W - 1) * spacing[0], (H - 1) * spacing[1], (D - 1) * spacing[2])

    vol = np.zeros(shape_zyx, np.float32)

    # sphere (sheet source): filled ball, its boundary is a sheet
    r_sph = 0.35 * extent
    d_sph = np.sqrt((px - cx) ** 2 + (py - cy) ** 2 + (pz - cz) ** 2)
    vol += 100.0 / (1.0 + np.exp((d_sph - r_sph) / 0.8))

    # two cylinders (tube sources) along x and y
    for axis in (0, 1):
        if axis == 0:
            dd = np.sqrt((py - cy * 0.6) ** 2 + (pz - cz * 1.3) ** 2)
        else:
            dd = np.sqrt((px - cx * 1.4) ** 2 + (pz - cz * 0.7) ** 2)
        vol += 120.0 * np.exp(-0.5 * (dd / 2.0) ** 2)

    # blobs (corner sources)
    lo = 0.15 * extent
    hi = 0.85 * extent
    for _ in range(num_blobs):
        bx = origin[0] + rng.uniform(lo, hi)
        by = origin[1] + rng.uniform(lo, hi)
        bz = origin[2] + rng.uniform(lo, hi)
        db2 = (px - bx) ** 2 + (py - by) ** 2 + (pz - bz) ** 2
        vol += 150.0 * np.exp(-0.5 * db2 / (1.5**2))

    if noise > 0:
        vol += noise * rng.standard_normal(shape_zyx).astype(np.float32)

    return _volume(torch.from_numpy(vol).to(device), origin, spacing)


def make_dense_phantom(
    shape_zyx=(400, 350, 350),
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    blobs_per_mm3: float = 1.0 / 2000.0,
    seed: int = 0,
    noise: float = 0.0,
    device=None,
) -> Volume:
    """Reference-scale phantom with lung-CT-like feature density, O(voxels)
    work, assembled on `device`:

      sheets   iso-surfaces of a smooth low-frequency random field
               (trilinearly upsampled coarse Gaussian noise);
      tubes    the intersection curves of two more such fields' zero sets;
      corners  ~voxels * blobs_per_mm3 random impulses smoothed by a
               separable Gaussian.

    Structures are confined to a central ellipsoid (~30 % of the field of
    view), as a chest CT concentrates features in the lung fields: the
    descriptor neighbourhoods (>= 100 features within 30 mm) only make sense
    at that local density."""
    device = resolve_device(device, "make_dense_phantom")
    rng = np.random.default_rng(seed)
    D, H, W = shape_zyx

    def coarse_noise(key_seed, cell):
        shape = (D // cell + 2, H // cell + 2, W // cell + 2)
        return np.random.default_rng(key_seed).standard_normal(shape).astype(np.float32)

    cell_a, cell_bc = 18, 24
    A = coarse_noise(seed * 3 + 1, cell_a)
    B = coarse_noise(seed * 3 + 2, cell_bc)
    C = coarse_noise(seed * 3 + 3, cell_bc)

    semi = 0.42 * np.asarray([D, H, W], np.float64)
    ctr = 0.5 * np.asarray([D - 1, H - 1, W - 1], np.float64)

    n_try = int(D * H * W * float(np.prod(spacing)) * blobs_per_mm3 / 0.31)
    cand = np.stack(
        [rng.integers(2, D - 2, n_try), rng.integers(2, H - 2, n_try),
         rng.integers(2, W - 2, n_try)],
        axis=0,
    ).astype(np.int32)
    inside = (
        ((cand[0] - ctr[0]) / semi[0]) ** 2
        + ((cand[1] - ctr[1]) / semi[1]) ** 2
        + ((cand[2] - ctr[2]) / semi[2]) ** 2
    ) <= 1.0
    blob_idx = cand[:, inside]
    amp = rng.uniform(80.0, 220.0, blob_idx.shape[1]).astype(np.float32)
    noise_vol = rng.standard_normal(shape_zyx).astype(np.float32) if noise > 0 else None

    # two impulses can hit one voxel: they are added on the host, in index
    # order, so the volume is the same on every run
    impulses = np.zeros(shape_zyx, np.float32)
    np.add.at(impulses, (blob_idx[0], blob_idx[1], blob_idx[2]), amp)

    def dev_t(x):
        return torch.from_numpy(x).to(device)

    data = _assemble_dense(
        dev_t(A), dev_t(B), dev_t(C), dev_t(impulses),
        None if noise_vol is None else dev_t(noise_vol),
        shape=tuple(shape_zyx), cell_a=cell_a, cell_bc=cell_bc,
        sigma_blob=1.5 / float(min(spacing)), noise=float(noise),
    )
    return _volume(data, origin, spacing)


def _assemble_dense(A, B, C, impulses, noise_vol, *, shape, cell_a, cell_bc, sigma_blob, noise):
    """The dense phantom from its coarse fields and impulse volume."""
    D, H, W = shape
    dev = A.device

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    def upsample(coarse, cell):
        z, y, x = ar(D) / cell, ar(H) / cell, ar(W) / cell
        z0, y0, x0 = torch.floor(z).long(), torch.floor(y).long(), torch.floor(x).long()
        fz = (z - z0)[:, None, None]
        fy = (y - y0)[None, :, None]
        fx = (x - x0)[None, None, :]

        def g(dz, dy, dx):
            return coarse[z0 + dz][:, y0 + dy][:, :, x0 + dx]

        c00 = g(0, 0, 0) * (1 - fx) + g(0, 0, 1) * fx
        c01 = g(0, 1, 0) * (1 - fx) + g(0, 1, 1) * fx
        c10 = g(1, 0, 0) * (1 - fx) + g(1, 0, 1) * fx
        c11 = g(1, 1, 0) * (1 - fx) + g(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c01 * fy
        c1 = c10 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz

    fa = upsample(A, cell_a)
    fb = upsample(B, cell_bc)
    fc = upsample(C, cell_bc)
    vol = 100.0 / (1.0 + torch.exp(-fa / 0.06))  # sheets at A = 0
    vol = vol + 140.0 * torch.exp(-(fb * fb + fc * fc) / (2 * 0.05**2))  # tubes

    # smooth ellipsoid envelope (lung-field analogue) confining structure
    semi = [0.42 * n for n in (D, H, W)]
    ctr = [0.5 * (n - 1) for n in (D, H, W)]
    ez = ((ar(D) - ctr[0]) / semi[0]) ** 2
    ey = ((ar(H) - ctr[1]) / semi[1]) ** 2
    ex = ((ar(W) - ctr[2]) / semi[2]) ** 2
    r2 = ez[:, None, None] + ey[None, :, None] + ex[None, None, :]
    vol = vol / (1.0 + torch.exp((r2 - 1.0) / 0.02))

    blob = filters.gaussian_smooth(impulses, (sigma_blob,) * 3)
    vol = vol + blob * (2 * np.pi * sigma_blob**2) ** 1.5  # unit peak * amp
    if noise_vol is not None:
        vol = vol + noise * noise_vol
    return vol


def make_pair(
    shape_zyx=(64, 64, 64),
    rotation_deg=4.0,
    translation=(2.0, -1.5, 1.0),
    scale=1.0,
    seed: int = 0,
    noise: float = 0.0,
    dense: bool = False,
    device=None,
):
    """(fixed Volume, moving Volume, true Affine3D mapping moving -> fixed
    physical points).  The moving volume is the fixed phantom resampled
    through the true transform, moving(x) = fixed(true(x)), so a feature at
    moving-space x corresponds to fixed-space true(x)."""
    device = resolve_device(device, "make_pair")
    make = make_dense_phantom if dense else make_phantom
    fixed = make(shape_zyx, seed=seed, noise=noise, device=device)

    th = np.deg2rad(rotation_deg)
    Rz = np.array(
        [[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]]
    )
    origin = fixed.origin.cpu().numpy()
    spacing = fixed.spacing.cpu().numpy()
    center = np.asarray(
        [float(origin[i]) + (shape_zyx[2 - i] - 1) * float(spacing[i]) / 2 for i in range(3)]
    )
    true = Affine3D(
        A=torch.tensor(scale * Rz, dtype=torch.float32, device=device),
        t=torch.tensor(center + np.asarray(translation), dtype=torch.float32, device=device),
        center=torch.tensor(center, dtype=torch.float32, device=device),
    )
    moving_data = warp_volume(
        fixed.data, tuple(shape_zyx), fixed.origin, fixed.spacing, true.apply,
        fixed.origin, fixed.spacing,
    )
    return fixed, Volume(data=moving_data, origin=fixed.origin, spacing=fixed.spacing), true

"""The benchmark's own phantoms: volumes with a known true transform, made
on the device from a seed.

A frozen copy of `lrr_tpu_torch/utils/synthetic.py::make_dense_phantom`
(sheets at the zero set of a smooth random field, tubes where two more such
fields vanish together, smoothed impulses as corners, all inside a central
ellipsoid), with two changes that a benchmark needs:

  - every draw comes from a `torch.Generator` on the volume's device, in a
    few large calls, so set-up does not wait on the host;
  - lengths are physical: the coarse fields' cells and the blobs' width are
    in mm, so a volume at anisotropic spacing (DIR-Lab's 0.625 x 0.625 x
    2.5 mm) holds structure of the same physical size and density as one at
    1 mm.

Impulse amplitudes are whole numbers, so two impulses on one voxel add to
the same float in any order and a seed gives the same bits on every run.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CELL_SHEETS_MM = 18.0
CELL_TUBES_MM = 24.0
BLOB_SIGMA_MM = 1.5


def _upsample(coarse: torch.Tensor, shape, spacing_zyx, cell_mm: float) -> torch.Tensor:
    """Trilinear upsampling of a coarse [d, h, w] field with cells of
    `cell_mm` onto the voxel grid."""
    dev = coarse.device
    axes = []
    for n, s in zip(shape, spacing_zyx):
        u = torch.arange(n, dtype=torch.float32, device=dev) * (s / cell_mm)
        i0 = torch.floor(u).long()
        axes.append((i0, u - i0))
    (z0, fz), (y0, fy), (x0, fx) = axes
    fz, fy, fx = fz[:, None, None], fy[None, :, None], fx[None, None, :]

    def g(dz, dy, dx):
        return coarse[z0 + dz][:, y0 + dy][:, :, x0 + dx]

    c00 = g(0, 0, 0) * (1 - fx) + g(0, 0, 1) * fx
    c01 = g(0, 1, 0) * (1 - fx) + g(0, 1, 1) * fx
    c10 = g(1, 0, 0) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(1, 1, 0) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _gaussian_1d(sigma: float, device) -> torch.Tensor:
    r = max(1, int(math.ceil(4.0 * sigma)))
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).to(torch.float32).to(device)


def _smooth(vol: torch.Tensor, sigmas_zyx) -> torch.Tensor:
    """Separable Gaussian, zero outside the volume, one axis at a time, as
    shift-and-add in tap order: a library convolution may pick its
    algorithm (and TF32) per run, and the inputs must not change bits."""
    out = vol
    for axis, s in enumerate(sigmas_zyx):
        k = _gaussian_1d(s, vol.device).tolist()
        r = (len(k) - 1) // 2
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r
        padded = F.pad(out, pad)
        n = out.shape[axis]
        acc = torch.zeros_like(out)
        for j, w in enumerate(k):
            acc.add_(padded.narrow(axis, j, n), alpha=w)
        out = acc
        del padded
    return out


def dense_phantom(shape_zyx, spacing_xyz, seed: int, device,
                  blobs_per_mm3: float = 1.0 / 2000.0) -> torch.Tensor:
    """[D, H, W] float32 volume on `device`, without noise (`add_noise`
    draws it per volume)."""
    D, H, W = (int(n) for n in shape_zyx)
    sx, sy, sz = (float(s) for s in spacing_xyz)
    spacing_zyx = (sz, sy, sx)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def coarse(cell_mm):
        shp = tuple(int(n * s // cell_mm) + 2 for n, s in zip((D, H, W), spacing_zyx))
        return torch.randn(shp, generator=g, device=device)

    fields = (coarse(CELL_SHEETS_MM), coarse(CELL_TUBES_MM), coarse(CELL_TUBES_MM))
    # corners: impulses inside the ellipsoid
    semi = [0.42 * n for n in (D, H, W)]
    ctr = [0.5 * (n - 1) for n in (D, H, W)]
    n_try = int(D * H * W * sx * sy * sz * blobs_per_mm3 / 0.31)
    lo = torch.tensor([2, 2, 2], device=device)
    hi = torch.tensor([D - 2, H - 2, W - 2], device=device)
    cand = lo + (torch.rand((n_try, 3), generator=g, device=device) * (hi - lo)).long()
    rel = (cand.float() - torch.tensor(ctr, device=device)) / torch.tensor(semi, device=device)
    inside = (rel * rel).sum(1) <= 1.0
    amp = 80.0 + torch.floor(torch.rand(n_try, generator=g, device=device) * 141.0)
    lin = (cand[:, 0] * H + cand[:, 1]) * W + cand[:, 2]
    impulses = torch.zeros(D * H * W, dtype=torch.float32, device=device)
    impulses.index_add_(0, lin[inside], amp[inside])
    return assemble(*fields, impulses.reshape(D, H, W), spacing_xyz)


def assemble(coarse_a: torch.Tensor, coarse_b: torch.Tensor, coarse_c: torch.Tensor,
             impulses: torch.Tensor, spacing_xyz) -> torch.Tensor:
    """The phantom from its coarse fields (cells of 18 and 24 mm) and its
    impulse volume: `_assemble_dense`'s arithmetic with physical lengths."""
    D, H, W = impulses.shape
    dev = impulses.device
    spacing_zyx = tuple(float(s) for s in reversed(spacing_xyz))
    fa = _upsample(coarse_a, (D, H, W), spacing_zyx, CELL_SHEETS_MM)
    fb = _upsample(coarse_b, (D, H, W), spacing_zyx, CELL_TUBES_MM)
    fc = _upsample(coarse_c, (D, H, W), spacing_zyx, CELL_TUBES_MM)
    vol = 100.0 / (1.0 + torch.exp(-fa / 0.06))  # sheets at A = 0
    vol = vol + 140.0 * torch.exp(-(fb * fb + fc * fc) / (2 * 0.05**2))  # tubes
    del fa, fb, fc

    # smooth ellipsoid envelope confining the structure, as a chest CT
    # concentrates its features in the lung fields
    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    semi = [0.42 * n for n in (D, H, W)]
    ctr = [0.5 * (n - 1) for n in (D, H, W)]
    r2 = (((ar(D) - ctr[0]) / semi[0]) ** 2)[:, None, None] \
        + (((ar(H) - ctr[1]) / semi[1]) ** 2)[None, :, None] \
        + (((ar(W) - ctr[2]) / semi[2]) ** 2)[None, None, :]
    vol = vol / (1.0 + torch.exp((r2 - 1.0) / 0.02))
    del r2
    sig = tuple(BLOB_SIGMA_MM / s for s in spacing_zyx)
    blob = _smooth(impulses, sig)
    return vol + blob * float((2 * np.pi) ** 1.5 * sig[0] * sig[1] * sig[2])  # unit peak * amp


def add_noise(vol: torch.Tensor, noise: float, generator: torch.Generator) -> torch.Tensor:
    """`vol` plus `noise` x standard normal, one draw of the generator."""
    if noise <= 0:
        return vol.clone()
    return vol + noise * torch.randn(vol.shape, generator=generator, device=vol.device)


def center_xyz(shape_zyx, spacing_xyz) -> np.ndarray:
    """The physical centre (x, y, z) of a volume with origin 0."""
    D, H, W = shape_zyx
    return np.asarray([(W - 1) * spacing_xyz[0] / 2, (H - 1) * spacing_xyz[1] / 2,
                       (D - 1) * spacing_xyz[2] / 2], np.float64)


def true_transform(rng: np.random.Generator, truth: dict, center: np.ndarray):
    """(A [3, 3], t [3], center [3]) float64 of one pair: a rotation about z
    by `truth["rotation_deg"]` +- `truth["rotation_jitter_deg"]` and the
    translation `truth["translation_mm"]` +- `truth["translation_jitter_mm"]`
    a component, about the volume's centre: y = A (x - c) + t."""
    th = np.deg2rad(truth["rotation_deg"] + rng.uniform(-1, 1) * truth["rotation_jitter_deg"])
    A = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0, 0, 1.0]])
    tr = np.asarray(truth["translation_mm"], np.float64) \
        + rng.uniform(-1, 1, 3) * truth["translation_jitter_mm"]
    return A, center + tr, center.copy()


def warp(vol: torch.Tensor, spacing_xyz, A: np.ndarray, t: np.ndarray, c: np.ndarray,
         slab_voxels: int = 1 << 23) -> torch.Tensor:
    """moving(x) = vol(T(x)) with T(x) = A (x - c) + t, trilinear, 0 outside:
    the moving volume of a pair whose true transform maps moving -> fixed
    physical points.  One z-slab at a time."""
    D, H, W = vol.shape
    dev = vol.device
    sp = torch.tensor(spacing_xyz, dtype=torch.float32, device=dev)
    Ad = torch.tensor(A, dtype=torch.float32, device=dev)
    td = torch.tensor(t, dtype=torch.float32, device=dev)
    cd = torch.tensor(c, dtype=torch.float32, device=dev)
    size = torch.tensor([W - 1, H - 1, D - 1], dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    out = torch.empty_like(vol)
    slab = max(1, slab_voxels // (H * W))
    src = vol[None, None]
    for z0 in range(0, D, slab):
        z = torch.arange(z0, min(z0 + slab, D), device=dev, dtype=torch.float32)
        idx = torch.stack([xx.expand(len(z), H, W), yy.expand(len(z), H, W),
                           z[:, None, None].expand(len(z), H, W)], -1)
        x = idx * sp - cd
        y = (x[..., None, :] * Ad).sum(-1) + td  # A x without a matmul (no TF32)
        grid = (y / sp) / size * 2.0 - 1.0  # align_corners=True coordinates, (x, y, z)
        out[z0 : z0 + len(z)] = F.grid_sample(src, grid[None], mode="bilinear",
                                              padding_mode="zeros", align_corners=True)[0, 0]
    return out

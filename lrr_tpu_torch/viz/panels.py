"""Checkerboard inspection panels (lrr_tpu/viz/panels.py).

Re-implements the reference's visual QA output: the 9-panel
axial/coronal/sagittal x moving/fixed/checkerboard grids around a query
location (LocationRegistration::GenerateSlices,
rrl/itkLocationRegistration.cxx:432-580, WRITE_PANELS/LAST_ITER) and the
slice-with-features rendering (cdcl/io/itkImageSlicesWithGeometryFilter).
VTK off-screen rendering is replaced by pure array compositing + a
dependency-free PNG writer.  Volumes are sampled on their own device; the
panels come back as numpy arrays on the host.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

import torch

from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops.resample import sample_trilinear
from lrr_tpu_torch.types import Volume


def _host_point(xyz) -> np.ndarray:
    if isinstance(xyz, torch.Tensor):
        xyz = xyz.detach().cpu().numpy()
    return np.asarray(xyz, np.float32)


def _plane_points(center_xyz, axis: int, half_extent_mm: float, resolution: int) -> np.ndarray:
    """[res, res, 3] world points of the slice plane through `center_xyz`
    perpendicular to `axis`."""
    center = _host_point(center_xyz)
    axes = [a for a in range(3) if a != axis]
    u = np.linspace(-half_extent_mm, half_extent_mm, resolution, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    pts = np.broadcast_to(center, (resolution, resolution, 3)).copy()
    pts[..., axes[0]] += uu
    pts[..., axes[1]] += vv
    return pts


def _sample(vol: Volume, pts: torch.Tensor) -> np.ndarray:
    """Trilinear samples of `vol` at world points, 0 outside."""
    vals, inside = sample_trilinear(vol.data, (pts - vol.origin) / vol.spacing)
    return torch.where(inside, vals, torch.zeros_like(vals)).cpu().numpy()


def save_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] grayscale or [H, W, 3] RGB uint8 as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = ((img - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    if img.ndim == 2:
        color_type, nch = 0, 1
    else:
        color_type, nch = 2, 3
    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def slice_panel(
    vol: Volume,
    center_xyz,
    axis: int,
    half_extent_mm: float = 25.0,
    resolution: int = 128,
) -> np.ndarray:
    """Resample a 2D slice through `center_xyz` perpendicular to `axis`
    (0=x sagittal, 1=y coronal, 2=z axial) as [res, res] float array."""
    pts = _plane_points(center_xyz, axis, half_extent_mm, resolution)
    return _sample(vol, torch.from_numpy(pts).to(vol.device))


def checkerboard(a: np.ndarray, b: np.ndarray, tiles: int = 8) -> np.ndarray:
    h, w = a.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    mask = ((yy * tiles // max(h, 1)) + (xx * tiles // max(w, 1))) % 2 == 0
    return np.where(mask, a, b)


def checkerboard_panels(
    fixed: Volume,
    moving: Volume,
    trans: Affine3D,
    query_xyz,
    half_extent_mm: float = 25.0,
    resolution: int = 128,
) -> np.ndarray:
    """The 9-panel grid: rows = axial/coronal/sagittal; columns = warped
    moving / fixed / checkerboard.  The moving volume is sampled through
    the inverse transform so its panel is in fixed-space coordinates
    (GenerateSlices semantics).  Returns one [3*res, 3*res] array."""
    inv = trans.inverse()

    def moving_panel(axis):
        # sample moving at inverse-mapped fixed-space points
        pts = _plane_points(query_xyz, axis, half_extent_mm, resolution)
        mapped = inv.apply(torch.from_numpy(pts.reshape(-1, 3)).to(moving.device))
        return _sample(moving, mapped.reshape(pts.shape))

    rows = []
    for axis in (2, 1, 0):  # axial, coronal, sagittal
        m = moving_panel(axis)
        f = slice_panel(fixed, query_xyz, axis, half_extent_mm, resolution)
        c = checkerboard(m, f)
        rows.append(np.concatenate([m, f, c], axis=1))
    return np.concatenate(rows, axis=0)


def overlay_covariance_ellipses(
    panel: np.ndarray,  # [res, res] one slice panel (modified copy returned)
    centers_xyz: np.ndarray,  # [N, 3] world mm glyph centers
    covariances: np.ndarray,  # [N, 3, 3] (or [3, 3] for a single glyph)
    center_xyz,
    axis: int,
    half_extent_mm: float = 25.0,
    slab_mm: float = 2.5,
    scale: float = 1.0,
    n_arc: int = 96,
    value: float | None = None,
) -> np.ndarray:
    """Draw 1-sigma covariance ellipses on a slice panel — the array-first
    analog of the reference's scaled tensor glyphs
    (cdcl/displayVTK/vtkTensorGlyphScaled.{h,cxx}, which renders covariance
    ellipsoids over the match/feature panels; its ScaleFactor maps to
    `scale` here).

    Each 3x3 covariance is projected onto the slice plane by taking the
    in-plane 2x2 block (the planar marginal of the Gaussian), its
    eigen-decomposition gives the ellipse axes (radius = scale * sqrt(λ)),
    and the outline is rasterized as `n_arc` samples.  Glyphs whose center
    is farther than `slab_mm` from the plane are skipped."""
    panel = np.array(panel, copy=True)
    res = panel.shape[0]
    center = np.asarray(center_xyz, np.float32)
    axes = [a for a in range(3) if a != axis]
    if value is None:
        value = float(panel.max()) if panel.size else 1.0

    pts = np.atleast_2d(np.asarray(centers_xyz, np.float32))
    covs = np.asarray(covariances, np.float64)
    if covs.ndim == 2:
        covs = covs[None]
    rel = pts - center
    in_slab = np.abs(rel[:, axis]) <= slab_mm
    px_scale = (res - 1) / (2.0 * half_extent_mm)
    theta = np.linspace(0.0, 2 * np.pi, n_arc, endpoint=False)
    circ = np.stack([np.cos(theta), np.sin(theta)], axis=0)  # [2, n_arc]

    for n in np.flatnonzero(in_slab):
        c2 = covs[n][np.ix_(axes, axes)]
        w, V = np.linalg.eigh(0.5 * (c2 + c2.T))
        radii = scale * np.sqrt(np.maximum(w, 0.0))
        arc = (V * radii[None, :]) @ circ  # [2, n_arc] plane offsets (mm)
        uv = rel[n][axes][:, None] + arc
        ij = np.round((uv + half_extent_mm) * px_scale).astype(int)
        keep = (ij >= 0).all(axis=0) & (ij < res).all(axis=0)
        panel[ij[0, keep], ij[1, keep]] = value
    return panel


def overlay_features(
    panel: np.ndarray,  # [res, res] one slice panel (modified copy returned)
    feature_xyz: np.ndarray,  # [N, 3] world mm
    feature_mask: np.ndarray,  # [N]
    center_xyz,
    axis: int,
    half_extent_mm: float = 25.0,
    slab_mm: float = 1.5,
    value: float | None = None,
) -> np.ndarray:
    """Mark features within `slab_mm` of the slice plane as bright crosses.

    The reference renders feature glyphs over its slice panels
    (cdcl/io/itkImageSlicesWithGeometryFilter.h:5, used for the 9-panel
    checkerboards); this is the array-first equivalent.
    """
    panel = np.array(panel, copy=True)
    res = panel.shape[0]
    center = np.asarray(center_xyz, np.float32)
    axes = [a for a in range(3) if a != axis]
    if value is None:
        value = float(panel.max()) if panel.size else 1.0

    pts = np.asarray(feature_xyz, np.float32)[np.asarray(feature_mask, bool)]
    rel = pts - center
    in_slab = np.abs(rel[:, axis]) <= slab_mm
    uv = rel[in_slab][:, axes]
    scale = (res - 1) / (2.0 * half_extent_mm)
    ij = np.round((uv + half_extent_mm) * scale).astype(int)
    keep = (ij >= 0).all(axis=1) & (ij < res).all(axis=1)
    for i, j in ij[keep]:
        panel[i, j] = value
        for d in (-1, 1):
            if 0 <= i + d < res:
                panel[i + d, j] = value
            if 0 <= j + d < res:
                panel[i, j + d] = value
    return panel

"""FeatureSet / KeypointSet / DescriptorSet <-> reference polydata formats
(lrr_tpu/io/features_io.py).

Array names and layouts match the reference writers so artifacts are
interchangeable for golden-parity testing:
  features    — Points + "normals"[3] "binormals"[3] "errorProjectors"[9]
                "strengths"[1] "shapes"[1, uint8]
                (features/vtkITKPointSetToPolyDataFilter.cxx:147-180)
  keypoints   — Points + "normals" "binormals" (cdcl/cdcl_utils_VTKIO)
  descriptors — Points + "descriptors"[195] "normals" "binormals"
                (features/vtkITKDescriptorPointSetToPolyDataFilter
                .cxx:155-165)

Only the valid rows are written, in order; a reader pads back to `capacity`
with masked-out zero rows.  Reading a feature file reconstructs the
direction list / error projector exactly like
vtkPolyDataToFeaturesWithShapeFilter (corner tangent = normal x binormal,
etc.).  A reader puts its set on `device`; `None` means the CUDA card
(`types.resolve_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.io.vtk_xml import PolyData, read_vtp, write_vtp
from lrr_tpu_torch.types import (
    CORNER,
    SHEET,
    DescriptorSet,
    FeatureSet,
    KeypointSet,
    resolve_device,
)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _padder(n: int, capacity: int | None, device):
    """(pad, mask): `pad` zero-extends a host array of n rows to the
    capacity and puts it on `device`; `mask` marks the n valid rows."""
    cap = capacity or n

    def pad(x):
        w = [(0, cap - n)] + [(0, 0)] * (x.ndim - 1)
        return torch.from_numpy(np.pad(x, w)).to(device)

    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pad, mask


def write_features(path: str, fs: FeatureSet):
    m = _np(fs.mask)
    poly = PolyData(
        points=_np(fs.xyz)[m].astype(np.float32),
        point_data={
            "normals": _np(fs.directions)[m][:, 0, :].astype(np.float32),
            "binormals": _np(fs.directions)[m][:, 1, :].astype(np.float32),
            "errorProjectors": _np(fs.projector)[m].reshape(-1, 9).astype(np.float32),
            "strengths": _np(fs.strength)[m].astype(np.float32),
            "shapes": _np(fs.shape)[m].astype(np.uint8),
        },
    )
    write_vtp(path, poly)


def read_features(path: str, capacity: int | None = None, device=None) -> FeatureSet:
    device = resolve_device(device, "read_features")
    poly = read_vtp(path)
    n = poly.points.shape[0]
    shapes = poly.point_data["shapes"].astype(np.int32).reshape(-1)
    normals = poly.point_data["normals"].astype(np.float32)
    binormals = poly.point_data.get(
        "binormals", np.zeros_like(normals)
    ).astype(np.float32)
    proj = poly.point_data["errorProjectors"].astype(np.float32).reshape(-1, 3, 3)
    strengths = poly.point_data["strengths"].astype(np.float32).reshape(-1)

    dirs = np.zeros((n, 3, 3), np.float32)
    dirs[:, 0, :] = normals
    tube_or_corner = shapes != SHEET
    dirs[tube_or_corner, 1, :] = binormals[tube_or_corner]
    corner = shapes == CORNER
    tangent = np.cross(normals[corner], binormals[corner])
    nrm = np.linalg.norm(tangent, axis=-1, keepdims=True)
    dirs[corner, 2, :] = tangent / np.maximum(nrm, 1e-12)

    pad, mask = _padder(n, capacity, device)
    return FeatureSet(
        xyz=pad(poly.points.astype(np.float32)),
        strength=pad(strengths),
        shape=pad(shapes),
        projector=pad(proj),
        directions=pad(dirs),
        mask=torch.from_numpy(mask).to(device),
    )


def write_keypoints(path: str, kp: KeypointSet):
    m = _np(kp.mask)
    poly = PolyData(
        points=_np(kp.xyz)[m].astype(np.float32),
        point_data={
            "normals": _np(kp.normal)[m].astype(np.float32),
            "binormals": _np(kp.binormal)[m].astype(np.float32),
            "strengths": _np(kp.strength)[m].astype(np.float32),
        },
    )
    write_vtp(path, poly)


def read_keypoints(path: str, capacity: int | None = None, device=None) -> KeypointSet:
    device = resolve_device(device, "read_keypoints")
    poly = read_vtp(path)
    n = poly.points.shape[0]
    pad, mask = _padder(n, capacity, device)
    strengths = poly.point_data.get("strengths", np.ones(n, np.float32))
    return KeypointSet(
        xyz=pad(poly.points.astype(np.float32)),
        strength=pad(strengths.astype(np.float32).reshape(-1)),
        normal=pad(poly.point_data["normals"].astype(np.float32)),
        binormal=pad(poly.point_data["binormals"].astype(np.float32)),
        mask=torch.from_numpy(mask).to(device),
    )


def write_descriptors(path: str, ds: DescriptorSet):
    kp = ds.keypoints
    m = _np(kp.mask)
    poly = PolyData(
        points=_np(kp.xyz)[m].astype(np.float32),
        point_data={
            "descriptors": _np(ds.descriptors)[m].astype(np.float32),
            "normals": _np(kp.normal)[m].astype(np.float32),
            "binormals": _np(kp.binormal)[m].astype(np.float32),
        },
    )
    write_vtp(path, poly)


def read_descriptors(path: str, capacity: int | None = None, device=None) -> DescriptorSet:
    device = resolve_device(device, "read_descriptors")
    poly = read_vtp(path)
    n = poly.points.shape[0]
    pad, mask = _padder(n, capacity, device)
    kp = KeypointSet(
        xyz=pad(poly.points.astype(np.float32)),
        strength=torch.from_numpy(np.where(mask, 1.0, 0.0).astype(np.float32)).to(device),
        normal=pad(poly.point_data["normals"].astype(np.float32)),
        binormal=pad(poly.point_data["binormals"].astype(np.float32)),
        mask=torch.from_numpy(mask).to(device),
    )
    return DescriptorSet(
        keypoints=kp,
        descriptors=pad(poly.point_data["descriptors"].astype(np.float32)),
    )

"""Spatial block parallelism over the volume grid
(lrr_tpu/parallel/spatial.py).

The reference splits voxel regions across threads for the score-image and
NMS stencils (itkFeatureImageFilter.txx:370-466 via SplitRequestedRegion).
Here the volume's z axis is split over the ranks of a mesh axis: each rank
runs the stencils on its z-slab extended by its neighbours' boundary slabs
(the halo), so its block of the result is bitwise the single-process
program's (the filters are shift-and-add in a fixed order,
`ops/filters.py`).  Every rank holds the whole volume; it takes its own
slab, and the slabs of the result are gathered along z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lrr_tpu_torch.ops import filters
from lrr_tpu_torch.parallel.distributed import Mesh, all_gather


def halo_exchange(
    x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str = "sp", axis: int = 0
) -> torch.Tensor:
    """Extend this rank's block by `halo` slabs on each side of `axis`.

    Interior boundaries receive the neighbouring ranks' slabs (one
    all-gather of every rank's two boundary slabs); the outermost ranks
    replicate their edge slab, as `ops.filters.correlate1d` edge-pads at
    the volume's borders."""
    n = mesh.axis_size(axis_name)
    size = x.shape[axis]
    if halo > size:
        raise ValueError(f"halo {halo} exceeds local block extent {size}")
    idx = mesh.axis_index(axis_name)
    top = x.narrow(axis, 0, halo)
    bot = x.narrow(axis, size - halo, halo)
    if n > 1:
        # [n, 2, ...]: every rank's (top, bottom) slabs in rank order
        slabs = all_gather(mesh, torch.stack([top, bot])[None], axis_name, dim=0)

    def edge(at: int) -> torch.Tensor:
        reps = [1] * x.dim()
        reps[axis] = halo
        return x.narrow(axis, at, 1).repeat(*reps)

    up = edge(0) if idx == 0 else slabs[idx - 1, 1]
    down = edge(size - 1) if idx == n - 1 else slabs[idx + 1, 0]
    return torch.cat([up, x, down], dim=axis)


def score_halo(sigma_vox: float, truncate: float = 4.0) -> int:
    """Halo width for the Gaussian-gradient stencil (kernel radius).  The
    3^3 box-mean stage exchanges its own 1-slab halo separately so border
    semantics compose exactly like the single-process program (each stage
    edge-pads its own input at true volume borders)."""
    return int(math.ceil(truncate * float(sigma_vox)))


def score_stage_slab(
    vol_data: torch.Tensor,  # [D, H, W], the whole volume; D divisible by the axis size
    sigma_vox,  # scalar or per axis (z, y, x)
    spacing,  # (x, y, z)
    mesh: Mesh,
    axis_name: str = "sp",
    truncate: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The detector's dense stage on this rank's z-slab: (gradient
    [dz, H, W, 3], score [dz, H, W], outer6 [dz, H, W, 6]), bitwise the
    single-process program's rows of that slab."""
    from lrr_tpu_torch.features.extract import _score_and_outer

    sigma_z = float(np.broadcast_to(np.asarray(sigma_vox, np.float64), (3,))[0])
    # a derivative kernel reaches one voxel even at sigma 0 (filters.gaussian_kernel)
    halo = max(1, score_halo(sigma_z, truncate))
    dz = vol_data.shape[0] // mesh.axis_size(axis_name)
    i = mesh.axis_index(axis_name)
    ext = halo_exchange(vol_data[i * dz : (i + 1) * dz], halo, mesh, axis_name)
    grad = filters.gaussian_gradient(ext, sigma_vox, spacing, truncate)
    grad = grad[halo : grad.shape[0] - halo]
    # box_mean stage: its own 1-slab exchange, so the true-border edge
    # replication applies to the gradient field (as box_mean's edge padding
    # does in one process), not to raw voxels
    score, outer = _score_and_outer(halo_exchange(grad, 1, mesh, axis_name))
    return grad, score[1:-1], outer[1:-1]


def sharded_feature_score(
    vol_data: torch.Tensor,  # [D, H, W], D divisible by the axis size
    sigma_vox,
    spacing,
    mesh: Mesh,
    axis_name: str = "sp",
    truncate: float = 4.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The detector's score stage (gradient -> outer product -> score,
    itkFeatureImageFilter.txx:303-367) with the volume z-split over
    `axis_name`.  Returns (score [D, H, W], outer6 [D, H, W, 6]) on every
    rank, equal bit for bit to the single-process computation."""
    spacing = tuple(float(s) for s in np.asarray(spacing))
    _, score, outer = score_stage_slab(vol_data, sigma_vox, spacing, mesh, axis_name, truncate)
    return all_gather(mesh, score, axis_name), all_gather(mesh, outer, axis_name)

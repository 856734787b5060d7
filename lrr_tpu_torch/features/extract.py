"""Multi-scale 3D feature detection: corners, tubes, sheets
(lrr_tpu/features/extract.py; reference features/itkFeatureImageFilter.txx).

  dense pass   separable Gaussian gradients, the 27-neighbourhood
               outer-product score, local-contrast filtering, a dense
               axis-maximum pre-filter, and a candidate budget split over
               z-slabs;
  sparse pass  the budgeted candidate voxels as one batch: eigen-direction
               NMS with shape classification, the 10-coefficient quadratic
               sub-voxel fit, gradient-based direction refinement,
               gamma-normalised strengths and error projectors.

Levels are merged, sparsified at `min_distance_mm` (ops/sparsify.py) and the
strongest `max_features` kept.  Every "top k" is a stable descending sort:
equal values come out lowest index first, as from `jax.lax.top_k`, and the
order of the output set is part of the result (the Voronoi maps store
feature indices, the sampling plan permutes them).
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.config import FeatureConfig, KeypointConfig
from lrr_tpu_torch.ops import filters, ieee
from lrr_tpu_torch.ops.contrast import contrast_keep_mask
from lrr_tpu_torch.ops.eig3 import eigh3, unit
from lrr_tpu_torch.ops.resample import sample_trilinear
from lrr_tpu_torch.ops.sparsify import sparsify_mask
from lrr_tpu_torch.parallel.distributed import all_gather
from lrr_tpu_torch.parallel.spatial import score_stage_slab
from lrr_tpu_torch.types import (
    CORNER, SHEET, TUBE, FeatureSet, KeypointSet, Volume, concat_feature_sets, no_tf32, pad_rows,
)

SCORE_FLOOR = 1e-4  # NMS noise floor (itkFeatureImageFilter.txx:657)
MAX_REFINE_NORM = 1.73  # sqrt(3) refinement bound (txx:1595)
HESSIAN_EIG_CUTOFF = -1.0  # eigendirections above this get no refinement (txx:1584)

# 27 neighbourhood offsets in (x, y, z) order, x fastest: the ITK
# neighbourhood order of the LS design (txx:1495-1533)
_OFF = np.array(
    [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)], np.float32
)


def _monomials(o):
    """[..., 3] offsets -> [..., 10] design rows ordered
    [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1] (txx:1537-1547,1625-1641);
    numpy arrays and tensors alike."""
    x, y, z = o[..., 0], o[..., 1], o[..., 2]
    stack = torch.stack if isinstance(o, torch.Tensor) else np.stack
    ones = torch.ones_like(x) if isinstance(o, torch.Tensor) else np.ones_like(x)
    return stack([x * x, x * y, y * y, x * z, y * z, z * z, x, y, z, ones], -1)


_DESIGN = _monomials(_OFF)  # [27, 10]
_LS = np.linalg.solve(_DESIGN.T @ _DESIGN, _DESIGN.T).astype(np.float32)  # [10, 27]


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, equal values lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _score_and_outer(grad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """grad [D, H, W, 3] -> (score [D, H, W], outer6 [D, H, W, 6]): the
    3^3 mean of the gradient outer product, unique entries (xx, xy, xz, yy,
    yz, zz), and its trace."""
    g = grad
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    outer = torch.stack([filters.box_mean(g[..., i] * g[..., j], 1) for i, j in pairs], dim=-1)
    score = outer[..., 0] + outer[..., 3] + outer[..., 5]
    return score, outer


def _sym_from_6(o6: torch.Tensor) -> torch.Tensor:
    """[..., 6] (xx, xy, xz, yy, yz, zz) -> [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (o6[..., i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )


def _xyz_index(cand_idx: torch.Tensor, dtype) -> torch.Tensor:
    """Voxel indices [K, 3] (z, y, x) -> positions (x, y, z) as floats."""
    return torch.stack([cand_idx[:, 2], cand_idx[:, 1], cand_idx[:, 0]], -1).to(dtype)


def _nms_classify(
    score_vol: torch.Tensor,
    outer6: torch.Tensor,
    cand_idx: torch.Tensor,  # [K, 3] int (z, y, x)
    cand_score: torch.Tensor,  # [K]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigen-direction non-max suppression at candidate voxels.

    Returns (num_maxima [K], shape [K], nms_dirs [K, 3, 3]); the rows of
    nms_dirs are the eigenvector step directions that were maxima, compacted
    to the front in ascending-eigenvalue order: the reference's m_Directions
    list (txx:696-745), later consumed by position (txx:860-912)."""
    O = _sym_from_6(outer6[cand_idx[:, 0], cand_idx[:, 1], cand_idx[:, 2]])
    _, V = eigh3(O)  # columns ascending

    pos_xyz = _xyz_index(cand_idx, score_vol.dtype)
    is_max = []
    for d in range(3):
        v = V[:, :, d]
        prev, _ = sample_trilinear(score_vol, pos_xyz - v)
        post, _ = sample_trilinear(score_vol, pos_xyz + v)
        is_max.append((cand_score > prev) & (cand_score > post))
    is_max = torch.stack(is_max, -1)  # [K, 3]

    num_maxima = is_max.sum(-1).to(torch.int32)
    # 1 -> SHEET, 2 -> TUBE, 3 -> CORNER (txx:748-768)
    shape = torch.where(
        num_maxima == 1, SHEET, torch.where(num_maxima == 2, TUBE, CORNER)
    ).to(torch.int32)

    # compact the max directions to the front, keeping ascending-d order
    order = torch.sort((~is_max).to(torch.int8), dim=-1, stable=True).indices  # [K, 3]
    dirs = V.transpose(1, 2).gather(1, order[:, :, None].expand(-1, -1, 3))
    return num_maxima, shape, dirs


def _subvoxel_fit(
    score_vol: torch.Tensor,
    cand_idx: torch.Tensor,  # [K, 3] (z, y, x)
    origin: torch.Tensor,
    spacing: torch.Tensor,
    step_mm: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched 10-coefficient quadratic fit with physical-unit steps: the
    score at the 27 offsets of +-step_mm around each candidate, the
    precomputed LS solve, and the refinement toward the quadratic's maximum
    with the reference's eigenvalue gating (txx:1504-1605).

    Returns (xyz_refined [K, 3] physical, strength [K], ok [K])."""
    dev = score_vol.device
    phys = origin + _xyz_index(cand_idx, score_vol.dtype) * spacing  # [K, 3]

    off = torch.as_tensor(_OFF, device=dev) * step_mm  # [27, 3] physical offsets
    sample_idx = (phys[:, None, :] + off[None]) / spacing - (origin / spacing)
    vals, _ = sample_trilinear(score_vol, sample_idx)  # [K, 27]

    X = vals @ torch.as_tensor(_LS.T, device=dev)  # [K, 10] quadratic coefficients

    # Hessian A (txx:1540-1553) and gradient b
    A = torch.stack(
        [
            torch.stack([2 * X[:, 0], X[:, 1], X[:, 3]], -1),
            torch.stack([X[:, 1], 2 * X[:, 2], X[:, 4]], -1),
            torch.stack([X[:, 3], X[:, 4], 2 * X[:, 5]], -1),
        ],
        dim=-2,
    )  # [K, 3, 3]
    b = -X[:, 6:9]

    w, V = eigh3(A)
    any_negative = (w < 0).any(-1)  # reject pure minima (txx:1570-1573)
    use = w < HESSIAN_EIG_CUTOFF
    winv = torch.where(use, 1.0 / torch.where(use, w, torch.ones_like(w)), torch.zeros_like(w))
    # A^-1 = V diag(winv) V^T and its product with b, as plain sums
    Ainv = (V[:, :, None, :] * winv[:, None, None, :] * V[:, None, :, :]).sum(-1)
    refinement = (Ainv * b[:, None, :]).sum(-1)  # [K, 3] in mm

    ok_norm = ieee.sqrt((refinement * refinement).sum(-1)) <= MAX_REFINE_NORM
    strength = (_monomials(refinement) * X).sum(-1)
    ok = any_negative & ok_norm & (strength >= 0.0)
    xyz = torch.where(ok[:, None], phys + refinement, phys)
    return xyz, strength, ok


def _refine_directions(
    grad_vol: torch.Tensor,  # [D, H, W, 3]
    xyz: torch.Tensor,  # [K, 3] physical
    shape: torch.Tensor,  # [K]
    nms_dirs: torch.Tensor,  # [K, 3, 3] compacted NMS step directions (rows)
    origin: torch.Tensor,
    spacing: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-interpolated-gradient direction and the shape frames and
    projectors (ComputeDirections and ComputeCovariances, txx:791-925,
    1041-1085):
      * d0 = normalised mean of the gradient interpolated at the 27
        min-spacing physical offsets around the point;
      * sheet: dirs = [d0];                                   P = d0 d0^T
      * tube: binormal source = nms_dirs[0], y-flipped, Gram-Schmidt against
        d0; tangent = d0 x d1;                                P = I - t t^T
      * corner: binormal source = nms_dirs[2] (largest eigenvalue), same
        orthogonalisation; dirs[2] = d0 x d1;                 P = I
    Returns (directions [K, 3, 3] rows, projector [K, 3, 3])."""
    off = torch.as_tensor(_OFF, device=xyz.device) * spacing.min()
    sample_idx = (xyz[:, None, :] + off[None] - origin) / spacing
    g, inside = sample_trilinear(grad_vol, sample_idx)  # [K, 27, 3]
    g = torch.where(inside[..., None], g, torch.zeros_like(g))
    d0 = unit(g.sum(1) / 27.0)

    def orth_from(ev):
        ev = torch.where(ev[:, 1:2] < 0.0, -ev, ev)  # half-space flip (txx:874)
        return unit(ev - (d0 * ev).sum(-1, keepdim=True) * d0)

    d1 = torch.where(
        (shape == CORNER)[:, None], orth_from(nms_dirs[:, 2, :]), orth_from(nms_dirs[:, 0, :])
    )
    d2 = unit(torch.linalg.cross(d0, d1))

    zero = torch.zeros_like(d0)
    is_sheet = (shape == SHEET)[:, None]
    is_tube = (shape == TUBE)[:, None]
    dirs = torch.stack(
        [d0, torch.where(is_sheet, zero, d1), torch.where(is_sheet | is_tube, zero, d2)], dim=1
    )

    eye = torch.eye(3, dtype=d0.dtype, device=d0.device)
    proj_sheet = d0[:, :, None] * d0[:, None, :]
    tangent = torch.linalg.cross(d0, d1)
    proj_tube = eye - tangent[:, :, None] * tangent[:, None, :]
    projector = torch.where(
        is_sheet[:, :, None], proj_sheet,
        torch.where(is_tube[:, :, None], proj_tube, eye.expand_as(proj_tube)),
    )
    return dirs, projector


def _slab_candidates(flat_score: torch.Tensor, D: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The candidate budget k split evenly over up to 16 z-slabs: (scores
    [k], flat voxel indices [k]).  A single global top-k starves whole
    regions once the volume dwarfs the budget; the reference has no cap."""
    n_vox = flat_score.shape[0]
    nb = max(1, min(16, D // 16))
    if nb == 1:
        return _top_k(flat_score, k)
    k_b = -(-k // nb)
    pad_rows_ = (-D) % nb
    padded = torch.cat(
        [flat_score, flat_score.new_full((pad_rows_ * (n_vox // D),), -torch.inf)]
    ).reshape(nb, -1)
    slab_scores, slab_idx = _top_k(padded, k_b)  # [nb, k_b]
    slab_vox = padded.shape[1]
    flat_idx = (
        slab_idx + (torch.arange(nb, device=flat_score.device) * slab_vox)[:, None]
    ).reshape(-1)[:k]
    # padding rows land beyond the volume and carry -inf scores
    return slab_scores.reshape(-1)[:k], torch.clamp(flat_idx, max=n_vox - 1)


def _dense_stage(data, sigma_vox, spacing_t, mesh, axis_name: str):
    """(gradient, score, outer6) of the whole volume.  With a mesh whose
    `axis_name` divides the z extent, each rank computes its z-slab
    (`parallel.spatial.score_stage_slab`, bitwise the one-process rows) and
    one all-gather of the packed slabs gives every rank the whole stage;
    otherwise, as lrr_tpu's `shard_vol` leaves an uneven volume, one process
    computes it all."""
    if mesh is None or mesh.axis_size(axis_name) == 1 or data.shape[0] % mesh.axis_size(axis_name):
        grad = filters.gaussian_gradient(data, sigma_vox, spacing_t)
        return (grad, *_score_and_outer(grad))
    grad, _, outer6 = score_stage_slab(data, sigma_vox, spacing_t, mesh, axis_name)
    packed = all_gather(mesh, torch.cat([grad, outer6], -1), axis_name)
    grad, outer6 = packed[..., :3].contiguous(), packed[..., 3:].contiguous()
    del packed
    # the score is the outer product's trace, summed as `_score_and_outer` sums it
    return grad, outer6[..., 0] + outer6[..., 3] + outer6[..., 5], outer6


def detect_features_level(
    vol: Volume, sigma_mm: float, max_candidates: int, contrast_radius_mm: float = 30.0,
    mesh=None, axis_name: str = "sp",
) -> FeatureSet:
    """The detector at one pyramid level: a FeatureSet of capacity
    `max_candidates` (invalid entries masked).  The spacing fixes the filter
    taps, so it is read on the host.  With `mesh` the dense stage is split
    over the ranks of `axis_name` along z (`_dense_stage`); the sparse
    pass runs on every rank."""
    spacing_t = tuple(float(x) for x in vol.spacing.cpu().numpy())
    data, origin, spacing = vol.data, vol.origin, vol.spacing
    sigma_vox = sigma_mm / np.asarray(spacing_t, np.float64)
    # sigma per storage axis (z, y, x)
    grad, score, outer6 = _dense_stage(data, sigma_vox[::-1], spacing_t, mesh, axis_name)

    radius_vox = int(round(contrast_radius_mm / max(min(spacing_t), 1e-6)))
    keep = contrast_keep_mask(score, torch.ones_like(score, dtype=torch.bool), radius_vox)

    # Dense 1-D NMS pre-filter: a voxel can only survive the eigendirection
    # NMS if it is a local maximum along at least one coordinate axis.
    # Spending the candidate budget on such voxels keeps it repeatable
    # across volumes.  The shifts wrap at the border, as the JAX package's.
    axis_max = torch.zeros_like(score, dtype=torch.bool)
    for ax in range(3):
        nxt = torch.roll(score, -1, dims=ax)
        prv = torch.roll(score, 1, dims=ax)
        axis_max |= (score > nxt) & (score >= prv)

    cand_ok = (score >= SCORE_FLOOR) & keep & axis_max
    flat_score = torch.where(cand_ok, score, torch.full_like(score, -torch.inf)).reshape(-1)
    del keep, axis_max, cand_ok, nxt, prv
    D, H, W = score.shape
    k = min(max_candidates, flat_score.shape[0])
    top_scores, flat_idx = _slab_candidates(flat_score, D, k)
    del flat_score
    cand_idx = torch.stack(
        [flat_idx // (H * W), (flat_idx // W) % H, flat_idx % W], -1
    )
    cand_valid = torch.isfinite(top_scores)

    num_maxima, shape, nms_dirs = _nms_classify(score, outer6, cand_idx, top_scores)
    xyz, strength, sub_ok = _subvoxel_fit(score, cand_idx, origin, spacing)
    dirs, projector = _refine_directions(grad, xyz, shape, nms_dirs, origin, spacing)

    # gamma normalisation across scales (txx:1030-1034,1049-1080)
    gamma = torch.where(
        shape == SHEET, sigma_mm, torch.where(shape == TUBE, sigma_mm**2, sigma_mm**1.5)
    ).to(strength.dtype)
    strength = strength * gamma

    mask = cand_valid & (num_maxima > 0) & sub_ok
    fs = FeatureSet(
        xyz=xyz, strength=strength, shape=shape, projector=projector, directions=dirs, mask=mask
    )
    return pad_rows(fs, max_candidates - k)


def _compact_top(fs: FeatureSet, capacity: int) -> FeatureSet:
    """The `capacity` strongest valid entries as a fresh set."""
    key = torch.where(fs.mask, fs.strength, torch.full_like(fs.strength, -torch.inf))
    k = min(capacity, key.shape[0])
    top, idx = _top_k(key, k)
    return pad_rows(fs.take(idx, valid=torch.isfinite(top)), capacity - k)


def downsampled(vol: Volume) -> Volume:
    return Volume(data=filters.downsample2(vol.data), origin=vol.origin, spacing=vol.spacing * 2.0)


def detect_features(vol: Volume, cfg: FeatureConfig, mesh=None, axis_name: str = "sp") -> FeatureSet:
    """Multi-level detection and spatial sparsification, on the volume's
    device.

    Pyramid levels follow the reference's use of levels 1-2 of 3 (shrink
    factors 2 and 1; txx:1119-1137); the features of all levels merge before
    the strength-greedy spatial filter (ExtractFeatures.cxx:483-488).  With
    `mesh`, each level's dense stage is z-split over `axis_name`."""
    no_tf32()  # scores feed strict comparisons
    shrink_by_level = {0: 4, 1: 2, 2: 1}
    merged = None
    for level in cfg.used_levels:
        v = vol
        shrink = shrink_by_level.get(level, 1)
        while shrink > 1:
            v = downsampled(v)
            shrink //= 2
        fs = detect_features_level(
            v, float(cfg.sigma), cfg.candidates_per_level, float(cfg.contrast_radius_mm),
            mesh=mesh, axis_name=axis_name,
        )
        merged = fs if merged is None else concat_feature_sets(merged, fs)

    keep = sparsify_mask(merged.xyz, merged.strength, merged.mask, cfg.min_distance_mm)
    merged.mask = merged.mask & keep
    return _compact_top(merged, cfg.max_features)


def extract_keypoints(features: FeatureSet, cfg: KeypointConfig) -> KeypointSet:
    """Corner features, sparsified at `min_distance_mm`, with (normal,
    binormal) frames: the corner's direction rows 0 and 1
    (ExtractKeypoints.cxx:227-277)."""
    is_corner = features.mask & (features.shape == CORNER)
    keep = sparsify_mask(features.xyz, features.strength, is_corner, cfg.min_distance_mm)
    sel = is_corner & keep
    key = torch.where(sel, features.strength, torch.full_like(features.strength, -torch.inf))
    k = min(cfg.max_keypoints, key.shape[0])
    top, idx = _top_k(key, k)
    kps = KeypointSet(
        xyz=features.xyz[idx],
        strength=features.strength[idx],
        normal=features.directions[idx, 0, :],
        binormal=features.directions[idx, 1, :],
        mask=torch.isfinite(top),
    )
    return pad_rows(kps, cfg.max_keypoints - k)

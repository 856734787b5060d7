"""Oriented 3D shape-context descriptors, 195-d (lrr_tpu/ops/descriptors.py;
reference features/itkDescriptorMeshFilter.txx).

  * neighbours: the features within `radius_mm` of the keypoint, at least
    `min_neighbors` (txx:573-581), gathered as the `max_neighbors` nearest;
  * keypoint orientation: strength-weighted mean of the non-sheet
    neighbours' direction rows 0 and 1; a keypoint whose neighbours are all
    sheets is skipped (txx:596-654);
  * per neighbour, the context vector (keypoint - feature) is soft-binned
    into (log radius, azimuth mod pi, elevation mod pi) with the reference's
    2x2x2 trilinear splat, angular wrap-around and radius overflow row
    (AddToBin, txx:183-344); the payload is the feature's z>=0-flipped
    normal;
  * bins are rotated by the keypoint frame, normalised by the cube root of
    the wedge volume, flattened to (1 + 4*4*4)*3 = 195 and L2-normalised
    (txx:698-707, CopyDescriptor txx:357-410).

The splat is a one-hot product, as in the JAX package, written as a masked
sum over the splat targets: a reduction in a fixed order, so the same input
gives the same bits on every run (an atomic scatter-add would not, and the
low bits decide near-ties of the descriptor matching).  Neighbour distances
are component-wise fp32, never the matmul expansion.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lrr_tpu_torch.config import DescriptorConfig
from lrr_tpu_torch.ops import ieee
from lrr_tpu_torch.ops.eig3 import unit
from lrr_tpu_torch.types import SHEET, DescriptorSet, FeatureSet, KeypointSet

TWO_PI = 2.0 * math.pi


def _angles_wrt(v: torch.Tensor, ref_angle: torch.Tensor, comp: int) -> torch.Tensor:
    """Azimuth (comp=1) or elevation (comp=2) of vectors v [..., 3] relative
    to a reference angle, folded to [0, pi) (AddToBin txx:228-243)."""
    ang = torch.atan2(v[..., comp], v[..., 0]) + math.pi
    ang = torch.where(ang >= TWO_PI, ang - TWO_PI, ang)
    rel = ang - ref_angle
    rel = torch.where(rel < 0.0, rel + TWO_PI, rel)
    rel = torch.where(rel >= TWO_PI, rel - TWO_PI, rel)
    rel = torch.where(rel >= math.pi, rel - math.pi, rel)
    # guard the second fold for rel just under 2*pi
    return torch.where(rel >= math.pi, rel - math.pi, rel)


def _soft_bin_1d(frac_raw: torch.Tensor, nbins: int, wrap: bool, clamp_hi: int):
    """Reference soft-binning along one axis; frac_raw = value / bin_size.
    Returns (bin, w, nbr_bin, nbr_w) (txx:247-325): main bin = floor(frac)
    (mod nbins if wrap), frac -= bin - 0.5; if frac > 1 the neighbour is
    bin+1 with weight frac-1, else bin-1 with weight 1-frac.  Non-wrapped
    axes clamp at 0 and at `clamp_hi`."""
    fl = torch.floor(frac_raw).long()
    b = torch.remainder(fl, nbins) if wrap else torch.clamp(fl, 0, clamp_hi)
    frac = frac_raw - (b.to(frac_raw.dtype) - 0.5)
    hi = frac > 1.0
    w_main = torch.where(hi, 2.0 - frac, frac)
    w_nbr = 1.0 - w_main
    if wrap:
        nbr = torch.where(hi, torch.remainder(b + 1, nbins), torch.remainder(b - 1 + nbins, nbins))
    else:
        nbr = torch.where(hi, torch.clamp(b + 1, max=clamp_hi), torch.clamp(b - 1, min=0))
    return b, w_main, nbr, w_nbr


def _wedge_norms(cfg: DescriptorConfig) -> np.ndarray:
    """Cube-root wedge-volume normalisers in the flattened descriptor's
    layout (CopyDescriptor txx:357-410): [centre] + shells 1..R-1 x az x el.
    3.1415 is the reference's pi."""
    R, O = cfg.radius_bins, cfg.orient_bins
    log_bin = math.log(cfg.radius_mm) / R
    out = np.zeros(1 + (R - 1) * O * O, np.float64)
    center_r = math.exp(log_bin)
    out[0] = (4.0 / 3.0 * 3.1415 * center_r**3) ** (1.0 / 3.0)
    const = 4.0 / 3.0 * 3.1415 / (O * O)
    loc = 1
    for i in range(1, R):
        big = math.exp((i + 1) * log_bin)
        small = math.exp(i * log_bin)
        w = (const * (big**3 - small**3)) ** (1.0 / 3.0)
        for _ in range(O * O):
            out[loc] = w
            loc += 1
    return out.astype(np.float32)


def _descriptors_chunk(
    kp_xyz: torch.Tensor,  # [C, 3]
    nb_xyz: torch.Tensor,  # [C, M, 3]
    nb_normal: torch.Tensor,  # [C, M, 3] feature direction row 0
    nb_binormal: torch.Tensor,  # [C, M, 3] feature direction row 1
    nb_strength: torch.Tensor,  # [C, M]
    nb_shape: torch.Tensor,  # [C, M]
    nb_valid: torch.Tensor,  # [C, M]
    cfg: DescriptorConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_descriptor_one` of the JAX package over C keypoints at once:
    (descriptor [C, dim], direction [C, 3], bidirection [C, 3], ok [C])."""
    R, O = cfg.radius_bins, cfg.orient_bins
    C, M = nb_strength.shape
    dev = kp_xyz.device
    log_bin = math.log(cfg.radius_mm) / R
    az_bin = math.pi / O

    # ---- keypoint orientation (txx:596-654) --------------------------------
    w = torch.where(nb_valid & (nb_shape != SHEET), nb_strength, torch.zeros_like(nb_strength))
    ok_orient = w.sum(-1) > 0.0
    direction = unit((w[..., None] * nb_normal).sum(1))
    bidirection = unit((w[..., None] * nb_binormal).sum(1))

    normal = torch.where(direction[:, 2:3] < 0.0, -direction, direction)
    binormal = torch.where(bidirection[:, 1:2] < 0.0, -bidirection, bidirection)
    kp_az = torch.atan2(normal[:, 1], normal[:, 0]) + math.pi
    kp_el = torch.atan2(normal[:, 2], normal[:, 0]) + math.pi
    rot = torch.stack([normal, binormal, torch.linalg.cross(normal, binormal)], dim=2)  # columns

    # ---- per-neighbour soft binning (AddToBin) -----------------------------
    cv = kp_xyz[:, None, :] - nb_xyz  # context vectors point AT the keypoint
    radius = torch.clamp(ieee.sqrt((cv * cv).sum(-1)), min=1.0)
    az = _angles_wrt(cv, kp_az[:, None], 1)
    el = _angles_wrt(cv, kp_el[:, None], 2)

    rb, rw, rnb, rnw = _soft_bin_1d(torch.log(radius) / log_bin, R + 1, False, R)
    ab, aw, anb, anw = _soft_bin_1d(az / az_bin, O, True, O - 1)
    eb, ew, enb, enw = _soft_bin_1d(el / az_bin, O, True, O - 1)

    payload = torch.where(nb_normal[..., 2:3] < 0.0, -nb_normal, nb_normal)
    payload = torch.where(nb_valid[..., None], payload, torch.zeros_like(payload))

    nbins = (R + 1) * O * O

    def flat(r, a, e):
        return (r * O + a) * O + e

    targets = torch.stack(
        [
            flat(rb, ab, eb), flat(rb, ab, enb), flat(rb, anb, eb), flat(rb, anb, enb),
            flat(rnb, ab, eb), flat(rnb, ab, enb), flat(rnb, anb, eb), flat(rnb, anb, enb),
        ],
        dim=-1,
    )  # [C, M, 8]
    weights = torch.stack(
        [
            rw * aw * ew, rw * aw * enw, rw * anw * ew, rw * anw * enw,
            rnw * aw * ew, rnw * aw * enw, rnw * anw * ew, rnw * anw * enw,
        ],
        dim=-1,
    )
    weights = torch.where(nb_valid[..., None], weights, torch.zeros_like(weights))

    # the 8 splats of every neighbour, summed per bin in a fixed order
    one_hot = (
        targets.reshape(C, M * 8, 1) == torch.arange(nbins, device=dev)
    ).to(payload.dtype)  # [C, M*8, nbins]
    contrib = weights.reshape(C, M * 8, 1) * payload.repeat_interleave(8, dim=1)  # [C, M*8, 3]
    bins = torch.stack(
        [(one_hot * contrib[:, :, c, None]).sum(1) for c in range(3)], dim=-1
    )  # [C, nbins, 3]

    # rotate the bins by the keypoint frame (txx:698-707): bins @ rot^T
    bins = (bins[:, :, None, :] * rot[:, None, :, :]).sum(-1)

    # ---- flatten + normalise (CopyDescriptor) ------------------------------
    grid = bins.reshape(C, R + 1, O, O, 3)
    center = grid[:, 0].sum(dim=(1, 2))  # [C, 3]
    shells = grid[:, 1:R].reshape(C, -1, 3)  # overflow row R dropped
    flatv = torch.cat([center[:, None], shells], 1)  # [C, 1 + (R-1)*O*O, 3]
    flatv = flatv / torch.as_tensor(_wedge_norms(cfg), device=dev)[None, :, None]
    desc = flatv.reshape(C, -1)
    nrm = ieee.sqrt((desc * desc).sum(-1, keepdim=True))
    desc = torch.where(nrm > 0, desc / torch.clamp(nrm, min=1e-30), desc)

    ok = ok_orient & (nb_valid.sum(-1) >= cfg.min_neighbors)
    return desc, direction, bidirection, ok


def _nearest_features(
    kp_xyz: torch.Tensor, f_xyz: torch.Tensor, f_mask: torch.Tensor, M: int, radius_mm: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The M nearest valid features of each keypoint (indices [C, M], equal
    distances lowest index first, as `lax.top_k` of the negated distances
    gives) and which of them lie within the radius."""
    d2 = sum((kp_xyz[:, c][:, None] - f_xyz[:, c][None, :]) ** 2 for c in range(3))
    d2 = torch.where(f_mask[None, :], d2, torch.full_like(d2, torch.inf))
    near, idx = torch.sort(d2, dim=1, stable=True)
    near, idx = near[:, :M], idx[:, :M]
    return idx, (near <= radius_mm**2) & torch.isfinite(near)


def compute_descriptors(
    keypoints: KeypointSet, features: FeatureSet, cfg: DescriptorConfig, chunk: int = 128
) -> DescriptorSet:
    """Descriptors for every keypoint; invalid keypoints (too few
    neighbours, all-sheet neighbourhoods) get mask=False."""
    M = min(cfg.max_neighbors, features.capacity)
    outs = []
    for c0 in range(0, keypoints.capacity, chunk):
        cx = keypoints.xyz[c0 : c0 + chunk]
        idx, valid = _nearest_features(cx, features.xyz, features.mask, M, cfg.radius_mm)
        nb_dirs = features.directions[idx]
        desc, direction, bidir, ok = _descriptors_chunk(
            cx, features.xyz[idx], nb_dirs[:, :, 0, :], nb_dirs[:, :, 1, :],
            features.strength[idx], features.shape[idx], valid, cfg,
        )
        outs.append((desc, direction, bidir, ok & keypoints.mask[c0 : c0 + chunk]))
    desc, direction, bidir, ok = (torch.cat(parts) for parts in zip(*outs))
    kps = KeypointSet(
        xyz=keypoints.xyz, strength=keypoints.strength, normal=direction, binormal=bidir, mask=ok
    )
    return DescriptorSet(keypoints=kps, descriptors=desc)

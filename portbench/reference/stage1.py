"""The plain reference of stage 1's descriptors, watershed regions and the
region-grown ROIs, written from their definitions in float64 (the control:
float32 with every product's operands rounded to TF32, the watershed in
bfloat16).  It imports nothing of the program.

  descriptors  oriented 3D shape contexts of 195 entries
               (itkDescriptorMeshFilter.txx): each keypoint's neighbours
               within the radius (the `max_neighbors` nearest), its frame
               from the strength-weighted non-sheet directions, each
               neighbour's flipped normal splatted 2 x 2 x 2 into (log
               radius, azimuth mod pi, elevation mod pi) bins, the bins
               turned into the keypoint frame, divided by the cube root of
               the wedge volume and normalised;
  watershed    WatershedSegmentation1.cxx's canonical `2.0 10 0.001 0.10`
               (the control: bfloat16, the precision below a stencil's float32):
               Perona-Malik diffusion (conductance 2, 10 steps of 1/16),
               central-difference gradient magnitude, the floor flooded at
               10 % of the height range, each voxel descending to its least
               6-neighbour (ties to the lower flat index, itself when none
               is lower or equal and lower-indexed), descent followed to
               its end, 8 rounds of the least label across neighbours of
               equal height, then followed again: a label is the flat index
               of its basin's bottom;
  regions      FeaturesInRegions (itkLocationRegistration.cxx:1363-1522):
               whole regions enter, nearest first, until the ROI holds the
               target count, never leaving the ROI box.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.plain import dtype_of as _dt, operand as _op

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


def _fold(v, ref, comp):
    """Angle of v's (x, comp) components in [0, 2 pi) relative to `ref`,
    folded to [0, pi)."""
    a = torch.remainder(torch.atan2(v[..., comp], v[..., 0]) + math.pi, TWO_PI)
    return torch.remainder(a - ref, TWO_PI).remainder(math.pi)


def _soft(frac, nbins, wrap, hi):
    """The reference's soft binning along one axis: the main bin floor(frac)
    (wrapped or clamped), its weight 1 - |frac - bin - 0.5| ... as
    (bin, weight, neighbour bin, weight)."""
    b = torch.floor(frac).long()
    b = torch.remainder(b, nbins) if wrap else b.clamp(0, hi)
    f = frac - (b.to(frac.dtype) - 0.5)
    up = f > 1.0
    w = torch.where(up, 2.0 - f, f)
    if wrap:
        nb = torch.where(up, torch.remainder(b + 1, nbins), torch.remainder(b - 1, nbins))
    else:
        nb = torch.where(up, (b + 1).clamp(max=hi), (b - 1).clamp(min=0))
    return b, w, nb, 1.0 - w


def _wedge_norms(radius_mm, R, O, dt, device):
    log_bin = math.log(radius_mm) / R
    out = [(4.0 / 3.0 * 3.1415 * math.exp(log_bin) ** 3) ** (1.0 / 3.0)]
    for i in range(1, R):
        big, small = math.exp((i + 1) * log_bin), math.exp(i * log_bin)
        out += [(4.0 / 3.0 * 3.1415 / (O * O) * (big**3 - small**3)) ** (1.0 / 3.0)] * (O * O)
    return torch.tensor(out, dtype=dt, device=device)


def descriptors(kp_xyz, fs: dict, cfg: dict, mode: str, chunk: int = 256):
    """(descriptor [K, 195], direction [K, 3], bidirection [K, 3], ok [K]) of
    keypoints [K, 3] in the features `fs` (xyz, strength, shape, directions,
    mask); ok: enough neighbours and a non-sheet one."""
    dt = _dt(mode)
    R, O = cfg["radius_bins"], cfg["orient_bins"]
    r_mm = cfg["radius_mm"]
    fx = fs["xyz"].to(dt)
    N = fx.shape[0]
    M = min(cfg["max_neighbors"], N)
    log_bin, ang_bin = math.log(r_mm) / R, math.pi / O
    nbins = (R + 1) * O * O
    norms = _wedge_norms(r_mm, R, O, dt, fx.device)
    out = []
    for k0 in range(0, kp_xyz.shape[0], chunk):
        kx = kp_xyz[k0 : k0 + chunk].to(dt)
        C = kx.shape[0]
        d2 = ((kx[:, None, :] - fx[None]) ** 2).sum(-1)
        d2 = torch.where(fs["mask"][None], d2, torch.full_like(d2, math.inf))
        near, idx = torch.sort(d2, dim=1, stable=True)
        near, idx = near[:, :M], idx[:, :M]
        valid = torch.isfinite(near) & (near <= r_mm * r_mm)
        nx = fx[idx]
        dirs = fs["directions"].to(dt)[idx]
        d0, d1 = dirs[..., 0, :], dirs[..., 1, :]
        w = torch.where(valid & (fs["shape"][idx] != 2), fs["strength"].to(dt)[idx],
                        torch.zeros_like(near))
        ok = (w.sum(1) > 0) & (valid.sum(1) >= cfg["min_neighbors"])
        direction = (w[..., None] * d0).sum(1)
        bidirection = (w[..., None] * d1).sum(1)
        direction = direction / torch.linalg.norm(direction, dim=1, keepdim=True).clamp(min=1e-12)
        bidirection = bidirection / torch.linalg.norm(bidirection, dim=1, keepdim=True).clamp(min=1e-12)
        n = torch.where(direction[:, 2:3] < 0, -direction, direction)
        b = torch.where(bidirection[:, 1:2] < 0, -bidirection, bidirection)
        frame = torch.stack([n, b, torch.linalg.cross(n, b)], 2)  # columns
        cv = kx[:, None, :] - nx
        radius = torch.linalg.norm(cv, dim=-1).clamp(min=1.0)
        az = _fold(cv, (torch.atan2(n[:, 1], n[:, 0]) + math.pi)[:, None], 1)
        el = _fold(cv, (torch.atan2(n[:, 2], n[:, 0]) + math.pi)[:, None], 2)
        rb, rw, rn, rnw = _soft(torch.log(radius) / log_bin, R + 1, False, R)
        ab, aw, an, anw = _soft(az / ang_bin, O, True, O - 1)
        eb, ew, en, enw = _soft(el / ang_bin, O, True, O - 1)
        pay = torch.where(d0[..., 2:3] < 0, -d0, d0) * valid[..., None]
        bins = torch.zeros(C, nbins, 3, dtype=dt, device=fx.device)
        for r_, wr in ((rb, rw), (rn, rnw)):
            for a_, wa in ((ab, aw), (an, anw)):
                for e_, we in ((eb, ew), (en, enw)):
                    t = (r_ * O + a_) * O + e_
                    bins.scatter_add_(1, t[..., None].expand(C, M, 3),
                                      (wr * wa * we * valid)[..., None] * pay)
        # into the keypoint frame: entry i of a bin is sum_j bin_j frame[i, j]
        bins = torch.einsum("cbj,cij->cbi", _op(bins, mode), _op(frame, mode))
        g = bins.reshape(C, R + 1, O * O, 3)
        flat = torch.cat([g[:, 0].sum(1, keepdim=True), g[:, 1:R].reshape(C, -1, 3)], 1)
        desc = (flat / norms[None, :, None]).reshape(C, -1)
        nrm = torch.linalg.norm(desc, dim=1, keepdim=True)
        desc = torch.where(nrm > 0, desc / nrm.clamp(min=1e-30), desc)
        out.append((desc, direction, bidirection, ok))
    return tuple(torch.cat(p) for p in zip(*out))


# ---------------------------------------------------------------------------
# watershed
# ---------------------------------------------------------------------------


def _sl(ax, a, b):
    s = [slice(None)] * 3
    s[ax] = slice(a, b)
    return tuple(s)


def watershed(vol: torch.Tensor, mode: str, conductance=2.0, iterations=10, time_step=0.0625,
              lower=0.001, level=0.10, sweeps=8) -> torch.Tensor:
    """int64 [D, H, W] basin labels (flat index of the basin's bottom).
    The control ("tf32") runs it in bfloat16: a stencil has no product that
    TF32 rounds, and the precision below its float32 is bfloat16."""
    dt = torch.float64 if mode == "f64" else torch.bfloat16
    v = vol.to(dt)
    k2 = conductance * conductance
    for _ in range(iterations):
        acc = torch.zeros_like(v)
        for ax in range(3):
            n = v.shape[ax]
            if n < 2:
                continue
            d = v[_sl(ax, 1, n)] - v[_sl(ax, 0, n - 1)]
            flux = torch.exp(-(d * d) / k2) * d
            acc[_sl(ax, 0, n - 1)] += flux
            acc[_sl(ax, 1, n)] -= flux
        v = v + time_step * acc
    g2 = torch.zeros_like(v)
    for ax in range(3):
        n = v.shape[ax]
        if n < 3:
            continue
        c = (v[_sl(ax, 2, n)] - v[_sl(ax, 0, n - 2)]) * 0.5
        g2[_sl(ax, 1, n - 1)] += c * c
    h = torch.sqrt(g2)
    hmin, hmax = h.min(), h.max()
    h = torch.maximum(h, hmin + max(lower, level) * (hmax - hmin))
    D, H, W = h.shape
    idx = torch.arange(D * H * W, device=h.device).reshape(D, H, W)
    best_h, best_i = h.clone(), idx.clone()
    for ax in range(3):
        n = h.shape[ax]
        for mine, theirs in (((1, n), (0, n - 1)), ((0, n - 1), (1, n))):
            bh, bi = best_h[_sl(ax, *mine)], best_i[_sl(ax, *mine)]
            nh, ni = h[_sl(ax, *theirs)], idx[_sl(ax, *theirs)]
            lower_nb = (nh < bh) | ((nh == bh) & (ni < bi))
            best_i[_sl(ax, *mine)] = torch.where(lower_nb, ni, bi)
            best_h[_sl(ax, *mine)] = torch.where(lower_nb, nh, bh)
    p = _follow(best_i.reshape(-1))
    lab = p.reshape(D, H, W)
    for _ in range(sweeps):
        new = lab.clone()
        for ax in range(3):
            n = h.shape[ax]
            eq = h[_sl(ax, 1, n)] == h[_sl(ax, 0, n - 1)]
            for mine, theirs in (((1, n), (0, n - 1)), ((0, n - 1), (1, n))):
                cur = new[_sl(ax, *mine)]
                new[_sl(ax, *mine)] = torch.where(eq, torch.minimum(cur, lab[_sl(ax, *theirs)]),
                                                  cur)
        lab = new
    return _follow(lab.reshape(-1)).reshape(D, H, W)


def _follow(p: torch.Tensor) -> torch.Tensor:
    """p <- p[p] until it stands."""
    while True:
        q = p[p]
        if bool((q == p).all()):
            return q
        p = q


def labels_at(labels: torch.Tensor, xyz: torch.Tensor, spacing) -> torch.Tensor:
    """The label of the voxel nearest each point [N, 3] (origin 0)."""
    D, H, W = labels.shape
    g = torch.round(xyz.double() / torch.as_tensor(spacing, dtype=torch.float64,
                                                   device=xyz.device))
    x = g[:, 0].clamp(0, W - 1).long()
    y = g[:, 1].clamp(0, H - 1).long()
    z = g[:, 2].clamp(0, D - 1).long()
    return labels[z, y, x]


def partition_miss(a: np.ndarray, b: np.ndarray) -> float:
    """The share of items outside their region's largest overlap with the
    other partition, the worse of the two directions: 0 when the two
    labellings group the items alike."""
    if a.size == 0:
        return 0.0
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    pair = ia.astype(np.int64) * (ib.max() + 1) + ib
    keys, counts = np.unique(pair, return_counts=True)
    ka, kb = keys // (ib.max() + 1), keys % (ib.max() + 1)
    best_a = np.zeros(ia.max() + 1, np.int64)
    np.maximum.at(best_a, ka, counts)
    best_b = np.zeros(ib.max() + 1, np.int64)
    np.maximum.at(best_b, kb, counts)
    return 1.0 - min(best_a.sum(), best_b.sum()) / a.size


# ---------------------------------------------------------------------------
# region-grown ROIs
# ---------------------------------------------------------------------------


def select_regions(xyz, mask, labels, q, target: int, lo, hi, max_mm: float = 100.0):
    """bool [L, N]: in-box features of the regions whose nearest in-box
    feature lies within the distance at which the target count is reached
    (at most `max_mm`) of each lane's point q [L, 3]."""
    x = xyz.double()
    sel = mask[None] & ((x[None] >= lo[:, None]) & (x[None] <= hi[:, None])).all(-1)
    d = torch.where(sel, torch.linalg.norm(x[None] - q[:, None].double(), dim=-1),
                    torch.full(sel.shape, math.inf, dtype=torch.float64, device=x.device))
    _, compact = torch.unique(labels, return_inverse=True)
    lab = compact.long()[None].expand_as(d)
    rmin = torch.full_like(d, math.inf).scatter_reduce(1, lab, d, "amin")
    rd = torch.where(sel, rmin.gather(1, lab), torch.full_like(d, math.inf))
    k = min(target, d.shape[1])
    tau = torch.kthvalue(rd, k, dim=1).values.clamp(max=max_mm)
    return sel & (rd <= tau[:, None])

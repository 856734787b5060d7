"""The plain reference of the PASS-2 lanes: the symmetric robust ICP of
each lane from its initial transform, the backward covariance and the 8
decision measurements (rrl's symmetric ICP and itkLocationRegistration.cxx:
1816-1871, 2824-2858), written straight from their definitions in float64,
one tensor a quantity, batched over lanes.  It imports nothing of the
program.

What it takes: the two feature sets and Voronoi index maps of the pair
(stage 1's outputs, which `judge.py` checks by themselves), each lane's
query, initial transform, ROI masks and random draws (the benchmark's
sampling plan).  A lane's match windows are the draws' windows of its
permutations, so the reference samples the same matches the program does;
from there every number is its own.

`mode` "f64" is the reference; "tf32" is the control: float32 with every
product's operands rounded to TF32 (`plain.tf32`), the card's tensor-core
arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.plain import dtype_of as _dt, operand as _op

BT_B2 = 16.0  # Beaton-Tukey b^2 (cdcl_utils.h:142-152)
WEIGHT_FLOOR = 1e-4  # symmetric .txx:469,576
SCALE_FLOOR = 0.005  # symmetric .txx:701,704
STRENGTH_CAP = 90000.0
MUSE_FRACTIONS = 41
SHEET, TUBE = 2, 1
PINV_RTOL = 10 * 12 * float(np.finfo(np.float32).eps)  # the configured float32's cut


def side(fs: dict, mode: str) -> dict:
    """A feature set as the ICP reads it, in `mode`'s type: xyz [N, 3],
    strength, shape, projector P [N, 3, 3], direction rows d0, d1, mask."""
    dt = _dt(mode)
    d = fs["directions"].to(dt)
    return {"xyz": fs["xyz"].to(dt), "strength": fs["strength"].to(dt),
            "shape": fs["shape"].long(), "P": fs["projector"].to(dt), "d0": d[:, 0],
            "d1": d[:, 1], "mask": fs["mask"].bool()}


# ---------------------------------------------------------------------------
# transforms y = A (x - c) + t
# ---------------------------------------------------------------------------


def apply(T, x: torch.Tensor, mode: str) -> torch.Tensor:
    """Points x [L, M, 3] under lane transforms T = (A, t, c)."""
    A, t, c = T
    return torch.einsum("lij,lmj->lmi", _op(A, mode), _op(x - c[:, None, :], mode)) \
        + t[:, None, :]


def inverse(T):
    A, t, c = T
    Ai = torch.linalg.inv_ex(A).inverse
    return Ai, c - torch.einsum("lij,lj->li", Ai, t), torch.zeros_like(c)


def is_valid(A: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Singular values of A within [lo, hi] (itkLocationRegistration.cxx:
    2914-2926)."""
    finite = torch.isfinite(A).flatten(1).all(1)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    s = torch.linalg.svdvals(torch.where(finite[:, None, None], A, eye).double())
    return finite & (s[:, -1] > lo) & (s[:, 0] < hi)


# ---------------------------------------------------------------------------
# matches
# ---------------------------------------------------------------------------


def permutation(scores: torch.Tensor, lane_mask: torch.Tensor):
    """Each lane's random order of its ROI features (lowest score first,
    ties to the lower index) and its ROI count."""
    s = torch.where(lane_mask, scores.double(), torch.full_like(scores, math.inf, dtype=torch.float64))
    return torch.sort(s, dim=1, stable=True).indices, lane_mask.sum(1)


def lookup(vor: dict, x: torch.Tensor) -> torch.Tensor:
    """Nearest-feature index of points x [..., 3] by the Voronoi index map:
    the voxel whose centre is nearest (half to even), clamped to the map;
    -1 for an empty voxel."""
    iv = vor["index"]
    D, H, W = iv.shape
    g = torch.round((x.double() - vor["origin"]) / vor["spacing"])
    g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
    xi = g[..., 0].clamp(0, W - 1).long()
    yi = g[..., 1].clamp(0, H - 1).long()
    zi = g[..., 2].clamp(0, D - 1).long()
    return iv.reshape(-1)[(zi * H + yi) * W + xi].long()


def sample(src: dict, order, valid, offset, number, cap: int, dst: dict, vor: dict, T,
           mode: str) -> dict:
    """One match window a lane: its permutation from `offset` (modulo its
    ROI count), the first min(number, ROI count, cap) positions, each
    source feature carried by T and matched to the target feature of its
    voxel.  Returns source and target indices [L, M] and the mask."""
    M = min(cap, order.shape[1])
    pos = torch.arange(M, device=order.device)
    v = valid.clamp(min=1)
    at = torch.remainder(torch.remainder(offset, v)[:, None] + pos[None], v[:, None])
    fi = order.gather(1, at)
    limit = torch.minimum(torch.minimum(number, valid), torch.full_like(valid, M))
    sel = (pos[None] < limit[:, None]) & src["mask"][fi]
    nn = lookup(vor, apply(T, src["xyz"][fi], mode))
    ti = nn.clamp(min=0)
    mask = sel & (nn >= 0) & dst["mask"][ti]
    return {"src": src, "dst": dst, "fi": fi, "ti": ti, "mask": mask,
            "w": mask.to(_dt(mode))}


def residual2(T, m: dict, mode: str) -> torch.Tensor:
    """e^T P e of each match, e = T(source) - target, P the target's."""
    e = apply(T, m["src"]["xyz"][m["fi"]], mode) - m["dst"]["xyz"][m["ti"]]
    P = m["dst"]["P"][m["ti"]]
    Pe = torch.einsum("lmij,lmj->lmi", _op(P, mode), _op(e, mode))
    return torch.clamp((e * Pe).sum(-1), min=0.0)


# ---------------------------------------------------------------------------
# robust statistics
# ---------------------------------------------------------------------------


def _masked_sorted(values, mask):
    big = torch.finfo(values.dtype).max
    return torch.sort(torch.where(mask, values, torch.full_like(values, big)), dim=-1).values


def muse_scale(absr: torch.Tensor, mask: torch.Tensor, fmin: float, fmax: float):
    """The minimum unbiased scale estimate over inlier fractions fmin..fmax
    (41 of them, as float32 fractions of the count): min over k of
    sqrt(sum_{i<=k} r_(i)^2 / sum_{i<=k} E[u_(i:n)^2]) of half-normal order
    statistics."""
    r = _masked_sorted(absr, mask)
    n = mask.sum(-1).clamp(min=2)
    cap = absr.shape[-1]
    dt = r.dtype
    i = torch.arange(1, cap + 1, dtype=dt, device=r.device)
    nf = n.to(dt)[..., None]
    p = i / (nf + 1.0)
    q = math.sqrt(2.0) * torch.special.erfinv(p.clamp(0.0, 0.999999))
    pdf = math.sqrt(2.0 / math.pi) * torch.exp(-0.5 * q * q)
    eu2 = q * q + p * (1.0 - p) / (nf + 2.0) * (1.0 + q * q) / (pdf * pdf).clamp(min=1e-12)
    row = i <= nf
    zero = torch.zeros((), dtype=dt, device=r.device)
    r2c = torch.cumsum(torch.where(row, r * r, zero), -1)
    eu2c = torch.cumsum(torch.where(row, eu2, zero), -1)
    fr = torch.as_tensor(np.linspace(fmin, fmax, MUSE_FRACTIONS).astype(np.float32),
                         device=r.device)
    ks = ((fr * n.to(torch.float32)[..., None]).to(torch.int64) - 1).clamp(1, cap - 1)
    s2 = r2c.gather(-1, ks) / eu2c.gather(-1, ks).clamp(min=1e-30)
    return torch.sqrt(s2.min(-1).values)


def mad_scale_dof(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 (1 + 5 / (n - 1)) times the upper median of |values|."""
    n = mask.sum(-1)
    v = _masked_sorted(values.abs(), mask)
    loc = (torch.div(n - 1, 2, rounding_mode="floor") + 1).clamp(0, values.shape[-1] - 1)
    med = v.gather(-1, loc[..., None])[..., 0]
    return 1.4826 * (1.0 + 5.0 / (n - 1).clamp(min=1).to(values.dtype)) * med


def _bt_weights(T, m: dict, use_muse: bool, cfg: dict, mode: str) -> dict:
    r2 = residual2(T, m, mode)
    mask = m["mask"]
    zero = torch.zeros_like(r2)
    if use_muse:
        s = muse_scale(torch.sqrt(r2), mask, cfg["muse_min_frac"], cfg["muse_max_frac"])
    else:
        s = torch.sqrt(torch.where(mask, r2, zero).sum(-1) / mask.sum(-1).clamp(min=1))
    s2 = (s.clamp(min=SCALE_FLOOR) ** 2)[:, None]
    u = r2 / s2
    w = torch.where(u <= BT_B2, (1.0 - u / BT_B2) ** 2, zero) / s2
    return {**m, "w": torch.where(mask, w, zero)}


def _masked_mean(x, mask):
    return (x * mask[..., None]).sum(1) / mask.sum(1).clamp(min=1)[:, None]


def weighted_matches(T, fwd: dict, bwd: dict, use_muse: bool, cfg: dict, mode: str):
    """The robust weights of both directions (symmetric .txx:698-728):
    Beaton-Tukey at the robust scale, the strength product over its MAD
    scale, the spatial falloff over its MAD scale, the floor.  Returns the
    weighted sets and the frame (cm, cf, rm, rf) of the forward matches."""
    fwd = _bt_weights(T, fwd, use_muse, cfg, mode)
    bwd = _bt_weights(inverse(T), bwd, use_muse, cfg, mode)
    fx = fwd["src"]["xyz"][fwd["fi"]]
    tx = fwd["dst"]["xyz"][fwd["ti"]]
    cm, cf = _masked_mean(fx, fwd["mask"]), _masked_mean(tx, fwd["mask"])
    rm = _masked_mean(torch.linalg.norm(fx - cm[:, None], dim=-1)[..., None], fwd["mask"])[:, 0]
    rf = _masked_mean(torch.linalg.norm(tx - cf[:, None], dim=-1)[..., None], fwd["mask"])[:, 0]
    rm, rf = rm.clamp(min=1e-6), rf.clamp(min=1e-6)

    def strength(m):
        gw = (m["src"]["strength"][m["fi"]] * m["dst"]["strength"][m["ti"]]).clamp(max=STRENGTH_CAP)
        nz = m["mask"] & (m["w"] != 0.0)
        w = torch.where(nz, m["w"] * gw, m["w"])
        return {**m, "w": w / mad_scale_dof(gw, nz).clamp(min=1e-30)[:, None]}

    def spatial(m, c, r):
        tn = (m["dst"]["xyz"][m["ti"]] - c[:, None]) / r[:, None, None]
        sw = 1.0 / (1.0 + cfg["spatial_falloff"] * (tn * tn).sum(-1))
        return {**m, "w": m["w"] * sw / mad_scale_dof(sw, m["mask"]).clamp(min=1e-30)[:, None]}

    fwd = spatial(strength(fwd), cf, rf)
    bwd = spatial(strength(bwd), cm, rm)
    for m in (fwd, bwd):
        m["w"] = torch.where(m["w"] >= WEIGHT_FLOOR, m["w"], torch.zeros_like(m["w"]))
    return fwd, bwd, (cm, cf, rm, rf)


# ---------------------------------------------------------------------------
# the least-squares step
# ---------------------------------------------------------------------------


def _system(frm, to, P, w, mode):
    """Normal equations [L, 12, 12], [L, 12] of sum_m w (Theta h - to)^T P
    (Theta h - to), h = [frm, 1], theta = vec_row([A | t])."""
    h = torch.cat([frm, torch.ones_like(frm[..., :1])], -1)
    L = h.shape[0]
    wP = w[..., None, None] * P
    AtA = torch.zeros(L, 3, 4, 3, 4, dtype=h.dtype, device=h.device)
    for k in range(3):
        for q in range(3):
            AtA[:, k, :, q, :] = torch.einsum(
                "lma,lmb->lab", _op(h * wP[..., k, q, None], mode), _op(h, mode))
    Pto = torch.einsum("lmkq,lmq->lmk", _op(P, mode), _op(to, mode))
    Atb = torch.einsum("lmk,lma->lka", _op(w[..., None] * Pto, mode), _op(h, mode))
    return AtA.reshape(L, 12, 12), Atb.reshape(L, 12)


def pinv_hermitian(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of symmetric [L, n, n], eigenvalues under PINV_RTOL of
    the largest cut; all-NaN for a matrix with a non-finite entry."""
    finite = torch.isfinite(a).flatten(1).all(1)
    w, V = torch.linalg.eigh(torch.where(finite[:, None, None], a, torch.zeros_like(a)))
    cut = PINV_RTOL * w.abs().max(-1, keepdim=True).values
    winv = torch.where(w.abs() > cut, 1.0 / torch.where(w == 0, torch.ones_like(w), w),
                       torch.zeros_like(w))
    out = (V * winv[:, None, :]) @ V.transpose(1, 2)
    return torch.where(finite[:, None, None], out, torch.full_like(out, math.nan))


def estimate(T, fwd: dict, bwd: dict, use_muse: bool, cfg: dict, mode: str):
    """One robust least-squares step (symmetric .txx:698-918): both
    directions constrain the forward parameters, in coordinates centred and
    scaled by the forward matches' frame.  Returns the new transform
    (centre 0), its parameter covariance and the weighted sets."""
    fwd, bwd, (cm, cf, rm, rf) = weighted_matches(T, fwd, bwd, use_muse, cfg, mode)

    def n_from(x):
        return (x - cm[:, None]) / rm[:, None, None]

    def n_to(x):
        return (x - cf[:, None]) / rf[:, None, None]

    a1, b1 = _system(n_from(fwd["src"]["xyz"][fwd["fi"]]), n_to(fwd["dst"]["xyz"][fwd["ti"]]),
                     fwd["dst"]["P"][fwd["ti"]], fwd["w"], mode)
    a2, b2 = _system(n_from(bwd["dst"]["xyz"][bwd["ti"]]), n_to(bwd["src"]["xyz"][bwd["fi"]]),
                     bwd["src"]["P"][bwd["fi"]], bwd["w"], mode)
    cov_n = pinv_hermitian(a1 + a2)
    theta = torch.einsum("lij,lj->li", _op(cov_n, mode), _op(b1 + b2, mode)).reshape(-1, 3, 4)
    s = (rf / rm)[:, None, None]
    A = s * theta[:, :, :3]
    t = rf[:, None] * theta[:, :, 3] + cf - torch.einsum("lij,lj->li", A, cm)
    Lm = torch.zeros(A.shape[0], 12, 12, dtype=A.dtype, device=A.device)
    for i in range(3):
        for j in range(3):
            Lm[:, 4 * i + j, 4 * i + j] = rf / rm
            Lm[:, 4 * i + 3, 4 * i + j] = -(rf / rm) * cm[:, j]
        Lm[:, 4 * i + 3, 4 * i + 3] = rf
    cov = Lm @ cov_n @ Lm.transpose(1, 2)
    return (A, t, torch.zeros_like(t)), cov, fwd, bwd


def weighted_error(T, m: dict, mode: str) -> torch.Tensor:
    w = torch.where(m["mask"], m["w"], torch.zeros_like(m["w"]))
    return (torch.sqrt(residual2(T, m, mode)) * w).sum(-1) / w.sum(-1).clamp(min=1e-30)


# ---------------------------------------------------------------------------
# the refinement of a lane
# ---------------------------------------------------------------------------


def _where(active, new, old):
    if isinstance(new, tuple):
        return tuple(_where(active, a, b) for a, b in zip(new, old))
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old)


def refine(lanes: dict, moving: dict, fixed: dict, mvor: dict, fvor: dict, cfg: dict,
           mode: str) -> dict:
    """The symmetric robust ICP of every lane (rrl symmetric ICP): iteration
    0 with the MUSE scale, then until converged, invalid or out of
    iterations; on convergence below the finest level the match count
    doubles (1000, 2000, ... up to the ROI's size), on oscillation the lane
    stops.  `lanes`: init (A, t, c), the ROI masks m_sel / f_sel and the
    draws.  Returns the final carry and the finishing statistics."""
    T = lanes["init"]
    L, dev = T[0].shape[0], T[0].device
    order_m, valid_m = permutation(lanes["icp_scores_m"], lanes["m_sel"])
    order_f, valid_f = permutation(lanes["icp_scores_f"], lanes["f_sel"])
    n_off = cfg["max_iterations"] + 1
    zf = torch.zeros(L, dtype=T[0].dtype, device=dev)
    zi = torch.zeros(L, dtype=torch.int64, device=dev)
    c = {"T": T, "cov": torch.zeros(L, 12, 12, dtype=T[0].dtype, device=dev), "we": zf,
         "we_b": zf, "diff": zf, "osc": zi, "number": zi + cfg["initial_matches"],
         "finest": zi.bool(), "it": zi, "conv": zi.bool(), "valid": ~zi.bool()}

    def body(c, use_muse):
        it = c["it"].clamp(max=n_off - 1)[:, None]
        fwd = sample(moving, order_m, valid_m, lanes["icp_offsets_f"].gather(1, it)[:, 0],
                     c["number"], cfg["max_matches"], fixed, fvor, c["T"], mode)
        bwd = sample(fixed, order_f, valid_f, lanes["icp_offsets_b"].gather(1, it)[:, 0],
                     c["number"], cfg["max_matches"], moving, mvor, inverse(c["T"]), mode)
        new_T, cov, fwd_w, bwd_w = estimate(c["T"], fwd, bwd, use_muse, cfg, mode)
        we = weighted_error(new_T, fwd_w, mode)
        we_b = weighted_error(inverse(new_T), bwd_w, mode)
        diff = we - c["we"]
        rate = diff / torch.where(we == 0, torch.full_like(we, 1e-30), we)
        conv = rate.abs() < cfg["convergence_tol"]
        osc = c["osc"]
        # oscillation (.txx:388-421), from iteration 1
        coarse_switch = (~c["finest"]) & ((osc > 1) | (rate.abs() < 0.01))
        osc1 = torch.where(diff * c["diff"] < 0.0, osc + 1, (osc - 1).clamp(min=0))
        osc2 = torch.where(diff > 0.0, osc + 1, osc)
        big = we > 1.5
        osc_new = torch.where(big, osc1, osc2)
        conv_osc = torch.where(big, osc1 > cfg["max_oscillations"], osc2 > 3)
        started = c["it"] > 0
        active = started & ~conv
        conv = conv | (started & coarse_switch)
        osc_new = torch.where(active & ~coarse_switch, osc_new, osc)
        conv = conv | (active & ~coarse_switch & conv_osc)
        # the match count doubles on convergence below the finest level (.txx:423-433)
        switch = conv & ~c["finest"]
        number = torch.where(switch, c["number"] * 2, c["number"])
        at_max = (number >= valid_m) & (number >= valid_f)
        finest = torch.where(switch, at_max, c["finest"])
        return {"T": new_T, "cov": cov, "we": we, "we_b": we_b,
                "diff": torch.where(switch, torch.zeros_like(diff), diff),
                "osc": torch.where(switch, torch.zeros_like(osc_new), osc_new),
                "number": number, "finest": finest, "it": c["it"] + 1,
                "conv": conv & ~switch & finest,
                "valid": is_valid(new_T[0], *cfg["singular_value_bounds"])}

    c = body(c, True)
    while True:
        act = (~c["conv"]) & (c["it"] < cfg["max_iterations"]) & c["valid"]
        if not bool(act.any()):
            break
        new = body(c, False)
        c = {k: _where(act, new[k], c[k]) for k in c}
    c["oscillated"] = c["osc"] > cfg["max_oscillations"]
    c["order_m"], c["valid_m"], c["order_f"], c["valid_f"] = order_m, valid_m, order_f, valid_f
    return c


def _norm_rows(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-12)


def angle_stats(T, m: dict, mode: str):
    """Weighted mean angle (radians, folded to [0, pi/2]) between mapped and
    matched sheet normals and tube tangents, [L] each."""
    A = T[0]
    s, d = m["src"], m["dst"]
    fi, ti = m["fi"], m["ti"]

    def mean_angle(p_dir, q_dir, pair):
        pm = _norm_rows(torch.einsum("lij,lmj->lmi", _op(A, mode), _op(p_dir, mode)))
        ang = torch.acos((pm * q_dir).sum(-1).clamp(-1.0, 1.0))
        ang = torch.where(ang > math.pi / 2, math.pi - ang, ang)
        w = torch.where(pair & m["mask"], m["w"], torch.zeros_like(m["w"]))
        return (w * ang).sum(-1) / w.sum(-1).clamp(min=1e-30)

    fs, ts = s["shape"][fi], d["shape"][ti]
    sheet = mean_angle(s["d0"][fi], d["d0"][ti], (fs == SHEET) & (ts == SHEET))
    p_tan = torch.linalg.cross(s["d0"][fi], s["d1"][fi])
    q_tan = _norm_rows(torch.linalg.cross(d["d0"][ti], d["d1"][ti]))
    tube = mean_angle(p_tan, q_tan, (fs == TUBE) & (ts == TUBE))
    return sheet, tube


def finish(c: dict, lanes: dict, moving: dict, fixed: dict, mvor: dict, fvor: dict, cfg: dict,
           mode: str) -> dict:
    """The final statistics pass at the final transform: fresh windows of
    the lanes' permutations at the final match count, the robust weights,
    the weighted mean angles of both directions."""
    T, inv = c["T"], inverse(c["T"])
    fwd = sample(moving, c["order_m"], c["valid_m"], lanes["icp_stats_offset_f"], c["number"],
                 cfg["max_matches"], fixed, fvor, T, mode)
    bwd = sample(fixed, c["order_f"], c["valid_f"], lanes["icp_stats_offset_b"], c["number"],
                 cfg["max_matches"], moving, mvor, inv, mode)
    fwd, bwd, _ = weighted_matches(T, fwd, bwd, False, cfg, mode)
    sheet_f, tube_f = angle_stats(T, fwd, mode)
    sheet_b, tube_b = angle_stats(inv, bwd, mode)
    return {"sheet_f": sheet_f, "tube_f": tube_f, "sheet_b": sheet_b, "tube_b": tube_b}


def backward_covariance(c: dict, lanes: dict, moving: dict, fixed: dict, mvor: dict, fvor: dict,
                        cfg: dict, mode: str) -> torch.Tensor:
    """[L, 12, 12] covariance of the backward transform's parameters: one
    least-squares step about the inverse transform with the directions
    swapped, on fresh windows at the final match count."""
    T, inv = c["T"], inverse(c["T"])
    order_f, valid_f = permutation(lanes["cov_scores_f"], lanes["f_sel"])
    order_m, valid_m = permutation(lanes["cov_scores_m"], lanes["m_sel"])
    fwd = sample(fixed, order_f, valid_f, lanes["cov_offset_b"], c["number"], cfg["max_matches"],
                 moving, mvor, inv, mode)
    bwd = sample(moving, order_m, valid_m, lanes["cov_offset_f"], c["number"],
                 cfg["max_matches"], fixed, fvor, T, mode)
    _, cov, _, _ = estimate(inv, fwd, bwd, False, cfg, mode)
    return cov


def max_transfer_trace(T, cov: torch.Tensor, start: torch.Tensor, roi_mm: float, mode: str,
                       interval_mm: float = 5.0) -> torch.Tensor:
    """[L] the largest trace of J C J^T, the transfer error covariance, over
    the grid of `interval_mm` from `start` across `roi_mm`."""
    n = max(int(roi_mm // interval_mm) + 1, 2)
    ax = torch.arange(n, dtype=cov.dtype, device=cov.device) * interval_mm
    g = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = start[:, None, :] + g[None]
    h = torch.cat([pts - T[2][:, None, :], torch.ones_like(pts[..., :1])], -1)
    Cb = cov.reshape(-1, 3, 4, 3, 4)
    blocks = Cb[:, 0, :, 0, :] + Cb[:, 1, :, 1, :] + Cb[:, 2, :, 2, :]
    hb = torch.einsum("lpj,ljk->lpk", _op(h, mode), _op(blocks, mode))
    return (hb * h).sum(-1).max(1).values


def measurements(c: dict, stats: dict, cov_b: torch.Tensor, roi_moving_start, roi_fixed_start,
                 roi_mm: float, mode: str) -> torch.Tensor:
    """[L, 8] = [max we, max max-trace, max sheet deg, max tube deg, min we,
    min max-trace, min sheet deg, min tube deg] over the two directions
    (itkLocationRegistration.cxx:1857-1868)."""
    tr_f = max_transfer_trace(c["T"], c["cov"], roi_moving_start, roi_mm, mode)
    tr_b = max_transfer_trace(inverse(c["T"]), cov_b, roi_fixed_start, roi_mm, mode)
    deg = 180.0 / math.pi
    pairs = [(c["we"], c["we_b"]), (tr_f, tr_b), (stats["sheet_f"] * deg, stats["sheet_b"] * deg),
             (stats["tube_f"] * deg, stats["tube_b"] * deg)]
    return torch.stack([torch.maximum(a, b) for a, b in pairs]
                       + [torch.minimum(a, b) for a, b in pairs], -1)


def lanes_result(lanes: dict, moving_fs: dict, fixed_fs: dict, mvor: dict, fvor: dict, cfg: dict,
                 mode: str) -> dict:
    """Refinement, finishing pass, backward covariance and measurements of
    every lane: {A, t, c, covar, meas, valid, oscillated, number}."""
    moving, fixed = side(moving_fs, mode), side(fixed_fs, mode)
    dt = _dt(mode)
    lanes = {**lanes, "init": tuple(x.to(dt) for x in lanes["init"])}
    vors = [{**v, "origin": v["origin"].double(), "spacing": v["spacing"].double()}
            for v in (mvor, fvor)]
    c = refine(lanes, moving, fixed, *vors, cfg, mode)
    stats = finish(c, lanes, moving, fixed, *vors, cfg, mode)
    cov_b = backward_covariance(c, lanes, moving, fixed, *vors, cfg, mode)
    half = cfg["roi_mm"] / 2.0
    meas = measurements(c, stats, cov_b, lanes["init"][2] - half, lanes["query"].to(dt) - half,
                        cfg["roi_mm"], mode)
    A, t, ctr = c["T"]
    return {"A": A, "t": t, "c": ctr, "covar": c["cov"], "meas": meas, "valid": c["valid"],
            "oscillated": c["oscillated"], "number": c["number"], "iterations": c["it"]}

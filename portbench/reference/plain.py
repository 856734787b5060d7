"""The plain reference: what the program computes, worked out again in plain
PyTorch and NumPy, in float64, with no kernel, no cache and no batching
trick of the program.  It imports nothing of the program.

Each function takes the benchmark's inputs (queries, the verifier file) and,
where the reference can only follow the program from its own state, the
state the stage before produced (feature and keypoint sets, descriptors);
`judge.py` says which.  `mode` is "f64" for the reference itself and "tf32"
for the control: the same arithmetic in float32 with every matrix
product's operands rounded to TF32 (10-bit mantissa, float32 sums), as the
card's tensor cores compute a float32 product when TF32 is allowed.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (nearest, ties away from zero)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f64":
        return a.double() @ b.double()
    with no_tf32():
        return tf32(a) @ tf32(b)


class no_tf32:
    """The library's own TF32 off around a product whose operands were
    rounded by hand, so the control's precision does not depend on a flag."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def dtype_of(mode: str):
    return torch.float64 if mode == "f64" else torch.float32


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand of a product in `mode`: rounded to TF32 in the control."""
    return tf32(x) if mode == "tf32" else x


def sq_dists(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """[n, m] squared distances |a_i - b_j|^2 by the expansion
    |a|^2 + |b|^2 - 2 a.b (the product in `mode`'s precision)."""
    dt = dtype_of(mode)
    a, b = a.to(dt), b.to(dt)
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * _mm(a, b.T, mode).to(dt)


# ---------------------------------------------------------------------------
# stage 1: the descriptor-NN table and the Voronoi maps
# ---------------------------------------------------------------------------


def nn_table(desc_f: torch.Tensor, desc_m: torch.Tensor, mask_m: torch.Tensor, mode: str,
             block: int = 1024):
    """For every fixed descriptor its nearest valid moving one:
    (index [Kf] int64, distance [Kf])."""
    idx, dist = [], []
    for i in range(0, desc_f.shape[0], block):
        d2 = sq_dists(desc_f[i : i + block], desc_m, mode)
        d2 = torch.where(mask_m[None, :], d2, torch.full_like(d2, math.inf))
        v, j = d2.min(1)
        idx.append(j)
        dist.append(torch.sqrt(torch.clamp(v, min=0)))
    return torch.cat(idx), torch.cat(dist)


def nearest_feature(points: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, mode: str,
                    block: int = 4096) -> torch.Tensor:
    """[V] index of the nearest valid feature to each point (the Voronoi
    map's answer at those points), -1 where no feature is valid."""
    if not bool(mask.any()):
        return torch.full((points.shape[0],), -1, dtype=torch.int64, device=points.device)
    out = []
    for i in range(0, points.shape[0], block):
        d2 = sq_dists(points[i : i + block], xyz, mode)
        d2 = torch.where(mask[None, :], d2, torch.full_like(d2, math.inf))
        out.append(d2.argmin(1))
    return torch.cat(out)


def voxel_centres(vox_zyx: torch.Tensor, origin: torch.Tensor, spacing: torch.Tensor):
    """Physical (x, y, z) float64 of voxel indices [V, 3] given as (z, y, x)."""
    return origin.double() + vox_zyx.flip(1).double() * spacing.double()


# ---------------------------------------------------------------------------
# PASS 1: candidates and initial transforms
# ---------------------------------------------------------------------------


def candidates(queries: torch.Tensor, kp_xyz: torch.Tensor, kp_mask: torch.Tensor,
               nn_dist: torch.Tensor, radius_mm: float, max_query_keypoints: int,
               num_candidates: int):
    """Per query the fixed keypoints it draws its candidates from: the
    `max_query_keypoints` nearest valid ones within `radius_mm`, of which
    the `num_candidates` with the least descriptor-NN distance.  Returns
    (fixed index [Q, C] int64, key = NN distance [Q, C] float64, valid [Q, C]);
    ties go to the lower index (stable sorts)."""
    q = queries.double()
    d2 = ((q[:, None, :] - kp_xyz.double()[None]) ** 2).sum(-1)
    near = kp_mask[None, :] & (d2 <= radius_mm**2)
    kq = min(max_query_keypoints, d2.shape[1])
    key = torch.where(near, d2, torch.full_like(d2, math.inf))
    order = torch.sort(key, dim=1, stable=True).indices[:, :kq]
    ok = torch.isfinite(key.gather(1, order))
    dd = torch.where(ok, nn_dist.double()[order], torch.full_like(order, math.inf, dtype=torch.float64))
    kc = min(num_candidates, kq)
    pick = torch.sort(dd, dim=1, stable=True).indices[:, :kc]
    fidx = order.gather(1, pick)
    dsel = dd.gather(1, pick)
    return fidx, dsel, torch.isfinite(dsel)


def _frame(normal: torch.Tensor, binormal: torch.Tensor) -> torch.Tensor:
    return torch.stack([normal, binormal, torch.linalg.cross(normal, binormal)], dim=-1)


def query_in_moving(query: torch.Tensor, xf: torch.Tensor, nf: torch.Tensor, bf: torch.Tensor,
                    xm: torch.Tensor, nm: torch.Tensor, bm: torch.Tensor, mode: str):
    """The query carried into moving space by the keypoint-frame transform
    of a (fixed, moving) keypoint pair: R = Rf Rm^-1 aligns the frames, the
    translation carries the moving keypoint onto the fixed one, so
    q_m = R^-1 (q - x_f) + x_m.  Batched over leading dims."""
    dt = dtype_of(mode)
    Rf = _frame(nf.to(dt), bf.to(dt))
    Rm = _frame(nm.to(dt), bm.to(dt))
    n = Rf.shape[:-2]
    R = _mm(Rf.reshape(-1, 3, 3), torch.linalg.inv(Rm).reshape(-1, 3, 3), mode).to(dt)
    rhs = (query.to(dt) - xf.to(dt)).reshape(-1, 3, 1)
    return torch.linalg.solve(R, rhs).reshape(*n, 3) + xm.to(dt)


def initial_transform(query, xf, nf, bf, xm, nm, bm, mode: str):
    """A candidate's initial transform (A, t, c) [L]: A = Rf Rm^-1 aligns
    the keypoint frames; centred on the query carried into moving space,
    qm, it carries qm to qm + (x_f - x_m)."""
    dt = dtype_of(mode)
    R = _mm(_frame(nf.to(dt), bf.to(dt)), torch.linalg.inv(_frame(nm.to(dt), bm.to(dt))),
            mode).to(dt)
    qm = query_in_moving(query, xf, nf, bf, xm, nm, bm, mode)
    return R, qm + xf.to(dt) - xm.to(dt), qm


# ---------------------------------------------------------------------------
# the decision measurements' transfer-error trace
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# verification: the SVM and the early-exit selection
# ---------------------------------------------------------------------------

# the measurement scaling the reference program hard-codes
# (itkLocationRegistration.cxx:2107-2109)
FEATURE_MIN = np.array([0.823246, 0.17355, 13.5656, 14.8583, 0.776814, 0.124, 10.3695, 13.049])
FEATURE_MAX = np.array([16.1025, 139.276, 62.7776, 63.5239, 1.64664, 60.897, 59.8739, 60.8141])


def read_libsvm(path: str) -> dict:
    """A 2-class RBF C-SVC with Platt outputs from libsvm's text format:
    {gamma, rho, sv [N, 8], coef [N], prob_a, prob_b}."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    head, i = {}, 0
    while lines[i].strip() != "SV":
        parts = lines[i].split(None, 1)
        if parts:
            head[parts[0]] = parts[1] if len(parts) > 1 else ""
        i += 1
    coef, rows = [], []
    for line in lines[i + 1 :]:
        parts = line.split()
        if not parts:
            continue
        coef.append(float(parts[0]))
        row = np.zeros(8)
        for p in parts[1:]:
            k, v = p.split(":")
            row[int(k)] = float(v)
        rows.append(row)
    if head.get("kernel_type") != "rbf" or head.get("label", "1 -1").split()[0] != "1":
        raise ValueError(f"{path}: not a 2-class RBF model with label 1 first")
    return {"gamma": float(head["gamma"]), "rho": float(head["rho"].split()[0]),
            "sv": np.asarray(rows), "coef": np.asarray(coef),
            "prob_a": float(head["probA"].split()[0]), "prob_b": float(head["probB"].split()[0])}


def svm_probability(model: dict, meas: torch.Tensor, mode: str) -> torch.Tensor:
    """P(aligned) [N] of measurement rows [N, 8]: scaled to [-1, 1] by the
    fixed ranges, RBF decision value, Platt sigmoid."""
    dt = dtype_of(mode)
    dev = meas.device
    lo = torch.as_tensor(FEATURE_MIN, dtype=dt, device=dev)
    hi = torch.as_tensor(FEATURE_MAX, dtype=dt, device=dev)
    x = -1.0 + 2.0 * (meas.to(dt) - lo) / (hi - lo)
    sv = torch.as_tensor(model["sv"], dtype=dt, device=dev)
    coef = torch.as_tensor(model["coef"], dtype=dt, device=dev)
    d2 = torch.clamp(sq_dists(x, sv, mode), min=0.0)
    f = torch.exp(-model["gamma"] * d2) @ coef - model["rho"]
    fab = model["prob_a"] * f + model["prob_b"]
    return torch.where(fab >= 0, torch.exp(-fab) / (1.0 + torch.exp(-fab)),
                       1.0 / (1.0 + torch.exp(fab)))


def early_exit_selection(rank: np.ndarray, usable: np.ndarray, refined: np.ndarray,
                         verified: np.ndarray) -> np.ndarray:
    """[Q] the candidate each query selects under the staged early exit:
    walking its ranks in order, the first verified candidate; -1 at the
    first candidate that is not usable, or when none verifies.  A usable
    candidate reached before any verified one and never refined is a fault
    of the serving loop: -2."""
    Q, C = rank.shape
    out = np.full(Q, -1, np.int64)
    for q in range(Q):
        for pos in range(C):
            c = rank[q, pos]
            if not usable[q, c]:
                break
            if not refined[q, c]:
                out[q] = -2
                break
            if verified[q, c]:
                out[q] = c
                break
    return out

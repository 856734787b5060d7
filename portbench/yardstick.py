"""The benchmark's fixed arithmetic: the table of peaks, the kernels' least
times, the ground-truth error, and the reduction of a profiler trace.

Copied and frozen from the program's sources so that a later change to the
program cannot move the yardstick:
  - `k1_bytes`: `lrr_tpu_torch/utils/sol.py::k1_bound_ms`'s bytes (11
    floats a match, the frame, the system written once); its operation
    count needs each match's weight, which a trace does not hold, and at
    225 flops a match against 44 bytes the bytes bound is the larger
    (3.9x) on this card;
  - `k3_bound_ms`: `chip_smoke.py::pinv_bound_ms` (inputs alone);
  - `gt_errors_mm`: `chip_smoke.py::query_errors` / `gt_errors` (20 probes
    uniform in +-15 mm around the query, `default_rng(q)`, the median).
The peaks are the H100 SXM data sheet's (dense rates, 700 W).

A kernel's least time by its bytes (`least_bytes_ms`) holds wherever its
inputs sit: up to the L2's 50 MB of them may come from the L2 (K1 and K3
read what the kernels just before them wrote), and no byte reaches the
SMs faster than their load path carries it, 128 bytes a clock an SM at
the boost clock; only the bytes beyond the L2 must come from HBM.
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_HBM_GBS = 3350.0
PEAK_F32_TFLOPS = 67.0
L2_BYTES = 50 * 2**20
SMS, SM_LOAD_BYTES_PER_CLOCK, BOOST_GHZ = 132, 128, 1.98
PEAK_ONCHIP_GBS = SMS * SM_LOAD_BYTES_PER_CLOCK * BOOST_GHZ  # 33,454 GB/s


def least_bytes_ms(nbytes: float) -> float:
    """The least time (ms) to move `nbytes` through the SMs when up to
    L2_BYTES of them may already sit in the L2."""
    on_chip = nbytes / (PEAK_ONCHIP_GBS * 1e9)
    from_hbm = max(0.0, nbytes - L2_BYTES) / (PEAK_HBM_GBS * 1e9)
    return max(on_chip, from_hbm) * 1e3


def k1_bytes(L: int, m_f: int, m_b: int) -> int:
    """Bytes K1 reads and writes at (L lanes, m_f + m_b matches)."""
    return 4 * (L * (m_f + m_b) * 11 + L * 11 + L * 156)


def k1_bound_ms(L: int, m_f: int, m_b: int) -> float:
    """K1's least time for one launch."""
    return least_bytes_ms(k1_bytes(L, m_f, m_b))


def k3_bound_ms(L: int, n: int) -> float:
    """K3's least time for one launch at L matrices of n x n: the larger of
    the matrices read and written once and 10 n^3 float32 operations a
    matrix at the float32 peak."""
    t_ops = L * 10 * n**3 / (PEAK_F32_TFLOPS * 1e12) * 1e3
    return max(least_bytes_ms(2 * L * n * n * 4), t_ops)


def apply_affine(A, t, c, x):
    """y = A (x - c) + t, float64 numpy, batched over x's leading dims."""
    return np.einsum("...ij,...j->...i", A, x - c) + t


def gt_errors_mm(A: np.ndarray, t: np.ndarray, c: np.ndarray, queries: np.ndarray,
                 true, ids=None) -> np.ndarray:
    """[Q] median error (mm) over 20 probes around each query of the
    transforms (A [Q, 3, 3], t [Q, 3], c [Q, 3]) against the true one
    (A, t, c) mapping moving -> fixed; the probes are fixed-space points,
    carried into moving space by the inverse of the truth.  `ids[k]` (by
    default k) is query k's index in its request, which seeds its probes."""
    TA, Tt, Tc = (np.asarray(v, np.float64) for v in true)
    inv = np.linalg.inv(TA)
    out = np.empty(len(queries))
    for q in range(len(queries)):
        probe = queries[q][None, :] + np.random.default_rng(q if ids is None else int(ids[q])).uniform(
            -15, 15, (20, 3)).astype(np.float32)
        src = (probe.astype(np.float64) - Tt) @ inv.T + Tc
        got = apply_affine(np.asarray(A[q], np.float64), np.asarray(t[q], np.float64),
                           np.asarray(c[q], np.float64), src)
        out[q] = float(np.median(np.linalg.norm(got - (src - Tc) @ TA.T - Tt, axis=1)))
    return out


# ---------------------------------------------------------------------------
# profiler trace
# ---------------------------------------------------------------------------


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (any units)."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_kernels(prof, annotation: str = "portbench.") -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of every device kernel and memory operation
    in a `torch.profiler.profile`'s trace.  The profiler mirrors each host
    range (`record_function`) onto the device's timeline as an annotation
    that spans its kernels; those, named `annotation`..., are not work."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start \
                and not e.name.startswith(annotation):
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def cpu_ranges(prof, name: str) -> list[tuple[float, float]]:
    """(start_us, end_us) of every host range called `name`
    (`torch.profiler.record_function`)."""
    return [(float(e.time_range.start), float(e.time_range.end)) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.name == name]


def top_ops(kernels, k: int = 10) -> list[list]:
    """The `k` device operations that took most time: [[name, seconds]]."""
    by = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(kernels, labels: list[tuple[str, float, float]], window, k: int = 10):
    """The `k` longest device gaps in `window` (start_us, end_us), each named
    by the host range ("label") that held its midpoint: [[name, seconds]]."""
    iv = sorted((s, e) for _, s, e in kernels)
    gaps, cur = [], window[0]
    for s, e in iv + [(window[1], window[1])]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        mid = 0.5 * (s + e)
        name = next((n for n, a, b in labels if a <= mid < b), "host")
        out.append([name, (e - s) * 1e-6])
    return out

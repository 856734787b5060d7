"""Speed-of-light accounting of the port's hot paths on the card
(lrr_tpu/utils/sol.py).

Each figure sets a measured time against the least time the card could take
for the same work, so that "fast" is a number and not a claim.

`icp_iteration_sol` times one whole symmetric ICP iteration over a wave of
candidate lanes, the unit the serving path repeats 50-70 times a wave: the
port's own `_sample_matches_packed` (a window of each lane's source rows,
mapped, matched through the bare Voronoi map and the target rows, both
directions; kernel K5 on the card) chained into `_estimate_ls_packed` (robust weighting, then K1 and
the 12x12 solve).  Iterations are dependent: each feeds its transform to the
next, as in the serving loop.  A sampling-only ablation splits the iteration
into its gather and estimate segments.  The inputs are lrr_tpu's synthetic
ones, drawn from one numpy seed in lrr_tpu's order, so both packages time the
same work.

The light bound counts only the traffic and operations the iteration must
do, per lane and direction: the window of `cap` source rows and the `cap`
random map reads (a 32-byte sector each), and the normal-equation operations
(`_flops_min`).  Robust weighting (sorts, medians) is real work outside the
bound, so `fraction_of_light` is a conservative figure for the whole
iteration.  The random gather is priced at the card's measured random-row
rate (`measured_gather_roofline`), the window at the streaming peak;
`light_ms_streaming_peak` prices both at the streaming peak.

The port launches every iteration from the host (about a thousand launches
each), where lrr_tpu ran the loop inside one compiled program.
`device_ms_per_iter`, the summed time of the device's kernels in the timed
loop (`torch.profiler`), tells the kernels' own distance to light from the
host's share of the iteration.

`sample_matches_bound_ms` is K5's least time by bytes over the distinct
map sectors and target rows its windows read; `robust_bound_ms` and
`weighted_error_bound_ms` are K6's by the bytes of the match columns its
two entry points read and write.

`kernel_sol_report` gives the iteration at lrr_tpu's two wave shapes and the
195-d descriptor nearest neighbour at 4096 x 4096 through K2, with the
matmul expansion + argmin in PyTorch beside it for contrast (library calls,
not the port's path: the expansion cancels, K2 is exact).

Peaks: NVIDIA's H100 SXM data sheet at its 700 W power limit (67 TFLOP/s
fp32 outside the tensor cores, 495 TFLOP/s TF32, 3,350 GB/s), overridable
by LRR_PEAK_F32_TFLOPS and LRR_PEAK_HBM_GBS.  A card set below 700 W runs
under them; state the card's power limit beside every share.

Timing: the slope between two loop lengths (`_time_fn_slope`), each run
ended by `torch.cuda.synchronize()`, so the fixed cost of starting and
ending a run cancels.  Entry points take `device=None` to mean the card and
raise without one; on the CPU they run (the tests do), nothing is measured
of the card, and the bound takes the streaming peak.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from lrr_tpu_torch.config import EstimationConfig
from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.types import resolve_device

PEAK_F32_TFLOPS = float(os.environ.get("LRR_PEAK_F32_TFLOPS", "67.0"))
PEAK_HBM_GBS = float(os.environ.get("LRR_PEAK_HBM_GBS", "3350.0"))
PEAK_TF32_TFLOPS = 495.0  # tensor cores, dense (the data sheet's TF32 rate)

K1_FLOP_PER_MATCH = 225  # normalise 15, P 15, w*P^T P 36, h h^T 6, AtA 114, Atb 39
ROW_BYTES = 32  # one packed row, [8] float32 (estimation/icp.py)
DESC_DIM = 195


# ---------------------------------------------------------------------------
# bounds of the kernels, over the published peaks
# ---------------------------------------------------------------------------


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and fp32 operations over the compute rate."""
    by_bytes = nbytes / (PEAK_HBM_GBS * 1e9) * 1e3
    by_ops = ops / (PEAK_F32_TFLOPS * 1e12) * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k1_bound_ms(fwd, bwd) -> tuple[float, str]:
    """K1's least time for one call on directions `fwd`, `bwd` (as
    `kernels.normal_equations_sym` takes them): each input element read
    once (11 floats a match, the frame), the system written once, and the
    operations these weights need (w <= 0 is skipped)."""
    L = fwd[4].shape[0]
    matches = fwd[4].shape[1] + bwd[4].shape[1]
    nbytes = 4 * (L * matches * 11 + L * 11 + L * 156)
    flop = K1_FLOP_PER_MATCH * (int((fwd[4] > 0).sum()) + int((bwd[4] > 0).sum()))
    return _bound(nbytes, flop)


def knn_bound_ms(q_n: int, p_n: int, dim: int, k: int, live: int) -> tuple[float, str]:
    """K2's least time for `q_n` queries against `p_n` points of `dim`
    floats, `live` of them unmasked: both tables and the mask read once, k
    (distance, index) pairs written a query, and a subtract, a multiply and
    an add for each query, live point and component."""
    return _bound(4 * dim * (q_n + p_n) + p_n + 8 * q_n * k, 3 * q_n * live * dim)


def voronoi_bound_ms(n_vox: int, n: int, pairs: int) -> tuple[float, str]:
    """K4's least time for a map of `n_vox` voxels over `n` features in
    which it evaluated `pairs` voxel-candidate pairs: the features and mask
    read and the int32 map written once, and the plain distance's 8 fp32
    operations (3 subtracts, 3 multiplies, 2 adds) a pair evaluated."""
    return _bound(13 * n + 24 + 4 * n_vox, 8 * pairs)


# a window position's bytes that K5 must move: its permutation entry (8)
# read, its two rows (2 x 32), weight (4) and mask byte written
SAMPLE_POSITION_BYTES = 8 + 2 * ROW_BYTES + 4 + 1


def sample_matches_bound_ms(lanes: int, m: int, n_src: int, target_reads: int,
                            gather_gb_s: float | None = None) -> tuple[float, str]:
    """K5's least time for `lanes` x `m` window positions over a source
    table of `n_src` rows whose matches make `target_reads` distinct 32-byte
    target reads (the map sectors, at most one a match, and the feature rows
    they name): every position's `SAMPLE_POSITION_BYTES`, the source table
    and each distinct target read moved once, at the streaming peak (the
    lane-mask bytes, at most one a position, are left out).  With
    `gather_gb_s` the target reads are priced at that random-row rate
    instead (`measured_gather_roofline`'s, PyTorch's own gathers): what the
    reads would cost if no two positions shared a sector's neighbourhood, a
    yardstick K5 can beat, not a bound."""
    stream = lanes * m * SAMPLE_POSITION_BYTES + n_src * ROW_BYTES
    rate = PEAK_HBM_GBS if gather_gb_s is None else gather_gb_s
    ms = (target_reads * ROW_BYTES / (rate * 1e9) + stream / (PEAK_HBM_GBS * 1e9)) * 1e3
    return ms, "bytes"


def _row_sectors(stride: int, cols: int) -> float:
    """The 32-byte sectors a match moves to read columns [0, cols) of its
    row of `stride` floats (rows from a sector-aligned table), averaged over
    the rows' offsets."""
    return sum(len({(4 * (stride * j + c)) // 32 for c in range(cols)}) for j in range(8)) / 8


# a match's bytes that K6 must read, in whole sectors of its two rows: the
# source's (x, y, z, strength), the target's eight columns
def _robust_match_bytes(stride: int) -> float:
    return 32 * (_row_sectors(stride, 4) + _row_sectors(stride, 8))


def robust_bound_ms(L: int, m_f: int, m_b: int, stride: int) -> tuple[float, str]:
    """K6's weights' least time for `L` lanes of `m_f` + `m_b` matches whose
    rows hold `stride` floats: each match's row columns
    (`_robust_match_bytes`) and mask byte read once and its weight written
    once; each lane's two transforms read and its frame written, at the
    streaming peak."""
    nbytes = L * (m_f + m_b) * (_robust_match_bytes(stride) + 1 + 4) + 4 * L * (2 * 15 + 8)
    return nbytes / (PEAK_HBM_GBS * 1e9) * 1e3, "bytes"


def weighted_error_bound_ms(L: int, m_f: int, m_b: int, stride: int) -> tuple[float, str]:
    """K6's weighted errors' least time: each match's row columns, mask byte
    and weight read once, each lane's two transforms read and two errors
    written, at the streaming peak."""
    nbytes = L * (m_f + m_b) * (_robust_match_bytes(stride) + 1 + 4) + 4 * L * (2 * 15 + 2)
    return nbytes / (PEAK_HBM_GBS * 1e9) * 1e3, "bytes"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn_slope(run, k_lo: int, k_hi: int, device: torch.device, reps: int = 3) -> float:
    """Seconds a repeat, from the slope between `run(k_lo)` and `run(k_hi)`
    (each the best of `reps` after a warm-up), every run ended by a
    synchronise."""
    ts = {}
    for K in (k_lo, k_hi):
        run(K)
        _sync(device)
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            run(K)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        ts[K] = best
    return max((ts[k_hi] - ts[k_lo]) / (k_hi - k_lo), 1e-9)


def _device_ms(run, K: int, device: torch.device) -> float | None:
    """Summed milliseconds of the device's kernels over `run(K)`, a repeat;
    None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    run(K)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(K)
        _sync(device)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time on the card")
    return us / K / 1e3


SPIN_CYCLES = 10_000_000  # ~5 ms of a spinning kernel: longer than the host takes to queue


def _event_ms(fn, reps: int) -> float:
    """Milliseconds a call of `fn` on the card, between two CUDA events
    around `reps` calls in a row (after a warm-up).  A spinning kernel is
    queued first, so the host has queued every call before the device
    reaches them: the events bracket device time, not the host's launches."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# the card's random-access ceilings
# ---------------------------------------------------------------------------

_ROOFLINE: dict[str, dict] = {}
GATHER_ROWS = 64 * 2 * 4096  # rows an iteration of the bench wave gathers
COPY_ROWS = 8 * 1024 * 1024  # 256 MB: a copy that the 50 MB L2 cannot hold
# the two working sets (lrr_tpu's measurement's 2M- and 61M-voxel maps)
GATHER_VOXELS = {"gather_gb_s_padded_small": 2 * 1024 * 1024,
                 "gather_gb_s_dense_big": 63_963_136}


def measured_gather_roofline(device=None) -> dict | None:
    """The card's random-access ceilings, measured in this process with CUDA
    events and kept for the process; None on the CPU (nothing measured).

    `gather_gb_s_padded_small` / `gather_gb_s_dense_big` (lrr_tpu's keys):
    GB/s of 524,288 32-byte rows (an iteration of the bench wave) gathered at
    random from a [V, 8] float32 table, the layout of lrr_tpu's baked grid
    (`icp.bake_target_grid`), at V = 2M voxels and at V = 61M (63,963,136: the
    working set lrr_tpu measured for the reference map).  On the TPU the two
    keys were two layouts; on the card both are the one layout at two
    working sets (64 MB, beside the 50 MB L2, and 2 GB).  Each is the faster
    of two PyTorch formulations, both under `gather_gb_s_by_op`: `rows`,
    `table[ids]` (one thread block a row), and `elements`, `torch.take` of
    the rows' 8 floats (one thread an element, reading a 32 MB index
    besides).  A kernel of the port's own could pass both, so the bound
    they give is a floor the card's PyTorch reaches, not the hardware's.  `window_copy_gb_s`: a contiguous 256 MB copy, read and
    write counted (the match windows' streaming rate).
    `i32_self_gather_melem_s`: the int32 `p[p]` self-gather of the
    watershed's pointer jump over 61M entries, million elements a second."""
    device = resolve_device(device, "measured_gather_roofline")
    if device.type != "cuda":
        return None
    key = str(device)
    if key not in _ROOFLINE:
        _ROOFLINE[key] = _measure_roofline(device)
    return _ROOFLINE[key]


def _measure_roofline(device: torch.device) -> dict:
    g = torch.Generator(device=device).manual_seed(0)
    n = GATHER_ROWS
    out = {"rows": n, "row_bytes": ROW_BYTES, "gather_gb_s_by_op": {}}
    for name, voxels in GATHER_VOXELS.items():
        table = torch.rand((voxels, 8), generator=g, device=device)
        ids = torch.randint(0, voxels, (n,), generator=g, device=device)
        flat = (ids[:, None] * 8 + torch.arange(8, device=device)).reshape(-1)
        by_op = {op: n * ROW_BYTES / (_event_ms(fn, reps=20) * 1e-3) / 1e9 for op, fn in (
            ("rows", lambda: table[ids]), ("elements", lambda: torch.take(table, flat)))}
        out["gather_gb_s_by_op"][name] = by_op
        out[name] = max(by_op.values())
        out[name.replace("gb_s", "voxels")] = voxels
        del table, ids, flat
    src = torch.rand((COPY_ROWS, 8), generator=g, device=device)
    dst = torch.empty_like(src)
    ms = _event_ms(lambda: dst.copy_(src), reps=20)
    out["window_copy_gb_s"] = 2 * COPY_ROWS * ROW_BYTES / (ms * 1e-3) / 1e9
    del src, dst
    voxels = GATHER_VOXELS["gather_gb_s_dense_big"]
    p = torch.randint(0, voxels, (voxels,), generator=g, device=device, dtype=torch.int32)
    ms = _event_ms(lambda: p[p], reps=5)
    out["i32_self_gather_melem_s"] = voxels / (ms * 1e-3) / 1e6
    out["i32_self_gather_ms"] = ms
    return out


# ---------------------------------------------------------------------------
# one ICP iteration over a wave of lanes
# ---------------------------------------------------------------------------


def synthetic_iteration_inputs(lanes: int, n_features: int, map_side: int, K: int,
                               seed: int) -> dict[str, np.ndarray]:
    """The synthetic iteration inputs of lrr_tpu/utils/sol.py:119-163,
    drawn from `default_rng(seed)` in its order: the two target sets' packed
    rows [n, 8], random Voronoi index maps [S, S, S], each lane's two source
    tables of 2n independent rows [lanes, 2n, 8], the lanes' translations and
    the window offsets [2, 5K + 1] of the longest run."""
    rng = np.random.default_rng(seed)

    def make_packed(n):
        xyz = rng.uniform(2, map_side - 2, (n, 3)).astype(np.float32)
        s = rng.uniform(0.5, 5.0, (n, 1)).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tag = rng.integers(1, 4, (n, 1)).astype(np.float32)
        return np.concatenate([xyz, s, d, tag], 1)

    out = {"dst_f": make_packed(n_features), "dst_m": make_packed(n_features)}
    shape = (map_side,) * 3
    out["vor_f"] = rng.integers(0, n_features, shape).astype(np.int32)
    out["vor_m"] = rng.integers(0, n_features, shape).astype(np.int32)
    for side in ("tabs_m", "tabs_f"):
        out[side] = make_packed(lanes * 2 * n_features).reshape(lanes, 2 * n_features, 8)
    out["t0"] = rng.uniform(-1, 1, (lanes, 3)).astype(np.float32)
    out["offs"] = rng.integers(0, n_features, (2, 5 * K + 1)).astype(np.int32)
    return out


@dataclasses.dataclass
class IterationWave:
    """The port's sampling state for `iterate`: per direction the lanes'
    sources, the target map and the target rows it indexes; the window
    offsets."""

    src_m: icp._PackedSource
    src_f: icp._PackedSource
    vor_f: icp.VoronoiGrid
    vor_m: icp.VoronoiGrid
    dst_f: torch.Tensor  # [n, 8]
    dst_m: torch.Tensor
    number: torch.Tensor  # [L] matches a window
    offs: torch.Tensor  # [2, k_hi + 1]
    cap: int
    cfg: EstimationConfig


def iteration_wave(inputs: dict[str, np.ndarray], cap: int, device) -> IterationWave:
    """`synthetic_iteration_inputs` as the port's sampling state on `device`.
    A lane's source is its own 2n rows, in order, all valid, so the cyclic
    window at an offset below n is lrr_tpu's contiguous slice of them.  Every
    voxel of the random maps names a feature, so the rows matched are
    lrr_tpu's grid rows."""
    dev = torch.device(device)
    L, two_n = inputs["tabs_m"].shape[:2]
    order = (torch.arange(L)[:, None] * two_n + torch.arange(two_n)[None, :]).to(dev)
    lane_mask = torch.ones((L, L * two_n), dtype=torch.bool, device=dev)
    valid = torch.full((L,), two_n, device=dev)

    def t_(name):
        return torch.from_numpy(inputs[name]).to(dev)

    def vor(side):
        return icp.VoronoiGrid(t_(f"vor_{side}"), torch.zeros(3, device=dev),
                               torch.ones(3, device=dev))

    return IterationWave(
        src_m=icp._PackedSource(t_("tabs_m").reshape(-1, 8), lane_mask, order, valid),
        src_f=icp._PackedSource(t_("tabs_f").reshape(-1, 8), lane_mask, order, valid),
        vor_f=vor("f"), vor_m=vor("m"), dst_f=t_("dst_f"), dst_m=t_("dst_m"),
        number=torch.full((L,), cap, device=dev), offs=t_("offs").long(), cap=cap,
        cfg=EstimationConfig(max_matches=cap),
    )


def iterate(w: IterationWave, A: torch.Tensor, t: torch.Tensor, i: int, with_ls: bool = True):
    """Iteration `i` of every lane (lrr_tpu's `lane_iter`): both directions'
    windows at offsets `w.offs[:, i]` matched through the maps, then the
    robust estimate (K1 and the solve).  Returns (A, t) moved 1e-3 of the way
    to the estimate (random matches hold no consistent transform; full steps
    would degenerate A), and the estimate.  Without `with_ls`, sampling
    alone: the transform comes back unchanged but for a 1e-30 multiple of a
    sum of the gathered rows, which keeps them live, and no estimate."""
    L = A.shape[0]
    trans = Affine3D(A=A, t=t, center=torch.zeros_like(t))
    fwd = icp._sample_matches_packed(w.src_m, w.vor_f, trans, w.number, w.cap,
                                     w.offs[0, i].expand(L), dst_rows=w.dst_f)
    bwd = icp._sample_matches_packed(w.src_f, w.vor_m, trans.inverse(), w.number, w.cap,
                                     w.offs[1, i].expand(L), dst_rows=w.dst_m)
    if not with_ls:
        s = (fwd.txyz.sum((1, 2)) + fwd.tdir.sum((1, 2)) + fwd.weight.sum(1)
             + bwd.txyz.sum((1, 2)) + bwd.fdir.sum((1, 2)) + bwd.weight.sum(1))
        return A, t + 1e-30 * s[:, None], None
    new = icp._estimate_ls_packed(trans, fwd, bwd, False, w.cfg)[0]
    return A + 1e-3 * (new.A - A), t + 1e-3 * (new.t - t), new


def _flops_min(lanes: int, cap: int) -> int:
    """The normal-equation operations an iteration must do: per lane and
    direction the 12x12 G^T G contraction over 3 cap rows, G's assembly and
    Atb (lrr_tpu's count)."""
    return lanes * 2 * (2 * 12 * 12 * 3 * cap + 2 * 12 * 3 * cap + 72 * cap)


def iteration_light(lanes: int, n_features: int, map_side: int, cap: int, t_full: float,
                    t_samp: float, gather_gbs: float | None,
                    device_ms: float | None = None) -> dict:
    """The report of one wave shape from its measured seconds an iteration
    (`t_full`, and `t_samp` of the sampling alone) and the card's random-row
    gather ceiling in GB/s (None: nothing measured, the streaming peak
    prices the gather).  lrr_tpu's arithmetic and keys, unrounded, with the
    kernels' summed device time beside them."""
    bytes_window = lanes * 2 * cap * ROW_BYTES
    bytes_gather = lanes * 2 * cap * ROW_BYTES
    t_flops = _flops_min(lanes, cap) / (PEAK_F32_TFLOPS * 1e12)
    t_bytes_stream = (bytes_window + bytes_gather) / (PEAK_HBM_GBS * 1e9)
    out = {
        "time_ms_per_iter": t_full * 1e3,
        "sample_ms": t_samp * 1e3,
        "estimate_ls_ms": (t_full - t_samp) * 1e3,
        "light_ms_streaming_peak": max(t_bytes_stream, t_flops) * 1e3,
        "achieved_gather_gb_s": bytes_gather / t_samp / 1e9,
        "peak_gb_s": PEAK_HBM_GBS,
        "shape": (f"{lanes} lanes x {cap} matches x 2 dirs, "
                  f"{n_features} features, {map_side}^3 map"),
        "device_ms_per_iter": device_ms,
    }
    if gather_gbs:
        t_bytes = bytes_window / (PEAK_HBM_GBS * 1e9) + bytes_gather / (gather_gbs * 1e9)
        t_light = max(t_bytes, t_flops)
        out["light_ms"] = t_light * 1e3
        out["fraction_of_light"] = t_light / t_full
        out["bound"] = "hbm-gather (measured roofline)" if t_bytes >= t_flops else "fp32"
        out["gather_roofline_gb_s"] = gather_gbs
        out["sample_fraction_of_gather_roofline"] = bytes_gather / (gather_gbs * 1e9) / t_samp
        if out["fraction_of_light"] > 1:
            out["note"] = ("fraction > 1: the iteration outruns the measured single-table "
                           "gather ceiling (the two directions' gathers and the window "
                           "copies overlap)")
    else:
        out["light_ms"] = max(t_bytes_stream, t_flops) * 1e3
        out["fraction_of_light"] = max(t_bytes_stream, t_flops) / t_full
        out["bound"] = ("hbm-streaming (no measured gather ceiling)"
                        if t_bytes_stream >= t_flops else "fp32")
    return out


def icp_iteration_sol(lanes: int = 64, n_features: int = 8192, map_side: int = 96,
                      cap: int = 4096, K: int = 8, seed: int = 0, device=None) -> dict:
    """Time one whole ICP iteration of a wave of `lanes` candidates, `cap`
    matches a direction (module docstring): K and 5K dependent iterations
    for the slope, with and without the estimate, and the kernels' device
    time over K iterations."""
    device = resolve_device(device, "icp_iteration_sol")
    inputs = synthetic_iteration_inputs(lanes, n_features, map_side, K, seed)
    w = iteration_wave(inputs, cap, device)
    A0 = torch.eye(3, device=device).expand(lanes, 3, 3).contiguous()
    t0 = torch.from_numpy(inputs["t0"]).to(device)
    del inputs

    def loop(with_ls):
        def run(k):
            A, t = A0, t0
            for i in range(k):
                A, t, _ = iterate(w, A, t, i, with_ls)
            return A, t
        return run

    t_full = _time_fn_slope(loop(True), K, 5 * K, device)
    t_samp = _time_fn_slope(loop(False), K, 5 * K, device)
    device_ms = _device_ms(loop(True), K, device)
    roof = measured_gather_roofline(device)
    gather_gbs = None
    if roof is not None:
        small = map_side ** 3 <= GATHER_VOXELS["gather_gb_s_padded_small"]
        gather_gbs = roof["gather_gb_s_padded_small" if small else "gather_gb_s_dense_big"]
    return iteration_light(lanes, n_features, map_side, cap, t_full, t_samp, gather_gbs,
                           device_ms)


# ---------------------------------------------------------------------------
# the descriptor nearest neighbour
# ---------------------------------------------------------------------------


def descriptor_nn_inputs(n_q: int, n_p: int, seed: int, device) -> tuple[torch.Tensor, ...]:
    """The report's descriptor tables [n_q, 195], [n_p, 195] (lrr_tpu's
    draws) and an all-true mask [n_p]."""
    rng = np.random.default_rng(seed)
    qd = torch.from_numpy(rng.standard_normal((n_q, DESC_DIM)).astype(np.float32)).to(device)
    pd = torch.from_numpy(rng.standard_normal((n_p, DESC_DIM)).astype(np.float32)).to(device)
    return qd, pd, torch.ones(n_p, dtype=torch.bool, device=device)


def _expansion_nn(q: torch.Tensor, p: torch.Tensor, tf32: bool):
    """`run(k)`: k nearest-neighbour sweeps by the matmul expansion
    |q|^2 + |p|^2 - 2 q p^T and an argmin a query, the matmul in TF32 or
    not.  PyTorch's library calls, for contrast only: the expansion cancels
    digits, so it is not the port's exact path."""
    p2 = (p * p).sum(-1)

    def run(k):
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for _ in range(k):
                d2 = (q * q).sum(-1, keepdim=True) + p2[None, :] - 2.0 * (q @ p.T)
                d2.argmin(1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    return run


def kernel_sol_report(n_desc_q: int = 4096, n_desc_p: int = 4096, K: int = 32, seed: int = 0,
                      device=None) -> dict:
    """{kernel: time, light bound, share} for the hot paths: the whole ICP
    iteration at the bench wave shape (64 lanes x 4096 matches, 8,192
    features, 96^3 map) and at the reference constants' (20 candidates x
    8000 matches, 16,384 features, 192^3), and the 195-d descriptor nearest
    neighbour through K2 against its operations bound, with the expansion
    variants beside it."""
    device = resolve_device(device, "kernel_sol_report")
    report = {
        "icp_iteration_bench": icp_iteration_sol(64, 8192, 96, 4096, 8, seed, device),
        "icp_iteration_reference": icp_iteration_sol(20, 16384, 192, 8000, 8, seed, device),
    }
    qd, pd, mask = descriptor_nn_inputs(n_desc_q, n_desc_p, seed, device)

    def k2(k):
        for _ in range(k):
            kernels.knn(qd, pd, mask, 1)

    t = _time_fn_slope(k2, K, 4 * K, device)
    ops = 3 * n_desc_q * n_desc_p * DESC_DIM
    report_nn = {
        "time_ms": t * 1e3,
        "achieved_tflop_s": ops / t / 1e12,
        "fraction_of_peak": knn_bound_ms(n_desc_q, n_desc_p, DESC_DIM, 1, n_desc_p)[0] / (t * 1e3),
        "peak_tflop_s": PEAK_F32_TFLOPS,
        "bound": "fp32 (K2, csrc/knn.cu: exact direct sum, 3 operations a component)",
        "shape": f"{n_desc_q}x{n_desc_p}x{DESC_DIM}",
    }
    pad = 256 - DESC_DIM
    q256 = torch.nn.functional.pad(qd, (0, pad))
    p256 = torch.nn.functional.pad(pd, (0, pad))
    flops = 2 * n_desc_q * n_desc_p * DESC_DIM  # the useful 195-deep products
    variants = {}
    for name, a, b, tf32, peak in (
        ("k195_fp32_expansion", qd, pd, False, PEAK_F32_TFLOPS),
        ("k256_fp32_expansion_packed", q256, p256, False, PEAK_F32_TFLOPS),
        ("k195_tf32_expansion", qd, pd, True, PEAK_TF32_TFLOPS),
        ("k256_tf32_expansion_packed", q256, p256, True, PEAK_TF32_TFLOPS),
    ):
        tv = _time_fn_slope(_expansion_nn(a, b, tf32), K, 4 * K, device)
        variants[name] = {
            "time_ms": tv * 1e3, "achieved_tflop_s": flops / tv / 1e12,
            "fraction_of_peak": flops / tv / 1e12 / peak, "peak_tflop_s": peak,
        }
    report_nn["variants"] = variants
    report["descriptor_nn"] = report_nn
    return report

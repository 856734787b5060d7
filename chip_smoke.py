"""Smoke test of the PyTorch port (lrr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each; any failure raises and exits non-zero:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build    nvcc builds the kernel libraries from lrr_tpu_torch/csrc (one
              compiler per source, side by side) and reports each kernel's
              registers and spills;
  3. kernels  K1 (normal equations) and K2 (k-NN) against their plain
              PyTorch versions on the card: error, run-to-run bit equality,
              median CUDA-event times with the inputs flushed from L2, the
              least time the card could take (`bound_ms`), and the time of
              an empty kernel launched the same way (`launch_floor_ms`);
              K5 (the ICP's match sampler) against its plain version, bit
              for bit, at copd512's wave shapes (512 lanes at 1,024 / 2,048
              / 4,096 / 8,000 matches) through a baked grid of copd512's
              map, and at 2,048 through the bare map, with times and bound;
  4. slice    the committed bench pair context (bench.py's 64^3 workload)
              is loaded onto the card and `register_locations_staged` serves
              its 64 queries: one warm-up and three timed runs, acceptance
              held against lrr_tpu's recorded result for that context, the
              kernels' launch counts over the whole run (both > 0) and the
              shapes the run gave K1;
  5. stage1_bench      the same 64^3 pair from the port's own stage 1: the
              port's `make_pair` and `prepare_pair` (no file prepared by
              lrr_tpu), seconds per stage, counts, the agreement of its
              features with the committed context's, and the 64 queries
              served with phase 4's acceptance bounds;
  6. stage1_reference  stage 1 alone at the reference constants: a dense
              400 x 350 x 350 phantom pair, 65,536 features and 4,096
              keypoints a volume; seconds per stage, counts, map shapes,
              peak memory, feature repeatability under the true transform,
              K2's launch at 4096 x 4096 x 195 inside `prepare_pair`, the
              two exact Voronoi builds and K4 against each other on a
              sub-box, K4 (two launches in `prepare_pair`, one a map)
              against the plain blocked build at the fixed map's shape and
              at copd512's 320 x 352 x 352 (bits, times, the pairs it
              evaluated, its bound), and two runs of `detect_features` bit
              for bit;
  7. serve_reference   the phase-6 pair served at the reference constants
              (verify/train_default.py::reference_cfg: 20 candidates, 64
              query keypoints, 8,000 matches, 70 iterations, gate 64):
              `segment_pair` (seconds per volume for diffusion, gradient
              and labels, `p[p]` rounds, basins, regions, peak memory), then
              `register_locations_staged` on 16 queries, one warm-up and
              three timed runs: seconds, waves, acceptance against the true
              transform, in-box feature counts, the region-grown masks
              against the box masks, K1 at 8,000 matches and K2 at
              4096 x 4096 on the path, two runs of one plan, and that plan
              served from the bare index maps (seconds, equal bits);
  8. regions_bench     the phase-5 pair with `segment_pair` and a region
              target below the box count: whole regions in or out, masks
              that differ from the box, phase 4's acceptance bounds;
              `register_locations` (every candidate refined) against the
              staged run; `register_location_rigid` on 8 queries;
              `watch_candidate`; one staged run from the bare index maps
              equal to the run from the baked grids; the kernels' launches
              of each entry point on its own (none by the rigid model);
  9. cli_reference     the file-based pipeline at the reference constants,
              through `lrr_tpu_torch.cli.main`: phase 6's two volumes written
              as .mhd into a temporary directory, then `extract-features`,
              `extract-keypoints`, `compute-descriptors`,
              `compute-distance-map --validate` and `watershed` on both,
              and `register` on phase 7's 16 queries with regions.  Seconds
              and bytes a stage; the sets, maps and labels read back against
              phase 6's bit for bit; the result files against the files of an
              in-memory `register_locations_staged` on phase 6's context with
              the same plan, byte for byte; two runs byte for byte; K1 and K2
              on the path; which readers served;
 10. batch_calibrate   `run_batch` over a pairs file of two 64^3 phantom
              pairs (seeds 11 and 12, 16 queries each) and one job whose
              volume is missing: 2 completed, 1 failed, pair 11 inside phase
              4's acceptance bounds, a resumed run byte-equal from the cached
              contexts.  Then verifier calibration on pair 11 with the bench's
              64 queries: `collect_labeled_measurements`, `train_c_svc` and
              `fit_rbf_classifier` on what it collected, the serialised
              models through `svm-predict`, one served run with each;
 11. kernels_path_shapes  K1 and K2 against their plain versions, as in
              phase 3, at every shape a path launched them at that phase 3
              did not hold; K3 likewise (phase 16's checks), and K4 at every
              map shape and feature count a path launched it at that phase
              6 did not hold, on features made for the shape; K5 bit for
              bit at every (lanes, matches, grid or map) a path launched it
              at that phase 3 did not hold, on inputs made for the shape.
 12. estimate  (printed before phase 11, while phase 6's pair is held) the
              estimate family on the card: `lrr_tpu_torch.cli.main(["estimate",
              ...])` for `icp` and the four CDC methods on phase 5's feature
              sets written as point files, twice each (bit for bit), and
              `--model similarity2d` on 1,000 2-D points from the seed;
              `fit_affine_to_field` on a `DeformationField` rasterised from the
              bench's true transform; `multiresolution_masks` on phase 6's
              65,536-feature set; `register_intensity` at its defaults on
              phase 6's 400 x 350 x 350 pair.  Seconds, iterations,
              `converged`, the median error against the true map next to the
              identity's; no kernel is on this path.
 13. parallel  (after phase 10, before phase 11) two ranks on the one card,
              subprocesses of this script joined through LRR_COORDINATOR
              (gloo: NCCL refuses two ranks on one device), each loading the
              kernels phase 2 built: `prepare_pair(mesh=)` at the reference
              constants (phase 6's features and maps, SHA-256 or proven
              ties), phase 7's 16 queries and plan served with the lanes
              split (phase 7's selections; >= 12 verified, < 1.0 mm), one
              candidate's ICP with its 8,000-match windows split against the
              one-process run, `cli batch` over phase 10's pairs file (pair
              11's selections); seconds, backend, peak memory and K1 / K2 / K5
              launches and shapes of each rank.  The ranks share the card:
              no scaling figure.
 14. train_verifier  (after phase 8, before phase 9, while phases 5-7's
              contexts are held) `python -m lrr_tpu_torch.verify.train_default`
              as a user runs it on the card: the five phantom pairs of
              lrr_tpu's training script collected (rows, aligned rows,
              seconds and peak memory a pair beside lrr_tpu's record), the
              C-SVC fitted and written; the shipped model and the port's on
              the port's corpus (accuracy > 0.9 a pair, tpr > 0.9 a pair with
              50 aligned rows and pooled); the port's model serving phase 5's
              64 queries (phase 4's bars) and phase 7's 16 with phase 7's
              plan (>= 12 verified, < 1.0 mm) beside the shipped model's;
              the refit of the committed corpus (`TRAIN_REUSE_CORPUS=1`): 288
              support vectors, P(aligned) within 1e-3 of the shipped file's;
              P(aligned) under the port's model of phase 7's sub-millimetre
              candidates that the shipped model rejected; K1 / K2 launches
              and shapes, held in phase 11.
 15. sol  (after phase 13, before phase 11's line, which holds its shapes)
              the speed-of-light report (`lrr_tpu_torch.utils.sol.
              kernel_sol_report`) with the card line: one whole ICP iteration
              (sampling through the baked grid, robust estimate, K1) at the
              bench wave (64 lanes x 4096 matches) and the reference wave (20
              x 8000) against its light bound, the 195-d descriptor NN
              through K2 at 4096 x 4096 against its operations bound, with the
              matmul expansion's library calls beside it, and the card's
              measured random-gather ceilings.  Every share in (0, 1.05],
              the gather ceilings under the streaming peak, K1 and K2
              launched, K2's indices equal `knn_plain`'s on the report's
              inputs.
 16. wave_graphs  (after phase 14, while phase 7's context is held) every
              serving phase above runs its waves from captured CUDA graphs
              (`pipeline/wave_graph.py`); here phase 4's bench context and
              phase 7's context at the reference constants are each served
              by the eager waves (`registration._wave_fn`, the oracle) and by
              the graphs, alternating, 9 runs a path on shared plans:
              seconds (median and spread), the graphs' build seconds per lane
              bucket, replays and host reads a wave, peak memory, the two
              paths' results bit for bit, both inside phase 4's and phase
              7's bars; one profiled graph run of the bench (the device's
              busy share); then K3 (`csrc/pinv_sym.cu`) against its plain
              version and float64 on the 64 systems of one eager bench wave
              and on SPD, rank-deficient and non-finite batches (n 12 at
              L 1 / 8 / 16 / 20 / 24 / 32 / 64, n 6 at L 1 / 8 / 24 / 64), with
              times, bound and the library call.  Each captured bucket's
              prologue, chunk and epilogue graphs record 2, 2 x
              ITERATIONS_PER_CHECK and 2 K5 launches, and in one eager bench
              run every sampler call is one K5 launch.
Phase 7 prints, for each query whose best refined candidate lies under 1 mm
but verified nothing, that candidate's 8 measurements beside the verifier's
scaling range and the committed corpus's range, and beside its own figures
lrr_tpu's per-query record of the same pair and queries
(lrr_tpu_torch/data/reference_constants_lrr_tpu.json).
Phase 10 also holds pair 12 to the bench's bars against lrr_tpu's figure for
seed 12 (lrr_tpu_torch/data/bench_pair_s64_seed12.json).
Then a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "lrr_tpu_torch", "data", "bench_pair_s64")
# K3's and K4's launches on every path, {(L, n): {path: launches}} and
# {(D, H, W, N): {path: launches}}: each phase folds `kernels.PINV_SHAPES`
# and `kernels.VORONOI_SHAPES` in where it reads its counts
# (`note_path_shapes`), and each kernel is held against its plain version at
# every one of them
PINV_PATH_SHAPES: dict[tuple[int, int], dict[str, int]] = {}
VORONOI_PATH_SHAPES: dict[tuple[int, int, int, int], dict[str, int]] = {}
# K5's, {(L, m, "grid" | "map"): {path: launches}} (`kernels.SAMPLE_SHAPES`)
SAMPLE_PATH_SHAPES: dict[tuple[int, int, str], dict[str, int]] = {}
# K5 measured against its plain version, by "Lxm_kind" (`measure_k5`)
K5_MEASURED: dict[str, dict] = {}
K5_CAPS = (1024, 2048, 4096, 8000)  # copd512's wave capacities (its staged schedule)
# K4 measured against its plain version, by "DxHxWxN" (`measure_k4`)
K4_MEASURED: dict[str, dict] = {}
COPD512_MAP = (320, 352, 352)  # the copd512 cells' Voronoi maps (z, y, x) at 1 mm
K1_TOL = 2e-5  # x max |entry|: fp32 sums in another order


def phase(label: str, **fields) -> None:
    print(json.dumps({"phase": label, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median milliseconds of a call on the card between two CUDA events,
    after a warm-up.  A spinning kernel is queued ahead of every timed call,
    so the host has queued the call and both events before the device
    reaches them: the events then bracket device time, not the host's launch
    path.  With `cold`, a buffer larger than the L2 cache is rewritten before
    that, outside the timed window."""

    SPIN_CYCLES = 1_000_000  # ~0.5 ms: longer than the host needs to queue a call

    def __init__(self, dev):
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)  # 256 MB

    def ms(self, fn, reps: int = 20, cold: bool = True) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if cold:
                self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def note_path_shapes(path: str, delta: tuple | None = None) -> None:
    """Fold the shapes `path` launched K3, K4 and K5 at (a `kernels.counts()`-
    shaped tuple: a `counts_since` delta or a rank's; by default the
    counters as they stand) into PINV_PATH_SHAPES, VORONOI_PATH_SHAPES and
    SAMPLE_PATH_SHAPES."""
    from lrr_tpu_torch.ops import kernels

    delta = kernels.counts() if delta is None else delta
    for logged, into in ((delta[3], PINV_PATH_SHAPES), (delta[4], VORONOI_PATH_SHAPES),
                         (delta[5], SAMPLE_PATH_SHAPES)):
        for shape, n in logged.items():
            by_path = into.setdefault(tuple(shape), {})
            by_path[path] = by_path.get(path, 0) + n


def ptxas_report(logs: dict[str, str]) -> dict:
    """{source: {kernel: {registers, spill_stores, spill_loads}}} from the
    kept `-Xptxas -v` output."""
    report = {}
    demangle = shutil.which("c++filt")
    for stem, log in logs.items():
        entries = {}
        for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads\s*\n.*?Used (\d+) registers", log, re.S):
            name = m.group(1)
            if demangle:
                name = subprocess.run([demangle, "-p", name], capture_output=True,
                                      text=True).stdout.strip() or name
            entries[re.sub(r"\(anonymous namespace\)::", "", name)] = {
                "registers": int(m.group(5)), "spill_stores": int(m.group(3)),
                "spill_loads": int(m.group(4))}
        report[stem] = entries
    return report


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def k1_direction(rng, L: int, M: int, dev):
    """(from, to, dir, tag, w) of one direction in world coordinates: unit
    projector directions, tags over all four row kinds, weights with zeros
    (every 7th) and negatives."""
    d = rng.standard_normal((L, 3, M))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.uniform(-0.2, 2.0, (L, M))
    w[:, ::7] = 0.0
    arrays = [rng.uniform(-40, 40, (L, 3, M)), rng.uniform(-40, 40, (L, 3, M)), d,
              rng.integers(0, 4, (L, M)).astype(np.float64), w]
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays)


def k1_frame(rng, L: int, dev):
    arrays = [rng.uniform(-5, 5, (L, 3)), rng.uniform(-5, 5, (L, 3)), rng.uniform(20, 30, L),
              rng.uniform(20, 30, L), rng.uniform(-0.1, 0.1, (L, 3))]
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


def as_row_views(direction):
    """The same values as views of [L, M, 8] rows: the layout the ICP's row
    gathers hand to K1 on the main path."""
    fx, ty, d, tag, w = direction
    rows_a = torch.cat([fx, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
    rows_b = torch.cat([ty, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
    va, vb = rows_a.permute(0, 2, 1), rows_b.permute(0, 2, 1)
    return va[:, 0:3], vb[:, 0:3], va[:, 4:7], vb[:, 7], w


def measure_k1(rng, dev, timer, L: int, m_f: int, m_b: int, rows: bool) -> dict:
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.utils.sol import k1_bound_ms

    fwd, bwd = k1_direction(rng, L, m_f, dev), k1_direction(rng, L, m_b, dev)
    frame = k1_frame(rng, L, dev)
    if rows:
        fwd, bwd = as_row_views(fwd), as_row_views(bwd)
    ata, atb = kernels.normal_equations_sym(fwd, bwd, *frame)
    ata2, atb2 = kernels.normal_equations_sym(fwd, bwd, *frame)
    ata_p, atb_p = kernels.normal_equations_sym_plain(fwd, bwd, *frame)
    torch.cuda.synchronize()
    label = f"L={L} M_f={m_f} M_b={m_b}{' rows' if rows else ''}"
    if not (torch.equal(ata, ata2) and torch.equal(atb, atb2)):
        raise AssertionError(f"K1 {label}: two launches on the same inputs differ")
    if not torch.equal(ata, ata.transpose(1, 2)):
        raise AssertionError(f"K1 {label}: AtA is not symmetric")
    err = max(float((ata - ata_p).abs().max()), float((atb - atb_p).abs().max()))
    scale = max(float(ata_p.abs().max()), float(atb_p.abs().max()))
    if not ((ata - ata_p).abs().max() <= K1_TOL * ata_p.abs().max()
            and (atb - atb_p).abs().max() <= K1_TOL * atb_p.abs().max()):
        raise AssertionError(f"K1 {label}: max err {err} vs scale {scale}")
    bound, bound_by = k1_bound_ms(fwd, bwd)
    ms = timer.ms(lambda: kernels.normal_equations_sym(fwd, bwd, *frame))
    return {
        "L": L, "M_f": m_f, "M_b": m_b, "layout": "rows" if rows else "planar",
        "max_abs_err": err, "max_abs_entry": scale, "bit_identical": True, "ms": ms,
        "ms_warm": timer.ms(lambda: kernels.normal_equations_sym(fwd, bwd, *frame), cold=False),
        "plain_ms": timer.ms(lambda: kernels.normal_equations_sym_plain(fwd, bwd, *frame), reps=5),
        "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
        "library_ms": None,
    }


def k1_key(L: int, m_f: int, m_b: int, rows: bool) -> str:
    return f"{L}x{m_f}x{m_b}{'_rows' if rows else ''}"


K1_SHAPES = [
    (64, 1024, 1024, False), (64, 4096, 4096, False), (64, 4096, 2048, False),
    (1, 500, 400, False), (5, 1023, 77, False),  # a ragged M, not divisible by 4
    # as the serving path hands them over: views of the ICP's row gathers
    (64, 2048, 2048, True), (64, 4096, 4096, True),
    # the reference constants' full capacity (`backward_covariance`): 8000 is
    # no multiple of 128, the tail of every block's last tile is ragged
    (64, 8000, 8000, False), (64, 8000, 8000, True),
]


def check_k1(rng, dev, timer):
    from lrr_tpu_torch.models.affine import solve_normal_equations
    from lrr_tpu_torch.ops import kernels

    results = {k1_key(*shape): measure_k1(rng, dev, timer, *shape) for shape in K1_SHAPES}

    # a consistent system in a non-trivial frame: the solve recovers A
    true = torch.tensor([[1.02, 0.05, 0.0], [-0.03, 0.97, 0.02], [0.01, 0.0, 1.01]], device=dev)
    fx, _, d, tag, _ = k1_direction(rng, 1, 400, dev)
    ty = torch.einsum("ij,ljm->lim", true, fx) + torch.tensor([0.3, -0.2, 0.1], device=dev)[None, :, None]
    one, zero3 = torch.ones(1, device=dev), torch.zeros(1, 3, device=dev)
    fwd = (fx, ty, d, tag, torch.ones_like(tag))
    bwd = tuple(t[..., :0] for t in fwd)
    ata, atb = kernels.normal_equations_sym(fwd, bwd, zero3, zero3, one, one, zero3)
    est, _ = solve_normal_equations(ata, atb, zero3)
    a_err = float((est.A[0] - true).abs().max())
    if a_err > 1e-3:
        raise AssertionError(f"K1 solved A off by {a_err}")
    results["solve_1x400"] = {"solved_A_err": a_err}
    return results


K2_SHAPES = [
    (37, 129, 195, 1, False), (200, 700, 195, 20, False),
    (128, 128, 195, 1, False), (8, 16, 195, 2, True),
    (4096, 4096, 195, 1, False), (4096, 4096, 195, 20, False),
]


def k2_key(q_n: int, p_n: int, dim: int, k: int, masked: bool = False) -> str:
    return f"{q_n}x{p_n}x{dim}_k{k}{'_masked' if masked else ''}"


def measure_k2(rng, dev, timer, q_n: int, p_n: int, dim: int, k: int, masked: bool) -> dict:
    """K2 against its plain version at one shape; `masked` masks every
    point out, else about one in seven."""
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.utils.sol import knn_bound_ms

    q = torch.tensor(rng.standard_normal((q_n, dim)), dtype=torch.float32, device=dev)
    p = torch.tensor(rng.standard_normal((p_n, dim)), dtype=torch.float32, device=dev)
    mask = torch.tensor(
        np.zeros(p_n, bool) if masked else rng.uniform(size=p_n) > 0.15, device=dev
    )
    d, i = kernels.knn(q, p, mask, k)
    d_p, i_p = kernels.knn_plain(q, p, mask, k)
    torch.cuda.synchronize()
    label = f"K2 {q_n}x{p_n}x{dim} k={k}"
    if masked:
        if not bool(torch.isinf(d).all()):
            raise AssertionError(f"{label} all-masked: finite distance returned")
        err = 0.0
    else:
        if not torch.equal(i, i_p):
            raise AssertionError(f"{label}: indices differ")
        if not torch.equal(d, d_p):  # the same arithmetic in the same order
            raise AssertionError(f"{label}: distances are not bit-equal")
        err = float((d - d_p).abs().max())
    wide, splits = kernels.knn_plan(q_n, p_n, dim, k, dev)
    bound, bound_by = knn_bound_ms(q_n, p_n, dim, k, int(mask.sum()))
    ms = timer.ms(lambda: kernels.knn(q, p, mask, k))
    big = q_n * p_n > 1 << 20
    return {
        "Q": q_n, "N": p_n, "D": dim, "k": k, "all_masked": masked, "max_abs_err": err,
        "bit_equal": True, "tiles": "64x64" if wide else "16x16", "point_splits": splits,
        "ms": ms, "ms_warm": timer.ms(lambda: kernels.knn(q, p, mask, k), cold=False),
        "plain_ms": timer.ms(lambda: kernels.knn_plain(q, p, mask, k), reps=3 if big else 5),
        "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
        "library_ms": None,
    }


def check_k2(rng, dev, timer):
    return {k2_key(*shape): measure_k2(rng, dev, timer, *shape) for shape in K2_SHAPES}


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------


def acceptance_stats(out, queries: np.ndarray, true) -> dict:
    """bench.py::acceptance_stats: verified and rank-0 fractions and the
    median (over verified queries) of the per-query median ground-truth
    error of the selected transform on 20 probes around the query."""
    sel = out.selected.cpu().numpy()
    rank = out.rank.cpu().numpy()
    errs = query_errors(out, queries, true)
    return {
        "verified_frac": float((sel >= 0).mean()),
        "rank0_frac": float((sel == rank[:, 0]).mean()),
        "median_gt_error_mm": float(np.median(errs)) if errs else None,
    }


def query_errors(out, queries: np.ndarray, true) -> list[float]:
    """`acceptance_stats`' per-query errors (mm) of the verified queries."""
    sel = out.selected.cpu().numpy()
    errs = []
    inv = true.inverse()
    for q in range(sel.size):
        if sel[q] < 0:
            continue
        tr = out.trans[q, int(sel[q])]
        probe = queries[q][None, :] + np.random.default_rng(q).uniform(
            -15, 15, (20, 3)
        ).astype(np.float32)
        src = inv.apply(torch.as_tensor(probe, device=tr.A.device))
        err = torch.linalg.norm(tr.apply(src) - true.apply(src), dim=1)
        errs.append(float(np.median(err.cpu().numpy())))
    return errs


def load_bench_meta():
    from lrr_tpu_torch.config import pipeline_config_from_dict

    with open(BENCH + ".json") as f:
        meta = json.load(f)
    return meta, pipeline_config_from_dict(meta["config"])


def k2_shape_rows(shapes: dict) -> list[dict]:
    return [{"Q": k[0], "N": k[1], "D": k[2], "k": k[3], "launches": n} for k, n in shapes.items()]


def serve_and_check(label: str, ctx, cfg, meta, seed: int, card: str,
                    on_path=("normal_equations", "knn"), svm=None, **fields):
    """Serve the bench queries on `ctx` (one warm-up, three timed runs) with
    the verifier `svm` (default: the shipped one), print the phase line, and
    hold launches and acceptance to their bounds.  The caller set the launch
    counts to 0 just before the part of its path that ends here; `on_path`
    names the kernels that part runs.  Returns the launch counts and K1's
    {(L, M_f, M_b): launches}."""
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.registration import register_locations_staged
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    dev = ctx.device
    queries = np.asarray(meta["queries"], np.float32)
    true = Affine3D(*(torch.tensor(meta["true"][k], device=dev) for k in ("A", "t", "center")))
    ref = meta["lrr_tpu_reference"]
    svm = load_default_verifier() if svm is None else svm
    q = torch.as_tensor(queries, device=dev)
    counts0 = kernels.counts()

    def serve(run: int):
        g = torch.Generator().manual_seed(seed * 1000 + run)
        plan = draw_sampling_plan(
            g, len(queries), cfg, ctx.moving_features.capacity,
            ctx.fixed_features.capacity, dev,
        )
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = register_locations_staged(ctx, q, cfg, svm, plan)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, warm_s = serve(0)
    times = []
    for r in range(3):
        before = kernels.LAUNCHES["normal_equations"]
        out, s = serve(r + 1)
        times.append(s)
    launches = dict(kernels.LAUNCHES)
    k1_shapes = sorted(kernels.K1_SHAPES.items(), key=lambda kv: -kv[1])
    note_path_shapes(label, kernels.counts_since(counts0))

    acc = acceptance_stats(out, queries, true)
    rec = {
        "card": card, "queries": len(queries), **fields, "warmup_s": warm_s,
        "run_s": times, "locations_per_s": len(queries) / min(times),
        "locations_per_s_median": len(queries) / statistics.median(times),
        **acc, "launches": launches,
        "k1_launches_last_run": launches["normal_equations"] - before,
        "k1_shapes": [{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n} for k, n in k1_shapes],
        "k2_shapes": k2_shape_rows(kernels.K2_SHAPES),
        "lrr_tpu_reference": {k: ref[k] for k in ("verified_frac", "rank0_frac",
                                                   "median_gt_error_mm")},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    phase(label, **rec)
    for name in on_path:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was never launched on the main path")
    slack = 2.0 / len(queries)
    if acc["verified_frac"] < ref["verified_frac"] - slack:
        raise AssertionError(f"{label}: verified_frac {acc['verified_frac']} below {ref['verified_frac']}")
    if acc["rank0_frac"] < ref["rank0_frac"] - slack:
        raise AssertionError(f"{label}: rank0_frac {acc['rank0_frac']} below {ref['rank0_frac']}")
    err_cap = max(1.0, 1.5 * ref["median_gt_error_mm"])
    if acc["median_gt_error_mm"] is None or acc["median_gt_error_mm"] > err_cap:
        raise AssertionError(f"{label}: median_gt_error_mm {acc['median_gt_error_mm']} above {err_cap}")
    return launches, dict(k1_shapes)


def run_slice(seed: int, card: str):
    """Phase 4: the committed bench context, loaded and served."""
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context

    meta, cfg = load_bench_meta()
    # the main path, counted: context load (descriptor-NN table) + serving.
    # No device is named: the port's entry point takes the card by itself.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ctx = load_pair_context(BENCH + ".npz")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    return serve_and_check("slice", ctx, cfg, meta, seed, card, load_s=load_s)


# ---------------------------------------------------------------------------
# phases 5 and 6: stage 1
# ---------------------------------------------------------------------------

STAGES = ("detect_features", "extract_keypoints", "compute_descriptors",
          "build_feature_voronoi", "descriptor_nn_table", "bake_target_grid")


def timed_prepare_pair(moving, fixed, cfg):
    """`prepare_pair` through its entry point, with the stage functions it
    calls wrapped so that each call is ended by a synchronise and timed:
    (context, {stage: [seconds per call]}, keypoints found per volume);
    calls run moving first."""
    from lrr_tpu_torch.pipeline import registration

    seconds = {name: [] for name in STAGES}
    keypoints = []
    originals = {name: getattr(registration, name) for name in STAGES}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            if name == "extract_keypoints":
                keypoints.append(int(out.count()))
            return out
        return call

    for name in STAGES:
        setattr(registration, name, timed(name))
    try:
        t0 = time.perf_counter()
        ctx = registration.prepare_pair(moving, fixed, cfg)
        torch.cuda.synchronize()
        seconds["prepare_pair"] = [time.perf_counter() - t0]
    finally:
        for name, fn in originals.items():
            setattr(registration, name, fn)
    return ctx, seconds, keypoints


def context_counts(ctx, keypoints: list[int]) -> dict:
    """[moving, fixed] counts of a prepared context."""
    return {
        "features": [int(ctx.moving_features.count()), int(ctx.fixed_features.count())],
        "keypoints": keypoints,
        "valid_descriptors": [int(ctx.moving_descriptors.keypoints.count()),
                              int(ctx.fixed_descriptors.keypoints.count())],
        "map_shapes": [list(ctx.moving_vor.index_vol.shape), list(ctx.fixed_vor.index_vol.shape)],
    }


def share_matched(a, b, tol_mm: float) -> float:
    """Share of a's valid features with a valid feature of b within
    `tol_mm` and of the same shape class."""
    from lrr_tpu_torch.ops.knn import nn1

    d2, i = nn1(a.xyz, b.xyz, b.mask)
    ok = a.mask & (d2 <= tol_mm**2) & (a.shape == b.shape[i])
    return float(ok.sum()) / max(int(a.mask.sum()), 1)


def run_stage1_bench(seed: int, card: str):
    """Phase 5: volume to verified transform at bench scale."""
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.utils.synthetic import make_pair

    meta, cfg = load_bench_meta()
    pair = meta["pair"]
    committed = load_pair_context(BENCH + ".npz")  # for the agreement check only
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fixed, moving, true = make_pair(
        tuple(pair["shape_zyx"]), rotation_deg=pair["rotation_deg"],
        translation=tuple(pair["translation"]), seed=pair["seed"],
    )
    torch.cuda.synchronize()
    phantom_s = time.perf_counter() - t0
    for k in ("A", "t", "center"):
        if not np.allclose(getattr(true, k).cpu().numpy(), np.asarray(meta["true"][k]), atol=1e-5):
            raise AssertionError(f"stage1_bench: true.{k} differs from the committed pair's")
    ctx, seconds, keypoints = timed_prepare_pair(moving, fixed, cfg)
    note_path_shapes("stage1_bench")  # the maps' K4 launches: serving counts from here on
    agreement = {
        side: [share_matched(getattr(ctx, side), getattr(committed, side), 0.01),
               share_matched(getattr(committed, side), getattr(ctx, side), 0.01)]
        for side in ("moving_features", "fixed_features")
    }
    del committed
    out = serve_and_check(
        "stage1_bench", ctx, cfg, meta, seed, card, phantom_s=phantom_s,
        stage_s=seconds, **context_counts(ctx, keypoints), feature_agreement=agreement,
    )
    for side, shares in agreement.items():
        if min(shares) < 0.95:
            raise AssertionError(f"stage1_bench: {side} agreement {shares} below 0.95")
    return out, (ctx, moving, fixed, cfg, meta)


def k4_key(shape: tuple[int, int, int], n: int) -> str:
    return "x".join(map(str, (*shape, n)))


def measure_k4(timer, xyz, mask, origin, spacing, shape: tuple[int, int, int]) -> dict:
    """K4 against its plain version on the card (`voronoi_map_exact_plain`:
    the blocked build above 4M voxels, else the brute force) on one map:
    bits (twice), the pairs it evaluated, times and bound.  Its launches
    here are taken back from the counters: they are not a path's."""
    from lrr_tpu_torch.ops import kernels, voronoi
    from lrr_tpu_torch.utils import sol

    before = kernels.counts()
    args = (xyz, mask, origin, spacing, tuple(shape))
    stats = torch.zeros(2, dtype=torch.int64, device=xyz.device)
    got = kernels.voronoi_nearest(*args, stats=stats)
    again = kernels.voronoi_nearest(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = voronoi.voronoi_map_exact_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    key = k4_key(shape, xyz.shape[0])
    if not torch.equal(got, again):
        raise AssertionError(f"K4 {key}: two launches on the same inputs differ")
    if not torch.equal(got, plain):
        raise AssertionError(f"K4 {key}: {int((got != plain).sum())} voxels differ from the "
                             f"plain build")
    del again, plain
    pairs, kept = (int(v) for v in stats.cpu())
    n_vox = math.prod(shape)
    bound, by = sol.voronoi_bound_ms(n_vox, xyz.shape[0], pairs)
    fn = lambda: kernels.voronoi_nearest(*args)  # noqa: E731
    ms = timer.ms(fn, reps=5)
    rec = {"shape": list(shape), "features": xyz.shape[0], "valid": int(mask.sum()),
           "bit_identical": True, "pairs": pairs, "pairs_per_voxel": pairs / n_vox,
           "kept_per_block": kept / math.prod(-(-d // 16) for d in shape),
           "ms": ms, "ms_warm": timer.ms(fn, reps=5, cold=False), "plain_ms": plain_ms,
           "plain": "blocked" if n_vox > voronoi._BLOCKED_MIN_VOXELS else "brute_force",
           "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms}
    kernels.add_counts(kernels.counts_since(before), -1)
    K4_MEASURED[key] = rec
    return rec


def k4_inputs(rng, shape: tuple[int, int, int], n: int, dev):
    """n features (15 % masked) uniform in the ellipsoid inscribed in a
    1 mm map of `shape` at the origin: dense inside, empty corners."""
    D, H, W = shape
    u = rng.standard_normal((n, 3))
    u *= (rng.uniform(size=(n, 1)) ** (1 / 3)) / np.linalg.norm(u, axis=1, keepdims=True)
    half = np.array([W, H, D], np.float64) / 2 - 2.0
    xyz = torch.tensor(u * half + half + 2.0, dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.uniform(size=n) > 0.15, device=dev)
    return xyz, mask, torch.zeros(3, device=dev), torch.ones(3, device=dev)


def k5_key(L: int, m: int, kind: str) -> str:
    return f"{L}x{m}_{kind}"


def sample_shape(key: str) -> tuple[int, int, str]:
    """A `kernels.SAMPLE_SHAPES` key from its "Lxmxkind" form (phase 13's
    ranks write them so)."""
    L, m, kind = key.split("x")
    return int(L), int(m), kind


def k5_inputs(rng, L: int, n: int, shape: tuple[int, int, int], dev, box_mm: float = 50.0):
    """(src, grid, vor, trans, number, offset, dst_rows) for K5 on a 1 mm map
    of `shape`: n source and n target features drawn as `k4_inputs` draws
    them (15 % masked, their rows' tag 0), the targets' exact Voronoi map
    (K4) and its baked grid; each lane's mask the valid sources in a
    `box_mm` cube about a random source (a candidate's ROI), its transform a
    rotation of up to 3 degrees about z and a shift of up to 2 mm about that
    centre, its window offset below 2^62, its match count 10^9 (every valid
    source inside the capacity is kept).  The K4 launch is taken back from
    the counters: it is not a path's."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels

    before = kernels.counts()
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    def rows(xyz, mask):
        d = rng.standard_normal((n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tag = t(rng.integers(1, 4, n)) * mask
        return torch.cat([xyz, t(rng.uniform(0.5, 5.0, (n, 1))), t(d), tag[:, None]], 1)

    xyz_s, mask_s, origin, spacing = k4_inputs(rng, shape, n, dev)
    xyz_d, mask_d, _, _ = k4_inputs(rng, shape, n, dev)
    src_rows, dst_rows = rows(xyz_s, mask_s).contiguous(), rows(xyz_d, mask_d).contiguous()
    vor = icp.VoronoiGrid(kernels.voronoi_nearest(xyz_d, mask_d, origin, spacing, shape),
                          origin, spacing)
    flat = vor.index_vol.reshape(-1).long()
    grid = torch.where((flat >= 0)[:, None], dst_rows[flat.clamp(min=0)],
                       torch.zeros((1, 8), device=dev))
    del flat
    centers = xyz_s[t(rng.integers(0, n, L), torch.int64)]
    lane_mask = mask_s[None, :] & ((xyz_s[None, :, :] - centers[:, None, :]).abs()
                                   <= box_mm / 2).all(-1)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    scores = torch.rand((L, n), generator=gen, device=dev)
    src = icp._pack_source(scores, src_rows, lane_mask)
    ang = np.deg2rad(rng.uniform(-3, 3, L))
    A = np.zeros((L, 3, 3))
    A[:, 0, 0], A[:, 0, 1] = np.cos(ang), -np.sin(ang)
    A[:, 1, 0], A[:, 1, 1] = np.sin(ang), np.cos(ang)
    A[:, 2, 2] = 1.0
    trans = Affine3D(A=t(A), t=(centers + t(rng.uniform(-2, 2, (L, 3)))).contiguous(),
                     center=centers.contiguous())
    number = torch.full((L,), 10**9, dtype=torch.int64, device=dev)
    offset = t(rng.integers(0, 1 << 62, L), torch.int64)
    kernels.add_counts(kernels.counts_since(before), -1)
    return src, grid, vor, trans, number, offset, dst_rows


def k5_target_rows(inputs, m: int, kind: str) -> int:
    """The distinct 32-byte target reads of the window positions [0, m) of
    `k5_inputs`: grid rows, or without a grid the map's sectors and the
    feature rows they name (the plain path's voxel ids)."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.ops.voronoi import voxel_ids

    src, _, vor, trans, _, offset, _ = inputs
    idx = icp._window(src.order, src.valid_count, offset,
                      torch.arange(m, device=src.order.device))
    mapped = icp._apply_packed(trans, src.rows[idx].permute(0, 2, 1)[:, 0:3])
    ids = voxel_ids(tuple(vor.index_vol.shape), vor.origin, vor.spacing, mapped.transpose(1, 2))
    if kind == "grid":
        return int(torch.unique(ids).numel())
    nn = vor.index_vol.reshape(-1)[ids]
    return int(torch.unique(ids // 8).numel()) + int(torch.unique(nn[nn >= 0]).numel())


def measure_k5(timer, inputs, cap: int, kind: str, gather_gb_s: float | None) -> dict:
    """K5 against its plain version on the card (`icp.sample_matches_plain`)
    on one set of `k5_inputs`, through the baked grid (`kind` "grid") or the
    bare map ("map"): bits of all four outputs (twice), the share of window
    positions kept, times, the bound (`sol.sample_matches_bound_ms` over the
    distinct target reads) and, with `gather_gb_s`, the same bytes with the
    target reads priced at that random-row rate.  Its launches here are
    taken back from the counters: they are not a path's."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.wave_graph import first_difference
    from lrr_tpu_torch.utils import sol

    src, grid, vor, trans, number, offset, dst_rows = inputs
    L, m = src.order.shape[0], min(cap, src.order.shape[1])
    args = (src, grid if kind == "grid" else None, vor, trans, number, m, offset)
    before = kernels.counts()

    def k5():
        return kernels.sample_matches(*args, dst_rows=dst_rows, p0=0, m=m)

    def plain():
        return icp.sample_matches_plain(*args, dst_rows=dst_rows, p0=0, m=m)

    got, again, want = k5(), k5(), plain()
    key = k5_key(L, m, kind)
    for other, what in ((want, "the plain sampler"), (again, "a second launch")):
        field = first_difference(got, other)
        if field is not None:
            raise AssertionError(f"K5 {key}: output {field} differs from {what}")
    kept = float(got[3].float().mean())
    del got, again, want
    ms = timer.ms(k5)
    rows = k5_target_rows(inputs, m, kind)
    bound, by = sol.sample_matches_bound_ms(L, m, src.rows.shape[0], rows)
    rec = {"lanes": L, "m": m, "kind": kind, "bit_identical": True, "kept_share": kept,
           "target_reads": rows, "ms": ms, "ms_warm": timer.ms(k5, cold=False),
           "plain_ms": timer.ms(plain, reps=5), "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / ms}
    if gather_gb_s is not None:
        rec["random_rows_ms"] = sol.sample_matches_bound_ms(L, m, src.rows.shape[0], rows,
                                                            gather_gb_s)[0]
    kernels.add_counts(kernels.counts_since(before), -1)
    K5_MEASURED[key] = rec
    return rec


def check_k5(rng, dev, timer) -> dict:
    """K5 at copd512's wave shapes: 512 lanes at each capacity of its
    schedule through a baked grid of copd512's map (320 x 352 x 352 at 1 mm,
    65,536 features a side), and at 2,048 through the bare map."""
    from lrr_tpu_torch.utils import sol

    gather = sol.measured_gather_roofline(dev)["gather_gb_s_dense_big"]
    inputs = k5_inputs(rng, 512, 65536, COPD512_MAP, dev)
    out = {k5_key(512, cap, "grid"): measure_k5(timer, inputs, cap, "grid", gather)
           for cap in K5_CAPS}
    out[k5_key(512, 2048, "map")] = measure_k5(timer, inputs, 2048, "map", gather)
    out["gather_gb_s"] = gather
    del inputs
    return out


def run_stage1_reference(card: str, timer):
    """Phase 6: stage 1 at the reference constants.  The pair and its
    context go on to phase 7, and so do the launch counts: set to 0 here,
    read there, over the path volume -> context -> regions -> served."""
    from lrr_tpu_torch.eval.repeatability import feature_repeatability
    from lrr_tpu_torch.features.extract import detect_features
    from lrr_tpu_torch.ops import kernels, voronoi
    from lrr_tpu_torch.utils.synthetic import make_pair
    from lrr_tpu_torch.verify import train_default

    cfg = train_default.reference_cfg()
    shape = (400, 350, 350)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fixed, moving, true = make_pair(
        shape, rotation_deg=6.0, translation=(3.0, -2.0, 1.5), seed=11, noise=0.5, dense=True
    )
    torch.cuda.synchronize()
    phantom_s = time.perf_counter() - t0
    ctx, seconds, keypoints = timed_prepare_pair(moving, fixed, cfg)
    launches = dict(kernels.LAUNCHES)
    k2_shapes = dict(kernels.K2_SHAPES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rep = feature_repeatability(ctx.fixed_features, ctx.moving_features, true.inverse().apply)
    rep_dist, rep_angle = float(rep.fraction_distance_ok), float(rep.fraction_repeatable)

    # run to run: the same volume gives the same bits
    t0 = time.perf_counter()
    again = detect_features(fixed, cfg.features)
    torch.cuda.synchronize()
    detect_again_s = time.perf_counter() - t0
    same_bits = all(
        torch.equal(getattr(again, f), getattr(ctx.fixed_features, f))
        for f in ("xyz", "strength", "shape", "projector", "directions", "mask")
    )
    del again

    # the two exact builds on one 32-aligned sub-box (64^3 where the map
    # allows) of the fixed map
    fs, fv = ctx.fixed_features, ctx.fixed_vor
    D, H, W = fv.index_vol.shape
    z0, y0, x0 = (32 * ((n // 2) // 32) for n in (D, H, W))
    sub = (min(64, D - z0), min(64, H - y0), min(64, W - x0))
    sub_origin = fv.origin + torch.tensor([x0, y0, z0], device=fv.origin.device) * fv.spacing
    t0 = time.perf_counter()
    brute = voronoi.voronoi_map_exact(fs.xyz, fs.mask, sub_origin, fv.spacing, sub)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    blocked = voronoi.voronoi_map_exact_blocked(fs.xyz, fs.mask, sub_origin, fv.spacing, sub)
    exact_builds_equal = torch.equal(brute, blocked)
    before = kernels.counts()
    k4_equal_on_subbox = torch.equal(
        brute, kernels.voronoi_nearest(fs.xyz, fs.mask, sub_origin, fv.spacing, sub))
    kernels.add_counts(kernels.counts_since(before), -1)  # a check, not the path's
    differs_from_map = int(
        (brute != fv.index_vol[z0 : z0 + sub[0], y0 : y0 + sub[1], x0 : x0 + sub[2]]).sum()
    )

    # K4 against the plain blocked build at the fixed map's shape (the
    # path's) and at copd512's (a box of that shape at this map's origin)
    k4 = {"path": measure_k4(timer, fs.xyz, fs.mask, fv.origin, fv.spacing, (D, H, W)),
          "copd512": measure_k4(timer, fs.xyz, fs.mask, fv.origin, fv.spacing, COPD512_MAP)}

    counts = context_counts(ctx, keypoints)
    digests = context_digests(ctx)
    phase(
        "stage1_reference", card=card, volume=list(shape), phantom_s=phantom_s, stage_s=seconds,
        **counts, repeatability_2mm=rep_dist, repeatability_2mm_20deg=rep_angle,
        launches=launches,
        k2_shapes=k2_shape_rows(k2_shapes),
        detect_again_s=detect_again_s, detect_bit_identical=same_bits,
        exact_builds_equal_on_subbox=exact_builds_equal, subbox_brute_force_s=brute_s,
        k4_equal_on_subbox=k4_equal_on_subbox, k4=k4,
        subbox_voxels_differing_from_map=differs_from_map,
        grids_baked=[ctx.moving_grid is not None, ctx.fixed_grid is not None],
        peak_mem_gb=peak_gb, digests=digests,
    )
    if min(counts["features"]) < 30000:
        raise AssertionError(f"stage1_reference: feature counts {counts['features']} below 30000")
    if min(counts["valid_descriptors"]) < 1000:
        raise AssertionError(
            f"stage1_reference: valid descriptors {counts['valid_descriptors']} below 1000")
    if rep_dist < 0.5:
        raise AssertionError(f"stage1_reference: repeatability at 2 mm {rep_dist} below 0.5")
    if k2_shapes.get((4096, 4096, 195, 1), 0) < 1:
        raise AssertionError(f"stage1_reference: no K2 launch at 4096 x 4096 x 195, k=1: {k2_shapes}")
    if not exact_builds_equal:
        raise AssertionError("stage1_reference: the two exact Voronoi builds differ")
    if not k4_equal_on_subbox:
        raise AssertionError("stage1_reference: K4 differs from the brute force on the sub-box")
    if launches["voronoi"] != 2:
        raise AssertionError(f"stage1_reference: {launches['voronoi']} K4 launches in "
                             f"prepare_pair, not one a map")
    if not same_bits:
        raise AssertionError("stage1_reference: two runs of detect_features differ")
    return ctx, moving, fixed, true, cfg, digests


FEATURE_FIELDS = ("xyz", "strength", "shape", "projector", "directions", "mask")


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def context_digests(ctx) -> dict:
    """SHA-256 of the bytes of a context's Voronoi maps and feature sets."""
    return {
        "moving_vor": sha256(ctx.moving_vor.index_vol), "fixed_vor": sha256(ctx.fixed_vor.index_vol),
        **{f"{side}.{f}": sha256(getattr(getattr(ctx, side), f))
           for side in ("moving_features", "fixed_features") for f in FEATURE_FIELDS},
    }


# ---------------------------------------------------------------------------
# phases 7 and 8: regions, serving at the reference constants, the other
# entry points
# ---------------------------------------------------------------------------

WATERSHED_STAGES = ("anisotropic_diffusion", "gradient_magnitude", "watershed_labels")


def timed_segment_pair(moving, fixed, ctx):
    """`segment_pair` through its entry point with the watershed's stage
    functions wrapped as in `timed_prepare_pair`: (context, record); calls
    run moving first.  `pointer_jumps` holds rounds and seconds of each
    `p <- p[p]` loop (two a volume), `basins` the distinct labels."""
    from lrr_tpu_torch.ops import watershed
    from lrr_tpu_torch.pipeline import registration

    names = WATERSHED_STAGES + ("_pointer_jump",)
    seconds = {name: [] for name in WATERSHED_STAGES}
    jumps, basins = [], []
    originals = {name: getattr(watershed, name) for name in names}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name == "_pointer_jump":
                jumps.append({"rounds": out[1], "seconds": dt})
            else:
                seconds[name].append(dt)
            if name == "watershed_labels":
                # a label is the flat index of a voxel that carries it
                flat = out.reshape(-1)
                own = torch.arange(flat.numel(), dtype=flat.dtype, device=flat.device)
                basins.append(int((flat == own).sum()))
            return out
        return call

    for name in names:
        setattr(watershed, name, timed(name))
    try:
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        out = registration.segment_pair(moving, fixed, ctx)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(watershed, name, fn)
    return out, {
        "segment_pair_s": total, "stage_s": seconds, "pointer_jumps": jumps, "basins": basins,
        "regions": [int(out.moving_region_labels.max()) + 1,
                    int(out.fixed_region_labels.max()) + 1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "held_before_gb": held_gb,
    }


def gt_errors(trans, queries: np.ndarray, true) -> torch.Tensor:
    """[Q, C] error in mm of every transform of a [Q, C] batch against the
    true one, on `acceptance_stats`' 20 probes around each query (median)."""
    inv = true.inverse()
    rows = []
    for q in range(len(queries)):
        probe = queries[q][None, :] + np.random.default_rng(q).uniform(
            -15, 15, (20, 3)).astype(np.float32)
        src = inv.apply(torch.as_tensor(probe, device=trans.A.device))
        err = torch.linalg.norm(trans[q].apply(src) - true.apply(src), dim=-1)  # [C, 20]
        rows.append(err.median(-1).values)
    return torch.stack(rows)


def pass1_lanes(ctx, q: torch.Tensor, cfg, plan):
    """PASS 1 of the serving path, and its Q x C candidates as lanes:
    (cmask, inits, enough, rank, lane transforms, lane queries)."""
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.pipeline import registration

    cmask, inits, _, enough, _, rank, _, _ = registration._pass1_fn(ctx, q, cfg, plan)
    Q, C = cmask.shape
    flat = Affine3D(inits.A.flatten(0, 1), inits.t.flatten(0, 1), inits.center.flatten(0, 1))
    return cmask, inits, enough, rank, flat, q[:, None, :].expand(Q, C, 3).reshape(Q * C, 3)


def spread(x: torch.Tensor) -> list:
    """[min, median, max] of a tensor's values."""
    x = x.reshape(-1).float()
    if x.numel() == 0:
        return [None, None, None]
    return [float(x.min()), float(np.median(x.cpu().numpy())), float(x.max())]


def reference_queries(moving) -> np.ndarray:
    """16 queries inside the phantom's structured ellipsoid, as lrr_tpu's
    reference-scale profile draws them."""
    D, H, W = moving.data.shape
    ext = [float(W), float(H), float(D)]
    return np.random.default_rng(1).uniform(
        [0.3 * e for e in ext], [0.7 * e for e in ext], (16, 3)).astype(np.float32)


def run_serve_reference(seed: int, card: str, ref):
    """Phase 7: regions attached and 16 queries served at the reference
    constants, on phase 6's pair and context."""
    import dataclasses

    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    ctx, moving, fixed, true, cfg, _ = ref
    dev = ctx.device
    ctx_r, seg = timed_segment_pair(moving, fixed, ctx)

    queries = reference_queries(moving)
    q = torch.as_tensor(queries, device=dev)
    Q, C = len(queries), cfg.indexing.num_candidates
    svm = load_default_verifier()

    def plan_for(run: int):
        g = torch.Generator().manual_seed(seed * 1000 + 700 + run)
        return draw_sampling_plan(
            g, Q, cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity, dev)

    # the region-grown sets against the box sets, over PASS 1's lanes; the
    # plan is drawn on the CPU and moved to the card (one seed, one plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = plan_for(0)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    cmask, inits, enough, rank, flat, q_lanes = pass1_lanes(ctx_r, q, cfg, plan)
    grown = registration._candidate_rois(ctx_r, flat, q_lanes, cfg)
    box = registration._candidate_rois(ctx, flat, q_lanes, cfg)
    target = cfg.estimation.target_region_features
    live = cmask.reshape(-1)
    masks_equal = True
    for g_sel, b_sel in ((grown[0], box[0]), (grown[1], box[1])):
        small = b_sel.sum(-1) < target
        masks_equal &= bool(torch.equal(g_sel[small], b_sel[small]))
    in_box = {
        "fixed_per_query": spread(box[1].sum(-1).reshape(Q, C)[:, 0]),
        "moving_per_candidate": spread(box[0].sum(-1)[live]),
        "lanes_under_target": int(((box[0].sum(-1) < target) & (box[1].sum(-1) < target)).sum()),
    }
    usable = (cmask & enough)
    rank0 = rank[:, 0]
    init_err = gt_errors(inits, queries, true)
    del grown, box

    waves, outs, times = [], [], []
    wave_runner = registration._wave_runner

    def counted(*args, **kwargs):  # lanes a wave, its bucket included
        run = wave_runner(*args, **kwargs)

        def counted_run(queries_, inits_, plan_, lanes, cand_idx):
            waves[-1].append(int(lanes.numel()))
            return run(queries_, inits_, plan_, lanes, cand_idx)

        return counted_run

    registration._wave_runner = counted
    try:
        # warm-up on plan 0; timed runs on plans 1, 2 and 2 again
        for run in (0, 1, 2, 2):
            if run != 0 and len(outs) < 3:
                plan = plan_for(run)
            waves.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = registration.register_locations_staged(ctx_r, q, cfg, svm, plan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append(out)
    finally:
        registration._wave_runner = wave_runner
    launches = dict(kernels.LAUNCHES)
    k1_shapes = sorted(kernels.K1_SHAPES.items(), key=lambda kv: -kv[1])
    note_path_shapes("serve_reference")
    k2_shapes = dict(kernels.K2_SHAPES)

    # the last plan again from the bare index maps (after the counts were
    # read): the same rows, so the same result; its seconds beside the grids'
    ctx_bare = dataclasses.replace(ctx_r, fixed_grid=None, moving_grid=None)
    bare_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare = registration.register_locations_staged(ctx_bare, q, cfg, svm, plan)
        torch.cuda.synchronize()
        bare_s.append(time.perf_counter() - t0)
    bare_equal = all(torch.equal(a, b) for a, b in (
        (bare.selected, outs[-1].selected), (bare.trans.A, outs[-1].trans.A),
        (bare.trans.t, outs[-1].trans.t), (bare.probability, outs[-1].probability)))
    del plan, bare, ctx_bare

    out = outs[-1]
    acc = acceptance_stats(out, queries, true)
    sel = out.selected.cpu().numpy()
    rank_h = out.rank.cpu().numpy()
    final_err = gt_errors(out.trans, queries, true)
    refined = out.refined
    good = refined & (final_err < 1.0)
    diagnosis = unverified_under_1mm(out, final_err)
    rec = {
        "card": card, "queries": Q, "candidates": C, "segment": seg,
        "plan_draw_s": plan_s, "warmup_s": times[0], "run_s": times[1:], "waves": waves[1:],
        "verified": int((sel >= 0).sum()), **acc,
        "accepted_rank_positions": [
            int(np.nonzero(rank_h[i] == sel[i])[0][0]) if sel[i] >= 0 else None
            for i in range(Q)],
        "in_box_features": in_box, "region_masks_equal_box_masks": masks_equal,
        "same_plan_same_selected": bool(torch.equal(outs[-1].selected, outs[-2].selected)),
        "bare_index_map": {
            "run_s": bare_s, "equal_to_grid_run": bare_equal,
            "grids_baked": [ctx_r.moving_grid is not None, ctx_r.fixed_grid is not None]},
        "usable_candidates_per_query": usable.sum(1).tolist(),
        "rank0_initial_error_mm": init_err.gather(1, rank0[:, None])[:, 0].tolist(),
        "best_initial_error_mm": torch.where(
            usable, init_err, torch.full_like(init_err, float("inf"))).min(1).values.tolist(),
        "refined_candidates": int(refined.sum()),
        "refined_under_1mm": int(good.sum()),
        "refined_under_1mm_probability": spread(out.probability[good]),
        "refined_under_1mm_unverified": out.probability[good & ~out.verified].tolist(),
        "verified_over_1mm": int((out.verified & (final_err >= 1.0)).sum()),
        "unverified_under_1mm": diagnosis,
        "unverified_queries": [int(i) for i in np.nonzero(sel < 0)[0]],
        "lrr_tpu_reference": lrr_tpu_reference_record(),
        "launches": launches,
        "k1_shapes": [{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n} for k, n in k1_shapes],
        "k2_shapes": k2_shape_rows(k2_shapes),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    phase("serve_reference", **rec)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve_reference: kernel {name} was never launched on the path")
    if not any(8000 in k[1:] for k, _ in k1_shapes):
        raise AssertionError(f"serve_reference: K1 saw no shape with 8000 matches: {k1_shapes}")
    if k2_shapes.get((4096, 4096, 195, 1), 0) < 1:
        raise AssertionError(f"serve_reference: no K2 launch at 4096 x 4096 x 195: {k2_shapes}")
    if rec["verified"] < 12:
        raise AssertionError(f"serve_reference: {rec['verified']} of {Q} queries verified, want 12")
    if acc["median_gt_error_mm"] is None or acc["median_gt_error_mm"] >= 1.0:
        raise AssertionError(f"serve_reference: median GT error {acc['median_gt_error_mm']} mm")
    if not masks_equal:
        raise AssertionError("serve_reference: region-grown masks differ from the box masks "
                             "where the box holds fewer features than the target")
    if not rec["same_plan_same_selected"]:
        raise AssertionError("serve_reference: two runs with one plan selected differently")
    if not bare_equal:
        raise AssertionError("serve_reference: the run from the bare index maps differs "
                             "from the run from the grids")
    # what phase 13 serves again over two ranks: the last run's plan and result
    served = {"plan_seed": seed * 1000 + 700 + 2, "selected": sel.tolist(),
              "median_gt_error_mm": acc["median_gt_error_mm"],
              "verified": out.verified.cpu().numpy().tolist(),
              "refined": out.refined.cpu().numpy().tolist(),
              "selected_trans": {str(i): {k: getattr(out.trans, k)[i, int(sel[i])].tolist()
                                          for k in ("A", "t", "center")}
                                 for i in range(Q) if sel[i] >= 0}}
    return launches, dict(k1_shapes), served, (ctx_r, queries, true, diagnosis)


def lrr_tpu_reference_record() -> dict:
    """The record of lrr_tpu serving this pair and these queries at the same
    constants, on the CPU with its own draws
    (`lrr_tpu_torch/data/reference_constants_lrr_tpu.json`, written by
    `scripts/make_torch_fixtures.py --reference-constants`): per query the
    selection and the best refined candidate's P(aligned) and error."""
    with open(os.path.join(ROOT, "lrr_tpu_torch", "data",
                           "reference_constants_lrr_tpu.json")) as f:
        ref = json.load(f)
    rows = ref["per_query"]
    return {
        "platform": ref["platform"], "verified": ref["verified"],
        "median_gt_error_mm": ref["median_selected_gt_error_mm"],
        "unverified_queries": [r["query"] for r in rows if r["selected"] < 0],
        "per_query": [{k: r[k] for k in ("query", "selected", "rank_position",
                                         "best_refined_gt_error_mm", "best_refined_probability")}
                      for r in rows],
    }


def unverified_under_1mm(out, final_err: torch.Tensor) -> list[dict]:
    """For each query that verified nothing although a refined candidate
    lies under 1 mm of the true transform: the best such candidate's 8
    measurements beside the range the verifier scales them by (the
    reference's train-set min / max) and the range of the committed training
    corpus, each coordinate flagged where it falls outside, and P(aligned)
    under the shipped model."""
    from lrr_tpu_torch.verify import svm as svm_mod
    from lrr_tpu_torch.verify.train_default import load_corpus

    corpus = np.concatenate([x for _, x, _ in load_corpus()])
    lo, hi = corpus.min(0), corpus.max(0)
    err = torch.where(out.refined, final_err, torch.full_like(final_err, float("inf")))
    rows = []
    for q in range(err.shape[0]):
        c = int(err[q].argmin())
        if int(out.selected[q]) >= 0 or float(err[q, c]) >= 1.0:
            continue
        m = out.measurements[q, c].double().cpu().numpy()
        rows.append({
            "query": q, "candidate": c, "gt_error_mm": float(err[q, c]),
            "measurements": m.tolist(),
            "scaling_min": svm_mod.REFERENCE_FEATURE_MIN.tolist(),
            "scaling_max": svm_mod.REFERENCE_FEATURE_MAX.tolist(),
            "outside_scaling": [int(i) for i in np.nonzero(
                (m < svm_mod.REFERENCE_FEATURE_MIN) | (m > svm_mod.REFERENCE_FEATURE_MAX))[0]],
            "corpus_min": lo.tolist(), "corpus_max": hi.tolist(),
            "outside_corpus": [int(i) for i in np.nonzero((m < lo) | (m > hi))[0]],
            "p_shipped": float(out.probability[q, c]),
        })
    return rows


def whole_regions(sel: torch.Tensor, box: torch.Tensor, labels: torch.Tensor) -> bool:
    """Every region is wholly in or wholly out of `sel` [L, N] among the
    in-box features `box` [L, N]; `labels` [N] are compact region ids."""
    L, N = sel.shape
    index = labels.long()[None].expand(L, N)
    n_reg = int(labels.max()) + 1

    def per_region(mask):
        return torch.zeros((L, n_reg), dtype=torch.int64, device=sel.device).scatter_add_(
            1, index, mask.long())

    taken, held = per_region(sel & box), per_region(box)
    return bool(((taken == 0) | (taken == held)).all())


def run_regions_bench(seed: int, card: str, bench):
    """Phase 8: the bench pair with regions that cut the box, then the
    refine-all, rigid, replay and grid-less entry points."""
    import dataclasses

    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    ctx, moving, fixed, cfg, meta = bench
    dev = ctx.device
    queries = np.asarray(meta["queries"], np.float32)
    q = torch.as_tensor(queries, device=dev)
    Q = len(queries)
    true = Affine3D(*(torch.tensor(meta["true"][k], device=dev) for k in ("A", "t", "center")))
    svm = load_default_verifier()
    problems = []

    # launches of each entry point on its own: the counts are read and set to
    # 0 after every one of them
    by_entry, k1_all = {}, {}

    def close_entry(name: str, k1_on_path: bool):
        n = dict(kernels.LAUNCHES)
        by_entry[name] = {**n, "k1_shapes": [
            {"L": k[0], "M_f": k[1], "M_b": k[2], "launches": c}
            for k, c in sorted(kernels.K1_SHAPES.items(), key=lambda kv: -kv[1])]}
        for k, c in kernels.K1_SHAPES.items():
            k1_all[k] = k1_all.get(k, 0) + c
        if k1_on_path and n["normal_equations"] <= 0:
            problems.append(f"{name}: K1 was never launched")
        if not k1_on_path and n["normal_equations"] != 0:
            problems.append(f"{name}: K1 launched {n['normal_equations']} times off its path")
        note_path_shapes(f"regions_bench_{name}")
        kernels.reset_launch_counts()

    kernels.reset_launch_counts()
    ctx_r, seg = timed_segment_pair(moving, fixed, ctx)
    g = torch.Generator().manual_seed(seed * 1000 + 800)
    plan = draw_sampling_plan(
        g, Q, cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity, dev)

    # a target below what the boxes hold, so that growth stops inside them
    cmask, _, enough, _, flat, q_lanes = pass1_lanes(ctx, q, cfg, plan)
    live = (cmask & enough).reshape(-1)
    box = registration._candidate_rois(ctx, flat, q_lanes, cfg)
    box_counts = torch.cat([box[0].sum(-1)[live], box[1].sum(-1)[live]])
    target = max(int(np.median(box_counts.cpu().numpy())) // 2, 1)
    cfg_r = dataclasses.replace(
        cfg, estimation=dataclasses.replace(cfg.estimation, target_region_features=target))
    grown = registration._candidate_rois(ctx_r, flat, q_lanes, cfg_r)
    lanes_differ = 0
    for side, g_sel, b_sel, labels in (
            ("moving", grown[0], box[0], ctx_r.moving_region_labels),
            ("fixed", grown[1], box[1], ctx_r.fixed_region_labels)):
        g_sel, b_sel = g_sel[live], b_sel[live]
        lanes_differ += int((g_sel != b_sel).any(-1).sum())
        if bool((g_sel & ~b_sel).any()):
            problems.append(f"{side}: a region-grown set leaves its box")
        if not whole_regions(g_sel, b_sel, labels):
            problems.append(f"{side}: a region is split among in-box features")
        if not bool((g_sel.sum(-1) >= torch.clamp(b_sel.sum(-1), max=target)).all()):
            problems.append(f"{side}: a lane selects fewer than the target {target}")
    if lanes_differ == 0:
        problems.append("no lane's region-grown set differs from its box set")
    fields = {
        "segment": seg, "target_region_features": target,
        "in_box_features": spread(box_counts), "selected_features": spread(
            torch.cat([grown[0].sum(-1)[live], grown[1].sum(-1)[live]])),
        "lane_sides_differing_from_box": lanes_differ, "lane_sides": 2 * int(live.sum()),
    }
    del grown, box
    close_entry("segment_pair_and_rois", k1_on_path=False)

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # every candidate refined, against the staged run on the same plan
    staged, staged_s = timed(registration.register_locations_staged, ctx_r, q, cfg_r, svm, plan)
    close_entry("staged", k1_on_path=True)
    every, every_s = timed(registration.register_locations, ctx_r, q, cfg_r, svm, plan)
    close_entry("refine_all", k1_on_path=True)
    both = (staged.selected >= 0) & (every.selected >= 0)
    agree = int((staged.selected == every.selected)[both].sum())
    if agree != int(both.sum()):
        problems.append(f"refine-all agrees with staged on {agree} of {int(both.sum())} queries")
    if not bool(every.refined.all()):
        problems.append("refine-all left a candidate unrefined")
    fields["refine_all"] = {
        "staged_s": staged_s, "refine_all_s": every_s, "both_verified": int(both.sum()),
        "selected_agree": agree, **acceptance_stats(every, queries, true),
    }

    # the bare index maps give the rows the baked grids hold
    bare, bare_s = timed(
        registration.register_locations_staged,
        dataclasses.replace(ctx_r, fixed_grid=None, moving_grid=None), q, cfg_r, svm, plan)
    bare_equal = all(
        torch.equal(a, b) for a, b in (
            (bare.selected, staged.selected), (bare.trans.A, staged.trans.A),
            (bare.trans.t, staged.trans.t), (bare.probability, staged.probability)))
    if not bare_equal:
        problems.append("the run from the bare index maps differs from the run from the grids")
    fields["bare_index_map"] = {"seconds": bare_s, "equal_to_grid_run": bare_equal}
    close_entry("bare_index_map", k1_on_path=True)

    # the rigid model on 8 queries
    rigid_err, rigid_orth, rigid_s = [], [], []
    for i in range(8):
        (res, best, any_usable), s = timed(
            registration.register_location_rigid, ctx_r, q[i], cfg_r, plan.query(i))
        rigid_s.append(s)
        if not bool(any_usable):
            continue
        eye = torch.eye(3, device=dev)
        rigid_orth.append(float((res.trans.A @ res.trans.A.T - eye).abs().max()))
        one = Affine3D(res.trans.A[None, None], res.trans.t[None, None],
                       res.trans.center[None, None])
        rigid_err.append(float(gt_errors(one, queries[i : i + 1], true)[0, 0]))
    fields["rigid"] = {
        "queries": 8, "usable": len(rigid_err), "seconds": rigid_s,
        "gt_error_mm": rigid_err, "max_orthogonality_error": max(rigid_orth, default=None),
    }
    if not rigid_err or float(np.median(rigid_err)) >= 1.5:
        problems.append(f"rigid: median GT error {rigid_err} not under 1.5 mm")
    if rigid_orth and max(rigid_orth) > 1e-5:
        problems.append(f"rigid: rotation off orthogonal by {max(rigid_orth)}")
    close_entry("rigid", k1_on_path=False)  # its 6 x 6 system is plain PyTorch

    # one accepted candidate replayed with a callback
    accepted = torch.nonzero(staged.selected >= 0)[:, 0]
    if accepted.numel() == 0:
        problems.append("no accepted candidate to replay")
    else:
        i = int(accepted[0])
        c = int(staged.selected[i])
        calls = []
        res = registration.watch_candidate(
            ctx_r, q[i], cfg_r, plan.query(i), c, lambda *a: calls.append(a))
        fields["watch"] = {
            "query": i, "candidate": c, "callbacks": len(calls),
            "iterations": int(res.iterations),
            "max_abs_diff_A_to_served": float((res.trans.A - staged.trans.A[i, c]).abs().max()),
        }
        if len(calls) != int(res.iterations):
            problems.append(f"watch: {len(calls)} callbacks for {int(res.iterations)} iterations")
        close_entry("watch", k1_on_path=True)

    # `launches` and `k1_shapes` of the line are the four served runs' alone
    served, served_shapes = serve_and_check(
        "regions_bench", ctx_r, cfg_r, meta, seed, card, on_path=("normal_equations",),
        problems=problems, launches_by_entry=by_entry, **fields)
    if problems:
        raise AssertionError("regions_bench: " + "; ".join(problems))
    by_entry["served"] = served
    for k, c in served_shapes.items():
        k1_all[k] = k1_all.get(k, 0) + c
    total = {name: sum(e[name] for e in by_entry.values()) for name in served}
    return total, k1_all, by_entry


# ---------------------------------------------------------------------------
# phases 9 and 10: the file-based pipeline
# ---------------------------------------------------------------------------


def shape_rows(k1_shapes: dict, k2_shapes: dict) -> dict:
    return {
        "k1_shapes": [{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n}
                      for k, n in sorted(k1_shapes.items(), key=lambda kv: -kv[1])],
        "k2_shapes": k2_shape_rows(k2_shapes),
    }


def tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root) for f in files)


def same_files(a: str, b: str) -> list[str]:
    """Relative paths under `a` and `b` that are missing on one side or
    differ in a byte; empty when the two trees are equal."""
    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    la, lb = listing(a), listing(b)
    bad = sorted(set(la) ^ set(lb))
    for rel in sorted(set(la) & set(lb)):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            if fa.read() != fb.read():
                bad.append(rel)
    return bad


def write_volume(path: str, vol) -> None:
    from lrr_tpu_torch.io import write_mhd

    write_mhd(path, vol.data.cpu().numpy(), tuple(vol.origin.cpu().numpy()),
              tuple(vol.spacing.cpu().numpy()))


def write_locs(path: str, queries) -> None:
    """One query a line, with the nine digits that bring a float32 back."""
    with open(path, "w") as f:
        for q in queries:
            f.write(" ".join(f"{float(v):.9g}" for v in q) + "\n")


def compacted(fs):
    """The valid rows of a set, in order: what a stage file holds."""
    from lrr_tpu_torch.types import DescriptorSet

    if isinstance(fs, DescriptorSet):
        kp = compacted(fs.keypoints)
        kp.strength = torch.ones_like(kp.strength)  # a descriptor file carries none
        return DescriptorSet(kp, fs.descriptors[fs.keypoints.mask])
    keep = fs.mask
    return type(fs)(**{name: getattr(fs, name)[keep] for name in fs.__dataclass_fields__})


def run_cli_reference(seed: int, card: str, ref):
    """Phase 9: the stage commands from files at the reference constants,
    on phase 6's volumes and phase 7's queries."""
    from lrr_tpu_torch import cli
    from lrr_tpu_torch.io import (
        native_loader, read_descriptors, read_features, read_keypoints, read_mhd,
        write_descriptors, write_features, write_mhd,
    )
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.ops.watershed import watershed_segmentation
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.types import Volume
    from lrr_tpu_torch.verify.svm import load_default_verifier

    ctx, moving, fixed, true, cfg, _ = ref
    dev = ctx.device
    queries = reference_queries(moving)
    problems = []
    seconds: dict[str, list[float]] = {}
    written: dict[str, int] = {}
    work = tempfile.mkdtemp(prefix="lrr_cli_reference_")

    def run(name: str, argv: list[str]):
        before = tree_bytes(work)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)  # no --device: the commands take the card by themselves
        torch.cuda.synchronize()
        seconds.setdefault(name, []).append(time.perf_counter() - t0)
        written[name] = written.get(name, 0) + tree_bytes(work) - before

    def p(name: str) -> str:
        return os.path.join(work, name)

    try:
        t0 = time.perf_counter()
        write_volume(p("moving.mhd"), moving)
        write_volume(p("fixed.mhd"), fixed)
        write_locs(p("locs.txt"), queries)
        seconds["write_volumes"] = [time.perf_counter() - t0]
        written["write_volumes"] = tree_bytes(work)

        kernels.reset_launch_counts()
        for side in ("moving", "fixed"):  # the order `prepare_pair` takes
            run("extract-features", ["extract-features", p(f"{side}.mhd"), p(f"{side}_00.vtk"),
                                     "--max-features", str(cfg.features.max_features)])
            run("extract-keypoints", ["extract-keypoints", p(f"{side}_00.vtk"),
                                      p(f"{side}_keypoints.vtk"),
                                      "--max-keypoints", str(cfg.keypoints.max_keypoints)])
            run("compute-descriptors", ["compute-descriptors", p(f"{side}_keypoints.vtk"),
                                        p(f"{side}_00.vtk"), p(f"{side}_desc.vtk"),
                                        "--min-neighbors", str(cfg.descriptors.min_neighbors)])
            run("compute-distance-map", ["compute-distance-map", p(f"{side}_00.vtk"),
                                         p(f"{side}_map.mhd"), "--validate"])
            run("watershed", ["watershed", p(f"{side}.mhd"), p(f"{side}_ws.mhd")])
        ecfg = cfg.estimation
        register = [
            "register", p("moving_00.vtk"), p("fixed_00.vtk"), p("moving_desc.vtk"),
            p("fixed_desc.vtk"), "--locs", p("locs.txt"),
            "--candidates", str(cfg.indexing.num_candidates),
            "--max-matches", str(ecfg.max_matches), "--max-iterations", str(ecfg.max_iterations),
            "--min-region-features", str(ecfg.min_region_features),
            "--segment-moving", p("moving_ws.mhd"), "--segment-fixed", p("fixed_ws.mhd"),
            "--seed", str(seed),
        ]
        run("register", register + ["--out", p("results")])
        launches = dict(kernels.LAUNCHES)
        k1_shapes, k2_shapes = dict(kernels.K1_SHAPES), dict(kernels.K2_SHAPES)
        note_path_shapes("cli_reference")
        run("register", register + ["--out", p("results_again")])
        twice = same_files(p("results"), p("results_again"))
        if twice:
            problems.append(f"two runs of register differ in {twice[:5]}")

        # the file operations alone, one call each: what of a stage command's
        # seconds is reading and writing (host copies and encoding included)
        io_s: dict[str, list[float]] = {}

        def io(name: str, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            io_s.setdefault(name, []).append(time.perf_counter() - t0)
            return out

        # what the files hold, against phase 6's sets: order and mask, bit for bit
        row2_diff = 0.0
        for side in ("moving", "fixed"):
            want = compacted(getattr(ctx, f"{side}_features"))
            io("read_volume", lambda: cli._load_volume(p(f"{side}.mhd"), dev))
            got = io("read_features", lambda: read_features(p(f"{side}_00.vtk")))
            io("write_features", lambda: write_features(p("io_features.vtk"), got))
            if not bool(getattr(ctx, f"{side}_features").mask[: want.capacity].all()):
                problems.append(f"{side}: phase 6's valid features are not a prefix")
            if got.capacity != want.capacity or not bool(got.mask.all()):
                problems.append(f"{side}: {got.capacity} features read back, want {want.capacity}")
                continue
            for name in ("xyz", "strength", "shape", "projector"):
                if not torch.equal(getattr(got, name), getattr(want, name)):
                    problems.append(f"{side} features.{name} read back differs")
            # the file carries direction rows 0 and 1; a corner's row 2 is
            # rebuilt from them on read and no path reads it
            if not torch.equal(got.directions[:, :2], want.directions[:, :2]):
                problems.append(f"{side} features.directions rows 0-1 read back differ")
            row2_diff = max(row2_diff, float((got.directions[:, 2] - want.directions[:, 2]).abs().max()))
            want_d = compacted(getattr(ctx, f"{side}_descriptors"))
            got_d = io("read_descriptors", lambda: read_descriptors(p(f"{side}_desc.vtk")))
            io("write_descriptors", lambda: write_descriptors(p("io_desc.vtk"), got_d))
            got_k = io("read_keypoints", lambda: read_keypoints(p(f"{side}_keypoints.vtk")))
            if got_d.keypoints.capacity != want_d.keypoints.capacity:
                problems.append(f"{side}: {got_d.keypoints.capacity} descriptors read back, "
                                f"want {want_d.keypoints.capacity}")
                continue
            if not torch.equal(got_d.descriptors, want_d.descriptors):
                problems.append(f"{side} descriptors read back differ")
            for name in ("xyz", "normal", "binormal", "strength", "mask"):
                if not torch.equal(getattr(got_d.keypoints, name), getattr(want_d.keypoints, name)):
                    problems.append(f"{side} descriptor keypoints.{name} read back differs")
            # the keypoint file holds every keypoint, the descriptor file the described ones
            if got_k.capacity < got_d.keypoints.capacity:
                problems.append(f"{side}: fewer keypoints than descriptors on file")
            vor = getattr(ctx, f"{side}_vor")
            data, origin, spacing = io("read_map", lambda: read_mhd(p(f"{side}_map.mhd")))
            io("write_map", lambda: write_mhd(
                p("io_map.mhd"), vor.index_vol.cpu().numpy().astype(np.int32)))
            if data.dtype != np.int32 or not np.array_equal(data, vor.index_vol.cpu().numpy()):
                problems.append(f"{side} Voronoi map on file differs from phase 6's")
            # the header prints the origin with six digits
            if not (np.allclose(origin, vor.origin.cpu().numpy(), rtol=1e-5, atol=0)
                    and np.array_equal(spacing, vor.spacing.cpu().numpy())):
                problems.append(f"{side} Voronoi map geometry on file differs")

        # the same registration in memory: phase 6's sets as a file holds them
        # (valid rows, in order), phase 6's maps, labels straight from the
        # watershed, the config and the plan `register` builds
        cfg_cli = cli.register_config(cfg.indexing.num_candidates, ecfg.max_matches,
                                      ecfg.max_iterations, ecfg.min_region_features)
        mem = registration.assemble_pair_context(
            compacted(ctx.moving_features), compacted(ctx.fixed_features),
            compacted(ctx.moving_descriptors), compacted(ctx.fixed_descriptors),
            ctx.moving_vor, ctx.fixed_vor)
        labels = []
        for side, vol in (("moving", moving), ("fixed", fixed)):
            lab = watershed_segmentation(vol.data)
            on_file = io("read_labels", lambda: cli._load_labels(p(f"{side}_ws.mhd"), dev))
            on_file = on_file.data.cpu().numpy().astype(np.uint32)
            if read_mhd(p(f"{side}_ws.mhd"))[0].dtype != np.uint32:
                problems.append(f"{side} watershed labels on file are not MET_UINT")
            if not np.array_equal(on_file, lab.cpu().numpy().astype(np.uint32)):
                problems.append(f"{side} watershed labels on file differ from the in-memory ones")
            labels.append(Volume(lab, vol.origin, vol.spacing))
        mem = registration.attach_regions(mem, *labels)
        del labels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.register_queries(
            mem, cli._read_locs(p("locs.txt")), cfg_cli, load_default_verifier(),
            p("results_memory"), seed=seed)
        torch.cuda.synchronize()
        seconds["register_in_memory"] = [time.perf_counter() - t0]
        routes = same_files(p("results"), p("results_memory"))
        if routes:
            problems.append(f"the files route and the in-memory route differ in {routes[:5]}")
        n_result_files = len(os.listdir(p("results"))) + len(os.listdir(p("results/reference_format")))

        # the result files parse, and say what the in-memory result says
        sel = out.selected.cpu().numpy()
        for t in range(len(queries)):
            with open(p(f"results/results{t:06d}.json")) as f:
                rec = json.load(f)
            if rec["selected"] != int(sel[t]) or len(rec["candidates"]) != cfg.indexing.num_candidates:
                problems.append(f"results{t:06d}.json does not hold the in-memory result")
        acc = acceptance_stats(out, queries, true)
        total_bytes = tree_bytes(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase(
        "cli_reference", card=card, queries=len(queries), stage_s=seconds, io_s=io_s,
        bytes_written=written, bytes_total=total_bytes, result_files=n_result_files,
        readers={"mhd": "python (io.mhd.read_mhd)", "base64": native_loader.reader_kind()},
        features=[int(ctx.moving_features.count()), int(ctx.fixed_features.count())],
        descriptors=[int(ctx.moving_descriptors.keypoints.count()),
                     int(ctx.fixed_descriptors.keypoints.count())],
        corner_third_direction_max_abs_diff=row2_diff,
        verified=int((sel >= 0).sum()), **acc,
        max_query_keypoints=cfg_cli.indexing.max_query_keypoints,
        files_route_equals_memory_route=not routes, two_runs_equal=not twice,
        launches=launches, **shape_rows(k1_shapes, k2_shapes),
        problems=problems,
    )
    if problems:
        raise AssertionError("cli_reference: " + "; ".join(problems))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"cli_reference: kernel {name} was never launched on the path")
    kf, km = (int(ctx.fixed_descriptors.keypoints.count()),
              int(ctx.moving_descriptors.keypoints.count()))
    if k2_shapes.get((kf, km, 195, 1), 0) < 1:
        raise AssertionError(
            f"cli_reference: no K2 launch at {kf} x {km} x 195 (the described keypoints "
            f"of the two files): {k2_shapes}")
    return launches, k1_shapes, k2_shapes


def run_batch_calibrate(seed: int, card: str, work: str):
    """Phase 10: `run_batch` with a failing job and a resume, then
    verifier calibration on its first pair, at bench scale.  The inputs
    written under `work` (volumes, `pairs.txt`, `locs.txt`) stay for phase
    13."""
    from lrr_tpu_torch import cli
    from lrr_tpu_torch.io import native_loader
    from lrr_tpu_torch.io.svmlight import write_svmlight
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline import batch
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.pipeline.registration import register_locations_staged
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.utils.synthetic import make_pair
    from lrr_tpu_torch.verify import smo, surrogate
    from lrr_tpu_torch.verify.svm import (
        fit_rbf_classifier, load_default_verifier, predict_probability, scale_measurements,
        serialize_libsvm_model,
    )

    meta, cfg = load_bench_meta()
    pair = meta["pair"]
    cal_queries = np.asarray(meta["queries"], np.float32)  # 64, as bench.py calibrates
    queries = cal_queries[:16]
    ref = meta["lrr_tpu_reference"]
    with open(BENCH + "_seed12.json") as f:
        ref12 = json.load(f)["lrr_tpu_reference"]
    problems = []

    def p(name: str) -> str:
        return os.path.join(work, name)

    kernels.reset_launch_counts()
    trues = {}
    for s in (11, 12):
        fixed, moving, trues[s] = make_pair(
            tuple(pair["shape_zyx"]), rotation_deg=pair["rotation_deg"],
            translation=tuple(pair["translation"]), seed=s)
        write_volume(p(f"moving{s}.mhd"), moving)
        write_volume(p(f"fixed{s}.mhd"), fixed)
    del fixed, moving
    write_locs(p("locs.txt"), queries)
    with open(p("pairs.txt"), "w") as f:
        f.write(f"pair11 {p('moving11.mhd')} {p('fixed11.mhd')} {p('locs.txt')}\n")
        f.write(f"absent {p('no_such_volume.mhd')} {p('fixed11.mhd')} {p('locs.txt')}\n")
        f.write(f"pair12 {p('moving12.mhd')} {p('fixed12.mhd')} {p('locs.txt')}\n")
    jobs = batch.load_pair_list(p("pairs.txt"))
    svm = load_default_verifier()

    # the batched results of every staged run, by job: the script reads
    # acceptance from them, `run_batch` itself only writes files
    served = []
    staged = batch.register_locations_staged

    def keeping(ctx, q, *args, **kwargs):
        out = staged(ctx, q, *args, **kwargs)
        served.append(out)
        return out

    def run(out_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = batch.run_batch(jobs, cfg, svm, out_dir, seed=seed, query_batch=8)
        torch.cuda.synchronize()
        return report, time.perf_counter() - t0

    batch.register_locations_staged = keeping
    try:
        report, first_s = run(p("out"))
    finally:
        batch.register_locations_staged = staged
    statuses = [(e["name"], e["status"]) for e in report["pairs"]]
    if (report["completed"], report["failed"], report["skipped"]) != (2, 1, 0) or statuses != [
            ("pair11", "ok"), ("absent", "failed"), ("pair12", "ok")]:
        errors = [e.get("error") for e in report["pairs"] if e["status"] == "failed"]
        raise AssertionError(f"batch_calibrate: run_batch reported {statuses}: {errors}")
    if "no_such_volume" not in report["pairs"][1]["error"]:
        problems.append(f"the absent job failed otherwise: {report['pairs'][1]['error']}")

    # pair 11 is the bench pair: its 16 queries inside phase 4's bounds
    # (two batches of 8; pair 12's two follow)
    true11 = trues[11]
    acc = {}
    for name, outs, true in (("pair11", served[:2], true11), ("pair12", served[2:], trues[12])):
        stats = [acceptance_stats(o, queries[i * 8 : i * 8 + 8], true) for i, o in enumerate(outs)]
        pooled = [e for i, o in enumerate(outs)
                  for e in query_errors(o, queries[i * 8 : i * 8 + 8], true)]
        sel = np.concatenate([o.selected.cpu().numpy() for o in outs])
        rank0 = np.concatenate([o.rank[:, 0].cpu().numpy() for o in outs])
        errs = [s["median_gt_error_mm"] for s in stats if s["median_gt_error_mm"] is not None]
        acc[name] = {"verified_frac": float((sel >= 0).mean()),
                     "rank0_frac": float((sel == rank0).mean()),
                     "median_gt_error_mm_by_batch": errs,
                     "median_gt_error_mm": float(np.median(pooled)) if pooled else None}
    del served
    slack = 2.0 / len(queries)
    a11 = acc["pair11"]
    err_cap = max(1.0, 1.5 * ref["median_gt_error_mm"])
    # pair 12 at the bench's bars against lrr_tpu's figure for seed 12
    # (lrr_tpu_torch/data/bench_pair_s64_seed12.json): the verified share
    # and the median error over all its queries, as bench.py takes them
    a12 = acc["pair12"]
    err_cap12 = max(1.0, 1.5 * ref12["median_gt_error_mm"])
    if a12["verified_frac"] < ref12["verified_frac"] - 2.0 / 64:
        problems.append(f"pair12 verified_frac {a12['verified_frac']}")
    if a12["median_gt_error_mm"] is None or a12["median_gt_error_mm"] > err_cap12:
        problems.append(f"pair12 median GT error {a12['median_gt_error_mm']} above {err_cap12}")
    if a11["verified_frac"] < ref["verified_frac"] - slack:
        problems.append(f"pair11 verified_frac {a11['verified_frac']}")
    if a11["rank0_frac"] < ref["rank0_frac"] - slack:
        problems.append(f"pair11 rank0_frac {a11['rank0_frac']}")
    if not a11["median_gt_error_mm_by_batch"] or max(a11["median_gt_error_mm_by_batch"]) > err_cap:
        problems.append(f"pair11 median GT error {a11['median_gt_error_mm_by_batch']} above {err_cap}")

    # a second run skips on the markers; with the markers gone it resumes
    # from the cached contexts and writes the same bytes
    def result_files(out_dir):
        return {f: open(os.path.join(out_dir, f), "rb").read()
                for f in sorted(os.listdir(out_dir)) if "_results" in f}

    first = result_files(p("out"))
    report2, skip_s = run(p("out"))
    if (report2["completed"], report2["failed"], report2["skipped"]) != (0, 1, 2):
        problems.append(f"the second run did not skip on the markers: {report2}")
    for name in ("pair11", "pair12"):
        os.remove(p(f"out/{name}.done"))
    stamp = os.path.getmtime(p("out/artifacts/pair11.npz"))
    report3, resume_s = run(p("out"))
    resumed_equal = result_files(p("out")) == first
    if report3["completed"] != 2 or os.path.getmtime(p("out/artifacts/pair11.npz")) != stamp:
        problems.append("the resumed run did not use the cached contexts")
    if not resumed_equal or len(first) != 2 * 2 * len(queries):
        problems.append("the resumed run's results are not byte-equal to the first run's")
    batch_launches = dict(kernels.LAUNCHES)

    # calibration on pair 11, from the context the batch cached
    ctx = load_pair_context(p("out/artifacts/pair11.npz"))
    dev = ctx.device
    true11 = Affine3D(*(t.to(dev) for t in (true11.A, true11.t, true11.center)))

    def plan_for(run_id: int, n_queries: int):
        g = torch.Generator().manual_seed(seed * 1000 + 900 + run_id)
        return draw_sampling_plan(g, n_queries, cfg, ctx.moving_features.capacity,
                                  ctx.fixed_features.capacity, dev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X, y = surrogate.collect_labeled_measurements(
        ctx, cfg, true11, cal_queries, plan_for(0, len(cal_queries)))
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    n_pos, n_neg = int((y > 0).sum()), int((y == 0).sum())
    if min(n_pos, n_neg) < 8:
        raise AssertionError(f"batch_calibrate: {n_pos} aligned and {n_neg} misaligned "
                             "measurements collected, want 8 of each")
    Xs = scale_measurements(torch.from_numpy(X)).numpy()
    write_svmlight(p("train.txt"), Xs, np.where(y > 0, 1.0, -1.0))

    t0 = time.perf_counter()
    _, _, smo_iterations = smo.smo_solve(
        smo.rbf_kernel(Xs.astype(np.float64), 0.125), np.where(y > 0, 1.0, -1.0), 1.0)
    models = {"smo": smo.train_c_svc(Xs, y)}
    smo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    models["klr"] = fit_rbf_classifier(Xs, y)  # on the card
    torch.cuda.synchronize()
    klr_s = time.perf_counter() - t0

    trained = {}
    q_dev = torch.as_tensor(queries, device=dev)
    for name, model in models.items():
        probs = predict_probability(model.to(dev), torch.from_numpy(Xs).to(dev)).cpu().numpy()
        accuracy = float(((probs > 0.5) == (y > 0)).mean())
        with open(p(f"{name}.model"), "w") as f:
            f.write(serialize_libsvm_model(model))
        cli.main(["svm-predict", p("train.txt"), p(f"{name}.model"), p(f"{name}.pred"), "-b"])
        from_file = np.loadtxt(p(f"{name}.pred"), skiprows=1)[:, 1]
        file_diff = float(np.abs(from_file - probs).max())
        out = register_locations_staged(ctx, q_dev, cfg, model, plan_for(1, len(queries)))
        torch.cuda.synchronize()
        trained[name] = {
            "support_vectors": int(model.sv.shape[0]), "training_accuracy": accuracy,
            "serialised_max_abs_probability_diff": file_diff,
            **acceptance_stats(out, queries, true11),
        }
        if accuracy < 0.9:
            problems.append(f"{name}: training accuracy {accuracy} below 0.9")
        if file_diff > 1e-5:
            problems.append(f"{name}: the serialised model's probabilities differ by {file_diff}")
    launches = dict(kernels.LAUNCHES)
    k1_shapes, k2_shapes = dict(kernels.K1_SHAPES), dict(kernels.K2_SHAPES)
    note_path_shapes("batch_calibrate")
    total_bytes = tree_bytes(work)
    phase(
        "batch_calibrate", card=card, queries_per_pair=len(queries),
        calibration_queries=len(cal_queries),
        report={k: report[k] for k in ("completed", "failed", "skipped")},
        failed_job_error=report["pairs"][1]["error"], timers=report["timers"],
        run_s={"first": first_s, "skipping": skip_s, "resumed": resume_s},
        resumed_timers=report3["timers"], resumed_byte_equal=resumed_equal,
        volume_reader=native_loader.reader_kind(), acceptance=acc,
        lrr_tpu_reference={k: ref[k] for k in ("verified_frac", "rank0_frac", "median_gt_error_mm")},
        lrr_tpu_reference_pair12={k: ref12[k] for k in ("verified_frac", "rank0_frac",
                                                        "median_gt_error_mm")},
        calibration={"collect_s": collect_s, "aligned": n_pos, "misaligned": n_neg,
                     "smo_iterations": int(smo_iterations), "smo_s": smo_s, "klr_s": klr_s,
                     "models": trained},
        bytes_total=total_bytes, batch_launches=batch_launches, launches=launches,
        **shape_rows(k1_shapes, k2_shapes), problems=problems,
    )
    if problems:
        raise AssertionError("batch_calibrate: " + "; ".join(problems))
    for name, n in batch_launches.items():
        if n <= 0:
            raise AssertionError(f"batch_calibrate: kernel {name} was never launched by run_batch")
    batch = {"pairs": p("pairs.txt"),
             "selected": {e["name"]: [loc["selected"] for loc in e["locations"]]
                          for e in report["pairs"] if e["status"] == "ok"}}
    return launches, k1_shapes, k2_shapes, batch


# ---------------------------------------------------------------------------
# phase 12: the estimate family
# ---------------------------------------------------------------------------

CDC_METHODS = ("cdc", "cdc-transfer", "cdc-symmetric", "cdc-symmetric-transfer")
ESTIMATE_ITERATIONS = 12  # `estimate --iterations` for the CDC methods (default 30)


def median_error(fn, true_fn, pts: torch.Tensor) -> float:
    """Median distance in mm between two maps of the points."""
    return float(torch.linalg.norm(fn(pts) - true_fn(pts), dim=-1).median())


class Recorded:
    """Wraps an estimator so that a command's result object is kept."""

    def __init__(self, module, name: str):
        self.module, self.name, self.fn, self.results = module, name, getattr(module, name), []

    def __enter__(self):
        def call(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            self.results.append(out)
            return out

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def estimate_inputs(bench):
    """What phase 12 keeps of phase 5: the two feature sets, the volume's
    grid and the true transform (from the committed pair's record)."""
    from lrr_tpu_torch.models.affine import Affine3D

    ctx, moving, _, _, meta = bench
    dev = ctx.device
    true = Affine3D(*(torch.tensor(meta["true"][k], dtype=torch.float32, device=dev)
                      for k in ("A", "t", "center")))
    return (ctx.moving_features, ctx.fixed_features, tuple(moving.data.shape), moving.origin,
            moving.spacing), true


def run_estimate(seed: int, card: str, bench_sets, ref):
    """Phase 12: `estimate` through `lrr_tpu_torch.cli.main` on the card for
    `icp` and the four CDC methods on the bench pair's features (phase 5), and
    `--model similarity2d` on 1,000 2-D points from the seed; the affine fit
    to a field rasterised from the bench's true transform; the decimation
    masks of phase 6's 65,536-feature set; `register_intensity` at its
    defaults on phase 6's 400 x 350 x 350 pair.  Seconds, iterations,
    `converged`, the median error against the true map next to the
    identity's, and for icp and each CDC method whether two runs give the
    same bits."""
    import contextlib
    import io

    from lrr_tpu_torch import cli
    from lrr_tpu_torch.estimation import cdc, icp_classic, similarity2d
    from lrr_tpu_torch.models.bspline import DeformationField, fit_affine_to_field
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.ops.subsample import multiresolution_masks
    from lrr_tpu_torch.pipeline.intensity import register_intensity

    (mov_fs, fix_fs, vol_shape, vol_origin, vol_spacing), true_b = bench_sets
    ctx_r, moving_r, fixed_r, true_r, _, _ = ref
    dev = mov_fs.xyz.device
    mov_xyz, fix_xyz = mov_fs.xyz[mov_fs.mask], fix_fs.xyz[fix_fs.mask]
    problems = []
    work = tempfile.mkdtemp(prefix="lrr_estimate_")
    kernels.reset_launch_counts()

    def p(name: str) -> str:
        return os.path.join(work, name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def estimate(argv: list[str], module, name: str):
        """One `estimate` command (no --device: the card by itself): its
        printed lines, result object, output row and seconds."""
        out = p(f"out_{len(os.listdir(work))}.txt")
        buf = io.StringIO()
        with Recorded(module, name) as rec, contextlib.redirect_stdout(buf):
            _, sec = timed(lambda: cli.main(["estimate", *argv, "--output", out]))
        with open(out, "rb") as f:
            return buf.getvalue().splitlines(), rec.results[-1], f.read(), sec

    try:
        write_locs(p("moving.txt"), mov_xyz.cpu().numpy())
        write_locs(p("fixed.txt"), fix_xyz.cpu().numpy())
        ident_b = median_error(lambda x: x, true_b.apply, mov_xyz)
        methods = {}
        for method in ("icp",) + CDC_METHODS:
            argv = [p("moving.txt"), p("fixed.txt"), "--method", method]
            module, name = (icp_classic, "icp_classic") if method == "icp" else (cdc, "run_cdc")
            if method != "icp":
                argv += ["--iterations", str(ESTIMATE_ITERATIONS)]
            runs = [estimate(argv, module, name) for _ in range(2)]
            (lines, res, row, sec), (_, res2, row2, sec2) = runs
            tr = res.trans
            same = row == row2 and all(torch.equal(getattr(tr, f), getattr(res2.trans, f))
                                       for f in ("A", "t", "center"))
            rec = {"seconds": [sec, sec2],
                   "iterations": int(res.iterations if method == "icp" else res.iteration + 1),
                   "converged": bool(res.converged), "two_runs_bit_identical": same,
                   "median_error_mm": median_error(tr.apply, true_b.apply, mov_xyz),
                   "printed": lines}
            methods[method] = rec
            if not same:
                problems.append(f"{method}: two runs differ")
            if not (torch.isfinite(tr.A).all() and torch.isfinite(tr.t).all()):
                problems.append(f"{method}: non-finite transform")
            if not rec["median_error_mm"] < ident_b:
                problems.append(f"{method}: error {rec['median_error_mm']} not below the "
                                f"identity's {ident_b}")

        # the 2-D demo: 1,000 points under a known similarity, 5 % outliers
        rng = np.random.default_rng(seed + 12)
        mov2 = rng.uniform(0, 50, (1000, 2)).astype(np.float32)
        phi = np.deg2rad(3.0)
        A2 = 1.02 * np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]])
        fix2 = mov2 @ A2.T + np.array([1.0, -0.5]) + 0.05 * rng.standard_normal((1000, 2))
        fix2[:50] = rng.uniform(0, 50, (50, 2))
        write_locs(p("moving2.txt"), mov2)
        write_locs(p("fixed2.txt"), fix2.astype(np.float32))
        lines, res, _, sec = estimate([p("moving2.txt"), p("fixed2.txt"), "--model", "similarity2d"],
                                      similarity2d, "icp_similarity2d")
        m2 = torch.from_numpy(mov2).to(dev)
        A2t = torch.tensor(A2, dtype=torch.float32, device=dev)
        t2 = torch.tensor([1.0, -0.5], device=dev)
        true2 = lambda x: (A2t * x[:, None, :]).sum(-1) + t2  # noqa: E731
        ident2 = median_error(lambda x: x, true2, m2)
        sim = {"seconds": sec, "iterations": int(res.iterations), "converged": bool(res.converged),
               "median_error_mm": median_error(res.trans.apply, true2, m2),
               "identity_error_mm": ident2, "printed": lines}
        if not (sim["median_error_mm"] < ident2 and np.isfinite(sim["median_error_mm"])):
            problems.append(f"similarity2d: error {sim['median_error_mm']} vs identity {ident2}")

        # the affine fit to a field rasterised from the bench's true transform
        field, field_s = timed(lambda: DeformationField.from_transform(
            true_b.apply, vol_shape, vol_origin, vol_spacing))
        extent = torch.tensor(vol_shape[::-1], dtype=torch.float32, device=dev) * vol_spacing
        (fit, rms), fit_s = timed(lambda: fit_affine_to_field(
            field, vol_origin + 0.125 * extent, vol_origin + 0.875 * extent))
        fit_rec = {"seconds": fit_s, "field_seconds": field_s, "rms_residual_mm": float(rms),
                   "median_error_mm": median_error(fit.apply, true_b.apply, mov_xyz),
                   "identity_error_mm": ident_b}
        if not fit_rec["median_error_mm"] < ident_b or not np.isfinite(float(rms)):
            problems.append(f"fit_affine_to_field: {fit_rec}")

        # decimation of the reference-constants feature set
        fs_r = ctx_r.fixed_features
        spacings = (8.0, 4.0, 2.0, 0.0)
        masks, dec_s = timed(lambda: multiresolution_masks(fs_r, spacings))
        counts = [int(m.sum()) for m in masks]
        again = multiresolution_masks(fs_r, spacings)
        decimate = {"seconds": dec_s, "capacity": fs_r.capacity, "spacings": list(spacings),
                    "kept": counts,
                    "two_runs_bit_identical": all(torch.equal(a, b) for a, b in zip(masks, again))}
        if not (counts == sorted(counts) and counts[-1] == int(fs_r.count())
                and decimate["two_runs_bit_identical"]):
            problems.append(f"multiresolution_masks: {decimate}")

        # intensity registration at its defaults on the reference pair
        torch.cuda.reset_peak_memory_stats()
        res_i, int_s = timed(lambda: register_intensity(fixed_r, moving_r, seed=seed))
        mxyz = ctx_r.moving_features.xyz[ctx_r.moving_features.mask]
        ident_i = median_error(lambda x: x, true_r.apply, mxyz)
        inten = {"seconds": int_s, "levels": res_i.levels_run, "iterations": 3 * 80,
                 "samples": 16384, "voxels": int(fixed_r.data.numel()),
                 "metric_value": float(res_i.metric_value),
                 "median_error_mm": median_error(res_i.trans.apply, true_r.apply, mxyz),
                 "identity_error_mm": ident_i,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if not (inten["median_error_mm"] < ident_i and np.isfinite(inten["metric_value"])):
            problems.append(f"register_intensity: error {inten['median_error_mm']} vs "
                            f"identity {ident_i}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    launches = dict(kernels.LAUNCHES)
    note_path_shapes("estimate")
    phase("estimate", card=card, points=[int(mov_xyz.shape[0]), int(fix_xyz.shape[0])],
          cdc_iterations_flag=ESTIMATE_ITERATIONS, identity_error_mm=ident_b, methods=methods,
          similarity2d=sim, fit_affine_to_field=fit_rec, multiresolution_masks=decimate,
          register_intensity=inten, launches=launches, problems=problems)
    if problems:
        raise AssertionError("estimate: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# phase 13: two ranks on the card (lrr_tpu_torch.parallel)
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 420


def ties_only(got: torch.Tensor, want: torch.Tensor, pts: torch.Tensor, origin, spacing) -> int:
    """Two index maps over the same features: equal but at voxels whose two
    answers' squared distances (float64 of the fp32 inputs) lie within 4
    fp32 ulp of each other (a tie the rounding of a voxel coordinate can
    flip).  Returns the number of differing voxels; raises at a non-tie."""
    diff = torch.nonzero(got != want).cpu().numpy()
    p = pts.double().cpu().numpy()
    o, sp = origin.double().cpu().numpy(), spacing.double().cpu().numpy()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    for z, y, x in diff:
        q = o + np.array([x, y, z]) * sp
        da, db = ((q - p[g[z, y, x]]) ** 2).sum(), ((q - p[w[z, y, x]]) ** 2).sum()
        if abs(da - db) > 4 * np.spacing(np.float32(max(da, db))):
            raise AssertionError(f"parallel: voxel {(z, y, x)} differs and is no tie ({da}, {db})")
    return len(diff)


def parallel_rank(spec_path: str) -> None:
    """One rank of phase 13 (run as `chip_smoke.py --parallel-rank SPEC` with
    the LRR_* environment): stage 1 z-split at the reference constants,
    phase 7's queries served with the lanes split, one candidate's ICP with
    the matches split, then `cli batch` over phase 10's pairs; its record
    goes to <out>/rank<r>.json."""
    import dataclasses

    import torch.distributed as dist

    from lrr_tpu_torch import cli, config
    from lrr_tpu_torch.estimation.icp import register_candidate
    from lrr_tpu_torch.estimation.measurements import backward_covariance
    from lrr_tpu_torch.ops import kernels, native, voronoi
    from lrr_tpu_torch.parallel import distributed, make_mesh
    from lrr_tpu_torch.pipeline import registration
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.utils.synthetic import make_pair
    from lrr_tpu_torch.verify import train_default
    from lrr_tpu_torch.verify.svm import load_default_verifier

    with open(spec_path) as f:
        spec = json.load(f)
    # the libraries phase 2 built: ranks side by side must not build into build/
    missing = [p for p in map(native.library_path, native.sources()) if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"parallel: kernel libraries not built: {missing}")
    t0 = time.perf_counter()
    if not distributed.maybe_initialize_distributed():
        raise RuntimeError("parallel: the LRR_* environment did not start a process group")
    rank, world = distributed.process_info()
    rec = {"rank": rank, "world": world, "backend": distributed.backend(),
           "device": torch.cuda.current_device(), "init_s": time.perf_counter() - t0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    problems = []
    seconds = {}
    launches = {}
    k1_shapes: dict[str, int] = {}
    k2_shapes: dict[str, int] = {}
    pinv_shapes: dict[str, int] = {}
    voronoi_shapes: dict[str, int] = {}
    sample_shapes: dict[str, int] = {}

    def part(name: str, fn):
        """Run one part with the counts set to 0 just before it and read just
        after; seconds end with a synchronise."""
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = dict(kernels.LAUNCHES)
        for shape, n in kernels.K1_SHAPES.items():
            key = "x".join(map(str, shape))
            k1_shapes[key] = k1_shapes.get(key, 0) + n
        for shape, n in kernels.K2_SHAPES.items():
            key = "x".join(map(str, shape))
            k2_shapes[key] = k2_shapes.get(key, 0) + n
        for shape, n in kernels.PINV_SHAPES.items():
            key = "x".join(map(str, shape))
            pinv_shapes[key] = pinv_shapes.get(key, 0) + n
        for shape, n in kernels.VORONOI_SHAPES.items():
            key = "x".join(map(str, shape))
            voronoi_shapes[key] = voronoi_shapes.get(key, 0) + n
        for shape, n in kernels.SAMPLE_SHAPES.items():
            key = "x".join(map(str, shape))
            sample_shapes[key] = sample_shapes.get(key, 0) + n
        return out

    torch.cuda.reset_peak_memory_stats()

    # stage 1 at the reference constants, z-split over the ranks
    cfg = train_default.reference_cfg()
    fixed, moving, true = make_pair((400, 350, 350), rotation_deg=6.0,
                                    translation=(3.0, -2.0, 1.5), seed=11, noise=0.5, dense=True)
    sp_mesh = distributed.global_mesh("sp")
    ctx = part("prepare_pair", lambda: registration.prepare_pair(
        moving, fixed, cfg, mesh=sp_mesh, axis_name="sp"))
    digests = context_digests(ctx)
    want = spec["digests"]
    rec["features_equal_phase6"] = all(digests[k] == want[k] for k in want if "features" in k)
    if not rec["features_equal_phase6"]:
        problems.append("features differ from phase 6's")
    rec["maps"] = {}
    for side, fs in (("moving_vor", ctx.moving_features), ("fixed_vor", ctx.fixed_features)):
        if digests[side] == want[side]:
            rec["maps"][side] = "sha256 equal"
            continue
        vor = getattr(ctx, side)
        one = voronoi.build_feature_voronoi(fs.xyz, fs.mask)[0]  # phase 6's builder, one process
        rec["maps"][side] = f"{ties_only(vor.index_vol, one, fs.xyz, vor.origin, vor.spacing)} ties"
    rec["z_split"] = {"volume": list(moving.data.shape),
                      "maps": [list(ctx.moving_vor.index_vol.shape),
                               list(ctx.fixed_vor.index_vol.shape)]}

    # phase 7's 16 queries and plan, the lanes of every dispatch split
    svm = load_default_verifier()
    ctx_r = registration.segment_pair(moving, fixed, ctx)
    queries = reference_queries(moving)
    del fixed, moving
    q = torch.as_tensor(queries, device=ctx.device)
    served = spec["served"]
    plan = draw_sampling_plan(torch.Generator().manual_seed(served["plan_seed"]), len(queries),
                              cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity,
                              ctx.device)
    waves = []
    wave_fn = registration._wave_fn

    def counted(*args):
        waves.append(int(args[-2].numel()))
        return wave_fn(*args)

    registration._wave_fn = counted
    try:
        out = part("serve", lambda: registration.register_locations_staged(
            ctx_r, q, cfg, svm, plan, mesh=distributed.global_mesh("dp")))
    finally:
        registration._wave_fn = wave_fn
    sel = out.selected.cpu().numpy()
    both = out.refined.cpu().numpy() & np.asarray(served["refined"])
    rec["serve"] = {
        **acceptance_stats(out, queries, true), "verified": int((sel >= 0).sum()),
        "lanes_per_rank_by_wave": waves,
        "selected_equal_phase7": sel.tolist() == served["selected"],
        "verified_equal_where_both_refined": bool(
            (out.verified.cpu().numpy()[both] == np.asarray(served["verified"])[both]).all()),
        "refined": int(out.refined.sum()), "refined_phase7": int(np.sum(served["refined"])),
    }
    diffs = []
    for i, tr in served["selected_trans"].items():
        c = int(sel[int(i)])
        if c >= 0:
            mine = out.trans[int(i), c]
            diffs.append(max(float((getattr(mine, k).cpu() - torch.tensor(tr[k])).abs().max())
                             for k in ("A", "t", "center")))
    rec["serve"]["max_selected_transform_diff"] = max(diffs) if diffs else None
    if not rec["serve"]["selected_equal_phase7"]:
        problems.append(f"selected {sel.tolist()} differ from phase 7's {served['selected']}")
    if not rec["serve"]["verified_equal_where_both_refined"]:
        problems.append("verified differs from phase 7's on candidates both runs refined")
    if rec["serve"]["verified"] < 12:
        problems.append(f"{rec['serve']['verified']} of 16 verified")
    err = rec["serve"]["median_gt_error_mm"]
    if err is None or err >= 1.0:
        problems.append(f"median GT error {err} mm")

    # one candidate's ICP with its matches split over the ranks (mp): query
    # 0's best-ranked candidate, sampling from every feature of each volume
    # (not its ROI's 100-200), so each 8,000-position window holds 8,000
    # matches, 4,000 a rank
    mp_mesh = make_mesh()
    _, inits, _, _, _, rank_q, _, _ = registration._pass1_fn(ctx_r, q[:1], cfg, plan.query(0))
    cand = int(rank_q[0, 0])
    init, _, _, draws = registration._one_candidate(ctx_r, q[0], cfg, plan.query(0), cand, inits)
    m_roi = dataclasses.replace(ctx_r.moving_features, mask=ctx_r.moving_features.mask[None])
    f_roi = dataclasses.replace(ctx_r.fixed_features, mask=ctx_r.fixed_features.mask[None])
    kw = dict(moving_targets=ctx_r.moving_features, fixed_targets=ctx_r.fixed_features,
              fixed_grid=ctx_r.fixed_grid, moving_grid=ctx_r.moving_grid)

    def icp(mesh):
        res = register_candidate(m_roi, f_roi, ctx_r.fixed_vor, ctx_r.moving_vor, init,
                                 cfg.estimation, draws, mesh=mesh, **kw)
        cov = backward_covariance(res, m_roi, f_roi, ctx_r.fixed_vor, ctx_r.moving_vor,
                                  cfg.estimation, plan.query(0).select(
                                      torch.zeros(1, dtype=torch.long, device=ctx.device),
                                      torch.full((1,), cand, device=ctx.device)).covariance(),
                                  mesh=mesh, **kw)
        return res, cov

    res_mp, cov_mp = part("icp_mp", lambda: icp(mp_mesh))
    torch.cuda.synchronize()
    t = time.perf_counter()
    res_one, cov_one = icp(None)
    torch.cuda.synchronize()
    seconds["icp_one_process"] = time.perf_counter() - t
    rec["icp_mp"] = {
        "candidate": cand, "max_matches": cfg.estimation.max_matches,
        "source_features": [int(m_roi.mask.sum()), int(f_roi.mask.sum())],
        "iterations": [int(res_mp.iterations[0]), int(res_one.iterations[0])],
        "number_matches": [int(res_mp.number_matches[0]), int(res_one.number_matches[0])],
        "max_abs_diff": {"A": float((res_mp.trans.A - res_one.trans.A).abs().max()),
                         "t": float((res_mp.trans.t - res_one.trans.t).abs().max()),
                         "weighted_error": float((res_mp.weighted_error
                                                  - res_one.weighted_error).abs().max())},
        "covariance_rel_diff": float((cov_mp - cov_one).abs().max() / cov_one.abs().max()),
    }
    d = rec["icp_mp"]["max_abs_diff"]
    if d["A"] > 1e-3 or d["t"] > 1e-2 or rec["icp_mp"]["iterations"][0] != rec["icp_mp"]["iterations"][1]:
        problems.append(f"the match-parallel ICP differs from the one-process run: {rec['icp_mp']}")
    del ctx, ctx_r, out

    # `cli batch` over phase 10's pairs file, the bench config in place of
    # PipelineConfig() (the command has no config flag)
    bench_cfg = load_bench_meta()[1]
    config.PipelineConfig = lambda: bench_cfg
    out_dir = os.path.join(spec["out"], "batch")
    part("batch", lambda: cli.main(["batch", spec["batch"]["pairs"], "--out", out_dir,
                                    "--seed", str(spec["seed"])]))
    dist.barrier()  # rank 0 has written the report
    with open(os.path.join(out_dir, "batch_report.json")) as f:
        report = json.load(f)
    rec["batch"] = {
        "report": {k: report[k] for k in ("completed", "failed", "skipped")},
        "selected": {e["name"]: [loc["selected"] for loc in e["locations"]]
                     for e in report["pairs"] if e["status"] == "ok"},
        "writes": rank == 0,
    }
    rec["batch"]["pair11_equal_phase10"] = (
        rec["batch"]["selected"].get("pair11") == spec["batch"]["selected"]["pair11"])
    if not rec["batch"]["pair11_equal_phase10"]:
        problems.append(f"batch pair11 {rec['batch']['selected'].get('pair11')} differs from "
                        f"phase 10's {spec['batch']['selected']['pair11']}")

    rec.update(seconds=seconds, launches=launches, k1_shapes=k1_shapes, k2_shapes=k2_shapes,
               pinv_shapes=pinv_shapes, voronoi_shapes=voronoi_shapes,
               sample_shapes=sample_shapes,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, problems=problems)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def run_parallel(seed: int, card: str, digests: dict, served: dict, batch: dict, work: str):
    """Phase 13: two ranks on the one card, as subprocesses joined through
    LRR_COORDINATOR (`parallel_rank`); the ranks share the card, so the
    backend is gloo and no figure here is a scaling figure."""
    import socket

    spec = {"seed": seed, "digests": digests, "served": served, "batch": batch,
            "out": os.path.join(work, "parallel")}
    os.makedirs(spec["out"])
    spec_path = os.path.join(work, "parallel_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.empty_cache()
    procs = []
    t0 = time.perf_counter()
    for r in range(PARALLEL_RANKS):
        env = dict(os.environ, LRR_COORDINATOR=f"127.0.0.1:{port}",
                   LRR_NUM_PROCESSES=str(PARALLEL_RANKS), LRR_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", spec_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            left = PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(1.0, left))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel: rank {r} exited {p.returncode}:\n{out[-6000:]}")
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    problems = [f"rank {rec['rank']}: {x}" for rec in ranks for x in rec["problems"]]
    for rec in ranks:
        for name in ("normal_equations", "knn", "sample_matches"):
            if sum(part[name] for part in rec["launches"].values()) <= 0:
                problems.append(f"rank {rec['rank']}: kernel {name} never launched")
    if ranks[0]["serve"]["selected_equal_phase7"] != ranks[1]["serve"]["selected_equal_phase7"] \
            or ranks[0]["batch"]["selected"] != ranks[1]["batch"]["selected"]:
        problems.append("the ranks disagree")
    phase("parallel", card=card, ranks=PARALLEL_RANKS, wall_s=wall_s,
          backend=ranks[0]["backend"], per_rank=ranks, problems=problems)
    if problems:
        raise AssertionError("parallel: " + "; ".join(problems))

    def shapes(key):
        merged: dict[tuple, dict[str, int]] = {}
        for rec in ranks:
            for k, n in rec[key].items():
                merged.setdefault(tuple(int(v) for v in k.split("x")), {})[
                    f"parallel_rank{rec['rank']}"] = n
        return merged

    for rec in ranks:
        note_path_shapes(f"parallel_rank{rec['rank']}", ({}, {}, {}, *(
            {tuple(int(v) for v in k.split("x")): n for k, n in rec[key].items()}
            for key in ("pinv_shapes", "voronoi_shapes")),
            {sample_shape(k): n for k, n in rec["sample_shapes"].items()}))
    launches = {name: sum(part[name] for rec in ranks for part in rec["launches"].values())
                for name in ranks[0]["launches"]["serve"]}
    return launches, shapes("k1_shapes"), shapes("k2_shapes")


# ---------------------------------------------------------------------------
# phase 14: the shipped verifier's training, by the port
# ---------------------------------------------------------------------------

PAIR_BAR = 0.9  # accuracy and tpr over a pair's rows (tests/test_verify.py:196-227)
TPR_MIN_ALIGNED = 50  # a pair with fewer aligned rows prints its tpr without a bar
REFIT_P_TOL = 1e-3  # the refit's P(aligned) against the shipped file's


def pooled(corpus) -> list:
    """`corpus` with all its rows once more, under "pooled"."""
    return [*corpus, ("pooled", np.concatenate([x for _, x, _ in corpus]),
                      np.concatenate([y for _, _, y in corpus]))]


def score_problems(label: str, scores: dict) -> list[str]:
    """The bars on `train_default.corpus_scores` of a `pooled` corpus: acc
    over each pair; tpr over each pair with at least TPR_MIN_ALIGNED aligned
    rows and over the pooled rows."""
    problems = []
    for name, s in scores.items():
        if name != "pooled" and not s["acc"] > PAIR_BAR:
            problems.append(f"{label} {name}: acc {s['acc']} not above {PAIR_BAR}")
        if (name == "pooled" or s["aligned"] >= TPR_MIN_ALIGNED) and not (
                s["tpr"] is not None and s["tpr"] > PAIR_BAR):
            problems.append(f"{label} {name}: tpr {s['tpr']} not above {PAIR_BAR}")
    return problems


def run_train_verifier(seed: int, card: str, bench, served_ref, served7: dict):
    """Phase 14: `python -m lrr_tpu_torch.verify.train_default` on the card,
    as a user runs it (no switch, no `--device`): the five phantom pairs
    collected, the C-SVC fitted, the model written; each pair's rows,
    seconds and peak memory beside lrr_tpu's record.  The shipped model and
    the port's on the port's corpus; the port's model serving phase 5's
    bench queries (phase 4's bars) and phase 7's queries with phase 7's
    plan; the refit of the committed corpus (`TRAIN_REUSE_CORPUS=1`) against
    the shipped file; P(aligned) under the port's model of the candidates
    phase 7 diagnosed."""
    import contextlib
    import io

    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.registration import register_locations_staged
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify import train_default
    from lrr_tpu_torch.verify.svm import (
        DEFAULT_MODEL_PATH, load_default_verifier, predict_probability, scale_measurements,
    )

    with open(DEFAULT_MODEL_PATH + ".json") as f:
        lrr_tpu_record = {e["name"]: e for e in json.load(f)["pairs"]}
    shipped = load_default_verifier()
    problems = []
    calls = []  # one record a collected pair, in call order
    originals = {name: getattr(train_default, name)
                 for name in ("collect_bench_pair", "collect_reference_pair")}

    def measured(fn):
        def collect(*spec, device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            X, y = fn(*spec, device=device)
            torch.cuda.synchronize()
            calls.append({"spec": spec, "rows": int(len(y)), "aligned": int((y > 0).sum()),
                          "seconds": time.perf_counter() - t0,
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "device": device.type})
            return X, y
        return collect

    def run_main(out_dir: str, reuse: bool) -> tuple[float, list[str]]:
        env = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("TRAIN_")}
        if reuse:
            os.environ["TRAIN_REUSE_CORPUS"] = "1"
        printed = io.StringIO()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                train_default.main(["--out", out_dir])
            return time.perf_counter() - t0, printed.getvalue().splitlines()
        finally:
            os.environ.pop("TRAIN_REUSE_CORPUS", None)
            os.environ.update(env)

    work = tempfile.mkdtemp(prefix="lrr_train_verifier_")
    try:
        # the path, counted: five pairs collected, the fit, the files
        kernels.reset_launch_counts()
        for name, fn in originals.items():
            setattr(train_default, name, measured(fn))
        try:
            main_s, main_lines = run_main(os.path.join(work, "collected"), reuse=False)
        finally:
            for name, fn in originals.items():
                setattr(train_default, name, fn)
        launches = dict(kernels.LAUNCHES)
        k1_shapes, k2_shapes = dict(kernels.K1_SHAPES), dict(kernels.K2_SHAPES)
        note_path_shapes("train_verifier")
        collected = os.path.join(work, "collected")
        model = load_default_verifier(os.path.join(collected, "verifier_default.model"))
        with open(os.path.join(collected, "verifier_default.model.json")) as f:
            written = json.load(f)
        corpus = train_default.load_corpus(os.path.join(collected, "verifier_corpus.npz"))
        ctx5, _, _, cfg5, meta5 = bench
        dev = ctx5.device
        specs = [*train_default.BENCH_SPECS, *train_default.REF_SPECS]
        names = [name for name, _, _ in corpus]
        if [c.pop("spec") for c in calls] != specs or len(names) != len(specs):
            problems.append(f"{len(calls)} pairs collected, {names} in the corpus")
        pairs = dict(zip(names, calls))
        for name, X, y in corpus:
            rec = lrr_tpu_record.get(name, {})
            pairs[name]["lrr_tpu_rows_aligned"] = [rec.get("rows"), rec.get("aligned")]
            if X.shape != (pairs[name]["rows"], 8):
                problems.append(f"{name}: the corpus file holds {X.shape} rows")
        if [e["name"] for e in written["pairs"]] != names:
            problems.append(f"the written .json names {written['pairs']}")
        if any(p["device"] != "cuda" for p in pairs.values()):
            problems.append("a pair was not collected on the card")
        shipped_scores = train_default.corpus_scores(shipped, pooled(corpus))
        trained_scores = train_default.corpus_scores(model, pooled(corpus))
        problems += score_problems("shipped model on the port's corpus", shipped_scores)
        problems += score_problems("port's model on its corpus", trained_scores)
        for entry in written["pairs"]:
            s = trained_scores[entry["name"]]
            if entry["acc"] != round(s["acc"], 4) or entry["rows"] != s["rows"]:
                problems.append(f"the written .json says {entry}, the model scores {s}")

        # the port's model serving: phase 5's bench queries with phase 4's
        # bars (the shared function raises), then phase 7's queries and plan
        serve_and_check("train_verifier_serve_bench", ctx5, cfg5, meta5, seed, card,
                        svm=model, verifier="port-trained (phase 14)")
        ctx_r, queries7, true7, diagnosis7 = served_ref
        cfg7 = train_default.reference_cfg()
        q7 = torch.as_tensor(queries7, device=dev)
        plan7 = draw_sampling_plan(
            torch.Generator().manual_seed(served7["plan_seed"]), len(queries7), cfg7,
            ctx_r.moving_features.capacity, ctx_r.fixed_features.capacity, dev)
        counts7 = kernels.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out7 = register_locations_staged(ctx_r, q7, cfg7, model, plan7)
        torch.cuda.synchronize()
        serve7_s = time.perf_counter() - t0
        note_path_shapes("train_verifier_serve_reference", kernels.counts_since(counts7))
        acc7 = acceptance_stats(out7, queries7, true7)
        sel7 = out7.selected.cpu().numpy()
        shipped7 = np.asarray(served7["selected"])
        serve7 = {
            "seconds": serve7_s, "verified": int((sel7 >= 0).sum()), **acc7,
            "selected": sel7.tolist(),
            "shipped": {"verified": int((shipped7 >= 0).sum()),
                        "median_gt_error_mm": served7["median_gt_error_mm"],
                        "selected": shipped7.tolist()},
        }
        if serve7["verified"] < 12:
            problems.append(f"phase 7's queries: {serve7['verified']} of {len(queries7)} "
                            "verified, want 12")
        if acc7["median_gt_error_mm"] is None or acc7["median_gt_error_mm"] >= 1.0:
            problems.append(f"phase 7's queries: median GT error {acc7['median_gt_error_mm']} mm")
        for row in diagnosis7:
            m = torch.tensor([row["measurements"]], dtype=torch.float32, device=dev)
            row["p_port_trained"] = float(predict_probability(
                model.to(dev), scale_measurements(m))[0])
            row["verified_by_port_trained"] = bool(sel7[row["query"]] >= 0)

        # the refit route on the committed corpus, against the shipped file
        refit_s, refit_lines = run_main(os.path.join(work, "refit"), reuse=True)
        refit = load_default_verifier(os.path.join(work, "refit", "verifier_default.model"))
        committed = train_default.load_corpus()
        X = torch.from_numpy(np.concatenate([x for _, x, _ in committed])).to(dev)
        diff = (predict_probability(refit.to(dev), scale_measurements(X))
                - predict_probability(shipped.to(dev), scale_measurements(X))).abs()
        refit_rec = {"seconds": refit_s, "rows": int(X.shape[0]),
                     "support_vectors": int(refit.sv.shape[0]),
                     "max_abs_p_diff_vs_shipped": float(diff.max()), "printed": refit_lines}
        if refit_rec["support_vectors"] != 288 or refit_rec["rows"] != 1680:
            problems.append(f"refit: {refit_rec['support_vectors']} support vectors on "
                            f"{refit_rec['rows']} rows, want 288 on 1680")
        if not refit_rec["max_abs_p_diff_vs_shipped"] <= REFIT_P_TOL:
            problems.append(f"refit: P differs from the shipped file's by "
                            f"{refit_rec['max_abs_p_diff_vs_shipped']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    phase(
        "train_verifier", card=card, main_s=main_s, printed=main_lines, pairs=pairs,
        support_vectors=int(model.sv.shape[0]), prob_ab=[model.prob_a, model.prob_b],
        shipped_on_port_corpus=shipped_scores, port_model_on_port_corpus=trained_scores,
        serve_reference_queries=serve7, phase7_diagnosis=diagnosis7, refit=refit_rec,
        launches=launches, **shape_rows(k1_shapes, k2_shapes),
        peak_mem_gb=max(p["peak_mem_gb"] for p in pairs.values()), problems=problems,
    )
    if problems:
        raise AssertionError("train_verifier: " + "; ".join(problems))
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"train_verifier: kernel {name} was never launched on the path")
    return launches, k1_shapes, k2_shapes


# ---------------------------------------------------------------------------
# phase 15: speed of light (lrr_tpu_torch.utils.sol)
# ---------------------------------------------------------------------------


SHARE_MAX = 1.05  # a share above 1 by more than timing noise is a wrong bound or time


def sol_shares(report: dict) -> dict[str, float]:
    """Every share of a bound in the report, by its path in the report."""
    shares = {}
    for name in ("icp_iteration_bench", "icp_iteration_reference"):
        for key in ("fraction_of_light", "sample_fraction_of_gather_roofline"):
            shares[f"{name}.{key}"] = report[name][key]
    nn = report["descriptor_nn"]
    shares["descriptor_nn.fraction_of_peak"] = nn["fraction_of_peak"]
    for name, v in nn["variants"].items():
        shares[f"descriptor_nn.variants.{name}.fraction_of_peak"] = v["fraction_of_peak"]
    return shares


def run_sol(seed: int, card: str):
    """Phase 15: `kernel_sol_report` on the card, the launch counts set to 0
    just before it and read just after, then K2 against its plain version on
    the report's descriptor tables."""
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.utils import sol

    dev = torch.device("cuda", 0)
    roof = sol.measured_gather_roofline(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    report = sol.kernel_sol_report(seed=seed, device=dev)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    k1_shapes, k2_shapes = dict(kernels.K1_SHAPES), dict(kernels.K2_SHAPES)
    note_path_shapes("sol")

    qd, pd, mask = sol.descriptor_nn_inputs(4096, 4096, seed, dev)
    _, idx = kernels.knn(qd, pd, mask, 1)
    _, idx_plain = kernels.knn_plain(qd, pd, mask, 1)
    shares = sol_shares(report)
    problems = [f"{k} = {v} outside (0, {SHARE_MAX}]" for k, v in shares.items()
                if not 0 < v <= SHARE_MAX]
    for key in ("gather_gb_s_padded_small", "gather_gb_s_dense_big"):
        if not 0 < roof[key] < sol.PEAK_HBM_GBS:
            problems.append(f"{key} = {roof[key]} GB/s, not under the peak {sol.PEAK_HBM_GBS}")
    if not torch.equal(idx, idx_plain):
        problems.append("K2's indices differ from knn_plain's on the report's inputs")
    for name in ("normal_equations", "knn", "pinv_sym", "sample_matches"):  # no stage 1 (K4)
        if launches[name] <= 0:
            problems.append(f"kernel {name} was never launched by the report")
    phase("sol", card=card, seconds=seconds, peaks={
        "f32_tflops": sol.PEAK_F32_TFLOPS, "tf32_tflops": sol.PEAK_TF32_TFLOPS,
        "hbm_gbs": sol.PEAK_HBM_GBS}, gather_roofline=roof, report=report, shares=shares,
        launches=launches, **shape_rows(k1_shapes, k2_shapes),
        knn_indices_equal_plain=bool(torch.equal(idx, idx_plain)), problems=problems)
    if problems:
        raise AssertionError("sol: " + "; ".join(problems))
    return launches, k1_shapes, k2_shapes


# ---------------------------------------------------------------------------
# phase 16: waves from captured CUDA graphs, and K3
# ---------------------------------------------------------------------------

PINV_TOL_F64 = 1e-6  # x max |entry|: K3 against float64 on the same float32 inputs
PINV_TOL_KAPPA = 100  # K3 against the plain version: 100 x kappa x eps_f32 x max |entry|
WAVE_RUNS = 9  # eager and graph runs of each context, alternating


def pinv_f64(a: torch.Tensor) -> tuple[np.ndarray, float]:
    """The plain version's cut on the float32 matrices, solved in float64,
    and the largest condition number among the eigenvalues kept."""
    x = a.double().cpu().numpy()
    n = x.shape[-1]
    w, v = np.linalg.eigh(x)
    big = np.abs(w).max(-1, keepdims=True)
    keep = np.abs(w) > 10 * n * 2.0**-23 * big
    inv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
    small = np.where(keep, np.abs(w), np.inf).min(-1)
    return (v * inv[:, None, :]) @ np.swapaxes(v, 1, 2), float((big[:, 0] / small).max())


def pinv_bound_ms(L: int, n: int) -> tuple[float, str]:
    """K3's least time from its inputs alone: the L float32 matrices read
    and their pseudo-inverses written once at the HBM rate, or the float32
    operations of the function at the float32 peak: 9 n^3 a matrix for the
    symmetric eigendecomposition with eigenvectors (Golub and Van Loan's
    count for the symmetric QR algorithm) and n^3 for V diag(1/lambda) V^T
    (one triangle, 2 n an entry).  The kernel's float64 Jacobi does more
    than this; the bound does not move with it."""
    from lrr_tpu_torch.utils.sol import PEAK_F32_TFLOPS, PEAK_HBM_GBS

    t_bytes = 2 * L * n * n * 4 / (PEAK_HBM_GBS * 1e9) * 1e3
    t_ops = L * 10 * n**3 / (PEAK_F32_TFLOPS * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_pinv(timer, a: torch.Tensor, label: str) -> dict:
    """K3 against its plain version (`kernels.pinv_hermitian_plain`) and
    float64 on one batch: bits twice, symmetry, all-NaN for a non-finite
    matrix, the errors against their tolerances, times and bound."""
    from lrr_tpu_torch.ops import kernels

    L, n = a.shape[0], a.shape[-1]
    got = kernels.pinv_hermitian_small(a)
    again = kernels.pinv_hermitian_small(a)
    plain = kernels.pinv_hermitian_plain(a)
    rot = torch.zeros(L, dtype=torch.int32, device=a.device)
    kernels.pinv_hermitian_small(a, rot)
    torch.cuda.synchronize()
    bits = got.view(torch.int32)  # NaN-safe: compare the bits
    if not torch.equal(bits, again.view(torch.int32)):
        raise AssertionError(f"K3 {label}: two launches on the same inputs differ")
    if not torch.equal(bits, bits.transpose(1, 2)):
        raise AssertionError(f"K3 {label}: the pseudo-inverse is not symmetric")
    ok = torch.isfinite(a).flatten(1).all(1)
    if not (bool(torch.isnan(got[~ok]).all()) and bool(torch.isnan(plain[~ok]).all())):
        raise AssertionError(f"K3 {label}: a non-finite matrix did not give all-NaN")
    rec = {"L": L, "n": n, "non_finite": int((~ok).sum())}
    if bool(ok.any()):
        f64, kappa = pinv_f64(a[ok])
        scale = float(np.abs(f64).max())
        err_f64 = float(np.abs(got[ok].cpu().numpy() - f64).max())
        err = float((got[ok] - plain[ok]).abs().max())
        tol = PINV_TOL_KAPPA * kappa * 2.0**-23 * float(plain[ok].abs().max())
        rec.update(max_abs_err=err, tolerance=tol, max_abs_err_f64=err_f64,
                   tolerance_f64=PINV_TOL_F64 * scale, kappa=kappa, max_abs_entry=scale)
        if err_f64 > PINV_TOL_F64 * scale or err > tol:
            raise AssertionError(f"K3 {label}: err {err} (tol {tol}), against float64 "
                                 f"{err_f64} (tol {PINV_TOL_F64 * scale})")
    bound, by = pinv_bound_ms(L, n)
    ms = timer.ms(lambda: kernels.pinv_hermitian_small(a))
    rec.update(
        rotations=spread(rot.float()),  # a diagnostic: the bound does not use it
        bit_identical=True, ms=ms,
        ms_warm=timer.ms(lambda: kernels.pinv_hermitian_small(a), cold=False),
        plain_ms=timer.ms(lambda: kernels.pinv_hermitian_plain(a), reps=5),
        bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
        library_ms=timer.ms(lambda: torch.linalg.pinv(a, hermitian=True), reps=5)
        if bool(ok.all()) else None)
    return rec


def pinv_batch(rng, L: int, n: int, kind: str, dev) -> torch.Tensor:
    """Symmetric [L, n, n]: V diag(lam) V^T, |lam| over three decades; "rank"
    zeroes two eigenvalues, "nonfinite" puts a NaN or an inf into every third
    matrix."""
    out = np.empty((L, n, n), np.float32)
    for i in range(L):
        v, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.logspace(0, -3, n) * 10.0 ** rng.uniform(-2, 2)
        if kind == "rank":
            lam[-2:] = 0.0
        x = (v * lam) @ v.T
        out[i] = (x + x.T) / 2
    if kind == "nonfinite":
        out[::3, 1, n - 1] = np.nan
        out[1::3, 0, 0] = np.inf
    return torch.tensor(out, device=dev)


@contextlib.contextmanager
def eager_waves():
    """Serve through the eager `_wave_fn`, the graphs' oracle."""
    from lrr_tpu_torch.pipeline import registration

    runner = registration._wave_runner
    registration._wave_runner = registration._eager_wave_runner
    try:
        yield
    finally:
        registration._wave_runner = runner


def serve_both_paths(ctx, q, cfg, svm, plan_for, runs: int = WAVE_RUNS) -> dict:
    """One warm-up run a path (the graphs' buckets are built in the graph
    one), then `runs` eager and `runs` graph runs alternating, each pair on
    one plan and compared bit for bit; then one run a path for its peak
    memory."""
    from lrr_tpu_torch.pipeline import registration, wave_graph

    def serve(plan, graphs: bool):
        with contextlib.nullcontext() if graphs else eager_waves():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = registration.register_locations_staged(ctx, q, cfg, svm, plan)
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    wave_graph.drop()
    _, warm_graph_s = serve(plan_for(100), True)
    _, warm_eager_s = serve(plan_for(100), False)
    built = wave_graph.stats()
    times = {True: [], False: []}
    equal, outs = True, {}
    for i in range(runs):
        plan = plan_for(i)
        for graphs in ((False, True) if i % 2 == 0 else (True, False)):
            outs[graphs], s = serve(plan, graphs)
            times[graphs].append(s)
        equal = equal and wave_graph.first_difference(outs[True], outs[False]) is None
    after = wave_graph.stats()
    waves = after["waves"] - built["waves"]
    peak = {}
    for graphs in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        serve(plan_for(0), graphs)
        peak["graph" if graphs else "eager"] = torch.cuda.max_memory_allocated() / 1e9

    def summary(x):
        return {"runs_s": x, "median_s": statistics.median(x), "min_s": min(x), "max_s": max(x)}

    return {
        "eager": summary(times[False]), "graph": summary(times[True]),
        "warmup_s": {"graph_with_build": warm_graph_s, "eager": warm_eager_s},
        "build_s_by_bucket": built["build_s"], "buckets": sorted(built["build_s"]),
        "graph_waves": waves,
        "replays_per_wave": (after["replays"] - built["replays"]) / max(waves, 1),
        "host_reads_per_wave": (after["syncs"] - built["syncs"]) / max(waves, 1) + 1,
        "graph_equal_eager": equal, "peak_mem_gb": peak,
    }, outs[True], outs[False]


def device_busy(wall_fn) -> dict:
    """One call of `wall_fn` under torch.profiler: its wall seconds, the
    union of the device's kernel intervals in it, and their share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wall_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"wall_s": wall, "device_busy_s": busy / 1e6, "device_busy_share": busy / 1e6 / wall,
            "device_kernels": len(spans)}


def k5_graph_launches(problems: list, label: str) -> dict:
    """K5's launches recorded by each part of each bucket the last served
    context captured: two a MUSE iteration in the prologue, two an
    iteration in each chunk (2 x ITERATIONS_PER_CHECK a replay), two for
    the backward covariance in the epilogue; a part off that is a problem."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline import wave_graph

    out = {}
    for graphs in wave_graph._CACHE["graphs"].values():
        for bucket, b in sorted(graphs.buckets.items()):
            got = {"prologue": b.prologue.launches[0].get("sample_matches", 0),
                   "chunks": [g.launches[0].get("sample_matches", 0) for g in b.chunks],
                   "epilogue": b.epilogue.launches[0].get("sample_matches", 0)}
            want = {"prologue": 2, "chunks": [2 * icp.ITERATIONS_PER_CHECK] * len(b.chunks),
                    "epilogue": 2}
            if got != want:
                problems.append(f"{label} bucket {bucket}: K5 launches {got}, want {want}")
            out[str(bucket)] = got
    if not out:
        problems.append(f"{label}: no captured bucket to read K5's launches from")
    return out


def run_wave_graphs(seed: int, card: str, served_ref, ref_cfg, timer):
    """Phase 16: the bench context (phase 4's) and phase 7's context at the
    reference constants, each served by the eager waves and by the captured
    graphs in alternating runs: seconds, the graphs' build per bucket,
    replays and host reads a wave, peak memory, the two paths' results bit
    for bit, and both inside their acceptance bars; one profiled graph run
    of the bench for the device's busy share; then K3 against its plain
    version on the systems of one eager bench wave and on synthetic
    batches."""
    from lrr_tpu_torch.estimation import icp, measurements
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline import registration, wave_graph
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    svm = load_default_verifier()
    meta, cfg = load_bench_meta()
    ctx_r, queries_r, true_r, _ = served_ref
    problems = []
    # the main path, counted: context load (K2), both paths serving both
    # contexts, and the profiled run
    kernels.reset_launch_counts()
    ctx = load_pair_context(BENCH + ".npz")
    dev = ctx.device
    queries = np.asarray(meta["queries"], np.float32)
    q = torch.as_tensor(queries, device=dev)
    true = Affine3D(*(torch.tensor(meta["true"][k], device=dev) for k in ("A", "t", "center")))

    def bench_plan(run: int):
        return draw_sampling_plan(torch.Generator().manual_seed(seed * 1000 + 1600 + run),
                                  len(queries), cfg, ctx.moving_features.capacity,
                                  ctx.fixed_features.capacity, dev)

    bench, g_out, e_out = serve_both_paths(ctx, q, cfg, svm, bench_plan)
    bench["k5_launches_by_part"] = k5_graph_launches(problems, "bench")
    ref = meta["lrr_tpu_reference"]
    cap = max(1.0, 1.5 * ref["median_gt_error_mm"])
    for path, out in (("graph", g_out), ("eager", e_out)):
        acc = bench[f"{path}_acceptance"] = acceptance_stats(out, queries, true)
        if (acc["verified_frac"] < ref["verified_frac"] - 2.0 / len(queries)
                or acc["rank0_frac"] < ref["rank0_frac"] - 2.0 / len(queries)
                or acc["median_gt_error_mm"] is None or acc["median_gt_error_mm"] > cap):
            problems.append(f"bench {path}: acceptance {acc} outside the bars (error <= {cap})")
    bench["profiled_graph_run"] = device_busy(
        lambda: registration.register_locations_staged(ctx, q, cfg, svm, bench_plan(200)))

    q_r = torch.as_tensor(queries_r, device=dev)

    def ref_plan(run: int):
        return draw_sampling_plan(torch.Generator().manual_seed(seed * 1000 + 1700 + run),
                                  len(queries_r), ref_cfg, ctx_r.moving_features.capacity,
                                  ctx_r.fixed_features.capacity, dev)

    reference, g_ref, e_ref = serve_both_paths(ctx_r, q_r, ref_cfg, svm, ref_plan)
    reference["k5_launches_by_part"] = k5_graph_launches(problems, "reference")
    for path, out in (("graph", g_ref), ("eager", e_ref)):
        acc = reference[f"{path}_acceptance"] = acceptance_stats(out, queries_r, true_r)
        verified = reference[f"{path}_verified"] = int((out.selected >= 0).sum())
        if verified < 12 or acc["median_gt_error_mm"] is None or acc["median_gt_error_mm"] >= 1.0:
            problems.append(f"reference {path}: {verified} verified, {acc}")
    wave_graph.drop()
    launches = dict(kernels.LAUNCHES)
    k1_shapes, pinv_shapes = dict(kernels.K1_SHAPES), dict(kernels.PINV_SHAPES)
    note_path_shapes("wave_graphs")
    for name in ("normal_equations", "knn", "pinv_sym", "sample_matches"):  # no stage 1 (K4)
        if launches[name] <= 0:
            problems.append(f"kernel {name} was never launched on the path")
    for label, rec in (("bench", bench), ("reference", reference)):
        if not rec["graph_equal_eager"]:
            problems.append(f"{label}: the graph runs differ from the eager runs")

    # K3 on the 12 x 12 systems of one eager bench wave (its first launch
    # there: 64 lanes), then on synthetic batches
    systems = []
    pinv = kernels.pinv_hermitian_small

    def keep(a, rotations=None):
        systems.append(a.clone())
        return pinv(a, rotations)

    # and every sampler call of that run one K5 launch
    calls = [0]
    samplers = {mod: mod._sample_matches_packed for mod in (icp, measurements)}

    def counted(mod):
        def call(*a, **k):
            calls[0] += 1
            return samplers[mod](*a, **k)
        return call

    kernels.pinv_hermitian_small = keep
    for mod in samplers:
        mod._sample_matches_packed = counted(mod)
    k5_before = kernels.LAUNCHES["sample_matches"]
    try:
        with eager_waves():
            registration.register_locations_staged(ctx, q, cfg, svm, bench_plan(0))
    finally:
        kernels.pinv_hermitian_small = pinv
        for mod, fn in samplers.items():
            mod._sample_matches_packed = fn
    k5_per_call = (kernels.LAUNCHES["sample_matches"] - k5_before) / max(calls[0], 1)
    if calls[0] == 0 or k5_per_call != 1.0:
        problems.append(f"K5 launches over sampler calls {k5_per_call} ({calls[0]} calls)")
    wave_ata = next(a for a in systems if a.shape[0] == 64 and a.shape[-1] == 12)
    rng = np.random.default_rng(seed + 16)
    k3 = {"bench_wave_64x12": measure_pinv(timer, wave_ata, "bench wave")}
    # the lane counts the paths give K3 (the buckets, phase 15's 20 lanes,
    # the rigid refinement's one) and 1 / 8 / 24 / 64 for n = 6
    for L, n in [(L, 12) for L in (1, 8, 16, 20, 24, 32, 64)] + [(L, 6) for L in (1, 8, 24, 64)]:
        for kind in ("spd", "rank", "nonfinite"):
            rec = measure_pinv(timer, pinv_batch(rng, L, n, kind, dev), f"{L}x{n} {kind}")
            k3[f"{L}x{n}_{kind}"] = rec
    phase("wave_graphs", card=card, iterations_per_check=icp.ITERATIONS_PER_CHECK,
          bench=bench, reference=reference, launches=launches,
          k5_launches_per_sampler_call=k5_per_call, sampler_calls=calls[0],
          k1_shapes=[{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n}
                     for k, n in sorted(k1_shapes.items(), key=lambda kv: -kv[1])],
          pinv_shapes=[{"L": k[0], "n": k[1], "launches": n} for k, n in sorted(pinv_shapes.items())],
          pinv_sym=k3, problems=problems)
    if problems:
        raise AssertionError("wave_graphs: " + "; ".join(problems))
    return launches, k1_shapes, k3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel-rank", help=argparse.SUPPRESS)  # phase 13's ranks
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test runs only on the GPU")
    from lrr_tpu_torch.ops import native  # fails here, before any output, without the repo

    if args.parallel_rank:
        return parallel_rank(args.parallel_rank)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    paths, build_s = native.build()
    lib = native.library()
    phase("build", seconds=build_s, libraries=[os.path.relpath(p, ROOT) for p in paths],
          ptxas=ptxas_report(native.build_logs()))

    rng = np.random.default_rng(args.seed)
    timer = Timer(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor_ms = timer.ms(lambda: native.check(lib.lrr_empty(stream), "empty"), cold=False)
    k1 = check_k1(rng, dev, timer)
    k2 = check_k2(rng, dev, timer)
    k5 = check_k5(rng, dev, timer)
    phase("kernels", card=card, launch_floor_ms=floor_ms, normal_equations=k1, knn=k2,
          sample_matches=k5)

    launches4, shapes4 = run_slice(args.seed, card)
    (launches5, shapes5), bench = run_stage1_bench(args.seed, card)
    ref = run_stage1_reference(card, timer)
    launches7, shapes7, served7, served_ref = run_serve_reference(args.seed, card, ref)
    launches8, shapes8, entries8 = run_regions_bench(args.seed, card, bench)
    launches14, shapes14, k2_14 = run_train_verifier(args.seed, card, bench, served_ref, served7)
    launches16, shapes16, k3 = run_wave_graphs(args.seed, card, served_ref, ref[4], timer)
    del served_ref
    bench_sets = estimate_inputs(bench)
    del bench
    launches_cli, shapes_cli, k2_cli = run_cli_reference(args.seed, card, ref)
    run_estimate(args.seed, card, bench_sets, ref)
    digests6 = ref[-1]
    del ref, bench_sets
    work = tempfile.mkdtemp(prefix="lrr_batch_parallel_")
    try:
        launches_batch, shapes_batch, k2_batch, batch10 = run_batch_calibrate(args.seed, card, work)
        launches13, shapes13, k2_13 = run_parallel(args.seed, card, digests6, served7, batch10, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches15, shapes15, k2_15 = run_sol(args.seed, card)
    by_path = {"slice": launches4, "stage1_bench": launches5,
               "stage1_reference+serve_reference": launches7, "cli_reference": launches_cli,
               "regions_bench": launches8, "batch_calibrate": launches_batch,
               "parallel": launches13, "train_verifier": launches14, "sol": launches15,
               "wave_graphs": launches16,
               "regions_bench_by_entry": {
                   name: {k: e[k] for k in launches4} for name, e in entries8.items()}}
    launches = {name: sum(path[name] for path in (launches4, launches5, launches7, launches_cli,
                                                  launches8, launches_batch, launches13,
                                                  launches14, launches15, launches16))
                for name in launches4}

    # K1 against its plain version at every shape a path gave it (as row
    # views, the layout the ICP hands over) that phase 3 did not hold, and
    # K2 at every shape the file-based paths gave it
    path_shapes: dict[tuple[int, int, int], dict[str, int]] = {}
    for path, shapes in (("slice", shapes4), ("stage1_bench", shapes5),
                         ("serve_reference", shapes7), ("cli_reference", shapes_cli),
                         ("regions_bench", shapes8), ("batch_calibrate", shapes_batch),
                         ("train_verifier", shapes14), ("sol", shapes15),
                         ("wave_graphs", shapes16)):
        for shape, n in shapes.items():
            path_shapes.setdefault(shape, {})[path] = n
    for shape, by_rank in shapes13.items():  # per rank: "parallel_rank0", ...
        path_shapes.setdefault(shape, {}).update(by_rank)
    added = {}
    for shape in sorted(path_shapes):
        if k1_key(*shape, True) not in k1:
            k1[k1_key(*shape, True)] = added[k1_key(*shape, True)] = measure_k1(
                rng, dev, timer, *shape, True)
    k2_path_shapes: dict[tuple[int, int, int, int], dict[str, int]] = {}
    for path, shapes in (("cli_reference", k2_cli), ("batch_calibrate", k2_batch),
                         ("train_verifier", k2_14), ("sol", k2_15)):
        for shape, n in shapes.items():
            k2_path_shapes.setdefault(shape, {})[path] = n
    for shape, by_rank in k2_13.items():
        k2_path_shapes.setdefault(shape, {}).update(by_rank)
    k2_added = {}
    for shape in sorted(k2_path_shapes):
        if k2_key(*shape) not in k2:
            k2[k2_key(*shape)] = k2_added[k2_key(*shape)] = measure_k2(
                rng, dev, timer, *shape, False)
    # K3 against its plain version and float64 at every (L, n) a path gave
    # it that phase 16 did not hold
    k3_added = {}
    for L, n in sorted(PINV_PATH_SHAPES):
        for kind in ("spd", "rank", "nonfinite"):
            key = f"{L}x{n}_{kind}"
            if key not in k3:
                k3[key] = k3_added[key] = measure_pinv(
                    timer, pinv_batch(rng, L, n, kind, dev), key)
    unchecked = [shape for shape in PINV_PATH_SHAPES
                 if "max_abs_err" not in k3.get(f"{shape[0]}x{shape[1]}_spd", {})]
    # K4 against its plain version at every (D, H, W, N) a path gave it
    # that phase 6 did not hold, on features made for the shape
    k4_added = {}
    for D, H, W, n in sorted(VORONOI_PATH_SHAPES):
        if k4_key((D, H, W), n) not in K4_MEASURED:
            k4_added[k4_key((D, H, W), n)] = measure_k4(
                timer, *k4_inputs(rng, (D, H, W), n, dev), (D, H, W))
    # K5 against its plain version at every (L, m, kind) a path gave it
    # that phase 3 did not hold, on a small map with m sources a lane's box
    k5_added = {}
    for L, m, kind in sorted(SAMPLE_PATH_SHAPES):
        if k5_key(L, m, kind) not in K5_MEASURED:
            k5_added[k5_key(L, m, kind)] = measure_k5(
                timer, k5_inputs(rng, L, m, (64, 64, 64), dev, box_mm=40.0), m, kind, None)
    phase("kernels_path_shapes", card=card, normal_equations=added, knn=k2_added,
          pinv_sym=k3_added, voronoi=k4_added, sample_matches=k5_added,
          launches={k1_key(*shape, True): n for shape, n in sorted(path_shapes.items())},
          knn_launches={k2_key(*shape): n for shape, n in sorted(k2_path_shapes.items())},
          pinv_sym_launches={f"{L}x{n}": by for (L, n), by in sorted(PINV_PATH_SHAPES.items())},
          voronoi_launches={k4_key(shape[:3], shape[3]): by
                            for shape, by in sorted(VORONOI_PATH_SHAPES.items())},
          sample_matches_launches={k5_key(*shape): by
                                   for shape, by in sorted(SAMPLE_PATH_SHAPES.items())},
          pinv_sym_unchecked=unchecked)
    if unchecked:
        raise AssertionError(f"kernels_path_shapes: K3 unchecked at {unchecked}")

    # each kernel at the shape the serving path (phase 4) gives it most often
    k1_main = max(shapes4, key=shapes4.get)
    k1m, k2m, k2r = k1[k1_key(*k1_main, True)], k2["128x128x195_k1"], k2["4096x4096x195_k1"]
    k3m = k3["bench_wave_64x12"]
    k4m = next(rec for rec in K4_MEASURED.values() if tuple(rec["shape"]) == COPD512_MAP)
    k5m = K5_MEASURED[k5_key(512, 2048, "grid")]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "normal_equations", "route": "cuda",
         "source": "lrr_tpu_torch/csrc/normal_equations.cu",
         "replaces": "lrr_tpu/ops/pallas_kernels.py:212",
         "launches": launches["normal_equations"], **{k: k1m[k] for k in keys},
         "shape": k1_key(*k1_main, True),
         "other_path_shapes": {
             k1_key(*shape, True): {**{k: k1[k1_key(*shape, True)][k] for k in keys},
                                    "launches": sum(n.values()), "launches_by_path": n}
             for shape, n in sorted(path_shapes.items()) if shape != k1_main}},
        {"name": "knn", "route": "cuda", "source": "lrr_tpu_torch/csrc/knn.cu",
         "replaces": "lrr_tpu/ops/pallas_kernels.py:108",
         "launches": launches["knn"], **{k: k2r[k] for k in keys},
         "shape": "4096x4096x195_k1",
         "other_path_shapes": {
             "128x128x195_k1": {k: k2m[k] for k in keys},
             **{k2_key(*shape): {**{k: k2[k2_key(*shape)][k] for k in keys},
                                 "launches": sum(n.values()), "launches_by_path": n}
                for shape, n in sorted(k2_path_shapes.items())
                if k2_key(*shape) not in ("128x128x195_k1", "4096x4096x195_k1")}}},
        {"name": "pinv_sym", "route": "cuda", "source": "lrr_tpu_torch/csrc/pinv_sym.cu",
         "replaces": None,
         "note": "no Pallas counterpart: lrr_tpu leaves the ICP's pseudo-inverse to XLA's "
                 "eigensolver inside its wave program; the port's plain version is "
                 "torch.linalg.pinv(hermitian=True), which reads its status back on the host",
         "launches": launches["pinv_sym"], **{k: k3m[k] for k in keys},
         "shape": "64x12x12 (one bench wave's systems)",
         "other_path_shapes": {
             f"{L}x{n}x{n}": {**{k: k3[f"{L}x{n}_spd"][k] for k in keys},
                              "launches": sum(by.values()), "launches_by_path": by}
             for (L, n), by in sorted(PINV_PATH_SHAPES.items())}},
        {"name": "voronoi", "route": "cuda", "source": "lrr_tpu_torch/csrc/voronoi.cu",
         "replaces": None,
         "note": "no Pallas counterpart: lrr_tpu builds the Voronoi map with XLA ops; the "
                 "port's plain versions are ops/voronoi.py's exact builds (blocked above 4M "
                 "voxels), which `plain_ms` times once on the card",
         "launches": launches["voronoi"], "bit_identical": True,
         **{k: k4m[k] for k in ("ms", "ms_warm", "plain_ms", "bound_ms", "bound_by",
                                "share_of_bound", "pairs_per_voxel")},
         "shape": "x".join(map(str, COPD512_MAP)) + f"x{k4m['features']} (copd512's map)",
         "other_path_shapes": {
             k4_key(shape[:3], shape[3]): {
                 **{k: K4_MEASURED[k4_key(shape[:3], shape[3])][k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by", "pairs_per_voxel")},
                 "launches": sum(by.values()), "launches_by_path": by}
             for shape, by in sorted(VORONOI_PATH_SHAPES.items())}},
        {"name": "sample_matches", "route": "cuda",
         "source": "lrr_tpu_torch/csrc/sample_matches.cu", "replaces": None,
         "note": "no Pallas counterpart: lrr_tpu samples the ICP's matches with XLA gathers "
                 "(`_take_rows8`); the port's plain version is estimation/icp.py::"
                 "sample_matches_plain, two 32-byte row gathers and ~50 eager launches",
         "launches": launches["sample_matches"], "bit_identical": True,
         **{k: k5m[k] for k in ("ms", "ms_warm", "plain_ms", "bound_ms", "bound_by",
                                "share_of_bound")},
         "shape": k5_key(512, 2048, "grid") + " (a copd512 wave's second level, copd512's map)",
         "other_path_shapes": {
             k5_key(*shape): {
                 **{k: K5_MEASURED[k5_key(*shape)][k]
                    for k in ("ms", "plain_ms", "bound_ms", "share_of_bound")},
                 "launches": sum(by.values()), "launches_by_path": by}
             for shape, by in sorted(SAMPLE_PATH_SHAPES.items())}},
    ], "launch_floor_ms": floor_ms, "launches_by_path": by_path}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

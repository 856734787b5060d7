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
  4. slice    the committed bench pair context (bench.py's 64^3 workload)
              is loaded onto the card and `register_locations_staged` serves
              its 64 queries: one warm-up and three timed runs, acceptance
              held against lrr_tpu's recorded result for that context, the
              kernels' launch counts over the whole run (both > 0) and the
              shapes the run gave K1.
Then a JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "lrr_tpu_torch", "data", "bench_pair_s64")
K1_TOL = 2e-5  # x max |entry|: fp32 sums in another order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM outside the tensor cores, data sheet
K1_FLOP_PER_MATCH = 225  # normalise 15, P 15, w*P^T P 36, h h^T 6, AtA 114, Atb 39


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


def k1_bound_ms(fwd, bwd) -> tuple[float, str]:
    """The larger of bytes over the memory rate (each input element read
    once: 11 floats a match, the frame; the system written once) and the
    operations these weights need (w <= 0 is skipped) over the fp32 rate."""
    L = fwd[4].shape[0]
    matches = fwd[4].shape[1] + bwd[4].shape[1]
    nbytes = 4 * (L * matches * 11 + L * 11 + L * 156)
    flop = K1_FLOP_PER_MATCH * (int((fwd[4] > 0).sum()) + int((bwd[4] > 0).sum()))
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def measure_k1(rng, dev, timer, L: int, m_f: int, m_b: int, rows: bool) -> dict:
    from lrr_tpu_torch.ops import kernels

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


def check_k2(rng, dev, timer):
    from lrr_tpu_torch.ops import kernels

    results = {}
    for q_n, p_n, dim, k, masked in [
        (37, 129, 195, 1, False), (200, 700, 195, 20, False),
        (128, 128, 195, 1, False), (8, 16, 195, 2, True),
        (4096, 4096, 195, 1, False), (4096, 4096, 195, 20, False),
    ]:
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
        live = int(mask.sum())
        wide, splits = kernels.knn_plan(q_n, p_n, dim, k, dev)
        by_ops = 3 * q_n * live * dim / FP32_FLOP_PER_S * 1e3
        by_bytes = (4 * dim * (q_n + p_n) + p_n + 8 * q_n * k) / HBM_BYTES_PER_S * 1e3
        ms = timer.ms(lambda: kernels.knn(q, p, mask, k))
        big = q_n * p_n > 1 << 20
        results[f"{q_n}x{p_n}x{dim}_k{k}{'_masked' if masked else ''}"] = {
            "Q": q_n, "N": p_n, "D": dim, "k": k, "all_masked": masked, "max_abs_err": err,
            "bit_equal": True, "tiles": "64x64" if wide else "16x16", "point_splits": splits,
            "ms": ms, "ms_warm": timer.ms(lambda: kernels.knn(q, p, mask, k), cold=False),
            "plain_ms": timer.ms(lambda: kernels.knn_plain(q, p, mask, k), reps=3 if big else 5),
            "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "share_of_bound": max(by_ops, by_bytes) / ms, "library_ms": None,
        }
    return results


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------


def acceptance_stats(out, queries: np.ndarray, true) -> dict:
    """bench.py::acceptance_stats: verified and rank-0 fractions and the
    median (over verified queries) of the per-query median ground-truth
    error of the selected transform on 20 probes around the query."""
    sel = out.selected.cpu().numpy()
    rank = out.rank.cpu().numpy()
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
    return {
        "verified_frac": float((sel >= 0).mean()),
        "rank0_frac": float((sel == rank[:, 0]).mean()),
        "median_gt_error_mm": float(np.median(errs)) if errs else None,
    }


def run_slice(seed: int, card: str):
    from lrr_tpu_torch.config import pipeline_config_from_dict
    from lrr_tpu_torch.models.affine import Affine3D
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.pipeline.registration import register_locations_staged
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    with open(BENCH + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    queries = np.asarray(meta["queries"], np.float32)

    # the main path, counted: context load (descriptor-NN table) + serving.
    # No device is named: the port's entry point takes the card by itself.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ctx = load_pair_context(BENCH + ".npz")
    dev = ctx.device
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    true = Affine3D(*(torch.tensor(meta["true"][k], device=dev) for k in ("A", "t", "center")))
    ref = meta["lrr_tpu_reference"]

    svm = load_default_verifier()
    q = torch.as_tensor(queries, device=dev)

    def serve(run: int):
        g = torch.Generator(device=dev).manual_seed(seed * 1000 + run)
        plan = draw_sampling_plan(
            g, len(queries), cfg, ctx.moving_features.capacity,
            ctx.fixed_features.capacity,
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

    acc = acceptance_stats(out, queries, true)
    best = min(times)
    rec = {
        "card": card, "queries": len(queries), "load_s": load_s, "warmup_s": warm_s,
        "run_s": times, "locations_per_s": len(queries) / best,
        "locations_per_s_median": len(queries) / statistics.median(times),
        **acc, "launches": launches,
        "k1_launches_last_run": launches["normal_equations"] - before,
        "k1_shapes": [{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n} for k, n in k1_shapes],
        "lrr_tpu_reference": {k: ref[k] for k in ("verified_frac", "rank0_frac",
                                                   "median_gt_error_mm")},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    phase("slice", **rec)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    slack = 2.0 / len(queries)
    if acc["verified_frac"] < ref["verified_frac"] - slack:
        raise AssertionError(f"verified_frac {acc['verified_frac']} below {ref['verified_frac']}")
    if acc["rank0_frac"] < ref["rank0_frac"] - slack:
        raise AssertionError(f"rank0_frac {acc['rank0_frac']} below {ref['rank0_frac']}")
    err_cap = max(1.0, 1.5 * ref["median_gt_error_mm"])
    if acc["median_gt_error_mm"] is None or acc["median_gt_error_mm"] > err_cap:
        raise AssertionError(f"median_gt_error_mm {acc['median_gt_error_mm']} above {err_cap}")
    return launches, k1_shapes[0][0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke test runs only on the GPU")
    from lrr_tpu_torch.ops import native  # fails here, before any output, without the repo

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
    phase("kernels", card=card, launch_floor_ms=floor_ms, normal_equations=k1, knn=k2)

    launches, k1_main = run_slice(args.seed, card)

    # each kernel at the shape the serving path gives it most often
    if k1_key(*k1_main, True) not in k1:
        k1[k1_key(*k1_main, True)] = measure_k1(rng, dev, timer, *k1_main, True)
        phase("kernels_main_path_shape", card=card, normal_equations=k1[k1_key(*k1_main, True)])
    k1m, k2m = k1[k1_key(*k1_main, True)], k2["128x128x195_k1"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "normal_equations", "route": "cuda",
         "source": "lrr_tpu_torch/csrc/normal_equations.cu",
         "replaces": "lrr_tpu/ops/pallas_kernels.py:212",
         "launches": launches["normal_equations"], **{k: k1m[k] for k in keys},
         "shape": k1_key(*k1_main, True)},
        {"name": "knn", "route": "cuda", "source": "lrr_tpu_torch/csrc/knn.cu",
         "replaces": "lrr_tpu/ops/pallas_kernels.py:108",
         "launches": launches["knn"], **{k: k2m[k] for k in keys},
         "shape": "128x128x195_k1"},
    ], "launch_floor_ms": floor_ms}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

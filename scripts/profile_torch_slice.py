"""Profile the PyTorch port's serving slice on one NVIDIA GPU.

Serves the committed bench pair context (lrr_tpu_torch/data/bench_pair_s64)
through `register_locations_staged` once to warm up, then once under
`torch.profiler`, and reports where the device time goes: the busy share of
the timed window, device time by kernel name, and host time by operator.

    python3 scripts/profile_torch_slice.py [--out chiprun_out/profile] [--seed N]
                                           [--runs N] [--root DIR]

Writes `<out>/summary.json`. No Chrome trace is exported: a trace of the
~45k launches would be too large to keep.  `--runs N` adds N served runs
without the profiler, each on its own draws, and reports their wall times
(`run_s`).  `--root DIR` profiles the `lrr_tpu_torch` package of another
checkout (an earlier commit unpacked with `git archive`) on this one's bench
context, so two commits can be held side by side on one card in one run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=0)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA GPU")
    from torch.profiler import ProfilerActivity, profile

    from lrr_tpu_torch.config import pipeline_config_from_dict
    from lrr_tpu_torch.ops import kernels
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.pipeline.registration import register_locations_staged
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    base = os.path.join(ROOT, "lrr_tpu_torch", "data", "bench_pair_s64")
    with open(base + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    ctx = load_pair_context(base + ".npz", torch.device("cuda"))
    dev = ctx.moving_features.xyz.device
    svm = load_default_verifier()
    q = torch.tensor(np.asarray(meta["queries"], np.float32), device=dev)

    def serve(run):
        # drawn on the CPU and moved, which every version of the package
        # (see --root) accepts
        g = torch.Generator().manual_seed(args.seed * 1000 + run)
        plan = draw_sampling_plan(g, len(q), cfg, ctx.moving_features.capacity,
                                  ctx.fixed_features.capacity)
        plan = type(plan)(**{k: None if v is None else v.to(dev) for k, v in vars(plan).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = register_locations_staged(ctx, q, cfg, svm, plan)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    serve(0)
    run_s = [serve(100 + r)[1] for r in range(args.runs)]
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = serve(1)
    launches = dict(kernels.LAUNCHES)
    k1_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "normal_equations" in e.name) / 1e3

    os.makedirs(args.out, exist_ok=True)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of device intervals (us)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_kernel = {}
    for e in events:
        k = by_kernel.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.elapsed_us()
        k[1] += 1
    top_dev = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    host_ops = sorted(
        (a for a in prof.key_averages() if a.key.startswith("aten::")),
        key=lambda a: -a.self_cpu_time_total,
    )[:20]
    summary = {
        "card": card, "root": os.path.abspath(args.root), "queries": len(q), "run_s": run_s,
        "wall_s": wall,
        "locations_per_s": len(q) / wall,
        "device_busy_s": busy / 1e6, "device_busy_share": busy / 1e6 / wall,
        "device_kernels": len(events), "launches": launches, "k1_device_ms": k1_ms,
        "k1_shapes": [{"L": k[0], "M_f": k[1], "M_b": k[2], "launches": n}
                      for k, n in sorted(getattr(kernels, "K1_SHAPES", {}).items(),
                                         key=lambda kv: -kv[1])],
        "device_time_by_kernel_ms": {n: {"ms": v[0] / 1e3, "calls": v[1]} for n, v in top_dev},
        "host_self_time_by_op_ms": {
            a.key: {"ms": a.self_cpu_time_total / 1e3, "calls": a.count} for a in host_ops
        },
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in (
        "card", "root", "run_s", "wall_s", "locations_per_s", "device_busy_s", "device_busy_share",
        "device_kernels", "launches", "k1_device_ms", "k1_shapes")}))
    for n, v in top_dev[:12]:
        print(f"# device {v[0] / 1e3:9.3f} ms {v[1]:6d}x  {n[:100]}")
    for a in host_ops[:12]:
        print(f"# host   {a.self_cpu_time_total / 1e3:9.3f} ms {a.count:6d}x  {a.key}")


if __name__ == "__main__":
    main()

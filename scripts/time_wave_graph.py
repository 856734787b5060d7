"""Time served runs of the port from captured CUDA graphs against the eager
waves, on one NVIDIA GPU, at several ICP chunk sizes.

    python3 scripts/time_wave_graph.py [--runs N] [--chunks 1,2,4,8] [--seed N]

Serves the committed bench pair context (lrr_tpu_torch/data/bench_pair_s64,
64 queries) with `register_locations_staged` through `chip_smoke.py`'s
phase-16 loop (`serve_both_paths`) once for each chunk size: the iterations
a level runs between two host reads, `icp.ITERATIONS_PER_CHECK`, which this
script sets for the sweep.  Each sweep point rebuilds the graphs, then runs
eager and graph serves alternately, each pair on one plan and compared bit
for bit.  Prints one JSON line a chunk size (phase 16's fields and the graph
runs' verified share), then the card line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--chunks", default="1,2,4,8")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_wave_graph: needs a CUDA GPU")

    import chip_smoke
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.svm import load_default_verifier

    card = chip_smoke.card_line()
    meta, cfg = chip_smoke.load_bench_meta()
    ctx = load_pair_context(chip_smoke.BENCH + ".npz")
    svm = load_default_verifier()
    q = torch.tensor(meta["queries"], dtype=torch.float32, device=ctx.device)

    def plan_for(run: int):
        return draw_sampling_plan(torch.Generator().manual_seed(args.seed * 1000 + run), len(q),
                                  cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity,
                                  ctx.device)

    for chunk in [int(c) for c in args.chunks.split(",")]:
        icp.ITERATIONS_PER_CHECK = chunk
        rec, out, _ = chip_smoke.serve_both_paths(ctx, q, cfg, svm, plan_for, runs=args.runs)
        print(json.dumps({"card": card, "iterations_per_check": chunk, **rec,
                          "verified_frac": float((out.selected >= 0).float().mean())}),
              flush=True)
    print(card)


if __name__ == "__main__":
    main()

"""Time the PyTorch port's CUDA kernels alone, on one NVIDIA GPU.

    python3 scripts/time_torch_kernels.py [--root DIR] [--seed N]

`--root` names the checkout whose `lrr_tpu_torch` package is timed (default:
this one), so two commits can be timed by the same method on the same card in
one run: unpack the other commit with `git archive` into a git-ignored
directory and pass that directory.  The method is `chip_smoke.Timer`'s of
this checkout: CUDA events around one call queued behind a spinning kernel,
median of 20, with the inputs flushed from L2 (`cold_us`) or not (`warm_us`).

K1 is timed through whichever entry point the checkout has: the symmetric
`normal_equations_sym` (both directions, un-normalised, L lanes) or the
earlier single-direction `normal_equations` (the two directions as 2L lanes
of normalised points); both read the same number of matches.  The exact
Voronoi map at copd512's shape (320 x 352 x 352 at 1 mm, 65,536 features in
an ellipsoid) is timed through K4 (`voronoi_nearest`, with its bound from the
pairs it evaluated) where the checkout has it, and through the plain blocked
build always (5 timings: it takes about a second).  The ICP's match sampler
is timed at copd512's wave shapes (512 lanes at 1,024 / 2,048 / 4,096 / 8,000
matches through copd512's map, `chip_smoke.k5_inputs`) through the
checkout's `_sample_matches_packed` (one direction, as the ICP calls it),
and where the checkout has K5 also through `kernels.sample_matches` and its
plain version `icp.sample_matches_plain`, with K5's bound over the distinct
map sectors and target rows the windows read.  A checkout whose sampler
still takes a baked [V, 8] NN-row grid is timed through the grid (`grid`,
the path its program took) and through the bare map (`map`).  The ICP's
robust weighting is timed at `chip_smoke.K6_SHAPES` (16 / 64 / 512 lanes, each
capacity, the sampler's rows and the statistics sample's) on
`chip_smoke.k6_inputs`: the checkout's `_weighted_matches_packed` (RMS scale,
as an iteration calls it) and its pair of weighted errors, eagerly and
replayed from a CUDA graph (`graph_us`, the way a served wave runs them), and
where the checkout has K6 also `kernels.robust_weights` /
`kernels.weighted_error` alone and the plain versions, with K6's bounds.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # the timing method and the input makers

    sys.path.insert(0, os.path.abspath(args.root))
    from lrr_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    rng = np.random.default_rng(args.seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    def both(fn):
        return {"cold_us": 1e3 * timer.ms(fn), "warm_us": 1e3 * timer.ms(fn, cold=False)}

    out = {"card": card, "root": os.path.abspath(args.root), "k1": {}, "k2": {}, "k4": {},
           "sampler": {}, "k6": {}}
    for L, M in [(64, 1024), (64, 2048), (64, 4096)]:
        fwd, bwd = cs.k1_direction(rng, L, M, dev), cs.k1_direction(rng, L, M, dev)
        frame = cs.k1_frame(rng, L, dev)
        if hasattr(kernels, "normal_equations_sym"):
            fwd_r, bwd_r = cs.as_row_views(fwd), cs.as_row_views(bwd)
            out["k1"][f"{L}x{M}x{M}"] = {
                "entry": "normal_equations_sym",
                "planar": both(lambda: kernels.normal_equations_sym(fwd, bwd, *frame)),
                "rows": both(lambda: kernels.normal_equations_sym(fwd_r, bwd_r, *frame)),
            }
        else:
            cat = [torch.cat([a, b]).contiguous() for a, b in zip(fwd, bwd)]
            center = torch.cat([frame[4], frame[4]])
            c1 = (cat[3] != 2).float()
            c2 = (cat[3] == 2).float() - (cat[3] == 3).float()
            out["k1"][f"{L}x{M}x{M}"] = {
                "entry": "normal_equations (2L lanes)",
                "planar": both(lambda: kernels.normal_equations(
                    center, cat[0], cat[1], cat[2], c1, c2, cat[4])),
            }
    for Q, N, k in [(128, 128, 1), (200, 700, 20), (4096, 4096, 1), (4096, 4096, 20)]:
        q = torch.tensor(rng.standard_normal((Q, 195)), dtype=torch.float32, device=dev)
        p = torch.tensor(rng.standard_normal((N, 195)), dtype=torch.float32, device=dev)
        mask = torch.tensor(rng.uniform(size=N) > 0.15, device=dev)
        out["k2"][f"{Q}x{N}x195_k{k}"] = both(lambda: kernels.knn(q, p, mask, k))
    from lrr_tpu_torch.ops import voronoi

    vor_args = (*cs.k4_inputs(rng, cs.COPD512_MAP, 65536, dev), cs.COPD512_MAP)
    out["k4"]["plain_blocked_ms"] = timer.ms(lambda: voronoi.voronoi_map_exact_blocked(*vor_args),
                                             reps=5)
    if hasattr(kernels, "voronoi_nearest"):
        from lrr_tpu_torch.utils import sol

        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        kernels.voronoi_nearest(*vor_args, stats=stats)
        pairs = int(stats[0])
        bound_ms, by = sol.voronoi_bound_ms(math.prod(cs.COPD512_MAP), 65536, pairs)
        out["k4"].update(both(lambda: kernels.voronoi_nearest(*vor_args)), pairs=pairs,
                         bound_us=1e3 * bound_ms, bound_by=by)
    del vor_args
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.utils import sol

    inputs = cs.k5_inputs(rng, 512, 65536, cs.COPD512_MAP, dev)
    src, vor, trans, number, offset, dst_rows = inputs
    modes = {"map": (src, vor)}
    if "grid" in inspect.signature(icp._sample_matches_packed).parameters:
        flat = vor.index_vol.reshape(-1).long()
        grid = torch.where((flat >= 0)[:, None], dst_rows[flat.clamp(min=0)],
                           torch.zeros((1, 8), device=dev))
        del flat
        modes = {"grid": (src, grid, vor), "map": (src, None, vor)}
    gather = sol.measured_gather_roofline(dev)["gather_gb_s_dense_big"]
    out["sampler"]["gather_gb_s"] = gather
    for cap in cs.K5_CAPS:
        rec = {}
        for mode, head in modes.items():
            args = (*head, trans, number, cap, offset)
            r = {"sampler": both(lambda: icp._sample_matches_packed(*args, dst_rows=dst_rows))}
            if hasattr(kernels, "sample_matches"):
                r["k5"] = both(lambda: kernels.sample_matches(*args, dst_rows=dst_rows, p0=0,
                                                              m=cap))
                r["plain_us"] = 1e3 * timer.ms(
                    lambda: icp.sample_matches_plain(*args, dst_rows=dst_rows, p0=0, m=cap),
                    reps=5)
            rec[mode] = r
        reads = cs.k5_target_reads(inputs, cap)
        rec["target_reads"] = reads
        rec["bound_us"] = 1e3 * sol.sample_matches_bound_ms(512, cap, 65536, reads)[0]
        rec["random_rows_us"] = 1e3 * sol.sample_matches_bound_ms(512, cap, 65536, reads,
                                                                  gather)[0]
        out["sampler"][f"512x{cap}"] = rec
    del inputs, src, vor, trans, number, offset, dst_rows, modes
    out["k6"] = time_k6(cs, kernels, timer, rng, dev, both)
    print(json.dumps(out), flush=True)


def graphed(fn):
    """`fn` captured once into a CUDA graph (after two warm-up calls on a
    side stream): the replay, as a served wave runs its steps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def time_k6(cs, kernels, timer, rng, dev, both) -> dict:
    """The ICP's robust weighting and weighted errors at `cs.K6_SHAPES`."""
    import dataclasses

    from lrr_tpu_torch.config import EstimationConfig
    from lrr_tpu_torch.estimation import icp

    cfg = EstimationConfig()
    has_k6 = hasattr(kernels, "robust_weights")
    out = {}
    for L, m, stride in cs.K6_SHAPES:
        fwd, bwd, trans, inv, falloff = cs.k6_inputs(rng, L, m, m, stride, dev)
        fwd = dataclasses.replace(fwd, weight=fwd.weight.contiguous())
        bwd = dataclasses.replace(bwd, weight=bwd.weight.contiguous())

        def weights():
            return icp._weighted_matches_packed(trans, fwd, bwd, False, cfg)

        def errors():
            if has_k6:
                return kernels.weighted_error(fwd, bwd, trans, inv)
            return icp._weighted_error_packed(trans, fwd), icp._weighted_error_packed(inv, bwd)

        rec = {"path_weights": {**both(weights), "graph_us": 1e3 * timer.ms(graphed(weights))},
               "path_errors": {**both(errors), "graph_us": 1e3 * timer.ms(graphed(errors))}}
        if has_k6:
            from lrr_tpu_torch.utils import sol

            rec["k6_weights"] = both(lambda: kernels.robust_weights(fwd, bwd, trans, inv,
                                                                    falloff))
            rec["plain_weights"] = {"eager_us": 1e3 * timer.ms(
                lambda: icp.robust_weights_plain(fwd, bwd, trans, inv, falloff), reps=5),
                "graph_us": 1e3 * timer.ms(graphed(
                    lambda: icp.robust_weights_plain(fwd, bwd, trans, inv, falloff)))}
            rec["bound_us"] = 1e3 * sol.robust_bound_ms(L, m, m, stride)[0]
            rec["error_bound_us"] = 1e3 * sol.weighted_error_bound_ms(L, m, m, stride)[0]
            rec["share_of_bound"] = rec["bound_us"] / rec["k6_weights"]["cold_us"]
        out[f"{L}x{m}_s{stride}"] = rec
        del fwd, bwd
    return out


if __name__ == "__main__":
    main()

"""Where stage 1 of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_stage1.py [--shape 400,350,350] [--out DIR]
                                            [--stages detect,descriptors,voronoi,watershed]

Builds the dense phantom pair of the reference-constants workload (seed 11,
6 degrees, noise 0.5; `FeatureConfig(max_features=65536)`, 4,096 keypoints,
2,048 descriptor neighbours), then:

  1. runs `detect_features` on the fixed volume with the functions it calls
     wrapped so that each call ends in a synchronise and is timed (the sum
     per function, over both pyramid levels), and counts what the
     sparsification saw: points, conflict edges and fixed-point rounds;
  2. times `compute_descriptors` and, per chunk of 128 keypoints, its
     neighbour search;
  3. builds the fixed Voronoi map with `voronoi_map_exact_blocked` at block
     sizes 32 and 16, in turns (32, 16, 16, 32), checks the maps are equal
     bit for bit, and reports the candidate capacities the blocks fell into;
  4. runs `watershed_segmentation` on the fixed volume with its stages
     wrapped like 1. (diffusion, gradient, pre-flood, descent pointers, the
     two `p <- p[p]` loops with their rounds, the plateau sweeps), times one
     `p[p]` round alone between CUDA events, on the descent pointers (the
     first round) and on the final labels (the last), and reports the peak
     memory of the segmentation alone.

Prints one JSON object and writes it to DIR/stage1_profile.json (default
chiprun_out/profile).  Needs a CUDA GPU.
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


class Clock:
    """Wraps functions of a module so every call is synchronised and timed."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._undo = []

    def wrap(self, module, name: str):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.calls[name] = self.calls.get(name, 0) + 1
            return out

        setattr(module, name, call)
        self._undo.append((module, name, fn))

    def restore(self):
        for module, name, fn in self._undo:
            setattr(module, name, fn)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="400,350,350")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile"))
    ap.add_argument("--stages", default="detect,descriptors,voronoi,watershed")
    args = ap.parse_args()
    stages = set(args.stages.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_stage1: no CUDA device")

    from lrr_tpu_torch.config import FeatureConfig
    from lrr_tpu_torch.features import extract
    from lrr_tpu_torch.ops import descriptors, filters, sparsify, voronoi, watershed
    from lrr_tpu_torch.utils.synthetic import make_pair

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    shape = tuple(int(v) for v in args.shape.split(","))
    fcfg = FeatureConfig(max_features=65536)
    (fixed, _, _), phantom_s = timed(lambda: make_pair(
        shape, rotation_deg=6.0, translation=(3.0, -2.0, 1.5), seed=11, noise=0.5, dense=True))
    extract.detect_features(fixed, fcfg)  # warm-up: allocator and kernel loading

    # 1. detect_features, function by function
    clock = Clock()
    for module, names in (
        (filters, ["gaussian_gradient", "downsample2"]),
        (extract, ["_score_and_outer", "contrast_keep_mask", "_slab_candidates", "_nms_classify",
                   "_subvoxel_fit", "_refine_directions", "sparsify_mask", "_compact_top"]),
    ):
        for name in names:
            clock.wrap(module, name)
    seen = {}
    real_edges = sparsify._conflict_edges

    def spy_edges(xs, min_distance):
        (ea, eb), s = timed(lambda: real_edges(xs, min_distance))
        seen.update(points=int(xs.shape[0]), edges=int(ea.shape[0]), edges_s=s)
        return ea, eb

    rounds = {"n": 0}
    real_equal = torch.equal

    def spy_equal(a, b):  # sparsify's fixed point calls `torch.equal` once a round, and
        # nothing else in detect_features calls it
        rounds["n"] += 1
        return real_equal(a, b)

    sparsify._conflict_edges = spy_edges
    sparsify.torch.equal = spy_equal
    try:
        fs, detect_s = timed(lambda: extract.detect_features(fixed, fcfg))
    finally:
        clock.restore()
        sparsify._conflict_edges = real_edges
        sparsify.torch.equal = real_equal
    detect = {"total_s": detect_s, "by_function_s": clock.seconds, "calls": clock.calls,
              "features": int(fs.count()),
              "sparsify": {**seen, "rounds": rounds["n"]}}

    rec = {"card": card, "torch": torch.__version__, "volume": list(shape), "phantom_s": phantom_s,
           "detect_features": detect}

    if "descriptors" in stages:
        rec["compute_descriptors"] = profile_descriptors(extract, descriptors, fs)
    if "voronoi" in stages:
        rec["voronoi_blocked"] = profile_voronoi(voronoi, fs)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del fs
    if "watershed" in stages:
        rec["watershed"] = profile_watershed(watershed, fixed.data)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "stage1_profile.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


def profile_descriptors(extract, descriptors, fs) -> dict:
    from lrr_tpu_torch.config import DescriptorConfig, KeypointConfig

    kp = extract.extract_keypoints(fs, KeypointConfig(max_keypoints=4096))
    dcfg = DescriptorConfig(min_neighbors=100, max_neighbors=2048)
    descriptors.compute_descriptors(kp, fs, dcfg)  # warm-up
    clock = Clock()
    clock.wrap(descriptors, "_nearest_features")
    clock.wrap(descriptors, "_descriptors_chunk")
    try:
        ds, desc_s = timed(lambda: descriptors.compute_descriptors(kp, fs, dcfg))
    finally:
        clock.restore()
    return {"total_s": desc_s, "by_function_s": clock.seconds, "calls": clock.calls,
            "keypoints": int(kp.count()), "valid": int(ds.keypoints.count())}


def profile_voronoi(voronoi, fs) -> dict:
    """The blocked exact Voronoi build at two block sizes."""
    vol0, origin, spacing = voronoi.build_feature_voronoi(fs.xyz, fs.mask)  # and a warm-up
    shape_zyx = tuple(vol0.shape)
    del vol0
    vor = {"map_shape": list(shape_zyx), "runs": []}
    maps = {}
    for block in (32, 16, 16, 32):
        vol, s = timed(lambda: voronoi.voronoi_map_exact_blocked(
            fs.xyz, fs.mask, origin, spacing, shape_zyx, block=block))
        vor["runs"].append({"block": block, "seconds": s})
        if block in maps and not torch.equal(maps[block], vol):
            raise AssertionError(f"block {block}: two builds differ")
        maps[block] = vol
    if not torch.equal(maps[32], maps[16]):
        raise AssertionError("block 32 and block 16 maps differ")
    vor["maps_bit_equal"] = True
    for block in (32, 16):
        counts = voronoi._block_candidate_counts(
            fs.xyz, fs.mask, origin, spacing, shape_zyx, block).cpu().numpy()
        caps = 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
        vor[f"block{block}"] = {
            "blocks": int(counts.size), "candidates_median": float(np.median(counts)),
            "candidates_max": int(counts.max()),
            "blocks_by_capacity": {int(c): int((caps == c).sum()) for c in np.unique(caps)},
            "distance_evaluations": float((caps.astype(np.float64) * block**3).sum()),
        }
    return vor


def event_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of `fn` between two CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profile_watershed(watershed, vol: torch.Tensor) -> dict:
    watershed.watershed_segmentation(vol)  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clock = Clock()
    for name in ("anisotropic_diffusion", "gradient_magnitude", "_preflood", "_descent_pointers",
                 "_plateau_sweeps"):
        clock.wrap(watershed, name)
    jumps = []
    real_jump = watershed._pointer_jump

    def spy_jump(p, max_rounds):
        (out, rounds), s = timed(lambda: real_jump(p, max_rounds))
        jumps.append({"rounds": rounds, "seconds": s})
        return out, rounds

    watershed._pointer_jump = spy_jump
    try:
        labels, total_s = timed(lambda: watershed.watershed_segmentation(vol))
    finally:
        clock.restore()
        watershed._pointer_jump = real_jump
    peak = torch.cuda.max_memory_allocated()

    # one p[p] round alone: the first (descent pointers, mostly near
    # neighbours) and the last (every voxel already at its basin's root)
    height = watershed.gradient_magnitude(watershed.anisotropic_diffusion(vol))
    first = watershed._descent_pointers(watershed._preflood(height, 0.001, 0.10)).reshape(-1)
    last = labels.reshape(-1)
    del height
    n = last.numel()
    own = torch.arange(n, dtype=last.dtype, device=last.device)
    rounds = {
        name: {"ms": ms, "gb_per_s": 3 * 4 * n / ms / 1e6}  # index read, gather, write
        for name, ms in (("first_round", event_ms(lambda: torch.index_select(first, 0, first))),
                         ("last_round", event_ms(lambda: torch.index_select(last, 0, last))))
    }
    return {
        "total_s": total_s, "by_function_s": clock.seconds, "pointer_jumps": jumps,
        "one_p_of_p_round": rounds, "voxels": n, "basins": int((last == own).sum()),
        "table_mb": 4 * n / 1e6, "peak_mem_above_held_gb": (peak - held) / 1e9,
        "held_gb": held / 1e9,
    }


if __name__ == "__main__":
    main()

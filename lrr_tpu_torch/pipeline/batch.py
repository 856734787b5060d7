"""Batch runner over volume pairs (lrr_tpu/pipeline/batch.py).

The reference is driven pair-by-pair by shell scripts over
`pairs_with_nodules.txt` (README.md:27-41, BASELINE.md config 5).  This
runner goes through the whole pipeline over a pair list with:

  * native threaded prefetch of the next pair's volumes while the current
    pair computes (lrr_tpu_torch.io.native_loader): IO/compute overlap;
  * per-stage artifact checkpointing (pipeline/artifacts.py), so reruns
    resume after the last completed pair: the reference's file-based
    restartability;
  * per-pair failure isolation: an exception marks the pair failed and the
    batch continues (the reference's candidate-fallthrough philosophy at
    pair granularity);
  * stage timing + a JSON batch report;
  * several processes: under the LRR_COORDINATOR / LRR_DISTRIBUTED
    environment (parallel.distributed) every rank runs every pair, each
    batch of queries split over the ranks, and rank 0 alone writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import traceback
from typing import List, Sequence

import torch

from lrr_tpu_torch.config import PipelineConfig
from lrr_tpu_torch.io.mhd import volume_from_arrays
from lrr_tpu_torch.io.native_loader import VolumeLoader
from lrr_tpu_torch.parallel.distributed import (
    all_reduce_min, global_mesh, maybe_initialize_distributed,
)
from lrr_tpu_torch.pipeline.artifacts import prepare_pair_cached
from lrr_tpu_torch.pipeline.registration import register_locations_staged, result_at
from lrr_tpu_torch.pipeline.results import write_results
from lrr_tpu_torch.sampling import draw_sampling_plan
from lrr_tpu_torch.types import resolve_device
from lrr_tpu_torch.utils.timers import StageTimers


@dataclasses.dataclass
class PairJob:
    name: str
    moving_path: str
    fixed_path: str
    queries: List[List[float]]  # [[x, y, z], ...]


def _next_pair(loader: VolumeLoader):
    """The next job's (moving, fixed) host arrays.  The loader advances by
    two paths even when the first cannot be read, so a failed job leaves the
    jobs behind it their own volumes; the first error is raised after."""
    error = None
    try:
        moving = next(loader)
    except Exception as e:
        error = e
    fixed = next(loader)
    if error is not None:
        raise error
    return moving, fixed


def run_batch(
    jobs: Sequence[PairJob],
    cfg: PipelineConfig,
    svm,
    out_dir: str,
    cache_dir: str | None = None,
    seed: int = 0,
    query_batch: int = 8,
    device=None,
    plan_for=None,
    mesh=None,
) -> dict:
    """Register every job's queries on `device` (`None`: the CUDA card) and
    write results, `.done` markers and `batch_report.json` under `out_dir`.

    `query_batch` fixes the queries of one staged run: a short last batch is
    padded by repeating its last query, so the wave schedule (which depends
    on the batch size) is the same for every batch.  The batch that starts
    at query `b0` draws its `SamplingPlan` from a CPU generator seeded with
    `seed + b0` (the same plan on every device); `plan_for(ctx, b0,
    n_queries)` supplies the plan instead where a caller wants to fix the
    draws.

    `mesh` splits each batch of queries over its ranks
    (`register_locations_staged(mesh=)`).  When the LRR_COORDINATOR /
    LRR_DISTRIBUTED environment is set (parallel.distributed), the process
    group is initialised and, if no mesh was passed, one over every rank of
    every process is used, as lrr_tpu/pipeline/batch.py:66-72 does.  Every
    rank then runs every pair in lockstep and returns the same report; rank
    0 alone writes the result files, the `.done` markers, the cached
    contexts and `batch_report.json`.  A pair is skipped, or its context
    read from the cache, only where every rank sees the file."""
    if maybe_initialize_distributed() and mesh is None:
        mesh = global_mesh()
    writer = mesh is None or mesh.rank == 0
    device = resolve_device(device, "run_batch")
    os.makedirs(out_dir, exist_ok=True)
    cache_dir = cache_dir or os.path.join(out_dir, "artifacts")
    os.makedirs(cache_dir, exist_ok=True)

    def draw_plan(ctx, b0, n_queries):
        g = torch.Generator().manual_seed(seed + b0)
        return draw_sampling_plan(
            g, n_queries, cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity,
            device,
        )

    plan_for = plan_for or draw_plan

    # interleave moving/fixed paths so the loader prefetches pairs in order
    paths = []
    for j in jobs:
        paths += [j.moving_path, j.fixed_path]
    loader = VolumeLoader(paths, n_threads=4, max_queue=4)

    timers = StageTimers()
    report = {"pairs": [], "completed": 0, "failed": 0, "skipped": 0}

    def everywhere(path: str) -> bool:
        """Whether every rank sees `path` (one all-reduce under a mesh)."""
        seen = torch.tensor([int(os.path.exists(path))])
        return bool(all_reduce_min(mesh, seen)[0])

    for j in jobs:
        entry = {"name": j.name, "status": "ok", "locations": []}
        done_marker = os.path.join(out_dir, f"{j.name}.done")
        cache_path = os.path.join(cache_dir, f"{j.name}.npz")
        try:
            with timers.time("load"):
                moving_arrays, fixed_arrays = _next_pair(loader)
            if everywhere(done_marker):
                entry["status"] = "skipped"
                report["skipped"] += 1
                report["pairs"].append(entry)
                continue
            moving = volume_from_arrays(*moving_arrays, device)
            fixed = volume_from_arrays(*fixed_arrays, device)
            with timers.time("prepare"):
                ctx = prepare_pair_cached(
                    moving, fixed, cfg, cache_path, read=everywhere(cache_path), save=writer
                )
            # register_locations_staged is the serving path (the reference's
            # refine-in-rank-order early exit as batched waves); refining
            # every candidate costs ~C x the reference's work per query
            for b0 in range(0, len(j.queries), query_batch):
                qs = j.queries[b0 : b0 + query_batch]
                n_real = len(qs)
                padded = qs + [qs[-1]] * (query_batch - n_real)
                with timers.time("register"):
                    outs = register_locations_staged(
                        ctx, torch.tensor(padded, dtype=torch.float32, device=device),
                        cfg, svm, plan_for(ctx, b0, query_batch), mesh=mesh,
                    )
                for t in range(n_real):
                    out = result_at(outs, t)
                    qi = b0 + t
                    if writer:
                        write_results(os.path.join(out_dir, f"{j.name}_results{qi:06d}"),
                                      out, qs[t])
                    entry["locations"].append(
                        {"query": qs[t], "selected": int(out.selected)}
                    )
            if writer:
                with open(done_marker, "w") as f:
                    f.write("ok\n")
            report["completed"] += 1
        except Exception as e:  # failure isolation per pair
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["traceback"] = traceback.format_exc(limit=5)
            report["failed"] += 1
        report["pairs"].append(entry)

    loader.close()
    report["timers"] = timers.as_dict()
    if writer:
        with open(os.path.join(out_dir, "batch_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def load_pair_list(path: str, queries_dir: str | None = None) -> List[PairJob]:
    """Parse a pairs file: `name moving.mhd fixed.mhd [locs.txt]` per line
    (the pairs_with_nodules.txt analog)."""
    jobs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or line.lstrip().startswith("#"):
                continue
            queries = []
            if len(parts) >= 4:
                locs = parts[3]
                if queries_dir:
                    locs = os.path.join(queries_dir, locs)
                with open(locs) as lf:
                    for ll in lf:
                        v = ll.split()
                        if len(v) >= 3:
                            queries.append([float(x) for x in v[:3]])
            jobs.append(
                PairJob(
                    name=parts[0], moving_path=parts[1], fixed_path=parts[2],
                    queries=queries,
                )
            )
    return jobs

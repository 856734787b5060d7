"""Write the stage-1 pair contexts of lrr_tpu that the PyTorch port
(lrr_tpu_torch) is held against.

The port has its own stage 1; these contexts, prepared by lrr_tpu and saved
with `pipeline.artifacts.save_pair_context`, are its references: the port
loads them (`load_pair_context`), serves them, and compares its own
features with theirs.  This script makes them with lrr_tpu on the CPU:

  tests/data/torch_pair_small.npz (+ .json)
      a 32^3 `make_pair` context at a small config, for the port's CPU
      parity tests (so they pay no stage-1 compile), with the per-feature
      watershed region ids of lrr_tpu's `segment_pair` beside it as `mr.0` /
      `fr.0` (keys that lrr_tpu's own loader passes over and the port's
      `load_pair_context` carries across);
  lrr_tpu_torch/data/bench_pair_s64.npz (+ .json)
      the `bench.py::build_workload` context (64^3 phantom pair, seed 11),
      with lrr_tpu's own acceptance on its 64 bench queries, served with the
      shipped verifier;
  lrr_tpu_torch/data/bench_pair_s64_seed12.json  (`--seed12-only`)
      lrr_tpu's acceptance on the same workload with the phantom pair of
      seed 12 (the second pair of `chip_smoke.py`'s batch phase), by the same
      method; the context it serves from is written to a temporary file and
      not kept.
  lrr_tpu_torch/data/reference_constants_lrr_tpu.json  (`--reference-constants`)
      lrr_tpu's own serving of `chip_smoke.py` phase 7's pair at the reference
      constants: `make_pair((400, 350, 350), 6.0, (3, -2, 1.5), seed=11,
      noise=0.5, dense=True)`, `prepare_pair` and `segment_pair` under
      `scripts/train_default_verifier.py::reference_cfg` (the gate at 64),
      `register_locations_staged` with the shipped verifier on phase 7's 16
      queries (`default_rng(1)`), and per query the selection, its rank
      position, and the best refined candidate's P(aligned), 8 measurements
      and ground-truth error; about 20-40 GB and half an hour on the CPU.

Each .json holds the pipeline config, the true transform and the queries;
the bench one also records lrr_tpu's `verified_frac`, `rank0_frac` and
`median_gt_error_mm` (as `bench.py::acceptance_stats` computes them).

Run from the repo root:
  JAX_PLATFORMS=cpu python scripts/make_torch_fixtures.py \
      [--small-only | --seed12-only | --reference-constants]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _affine_dict(tr) -> dict:
    return {
        "A": np.asarray(tr.A, np.float32).tolist(),
        "t": np.asarray(tr.t, np.float32).tolist(),
        "center": np.asarray(tr.center, np.float32).tolist(),
    }


def small_workload():
    from lrr_tpu.config import (
        DescriptorConfig, EstimationConfig, FeatureConfig, IndexingConfig,
        KeypointConfig, PipelineConfig,
    )

    cfg = PipelineConfig(
        features=FeatureConfig(max_features=1024, contrast_radius_mm=100.0),
        keypoints=KeypointConfig(max_keypoints=32),
        descriptors=DescriptorConfig(min_neighbors=8, max_neighbors=128),
        indexing=IndexingConfig(num_candidates=4, max_query_keypoints=8),
        estimation=EstimationConfig(
            initial_matches=128, max_matches=512, max_iterations=12,
            min_region_features=32,
        ),
    )
    pair = dict(shape_zyx=(32, 32, 32), rotation_deg=4.0,
                translation=(2.0, -1.0, 0.5), seed=3)
    queries = dict(seed=1, lo=10.0, hi=22.0, n=4)
    return cfg, pair, queries


def bench_workload():
    """Mirrors bench.py::build_workload (config, pair and queries)."""
    from lrr_tpu.config import (
        DescriptorConfig, EstimationConfig, FeatureConfig, IndexingConfig,
        KeypointConfig, PipelineConfig,
    )

    size = 64
    cfg = PipelineConfig(
        features=FeatureConfig(max_features=8192, contrast_radius_mm=100.0),
        keypoints=KeypointConfig(max_keypoints=128),
        descriptors=DescriptorConfig(min_neighbors=30, max_neighbors=512),
        indexing=IndexingConfig(num_candidates=10, max_query_keypoints=32),
        estimation=EstimationConfig(
            max_matches=4096, max_iterations=50, min_region_features=100
        ),
    )
    pair = dict(shape_zyx=(size, size, size), rotation_deg=6.0,
                translation=(3.0, -2.0, 1.5), seed=11)
    queries = dict(seed=1, lo=0.3 * size, hi=0.7 * size, n=64)
    return cfg, pair, queries


def write(path_npz: str, cfg, pair: dict, qspec: dict, run_reference: bool,
          with_regions: bool = False, path_json: str | None = None):
    import jax
    import jax.numpy as jnp

    from lrr_tpu.pipeline import prepare_pair
    from lrr_tpu.pipeline.artifacts import save_pair_context
    from lrr_tpu.utils.synthetic import make_pair

    fixed, moving, true = make_pair(
        pair["shape_zyx"], rotation_deg=pair["rotation_deg"],
        translation=pair["translation"], seed=pair["seed"],
    )
    t0 = time.time()
    ctx = prepare_pair(moving, fixed, cfg)
    jax.block_until_ready(ctx.moving_features.xyz)
    print(f"# {path_npz}: prepare {time.time() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(path_npz), exist_ok=True)
    save_pair_context(path_npz, ctx)
    if with_regions:
        from lrr_tpu.pipeline.registration import segment_pair

        seg = segment_pair(moving, fixed, ctx)
        with np.load(path_npz) as z:
            flat = {k: z[k] for k in z.files}
        flat["mr.0"] = np.asarray(seg.moving_region_labels, np.int32)
        flat["fr.0"] = np.asarray(seg.fixed_region_labels, np.int32)
        np.savez_compressed(path_npz, **flat)

    queries = np.random.default_rng(qspec["seed"]).uniform(
        qspec["lo"], qspec["hi"], (qspec["n"], 3)
    ).astype(np.float32)
    meta = {
        "config": dataclasses.asdict(cfg),
        "pair": {k: list(v) if isinstance(v, tuple) else v
                 for k, v in pair.items()},
        "true": _affine_dict(true),
        "query_spec": qspec,
        "queries": queries.tolist(),
        "counts": {
            "moving_features": int(ctx.moving_features.mask.sum()),
            "fixed_features": int(ctx.fixed_features.mask.sum()),
            "moving_keypoints": int(ctx.moving_descriptors.keypoints.mask.sum()),
            "fixed_keypoints": int(ctx.fixed_descriptors.keypoints.mask.sum()),
            "moving_vor_shape": list(ctx.moving_vor.index_vol.shape),
            "fixed_vor_shape": list(ctx.fixed_vor.index_vol.shape),
        },
    }
    if run_reference:
        from bench import acceptance_stats
        from lrr_tpu.pipeline.artifacts import load_pair_context
        from lrr_tpu.pipeline.registration import register_locations_staged
        from lrr_tpu.verify import load_default_verifier

        # serve from the saved artifact, as the port does
        ctx = load_pair_context(path_npz)
        from lrr_tpu.matching.indexing import descriptor_nn_table

        ctx = ctx.replace(
            nn_table=descriptor_nn_table(ctx.fixed_descriptors,
                                         ctx.moving_descriptors)
        )
        svm = load_default_verifier()
        # bench.py's timed runs pass keys[0] of split(key(r + 1), Q)
        key = jax.random.split(jax.random.key(1), qspec["n"])[0]
        t0 = time.time()
        out = register_locations_staged(ctx, jnp.asarray(queries), cfg, svm, key)
        jax.block_until_ready(out.selected)
        acc = acceptance_stats(out, jnp.asarray(queries), true)
        meta["lrr_tpu_reference"] = dict(
            acc, platform="cpu", key="split(key(1), Q)[0]",
            seconds=round(time.time() - t0, 1),
            verifier="lrr_tpu/data/verifier_default.model",
        )
        print(f"# reference acceptance {acc}", flush=True)
    path_json = path_json or os.path.splitext(path_npz)[0] + ".json"
    with open(path_json, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"# wrote {path_json} and {path_npz} ({os.path.getsize(path_npz)} bytes)", flush=True)


def _gt_errors(trans, query: np.ndarray, q: int, true) -> np.ndarray:
    """[C] error in mm of each of a query's transforms against the true one:
    the median over `bench.py::acceptance_stats`' 20 probes around it."""
    import jax
    import jax.numpy as jnp

    probe = query[None, :] + np.random.default_rng(q).uniform(-15, 15, (20, 3)).astype(np.float32)
    src = true.inverse().apply(jnp.asarray(probe))
    err = jax.vmap(lambda tr: jnp.linalg.norm(tr.apply(src) - true.apply(src), axis=-1))(trans)
    return np.median(np.asarray(err), axis=-1)


def reference_constants(path_json: str):
    """lrr_tpu serving `chip_smoke.py` phase 7's pair and queries at the
    reference constants (module docstring), one record per query."""
    import jax
    import jax.numpy as jnp

    from lrr_tpu.pipeline import prepare_pair
    from lrr_tpu.pipeline.registration import register_locations_staged, segment_pair
    from lrr_tpu.utils.synthetic import make_pair
    from lrr_tpu.verify import load_default_verifier
    from scripts.train_default_verifier import reference_cfg

    cfg = reference_cfg()
    pair = dict(shape_zyx=(400, 350, 350), rotation_deg=6.0, translation=(3.0, -2.0, 1.5),
                seed=11, noise=0.5, dense=True)
    fixed, moving, true = make_pair(pair["shape_zyx"], rotation_deg=pair["rotation_deg"],
                                    translation=pair["translation"], seed=pair["seed"],
                                    noise=pair["noise"], dense=pair["dense"])
    seconds = {}
    t0 = time.time()
    ctx = prepare_pair(moving, fixed, cfg)
    jax.block_until_ready(ctx.moving_features.xyz)
    seconds["prepare_pair"] = round(time.time() - t0, 1)
    print(f"# prepare_pair {seconds['prepare_pair']} s", flush=True)
    t0 = time.time()
    ctx = segment_pair(moving, fixed, ctx)
    jax.block_until_ready(ctx.moving_region_labels)
    seconds["segment_pair"] = round(time.time() - t0, 1)
    print(f"# segment_pair {seconds['segment_pair']} s", flush=True)
    D, H, W = pair["shape_zyx"]
    ext = [float(W), float(H), float(D)]
    queries = np.random.default_rng(1).uniform(
        [0.3 * e for e in ext], [0.7 * e for e in ext], (16, 3)).astype(np.float32)
    t0 = time.time()
    out = register_locations_staged(ctx, jnp.asarray(queries), cfg, load_default_verifier(),
                                    jax.random.key(1))
    jax.block_until_ready(out.selected)
    seconds["register_locations_staged"] = round(time.time() - t0, 1)
    rows = []
    for q in range(len(queries)):
        o = jax.tree.map(lambda a: a[q], out)
        sel, rank = int(o.selected), np.asarray(o.rank)
        err = _gt_errors(o.trans, queries[q], q, true)
        err = np.where(np.asarray(o.refined), err, np.inf)
        best = int(err.argmin())
        rows.append({
            "query": q, "selected": sel,
            "rank_position": int(np.nonzero(rank == sel)[0][0]) if sel >= 0 else None,
            "selected_gt_error_mm": float(err[sel]) if sel >= 0 else None,
            "best_refined_candidate": best,
            "best_refined_gt_error_mm": float(err[best]),
            "best_refined_probability": float(o.probability[best]),
            "best_refined_verified": bool(o.verified[best]),
            "best_refined_measurements": np.asarray(o.measurements[best], np.float64).tolist(),
        })
    sel_err = [r["selected_gt_error_mm"] for r in rows if r["selected"] >= 0]
    meta = {
        "platform": "cpu", "package": "lrr_tpu", "pair": pair, "true": _affine_dict(true),
        "config": dataclasses.asdict(cfg), "queries": queries.tolist(), "key": "key(1)",
        "verifier": "lrr_tpu/data/verifier_default.model", "seconds": seconds,
        "features": [int(ctx.moving_features.mask.sum()), int(ctx.fixed_features.mask.sum())],
        "verified": sum(r["selected"] >= 0 for r in rows),
        "median_selected_gt_error_mm": float(np.median(sel_err)) if sel_err else None,
        "per_query": rows,
    }
    with open(path_json, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"# wrote {path_json}: {meta['verified']} of 16 verified", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small-only", action="store_true")
    ap.add_argument("--seed12-only", action="store_true")
    ap.add_argument("--reference-constants", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.reference_constants:
        return reference_constants(
            os.path.join(ROOT, "lrr_tpu_torch", "data", "reference_constants_lrr_tpu.json"))
    if args.seed12_only:
        import tempfile

        cfg, pair, q = bench_workload()
        with tempfile.TemporaryDirectory() as tmp:
            write(os.path.join(tmp, "bench_pair_s64_seed12.npz"), cfg, dict(pair, seed=12), q,
                  run_reference=True,
                  path_json=os.path.join(ROOT, "lrr_tpu_torch", "data",
                                         "bench_pair_s64_seed12.json"))
        return
    cfg, pair, q = small_workload()
    write(os.path.join(ROOT, "tests", "data", "torch_pair_small.npz"),
          cfg, pair, q, run_reference=False, with_regions=True)
    if not args.small_only:
        cfg, pair, q = bench_workload()
        write(os.path.join(ROOT, "lrr_tpu_torch", "data", "bench_pair_s64.npz"),
              cfg, pair, q, run_reference=True)


if __name__ == "__main__":
    main()

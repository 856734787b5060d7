"""Train the shipped verifier from phantoms (scripts/train_default_verifier.py).

    python -m lrr_tpu_torch.verify.train_default [--out DIR] [--device DEV]

The reference trains its SVM verifier once, offline, on measurement vectors
from registrations labeled by ground truth, and ships the model it gets
(rrl/itkLocationRegistration.cxx:2088-2109, libsvm/svm-train.cpp).  This is
that offline step for the port, the counterpart of lrr_tpu's training
script: five synthetic phantom pairs, four at bench scale and one dense
CT-scale pair at the reference constants with watershed regions, each
refined with every candidate (`collect_labeled_measurements`), every refined
candidate labeled by its ground-truth mapping error, the rows pooled and one
RBF C-SVC fitted by SMO with Platt probabilities (C = 10, gamma = 0.125).

It writes `verifier_default.model` (libsvm text), `verifier_default.model.json`
(rows, aligned rows, seconds and training acc / tpr / tnr at P > 0.5 a pair)
and the collected `verifier_corpus.npz` into `--out` (default
`build/verifier/` of the checkout), never into the package's `data/`: the
shipped model there stays the one lrr_tpu trained.  `--device` defaults to
the CUDA card and raises without one.  The switches of lrr_tpu's script act
as there:

    TRAIN_REUSE_CORPUS=1   refit the committed corpus (the package's copy,
                           `data/verifier_corpus.npz`) without collecting
    TRAIN_SKIP_REFSCALE=1  collect the four bench-scale pairs only
    TRAIN_SVC_C=<float>    the C-SVC's C (default 10.0)

The corpus file has lrr_tpu's layout (`names`, `X_<name>`, `y_<name>`), so
either package refits the other's corpus.  The pairs' sampling plans are
drawn from each pair's seed; lrr_tpu draws from `jax.random.key(seed)`, so
the two packages collect from the same phantoms but not the same match
windows unless a caller passes lrr_tpu's draws as `plan`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from lrr_tpu_torch.config import (
    DescriptorConfig, EstimationConfig, FeatureConfig, IndexingConfig, KeypointConfig,
    PipelineConfig,
)
from lrr_tpu_torch.types import no_tf32, resolve_device
from lrr_tpu_torch.verify.svm import DEFAULT_MODEL_PATH

# the committed corpus lrr_tpu collected: the package's byte copy
CORPUS_PATH = os.path.join(os.path.dirname(DEFAULT_MODEL_PATH), "verifier_corpus.npz")
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "verifier",
)

# (edge voxels, phantom seed, rotation deg, translation mm) of the bench-scale
# pairs; their seeds differ from the benchmark's 11 so that the shipped model
# is evaluated out of pair
BENCH_SPECS = (
    (64, 23, 6.0, (3.0, -2.0, 1.5)),
    (64, 37, 10.0, (-4.0, 2.0, -2.0)),
    (64, 51, 3.0, (1.0, 4.0, -3.0)),
    (96, 67, 8.0, (-2.0, -3.0, 2.0)),
)
# ((z, y, x) voxels, seed, rotation, translation) of the CT-scale pairs, made
# dense with noise (`REF_PAIR`)
REF_SPECS = (((400, 350, 350), 13, 6.0, (3.0, -2.0, 1.5)),)
REF_PAIR = {"noise": 0.5, "dense": True}


def bench_cfg() -> PipelineConfig:
    """The bench-scale workload's capacities (bench.py's)."""
    return PipelineConfig(
        features=FeatureConfig(max_features=8192, contrast_radius_mm=100.0),
        keypoints=KeypointConfig(max_keypoints=128),
        descriptors=DescriptorConfig(min_neighbors=30, max_neighbors=512),
        indexing=IndexingConfig(num_candidates=10, max_query_keypoints=32),
        estimation=EstimationConfig(
            max_matches=4096, max_iterations=50, min_region_features=100
        ),
    )


def reference_cfg() -> PipelineConfig:
    """The reference constants, with the gate that serves the dense phantom.

    The reference gates candidates at >= 1000 in-box features
    (itkLocationRegistration.cxx:1632), a constant tuned to chest CT's local
    density; a 50 mm box of the dense phantom holds 100-200 features, about
    a tenth of that, so the gate is scaled by the same ratio to 64.  The
    config default stays the reference's 1000."""
    return PipelineConfig(
        features=FeatureConfig(max_features=65536),
        keypoints=KeypointConfig(max_keypoints=4096),
        descriptors=DescriptorConfig(min_neighbors=100, max_neighbors=2048),
        indexing=IndexingConfig(num_candidates=20, max_query_keypoints=64),
        estimation=EstimationConfig(
            max_matches=8000, max_iterations=70, min_region_features=64
        ),
    )


def bench_queries(size: int, seed: int, n_queries: int = 64) -> np.ndarray:
    """[n, 3] queries uniform in 0.3-0.7 of a cubic pair's extent."""
    return np.random.default_rng(seed + 100).uniform(
        0.3 * size, 0.7 * size, (n_queries, 3)
    ).astype(np.float32)


def reference_queries(shape, seed: int, n_queries: int = 16) -> np.ndarray:
    """[n, 3] (x, y, z) queries uniform in 0.3-0.7 of a (z, y, x) volume."""
    ext = [float(shape[2]), float(shape[1]), float(shape[0])]
    return np.random.default_rng(seed + 100).uniform(
        [0.3 * e for e in ext], [0.7 * e for e in ext], (n_queries, 3)
    ).astype(np.float32)


def _collect(ctx, cfg, true, queries: np.ndarray, seed: int, plan):
    from lrr_tpu_torch.sampling import draw_sampling_plan
    from lrr_tpu_torch.verify.surrogate import collect_labeled_measurements

    if plan is None:
        plan = draw_sampling_plan(
            torch.Generator().manual_seed(seed), len(queries), cfg,
            ctx.moving_features.capacity, ctx.fixed_features.capacity, ctx.device,
        )
    return collect_labeled_measurements(ctx, cfg, true, queries, plan)


def collect_bench_pair(size, seed, rotation, translation, n_queries=64, *, device=None,
                       plan=None):
    """Labeled measurements (X [n, 8] float32, y [n]) of one bench-scale pair
    on `device` (`None`: the CUDA card): the port's `make_pair` and
    `prepare_pair` at `bench_cfg()`, `bench_queries`, every candidate refined.
    `plan` is the run's `SamplingPlan`; `None` draws it from `seed`."""
    from lrr_tpu_torch.pipeline.registration import prepare_pair
    from lrr_tpu_torch.utils.synthetic import make_pair

    device = resolve_device(device, "collect_bench_pair")
    cfg = bench_cfg()
    fixed, moving, true = make_pair(
        (size, size, size), rotation_deg=rotation, translation=translation, seed=seed,
        device=device,
    )
    ctx = prepare_pair(moving, fixed, cfg)
    return _collect(ctx, cfg, true, bench_queries(size, seed, n_queries), seed, plan)


def collect_reference_pair(shape, seed, rotation, translation, n_queries=16, *, device=None,
                           plan=None):
    """Labeled measurements of one CT-scale pair at `reference_cfg()`: a
    dense phantom with noise, `prepare_pair`, watershed regions by
    `segment_pair` (lrr_tpu's script builds the same context stage by stage),
    `reference_queries`, every candidate refined.  `device` and `plan` as in
    `collect_bench_pair`."""
    from lrr_tpu_torch.pipeline.registration import prepare_pair, segment_pair
    from lrr_tpu_torch.utils.synthetic import make_pair

    device = resolve_device(device, "collect_reference_pair")
    cfg = reference_cfg()
    fixed, moving, true = make_pair(
        tuple(shape), rotation_deg=rotation, translation=translation, seed=seed,
        device=device, **REF_PAIR,
    )
    ctx = segment_pair(moving, fixed, prepare_pair(moving, fixed, cfg))
    del fixed, moving
    return _collect(ctx, cfg, true, reference_queries(shape, seed, n_queries), seed, plan)


def save_corpus(path: str, corpus) -> None:
    """Write [(name, X, y)] in lrr_tpu's corpus layout."""
    blob = {"names": np.asarray([name for name, _, _ in corpus])}
    for name, X, y in corpus:
        blob[f"X_{name}"] = X
        blob[f"y_{name}"] = y
    np.savez_compressed(path, **blob)


def load_corpus(path: str = CORPUS_PATH):
    """[(name, X [n, 8] float32, y [n])] of a corpus file, in its order."""
    with np.load(path) as blob:
        return [(str(name), blob[f"X_{name}"], blob[f"y_{name}"]) for name in blob["names"]]


def _scaled(X: np.ndarray) -> torch.Tensor:
    from lrr_tpu_torch.verify.svm import scale_measurements

    return scale_measurements(torch.from_numpy(np.asarray(X, np.float32)))


def corpus_scores(model, corpus) -> dict:
    """{name: {rows, aligned, acc, tpr, tnr}} of `model` at P > 0.5 on each
    pair's rows of `corpus` (tpr / tnr None where the pair has no row of that
    class; a pair without rows is left out), on the host."""
    from lrr_tpu_torch.verify.svm import predict_probability

    model = model.to("cpu")
    scores = {}
    for name, X, y in corpus:
        if len(y) == 0:
            continue
        p = predict_probability(model, _scaled(X)).numpy()
        pos, neg = y > 0, y == 0
        scores[name] = {
            "rows": int(len(y)), "aligned": int(pos.sum()),
            "acc": float(((p > 0.5) == pos).mean()),
            "tpr": float((p[pos] > 0.5).mean()) if pos.any() else None,
            "tnr": float((p[neg] <= 0.5).mean()) if neg.any() else None,
        }
    return scores


def fit_corpus(corpus, C: float = 10.0, gamma: float = 0.125):
    """The C-SVC fitted by SMO on the pooled, scaled rows of `corpus`
    (host float64, Platt probabilities by 5-fold cross-validation), and each
    pair's training scores (`corpus_scores`): (model, {name: scores})."""
    from lrr_tpu_torch.verify.smo import train_c_svc

    X = np.concatenate([x for _, x, _ in corpus])
    y = np.concatenate([v for _, _, v in corpus])
    model = train_c_svc(_scaled(X).numpy(), y, C=C, gamma=gamma)
    return model, corpus_scores(model, corpus)


def _pair_meta(name: str, y: np.ndarray, seconds: float) -> dict:
    return {"name": name, "rows": int(len(y)), "aligned": int((y > 0).sum()),
            "seconds": round(seconds, 1)}


def main(argv=None) -> None:
    from lrr_tpu_torch.verify.svm import serialize_libsvm_model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory for the model, its .json and the corpus")
    ap.add_argument("--device", default=None,
                    help="torch device to collect on (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "train_default")
    no_tf32()
    os.makedirs(args.out, exist_ok=True)

    corpus, meta = [], {"pairs": []}
    if os.environ.get("TRAIN_REUSE_CORPUS") == "1":
        for name, X, y in load_corpus(CORPUS_PATH):
            corpus.append((name, X, y))
            meta["pairs"].append(_pair_meta(name, y, 0.0))
            print(f"{name}: {len(y)} rows (cached)", flush=True)
    else:
        jobs = [(f"bench{size}-s{seed}", collect_bench_pair, (size, seed, rot, tr))
                for size, seed, rot, tr in BENCH_SPECS]
        if os.environ.get("TRAIN_SKIP_REFSCALE") != "1":
            jobs += [(f"ref{shape[0]}-s{seed}", collect_reference_pair, (shape, seed, rot, tr))
                     for shape, seed, rot, tr in REF_SPECS]
        for name, collect, spec in jobs:
            t0 = time.time()
            X, y = collect(*spec, device=device)
            dt = time.time() - t0
            corpus.append((name, X, y))
            meta["pairs"].append(_pair_meta(name, y, dt))
            print(f"{name}: {len(y)} rows ({int((y > 0).sum())} aligned) in {dt:.0f}s",
                  flush=True)
        corpus_path = os.path.join(args.out, "verifier_corpus.npz")
        save_corpus(corpus_path, corpus)
        print(f"corpus written to {corpus_path}")

    y = np.concatenate([v for _, _, v in corpus])
    print(f"corpus: {len(y)} rows, {int((y > 0).sum())} aligned")
    t0 = time.time()
    model, stats = fit_corpus(corpus, C=float(os.environ.get("TRAIN_SVC_C", "10.0")))
    print(f"SMO fit in {time.time() - t0:.1f}s: {model.sv.shape[0]} SVs, "
          f"probA={model.prob_a:.3f} probB={model.prob_b:.3f}")
    for entry in meta["pairs"]:
        s = stats.get(entry["name"])
        if s is None:
            continue
        entry.update({k: None if s[k] is None else round(s[k], 4) for k in ("acc", "tpr", "tnr")})
        print(f"  {entry['name']}: acc={s['acc']:.3f} tpr={s['tpr']} tnr={s['tnr']}")

    path = os.path.join(args.out, os.path.basename(DEFAULT_MODEL_PATH))
    with open(path, "w") as f:
        f.write(serialize_libsvm_model(model))
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"wrote {path} ({model.sv.shape[0]} SVs)")


if __name__ == "__main__":
    main(sys.argv[1:])

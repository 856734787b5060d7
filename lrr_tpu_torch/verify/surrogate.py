"""Surrogate verifier for benches/tests, and verifier calibration
(lrr_tpu/verify/surrogate.py).

The reference ships a pre-trained SVM (`training_data_all.model`) fitted to
labeled measurements from real CT registrations
(rrl/itkLocationRegistration.cxx:2088-2109); that file is not in the repo,
so benches and tests train a stand-in on synthetic measurement
distributions.

Ranges follow what actually discriminates alignment in the 8-vector
(max/min over directions of {weighted error, max transfer-covariance trace,
sheet angle, tube angle}, estimation/measurements.py): weighted errors and
angle disagreements separate aligned from misaligned; the covariance traces
scale with ROI geometry and feature count (hundreds at CT scale, tens on
64^3 phantoms), so BOTH classes draw them from the same wide range and the
classifier learns to ignore them.  A surrogate trained with narrow trace
ranges silently rejects every candidate at a scale it wasn't tuned for.
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.verify.svm import SvmModel, fit_rbf_classifier, scale_measurements


def _scaled(X: np.ndarray) -> np.ndarray:
    return scale_measurements(torch.from_numpy(np.asarray(X, np.float32))).numpy()


def surrogate_verifier(seed: int = 0, n: int = 128, steps: int = 200, device=None) -> SvmModel:
    """The static stand-in, trained on `device` (`None`: the CUDA card)."""
    rng = np.random.default_rng(seed)

    def cls(err_lo, err_hi, ang_lo, ang_hi):
        return np.concatenate(
            [
                rng.uniform(err_lo, err_hi, (n, 1)),       # max weighted error
                rng.uniform(0.1, 900.0, (n, 1)),           # max trace (scale-dep)
                rng.uniform(ang_lo, ang_hi, (n, 2)),       # max sheet/tube angle
                rng.uniform(0.8 * err_lo, 0.9 * err_hi, (n, 1)),  # min error
                rng.uniform(0.1, 800.0, (n, 1)),           # min trace (scale-dep)
                rng.uniform(0.9 * ang_lo, 0.9 * ang_hi, (n, 2)),  # min angles
            ],
            axis=1,
        ).astype(np.float32)

    aligned = cls(0.5, 1.3, 5.0, 28.0)
    misaligned = cls(1.8, 16.0, 33.0, 62.0)
    X = np.concatenate([aligned, misaligned])
    y = np.concatenate([np.ones(n), np.zeros(n)])
    return fit_rbf_classifier(_scaled(X), y, steps=steps, device=device)


def collect_labeled_measurements(
    ctx,
    cfg,
    true_transform,
    cal_queries,
    plan,
    good_mm: float = 2.0,
    bad_mm: float = 6.0,
):
    """GT-labeled 8-d measurement vectors from one pair's workload.

    Refines every usable candidate of `cal_queries` with no early exit and
    labels each by its median ground-truth mapping error (aligned <
    good_mm, misaligned > bad_mm, ambiguous discarded).  Returns
    (X [n, 8] float32, y [n] {0, 1}): the raw corpus rows the reference's
    own `training_data_all` file was built from (libsvm svm-train inputs;
    rrl/itkLocationRegistration.cxx:2088-2109).

    The refine-all semantics run through `register_locations_staged` with
    `accept_override=2.0` (nothing verifies, so every usable candidate gets
    refined by the serving waves) and no jump to full width.  `plan` is the
    run's `SamplingPlan`; `true_transform` an `Affine3D` on the context's
    device."""
    from lrr_tpu_torch.pipeline.registration import register_locations_staged

    dev = ctx.device
    qs = torch.as_tensor(np.asarray(cal_queries, np.float32), device=dev)
    # permissive stand-in verifier: probabilities are ignored here
    stand_in = surrogate_verifier(seed=7, device=dev)
    out = register_locations_staged(
        ctx, qs, cfg, stand_in, plan,
        accept_override=2.0, max_unproductive=10**9,
    )
    errs = candidate_gt_errors(out, qs, true_transform)

    usable = (
        out.candidate_mask & out.enough_features & out.valid & out.refined
    ).cpu().numpy()
    aligned = usable & (errs < good_mm)
    misaligned = usable & (errs > bad_mm)
    meas_h = out.measurements.cpu().numpy()
    picked = list(zip(*np.nonzero(aligned | misaligned)))
    if not picked:
        return np.zeros((0, 8), np.float32), np.zeros((0,), np.float32)
    X = np.stack([meas_h[q, c] for q, c in picked]).astype(np.float32)
    y = np.asarray([1.0 if aligned[q, c] else 0.0 for q, c in picked], np.float32)
    return X, y


def candidate_gt_errors(out, queries: torch.Tensor, true_transform) -> np.ndarray:
    """[Q, C] median ground-truth mapping error (mm) of every candidate
    transform of `out` on 20 probes within 15 mm of its query (seeded; the
    mean of the two middle errors, as `jnp.median` gives it): what
    `collect_labeled_measurements` labels by."""
    from lrr_tpu_torch.ops.robust import nanmedian

    Q = queries.shape[0]
    rng = np.random.default_rng(17)
    probes = queries[:, None, :] + torch.as_tensor(
        rng.uniform(-15, 15, (Q, 20, 3)).astype(np.float32), device=queries.device
    )
    src = true_transform.inverse().apply(probes)  # [Q, 20, 3]
    want = true_transform.apply(src)
    C = out.probability.shape[1]
    d = out.trans.apply(src[:, None].expand(Q, C, 20, 3)) - want[:, None]
    return nanmedian(torch.linalg.norm(d, dim=-1)).cpu().numpy()


def calibrate_verifier(
    ctx,
    cfg,
    true_transform,
    cal_queries,
    plan,
    good_mm: float = 2.0,
    bad_mm: float = 6.0,
    steps: int = 300,
):
    """Train a verifier on GT-labeled measurements from ONE pair's workload
    (see `collect_labeled_measurements`): the documented training tool for
    adapting the verifier to a new measurement regime.  The production
    default is the SHIPPED model (`load_default_verifier`), trained offline
    on a multi-pair multi-scale corpus the way the reference ships
    `training_data_all.model`.

    Returns (model, n_aligned, n_misaligned); falls back to the static
    surrogate when either class has fewer than 8 examples."""
    X, y = collect_labeled_measurements(
        ctx, cfg, true_transform, cal_queries, plan, good_mm, bad_mm
    )
    n_pos = int((y > 0).sum())
    n_neg = int((y == 0).sum())
    if n_pos < 8 or n_neg < 8:
        return surrogate_verifier(seed=7, device=ctx.device), n_pos, n_neg
    model = fit_rbf_classifier(_scaled(X), y, steps=steps, device=ctx.device)
    return model, n_pos, n_neg

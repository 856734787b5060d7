"""The random inputs of a request, made from the run's seed.

Queries: uniform in a box given as fractions of the physical extent
(`lrr_tpu_torch/verify/train_default.py::reference_queries` and
`chip_smoke.py::reference_queries`, frozen, with spacing).

Sampling draws: every random draw of the serving path, field for field as
`lrr_tpu_torch/sampling.py::draw_sampling_plan` makes them (uniform [0, 1)
scores, raw offsets below 2^62), but drawn on the device by a
`torch.Generator` there: at 300 queries x 20 candidates x 65,536 features a
plan is ~8 GB, which the host would take seconds to draw.  The rigid
refinement's stream is not drawn: the staged entry point never reads it.
The fields are returned as a dict; the driver hands them to the program's
`SamplingPlan`.

Seeds: a run's seed is any whole number; each stream is keyed by
(seed, purpose, index) through numpy's SeedSequence, so requests never share
a draw and the warm-up's draws are disjoint from the window's.
"""

from __future__ import annotations

import numpy as np
import torch

OFFSET_RANGE = 1 << 62

# stream purposes
WINDOW, WARMUP, TRUTH, PHANTOM, CHECK = 1, 2, 3, 4, 5


def stream_seed(seed: int, purpose: int, index: int = 0) -> int:
    """A 63-bit seed of the stream (purpose, index) of run seed `seed`."""
    ss = np.random.SeedSequence([abs(int(seed)), int(int(seed) < 0), purpose, index])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, purpose, index))


def queries(r: np.random.Generator, n: int, extent_xyz, lo: float, hi: float) -> np.ndarray:
    """[n, 3] float32 (x, y, z) uniform in [lo, hi] of the extent."""
    ext = np.asarray(extent_xyz, np.float64)
    return r.uniform(lo * ext, hi * ext, (n, 3)).astype(np.float32)


def plan_fields(seed: int, n_queries: int, n_candidates: int, max_iterations: int,
                n_moving: int, n_fixed: int, device) -> dict:
    """The per-candidate draws of `n_queries` queries, on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    Q, C, T = n_queries, n_candidates, max_iterations + 1

    def u(n):
        return torch.rand((Q, C, n), generator=g, device=device)

    def off(*shape):
        return torch.randint(0, OFFSET_RANGE, (Q, C) + shape, generator=g, device=device,
                             dtype=torch.int64)

    return dict(
        rank_scores=u(n_moving), rank_offset=off(),
        icp_scores_m=u(n_moving), icp_scores_f=u(n_fixed),
        icp_offsets_f=off(T), icp_offsets_b=off(T),
        icp_stats_offset_f=off(), icp_stats_offset_b=off(),
        cov_scores_f=u(n_fixed), cov_scores_m=u(n_moving),
        cov_offset_b=off(), cov_offset_f=off(),
    )

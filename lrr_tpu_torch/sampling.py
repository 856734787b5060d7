"""The sampling plan: every random draw of the serving path, as tensors.

lrr_tpu draws from a tree of threefry keys; the port takes the same draws
from explicit tensors, one entry per (query, candidate).  The plan is drawn
from a seeded CPU `torch.Generator` and moved to the device
(`draw_sampling_plan`), so one seed gives one plan everywhere; the
parity tests build it by walking lrr_tpu's own key tree instead, so both
packages sample identical match windows.

Draws and where lrr_tpu makes them:
  rank_scores, rank_offset    PASS-1 ROI permutation and stats window
                              (registration.py:479 k0, k0b)
  icp_scores_m/f              source permutations (icp.py:114-122, keys
                              kpm/kpf of icp.py:1007)
  icp_offsets_f/b             per-iteration window offsets (icp.py:1031-1036)
  icp_stats_offset_f/b        final stats windows (icp.py:577, ks_f/ks_b :1183)
  cov_scores_f/m, cov_offset_b/f
                              backward_covariance (measurements.py:87)
  rigid_*                     the one refinement of register_location_rigid:
                              a stream of its own, one per query, beside the
                              C candidate streams (registration.py:839-840,
                              the last of C + 1 keys)

Scores are uniform [0, 1) float32.  Offsets are stored as raw non-negative
int64 and reduced modulo the lane's valid count where they are used, which
gives an integer uniform on [0, valid_count) (the bias of drawing from
[0, 2^62) is below 2^-49); an exact lrr_tpu offset is already below its
valid count and passes through unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from lrr_tpu_torch.config import PipelineConfig

_OFFSET_RANGE = 1 << 62


@dataclasses.dataclass
class ICPDraws:
    """register_candidate's draws for L lanes."""

    scores_m: torch.Tensor  # [L, Nm]
    scores_f: torch.Tensor  # [L, Nf]
    offsets_f: torch.Tensor  # [L, max_iterations + 1]
    offsets_b: torch.Tensor  # [L, max_iterations + 1]
    stats_offset_f: torch.Tensor  # [L]
    stats_offset_b: torch.Tensor  # [L]


@dataclasses.dataclass
class CovarianceDraws:
    """backward_covariance's draws for L lanes."""

    scores_f: torch.Tensor  # [L, Nf] fixed-source permutation (kpf)
    scores_m: torch.Tensor  # [L, Nm] moving-source permutation (kpm)
    offset_b: torch.Tensor  # [L] window into the fixed source (kb)
    offset_f: torch.Tensor  # [L] window into the moving source (kf)


@dataclasses.dataclass
class SamplingPlan:
    """Draws for Q queries x C candidates; the per-candidate fields have
    leading dims [Q, C] (or [L] after `select`), the `rigid_*` fields [Q]
    (None in a plan of lanes)."""

    rank_scores: torch.Tensor  # [Q, C, Nm]
    rank_offset: torch.Tensor  # [Q, C]
    icp_scores_m: torch.Tensor  # [Q, C, Nm]
    icp_scores_f: torch.Tensor  # [Q, C, Nf]
    icp_offsets_f: torch.Tensor  # [Q, C, T]
    icp_offsets_b: torch.Tensor  # [Q, C, T]
    icp_stats_offset_f: torch.Tensor  # [Q, C]
    icp_stats_offset_b: torch.Tensor  # [Q, C]
    cov_scores_f: torch.Tensor  # [Q, C, Nf]
    cov_scores_m: torch.Tensor  # [Q, C, Nm]
    cov_offset_b: torch.Tensor  # [Q, C]
    cov_offset_f: torch.Tensor  # [Q, C]
    rigid_scores_m: torch.Tensor | None = None  # [Q, Nm]
    rigid_scores_f: torch.Tensor | None = None  # [Q, Nf]
    rigid_offsets_f: torch.Tensor | None = None  # [Q, T]
    rigid_offsets_b: torch.Tensor | None = None  # [Q, T]
    rigid_stats_offset_f: torch.Tensor | None = None  # [Q]
    rigid_stats_offset_b: torch.Tensor | None = None  # [Q]

    def _per_candidate(self, fn) -> "SamplingPlan":
        """A plan of lanes: `fn` of every per-candidate field, and no rigid
        stream (that one belongs to a query, not to a lane)."""
        return SamplingPlan(
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if not f.name.startswith("rigid_")
            }
        )

    def select(self, lanes: torch.Tensor, cand: torch.Tensor) -> "SamplingPlan":
        """Per-lane plan: entry (lanes[i], cand[i]) for each lane i."""
        return self._per_candidate(lambda x: x[lanes, cand])

    def flatten(self) -> "SamplingPlan":
        """[Q, C, ...] -> [Q*C, ...] lanes, query-major."""
        return self._per_candidate(lambda x: x.flatten(0, 1))

    def take(self, rows) -> "SamplingPlan":
        """The plan of queries `rows` (a slice or an index tensor of the
        leading dim), its rigid stream included."""
        return SamplingPlan(
            **{
                f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[rows]
                for f in dataclasses.fields(self)
            }
        )

    def query(self, i: int) -> "SamplingPlan":
        """The [1, C] plan of query `i`, its rigid stream included."""
        return self.take(slice(i, i + 1))

    def icp(self) -> ICPDraws:
        return ICPDraws(
            self.icp_scores_m, self.icp_scores_f, self.icp_offsets_f,
            self.icp_offsets_b, self.icp_stats_offset_f, self.icp_stats_offset_b,
        )

    def rigid(self) -> ICPDraws:
        """The rigid refinement's draws, one lane per query."""
        if self.rigid_scores_m is None:
            raise ValueError("this plan holds no rigid stream (a plan of lanes, or one "
                             "built without it)")
        return ICPDraws(
            self.rigid_scores_m, self.rigid_scores_f, self.rigid_offsets_f,
            self.rigid_offsets_b, self.rigid_stats_offset_f, self.rigid_stats_offset_b,
        )

    def covariance(self) -> CovarianceDraws:
        return CovarianceDraws(
            self.cov_scores_f, self.cov_scores_m, self.cov_offset_b,
            self.cov_offset_f,
        )


def draw_sampling_plan(
    generator: torch.Generator,
    n_queries: int,
    cfg: PipelineConfig,
    n_moving: int,
    n_fixed: int,
    device=None,
) -> SamplingPlan:
    """Draw a plan from a CPU `generator` and move it to `device` (default:
    the CPU), so that one seed gives the same plan on every device.
    `n_moving`/`n_fixed` are the feature-set capacities of the pair
    context."""
    if generator.device.type != "cpu":
        raise ValueError("draw_sampling_plan: draw from a CPU generator (one seed, one plan "
                         f"on every device), not one on {generator.device}")
    Q, C = n_queries, cfg.indexing.num_candidates
    T = cfg.estimation.max_iterations + 1

    def u(*shape, lead=(Q, C)):
        return torch.rand(lead + shape, generator=generator).to(device)

    def off(*shape, lead=(Q, C)):
        return torch.randint(
            0, _OFFSET_RANGE, lead + shape, generator=generator, dtype=torch.int64,
        ).to(device)

    # the per-candidate streams first, in this order: the rigid stream was
    # added after them and leaves their values as they were
    return SamplingPlan(
        rank_scores=u(n_moving), rank_offset=off(),
        icp_scores_m=u(n_moving), icp_scores_f=u(n_fixed),
        icp_offsets_f=off(T), icp_offsets_b=off(T),
        icp_stats_offset_f=off(), icp_stats_offset_b=off(),
        cov_scores_f=u(n_fixed), cov_scores_m=u(n_moving),
        cov_offset_b=off(), cov_offset_f=off(),
        rigid_scores_m=u(n_moving, lead=(Q,)), rigid_scores_f=u(n_fixed, lead=(Q,)),
        rigid_offsets_f=off(T, lead=(Q,)), rigid_offsets_b=off(T, lead=(Q,)),
        rigid_stats_offset_f=off(lead=(Q,)), rigid_stats_offset_b=off(lead=(Q,)),
    )

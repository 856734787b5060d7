"""Stage 1 (`prepare_pair`, `segment_pair`) and the stage 2+3 entry points
(lrr_tpu/pipeline/registration.py).

`prepare_pair` takes the two volumes to a `PairContext`: features,
keypoints, descriptors, Voronoi maps and the descriptor-NN table, all on the
volumes' device.  `segment_pair` adds the watershed regions: with them a
candidate's feature subset is a union of whole regions grown inside the ROI
box instead of the plain box.

Per query location: candidate generation by descriptor indexing,
keypoint-frame initialisation, ROI feature selection, PASS-1 ranking by
initial angle agreement plus median residual, then waves of symmetric robust
ICP, backward covariance, decision measurements and SVM verification; the
first verified candidate in rank order wins (itkLocationRegistration.cxx:
2332-2528).  `register_locations_staged` is the serving entry point;
`register_locations` / `register_location` refine every candidate;
`register_location_rigid` refines the best-ranked one with the rigid model
and `watch_candidate` replays one refinement with a per-iteration callback.

A context can also come from an artifact that the JAX package saved
(`pipeline.artifacts.load_pair_context`).  Randomness comes from a
`SamplingPlan` (see `sampling.py`).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from lrr_tpu_torch.config import PipelineConfig
from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.estimation.icp import (
    ICPResult,
    VoronoiGrid,
    _angle_stats_packed,
    _as_packed_matches,
    _pack_features_wide,
    _residual2_packed,
    _sample_stats_packed,
    _source_permutation,
    Refinement,
    register_candidate,
)
from lrr_tpu_torch.estimation.measurements import (
    backward_covariance,
    decision_measurements,
)
from lrr_tpu_torch.features.extract import detect_features, extract_keypoints
from lrr_tpu_torch.matching.indexing import (
    descriptor_nn_table,
    generate_candidates,
    initial_transforms,
)
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops.descriptors import compute_descriptors
from lrr_tpu_torch.ops.robust import nanmedian
from lrr_tpu_torch.ops.voronoi import build_feature_voronoi
from lrr_tpu_torch.ops.watershed import watershed_segmentation
from lrr_tpu_torch.parallel.distributed import all_gather, gather_rows
from lrr_tpu_torch.pipeline import wave_graph
from lrr_tpu_torch.pipeline.regions import compact_feature_labels, select_features_by_labels
from lrr_tpu_torch.sampling import SamplingPlan
from lrr_tpu_torch.types import DescriptorSet, FeatureSet, Volume, no_tf32
from lrr_tpu_torch.utils import timers
from lrr_tpu_torch.verify.svm import SvmModel, predict_probability, scale_measurements

@dataclasses.dataclass
class PairContext:
    """Precomputed per-volume-pair state (stage-1 artifacts), plus the
    derived descriptor-NN table.  Every ICP match reads a Voronoi map's
    feature index and that feature's row (`icp.sample_matches_plain`)."""

    moving_features: FeatureSet
    fixed_features: FeatureSet
    moving_descriptors: DescriptorSet
    fixed_descriptors: DescriptorSet
    moving_vor: VoronoiGrid
    fixed_vor: VoronoiGrid
    nn_table: tuple[torch.Tensor, torch.Tensor]  # (moving index, distance) [Kf]
    # optional per-feature compact watershed region ids (int32 [N]); when
    # present, candidate feature selection grows whole regions around the
    # query inside the ROI box (FeaturesInRegions, itkLocationRegistration
    # .cxx:1363-1522); see `attach_regions`
    moving_region_labels: torch.Tensor | None = None
    fixed_region_labels: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.moving_features.xyz.device


def assemble_pair_context(
    fs_m: FeatureSet, fs_f: FeatureSet, ds_m: DescriptorSet, ds_f: DescriptorSet,
    mv: VoronoiGrid, fv: VoronoiGrid,
) -> PairContext:
    """The context of a pair from its stage-1 sets and maps: adds the derived
    state, the fixed->moving descriptor-NN table (kernel K2)."""
    with timers.span("stage1.nn_table"):
        nn_table = descriptor_nn_table(ds_f, ds_m)
    return PairContext(
        moving_features=fs_m, fixed_features=fs_f,
        moving_descriptors=ds_m, fixed_descriptors=ds_f,
        moving_vor=mv, fixed_vor=fv, nn_table=nn_table,
    )


def prepare_pair(
    moving: Volume, fixed: Volume, cfg: PipelineConfig, mesh=None, axis_name: str = "sp",
) -> PairContext:
    """Stage 1 for both volumes, on their device: features, keypoints,
    descriptors, Voronoi maps (ExtractFeatures + ExtractKeypoints +
    ComputeDescriptors + compute_distance_map), then the derived state.

    With `mesh` (naming `axis_name`; `parallel.distributed.Mesh`), stage 1
    runs spatially split over its ranks, the reference's voxel-region thread
    splitting (SplitRequestedRegion, itkFeatureImageFilter.txx:370-466): the
    detector's dense stage goes a z-slab a rank where the level's z extent
    divides (`features.extract._dense_stage`), and each exact Voronoi build
    a z-slab a rank (`build_feature_voronoi`).  Everything else, K2's
    descriptor-NN table included, runs on every rank, which then all hold
    the same context.

    With the program's trace on (`utils.timers`) it records
    `stage1.prepare_pair` around `stage1.features`, `stage1.keypoints`,
    `stage1.descriptors` and `stage1.voronoi` a volume (attribute
    `volume`), then `stage1.nn_table`."""
    if moving.device != fixed.device:
        raise ValueError(f"prepare_pair: volumes on {moving.device} and {fixed.device}")
    with timers.span("stage1.prepare_pair"):
        with timers.span("stage1.features", volume="moving"):
            fs_m = detect_features(moving, cfg.features, mesh=mesh, axis_name=axis_name)
        with timers.span("stage1.features", volume="fixed"):
            fs_f = detect_features(fixed, cfg.features, mesh=mesh, axis_name=axis_name)
        with timers.span("stage1.keypoints", volume="moving"):
            kp_m = extract_keypoints(fs_m, cfg.keypoints)
        with timers.span("stage1.keypoints", volume="fixed"):
            kp_f = extract_keypoints(fs_f, cfg.keypoints)
        with timers.span("stage1.descriptors", volume="moving"):
            ds_m = compute_descriptors(kp_m, fs_m, cfg.descriptors)
        with timers.span("stage1.descriptors", volume="fixed"):
            ds_f = compute_descriptors(kp_f, fs_f, cfg.descriptors)
        with timers.span("stage1.voronoi", volume="moving"):
            mv = VoronoiGrid(*build_feature_voronoi(fs_m.xyz, fs_m.mask, mesh=mesh,
                                                    axis_name=axis_name))
        with timers.span("stage1.voronoi", volume="fixed"):
            fv = VoronoiGrid(*build_feature_voronoi(fs_f.xyz, fs_f.mask, mesh=mesh,
                                                    axis_name=axis_name))
        return assemble_pair_context(fs_m, fs_f, ds_m, ds_f, mv, fv)


def attach_regions(ctx: PairContext, moving_labels: Volume, fixed_labels: Volume) -> PairContext:
    """Attach watershed segmentations (label volumes) to a pair context:
    per-feature compact region ids, gathered once here so the per-candidate
    work is capacity-sized (the reference reads the label volume and grows
    regions per candidate, itkLocationRegistration.cxx:657, 1363-1522)."""
    with timers.span("stage1.regions"):
        ml = compact_feature_labels(
            ctx.moving_features, moving_labels.data, moving_labels.origin, moving_labels.spacing
        )
        fl = compact_feature_labels(
            ctx.fixed_features, fixed_labels.data, fixed_labels.origin, fixed_labels.spacing
        )
    return dataclasses.replace(ctx, moving_region_labels=ml, fixed_region_labels=fl)


def segment_pair(moving: Volume, fixed: Volume, ctx: PairContext) -> PairContext:
    """Watershed oversegmentation (WatershedSegmentation1.cxx canonical
    parameters) of both volumes, attached to the context.  Traced as
    `stage1.segment_pair` around `stage1.watershed` a volume and
    `stage1.regions`."""
    with timers.span("stage1.segment_pair"):
        with timers.span("stage1.watershed", volume="moving"):
            ml = watershed_segmentation(moving.data)
        with timers.span("stage1.watershed", volume="fixed"):
            fl = watershed_segmentation(fixed.data)
        return attach_regions(
            ctx, Volume(ml, moving.origin, moving.spacing), Volume(fl, fixed.origin, fixed.spacing)
        )


@dataclasses.dataclass
class LocationResult:
    """Per-query output; leading dims [Q, C] (C = candidates), or [C] from
    `register_location`."""

    trans: Affine3D
    covar: torch.Tensor
    measurements: torch.Tensor
    probability: torch.Tensor
    verified: torch.Tensor
    converged: torch.Tensor
    valid: torch.Tensor
    oscillated: torch.Tensor
    enough_features: torch.Tensor
    candidate_mask: torch.Tensor
    initial_angle: torch.Tensor
    rank: torch.Tensor
    selected: torch.Tensor  # [Q] index into candidates, -1 if none verified
    query_mapped: torch.Tensor
    refined: torch.Tensor
    keypoint_moving: torch.Tensor
    keypoint_fixed: torch.Tensor
    initial_rms: torch.Tensor
    final_rms: torch.Tensor


def _in_box(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """[N, 3] points inside per-lane boxes [L, 3] -> [L, N]."""
    return ((xyz[None] >= lo[:, None]) & (xyz[None] <= hi[:, None])).all(-1)


def _candidate_rois(ctx: PairContext, init: Affine3D, query: torch.Tensor, cfg):
    """ROI masks + feature-count gate for L candidates.  Without region
    labels: plain ROI boxes (FeaturesInROIs, itkLocationRegistration.cxx:
    1324-1360,1632).  With them: whole watershed regions grown around the
    query inside the box until >= target_region_features (FeaturesInRegions,
    .cxx:1363-1522).  The measurement box stays the 50 mm box either way.
    The moving-space query point is the transform center."""
    ecfg = cfg.estimation
    half = ecfg.roi_mm / 2.0
    qm = init.center
    moving_lo, moving_hi = qm - half, qm + half
    fixed_lo, fixed_hi = query - half, query + half
    if ctx.moving_region_labels is not None:
        m_sel = select_features_by_labels(
            ctx.moving_features, ctx.moving_region_labels, qm,
            ecfg.target_region_features, box_lo=moving_lo, box_hi=moving_hi,
        )
        f_sel = select_features_by_labels(
            ctx.fixed_features, ctx.fixed_region_labels, query,
            ecfg.target_region_features, box_lo=fixed_lo, box_hi=fixed_hi,
        )
    else:
        m_sel = ctx.moving_features.mask[None] & _in_box(
            ctx.moving_features.xyz, moving_lo, moving_hi
        )
        f_sel = ctx.fixed_features.mask[None] & _in_box(
            ctx.fixed_features.xyz, fixed_lo, fixed_hi
        )
    enough = (m_sel.sum(-1) >= ecfg.min_region_features) & (
        f_sel.sum(-1) >= ecfg.min_region_features
    )
    return m_sel, f_sel, moving_lo, fixed_lo, enough, qm


def _candidate_initial_angle(
    ctx: PairContext, init: Affine3D, m_sel: torch.Tensor, cfg,
    scores: torch.Tensor, offset: torch.Tensor,
) -> torch.Tensor:
    """PASS-1 ranking key [L]: initial sheet/tube angle agreement (over
    pi/4) plus the initial median residual (over 4.5 mm), from one match
    sample of `initial_matches` at the initial transform.

    The window is cut to `initial_matches` rows: the JAX package samples
    `max_matches` and masks every row past `initial_matches`, so the rows
    cut here never count.  LRR_RANK_KEY=angle in the environment gives the
    reference's pure angle key (radians), for A/B runs."""
    ecfg = cfg.estimation
    order0, valid0 = _source_permutation(scores, m_sel)
    number = torch.full_like(valid0, ecfg.initial_matches)
    s0 = _sample_stats_packed(
        offset, order0, valid0,
        _pack_features_wide(ctx.moving_features),
        _pack_features_wide(ctx.fixed_features),
        ctx.fixed_vor, init, number, min(ecfg.max_matches, ecfg.initial_matches),
    )
    sheet0, tube0 = _angle_stats_packed(init, s0, s0.weight)
    ang = 0.5 * (sheet0 + tube0)
    if os.environ.get("LRR_RANK_KEY") == "angle":
        return ang
    r2 = _residual2_packed(init, _as_packed_matches(s0))
    med_res = torch.sqrt(nanmedian(torch.where(s0.mask, r2, torch.full_like(r2, math.nan))))
    # empty samples rank last among usable but stay finite
    med_res = torch.nan_to_num(med_res, nan=1e6, posinf=1e6)
    return ang / (math.pi / 4.0) + med_res / 4.5


def _roi_sets(ctx: PairContext, m_sel: torch.Tensor, f_sel: torch.Tensor):
    """The sampling sources of L candidates: the full sets under their ROI
    masks."""
    return (dataclasses.replace(ctx.moving_features, mask=m_sel),
            dataclasses.replace(ctx.fixed_features, mask=f_sel))


def _measure(ctx: PairContext, res: ICPResult, moving_roi, fixed_roi, moving_lo, fixed_lo,
             cfg: PipelineConfig, plan: SamplingPlan) -> torch.Tensor:
    """Backward covariance and the 8 decision measurements of refined lanes."""
    ecfg = cfg.estimation
    cov_b = backward_covariance(
        res, moving_roi, fixed_roi, ctx.fixed_vor, ctx.moving_vor, ecfg,
        plan.covariance(),
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features,
    )
    return decision_measurements(res, cov_b, moving_lo, fixed_lo, ecfg.roi_mm)


def _pass1_fn(ctx: PairContext, queries: torch.Tensor, cfg, plan: SamplingPlan):
    """Candidate generation + PASS-1 ranking for Q queries ([Q, C] outputs):
    the candidate initialisations, the rank order and the pre-refinement
    usability gate (candidate exists and both ROIs have enough features)."""
    Q = queries.shape[0]
    C = cfg.indexing.num_candidates
    cands = generate_candidates(
        queries, ctx.moving_descriptors, ctx.fixed_descriptors, cfg.indexing,
        nn_table=ctx.nn_table,
    )
    inits = initial_transforms(
        cands, ctx.moving_descriptors, ctx.fixed_descriptors, queries
    )
    flat = Affine3D(inits.A.flatten(0, 1), inits.t.flatten(0, 1), inits.center.flatten(0, 1))
    q_lanes = queries[:, None, :].expand(Q, C, 3).reshape(Q * C, 3)
    m_sel, _, _, _, enough, qm = _candidate_rois(ctx, flat, q_lanes, cfg)
    lanes = plan.flatten()
    angles = _candidate_initial_angle(
        ctx, flat, m_sel, cfg, lanes.rank_scores, lanes.rank_offset
    ).reshape(Q, C)
    enough = enough.reshape(Q, C)
    usable0 = cands.mask & enough
    rank = torch.sort(
        torch.where(usable0, angles, torch.full_like(angles, math.inf)),
        dim=1, stable=True,
    ).indices
    kp_m = ctx.moving_descriptors.keypoints.xyz[cands.moving_idx]
    kp_f = ctx.fixed_descriptors.keypoints.xyz[cands.fixed_idx]
    return cands.mask, inits, angles, enough, qm.reshape(Q, C, 3), rank, kp_m, kp_f


def _wave_inputs(queries, inits: Affine3D, plan: SamplingPlan, lanes, cand_idx):
    """A wave's per-lane inputs: each lane's query [L, 3], initial transform
    [L] and plan rows [L] (new tensors, gathered)."""
    init = Affine3D(
        inits.A[lanes, cand_idx], inits.t[lanes, cand_idx], inits.center[lanes, cand_idx]
    )
    return queries[lanes], init, plan.select(lanes, cand_idx)


def _wave_prologue(ctx: PairContext, cfg: PipelineConfig, query, init: Affine3D,
                   plan: SamplingPlan):
    """A wave up to its ICP levels: the ROIs, the sampling sources and
    iteration 0 with the MUSE scale.  Sampling sources are the ROI subsets;
    match targets are the full sets (itkLocationRegistration.cxx:1645-1650).
    Returns (refinement, carry, rois)."""
    m_sel, f_sel, mlo, flo, _, _ = _candidate_rois(ctx, init, query, cfg)
    moving_roi, fixed_roi = _roi_sets(ctx, m_sel, f_sel)
    refinement = Refinement(
        moving_roi, fixed_roi, ctx.fixed_vor, ctx.moving_vor, cfg.estimation, plan.icp(),
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features,
    )
    return refinement, refinement.start(init), (moving_roi, fixed_roi, mlo, flo)


def _wave_epilogue(ctx: PairContext, cfg: PipelineConfig, svm: SvmModel,
                   refinement: Refinement, carry, rois, plan: SamplingPlan) -> torch.Tensor:
    """A wave after its ICP levels: the final statistics, the decision
    measurements and the SVM, packed into rows [L, 174]."""
    res = refinement.finish(carry)
    meas = _measure(ctx, res, *rois, cfg, plan)
    return _pack_wave(res, meas, predict_probability(svm, scale_measurements(meas)))


def _wave_fn(ctx, queries, cfg, svm, inits: Affine3D, plan: SamplingPlan, lanes, cand_idx):
    """Refine one (query, candidate) pair per lane (a PASS-2 wave): the
    packed rows [L, 174].  `WAVE_STEPS` run eagerly, the ICP's levels between
    prologue and epilogue; `wave_graph` captures the same steps."""
    query, init, plan = _wave_inputs(queries, inits, plan, lanes, cand_idx)
    refinement, carry, rois = _wave_prologue(ctx, cfg, query, init, plan)
    return _wave_epilogue(ctx, cfg, svm, refinement, refinement.levels(carry), rois, plan)


WAVE_STEPS = wave_graph.WaveSteps(_wave_inputs, _wave_prologue, _wave_epilogue)


# a wave's results travel as one float32 row a lane: (name, width)
_WAVE_FIELDS = (
    ("A", 9), ("t", 3), ("center", 3), ("covar", 144), ("meas", 8), ("probs", 1),
    ("valid", 1), ("oscillated", 1), ("converged", 1), ("initial_rms", 1), ("final_rms", 1),
    ("iterations", 1),
)


def _pack_wave(res: ICPResult, meas: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """[L, 174] float32: every per-lane output a wave hands to the host
    (booleans as 0 / 1 and the iterations a lane ran, exact)."""
    cols = {
        "A": res.trans.A, "t": res.trans.t, "center": res.trans.center, "covar": res.covar,
        "meas": meas, "probs": probs, "valid": res.valid, "oscillated": res.oscillated,
        "converged": res.converged, "initial_rms": res.initial_rms, "final_rms": res.final_rms,
        "iterations": res.iterations,
    }
    L = probs.shape[0]
    return torch.cat([cols[name].reshape(L, -1).to(torch.float32) for name, _ in _WAVE_FIELDS], 1)


def _unpack_wave(rows):
    """`_pack_wave`'s fields of rows [L, 174] (numpy or torch: slices,
    reshapes and compares only)."""
    out, col = {}, 0
    for name, width in _WAVE_FIELDS:
        part = rows[:, col : col + width]
        out[name] = part[:, 0] if width == 1 else part
        col += width
    out["A"] = out["A"].reshape(-1, 3, 3)
    out["covar"] = out["covar"].reshape(-1, 12, 12)
    for name in ("valid", "oscillated", "converged"):
        out[name] = out[name] > 0.5
    return out


def _pad_queries(queries: torch.Tensor, plan: SamplingPlan, n: int):
    """Queries and plan padded to a multiple of `n` rows by repeating query
    0 and its plan rows (lrr_tpu/pipeline/registration.py:424-434)."""
    Q0 = queries.shape[0]
    pad = (-Q0) % n
    if pad == 0:
        return queries, plan
    rows = torch.cat([torch.arange(Q0), torch.zeros(pad, dtype=torch.long)])
    return queries[rows.to(queries.device)], plan.take(rows.to(plan.rank_offset.device))


def pad_bucket(m: int, n: int = 1) -> int:
    """Lanes a wave of `m` (lane, candidate) pairs runs at over `n` ranks:
    lrr_tpu's `pad_lanes` (lrr_tpu/pipeline/registration.py:690-701), a
    power of two of at least 8, rounded to a multiple of `n`, so that only
    O(log Q) wave shapes, and so captured graphs, ever exist."""
    bucket = max(8, 1 << (max(m, 1) - 1).bit_length())
    bucket = max(bucket, n) // n * n
    if bucket < m:
        bucket = -(-m // n) * n
    return bucket


def pad_lanes(lanes: torch.Tensor, cand_idx: torch.Tensor, n: int = 1):
    """A wave's (lane, candidate) pairs padded to `pad_bucket` by repeating
    the first pair (the padded lanes' results are dropped)."""
    pad = pad_bucket(lanes.numel(), n) - lanes.numel()
    return (torch.cat([lanes, lanes[:1].expand(pad)]),
            torch.cat([cand_idx, cand_idx[:1].expand(pad)]))


def _wave_runner(ctx: PairContext, cfg: PipelineConfig, svm: SvmModel, mesh=None):
    """How an entry point's waves run: run(queries, inits, plan, lanes,
    cand_idx) -> the packed rows [B, 174] of the B lanes, on the context's
    device.  On the card without a mesh, from captured CUDA graphs
    (`pipeline/wave_graph.py`, lrr_tpu's one program a wave); on the CPU,
    and with a mesh (its exchanges stay eager), `_wave_fn` itself."""
    if mesh is None and ctx.device.type == "cuda":
        return wave_graph.wave_graphs(ctx, cfg, svm, WAVE_STEPS).run
    return _eager_wave_runner(ctx, cfg, svm)


def _eager_wave_runner(ctx: PairContext, cfg: PipelineConfig, svm: SvmModel, mesh=None):
    """`_wave_runner`'s eager form: each wave through `_wave_fn` (on the
    card, the graphs' oracle; it takes `mesh` so that it can stand in for
    `_wave_runner`)."""
    svm = svm.to(ctx.device)

    def run(queries, inits, plan, lanes, cand_idx):
        return _wave_fn(ctx, queries, cfg, svm, inits, plan, lanes, cand_idx)

    return run


def register_locations_staged(
    ctx: PairContext,
    queries: torch.Tensor,  # [Q, 3]
    cfg: PipelineConfig,
    svm: SvmModel,
    plan: SamplingPlan,
    lane_budget: int = 64,
    accept_override: float | None = None,
    max_unproductive: int = 2,
    mesh=None,
) -> LocationResult:
    """Batched registration with the reference's PASS-2 early exit.

    PASS 1 ranks every query's candidates; then each wave refines the next
    group of ranks for every still-unresolved query as one batch of lanes,
    and the host checks verification in rank order (the first verified
    candidate wins; the first pre-gated-unusable rank exhausts the query).
    The group width adapts to `lane_budget`: k0 = budget // Q ranks per
    query in the first wave, then budget // (active queries).  After
    `max_unproductive` consecutive low-yield waves (fewer than a quarter of
    the active queries resolved) the group width jumps to all C candidates.
    Ranks no wave reached are left "never refined" (verified False,
    probability 0).  `accept_override` takes the place of
    `cfg.verify.accept_probability` as the acceptance bar: above 1 nothing
    verifies, so every usable candidate is refined through the serving
    waves (verifier calibration runs so).  `plan` holds every random draw
    (`sampling.draw_sampling_plan`).  A wave's results come to the host as
    one tensor.

    With `mesh` (`parallel.distributed.Mesh`; every rank calls with the same
    arguments) the lanes of every dispatch are split over all its ranks,
    data-parallel, as lrr_tpu's mesh branch splits them (:596-615): the
    queries are padded to a multiple of the rank count by repeating query 0
    and its plan rows, the budget is `lane_budget` a rank (so k0 follows
    the whole budget), PASS 1 runs a block of queries a rank and each wave
    (padded the same way) a block of lanes a rank, and one all-gather a
    dispatch gives every rank every result.  The host bookkeeping then runs
    on the same data on every rank, so the ranks stay in lockstep.

    With the program's trace on (`utils.timers`) it records `staged`
    (attributes `queries`, `candidates`) around `staged.pass1` (PASS 1 up to
    the host's copies of the ranks and the gate), a `staged.wave` a dispatch
    (attributes `bucket`, `lanes`) and `staged.result`; the host bookkeeping
    between them is `staged`'s own time.  The counters `icp.lane_iterations`
    (the iterations this rank's real lanes ran, iteration 0 included) and
    `icp.lane_slots` (the iterations the waves' loops gave those lanes room
    for: 1 + `ITERATIONS_PER_CHECK` a chunk run) measure how full the masked
    iterations are."""
    no_tf32()
    dev = ctx.device
    queries = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=dev))
    C = cfg.indexing.num_candidates
    with timers.span("staged", queries=queries.shape[0], candidates=C):
        return _staged(ctx, queries, cfg, svm, plan, lane_budget, accept_override,
                       max_unproductive, mesh)


def _staged(ctx, queries, cfg, svm, plan, lane_budget, accept_override, max_unproductive,
            mesh) -> LocationResult:
    """`register_locations_staged` on queries [Q, 3] on the context's device."""
    dev = ctx.device
    run = _wave_runner(ctx, cfg, svm, mesh)
    Q0 = queries.shape[0]
    C = cfg.indexing.num_candidates
    n, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    queries, plan = _pad_queries(queries, plan, n)
    Q = queries.shape[0]

    budget = lane_budget * n
    k0 = max(1, min(C, budget // max(Q, 1)))
    block = slice(r * (Q // n), (r + 1) * (Q // n))
    with timers.span("staged.pass1"):
        cmask, inits, angles, enough, qm, rank, kp_m, kp_f = gather_rows(
            mesh, _pass1_fn(ctx, queries[block], cfg, plan.take(block))
        )
        rank_h = rank.cpu().numpy()
        usable0 = (cmask & enough).cpu().numpy()

    def run_wave(lanes_np, cand_np):
        """One dispatch: (lane, candidate) pairs padded to their bucket
        (`pad_bucket`) by repeating the first, this rank's block refined,
        every block's results gathered on every rank as one host array of
        the m real rows."""
        m = lanes_np.size
        bucket = pad_bucket(m, n)
        with timers.span("staged.wave", bucket=bucket, lanes=m):
            lanes_t, cand_t = pad_lanes(torch.as_tensor(lanes_np, device=dev),
                                        torch.as_tensor(cand_np, device=dev), n)
            per_rank = lanes_t.numel() // n
            mine = slice(r * per_rank, (r + 1) * per_rank)
            chunks = icp.chunks_run()
            rows = run(queries, inits, plan, lanes_t[mine], cand_t[mine])
            h = _unpack_wave(all_gather(mesh, rows)[:m].cpu().numpy())
            if timers.enabled():  # this rank's real lanes
                real = slice(mine.start, min(mine.stop, m))
                timers.count("icp.lane_iterations", int(h["iterations"][real].sum()))
                timers.count("icp.lane_slots", len(h["iterations"][real]) * (
                    1 + icp.ITERATIONS_PER_CHECK * (icp.chunks_run() - chunks)))
        return h

    resolved = np.zeros(Q, bool)
    resolved[Q0:] = True  # padding queries never dispatch straggler waves
    selected = np.full(Q, -1, np.int64)

    A = np.tile(np.eye(3, dtype=np.float32), (Q, C, 1, 1))
    t = np.zeros((Q, C, 3), np.float32)
    center = np.zeros((Q, C, 3), np.float32)
    covar = np.zeros((Q, C, 12, 12), np.float32)
    meas_out = np.zeros((Q, C, 8), np.float32)
    probs_out = np.zeros((Q, C), np.float32)
    verified_out = np.zeros((Q, C), bool)
    converged_out = np.zeros((Q, C), bool)
    valid_out = np.zeros((Q, C), bool)
    oscillated_out = np.zeros((Q, C), bool)
    refined_out = np.zeros((Q, C), bool)
    initial_rms_out = np.zeros((Q, C), np.float32)
    final_rms_out = np.zeros((Q, C), np.float32)
    accept_p = cfg.verify.accept_probability if accept_override is None else accept_override

    def absorb_wave(h, lanes, cand_idx):
        usable_w = usable0[lanes, cand_idx] & h["valid"] & ~h["oscillated"]
        A[lanes, cand_idx] = h["A"]
        t[lanes, cand_idx] = h["t"]
        center[lanes, cand_idx] = h["center"]
        covar[lanes, cand_idx] = h["covar"]
        meas_out[lanes, cand_idx] = h["meas"]
        probs_out[lanes, cand_idx] = h["probs"]
        verified_out[lanes, cand_idx] = usable_w & (h["probs"] > accept_p)
        converged_out[lanes, cand_idx] = h["converged"]
        valid_out[lanes, cand_idx] = h["valid"]
        oscillated_out[lanes, cand_idx] = h["oscillated"]
        refined_out[lanes, cand_idx] = True
        initial_rms_out[lanes, cand_idx] = h["initial_rms"]
        final_rms_out[lanes, cand_idx] = h["final_rms"]

    def resolve_from_prefix(q, upto):
        """Scan q's refined ranks [0, upto) in rank order; True iff q was
        newly selected."""
        for pos in range(int(upto)):
            c = rank_h[q, pos]
            if not usable0[q, c]:
                resolved[q] = True  # unusable tail: nothing left to try
                return False
            if verified_out[q, c]:
                selected[q] = c
                resolved[q] = True
                return True
        return False

    # wave 0: ranks [0, k0) of every query
    lanes0 = np.repeat(np.arange(Q), k0)
    cands0 = rank_h[:, :k0].reshape(-1)
    absorb_wave(run_wave(lanes0, cands0), lanes0, cands0)
    wave_pos = np.full(Q, k0, np.int64)
    for q in range(Q0):
        resolve_from_prefix(q, k0)

    unproductive = 0
    while True:
        act = np.nonzero(~resolved & (wave_pos < C))[0]
        if act.size == 0:
            break
        k_r = C if unproductive >= max_unproductive else max(1, min(lane_budget // act.size, C))
        fl_lanes, fl_cands = [], []
        new_pos = wave_pos.copy()
        for q in act:
            for pos in range(int(wave_pos[q]), min(int(wave_pos[q]) + k_r, C)):
                c = rank_h[q, pos]
                if not usable0[q, c]:
                    new_pos[q] = C  # unusable tail: nothing beyond dispatches
                    break
                fl_lanes.append(q)
                fl_cands.append(c)
                new_pos[q] = pos + 1
        if not fl_lanes:
            for q in act:
                resolve_from_prefix(q, wave_pos[q])
            wave_pos[act] = C
            continue
        lanes = np.asarray(fl_lanes, np.int64)
        cand_idx = np.asarray(fl_cands, np.int64)
        absorb_wave(run_wave(lanes, cand_idx), lanes, cand_idx)
        wave_pos = new_pos
        n_resolved = sum(bool(resolve_from_prefix(q, wave_pos[q])) for q in act)
        unproductive = unproductive + 1 if n_resolved * 4 < act.size else 0

    def dev_t(x):
        return torch.as_tensor(x, device=dev)

    with timers.span("staged.result"):
        out = LocationResult(
            trans=Affine3D(A=dev_t(A), t=dev_t(t), center=dev_t(center)),
            covar=dev_t(covar),
            measurements=dev_t(meas_out),
            probability=dev_t(probs_out),
            verified=dev_t(verified_out),
            converged=dev_t(converged_out),
            valid=dev_t(valid_out),
            oscillated=dev_t(oscillated_out),
            enough_features=enough,
            candidate_mask=cmask,
            initial_angle=angles,
            rank=rank,
            selected=dev_t(selected),
            query_mapped=qm,
            refined=dev_t(refined_out),
            keypoint_moving=kp_m,
            keypoint_fixed=kp_f,
            initial_rms=dev_t(initial_rms_out),
            final_rms=dev_t(final_rms_out),
        )
        return out if Q == Q0 else result_at(out, slice(0, Q0))


def register_locations(
    ctx: PairContext,
    queries: torch.Tensor,  # [Q, 3]
    cfg: PipelineConfig,
    svm: SvmModel,
    plan: SamplingPlan,
    lane_budget: int = 64,
    mesh=None,
) -> LocationResult:
    """Batched registration that refines EVERY candidate of every query
    (Q x C lanes, `lane_budget` lanes a batch) and selects afterwards: the
    first verified candidate in ascending PASS-1 key order over the
    candidates still usable after refinement (valid, not oscillating).
    Maximal information at ~C times the staged path's work; `refined` is
    all ones.  The draws are the staged path's, so one plan serves both.

    With `mesh` the queries are split over all its ranks, data-parallel
    (lrr_tpu/pipeline/registration.py:421-452): padded to a multiple of the
    rank count by repeating query 0 and its plan rows, each rank registers
    its block, and one all-gather gives every rank the whole result."""
    if mesh is not None and mesh.size > 1:
        queries = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=ctx.device))
        Q0, n = queries.shape[0], mesh.size
        queries, plan = _pad_queries(queries, plan, n)
        block = slice(mesh.rank * (queries.shape[0] // n), (mesh.rank + 1) * (queries.shape[0] // n))
        local = register_locations(ctx, queries[block], cfg, svm, plan.take(block), lane_budget)
        return result_at(gather_rows(mesh, local), slice(0, Q0))
    no_tf32()
    dev = ctx.device
    queries = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32, device=dev))
    run = _wave_runner(ctx, cfg, svm)
    Q = queries.shape[0]
    C = cfg.indexing.num_candidates
    cmask, inits, angles, enough, qm, _, kp_m, kp_f = _pass1_fn(ctx, queries, cfg, plan)

    lanes = torch.arange(Q, device=dev).repeat_interleave(C)
    cands = torch.arange(C, device=dev).repeat(Q)
    step = max(lane_budget, 1)
    rows = []
    for i in range(0, Q * C, step):
        m = min(step, Q * C - i)
        rows.append(run(queries, inits, plan, *pad_lanes(lanes[i : i + m], cands[i : i + m]))[:m])
    h = {k: v.reshape((Q, C) + v.shape[1:]) for k, v in _unpack_wave(torch.cat(rows)).items()}

    probs = h["probs"]
    valid, oscillated = h["valid"], h["oscillated"]
    usable = cmask & enough & valid & ~oscillated
    verified = usable & (probs > cfg.verify.accept_probability)
    rank = torch.sort(
        torch.where(usable, angles, torch.full_like(angles, math.inf)), dim=1, stable=True
    ).indices
    in_order = verified.gather(1, rank)
    first = in_order.to(torch.int8).argmax(1)
    selected = torch.where(
        in_order.any(1), rank.gather(1, first[:, None])[:, 0], torch.full_like(first, -1)
    )
    return LocationResult(
        trans=Affine3D(A=h["A"], t=h["t"], center=h["center"]),
        covar=h["covar"], measurements=h["meas"], probability=probs,
        verified=verified, converged=h["converged"], valid=valid, oscillated=oscillated,
        enough_features=enough, candidate_mask=cmask, initial_angle=angles, rank=rank,
        selected=selected, query_mapped=qm, refined=torch.ones_like(verified),
        keypoint_moving=kp_m, keypoint_fixed=kp_f,
        initial_rms=h["initial_rms"], final_rms=h["final_rms"],
    )


def result_at(obj, i):
    """Entry `i` (or the rows of a slice) along the leading dim of every
    tensor of a result dataclass: one query's `LocationResult` out of a
    batched one."""
    if isinstance(obj, torch.Tensor):
        return obj[i]
    return type(obj)(**{f.name: result_at(getattr(obj, f.name), i) for f in dataclasses.fields(obj)})


def register_location(
    ctx: PairContext,
    query: torch.Tensor,  # [3]
    cfg: PipelineConfig,
    svm: SvmModel,
    plan: SamplingPlan,  # [1, C]
) -> LocationResult:
    """Full stage 2+3 for one query location, every candidate refined; the
    result's fields lead with [C] and `selected` is a scalar."""
    query = torch.as_tensor(query, dtype=torch.float32, device=ctx.device)
    return result_at(register_locations(ctx, query[None], cfg, svm, plan), 0)


def _one_candidate(ctx, query, cfg, plan: SamplingPlan, candidate, inits: Affine3D):
    """(init, ROI sets, ICP draws) of candidate `candidate` of a one-query
    plan, as one lane."""
    zero = torch.zeros(1, dtype=torch.long, device=ctx.device)
    cand = torch.as_tensor(candidate, device=ctx.device).reshape(1)
    init = Affine3D(inits.A[zero, cand], inits.t[zero, cand], inits.center[zero, cand])
    m_sel, f_sel, _, _, _, _ = _candidate_rois(ctx, init, query[None], cfg)
    return init, *_roi_sets(ctx, m_sel, f_sel), plan.select(zero, cand).icp()


def register_location_rigid(
    ctx: PairContext,
    query: torch.Tensor,  # [3]
    cfg: PipelineConfig,
    plan: SamplingPlan,  # [1, C]
):
    """BASELINE config 3: Rigid3D ICP refinement from a single indexed
    initialisation.  Candidate generation and PASS-1 ranking as in the
    affine entry points (itkLocationRegistration.cxx:2230-2319), then ONE rigid
    refinement of the best-ranked usable candidate by the incremental
    small-angle scheme (cdcl_estimation.txx:111-165).  Returns (ICPResult
    of that one lane, best candidate index, any usable); the result's A is
    a rotation by construction.  The refinement samples with the plan's
    rigid stream, PASS 1 with the candidates' own."""
    no_tf32()
    query = torch.as_tensor(query, dtype=torch.float32, device=ctx.device)
    cmask, inits, angles, enough, *_ = _pass1_fn(ctx, query[None], cfg, plan)
    usable = (cmask & enough)[0]
    best = torch.argmin(torch.where(usable, angles[0], torch.full_like(angles[0], math.inf)))
    init, moving_roi, fixed_roi, _ = _one_candidate(ctx, query, cfg, plan, best, inits)
    res = register_candidate(
        moving_roi, fixed_roi, ctx.fixed_vor, ctx.moving_vor, init, cfg.estimation,
        plan.rigid(),
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features, model="rigid",
    )
    return result_at(res, 0), best, usable.any()


def watch_candidate(
    ctx: PairContext,
    query: torch.Tensor,  # [3]
    cfg: PipelineConfig,
    plan: SamplingPlan,  # [1, C]
    candidate: int,
    progress_callback,
) -> ICPResult:
    """Replay ONE candidate's refinement with a per-iteration host callback
    `(iteration, weighted_error, number_matches)`: the headless analogue of
    the reference's interactive display callback and LAST_ITER replay
    (cdcl/display/cdcl_display.h:16, itkLocationRegistration.cxx:2550-2581).
    It samples with the candidate's own stream of `plan`, as
    `register_location` and the staged waves do, so the replayed refinement
    is the production refinement with observability added.  Returns the
    replayed ICPResult of that one lane."""
    no_tf32()
    query = torch.as_tensor(query, dtype=torch.float32, device=ctx.device)
    cands = generate_candidates(
        query[None], ctx.moving_descriptors, ctx.fixed_descriptors, cfg.indexing,
        nn_table=ctx.nn_table,
    )
    inits = initial_transforms(
        cands, ctx.moving_descriptors, ctx.fixed_descriptors, query[None]
    )
    init, moving_roi, fixed_roi, draws = _one_candidate(ctx, query, cfg, plan, candidate, inits)
    res = register_candidate(
        moving_roi, fixed_roi, ctx.fixed_vor, ctx.moving_vor, init, cfg.estimation, draws,
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features,
        progress_callback=progress_callback,
    )
    return result_at(res, 0)

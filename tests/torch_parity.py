"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The only place both packages meet: it loads the committed small pair
context into both, and builds the port's `SamplingPlan` by walking
lrr_tpu's own key tree with `jax.random`, so the two packages sample the
same match windows.  Data crosses between the two as numpy arrays.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SMALL = os.path.join(DATA, "torch_pair_small")


def np_(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def t_(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


@functools.lru_cache(maxsize=None)
def small_meta() -> dict:
    with open(SMALL + ".json") as f:
        return json.load(f)


def small_configs():
    """(lrr_tpu PipelineConfig, lrr_tpu_torch PipelineConfig) of the fixture."""
    import lrr_tpu.config as jc
    from lrr_tpu_torch.config import pipeline_config_from_dict

    tc = pipeline_config_from_dict(small_meta()["config"])
    d = small_meta()["config"]

    def build(cls, sub):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in sub.items()})

    jcfg = jc.PipelineConfig(
        features=build(jc.FeatureConfig, d["features"]),
        keypoints=build(jc.KeypointConfig, d["keypoints"]),
        descriptors=build(jc.DescriptorConfig, d["descriptors"]),
        indexing=build(jc.IndexingConfig, d["indexing"]),
        estimation=build(jc.EstimationConfig, d["estimation"]),
        verify=build(jc.VerifyConfig, d["verify"]),
        seed=d["seed"],
    )
    return jcfg, tc


@functools.lru_cache(maxsize=None)
def small_region_contexts():
    """(lrr_tpu PairContext with its nn_table, lrr_tpu_torch PairContext),
    both from the committed artifact, both with the per-feature watershed
    region ids that lrr_tpu's `segment_pair` gave (the artifact's `mr.0` /
    `fr.0`, which only the port's loader reads)."""
    from lrr_tpu.matching.indexing import descriptor_nn_table
    from lrr_tpu.pipeline.artifacts import load_pair_context as jload
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context as tload

    jctx = jload(SMALL + ".npz")
    with np.load(SMALL + ".npz") as z:
        regions = jnp.asarray(z["mr.0"]), jnp.asarray(z["fr.0"])
    jctx = jctx.replace(
        nn_table=descriptor_nn_table(jctx.fixed_descriptors, jctx.moving_descriptors),
        moving_region_labels=regions[0], fixed_region_labels=regions[1],
    )
    return jctx, tload(SMALL + ".npz", "cpu")


@functools.lru_cache(maxsize=None)
def small_contexts():
    """The two contexts of `small_region_contexts` without regions."""
    import dataclasses

    jctx, tctx = small_region_contexts()
    return (
        jctx.replace(moving_region_labels=None, fixed_region_labels=None),
        dataclasses.replace(tctx, moving_region_labels=None, fixed_region_labels=None),
    )


@functools.lru_cache(maxsize=None)
def small_volumes():
    """The fixture's phantom pair from its seed, by each package's own
    `make_pair`: ((fixed, moving) of lrr_tpu, (fixed, moving) of the port)."""
    from lrr_tpu.utils.synthetic import make_pair as jmake
    from lrr_tpu_torch.utils.synthetic import make_pair as tmake

    pair = small_meta()["pair"]
    kw = dict(rotation_deg=pair["rotation_deg"], translation=tuple(pair["translation"]),
              seed=pair["seed"])
    jf, jm, _ = jmake(tuple(pair["shape_zyx"]), **kw)
    tf, tm, _ = tmake(tuple(pair["shape_zyx"]), device="cpu", **kw)
    return (jf, jm), (tf, tm)


def small_queries(n: int | None = None) -> np.ndarray:
    q = np.asarray(small_meta()["queries"], np.float32)
    return q if n is None else q[:n]


def jax_candidates(jctx, queries: np.ndarray, jcfg):
    """lrr_tpu's candidate initialisations and ROI valid counts per (q, c):
    (inits list[list[Affine3D]], m_sel [Q][C], f_sel [Q][C])."""
    from lrr_tpu.matching import generate_candidates, initial_transforms
    from lrr_tpu.pipeline.registration import _candidate_rois

    inits, m_sel, f_sel, usable = [], [], [], []
    for q in queries:
        qj = jnp.asarray(q)
        cands = generate_candidates(
            qj, jctx.moving_descriptors, jctx.fixed_descriptors, jcfg.indexing,
            nn_table=jctx.nn_table,
        )
        it = initial_transforms(cands, jctx.moving_descriptors, jctx.fixed_descriptors, qj)
        row_i, row_m, row_f, row_u = [], [], [], []
        for c in range(jcfg.indexing.num_candidates):
            init = jax.tree.map(lambda x: x[c], it)
            m, f, _, _, enough, _ = _candidate_rois(jctx, init, qj, jcfg)
            row_i.append(init)
            row_m.append(np.asarray(m))
            row_f.append(np.asarray(f))
            row_u.append(bool(cands.mask[c]) and bool(enough))
        inits.append(row_i)
        m_sel.append(row_m)
        f_sel.append(row_f)
        usable.append(row_u)
    return inits, m_sel, f_sel, usable


def lane_keys(key, Q: int, C: int):
    """Per-(q, c) (k1, k2) refinement keys of register_locations_staged."""
    k1s, k2s = [], []
    for qk in jax.random.split(key, Q):
        for ck in jax.random.split(qk, C):
            _, _, k1, k2 = jax.random.split(ck, 4)
            k1s.append(k1)
            k2s.append(k2)
    return k1s, k2s


def _icp_draws(k1, m_mask, f_mask, T: int) -> dict:
    """register_candidate's draws from its key `k1` (icp.py:1007-1036/1183)
    for one candidate with ROI masks `m_mask` / `f_mask`."""
    nm, nf = m_mask.shape[0], f_mask.shape[0]
    vm, vf = max(int(m_mask.sum()), 1), max(int(f_mask.sum()), 1)
    kk, kpm, kpf, kof, kob = jax.random.split(k1, 5)
    ks_f, ks_b = jax.random.split(kk)
    return {
        "icp_scores_m": jax.random.uniform(kpm, (nm,)),
        "icp_scores_f": jax.random.uniform(kpf, (nf,)),
        "icp_offsets_f": jax.random.randint(kof, (T,), 0, vm),
        "icp_offsets_b": jax.random.randint(kob, (T,), 0, vf),
        "icp_stats_offset_f": jax.random.randint(ks_f, (), 0, vm),
        "icp_stats_offset_b": jax.random.randint(ks_b, (), 0, vf),
    }


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int64))


def plan_from_candidate_keys(ckeys, m_sel, f_sel, jcfg):
    """The port's SamplingPlan holding exactly the draws lrr_tpu makes from
    the per-candidate keys `ckeys[q][c]` (registration.py:384/479: each is
    split into k0, k0b, k1, k2; icp.py:1007-1036/1183, measurements.py:87)."""
    from lrr_tpu_torch.sampling import SamplingPlan

    T = jcfg.estimation.max_iterations + 1
    fields = {}
    for q, row in enumerate(ckeys):
        rows = {}
        for c, ck in enumerate(row):
            nm, nf = m_sel[q][c].shape[0], f_sel[q][c].shape[0]
            vm = max(int(m_sel[q][c].sum()), 1)
            vf = max(int(f_sel[q][c].sum()), 1)
            k0, k0b, k1, k2 = jax.random.split(ck, 4)
            kf, kb, kpf2, kpm2 = jax.random.split(k2, 4)
            draws = {
                "rank_scores": jax.random.uniform(k0, (nm,)),
                "rank_offset": jax.random.randint(k0b, (), 0, vm),
                **_icp_draws(k1, m_sel[q][c], f_sel[q][c], T),
                "cov_scores_f": jax.random.uniform(kpf2, (nf,)),
                "cov_scores_m": jax.random.uniform(kpm2, (nm,)),
                "cov_offset_b": jax.random.randint(kb, (), 0, vf),
                "cov_offset_f": jax.random.randint(kf, (), 0, vm),
            }
            for name, v in draws.items():
                rows.setdefault(name, []).append(np.asarray(v))
        for name, v in rows.items():
            fields.setdefault(name, []).append(np.stack(v))
    return SamplingPlan(**{name: _to_tensor(np.stack(v)) for name, v in fields.items()})


def plan_from_jax_keys(key, m_sel, f_sel, jcfg):
    """The plan of register_locations_staged(..., key) and of
    register_locations(..., key) (registration.py:420/475: one key a query,
    then one a candidate)."""
    C = jcfg.indexing.num_candidates
    return plan_from_candidate_keys(
        [jax.random.split(qk, C) for qk in jax.random.split(key, len(m_sel))],
        m_sel, f_sel, jcfg)


def plan_from_query_key(key, m_sel, f_sel, jcfg):
    """The [1, C] plan of register_location(..., key) and of
    watch_candidate(..., key) (registration.py:894/926); `m_sel` / `f_sel`
    are the one query's rows."""
    return plan_from_candidate_keys(
        [jax.random.split(key, jcfg.indexing.num_candidates)], [m_sel], [f_sel], jcfg)


def rigid_plan_from_jax_key(key, m_sel, f_sel, jcfg, best: int):
    """The [1, C] plan of register_location_rigid(..., key)
    (registration.py:839-858: C + 1 keys, the last one refines the
    best-ranked candidate `best`, whose ROI counts bound its offsets)."""
    import dataclasses

    C = jcfg.indexing.num_candidates
    keys = jax.random.split(key, C + 1)
    plan = plan_from_candidate_keys([keys[:C]], [m_sel], [f_sel], jcfg)
    d = _icp_draws(keys[C], m_sel[best], f_sel[best], jcfg.estimation.max_iterations + 1)
    return dataclasses.replace(plan, **{
        name.replace("icp_", "rigid_"): _to_tensor(v)[None] for name, v in d.items()})


def torch_affine(tr):
    """lrr_tpu Affine3D (any batch) -> lrr_tpu_torch Affine3D."""
    from lrr_tpu_torch.models.affine import Affine3D

    return Affine3D(t_(tr.A), t_(tr.t), t_(tr.center))


def stack_affines(trs):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trs)


# ---------------------------------------------------------------------------
# stage-1 objects across the two packages (as numpy, field for field)
# ---------------------------------------------------------------------------


def _fields_to_torch(obj, cls):
    import dataclasses

    return cls(**{f.name: t_(getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def torch_volume(vol):
    """lrr_tpu Volume -> lrr_tpu_torch Volume (CPU)."""
    from lrr_tpu_torch.types import Volume

    return _fields_to_torch(vol, Volume)


def torch_features(fs):
    from lrr_tpu_torch.types import FeatureSet

    return _fields_to_torch(fs, FeatureSet)


def torch_keypoints(kp):
    from lrr_tpu_torch.types import KeypointSet

    return _fields_to_torch(kp, KeypointSet)


def torch_descriptors(ds):
    from lrr_tpu_torch.types import DescriptorSet

    return DescriptorSet(torch_keypoints(ds.keypoints), t_(ds.descriptors))


def jax_like(obj, cls):
    """A port dataclass of tensors -> the lrr_tpu pytree class `cls` with
    the same field names (Volume, FeatureSet, KeypointSet)."""
    import dataclasses

    return cls(**{f.name: jnp.asarray(np_(getattr(obj, f.name))) for f in dataclasses.fields(obj)})


def jax_config(tcfg):
    """The lrr_tpu config dataclass with the fields of a port config
    dataclass (any of the six, or the whole PipelineConfig)."""
    import dataclasses

    import lrr_tpu.config as jc

    cls = getattr(jc, type(tcfg).__name__)
    kw = {}
    for f in dataclasses.fields(tcfg):
        v = getattr(tcfg, f.name)
        kw[f.name] = jax_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


# ---------------------------------------------------------------------------
# results and verifiers across the two packages
# ---------------------------------------------------------------------------


def torch_location_result(res):
    """lrr_tpu LocationResult (any batch) -> the port's, field for field."""
    import dataclasses

    from lrr_tpu_torch.pipeline.registration import LocationResult

    return LocationResult(**{
        f.name: torch_affine(res.trans) if f.name == "trans" else t_(getattr(res, f.name))
        for f in dataclasses.fields(LocationResult)})


def torch_svm(model):
    """lrr_tpu SvmModel -> the port's, with the same numbers."""
    from lrr_tpu_torch.verify.svm import SvmModel

    return SvmModel(
        gamma=float(model.gamma), rho=float(model.rho), sv=t_(model.sv, torch.float32),
        sv_coef=t_(model.sv_coef, torch.float32), prob_a=float(model.prob_a),
        prob_b=float(model.prob_b), labels=tuple(int(v) for v in model.labels))


# ---------------------------------------------------------------------------
# the estimate family and the ground-truth models across the two packages
# ---------------------------------------------------------------------------


def torch_cov_features(cf):
    """lrr_tpu CovFeatures -> the port's (CPU)."""
    from lrr_tpu_torch.estimation.cdc import CovFeatures

    return CovFeatures(t_(cf.xyz), t_(cf.cov), t_(cf.mask))


def torch_cdc_matches(m):
    """lrr_tpu CdcMatches -> the port's, field for field."""
    from lrr_tpu_torch.estimation.cdc import CdcMatches

    return _fields_to_torch(m, CdcMatches)


def torch_similarity2d(s):
    from lrr_tpu_torch.models.similarity import Similarity2D

    return _fields_to_torch(s, Similarity2D)


def torch_bspline(b):
    """lrr_tpu BSplineTransform -> the port's (CPU)."""
    from lrr_tpu_torch.models.bspline import BSplineTransform

    return _fields_to_torch(b, BSplineTransform)


def torch_deformation_field(f):
    """lrr_tpu DeformationField -> the port's (CPU)."""
    from lrr_tpu_torch.models.bspline import DeformationField

    return _fields_to_torch(f, DeformationField)


def assert_equal_or_tie(got, want, pts, origin, spacing):
    """Two index maps over the same features: equal, except at voxels where
    the two answers' squared distances (float64 of the fp32 inputs) lie
    within 4 fp32 ulp of each other.  Returns the number of such voxels."""
    diff = np.argwhere(got != want)
    for z, y, x in diff:
        q = origin.astype(np.float64) + np.array([x, y, z]) * spacing.astype(np.float64)
        da = ((q - pts[got[z, y, x]]) ** 2).sum()
        db = ((q - pts[want[z, y, x]]) ** 2).sum()
        assert abs(da - db) <= 4 * np.spacing(np.float32(max(da, db))), (z, y, x, da, db)
    return len(diff)


def torch_context(jctx):
    """lrr_tpu PairContext -> the port's, on the CPU: lrr_tpu's sets, maps
    and region ids; the derived state (K2's table) rebuilt by the port's
    `assemble_pair_context` from them."""
    from lrr_tpu_torch.estimation.icp import VoronoiGrid
    from lrr_tpu_torch.pipeline.registration import assemble_pair_context

    def vor(v):
        return VoronoiGrid(t_(v.index_vol), t_(v.origin), t_(v.spacing))

    ctx = assemble_pair_context(
        torch_features(jctx.moving_features), torch_features(jctx.fixed_features),
        torch_descriptors(jctx.moving_descriptors), torch_descriptors(jctx.fixed_descriptors),
        vor(jctx.moving_vor), vor(jctx.fixed_vor),
    )
    for side in ("moving_region_labels", "fixed_region_labels"):
        labels = getattr(jctx, side)
        setattr(ctx, side, None if labels is None else t_(labels, torch.int32))
    return ctx

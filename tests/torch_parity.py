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
def small_contexts():
    """(lrr_tpu PairContext with its nn_table, lrr_tpu_torch PairContext),
    both from the committed artifact."""
    from lrr_tpu.matching.indexing import descriptor_nn_table
    from lrr_tpu.pipeline.artifacts import load_pair_context as jload
    from lrr_tpu_torch.pipeline.artifacts import load_pair_context as tload

    jctx = jload(SMALL + ".npz")
    jctx = jctx.replace(
        nn_table=descriptor_nn_table(jctx.fixed_descriptors, jctx.moving_descriptors)
    )
    return jctx, tload(SMALL + ".npz", "cpu")


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


def plan_from_jax_keys(key, m_sel, f_sel, jcfg):
    """The port's SamplingPlan holding exactly the draws lrr_tpu makes in
    register_locations_staged(..., key) (registration.py:475-507, icp.py:
    1007-1036/1183, measurements.py:87)."""
    from lrr_tpu_torch.sampling import SamplingPlan

    Q = len(m_sel)
    C = jcfg.indexing.num_candidates
    T = jcfg.estimation.max_iterations + 1
    fields = {name: [] for name in (
        "rank_scores", "rank_offset", "icp_scores_m", "icp_scores_f",
        "icp_offsets_f", "icp_offsets_b", "icp_stats_offset_f",
        "icp_stats_offset_b", "cov_scores_f", "cov_scores_m", "cov_offset_b",
        "cov_offset_f",
    )}
    qkeys = jax.random.split(key, Q)
    for q in range(Q):
        ckeys = jax.random.split(qkeys[q], C)
        rows = {name: [] for name in fields}
        for c in range(C):
            nm, nf = m_sel[q][c].shape[0], f_sel[q][c].shape[0]
            vm = max(int(m_sel[q][c].sum()), 1)
            vf = max(int(f_sel[q][c].sum()), 1)
            k0, k0b, k1, k2 = jax.random.split(ckeys[c], 4)
            kk, kpm, kpf, kof, kob = jax.random.split(k1, 5)
            ks_f, ks_b = jax.random.split(kk)
            kf, kb, kpf2, kpm2 = jax.random.split(k2, 4)
            draws = {
                "rank_scores": jax.random.uniform(k0, (nm,)),
                "rank_offset": jax.random.randint(k0b, (), 0, vm),
                "icp_scores_m": jax.random.uniform(kpm, (nm,)),
                "icp_scores_f": jax.random.uniform(kpf, (nf,)),
                "icp_offsets_f": jax.random.randint(kof, (T,), 0, vm),
                "icp_offsets_b": jax.random.randint(kob, (T,), 0, vf),
                "icp_stats_offset_f": jax.random.randint(ks_f, (), 0, vm),
                "icp_stats_offset_b": jax.random.randint(ks_b, (), 0, vf),
                "cov_scores_f": jax.random.uniform(kpf2, (nf,)),
                "cov_scores_m": jax.random.uniform(kpm2, (nm,)),
                "cov_offset_b": jax.random.randint(kb, (), 0, vf),
                "cov_offset_f": jax.random.randint(kf, (), 0, vm),
            }
            for name, v in draws.items():
                rows[name].append(np.asarray(v))
        for name in fields:
            fields[name].append(np.stack(rows[name]))
    out = {}
    for name, v in fields.items():
        a = np.stack(v)
        out[name] = torch.from_numpy(
            a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int64)
        )
    return SamplingPlan(**out)


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

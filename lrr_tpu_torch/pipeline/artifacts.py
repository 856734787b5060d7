"""Stage artifact checkpoint/resume (lrr_tpu/pipeline/artifacts.py).

The reference's pipeline is restartable because every stage writes its
output to disk; here the same property comes from saving and loading the
whole `PairContext` as one compressed npz, and `prepare_pair_cached`
resumes from it when present.  The layout is the JAX package's
`save_pair_context` npz, so either package loads what the other saved; it
is written and read with numpy alone: keys `mf.0..5`/`ff.0..5` (FeatureSet
fields in order), `md.0..5`/`fd.0..5` (keypoint fields, then descriptors),
`mv.0..2`/`fv.0..2` (VoronoiGrid) and `version`, and optionally
`mr.0`/`fr.0`, the per-feature compact watershed region ids of a context
that had regions attached (the JAX package's loader passes over them).  The
derived state the file omits (the descriptor-NN table) is rebuilt by the
same `assemble_pair_context` that ends `prepare_pair`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from lrr_tpu_torch.config import PipelineConfig
from lrr_tpu_torch.estimation.icp import VoronoiGrid
from lrr_tpu_torch.pipeline.registration import PairContext, assemble_pair_context, prepare_pair
from lrr_tpu_torch.types import DescriptorSet, FeatureSet, KeypointSet, Volume, resolve_device

_VERSION = 1
# key prefix -> number of arrays
_KEYS = {"mf": 6, "ff": 6, "md": 6, "fd": 6, "mv": 3, "fv": 3}
_REGION_KEYS = ("mr", "fr")


def _fields(obj) -> list[torch.Tensor]:
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def save_pair_context(path: str, ctx: PairContext) -> None:
    """Write the context's stage-1 sets and maps (and its region ids, where
    it has them) to `path`, which ends in `.npz`."""
    groups = {
        "mf": _fields(ctx.moving_features),
        "ff": _fields(ctx.fixed_features),
        "md": _fields(ctx.moving_descriptors.keypoints) + [ctx.moving_descriptors.descriptors],
        "fd": _fields(ctx.fixed_descriptors.keypoints) + [ctx.fixed_descriptors.descriptors],
        "mv": _fields(ctx.moving_vor),
        "fv": _fields(ctx.fixed_vor),
    }
    if ctx.moving_region_labels is not None:
        groups["mr"] = [ctx.moving_region_labels]
        groups["fr"] = [ctx.fixed_region_labels]
    flat = {
        f"{prefix}.{i}": leaf.detach().cpu().numpy()
        for prefix, leaves in groups.items() for i, leaf in enumerate(leaves)
    }
    flat["version"] = np.asarray(_VERSION)
    np.savez_compressed(path, **flat)


def _read_arrays(path: str) -> dict:
    """The artifact's arrays by key prefix, on the host (a region key maps
    to None where the file has no region ids)."""
    with np.load(path) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"artifact version mismatch in {path}")
        arrays = {k: [np.asarray(z[f"{k}.{i}"]) for i in range(n)] for k, n in _KEYS.items()}
        for k in _REGION_KEYS:
            arrays[k] = [np.asarray(z[f"{k}.0"])] if f"{k}.0" in z else None
    return arrays


def _context_from_arrays(arrays: dict, device: torch.device) -> PairContext:
    def get(prefix):
        return [torch.from_numpy(a).to(device) for a in arrays[prefix]]

    fs_m = FeatureSet(*get("mf"))
    fs_f = FeatureSet(*get("ff"))
    md, fd = get("md"), get("fd")
    ds_m = DescriptorSet(KeypointSet(*md[:5]), md[5])
    ds_f = DescriptorSet(KeypointSet(*fd[:5]), fd[5])
    mv = VoronoiGrid(*get("mv"))
    fv = VoronoiGrid(*get("fv"))
    for fs in (fs_m, fs_f):
        fs.mask = fs.mask.bool()
    for ds in (ds_m, ds_f):
        ds.keypoints.mask = ds.keypoints.mask.bool()
    ctx = assemble_pair_context(fs_m, fs_f, ds_m, ds_f, mv, fv)
    ctx.moving_region_labels, ctx.fixed_region_labels = (
        None if arrays[k] is None else get(k)[0].to(torch.int32) for k in _REGION_KEYS
    )
    return ctx


def load_pair_context(path: str, device=None) -> PairContext:
    """The pair context on `device`; `None` means the CUDA card
    (`types.resolve_device`)."""
    device = resolve_device(device, "load_pair_context")
    return _context_from_arrays(_read_arrays(path), device)


def prepare_pair_cached(
    moving: Volume, fixed: Volume, cfg: PipelineConfig, cache_path: str,
    read: bool = True, save: bool = True,
) -> PairContext:
    """Stage 1 with resume: load the artifact if present (onto the volumes'
    device), else compute and save it (the file-based restartability of the
    reference pipeline).  A stale or corrupt artifact is recomputed: only
    reading the file is guarded, nothing that runs on the device.  `read`
    False ignores a present artifact and `save` False writes none (the
    batch driver's ranks decide both together, and one of them writes)."""
    arrays = None
    if read and os.path.exists(cache_path):
        try:
            arrays = _read_arrays(cache_path)
        except Exception:
            pass  # stale/corrupt artifact: recompute
    if arrays is not None:
        return _context_from_arrays(arrays, moving.device)
    ctx = prepare_pair(moving, fixed, cfg)
    if save:
        tmp = cache_path + ".tmp.npz"  # keep .npz suffix so savez writes exactly here
        save_pair_context(tmp, ctx)
        os.replace(tmp, cache_path)
    return ctx

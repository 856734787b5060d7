"""Load a stage-1 pair context saved by lrr_tpu (lrr_tpu/pipeline/artifacts.py).

The artifact is the JAX package's `save_pair_context` npz, read with numpy
alone: keys `mf.0..5`/`ff.0..5` (FeatureSet fields in order), `md.0..5`/
`fd.0..5` (keypoint fields, then descriptors), `mv.0..2`/`fv.0..2`
(VoronoiGrid) and `version`, and optionally `mr.0`/`fr.0`, the per-feature
compact watershed region ids of a context that had regions attached
(`scripts/make_torch_fixtures.py` adds them).  The derived state the file
omits (the descriptor-NN table and the baked NN-row grids) is rebuilt by the
same `assemble_pair_context` that ends `prepare_pair`.
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.estimation.icp import VoronoiGrid
from lrr_tpu_torch.pipeline.registration import PairContext, assemble_pair_context
from lrr_tpu_torch.types import DescriptorSet, FeatureSet, KeypointSet, resolve_device

_VERSION = 1


def load_pair_context(path: str, device=None) -> PairContext:
    """The pair context on `device`; `None` means the CUDA card
    (`types.resolve_device`)."""
    device = resolve_device(device, "load_pair_context")
    with np.load(path) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"artifact version mismatch in {path}")

        def get(prefix, n):
            return [torch.from_numpy(np.asarray(z[f"{prefix}.{i}"])).to(device)
                    for i in range(n)]

        fs_m = FeatureSet(*get("mf", 6))
        fs_f = FeatureSet(*get("ff", 6))
        md, fd = get("md", 6), get("fd", 6)
        ds_m = DescriptorSet(KeypointSet(*md[:5]), md[5])
        ds_f = DescriptorSet(KeypointSet(*fd[:5]), fd[5])
        mv = VoronoiGrid(*get("mv", 3))
        fv = VoronoiGrid(*get("fv", 3))
        regions = [get(k, 1)[0].to(torch.int32) if f"{k}.0" in z else None
                   for k in ("mr", "fr")]
    for fs in (fs_m, fs_f):
        fs.mask = fs.mask.bool()
    for ds in (ds_m, ds_f):
        ds.keypoints.mask = ds.keypoints.mask.bool()
    ctx = assemble_pair_context(fs_m, fs_f, ds_m, ds_f, mv, fv)
    ctx.moving_region_labels, ctx.fixed_region_labels = regions
    return ctx

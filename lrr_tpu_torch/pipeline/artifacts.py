"""Load a stage-1 pair context saved by lrr_tpu (lrr_tpu/pipeline/artifacts.py).

The artifact is the JAX package's `save_pair_context` npz, read with numpy
alone: keys `mf.0..5`/`ff.0..5` (FeatureSet fields in order), `md.0..5`/
`fd.0..5` (keypoint fields, then descriptors), `mv.0..2`/`fv.0..2`
(VoronoiGrid) and `version`.  The derived state the file omits is rebuilt
here: the fixed->moving descriptor-NN table (kernel K2) and the baked
NN-row grids.
"""

from __future__ import annotations

import numpy as np
import torch

from lrr_tpu_torch.estimation.icp import VoronoiGrid, bake_target_grid
from lrr_tpu_torch.matching.indexing import descriptor_nn_table
from lrr_tpu_torch.pipeline.registration import PairContext
from lrr_tpu_torch.types import DescriptorSet, FeatureSet, KeypointSet

_VERSION = 1


def load_pair_context(path: str, device=None) -> PairContext:
    """The pair context on `device`.  `None` means the CUDA card: it raises
    where there is none and never carries on on the CPU by itself (a caller
    that wants the CPU, as the tests do, says "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_pair_context: no CUDA device; lrr_tpu_torch runs on the GPU "
                'unless the caller asks for the CPU (pass device="cpu")'
            )
        device = "cuda"
    device = torch.device(device)
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
    for fs in (fs_m, fs_f):
        fs.mask = fs.mask.bool()
    for ds in (ds_m, ds_f):
        ds.keypoints.mask = ds.keypoints.mask.bool()
    return PairContext(
        moving_features=fs_m,
        fixed_features=fs_f,
        moving_descriptors=ds_m,
        fixed_descriptors=ds_f,
        moving_vor=mv,
        fixed_vor=fv,
        nn_table=descriptor_nn_table(ds_f, ds_m),
        fixed_grid=bake_target_grid(fs_f, fv),
        moving_grid=bake_target_grid(fs_m, mv),
    )

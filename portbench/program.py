"""The system under test, `lrr_tpu_torch`, as the benchmark drives it: its
entry points, and what the benchmark reads of it (outputs, counters, kernel
names).  The only module of the benchmark besides the drivers that imports
the program; it imports it lazily, so the harness can say what is missing
before it does.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

K1_KERNEL = "normal_equations_sym_kernel"
K3_KERNEL = "pinv_sym_kernel"


def pipeline_config(d: dict):
    from lrr_tpu_torch.config import pipeline_config_from_dict

    return pipeline_config_from_dict(d)


def verifier(path: str):
    """The verifier file, parsed by the program (an input both sides read)."""
    from lrr_tpu_torch.verify.svm import parse_libsvm_model

    with open(path) as f:
        return parse_libsvm_model(f.read())


def volume(data: torch.Tensor, spacing_xyz):
    from lrr_tpu_torch.types import Volume

    dev = data.device
    return Volume(data=data, origin=torch.zeros(3, dtype=torch.float32, device=dev),
                  spacing=torch.tensor(spacing_xyz, dtype=torch.float32, device=dev))


def sampling_plan(fields: dict):
    from lrr_tpu_torch.sampling import SamplingPlan

    return SamplingPlan(**fields)


def registration():
    from lrr_tpu_torch.pipeline import registration as reg

    return reg


def wave_stats() -> dict:
    from lrr_tpu_torch.pipeline import wave_graph

    return wave_graph.stats()


def drop_graphs() -> None:
    from lrr_tpu_torch.pipeline import wave_graph

    wave_graph.drop()


def kernel_counts() -> tuple:
    """(K1_SHAPES, PINV_SHAPES) copies: launches by shape."""
    from lrr_tpu_torch.ops import kernels

    return dict(kernels.K1_SHAPES), dict(kernels.PINV_SHAPES)


# what a check keeps of a LocationResult: PASS 1 and the refined lanes
RESULT_FIELDS = {
    "cmask": "candidate_mask", "enough": "enough_features", "angles": "initial_angle",
    "rank": "rank", "qm": "query_mapped", "kpm_xyz": "keypoint_moving",
    "kpf_xyz": "keypoint_fixed", "refined": "refined", "valid": "valid",
    "oscillated": "oscillated", "probs": "probability", "meas": "measurements",
    "selected": "selected", "covar": "covar",
}


def result_to_host(out) -> dict:
    """A `LocationResult`'s fields on the host (numpy): the request's answer."""
    h = {k: getattr(out, name).cpu().numpy() for k, name in RESULT_FIELDS.items()}
    h["A"] = out.trans.A.cpu().numpy()
    h["t"] = out.trans.t.cpu().numpy()
    h["center"] = out.trans.center.cpu().numpy()
    return h


def stage1_refs(ctx, moving, fixed) -> dict:
    """References to the stage-1 outputs a check reads, and to the pair's
    volumes (no copy, no sync): held after a request so that the rest of
    its context can be freed."""
    return {
        "kp_f": ctx.fixed_descriptors.keypoints, "kp_m": ctx.moving_descriptors.keypoints,
        "desc_f": ctx.fixed_descriptors.descriptors, "desc_m": ctx.moving_descriptors.descriptors,
        "nn": ctx.nn_table, "fs_m": ctx.moving_features, "fs_f": ctx.fixed_features,
        "maps": [(ctx.moving_vor, ctx.moving_features), (ctx.fixed_vor, ctx.fixed_features)],
        "labels_m": ctx.moving_region_labels, "labels_f": ctx.fixed_region_labels,
        "vol_m": moving.data, "vol_f": fixed.data,
    }


def stage1_outputs(refs: dict, rng: np.random.Generator, n_voxels: int) -> dict:
    """`stage1_refs` as the judge takes them (plain tensors, where they
    are), each Voronoi map also read at `n_voxels` voxels drawn from
    `rng`."""

    def kp(k):
        return {"xyz": k.xyz, "normal": k.normal, "binormal": k.binormal, "mask": k.mask}

    def fs(f):
        return {"xyz": f.xyz, "strength": f.strength, "shape": f.shape,
                "projector": f.projector, "directions": f.directions, "mask": f.mask}

    vor = []
    for grid, f in refs["maps"]:
        shape = np.asarray(grid.index_vol.shape)
        vox = (rng.random((n_voxels, 3)) * shape).astype(np.int64)
        v = torch.as_tensor(vox, device=grid.index_vol.device)
        vor.append({"vox_zyx": vox, "index": grid.index_vol[v[:, 0], v[:, 1], v[:, 2]],
                    "origin": grid.origin, "spacing": grid.spacing, "xyz": f.xyz,
                    "mask": f.mask})
    (mv, _), (fv, _) = refs["maps"]
    idx, dist = refs["nn"]
    return {"kp_f": kp(refs["kp_f"]), "kp_m": kp(refs["kp_m"]), "desc_f": refs["desc_f"],
            "desc_m": refs["desc_m"], "nn_idx": idx, "nn_dist": dist, "voronoi": vor,
            "fs_m": fs(refs["fs_m"]), "fs_f": fs(refs["fs_f"]),
            "vor_m": {"index": mv.index_vol, "origin": mv.origin, "spacing": mv.spacing},
            "vor_f": {"index": fv.index_vol, "origin": fv.origin, "spacing": fv.spacing},
            "labels_m": refs["labels_m"], "labels_f": refs["labels_f"],
            "vol_m": refs["vol_m"], "vol_f": refs["vol_f"]}


class Tracer:
    """Spans from the benchmark's side of the program's calls: each span
    ends in a synchronise, so it holds the device work it started.  Off
    (`enabled` False), it records nothing and adds nothing; on, it also
    wraps stage-1's Voronoi build, the lane padding and the wave runner of
    `registration` for the run's length."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.spans: dict[str, float] = {}
        self.waves: list[tuple[int, int]] = []  # (real lanes, bucket) a wave
        self._undo = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
            self._sync()
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def take(self) -> dict[str, float]:
        out, self.spans = self.spans, {}
        return out

    def install(self) -> None:
        if not self.enabled:
            return
        reg = registration()
        tracer = self

        def patch(name, wrap):
            orig = getattr(reg, name)
            setattr(reg, name, wrap(orig))
            self._undo.append((name, orig))

        def voronoi(orig):
            def call(*a, **k):
                with tracer.span("build_feature_voronoi"):
                    return orig(*a, **k)
            return call

        def pad_lanes(orig):
            def call(lanes, cand_idx, n=1):
                out = orig(lanes, cand_idx, n)
                tracer.waves.append((int(lanes.numel()), int(out[0].numel())))
                return out
            return call

        def wave_runner(orig):
            def make(*a, **k):
                run = orig(*a, **k)

                def traced(*ra):
                    with tracer.span("wave"):
                        return run(*ra)
                return traced
            return make

        patch("build_feature_voronoi", voronoi)
        patch("pad_lanes", pad_lanes)
        patch("_wave_runner", wave_runner)

    def uninstall(self) -> None:
        reg = registration()
        for name, orig in reversed(self._undo):
            setattr(reg, name, orig)
        self._undo = []

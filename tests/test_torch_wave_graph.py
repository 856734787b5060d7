"""What the captured-graph serving path of the port rests on, on the CPU:
the ICP's levels read back every `ITERATIONS_PER_CHECK` iterations give the
per-iteration loop's bits, a wave padded to lrr_tpu's lane bucket gives the
unpadded wave's bits in its real lanes, `linspace_f32` is made on the device
it is asked for, the kernel counters move by deltas, and the graph path
refuses a context that is not on a CUDA device.  The graphs themselves run
only on the card (tests/test_torch_gpu.py)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lrr_tpu_torch.config import pipeline_config_from_dict
from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.models.affine import pinv_hermitian
from lrr_tpu_torch.ops import kernels, robust
from lrr_tpu_torch.pipeline import registration, wave_graph
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.sampling import draw_sampling_plan
from lrr_tpu_torch.verify.svm import (
    load_default_verifier,
    predict_probability,
    scale_measurements,
)

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_pair_small")


@pytest.fixture(scope="module")
def small():
    """The small context on the CPU, a plan, PASS 1 and the usable lanes.
    `max_iterations` is raised from the fixture's 12 so that lanes stop at
    different iterations and levels rather than all at the cap."""
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    cfg = dataclasses.replace(cfg, estimation=dataclasses.replace(cfg.estimation,
                                                                  max_iterations=40))
    ctx = load_pair_context(SMALL + ".npz", device="cpu")
    queries = torch.as_tensor(np.asarray(meta["queries"], np.float32))
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), len(queries), cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    cmask, inits, _, enough, *_ = registration._pass1_fn(ctx, queries, cfg, plan)
    usable = (cmask & enough).nonzero()
    return dict(ctx=ctx, cfg=cfg, queries=queries, plan=plan, inits=inits,
                lanes=usable[:, 0], cands=usable[:, 1], svm=load_default_verifier())


def _refine(S, callback=None):
    ctx, cfg = S["ctx"], S["cfg"]
    lanes, cands, inits = S["lanes"], S["cands"], S["inits"]
    init = icp.Affine3D(inits.A[lanes, cands], inits.t[lanes, cands],
                        inits.center[lanes, cands])
    m_sel, f_sel, *_ = registration._candidate_rois(ctx, init, S["queries"][lanes], cfg)
    moving, fixed = registration._roi_sets(ctx, m_sel, f_sel)
    return icp.register_candidate(
        moving, fixed, ctx.fixed_vor, ctx.moving_vor, init, cfg.estimation,
        S["plan"].select(lanes, cands).icp(),
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features,
        progress_callback=callback,
    )


@pytest.fixture(scope="module")
def per_iteration(small):
    """The loop that reads every iteration back (a progress callback keeps
    it so) and the iterations its lanes ran."""
    seen = []
    return _refine(small, lambda it, we, n: seen.append((it, n))), seen


@pytest.mark.parametrize("chunk", [1, 2, 5, 8])
def test_chunked_levels_equal_the_per_iteration_loop(small, per_iteration, chunk, monkeypatch):
    want, seen = per_iteration
    # lanes stop at different iterations, every level runs, and at some
    # iteration lanes run on different levels
    assert len(set(want.iterations.tolist())) > 2
    assert len({n for _, n in seen}) == len(icp._staged_caps(small["cfg"].estimation))
    levels_at = {}
    for it, n in seen:
        levels_at.setdefault(it, set()).add(n)
    assert any(len(ns) > 1 for ns in levels_at.values())
    monkeypatch.setattr(icp, "ITERATIONS_PER_CHECK", chunk)
    assert wave_graph.first_difference(_refine(small), want) is None


@pytest.mark.parametrize("m", [5, 9])
def test_padded_wave_equals_the_unpadded_wave(small, m):
    S = small
    lanes, cands = S["lanes"][:m], S["cands"][:m]
    B = registration.pad_bucket(m)
    assert B > m
    pad_l, pad_c = registration.pad_lanes(lanes, cands)
    assert torch.equal(pad_l[m:], lanes[:1].expand(B - m))
    assert torch.equal(pad_c[m:], cands[:1].expand(B - m))
    args = (S["ctx"], S["queries"], S["cfg"], S["svm"], S["inits"], S["plan"])
    want = registration._wave_fn(*args, lanes, cands)
    got = registration._wave_fn(*args, pad_l, pad_c)
    assert got.shape == (B,) + want.shape[1:]
    assert torch.equal(got[:m], want)
    assert torch.equal(got[m:], want[:1].expand(B - m, -1))  # the padding repeats lane 0


def _wave_args(S, m):
    return (S["ctx"], S["queries"], S["cfg"], S["svm"], S["inits"], S["plan"],
            S["lanes"][:m], S["cands"][:m])


def test_wave_steps_equal_the_refinement_and_its_measurements(small):
    """`_wave_fn` (inputs, prologue, levels, epilogue) gives the bits of
    `register_candidate` followed by the measurements and the SVM."""
    ctx, queries, cfg, svm, inits, plan, lanes, cands = _wave_args(small, 9)
    init = icp.Affine3D(inits.A[lanes, cands], inits.t[lanes, cands], inits.center[lanes, cands])
    m_sel, f_sel, mlo, flo, _, _ = registration._candidate_rois(ctx, init, queries[lanes], cfg)
    moving, fixed = registration._roi_sets(ctx, m_sel, f_sel)
    lane_plan = plan.select(lanes, cands)
    res = icp.register_candidate(
        moving, fixed, ctx.fixed_vor, ctx.moving_vor, init, cfg.estimation, lane_plan.icp(),
        moving_targets=ctx.moving_features, fixed_targets=ctx.fixed_features,
    )
    meas = registration._measure(ctx, res, moving, fixed, mlo, flo, cfg, lane_plan)
    want = registration._pack_wave(res, meas, predict_probability(svm, scale_measurements(meas)))
    got = registration._wave_fn(ctx, queries, cfg, svm, inits, plan, lanes, cands)
    assert wave_graph.first_difference(got, want) is None


def test_graph_parts_run_eagerly_give_the_wave_bits(small):
    """The parts a bucket captures (prologue, one chunk a level read back as
    `WaveGraphs.run` reads it, epilogue), run eagerly on the CPU on static
    inputs that a second wave was copied into, give `_wave_fn`'s rows."""
    ctx, queries, cfg, svm, inits, plan, lanes, cands = _wave_args(small, 8)
    steps = registration.WAVE_STEPS
    g = object.__new__(wave_graph.WaveGraphs)  # its parts only: no stream, no capture
    g.ctx, g.cfg, g.svm, g.steps = ctx, cfg, svm, steps
    b = wave_graph._Bucket(steps.inputs(queries, inits, plan, lanes.flip(0), cands.flip(0)))
    wave_graph._copy_into(b.inputs, steps.inputs(queries, inits, plan, lanes, cands))
    b.flags = torch.zeros(len(icp._staged_caps(cfg.estimation)), dtype=torch.bool)
    g._prologue(b)
    flags, k, chunks = [True] * b.flags.numel(), 0, 0
    while k < len(flags):
        if not flags[k]:
            k += 1
            continue
        g._chunk(b, k)
        flags, chunks = b.flags.tolist(), chunks + 1
    got = g._epilogue(b)
    want = registration._wave_fn(ctx, queries, cfg, svm, inits, plan, lanes, cands)
    assert chunks > len(flags)  # some level ran more than one chunk
    assert wave_graph.first_difference(got, want) is None


def test_first_difference_names_the_field():
    a = icp.Affine3D(torch.eye(3)[None], torch.zeros(1, 3), torch.ones(1, 3))
    assert wave_graph.first_difference(a, icp.Affine3D(a.A.clone(), a.t.clone(),
                                                        a.center.clone())) is None
    assert wave_graph.first_difference(a, icp.Affine3D(a.A, -a.t, a.center)) == "t"  # -0.0
    assert wave_graph.first_difference((a, None), (a, None)) is None
    assert wave_graph.first_difference((a, a.A), (a, a.A.double())) == "1"
    nan = torch.tensor([float("nan")])
    assert wave_graph.first_difference(nan, nan.clone()) is None  # the same bits


def _lrr_tpu_bucket(m: int, n_dev: int) -> int:
    """lrr_tpu/pipeline/registration.py::pad_lanes's bucket, as written there."""
    bucket = max(8, 1 << int(np.ceil(np.log2(max(m, 1)))))
    bucket = max(bucket, n_dev) // n_dev * n_dev
    if bucket < m:
        bucket = -(-m // n_dev) * n_dev
    return bucket


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 33, 64])
def test_bucket_sizes_follow_lrr_tpu(m, n):
    assert registration.pad_bucket(m, n) == _lrr_tpu_bucket(m, n)


@pytest.mark.parametrize("start,stop,num", [(0.1, 0.9, 41), (0.0, 1.0, 7), (0.25, 0.75, 1),
                                            (-1.5, 2.5, 100)])
def test_linspace_f32_keeps_its_bits(start, stop, num):
    got = robust.linspace_f32(start, stop, num)
    want = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert robust.linspace_f32(start, stop, num) is got  # made once, then shared


class _Devices(TorchDispatchMode):
    """Records the device of every tensor an operation makes."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


def test_linspace_f32_builds_no_cpu_tensor_for_another_device():
    with _Devices() as seen:
        out = robust.linspace_f32(0.1, 0.9, 41, device="meta")
    assert out.device.type == "meta" and out.shape == (41,)
    assert seen.devices == {"meta"}


def test_kernel_counters_move_by_deltas():
    kernels.reset_launch_counts()
    before = kernels.counts()
    kernels.LAUNCHES["normal_equations"] += 3
    kernels.K1_SHAPES[(8, 512, 512)] = 3
    kernels.PINV_SHAPES[(8, 12)] = 2
    delta = kernels.counts_since(before)
    assert delta == ({"normal_equations": 3}, {(8, 512, 512): 3}, {}, {(8, 12): 2}, {}, {}, {})
    kernels.add_counts(delta, -1)  # what a capture counted is taken back
    assert kernels.counts() == before
    kernels.add_counts(delta, 2)  # two replays
    assert kernels.LAUNCHES["normal_equations"] == 6 and kernels.PINV_SHAPES == {(8, 12): 4}
    kernels.reset_launch_counts()


def test_voronoi_shapes_survive_the_counter_round_trip():
    """`VORONOI_SHAPES` moves through `counts()` -> `counts_since()` ->
    `add_counts()` as the other logs do, the way a capture's launches are
    taken back and its replays counted."""
    kernels.reset_launch_counts()
    kernels.VORONOI_SHAPES[(320, 352, 352, 65536)] = 1
    kernels.LAUNCHES["voronoi"] = 1
    before = kernels.counts()
    assert before[4] == {(320, 352, 352, 65536): 1}
    kernels.LAUNCHES["voronoi"] += 2
    kernels.VORONOI_SHAPES[(320, 352, 352, 65536)] += 1
    kernels.VORONOI_SHAPES[(64, 64, 64, 4096)] = 1
    delta = kernels.counts_since(before)
    assert delta == ({"voronoi": 2}, {}, {}, {},
                     {(320, 352, 352, 65536): 1, (64, 64, 64, 4096): 1}, {}, {})
    kernels.add_counts(delta, -1)
    assert kernels.counts() == before
    kernels.add_counts(delta, 3)
    assert kernels.LAUNCHES["voronoi"] == 7
    assert kernels.VORONOI_SHAPES == {(320, 352, 352, 65536): 4, (64, 64, 64, 4096): 3}
    kernels.reset_launch_counts()
    assert kernels.counts()[4] == {} and kernels.LAUNCHES["voronoi"] == 0


def test_pinv_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.standard_normal((5, 12, 30)), dtype=torch.float32)
    a = g @ g.transpose(1, 2)
    a[1, :, 3] = 0.0
    a[1, 3, :] = 0.0  # rank-deficient
    a[2, 4, 5] = float("nan")
    n0 = dict(kernels.LAUNCHES)
    got = pinv_hermitian(a)
    np.testing.assert_array_equal(got.numpy(), kernels.pinv_hermitian_plain(a).numpy())
    assert bool(torch.isnan(got[2]).all()) and bool(torch.isfinite(got[[0, 1, 3, 4]]).all())
    assert kernels.LAUNCHES == n0  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.pinv_hermitian_small(a.to("meta"))


def test_graph_path_refuses_a_cpu_context(small, monkeypatch):
    S = small
    calls = []

    def eager_wave(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("eager wave")

    monkeypatch.setattr(registration, "_wave_fn", eager_wave)
    with pytest.raises(ValueError, match="CUDA device"):
        wave_graph.wave_graphs(S["ctx"], S["cfg"], S["svm"], registration.WAVE_STEPS)
    assert not calls  # it raised without running the wave eagerly
    # the CPU's own runner is the eager wave
    run = registration._wave_runner(S["ctx"], S["cfg"], S["svm"])
    with pytest.raises(RuntimeError, match="eager wave"):
        run(S["queries"], S["inits"], S["plan"], S["lanes"][:1], S["cands"][:1])
    assert len(calls) == 1

"""The port's trace (`lrr_tpu_torch/utils/timers.py`) on the CPU: spans nest
with their parent and request ids, `drain` hands the buffer over and empties
it, a trace that is off records and annotates nothing, a trace without an
annotation prefix opens no profiler range, and the serving entry point
gives the same bits with the trace on and off while its spans and the ICP
counters say what ran."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lrr_tpu_torch.config import (
    DescriptorConfig,
    FeatureConfig,
    KeypointConfig,
    PipelineConfig,
    pipeline_config_from_dict,
)
from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.pipeline import registration, wave_graph
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.sampling import draw_sampling_plan
from lrr_tpu_torch.utils import timers
from lrr_tpu_torch.utils.synthetic import make_pair
from lrr_tpu_torch.verify.svm import load_default_verifier

SMALL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_pair_small")


@pytest.fixture(autouse=True)
def trace_left_off():
    timers.trace_off()
    timers.drain()
    yield
    timers.trace_off()
    timers.drain()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parent_and_request_ids():
    timers.trace_on()
    with timers.span("a", lanes=8, part="chunk"):
        with timers.span("b"):
            pass
        with timers.span("c"):
            with timers.span("d"):
                pass
    with timers.span("e"):
        pass
    got = timers.drain().spans
    assert [s.name for s in got] == ["b", "d", "c", "a", "e"]  # in the order they closed
    s = {x.name: x for x in got}
    assert s["a"].parent == 0 and s["a"].request == s["a"].id
    assert s["a"].attrs == {"lanes": 8, "part": "chunk"} and s["b"].attrs == {}
    assert s["b"].parent == s["c"].parent == s["a"].id and s["d"].parent == s["c"].id
    assert {x.request for x in got if x.name != "e"} == {s["a"].id}
    assert s["e"].parent == 0 and s["e"].request == s["e"].id != s["a"].id
    assert len({x.id for x in got}) == 5
    for x in got:
        assert x.start_ns <= x.end_ns
        if x.parent:
            p = next(y for y in got if y.id == x.parent)
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_a_request_scope_gives_its_spans_its_id():
    timers.trace_on()
    with timers.request(41):
        with timers.span("a"):
            with timers.span("b"):
                pass
        with timers.request("inner"):
            with timers.span("c"):
                pass
        with timers.span("d"):
            pass
    with timers.span("e"):
        pass
    s = {x.name: x for x in timers.drain().spans}
    assert s["a"].request == s["b"].request == s["d"].request == 41
    assert s["c"].request == "inner"
    assert s["e"].request == s["e"].id  # outside a scope: the root's id


def test_drain_hands_over_and_empties_the_buffer():
    timers.trace_on()
    with timers.span("a"):
        timers.count("x", 3)
    timers.count("x", 4)
    timers.count("y")
    first = timers.drain()
    assert [s.name for s in first.spans] == ["a"]
    assert first.counters == {"x": 7, "y": 1} and first.dropped == 0
    second = timers.drain()
    assert second.spans == [] and second.counters == {} and second.dropped == 0
    with timers.span("b"):
        pass
    assert [s.name for s in timers.drain().spans] == ["b"]


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(timers, "SPAN_CAPACITY", 2)
    timers.trace_on()
    for name in "abcd":
        with timers.span(name):
            pass
    got = timers.drain()
    assert [s.name for s in got.spans] == ["a", "b"] and got.dropped == 2
    assert timers.drain().dropped == 0


def test_a_trace_that_is_off_records_and_annotates_nothing():
    timers.trace_on(annotate="lrr_test.")
    timers.trace_off()
    assert timers.span("a") is timers.span("b", lanes=3) is timers.request(1)  # one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timers.request(1), timers.span("a", lanes=3):
            torch.ones(4) + 1
            timers.count("x", 5)
    names = [e.name for e in prof.events()]
    assert "aten::add" in names
    assert not [n for n in names if n.startswith("lrr_test.")]
    got = timers.drain()
    assert got.spans == [] and got.counters == {} and not timers.enabled()


def test_annotated_spans_are_profiler_ranges():
    timers.trace_on(annotate="lrr_test.")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timers.span("outer"):
            with timers.span("inner"):
                torch.ones(4) + 1
    names = [e.name for e in prof.events()]
    assert names.count("lrr_test.outer") == names.count("lrr_test.inner") == 1
    assert [s.name for s in timers.drain().spans] == ["inner", "outer"]


def test_a_trace_without_a_prefix_opens_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    timers.trace_on(annotate=None)
    with timers.span("a"):
        with timers.span("b"):
            pass
    assert [s.name for s in timers.drain().spans] == ["b", "a"]


def test_packed_rows_carry_the_iterations():
    L = 3
    res = icp.ICPResult(
        trans=Affine3D(torch.eye(3).expand(L, 3, 3), torch.zeros(L, 3), torch.ones(L, 3)),
        covar=torch.zeros(L, 12, 12), converged=torch.tensor([True, False, True]),
        valid=torch.ones(L, dtype=torch.bool), oscillated=torch.zeros(L, dtype=torch.bool),
        iterations=torch.tensor([1, 37, (1 << 24) - 1]), weighted_error=torch.zeros(L),
        weighted_error_backward=torch.zeros(L), sheet_angles=torch.zeros(L),
        tube_angles=torch.zeros(L), sheet_angles_backward=torch.zeros(L),
        tube_angles_backward=torch.zeros(L), number_matches=torch.zeros(L, dtype=torch.long),
        initial_rms=torch.zeros(L), final_rms=torch.zeros(L),
    )
    rows = registration._pack_wave(res, torch.zeros(L, 8), torch.zeros(L))
    assert rows.shape == (L, 174) and rows.dtype == torch.float32
    h = registration._unpack_wave(rows.numpy())
    assert h["iterations"].astype(np.int64).tolist() == [1, 37, (1 << 24) - 1]
    assert h["converged"].tolist() == [True, False, True]


@pytest.fixture(scope="module")
def staged():
    """The small context served twice by `register_locations_staged`: with
    the trace off, then on inside a request scope, the rows of every wave
    kept as the host unpacked them.  `max_iterations` is raised from the
    fixture's 12 so that lanes stop at different iterations, and nothing
    verifies (`accept_override` above 1), so that every usable candidate is
    refined, over several waves."""
    with open(SMALL + ".json") as f:
        meta = json.load(f)
    cfg = pipeline_config_from_dict(meta["config"])
    cfg = dataclasses.replace(cfg, estimation=dataclasses.replace(cfg.estimation,
                                                                  max_iterations=40))
    ctx = load_pair_context(SMALL + ".npz", device="cpu")
    queries = torch.as_tensor(np.asarray(meta["queries"], np.float32))
    plan = draw_sampling_plan(torch.Generator().manual_seed(5), len(queries), cfg,
                              ctx.moving_features.capacity, ctx.fixed_features.capacity)
    svm = load_default_verifier()

    def serve():
        return registration.register_locations_staged(ctx, queries, cfg, svm, plan,
                                                      lane_budget=4, accept_override=1.5)

    rows = []
    unpack = registration._unpack_wave
    with pytest.MonkeyPatch.context() as m:
        m.setattr(registration, "_unpack_wave", lambda r: rows.append(r) or unpack(r))
        timers.trace_off()
        off = serve()
        del rows[:]
        timers.trace_on(annotate="lrr_test.")
        with timers.request(5):
            on = serve()
        drained = timers.drain()
        timers.trace_off()
    return dict(off=off, on=on, rows=rows, trace=drained, queries=len(queries),
                candidates=cfg.indexing.num_candidates, max_iterations=40)


def test_staged_gives_the_same_bits_with_the_trace_on_and_off(staged):
    assert wave_graph.first_difference(staged["on"], staged["off"]) is None


def test_staged_spans_hold_pass1_each_wave_and_the_result(staged):
    spans = staged["trace"].spans
    assert staged["trace"].dropped == 0
    assert {s.request for s in spans} == {5}
    names = by_name(spans)
    (root,) = names["staged"]
    assert root.parent == 0
    assert root.attrs == {"queries": staged["queries"], "candidates": staged["candidates"]}
    (pass1,), (result,), waves = names["staged.pass1"], names["staged.result"], names["staged.wave"]
    assert len(waves) == len(staged["rows"]) >= 2
    for s in [pass1, result, *waves]:
        assert s.parent == root.id
    assert pass1.end_ns <= min(w.start_ns for w in waves)
    assert max(w.end_ns for w in waves) <= result.start_ns
    for w, r in zip(sorted(waves, key=lambda s: s.start_ns), staged["rows"]):
        assert w.attrs == {"bucket": registration.pad_bucket(len(r)), "lanes": len(r)}
    assert set(names) == {"staged", "staged.pass1", "staged.wave", "staged.result"}  # CPU: eager


def test_lane_iterations_are_the_refined_lanes_iterations(staged):
    iters = np.concatenate([registration._unpack_wave(r)["iterations"] for r in staged["rows"]])
    assert iters.min() >= 1 and iters.max() <= staged["max_iterations"]
    assert len(np.unique(iters)) > 1
    assert staged["trace"].counters["icp.lane_iterations"] == int(iters.sum())
    assert int(staged["on"].refined.sum()) == len(iters)


def test_lane_iterations_fit_in_the_lane_slots(staged):
    c = staged["trace"].counters
    lanes = sum(len(r) for r in staged["rows"])
    assert lanes < c["icp.lane_iterations"] <= c["icp.lane_slots"]
    assert (c["icp.lane_slots"] - lanes) % icp.ITERATIONS_PER_CHECK == 0


def test_stage1_spans_nest_under_prepare_and_segment():
    fixed, moving, _ = make_pair((24, 24, 24), seed=3, device="cpu")
    cfg = PipelineConfig(features=FeatureConfig(max_features=256, contrast_radius_mm=100.0),
                         keypoints=KeypointConfig(max_keypoints=32),
                         descriptors=DescriptorConfig(min_neighbors=20, max_neighbors=128))
    timers.trace_on()
    ctx = registration.segment_pair(moving, fixed, registration.prepare_pair(moving, fixed, cfg))
    spans = timers.drain().spans
    assert ctx.moving_region_labels is not None
    names = by_name(spans)
    (prep,), (seg,) = names["stage1.prepare_pair"], names["stage1.segment_pair"]
    assert prep.parent == seg.parent == 0
    for n in ("stage1.features", "stage1.keypoints", "stage1.descriptors", "stage1.voronoi"):
        assert sorted(s.attrs["volume"] for s in names[n]) == ["fixed", "moving"]
        assert {s.parent for s in names[n]} == {prep.id}
    assert [s.parent for s in names["stage1.nn_table"]] == [prep.id]
    assert "stage1.grids" not in names  # no NN-row grid is baked
    assert sorted(s.attrs["volume"] for s in names["stage1.watershed"]) == ["fixed", "moving"]
    assert {s.parent for s in names["stage1.watershed"]} == {seg.id}
    assert [s.parent for s in names["stage1.regions"]] == [seg.id]

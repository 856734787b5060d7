"""Whole runs of the harness at test size on the CPU: test-size cells added
by new files only run and come out correct; the control and each fault the
cells can have come out not correct."""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from portbench import run

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's may be


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["tiny.pair", "tiny.serve"])
def test_cell_added_by_files_runs_correct(tiny_root, cell):
    line, notes = run.run_cell(tiny_root, cell, SEED, 1.0, True, CPU)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert all(v[1] is not None for v in line["checks"].values())
    # what a CPU run can read: spans and counters, never a device metric
    want = {"stage1_s.pair", "voronoi_s.pair"} if cell == "tiny.pair" else {"lane_fill.batch"}
    assert want <= set(line["metrics"])
    assert not any(k.startswith(("device_", "k1_", "k3_")) for k in line["metrics"])
    assert notes[-1].startswith("check ")


def test_untraced_run_reports_the_cells_end_to_end_metrics(tiny_root):
    line, _ = run.run_cell(tiny_root, "tiny.serve", SEED + 1, 1.0, False, CPU)
    assert set(line["metrics"]) == {"setup_s", "locations_per_s"}
    assert line["metrics"]["locations_per_s"]["value"] > 0


def test_control_comes_out_not_correct(tiny_root):
    line, _ = run.run_cell(tiny_root, "tiny.serve", SEED, 1.0, False, CPU, control=True)
    assert not line["correct"]
    failed = {k for k, (v, lim) in line["checks"].items() if v > lim}
    # the stages the reference recomputes in full, the waves among them
    assert {"nn_gap", "desc_gap_q90", "label_miss", "lane_T_q90", "lane_cov_q90",
            "lane_meas_q90"} <= failed, line["checks"]


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _state_unchanged(orig):
    def body(self, cap, use_muse, c):
        new = orig(self, cap, use_muse, c)
        return dataclasses.replace(new, trans=c.trans)  # the step leaves the transform
    return body


def _half_the_lanes(orig):
    def make(*a, **k):
        run_ = orig(*a, **k)

        def half(queries, inits, plan, lanes, cand_idx):
            n = lanes.numel()
            h = max(1, n // 2)
            rows = run_(queries, inits, plan, lanes[:h], cand_idx[:h])
            return torch.cat([rows, rows[: n - h]])  # the rest from the half computed
        return half
    return make


def _answer_altered(orig):
    def epilogue(*a, **k):
        rows = orig(*a, **k).clone()
        rows[:, 9:12] += 3.0  # every lane's translation 3 mm off where it is produced
        return rows
    return epilogue


FAULTS = ["state_unchanged", "half_the_lanes", "answer_altered"]


@contextlib.contextmanager
def fault_patched(fault: str):
    """The program with one fault planted where it computes: an ICP step
    that leaves its transform as it was; half of each wave's lanes left out
    and the rest filled from the half computed; every lane's translation
    3 mm off where the wave produces it (eagerly, and in the steps a wave's
    graphs capture)."""
    from lrr_tpu_torch.estimation import icp
    from lrr_tpu_torch.pipeline import registration

    if fault == "state_unchanged":
        with patched(icp.Refinement, "body", _state_unchanged):
            yield
    elif fault == "half_the_lanes":
        with patched(registration, "_wave_runner", _half_the_lanes):
            yield
    else:
        steps = registration.WAVE_STEPS
        with patched(registration, "_wave_epilogue", _answer_altered), \
                patched(registration, "WAVE_STEPS",
                        lambda s: s._replace(epilogue=_answer_altered(s.epilogue))):
            yield
        assert registration.WAVE_STEPS is steps


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_comes_out_not_correct(tiny_root, fault):
    with fault_patched(fault):
        line, _ = run.run_cell(tiny_root, "tiny.serve", SEED, 1.0, False, CPU)
    assert not line["correct"], line["checks"]

"""Stage 1 on the CPU gives the same bits in every process.

On the CPU `torch.sqrt` runs MKL's VML in 2,048-element blocks, one per
worker thread, and on its first call in a process one worker's block has
come back 4,400-5,100 ulp off (a square-root estimate), so a fresh process
could classify other features.  The port's square roots on stage 1 go
through `ops.ieee.sqrt`, the IEEE instruction: the correctly rounded result,
which is the float64 square root rounded once to float32.

The input is the first `_nms_classify` call of `detect_features` on the
bench-scale moving volume (64^3, seed 23: the pair where the drift showed),
16,384 candidates.  Fresh processes with 8 torch threads each make that call
as their first stage-1 work, four at a time; every one must give the bits of
the others and of the float64-rounded computation made here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lrr_tpu_torch.config import FeatureConfig
from lrr_tpu_torch.features import extract
from lrr_tpu_torch.ops import eig3, ieee
from lrr_tpu_torch.types import CORNER, SHEET, TUBE
from lrr_tpu_torch.utils.synthetic import make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 16
AT_ONCE = 4
THREADS = 8
ARGS = ("score", "outer6", "cand_idx", "cand_score")
OUTS = ("w", "V", "num_maxima", "shape", "dirs")

CHILD = """
import sys
import numpy as np
import torch
torch.set_num_threads({threads})
from lrr_tpu_torch.features import extract
inp = np.load(sys.argv[1])
eigs = []
eigh3 = extract.eigh3
def recorded(S):
    out = eigh3(S)
    eigs.append(out)
    return out
extract.eigh3 = recorded
nm, shape, dirs = extract._nms_classify(*(torch.from_numpy(inp[k]) for k in {args!r}))
w, V = eigs[0]
np.savez(sys.argv[2], w=w.numpy(), V=V.numpy(), num_maxima=nm.numpy(), shape=shape.numpy(),
         dirs=dirs.numpy())
"""


class _Captured(Exception):
    pass


def _first_nms_inputs() -> dict[str, np.ndarray]:
    """The arguments of the first `_nms_classify` call of `detect_features`
    on the bench pair's moving volume (detection stops there)."""
    _, moving, _ = make_pair((64, 64, 64), rotation_deg=6.0, translation=(3.0, -2.0, 1.5),
                             seed=23, device="cpu")
    got = {}
    nms = extract._nms_classify

    def capture(*args):
        got.update({k: a.numpy().copy() for k, a in zip(ARGS, args)})
        raise _Captured

    extract._nms_classify = capture
    try:
        extract.detect_features(moving, FeatureConfig(max_features=8192, contrast_radius_mm=100.0))
    except _Captured:
        pass
    finally:
        extract._nms_classify = nms
    return got


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal dtype, shape and bytes (a NaN eigenvalue of a zero candidate
    row equals itself here)."""
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def _float64_rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.sqrt(x.numpy().astype(np.float64)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the float64-rounded outputs, each fresh process's outputs)."""
    tmp = tmp_path_factory.mktemp("determinism")
    inputs = _first_nms_inputs()
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)

    # the reference: every square root of the same call in float64, rounded once
    mp = pytest.MonkeyPatch()
    eigs = []
    eigh3 = extract.eigh3

    def recorded(S):
        eigs.append(eigh3(S))
        return eigs[-1]

    mp.setattr(ieee, "sqrt", _float64_rounded_sqrt)
    mp.setattr(extract, "eigh3", recorded)
    try:
        nm, shape, dirs = extract._nms_classify(*(torch.from_numpy(inputs[k]) for k in ARGS))
    finally:
        mp.undo()
    want = {"w": eigs[0][0].numpy(), "V": eigs[0][1].numpy(), "num_maxima": nm.numpy(),
            "shape": shape.numpy(), "dirs": dirs.numpy()}

    code = CHILD.format(threads=THREADS, args=ARGS)
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": str(THREADS)}
    outs = []
    for first in range(0, PROCESSES, AT_ONCE):
        batch = []
        for i in range(first, min(first + AT_ONCE, PROCESSES)):
            out = str(tmp / f"out{i}.npz")
            batch.append((out, subprocess.Popen([sys.executable, "-c", code, path, out],
                                                cwd=ROOT, env=env)))
        for out, proc in batch:
            assert proc.wait(timeout=300) == 0
            with np.load(out) as z:
                outs.append({k: z[k] for k in OUTS})
    return inputs, want, outs


def test_the_input_is_the_drift_case(runs):
    inputs, want, _ = runs
    assert inputs["cand_idx"].shape == (16384, 3)
    # every class occurs, so the NMS directions decide something
    assert set(np.unique(want["shape"]).tolist()) == {CORNER, SHEET, TUBE}


@pytest.mark.parametrize("name", OUTS)
def test_fresh_processes_give_the_float64_rounded_bits(runs, name):
    """Each of the 16 processes' first call equals the float64-rounded
    computation bit for bit (and so every other process)."""
    _, want, outs = runs
    assert len(outs) == PROCESSES
    bad = [i for i, o in enumerate(outs) if not _same_bits(o[name], want[name])]
    assert not bad, f"{name} differs in processes {bad}"


def test_ieee_sqrt_is_float64_rounded():
    """`ieee.sqrt` against the float64 square root rounded to float32, over
    normal numbers of every exponent range, zero and a 0-d tensor; and
    `eigh3` in this process with both."""
    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal(1 << 18)).astype(np.float32) * np.exp2(
        rng.integers(-100, 100, 1 << 18)).astype(np.float32)
    x[:3] = 0.0
    t = torch.from_numpy(x)
    assert torch.equal(ieee.sqrt(t), _float64_rounded_sqrt(t))
    assert float(ieee.sqrt(torch.tensor(2.25))) == 1.5
    S = torch.from_numpy(rng.standard_normal((4096, 3, 3)).astype(np.float32))
    S = S @ S.transpose(1, 2)
    w, V = eig3.eigh3(S)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ieee, "sqrt", _float64_rounded_sqrt)
        w64, V64 = eig3.eigh3(S)
    assert _same_bits(w.numpy(), w64.numpy()) and _same_bits(V.numpy(), V64.numpy())

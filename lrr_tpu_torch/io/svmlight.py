"""LIBSVM/svmlight data file IO and feature scaling (lrr_tpu/io/svmlight.py).

The reference trains its verifier offline with the vendored libsvm CLI tools
(libsvm/svm-train.cpp, svm-predict.cpp, svm-scale.cpp) over files of
"<label> <index>:<value> ..." lines, and applies a hardcoded per-feature
linear rescale to [-1, 1] at inference (libsvm/svm_interface.cpp:44-51).
This module provides the same data format and an explicit range-file scaler
(the svm-scale model), consumed by the cli svm-train/svm-predict/svm-scale
subcommands.
"""

from __future__ import annotations

import numpy as np


def read_svmlight(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (X [n, d] float32 dense, y [n] float32).  Missing indices are
    zero; d is the largest index seen."""
    labels: list[float] = []
    rows: list[dict[int, float]] = []
    dmax = 0
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            row = {}
            for tok in parts[1:]:
                idx, val = tok.split(":")
                i = int(idx)
                row[i] = float(val)
                dmax = max(dmax, i)
            rows.append(row)
    x = np.zeros((len(rows), dmax), np.float32)
    for r, row in enumerate(rows):
        for i, v in row.items():
            x[r, i - 1] = v
    return x, np.asarray(labels, np.float32)


def write_svmlight(path: str, x: np.ndarray, y: np.ndarray):
    with open(path, "w") as f:
        for row, label in zip(np.asarray(x), np.asarray(y)):
            feats = " ".join(f"{i+1}:{v:.7g}" for i, v in enumerate(row))
            f.write(f"{label:g} {feats}\n")


def fit_scale(x: np.ndarray, lower: float = -1.0, upper: float = 1.0):
    """Per-feature linear map of the data range to [lower, upper] (what
    svm-scale fits and svm_interface.cpp hardcodes)."""
    return {
        "lower": lower,
        "upper": upper,
        "min": np.min(x, axis=0).astype(np.float64),
        "max": np.max(x, axis=0).astype(np.float64),
    }


def apply_scale(x: np.ndarray, rng: dict) -> np.ndarray:
    span = np.maximum(rng["max"] - rng["min"], 1e-30)
    t = (np.asarray(x, np.float64) - rng["min"]) / span
    return (rng["lower"] + t * (rng["upper"] - rng["lower"])).astype(np.float32)


def write_range_file(path: str, rng: dict):
    """svm-scale range-file format: header 'x', bounds line, then
    '<index> <min> <max>' per feature."""
    with open(path, "w") as f:
        f.write("x\n")
        f.write(f"{rng['lower']:.17g} {rng['upper']:.17g}\n")
        for i, (lo, hi) in enumerate(zip(rng["min"], rng["max"])):
            f.write(f"{i+1} {lo:.17g} {hi:.17g}\n")


def read_range_file(path: str) -> dict:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    assert lines[0] == "x", "only feature ('x') range files are supported"
    lower, upper = (float(v) for v in lines[1].split())
    idx, lo, hi = [], [], []
    for ln in lines[2:]:
        parts = ln.split()
        idx.append(int(parts[0]))
        lo.append(float(parts[1]))
        hi.append(float(parts[2]))
    d = max(idx)
    mn = np.zeros(d)
    mx = np.ones(d)
    for i, a, b in zip(idx, lo, hi):
        mn[i - 1] = a
        mx[i - 1] = b
    return {"lower": lower, "upper": upper, "min": mn, "max": mx}

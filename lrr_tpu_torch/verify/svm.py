"""SVM verification of candidate alignments (lrr_tpu/verify/svm.py).

A 2-class RBF C-SVC with Platt probability outputs, read from and written to
the libsvm text model format; each 8-d measurement vector is rescaled to
[-1, 1] with the reference program's hard-coded train-set min/max before
prediction.  `fit_rbf_classifier` trains the kernel-logistic stand-in;
`verify.smo.train_c_svc` is the C-SVC solver.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from lrr_tpu_torch.types import no_tf32, resolve_device

# Hard-coded measurement scaling (itkLocationRegistration.cxx:2107-2109).
REFERENCE_FEATURE_MIN = np.array(
    [0.823246, 0.17355, 13.5656, 14.8583, 0.776814, 0.124, 10.3695, 13.049],
    np.float32,
)
REFERENCE_FEATURE_MAX = np.array(
    [16.1025, 139.276, 62.7776, 63.5239, 1.64664, 60.897, 59.8739, 60.8141],
    np.float32,
)


@dataclasses.dataclass
class SvmModel:
    """2-class RBF classifier with probability outputs."""

    gamma: float
    rho: float
    sv: torch.Tensor  # [N, D]
    sv_coef: torch.Tensor  # [N]
    prob_a: float
    prob_b: float
    labels: tuple[int, int] = (1, -1)  # labels[0] is the "aligned" class

    def to(self, device) -> "SvmModel":
        return dataclasses.replace(
            self, sv=self.sv.to(device), sv_coef=self.sv_coef.to(device)
        )


def scale_measurements(
    x: torch.Tensor,
    fmin: np.ndarray = REFERENCE_FEATURE_MIN,
    fmax: np.ndarray = REFERENCE_FEATURE_MAX,
) -> torch.Tensor:
    """Linear rescale to [-1, 1] (svm_interface.cpp:44-51), unclamped.  The
    ranges are made on x's device, so no host value is copied inside a CUDA
    graph."""
    fmin = _on_device(tuple(np.asarray(fmin, np.float64).tolist()), x.dtype, x.device)
    fmax = _on_device(tuple(np.asarray(fmax, np.float64).tolist()), x.dtype, x.device)
    return -1.0 + 2.0 * (x - fmin) / (fmax - fmin)


@functools.lru_cache(maxsize=None)
def _on_device(values: tuple[float, ...], dtype, device) -> torch.Tensor:
    """`values` as a tensor made on `device` by fills (no host-to-device
    copy), built once per (values, dtype, device) and shared: never written
    to."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in values])


def decision_function(model: SvmModel, x: torch.Tensor) -> torch.Tensor:
    """f(x) = sum_i coef_i exp(-gamma ||x - sv_i||^2) - rho for x [..., D]."""
    sv, coef = model.sv, model.sv_coef
    d2 = (x * x).sum(-1, keepdim=True) + (sv * sv).sum(-1) - 2.0 * x @ sv.T
    k = torch.exp(-model.gamma * torch.clamp(d2, min=0.0))
    return k @ coef - model.rho


def predict_probability(model: SvmModel, x: torch.Tensor) -> torch.Tensor:
    """P(labels[0] | x) via the Platt sigmoid p = 1 / (1 + exp(A f + B)),
    numerically stabilised."""
    fab = model.prob_a * decision_function(model, x) + model.prob_b
    e_neg = torch.exp(-fab)
    return torch.where(fab >= 0, e_neg / (1.0 + e_neg), 1.0 / (1.0 + torch.exp(fab)))


def parse_libsvm_model(text: str) -> SvmModel:
    """Parse the libsvm text model format (2-class C-SVC / RBF with
    probability info)."""
    lines = text.strip().splitlines()
    header: dict[str, str] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line == "SV":
            break
        if not line:
            continue
        parts = line.split(None, 1)
        header[parts[0]] = parts[1] if len(parts) > 1 else ""

    if header.get("svm_type", "c_svc") != "c_svc":
        raise ValueError(f"unsupported svm_type {header.get('svm_type')}")
    if header.get("kernel_type", "rbf") != "rbf":
        raise ValueError(f"unsupported kernel {header.get('kernel_type')}")
    if int(header.get("nr_class", "2")) != 2:
        raise ValueError("only 2-class models supported")

    coefs, raw, max_idx = [], [], 0
    for line in lines[i:]:
        parts = line.split()
        if not parts:
            continue
        coefs.append(float(parts[0]))
        pairs = [(int(k), float(v)) for k, v in (p.split(":") for p in parts[1:])]
        max_idx = max([max_idx] + [k for k, _ in pairs])
        raw.append(pairs)
    sv = np.zeros((len(raw), max_idx + 1), np.float32)
    for r, pairs in enumerate(raw):
        for k, val in pairs:
            sv[r, k] = val
    if len(coefs) != int(header["total_sv"]):
        raise ValueError("SV count mismatch")
    return SvmModel(
        gamma=float(header.get("gamma", "0.125")),
        rho=float(header["rho"].split()[0]),
        sv=torch.from_numpy(sv),
        sv_coef=torch.tensor(coefs, dtype=torch.float32),
        prob_a=float(header.get("probA", "0").split()[0]),
        prob_b=float(header.get("probB", "0").split()[0]),
        labels=tuple(int(v) for v in header.get("label", "1 -1").split()),
    )


def serialize_libsvm_model(model: SvmModel) -> str:
    """Inverse of parse_libsvm_model (svm.cpp svm_save_model format)."""
    sv = model.sv.detach().cpu().numpy()
    coef = model.sv_coef.detach().cpu().numpy()
    out = [
        "svm_type c_svc",
        "kernel_type rbf",
        f"gamma {model.gamma:g}",
        "nr_class 2",
        f"total_sv {sv.shape[0]}",
        f"rho {model.rho:g}",
        f"label {model.labels[0]} {model.labels[1]}",
        f"probA {model.prob_a:g}",
        f"probB {model.prob_b:g}",
        f"nr_sv {sv.shape[0]} 0",
        "SV",
    ]
    for c, v in zip(coef, sv):
        feats = " ".join(f"{i}:{x:g}" for i, x in enumerate(v))
        out.append(f"{c:g} {feats}")
    return "\n".join(out) + "\n"


# The shipped verifier: the port's own copy of lrr_tpu's trained model file
# (a test holds the two byte-equal).
DEFAULT_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "verifier_default.model",
)


def load_default_verifier(path: str = DEFAULT_MODEL_PATH) -> SvmModel:
    """The shipped verifier (trained once offline, loaded GT-free at serve
    time for every pair, as the reference loads training_data_all.model)."""
    with open(path) as f:
        return parse_libsvm_model(f.read())


def fit_rbf_classifier(
    X: np.ndarray,
    y: np.ndarray,  # 1 = aligned, 0/-1 = misaligned
    gamma: float = 0.125,
    l2: float = 1e-3,
    steps: int = 500,
    lr: float = 0.5,
    device=None,
) -> SvmModel:
    """Train a probabilistic RBF classifier (kernel logistic regression) on
    `device` (`None`: the CUDA card); the model comes back on the CPU.

    Functional replacement for svm-train + Platt scaling: the decision
    function has the same form sum_i alpha_i K(x, sv_i) - rho and the
    probability map is the same sigmoid, so the result round-trips through
    the libsvm model format.  Unlike C-SVC the solution is dense (all
    training points are "support vectors"), which is irrelevant for the
    8-d / few-hundred-sample verification problem.  `steps` plain gradient
    steps in float32; the Gram matrix product never runs in TF32.
    """
    device = resolve_device(device, "fit_rbf_classifier")
    no_tf32()
    X = np.asarray(X, np.float32)
    yy = np.where(np.asarray(y) > 0, 1.0, -1.0).astype(np.float32)
    n = X.shape[0]

    # class-balanced weights: calibration sets are naturally imbalanced
    # (few aligned candidates among many refined ones) and an unweighted
    # mean loss biases the 0.5 threshold toward the majority class
    n_pos = max(int((yy > 0).sum()), 1)
    n_neg = max(int((yy < 0).sum()), 1)
    w = np.where(yy > 0, n / (2.0 * n_pos), n / (2.0 * n_neg)).astype(np.float32)

    Xt = torch.from_numpy(X).to(device)
    yt = torch.from_numpy(yy).to(device)
    wt = torch.from_numpy(w).to(device)
    sq = (Xt * Xt).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * Xt @ Xt.T
    K = torch.exp(-gamma * torch.clamp(d2, min=0.0))

    alpha = torch.zeros(n, device=device, requires_grad=True)
    rho = torch.zeros((), device=device, requires_grad=True)
    for _ in range(steps):
        f = K @ alpha - rho
        # weighted logistic loss on margins; P(aligned) = sigmoid(f)
        loss = (wt * torch.log1p(torch.exp(-yt * f))).mean() + l2 * ((alpha @ K) @ alpha)
        ga, gr = torch.autograd.grad(loss, (alpha, rho))
        with torch.no_grad():
            alpha -= lr * ga
            rho -= lr * gr

    # Platt slope of -1 reproduces P = sigmoid(f) through the libsvm-style
    # sigmoid p = 1/(1+exp(A f + B))
    return SvmModel(
        gamma=gamma,
        rho=float(rho.detach()),
        sv=torch.from_numpy(X),
        sv_coef=alpha.detach().cpu(),
        prob_a=-1.0,
        prob_b=0.0,
        labels=(1, -1),
    )

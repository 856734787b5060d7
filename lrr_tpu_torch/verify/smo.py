"""SMO solver for 2-class C-SVC with RBF kernel (lrr_tpu/verify/smo.py).

Reproduces the training semantics of the vendored LIBSVM
(libsvm/svm.cpp: Solver::Solve with the second-order
working-set selection of Fan, Chen & Lin, JMLR 2005, and the one-vs-one
C-SVC wrapper) so that `cli svm-train` yields models interchangeable with
ones trained by the reference's `svm-train` — same dual optimum (alpha/rho
within tolerance), same support-vector set, same decision values.  The fast
kernel-logistic surrogate (svm.fit_rbf_classifier) remains available for
bench/test fixtures.

Implemented from the published algorithm, not the C++ source:
  dual:   min_a  0.5 a^T Q a - e^T a,  0 <= a_i <= C,  y^T a = 0,
          Q_ij = y_i y_j K(x_i, x_j)
  wss2:   i = argmax_{t in I_up} -y_t G_t;
          j = argmin_{t in I_low, -y_t G_t < m_i} -(b_it^2 / a_it)
          with b_it = m_i + y_t G_t, a_it = K_ii + K_tt - 2 K_it (floored)
  stop:   m_i - M < eps  (eps = 1e-3, libsvm default)
  rho:    mean of y_t G_t over free vectors (bounds midpoint otherwise)

Probability outputs use Platt scaling fit by the same Newton iteration as
libsvm's sigmoid_train, on cross-validated decision values.

This is offline tooling (the reference trains offline too): sequential
float64 numpy on the host, no device involved; the trained model feeds the
batched predictor (`verify.svm.predict_probability`).
"""

from __future__ import annotations

import numpy as np

import torch

from lrr_tpu_torch.verify.svm import SvmModel

TAU = 1e-12


def rbf_kernel(X: np.ndarray, gamma: float) -> np.ndarray:
    sq = np.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * X @ X.T
    return np.exp(-gamma * np.maximum(d2, 0.0))


def smo_solve(
    K: np.ndarray,  # [n, n] kernel matrix
    y: np.ndarray,  # [n] in {+1, -1}
    C: float,
    eps: float = 1e-3,
    max_iter: int = 1_000_000,
) -> tuple[np.ndarray, float, int]:
    """Solve the C-SVC dual by SMO with second-order working-set selection.

    Returns (alpha [n], rho, iterations)."""
    n = K.shape[0]
    y = y.astype(np.float64)
    Q = (y[:, None] * y[None, :]) * K  # [n, n]
    Qd = np.diag(Q).copy()
    alpha = np.zeros(n)
    G = -np.ones(n)  # gradient of the dual objective at alpha = 0

    it = 0
    while it < max_iter:
        it += 1
        # I_up = {t | (y=+1, a<C) or (y=-1, a>0)}; I_low symmetric
        up = ((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0))
        low = ((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C))
        if not up.any() or not low.any():
            break
        minus_yG = -y * G
        m_i = np.max(minus_yG[up])
        M = np.min(minus_yG[low])
        if m_i - M < eps:
            break
        i = int(np.flatnonzero(up)[np.argmax(minus_yG[up])])

        # second-order selection of j among violating members of I_low
        cand = low & (minus_yG < m_i - TAU)
        if not cand.any():
            break
        b_vec = m_i + (y * G)  # b_t = (-y_i G_i) - (-y_t G_t) > 0 on cand
        a_vec = Qd[i] + Qd - 2.0 * y[i] * y * Q[i]
        a_vec = np.where(a_vec <= 0, TAU, a_vec)
        score = -(b_vec * b_vec) / a_vec
        score = np.where(cand, score, np.inf)
        j = int(np.argmin(score))

        # feasible-direction step: d_alpha_i = y_i * delta,
        # d_alpha_j = -y_j * delta minimizes 0.5*a*delta^2 - b*delta at
        # delta = b/a, clipped so both alphas stay in [0, C] (equivalent to
        # libsvm's per-sign case analysis)
        delta = b_vec[j] / a_vec[j]
        up_i = C - alpha[i] if y[i] > 0 else alpha[i]
        up_j = alpha[j] if y[j] > 0 else C - alpha[j]
        delta = min(delta, up_i, up_j)
        dai = y[i] * delta
        daj = -y[j] * delta
        alpha[i] += dai
        alpha[j] += daj

        # incremental gradient update: G = Q alpha - e
        G += Q[:, i] * dai + Q[:, j] * daj

    # rho: average y_t G_t over free support vectors
    free = (alpha > TAU) & (alpha < C - TAU)
    yG = y * G
    if free.any():
        rho = float(np.mean(yG[free]))
    else:
        up = ((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0))
        low = ((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C))
        ub = np.min(yG[low]) if low.any() else 0.0
        lb = np.max(yG[up]) if up.any() else 0.0
        rho = float((ub + lb) / 2.0)
    return alpha, rho, it


def sigmoid_train(
    dec: np.ndarray, labels: np.ndarray, max_iter: int = 100
) -> tuple[float, float]:
    """Platt scaling: fit P(y=1|f) = 1/(1+exp(A f + B)) by the regularized
    Newton method used by libsvm's sigmoid_train (Lin, Lin & Weng 2007)."""
    t = np.asarray(labels) > 0
    prior1 = float(np.sum(t))
    prior0 = float(len(t) - prior1)
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    tt = np.where(t, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    sigma = 1e-12
    eps = 1e-5

    def fun(A, B):
        fApB = dec * A + B
        pos = fApB >= 0
        return float(
            np.sum(
                np.where(
                    pos,
                    tt * fApB + np.log1p(np.exp(-fApB)),
                    (tt - 1.0) * fApB + np.log1p(np.exp(fApB)),
                )
            )
        )

    fval = fun(A, B)
    for _ in range(max_iter):
        fApB = dec * A + B
        pos = fApB >= 0
        p = np.where(pos, np.exp(-fApB) / (1 + np.exp(-fApB)),
                     1.0 / (1 + np.exp(fApB)))
        q = 1.0 - p
        d1 = tt - p
        d2 = p * q
        h11 = sigma + float(np.sum(dec * dec * d2))
        h22 = sigma + float(np.sum(d2))
        h21 = float(np.sum(dec * d2))
        g1 = float(np.sum(dec * d1))
        g2 = float(np.sum(d1))
        if abs(g1) < eps and abs(g2) < eps:
            break
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= 1e-10:
            nA, nB = A + step * dA, B + step * dB
            nf = fun(nA, nB)
            if nf < fval + 1e-4 * step * gd:
                A, B, fval = nA, nB, nf
                break
            step /= 2.0
        else:
            break
    return A, B


def train_c_svc(
    X: np.ndarray,
    y: np.ndarray,  # 1 = aligned (positive), else negative
    C: float = 1.0,
    gamma: float = 0.125,
    eps: float = 1e-3,
    probability: bool = True,
    n_folds: int = 5,
    seed: int = 1,
) -> SvmModel:
    """Train a 2-class RBF C-SVC the way the reference's svm-train does
    (libsvm/svm-train.cpp defaults: C=1, eps=1e-3, probability via 5-fold
    CV + Platt scaling).  Returns an SvmModel holding only the support
    vectors (alpha > 0), coefficients y_i * alpha_i."""
    X = np.asarray(X, np.float64)
    yy = np.where(np.asarray(y) > 0, 1.0, -1.0)

    K = rbf_kernel(X, gamma)
    alpha, rho, _ = smo_solve(K, yy, C, eps)

    prob_a, prob_b = -1.0, 0.0
    if probability:
        # cross-validated decision values (libsvm svm_binary_svc_probability;
        # fold assignment uses a seeded shuffle rather than C rand())
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(yy))
        dec = np.zeros(len(yy))
        folds = np.array_split(perm, n_folds)
        for hold in folds:
            train = np.setdiff1d(perm, hold, assume_unique=False)
            Kt = K[np.ix_(train, train)]
            a_f, r_f, _ = smo_solve(Kt, yy[train], C, eps)
            coef = yy[train] * a_f
            dec[hold] = K[np.ix_(hold, train)] @ coef - r_f
        prob_a, prob_b = sigmoid_train(dec, yy > 0)

    svs = alpha > 1e-12
    return SvmModel(
        gamma=gamma,
        rho=rho,
        sv=torch.from_numpy(X[svs].astype(np.float32)),
        sv_coef=torch.from_numpy((yy[svs] * alpha[svs]).astype(np.float32)),
        prob_a=prob_a,
        prob_b=prob_b,
        labels=(1, -1),
    )

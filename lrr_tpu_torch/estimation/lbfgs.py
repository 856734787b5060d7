"""Minimal L-BFGS for the EM-CDC objectives (lrr_tpu/estimation/lbfgs.py;
the reference's vnl_lbfgs wrapper, cdcl/cdcl_lbfgs.h:15-38).

Two-loop recursion over a ring of `history` pairs, Armijo backtracking from
t = 1 by halving (at most `max_ls` halvings), and the early stop once the
objective has dropped by more than `improvement_stop` of |f0| (5 %,
cdcl_lbfgs.h:30-36).  Gradients come from torch.autograd.  The loops run on
the host: each line-search test and each stop test reads a scalar.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LbfgsResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    converged: bool


def value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
    """(f(x), df/dx), both detached."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = fun(x)
        (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iters: int = 5,
    history: int = 5,
    max_ls: int = 12,
    improvement_stop: float = 0.05,
) -> LbfgsResult:
    """Minimise `fun` from x0 in at most `max_iters` iterations.  Stops once
    f0 - f > improvement_stop * |f0| (pass float("inf") to disable), on a
    failed line search or on a relative step below 1e-10."""
    n = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    zero = torch.zeros((), dtype=dt, device=dev)
    f0, g0 = value_and_grad(fun, x0)
    x, f, g = x0.detach(), f0, g0
    s_hist = torch.zeros((history, n), dtype=dt, device=dev)
    y_hist = torch.zeros((history, n), dtype=dt, device=dev)
    rho_hist = torch.zeros(history, dtype=dt, device=dev)
    k = 0  # pairs stored so far
    done = False

    def direction():
        q = g
        alphas = []
        for i in range(history):
            j = (k - 1 - i) % history
            alpha = rho_hist[j] * torch.dot(s_hist[j], q) if i < min(k, history) else zero
            q = q - alpha * y_hist[j]
            alphas.append(alpha)
        j_last = (k - 1) % history
        sy = torch.dot(s_hist[j_last], y_hist[j_last])
        yy = torch.dot(y_hist[j_last], y_hist[j_last])
        one = torch.ones((), dtype=dt, device=dev)
        gamma = torch.where((yy > 1e-30) & (k > 0), sy / yy, one)
        r = gamma * q
        for i in range(history):
            ii = history - 1 - i
            j = (k - 1 - ii) % history
            beta = rho_hist[j] * torch.dot(y_hist[j], r) if ii < min(k, history) else zero
            r = r + (alphas[ii] - beta) * s_hist[j]
        return -r

    for _ in range(max_iters):
        if done:
            break
        d = direction()
        gd = torch.dot(g, d)
        d = torch.where(gd < 0, d, -g)  # safeguard: a descent direction
        gd = torch.minimum(gd, torch.dot(g, -g))

        # Armijo backtracking from t = 1
        t = torch.ones((), dtype=dt, device=dev)
        f_new, g_new = value_and_grad(fun, x + t * d)
        it = 0
        while it < max_ls and bool(f_new > f + 1e-4 * t * gd):
            t = t * 0.5
            f_new, g_new = value_and_grad(fun, x + t * d)
            it += 1
        ok = bool((f_new < f) & torch.isfinite(f_new))
        x_new = x + t * d if ok else x
        f_sel, g_sel = (f_new, g_new) if ok else (f, g)

        s = x_new - x
        y = g_sel - g
        sy = torch.dot(s, y)
        store = ok and bool(sy > 1e-30)
        if store:
            slot = k % history
            s_hist[slot] = s
            y_hist[slot] = y
            rho_hist[slot] = 1.0 / torch.clamp(sy, min=1e-30)
            k += 1

        improved_enough = bool((f0 - f_sel) > improvement_stop * torch.abs(f0))
        small_step = bool(torch.abs(f - f_sel) < 1e-10 * (1.0 + torch.abs(f_sel)))
        done = (not ok) or small_step or improved_enough
        x, f, g = x_new, f_sel, g_sel

    return LbfgsResult(x=x, f=f, converged=done)

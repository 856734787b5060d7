"""A PASS-2 wave served from captured CUDA graphs.

lrr_tpu runs a whole wave as one compiled device program (`_wave_jit`,
lrr_tpu/pipeline/registration.py:493-517), each ICP level a
`lax.while_loop` whose condition stays on the device
(lrr_tpu/estimation/icp.py:1171-1177), and reads the result back once.  The
counterpart here is a set of CUDA graphs per lane bucket (`registration.
pad_bucket`), captured once and replayed for every wave of that bucket.  The
steps are registration's (`WaveSteps`, the ones its eager `_wave_fn` runs):

  prologue  the lanes' ROIs, the sampling sources and the peeled MUSE
            iteration into a static carry;
  chunk k   one per level: `icp.ITERATIONS_PER_CHECK` masked iterations of
            level k (`icp.Refinement.step`, as `Refinement.levels` runs
            them) written back into the carry, then whether any lane is
            still active at each level;
  epilogue  the final statistics pass, `backward_covariance`, the decision
            measurements, the SVM and `_pack_wave` into one static output.

The host replays the prologue, then each level's chunk graph while the last
read says a lane is active there (one read a chunk; a chunk replayed with
nothing active changes nothing), then the epilogue; the caller reads the
rows once.  The results are the eager `_wave_fn`'s bits: the same kernels
on the same inputs, a lane that is done frozen by the mask.

A bucket's graphs are built at its first wave: the wave's per-lane inputs
become its static buffers (later waves are copied into them), every part
runs once eagerly on a side stream (warm-up: library handles, the kernels'
build), then each is captured there, all of a context's graphs into one
memory pool.  Warm-up and capture run with
`torch.cuda.set_sync_debug_mode("error")`: a host sync inside a wave raises,
and nothing falls back to eager.  The graphs of one context are kept (per
configuration and verifier); a wave on another context drops them.

The kernel wrappers' counters are Python counters, which a replay does not
move: each graph records what its capture counted, and every replay adds it
(`kernels.add_counts`); a chunk replay adds one to `icp.chunks_run()`.

With the program's trace on (`utils.timers`), a wave records `wave.inputs`
(the lanes' inputs, copied into the bucket's), `wave.build` (a new bucket:
`wave.build.warmup`, then a `wave.build.capture` a graph), `wave.replay` a
graph launched (attribute `part`: prologue, chunk with its `level`,
epilogue) and `wave.flags` a host read of the level flags.  `stats()` is
where waves, replays, reads and build seconds are counted.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from lrr_tpu_torch.estimation import icp
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.utils import timers
from lrr_tpu_torch.verify.svm import SvmModel


class WaveSteps(NamedTuple):
    """A wave's steps, in order (pipeline/registration.py):
    inputs(queries, inits, plan, lanes, cand_idx) -> (query, init, plan) of
    the lanes; prologue(ctx, cfg, query, init, plan) -> (refinement, carry,
    rois); then the ICP's levels on the carry; epilogue(ctx, cfg, svm,
    refinement, carry, rois, plan) -> the packed rows."""

    inputs: Callable
    prologue: Callable
    epilogue: Callable


# the graphs of one context, {(cfg, svm) key: WaveGraphs}, in one memory pool
_CACHE: dict = {"ctx": None, "pool": None, "graphs": {}}


def wave_graphs(ctx, cfg, svm: SvmModel, steps: WaveSteps) -> "WaveGraphs":
    """The graphs that serve `ctx`'s waves under `cfg` and `svm` (built per
    bucket at its first wave).  Raises for a context that is not on a CUDA
    device: the CPU runs `registration._wave_fn`."""
    if ctx.device.type != "cuda":
        raise ValueError(f"wave graphs serve a context on a CUDA device, not on {ctx.device}")
    if _CACHE["ctx"] is not ctx:
        drop()
        _CACHE["ctx"], _CACHE["pool"] = ctx, torch.cuda.graph_pool_handle()
    key = (cfg, _svm_key(svm), steps)
    graphs = _CACHE["graphs"].get(key)
    if graphs is None:
        graphs = _CACHE["graphs"][key] = WaveGraphs(ctx, cfg, svm, steps, _CACHE["pool"])
    return graphs


def drop() -> None:
    """Forget every captured graph (and free their memory pool)."""
    _CACHE["graphs"].clear()
    _CACHE["ctx"] = _CACHE["pool"] = None


def stats() -> dict:
    """Build seconds per bucket, waves, replays and host reads of every
    WaveGraphs of the current context, summed."""
    out = {"build_s": {}, "waves": 0, "replays": 0, "syncs": 0}
    for g in _CACHE["graphs"].values():
        for b, s in g.build_s.items():
            out["build_s"].setdefault(b, []).append(s)
        for k in ("waves", "replays", "syncs"):
            out[k] += getattr(g, k)
    return out


def first_difference(a, b, name: str = "") -> str | None:
    """The dotted name of the first field in which two results (tensors, and
    dataclasses, tuples and lists of them, nested) differ in type, dtype,
    shape or bits, or None when they hold the same bits: the graph path's
    contract with the eager waves."""
    here = name or "."
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).contiguous().view(torch.uint8),
            b.reshape(-1).contiguous().view(torch.uint8))
        return None if same else here
    if type(a) is not type(b):
        return here
    if dataclasses.is_dataclass(a):
        pairs = [(f.name, getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    elif isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return here
        pairs = [(str(i), x, y) for i, (x, y) in enumerate(zip(a, b))]
    else:
        return None if a == b else here
    for field, x, y in pairs:
        found = first_difference(x, y, f"{name}.{field}" if name else field)
        if found is not None:
            return found
    return None


def _svm_key(svm: SvmModel):
    """The verifier as a hashable value: its constants and its tensors'
    bytes (host copies; one read a call where they live on the card)."""
    sv, coef = svm.sv.detach().cpu(), svm.sv_coef.detach().cpu()
    return (svm.gamma, svm.rho, svm.prob_a, svm.prob_b, tuple(svm.labels), str(sv.dtype),
            tuple(sv.shape), sv.numpy().tobytes(), str(coef.dtype), coef.numpy().tobytes())


@contextlib.contextmanager
def _sync_errors():
    """Any host synchronisation inside raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _copy_into(dst, src) -> None:
    """dst <- src over tensors, tuples and dataclasses of them (nested; a
    None field stays None)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif dst is not None:
        for d, x in zip(dst, src):
            _copy_into(d, x)


def _clone(c):
    """A carry (dataclass of tensors, nested) with every tensor its own."""
    if isinstance(c, torch.Tensor):
        return c.clone()
    return type(c)(**{f.name: _clone(getattr(c, f.name)) for f in dataclasses.fields(c)})


class _Graph:
    """One captured part and the kernel launches its capture counted."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: tuple[dict, ...]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_counts(self.launches)


class _Bucket:
    """The static inputs and the graphs of waves of one lane count; after
    the prologue also its refinement, carry and ROIs."""

    def __init__(self, inputs):
        self.inputs = inputs  # (query, init, plan) of the lanes, fresh tensors


class WaveGraphs:
    """The captured waves of one (context, configuration, verifier)."""

    def __init__(self, ctx, cfg, svm: SvmModel, steps: WaveSteps, pool):
        self.ctx, self.cfg, self.steps, self.pool = ctx, copy.deepcopy(cfg), steps, pool
        dev = ctx.device
        self.svm = dataclasses.replace(svm, sv=svm.sv.to(dev, copy=True),
                                       sv_coef=svm.sv_coef.to(dev, copy=True))
        self.stream = torch.cuda.Stream(dev)
        self.buckets: dict[int, _Bucket] = {}
        self.build_s: dict[int, float] = {}
        self.waves = self.replays = self.syncs = 0

    # the three parts, on a bucket's static inputs

    def _prologue(self, b: _Bucket) -> None:
        b.refinement, carry, b.rois = self.steps.prologue(self.ctx, self.cfg, *b.inputs)
        b.carry = _clone(carry)

    def _chunk(self, b: _Bucket, k: int) -> None:
        c = b.carry
        for _ in range(icp.ITERATIONS_PER_CHECK):
            c = b.refinement.step(c, k)
        b.flags.copy_(b.refinement.flags(c))
        _copy_into(b.carry, c)

    def _epilogue(self, b: _Bucket) -> torch.Tensor:
        return self.steps.epilogue(self.ctx, self.cfg, self.svm, b.refinement, b.carry, b.rois,
                                   b.inputs[2])

    def _capture(self, fn, **part) -> tuple[_Graph, object]:
        before = kernels.counts()
        g = torch.cuda.CUDAGraph()
        with timers.span("wave.build.capture", **part):
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                with _sync_errors():
                    out = fn()
        launches = kernels.counts_since(before)
        kernels.add_counts(launches, -1)  # a capture launches nothing
        return _Graph(g, launches), out

    def _build(self, inputs) -> _Bucket:
        t0 = time.perf_counter()
        b = _Bucket(inputs)
        b.flags = torch.zeros(len(icp._staged_caps(self.cfg.estimation)), dtype=torch.bool,
                              device=self.ctx.device)
        levels = range(b.flags.numel())
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream), _sync_errors(), timers.span("wave.build.warmup"):
            self._prologue(b)
            for k in levels:
                self._chunk(b, k)
            self._epilogue(b)
        torch.cuda.current_stream().wait_stream(self.stream)
        b.prologue, _ = self._capture(lambda: self._prologue(b), part="prologue")
        b.chunks = [self._capture(lambda k=k: self._chunk(b, k), part="chunk", level=k)[0]
                    for k in levels]
        b.epilogue, b.out = self._capture(lambda: self._epilogue(b), part="epilogue")
        self.build_s[len(inputs[0])] = time.perf_counter() - t0
        return b

    def run(self, queries, inits, plan, lanes, cand_idx) -> torch.Tensor:
        """The packed rows [B, 174] of one wave of B = len(lanes) lanes
        (`registration._wave_fn`'s arguments but the context, configuration
        and verifier); a new tensor, so waves can be kept."""
        B = lanes.numel()
        with timers.span("wave.inputs"):
            inputs = self.steps.inputs(queries, inits, plan, lanes, cand_idx)
            b = self.buckets.get(B)
            if b is not None:
                _copy_into(b.inputs, inputs)
        if b is None:
            with timers.span("wave.build", lanes=B):
                b = self.buckets[B] = self._build(inputs)
        self._replay(b.prologue, part="prologue")
        flags = [True] * len(b.chunks)  # not read yet: a chunk with nothing active is a no-op
        k = 0
        while k < len(b.chunks):
            if not flags[k]:
                k += 1
                continue
            self._replay(b.chunks[k], part="chunk", level=k)
            icp.add_chunks()
            with timers.span("wave.flags"):
                flags = b.flags.tolist()  # the one host read of this chunk
            self.syncs += 1
        self._replay(b.epilogue, part="epilogue")
        self.waves += 1
        return b.out.clone()

    def _replay(self, g: _Graph, **part) -> None:
        with timers.span("wave.replay", **part):
            g.replay()
        self.replays += 1

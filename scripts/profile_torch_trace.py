"""Where the card waits, span by span: a benchmark cell's requests served
with the port's own trace on (`lrr_tpu_torch.utils.timers`), one of them
under `torch.profiler`, each idle instant of the card put down to the
innermost program span that held the host at that instant.

    python3 scripts/profile_torch_trace.py --workload copd512.landmarks300 --seed 7 \\
        [--requests 3] [--cost-rounds 10] [--out chiprun_out/trace]

Set-up is the benchmark's (`portbench/`: the cell's configuration,
traffic and driver, inputs made on the card from the seed, the shapes
warmed).  Then, with `--cost-rounds N`, N rounds of three requests timed by
the host clock to a synchronise: one request a round (its queries and
draws), served with the trace off, on, and on with the annotation prefix,
in an order that rotates a round: what the trace costs a request (the
`serve` driver's requests can be served again; the `pair` driver's
cannot).  Then `--requests` requests with the trace on and
the prefix, the last under the profiler.  The spans' prefix is
`portbench.lrr.`, under the `portbench.` annotations that
`portbench.yardstick.device_kernels` does not count as device work.

Prints one JSON line and writes it, with each request's span summary, to
`<out>/<workload>.json`: per span name its seconds, own seconds (less its
children's) and count a request, the counters, the profiled request's
device idle share and `idle_by_span` (its parts, `outside` for instants
under no program span, sum to the idle share), its ten longest gaps named
by the innermost program span at their midpoints, and the cost rounds'
quartiles.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lrr_tpu_torch.utils import timers  # noqa: E402
from portbench import program, yardstick  # noqa: E402
from portbench.run import load_cell  # noqa: E402

PREFIX = "portbench.lrr."
OUTSIDE = "outside"


def innermost_segments(ranges):
    """[(start, end, name)]: the pieces of the timeline over which the
    innermost of properly nested ranges [(name, start, end)] does not
    change, in order and disjoint."""
    segs, stack, t = [], [], -float("inf")

    def close(until):
        nonlocal t
        while stack and stack[-1][2] <= until:
            name, _, end = stack.pop()
            if end > t:
                segs.append((t, end, name))
                t = end

    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        close(s)
        if stack and s > t:
            segs.append((t, s, stack[-1][0]))
        t = max(t, s)
        stack.append((name, s, e))
    close(float("inf"))
    return segs


def idle_gaps(kernels, window):
    """[(start, end)]: the instants of `window` in which no device interval
    of `kernels` [(name, start, end)] runs."""
    gaps, cur = [], window[0]
    for s, e in sorted((s, e) for _, s, e in kernels) + [(window[1], window[1])]:
        s = min(s, window[1])
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    return gaps


def idle_by_span(kernels, ranges, window) -> dict:
    """{range name or OUTSIDE: share of `window`}: every idle instant of
    the device put down to the innermost of `ranges` that holds it; the
    parts sum to 1 - busy / window."""
    segs = innermost_segments(ranges)
    out: dict[str, float] = {}
    j = 0
    for gs, ge in idle_gaps(kernels, window):
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        cur, k = gs, j
        while k < len(segs) and segs[k][0] < ge:
            a, b = max(segs[k][0], gs), min(segs[k][1], ge)
            if a > cur:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + a - cur
            out[segs[k][2]] = out.get(segs[k][2], 0.0) + b - a
            cur = b
            k += 1
        if ge > cur:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + ge - cur
    span = window[1] - window[0]
    return {n: v / span for n, v in sorted(out.items(), key=lambda kv: -kv[1])}


def span_summary(drained: timers.Drained) -> dict:
    """Per span name: seconds, own seconds (less the children's) and count;
    the counters; the spans the buffer dropped."""
    dur = {s.id: s.end_ns - s.start_ns for s in drained.spans}
    inner: dict[int, int] = {}
    for s in drained.spans:
        if s.parent in dur:
            inner[s.parent] = inner.get(s.parent, 0) + dur[s.id]
    out: dict[str, dict] = {}
    for s in drained.spans:
        o = out.setdefault(s.name, {"s": 0.0, "self_s": 0.0, "n": 0})
        o["s"] += dur[s.id] * 1e-9
        o["self_s"] += (dur[s.id] - inner.get(s.id, 0)) * 1e-9
        o["n"] += 1
    return {"spans": out, "counters": dict(drained.counters), "dropped": drained.dropped}


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4) if len(xs) > 1 else (xs[0],) * 3
    return {"median": q2, "q1": q1, "q3": q3, "n": len(xs)}


def share(parts: dict, *prefixes) -> float:
    return 100.0 * sum(v for n, v in parts.items() if n.startswith(prefixes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--cost-rounds", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "trace"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_trace: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = load_cell(ROOT, args.workload)
    traffic = spec["traffic"]
    driver_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    driver = driver_mod.Driver(spec["config"], traffic, args.seed, device,
                               program.Tracer(False, device))
    t0 = time.perf_counter()
    driver.setup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    i = 0

    def request(profiled=False, index=None):
        """Request `index` (by default the next one), timed."""
        nonlocal i
        if index is None:
            index, i = i, i + 1
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA]) \
            if profiled else None
        t = time.perf_counter()
        if prof is not None:
            prof.__enter__()
        try:
            with torch.profiler.record_function("portbench.request"), timers.request(index):
                driver.request(index)
            torch.cuda.synchronize(device)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        seconds = time.perf_counter() - t
        driver.forget(index)
        return seconds, prof

    modes = {"off": None, "on": False, "annotated": True}
    cost = {m: [] for m in modes}
    for r in range(args.cost_rounds):  # one request a round, served in each mode
        names = list(modes)
        for m in names[r % 3:] + names[:r % 3]:
            if modes[m] is not None:
                timers.trace_on(annotate=PREFIX if modes[m] else None)
            cost[m].append(request(index=i)[0])
            timers.trace_off()
            timers.drain()
        i += 1

    timers.trace_on(annotate=PREFIX)
    summaries, prof = [], None
    for k in range(args.requests):
        seconds, prof = request(profiled=k == args.requests - 1)
        summaries.append({"seconds": seconds, **span_summary(timers.drain())})
    timers.trace_off()

    kern = yardstick.device_kernels(prof)
    window = yardstick.cpu_ranges(prof, "portbench.request")[0]
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in kern
              if e > window[0] and s < window[1]]
    ranges = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX)]
    busy = yardstick.union_seconds([(s, e) for _, s, e in inside])
    parts = idle_by_span(inside, ranges, window)
    idle = 100.0 * (1.0 - busy / (window[1] - window[0]))
    steady = summaries[:-1] or summaries

    def per_request(name, key="s"):
        return statistics.mean(r["spans"].get(name, {}).get(key, 0.0) for r in steady)

    waves = sum(r["spans"].get("staged.wave", {}).get("n", 0) for r in steady)
    counters = {}
    for r in steady:
        for n, v in r["counters"].items():
            counters[n] = counters.get(n, 0) + v
    line = {
        "workload": args.workload, "seed": args.seed, "setup_s": setup_s,
        "card": torch.cuda.get_device_name(device),
        "window_s": (window[1] - window[0]) * 1e-6, "busy_s": busy * 1e-6,
        "device_idle_pct": idle, "idle_by_span_sum_pct": 100.0 * sum(parts.values()),
        "idle_by_span_pct": {n: 100.0 * v for n, v in parts.items()},
        "idle_gaps": yardstick.idle_gaps(inside, [(n, a, b) for a, b, n in
                                                  innermost_segments(ranges)], window),
        "proposed": {
            "idle_stage1_pct": share(parts, PREFIX + "stage1."),
            "idle_capture_pct": share(parts, PREFIX + "wave.build"),
            "idle_waves_pct": share(parts, PREFIX + "wave.", PREFIX + "staged.wave"),
            "pass1_ms": 1e3 * per_request("staged.pass1"),
            "host_ms_per_wave": 1e3 * sum(r["spans"].get("staged", {}).get("self_s", 0.0)
                                          for r in steady) / waves if waves else None,
            "icp_iter_fill_pct": 100.0 * counters["icp.lane_iterations"]
            / counters["icp.lane_slots"] if counters.get("icp.lane_slots") else None,
        },
        "counters": counters,
        "cost_s": {m: quartiles(v) for m, v in cost.items() if v},
        "cost_ratio_on": quartiles([a / b for a, b in zip(cost["on"], cost["off"])])
        if cost["off"] else None,
        "cost_ratio_annotated": quartiles([a / b for a, b in zip(cost["annotated"],
                                                                 cost["off"])])
        if cost["off"] else None,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, args.workload + ".json"), "w") as f:
        json.dump({**line, "requests": summaries, "cost_runs_s": cost}, f, indent=1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

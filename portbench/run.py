"""The benchmark of lrr_tpu_torch on one H100: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration (its file in BENCHMARK.json's
`configs`) and a traffic mix (`portbench/traffic/<traffic>.json`, which
names its driver in `portbench/drivers/`); the per-layer metrics are the
readers `portbench/metrics/<name>.py`; the limits of the check are
`portbench/limits/<cell>.json`.  A new cell, configuration or metric is new
files and entries: nothing here names one.

A run: set-up (inputs made on the card from the seed, the cell's shapes
warmed), then a closed loop of one client that starts requests until
`--seconds` have passed and counts every request it started; the rate is
over the whole window, from the first request's start to the last one's
end.  With `--trace 1` the benchmark's spans are on (each ending in a
synchronise) and, once the window has closed, one more request runs under
`torch.profiler`; the line then carries the per-layer metrics.  After the
window: the peak memory is read, the program's state freed, and the plain
reference judges a sample of the requests drawn from the seed, with the
last one always in it.  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import torch

from portbench import draws, judge, program, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "lrr_tpu")


def process_age_s() -> float:
    """Seconds since this process started (/proc), or since this module was
    imported where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_cell(root: str, workload: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(root, "portbench", "limits", workload + ".json")
    limits = None
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    config["verifier"] = os.path.join(root, config["verifier"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return {"bench": bench, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def metric_reader(root: str, name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        os.path.join(root, "portbench", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def profile_summary(prof) -> dict:
    """What the readers take from the traced request: device intervals,
    busy and window seconds, K1 / K3 time, wave ranges, top ops, gaps."""
    kern = yardstick.device_kernels(prof)
    req = yardstick.cpu_ranges(prof, "portbench.request")
    window = req[0] if req else (min(s for _, s, _ in kern), max(e for _, _, e in kern))
    inside = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in kern
              if e > window[0] and s < window[1]]
    busy_us = yardstick.union_seconds([(s, e) for _, s, e in inside])
    waves = yardstick.cpu_ranges(prof, "portbench.wave")
    in_waves = [(s, e) for _, s, e in inside if any(a <= s < b for a, b in waves)]
    named = [(f"portbench.{n}", s, e) for n in ("wave", "build_feature_voronoi", "prepare_pair",
                                               "segment_pair", "serve")
             for s, e in yardstick.cpu_ranges(prof, f"portbench.{n}")]
    return {
        "busy_s": busy_us * 1e-6, "window_s": (window[1] - window[0]) * 1e-6,
        "wave_device_s": yardstick.union_seconds(in_waves) * 1e-6,
        "k1_s": sum(e - s for n, s, e in inside if program.K1_KERNEL in n) * 1e-6,
        "k1_records": sum(program.K1_KERNEL in n for n, _, _ in inside),
        "k3_s": sum(e - s for n, s, e in inside if program.K3_KERNEL in n) * 1e-6,
        "k3_records": sum(program.K3_KERNEL in n for n, _, _ in inside),
        "device_ops": yardstick.top_ops(inside),
        "idle_gaps": yardstick.idle_gaps(inside, named, window),
    }


def end_to_end(per_request: list[dict], window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: seconds a completed request and
    locations a second, both over the whole window."""
    done = [r for r in per_request if "error" not in r]
    e2e = {"setup_s": setup_s}
    if done:
        e2e["pair_s"] = window_s / len(done)
        e2e["locations_per_s"] = sum(r["queries"] for r in done) / window_s
    return e2e


def kernel_bounds(before: tuple, after: tuple) -> dict:
    """K1's and K3's least times (ms) over the launches between two
    `program.kernel_counts()`, and the launches."""
    (k1a, k3a), (k1b, k3b) = before, after
    d1 = {k: v - k1a.get(k, 0) for k, v in k1b.items() if v != k1a.get(k, 0)}
    d3 = {k: v - k3a.get(k, 0) for k, v in k3b.items() if v != k3a.get(k, 0)}
    return {"k1_bound_ms": sum(n * yardstick.k1_bound_ms(*k) for k, n in d1.items()),
            "k1_launches": sum(d1.values()),
            "k3_bound_ms": sum(n * yardstick.k3_bound_ms(*k) for k, n in d3.items()),
            "k3_launches": sum(d3.values())}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> tuple[dict, list[str]]:
    """One run; (result line, the check's lines for standard error)."""
    spec = load_cell(root, workload)
    config, traffic = spec["config"], spec["traffic"]
    tracer = program.Tracer(trace, device)
    driver_mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    driver = driver_mod.Driver(config, traffic, seed, device, tracer)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)

    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    tracer.install()
    tracer.take()  # set-up's spans are not the window's
    pick_rng = draws.rng(seed, draws.CHECK)
    early = int(pick_rng.integers(0, max(1, traffic["check_requests"] - 1) + 1))
    setup_s = process_age_s()
    per_request, failed, attempted = [], 0, 0

    def one_request(i: int, profiled: bool) -> dict:
        """Request `i`, timed; under the profiler when `profiled`."""
        nonlocal failed, attempted
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA]) \
            if profiled else None
        counts0, waves0 = program.kernel_counts() if trace else None, len(tracer.waves)
        t0 = time.perf_counter()
        try:
            if prof is not None:
                prof.__enter__()
            with torch.profiler.record_function("portbench.request"):
                rec = driver.request(i)
            if cuda:
                torch.cuda.synchronize(device)
        except Exception as exc:  # a request that raises fails its queries
            print(f"portbench: request {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            rec = {"queries": traffic["queries_per_request"], "error": repr(exc)}
            failed += rec["queries"]
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        rec["seconds"] = time.perf_counter() - t0
        rec["spans"] = tracer.take()
        rec["profiled"] = profiled
        if trace:
            rec["lanes"] = sum(m for m, _ in tracer.waves[waves0:])
            rec["buckets"] = [b for _, b in tracer.waves[waves0:]]
            rec.update(kernel_bounds(counts0, program.kernel_counts()))
        attempted += rec["queries"]
        per_request.append(rec)
        return prof

    i = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        one_request(i, False)
        if i >= 1 and i - 1 != early:
            driver.forget(i - 1)
        i += 1
    window_s = time.perf_counter() - t_start
    e2e = end_to_end(per_request, window_s, setup_s)
    traced, prof_summary = None, None
    if trace:  # one more request, after the window, under the profiler
        prof = one_request(i, True)
        prof_summary, traced = profile_summary(prof), i
        del prof
        driver.forget(i)
    tracer.uninstall()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    record = {"requests": per_request, "window_s": window_s, "waves": tracer.waves,
              "profile": prof_summary, "traced_request": traced}

    # the check: a sample of the requests, the last one always in it
    t_check = time.perf_counter()
    picked = sorted({j for j in (early, i - 1) if 0 <= j < i and "error" not in per_request[j]})
    check_rng = draws.rng(seed, draws.CHECK, 1)
    data = driver.check_data(picked, check_rng) if picked else []
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = {}
    for stage1, reqs in data:
        if control:  # the control's outputs in the program's place
            stage1, reqs = judge.control(stage1, reqs, config, device)
        got = judge.judge(stage1, reqs, config, device)
        for k, v in got.items():  # the worst over the checked pairs
            numbers[k] = max(numbers.get(k, v), v)
    del data
    numbers["requests_checked"] = len(picked)
    check_s = time.perf_counter() - t_check
    limits = spec["limits"]
    if limits is None or not picked:
        correct, checks = False, {k: [v, None] for k, v in numbers.items()}
    else:
        correct, checks = judge.decide(numbers, limits)
    correct = correct and failed == 0

    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = metric_reader(root, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in e2e}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and prof_summary is not None:
        dev["busy_s"] = prof_summary["busy_s"]
        dev["window_s"] = prof_summary["window_s"]
        line["breakdown"] = {"device_ops": prof_summary["device_ops"],
                             "idle_gaps": prof_summary["idle_gaps"]}
    line["checks"] = checks
    notes = [json.dumps({"e2e": e2e, "setup_parts": getattr(driver, "setup_parts", None),
                         "check_s": check_s, "numbers": numbers, "requests": [
        {k: v for k, v in r.items() if k != "spans"} | {"spans": r["spans"]}
        for r in per_request], "waves": len(tracer.waves),
        "profile": None if prof_summary is None else
        {k: v for k, v in prof_summary.items() if k not in ("device_ops", "idle_gaps")}})]
    notes += [f"check {k} {v} limit {lim}" for k, (v, lim) in checks.items()]
    return line, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    spec = load_cell(root, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line, notes = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                           device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for n in notes[:1]:
        print(n, flush=True)
    print(json.dumps(line), flush=True)
    for n in notes[1:]:
        print(n, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

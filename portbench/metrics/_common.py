"""Shared by the metric readers: the requests whose spans count (the
profiled one runs under the profiler and is left out of span means)."""


def steady(rec: dict) -> list[dict]:
    return [r for r in rec["requests"] if "error" not in r and not r["profiled"]]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None

"""Share (%) of the traced request's wall time in which no kernel or
memory operation ran on the device: 1 - the union of the profiler's
device intervals over the request's host range."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

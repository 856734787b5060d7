"""K3's share (%) of its roofline in the traced request: its least time at
the shapes it was launched at (`kernels.PINV_SHAPES`; its bytes as K1's,
or its operations, `portbench/yardstick.py::k3_bound_ms`) over the profiler's time of its
kernel."""


def read(rec):
    p, i = rec.get("profile"), rec.get("traced_request")
    if not p or i is None or p["k3_s"] <= 0:
        return None
    bound_ms = rec["requests"][i].get("k3_bound_ms")
    return 100.0 * bound_ms * 1e-3 / p["k3_s"] if bound_ms else None

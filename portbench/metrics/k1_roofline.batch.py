"""K1's share (%) of its roofline in the traced request: its least time at
the shapes it was launched at (`kernels.K1_SHAPES`; the bytes its inputs
need, through the SMs' load path, and from HBM what the L2 cannot hold,
`portbench/yardstick.py::k1_bound_ms`) over the profiler's time of its
kernel."""


def read(rec):
    p, i = rec.get("profile"), rec.get("traced_request")
    if not p or i is None or p["k1_s"] <= 0:
        return None
    bound_ms = rec["requests"][i].get("k1_bound_ms")
    return 100.0 * bound_ms * 1e-3 / p["k1_s"] if bound_ms else None

"""Device milliseconds a real lane: in the traced request, the union of the
device intervals inside the benchmark's wave spans over the real lanes its
waves refined."""


def read(rec):
    p, i = rec.get("profile"), rec.get("traced_request")
    if not p or i is None or p["wave_device_s"] <= 0:
        return None
    lanes = rec["requests"][i].get("lanes")
    return 1e3 * p["wave_device_s"] / lanes if lanes else None

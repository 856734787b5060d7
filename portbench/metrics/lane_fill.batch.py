"""Share (%) of the lanes dispatched that were real (lane, candidate)
pairs: over every wave of the window, the lanes before padding over the
bucket's lanes (`registration.pad_lanes`, wrapped)."""


def read(rec):
    waves = rec.get("waves") or []
    lanes = sum(b for _, b in waves)
    return 100.0 * sum(m for m, _ in waves) / lanes if lanes else None

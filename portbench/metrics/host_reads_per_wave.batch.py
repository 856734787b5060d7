"""Host reads a wave: `wave_graph.stats()`'s syncs over its waves, summed
over the window's requests."""


def read(rec):
    reqs = [r for r in rec["requests"] if "error" not in r]
    waves = sum(r.get("waves", 0) for r in reqs)
    return sum(r.get("syncs", 0) for r in reqs) / waves if waves else None

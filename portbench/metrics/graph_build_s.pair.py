"""Seconds a pair spent capturing its wave graphs: `wave_graph.stats()`'s
build seconds of the pair's context (a new context captures every bucket
anew), averaged over the window's pairs (the profiled one left out)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import mean, steady  # noqa: E402


def read(rec):
    return mean(r["graph_build_s"] for r in steady(rec) if "graph_build_s" in r)

"""Seconds a pair in `build_feature_voronoi` (both volumes' maps): spans
around each call stage 1 makes, summed per pair, averaged over the window's
pairs (the profiled one left out)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import mean, steady  # noqa: E402


def read(rec):
    return mean(r["spans"]["build_feature_voronoi"]
                for r in steady(rec) if "build_feature_voronoi" in r["spans"])

"""Seconds of stage 1 a pair: the benchmark's spans around `prepare_pair`
and `segment_pair`, each ended by a synchronise, averaged over the window's
pairs (the profiled one left out)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import mean, steady  # noqa: E402


def read(rec):
    return mean(r["spans"]["prepare_pair"] + r["spans"]["segment_pair"]
                for r in steady(rec) if "prepare_pair" in r["spans"])

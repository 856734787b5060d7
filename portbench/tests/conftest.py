"""The benchmark's own tests: CPU at test size, except those marked `gpu`,
which decide inside a fixture whether there is a card.

`tiny_root` is a checkout-like directory holding a copy of `portbench/`
and a BENCHMARK.json with test-size cells added the way a later change adds
a cell: new files (a configuration, a traffic mix, a limits file) and new
entries, nothing edited."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the chip")
    return torch.device("cuda", 0)


def add_cell(root: str, name: str, config: str, traffic: str, limits: str | None) -> None:
    """Add a cell to `root` by new files and new entries only."""
    shutil.copy(os.path.join(DATA, config + ".json"),
                os.path.join(root, "portbench", "configs", config + ".json"))
    shutil.copy(os.path.join(DATA, traffic + ".json"),
                os.path.join(root, "portbench", "traffic", traffic + ".json"))
    if limits:
        shutil.copy(os.path.join(DATA, limits + ".json"),
                    os.path.join(root, "portbench", "limits", name + ".json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    if not any(c["name"] == config for c in b["configs"]):
        b["configs"].append({"name": config, "source": "test size", "reduced": [],
                             "file": f"portbench/configs/{config}.json", "why": "test size"})
    b["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                           "why": "test size"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and m["name"] != "setup_s":
            like = "pair" if "pair" in traffic else "serve"
            if (like == "pair") == ("pair" in m["workloads"][0].split(".")[1]):
                m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(b, f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(root, "BENCHMARK.json"))
    add_cell(root, "tiny.pair", "tiny", "tiny_pair", "tiny_limits")
    add_cell(root, "tiny.serve", "tiny", "tiny_serve", "tiny_limits")
    return root

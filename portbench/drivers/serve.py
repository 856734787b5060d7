"""The `serve` driver: many locations on one pair.  Set-up prepares and
segments one pair, drawn from the configuration's `phantom_seed`; each
request is a fresh set of queries with fresh sampling draws from the run's
seed, through `register_locations_staged`, answers on the host.

Set-up warms the lane buckets the traffic lists (`warm_buckets`): each is
captured once by a refine-all call (`register_locations` with that lane
budget on as many queries as fill it), whose waves replay the same graphs
as the staged entry point's; then `warmup_requests` requests from draws
disjoint from the window's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import draws, phantom, program


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.tracer = tracer
        vol = config["volume"]
        self.shape, self.spacing = tuple(vol["shape_zyx"]), tuple(vol["spacing_xyz"])
        D, H, W = self.shape
        self.extent = (W * self.spacing[0], H * self.spacing[1], D * self.spacing[2])
        self.cfg = program.pipeline_config(config["pipeline"])
        self.svm = program.verifier(config["verifier"])
        self.kept: dict[int, dict] = {}

    def _plan_args(self, purpose: int, i: int, n: int) -> tuple:
        return (draws.stream_seed(self.seed, purpose, 300000 + i), n,
                self.cfg.indexing.num_candidates, self.cfg.estimation.max_iterations,
                self.ctx.moving_features.capacity, self.ctx.fixed_features.capacity)

    def _plan(self, purpose: int, i: int, n: int):
        return program.sampling_plan(draws.plan_fields(*self._plan_args(purpose, i, n),
                                                       self.device))

    def setup(self) -> None:
        t0 = time.perf_counter()
        vol = self.config["volume"]
        base = phantom.dense_phantom(self.shape, self.spacing,
                                     self.config["phantom_seed"], self.device,
                                     blobs_per_mm3=vol["blobs_per_mm3"])
        # the pair is the configuration's, the same for every seed: the seed
        # draws the queries and the sampling, so seeds share one workload
        pseed = self.config["phantom_seed"]
        self.truth = phantom.true_transform(draws.rng(pseed, draws.TRUTH, 0),
                                            self.config["truth"],
                                            phantom.center_xyz(self.shape, self.spacing))
        g = torch.Generator(device=self.device).manual_seed(
            draws.stream_seed(pseed, draws.PHANTOM, 1))
        fixed = program.volume(phantom.add_noise(base, vol["noise"], g), self.spacing)
        moving = program.volume(phantom.add_noise(
            phantom.warp(base, self.spacing, *self.truth), vol["noise"], g), self.spacing)
        del base
        reg = program.registration()
        self._sync()
        parts = self.setup_parts = {"inputs": time.perf_counter() - t0}
        self.ctx = reg.segment_pair(moving, fixed, reg.prepare_pair(moving, fixed, self.cfg))
        self.volumes = (moving, fixed)  # the check's watershed reads them
        self._sync()
        parts["stage1"] = time.perf_counter() - t0 - parts["inputs"]
        C = self.cfg.indexing.num_candidates
        for b in self.traffic["warm_buckets"]:
            t1 = time.perf_counter()
            n = -(-b // C)
            q = draws.queries(draws.rng(self.seed, draws.WARMUP, 1000 + b), n, self.extent,
                              *self.traffic["query_box"])
            reg.register_locations(self.ctx, torch.as_tensor(q, device=self.device), self.cfg,
                                   self.svm, self._plan(draws.WARMUP, 1000 + b, n),
                                   lane_budget=b)
            self._sync()
            parts[f"bucket_{b}"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        for i in range(self.traffic["warmup_requests"]):
            self._serve(draws.WARMUP, i)
        self._sync()
        parts["warmup"] = time.perf_counter() - t1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve(self, purpose: int, i: int):
        reg = program.registration()
        q = draws.queries(draws.rng(self.seed, purpose, i), self.traffic["queries_per_request"],
                          self.extent, *self.traffic["query_box"])
        plan = self._plan(purpose, i, len(q))
        with self.tracer.span("serve"):
            out = reg.register_locations_staged(
                self.ctx, torch.as_tensor(q, device=self.device), self.cfg, self.svm, plan,
                lane_budget=self.config["lane_budget"])
            host = program.result_to_host(out)
        return q, host

    def request(self, i: int) -> dict:
        before = program.wave_stats()
        q, host = self._serve(draws.WINDOW, i)
        after = program.wave_stats()
        built = {b: v for b, v in after["build_s"].items()
                 if len(v) > len(before["build_s"].get(b, []))}
        self.kept[i] = {"queries": q, "truth": self.truth,
                        "plan": self._plan_args(draws.WINDOW, i, len(q)), **host}
        return {"queries": len(q), "graph_build_s": sum(sum(v) for v in built.values()),
                "buckets_built": sorted(built), "waves": after["waves"] - before["waves"],
                "syncs": after["syncs"] - before["syncs"]}

    def forget(self, i: int) -> None:
        self.kept.pop(i, None)

    def check_data(self, picked: list[int], rng: np.random.Generator):
        """[(stage1, [request, ...])]: the one pair's stage 1 and the picked
        requests."""
        s1 = program.stage1_outputs(program.stage1_refs(self.ctx, *self.volumes), rng,
                                    self.traffic["voronoi_samples"])
        return [(s1, [self.kept[i] for i in picked])]

    def free(self) -> None:
        self.ctx, self.kept, self.volumes = None, {}, None
        program.drop_graphs()

"""The `pair` driver: each request is a new study pair and its queries,
timed from the two volumes on the card to the answers on the host:
`prepare_pair` -> `segment_pair` -> `register_locations_staged`.

Pairs are drawn in set-up from one phantom (the configuration's
`phantom_seed`): each pair warps it by a true transform of its own and adds
noise of its own to both volumes, both drawn from the run's seed, so no two
requests carry the same volume bytes.  The pool holds `pool_pairs`; a
request past the pool makes its pair inside the window and says so.
"""

from __future__ import annotations

import sys
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
        self.kept: dict[int, dict] = {}  # request -> what its check reads

    # -- inputs

    def _pair(self, purpose: int, i: int):
        vol = self.config["volume"]
        truth = phantom.true_transform(draws.rng(self.seed, draws.TRUTH, purpose * 100000 + i),
                                       self.config["truth"],
                                       phantom.center_xyz(self.shape, self.spacing))
        g = torch.Generator(device=self.device).manual_seed(
            draws.stream_seed(self.seed, purpose, 200000 + i))
        fixed = phantom.add_noise(self.base, vol["noise"], g)
        moving = phantom.add_noise(phantom.warp(self.base, self.spacing, *truth), vol["noise"], g)
        return (program.volume(moving, self.spacing), program.volume(fixed, self.spacing), truth)

    def setup(self) -> None:
        t0 = time.perf_counter()
        vol = self.config["volume"]
        self.base = phantom.dense_phantom(self.shape, self.spacing,
                                          self.config["phantom_seed"], self.device,
                                          blobs_per_mm3=vol["blobs_per_mm3"])
        self.pool = [self._pair(draws.WINDOW, i) for i in range(self.traffic["pool_pairs"])]
        self._sync()
        self.setup_parts = {"inputs": time.perf_counter() - t0}
        for i in range(self.traffic["warmup_requests"]):
            self._serve(self._pair(draws.WARMUP, i), draws.WARMUP, i)
        program.drop_graphs()
        self._sync()
        self.setup_parts["warmup"] = time.perf_counter() - t0 - self.setup_parts["inputs"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- one request

    def _serve(self, pair, purpose: int, i: int):
        moving, fixed, truth = pair
        reg = program.registration()
        tr = self.tracer
        q = draws.queries(draws.rng(self.seed, purpose, i), self.traffic["queries_per_request"],
                          self.extent, *self.traffic["query_box"])
        with tr.span("prepare_pair"):
            ctx = reg.prepare_pair(moving, fixed, self.cfg)
        with tr.span("segment_pair"):
            ctx = reg.segment_pair(moving, fixed, ctx)
        plan_args = (draws.stream_seed(self.seed, purpose, 300000 + i), len(q),
                     self.cfg.indexing.num_candidates, self.cfg.estimation.max_iterations,
                     ctx.moving_features.capacity, ctx.fixed_features.capacity)
        plan = program.sampling_plan(draws.plan_fields(*plan_args, self.device))
        with tr.span("serve"):
            out = reg.register_locations_staged(
                ctx, torch.as_tensor(q, device=self.device), self.cfg, self.svm, plan,
                lane_budget=self.config["lane_budget"])
            host = program.result_to_host(out)
        return ctx, q, truth, host, plan_args

    def request(self, i: int) -> dict:
        if i < len(self.pool):
            pair, self.pool[i] = self.pool[i], None
        else:
            print(f"portbench: request {i} is past the pool of {len(self.pool)} pairs; "
                  "its pair is made inside the window", file=sys.stderr)
            pair = self._pair(draws.WINDOW, i)
        ctx, q, truth, host, plan_args = self._serve(pair, draws.WINDOW, i)
        stats = program.wave_stats()
        # a new context captures its graphs anew: all of them are this pair's
        graph_s = sum(sum(v) for v in stats["build_s"].values())
        self.kept[i] = {"stage1": program.stage1_refs(ctx, pair[0], pair[1]), "queries": q,
                        "truth": truth, "plan": plan_args, **host}
        return {"queries": len(q), "graph_build_s": graph_s,
                "waves": stats["waves"], "syncs": stats["syncs"]}

    def forget(self, i: int) -> None:
        self.kept.pop(i, None)

    def check_data(self, picked: list[int], rng: np.random.Generator):
        """[(stage1, [request])] of the picked requests."""
        out = []
        for i in picked:
            k = self.kept[i]
            s1 = program.stage1_outputs(k["stage1"], rng, self.traffic["voronoi_samples"])
            out.append((s1, [{kk: v for kk, v in k.items() if kk != "stage1"}]))
        return out

    def free(self) -> None:
        self.pool, self.kept, self.base = [], {}, None
        program.drop_graphs()

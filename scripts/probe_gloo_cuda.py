"""Which collectives the gloo backend of torch.distributed takes with CUDA
tensors, and whether NCCL and `init_device_mesh` accept two ranks on one
card: the facts behind `lrr_tpu_torch/parallel/distributed.py`'s choice of
backend and its host-memory transport.

    python3 scripts/probe_gloo_cuda.py

Each probe runs in its own pair of processes (ranks 0 and 1, both on card 0,
joined through a tcp:// rendezvous on localhost) with a time limit, so a
probe that hangs or kills its process is reported and does not stop the
others.  One JSON line a probe, then a summary line; the summary is also
written to chiprun_out/probe_gloo_cuda.json.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

PROBES = ("all_gather", "all_reduce", "broadcast", "send_recv", "nccl_two_ranks_one_card",
          "init_device_mesh_gloo_cuda")
TIMEOUT_S = 90


def rank(probe: str, r: int, port: int) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    backend = "nccl" if probe == "nccl_two_ranks_one_card" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=r,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.full((4,), float(r + 1), device="cuda")
    if probe in ("all_gather", "nccl_two_ranks_one_card"):
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = [float(p[0]) for p in parts] == [1.0, 2.0]
    elif probe == "all_reduce":
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif probe == "broadcast":
        dist.broadcast(x, src=0)
        ok = float(x[0]) == 1.0
    elif probe == "send_recv":
        if r == 0:
            dist.send(x, dst=1)
            ok = True
        else:
            dist.recv(x, src=0)
            ok = float(x[0]) == 1.0
    else:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("dp",))
        ok = mesh.size() == 2
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print(json.dumps({"rank": r, "ok": bool(ok)}), flush=True)


def run(probe: str) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), probe, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs, hung = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, TIMEOUT_S - (time.perf_counter() - t0)))[0])
        except subprocess.TimeoutExpired:
            hung = True
            p.kill()
            outs.append(p.communicate()[0])
    oks = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith('{"rank"')]
        oks.append(bool(lines) and json.loads(lines[-1])["ok"])
    errors = [next((ln for ln in reversed(out.splitlines()) if "Error" in ln), out[-300:])
              for out, ok in zip(outs, oks) if not ok]
    return {"probe": probe, "works": all(oks) and not hung, "hung": hung,
            "exit_codes": [p.returncode for p in procs], "error": errors[0] if errors else None,
            "seconds": time.perf_counter() - t0}


def main() -> None:
    import torch

    results = []
    for probe in PROBES:
        results.append(run(probe))
        print(json.dumps(results[-1]), flush=True)
    summary = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "card": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
               "works": {r["probe"]: r["works"] for r in results}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_gloo_cuda.json"), "w") as f:
        json.dump({"summary": summary, "probes": results}, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4:
        rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()

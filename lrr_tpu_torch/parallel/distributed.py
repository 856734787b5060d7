"""Multi-process runtime over `torch.distributed`
(lrr_tpu/parallel/distributed.py).

lrr_tpu's mesh is devices inside one process, and XLA places the
collectives.  Here a mesh is ranks of a process group, one process a rank
and one device a process, and every collective is placed by hand: the
functions below are the only ones the port calls.

Environment-triggered, so single-process users never pay for it:

    LRR_COORDINATOR=host0:29500 LRR_NUM_PROCESSES=2 LRR_PROCESS_ID=1 \\
        python -m lrr_tpu_torch.cli batch ...

rendezvouses at `tcp://host0:29500`; under `torchrun`, `LRR_DISTRIBUTED=1`
takes the rendezvous from its `MASTER_ADDR` / `MASTER_PORT` / `WORLD_SIZE` /
`RANK` (`env://`).

Devices and backends.  With CUDA, a rank works on card `LOCAL_RANK %
device_count` (`LOCAL_RANK` is torchrun's; the coordinator route takes the
process id), made the current device here, so "cuda" means the rank's own
card.  When every local rank has a card of its own, CUDA tensors go over
NCCL and CPU tensors over gloo (`"cpu:gloo,cuda:nccl"`).  When ranks share
a card (NCCL refuses two ranks on one device) or there is no card, the
backend is gloo, and a CUDA tensor is copied to host memory for the
collective and back (`_to_backend`): that is the transport, not a
fallback.  The group has a timeout, so a rank that diverges fails the run
instead of hanging it.

Import this module directly in launcher code: it imports only torch, numpy
and the standard library, and `maybe_initialize_distributed` must run before
a collective is made (`cli.main` calls it first).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("LRR_PROCESS_ID", "0")))


def _backend(local_world: int) -> str:
    if torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def maybe_initialize_distributed() -> bool:
    """Initialise the default process group from the environment.

    Returns True when running distributed (after initialisation), False for
    the ordinary single-process case.  Idempotent."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("LRR_COORDINATOR")
    if coord:
        world = int(os.environ["LRR_NUM_PROCESSES"])
        rank = int(os.environ["LRR_PROCESS_ID"])
        init = f"tcp://{coord}"
    elif os.environ.get("LRR_DISTRIBUTED") == "1":
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init = "env://"
    else:
        return False
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dist.init_process_group(
        _backend(local_world), init_method=init, world_size=world, rank=rank, timeout=TIMEOUT
    )
    return True


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) without a
    process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> str:
    """The default group's backend ("gloo", "cpu:gloo,cuda:nccl"), or
    "none" without a process group."""
    return str(dist.get_backend()) if dist.is_initialized() else "none"


class Mesh:
    """The ranks of the default process group as a grid with named axes
    (what `jax.sharding.Mesh` is to lrr_tpu).  Rank r sits at the row-major
    coordinate of r in `shape`; each axis of more than one rank has a
    process group per line of the grid along it (every rank creates every
    group, in one order, as `dist.new_group` requires).  Without a process
    group the mesh is one rank and every collective returns its input."""

    def __init__(self, axis_names: tuple[str, ...], shape: tuple[int, ...]):
        rank, world = process_info()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {int(np.prod(shape))} "
                             f"processes, the process group has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = world
        self.rank = rank
        grid = np.arange(world).reshape(shape)
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, shape))))
        self._groups: dict[str, object] = {}
        for ax, name in enumerate(self.axis_names):
            if shape[ax] == 1 or shape[ax] == world:
                continue  # no collective, or the whole world
            for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[name] = group

    def axis_size(self, axis=None) -> int:
        """Ranks along `axis` (a name), or in the whole mesh (None)."""
        return self.size if axis is None else self.shape[axis]

    def axis_index(self, axis=None) -> int:
        """This rank's coordinate along `axis`, or its rank (None): the
        index of its block when that axis, or all of them row-major, split
        an array."""
        return self.rank if axis is None else self.coords[axis]

    def group(self, axis=None):
        """The process group of this rank's line along `axis` (None for the
        world)."""
        if axis is None or self.shape[axis] == self.size:
            return None
        return self._groups[axis]


def _to_backend(x: torch.Tensor) -> torch.Tensor:
    """`x` as the backend takes it: gloo gets a CUDA tensor through host
    memory unless NCCL carries CUDA tensors."""
    if x.is_cuda and "nccl" not in backend():
        return x.cpu().contiguous()
    return x.contiguous()


def all_gather(mesh: Mesh | None, x: torch.Tensor, axis=None, dim: int = 0) -> torch.Tensor:
    """The equal-sized blocks `x` of the ranks along `axis` (None: every
    rank, in rank order), concatenated along `dim` in coordinate order, on
    `x`'s device."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    xb = _to_backend(x)
    parts = [torch.empty_like(xb) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, xb, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce_sum(mesh: Mesh | None, x: torch.Tensor, axis=None) -> torch.Tensor:
    """The sum of `x` over the ranks along `axis`; every rank gets the same
    bits (the backend picks the order of the sum: hazard H1)."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    xb = _to_backend(x.clone())
    dist.all_reduce(xb, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return xb.to(x.device)


def all_reduce_min(mesh: Mesh | None, x: torch.Tensor, axis=None) -> torch.Tensor:
    """The elementwise minimum of `x` over the ranks along `axis`."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    xb = _to_backend(x.clone())
    dist.all_reduce(xb, op=dist.ReduceOp.MIN, group=mesh.group(axis))
    return xb.to(x.device)


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if tree is None:
        return []
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_rebuild(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_rebuild(getattr(tree, f.name), leaves)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_rebuild(item, leaves) for item in tree)
    if isinstance(tree, dict):
        return {k: tree_rebuild(tree[k], leaves) for k in tree}
    return None


def gather_rows(mesh: Mesh | None, tree, axis=None):
    """Every tensor of a tree (tensors, dataclasses, tuples, lists, dicts)
    gathered along its leading dim over the ranks along `axis`, in ONE
    collective: the leaves travel as the bytes of one [rows, bytes] uint8
    tensor, so every dtype round-trips exactly.  Every leaf has the same
    leading dim on every rank."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return tree
    leaves = tree_leaves(tree)
    rows = leaves[0].shape[0]
    for x in leaves:
        if x.dim() == 0 or x.shape[0] != rows:
            raise ValueError(f"gather_rows: leading dims differ ({tuple(x.shape)}, {rows} rows)")
    packed = torch.cat([x.contiguous().reshape(rows, -1).view(torch.uint8) for x in leaves], 1)
    full = all_gather(mesh, packed, axis, dim=0)
    out, col = [], 0
    for x in leaves:
        width = int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()
        part = full[:, col : col + width].contiguous().view(x.dtype)
        out.append(part.reshape((full.shape[0],) + tuple(x.shape[1:])))
        col += width
    return tree_rebuild(tree, iter(out))


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every rank of every process."""
    return Mesh((axis,), (process_info()[1],))


def host_local_to_global(mesh: Mesh, local) -> torch.Tensor:
    """The global array from each process's equal-sized block of rows
    (process-major order), on every rank."""
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    return all_gather(mesh, local, None, dim=0)


def global_to_host_local(garr) -> np.ndarray:
    """This process's rows of a global array split evenly over the
    processes along its leading axis."""
    rank, world = process_info()
    rows = garr.shape[0] // world
    block = garr[rank * rows : (rank + 1) * rows]
    return block.cpu().numpy() if isinstance(block, torch.Tensor) else np.asarray(block)

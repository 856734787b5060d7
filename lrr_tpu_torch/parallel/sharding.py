"""Distribution of the registration workload over ranks
(lrr_tpu/parallel/sharding.py).

The scaling axes are lrr_tpu's:

  dp ("data")   query locations / candidates / volume pairs: each rank
                refines its block of the lanes (`register_locations*(mesh=)`);
  mp ("match")  within one estimation, the per-match partial 12x12
                Gauss-Newton systems: each rank reduces its block of the
                matches and an all-reduce adds the 12x12 / 12x1 partials
                (`register_candidate(mesh=, match_axis="mp")`), the analogue
                of the reference's per-thread AtA/Atb accumulators and serial
                reduction (rrl_estimation_symmetric_ICP_matching_all
                .txx:774-877).

A mesh here is ranks of a process group (`parallel.distributed.Mesh`); an
array is split over it by each rank taking its own block.
"""

from __future__ import annotations

import torch

from lrr_tpu_torch.models.affine import Affine3D, normal_equations_terms
from lrr_tpu_torch.parallel.distributed import (
    Mesh, all_reduce_sum, process_info, tree_leaves, tree_rebuild,
)


def default_dp(n: int) -> int:
    """The largest power of two <= sqrt(n) that divides n."""
    dp = 1
    while n % (dp * 2) == 0 and (dp * 2) ** 2 <= n:
        dp *= 2
    return dp


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """A (dp, mp) mesh over the ranks of the process group (all of them: a
    rank cannot sit out); dp defaults to `default_dp(n)`."""
    world = process_info()[1]
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, the process group has {world} ranks")
    if dp is None:
        dp = default_dp(n)
    if n % dp != 0:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return Mesh(("dp", "mp"), (dp, n // dp))


def distributed_normal_equations(
    mesh: Mesh,
    trans: Affine3D,
    from_xyz: torch.Tensor,  # [M / mp, 3]: this rank's block of the matches
    to_xyz: torch.Tensor,
    projector: torch.Tensor,
    weight: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted 12x12 normal equations with the match axis split over the
    'mp' axis: this rank's terms over its block, summed over the mp ranks
    by an all-reduce.  Every rank gets the same bits; against the sum over
    all matches in one process they differ by the order of the sum (H1)."""
    AtA, Atb = normal_equations_terms(trans, from_xyz, to_xyz, projector, weight)
    return all_reduce_sum(mesh, AtA, "mp"), all_reduce_sum(mesh, Atb, "mp")


def shard_candidates(mesh: Mesh, tree, axis: int = 0):
    """This rank's block along `axis` of every tensor of a tree, the
    ranks (dp, mp) flattened row-major, as `P(("dp", "mp"))` splits it."""
    n, i = mesh.size, mesh.rank

    def block(x: torch.Tensor) -> torch.Tensor:
        if x.shape[axis] % n:
            raise ValueError(f"shard_candidates: axis {axis} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        b = x.shape[axis] // n
        return x.narrow(axis, i * b, b)

    return tree_rebuild(tree, iter([block(x) for x in tree_leaves(tree)]))

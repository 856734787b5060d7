"""Indexing quality evaluation against ground truth
(lrr_tpu/eval/indexing_eval.py).

Re-implements the evaluation half of rrl/examples/indexing_one_descriptor
.cxx (:1040-1060,1547-1596) and indexing_shape_context3dITK: per query
location, a candidate (moving keypoint, fixed keypoint) is GOOD iff the
GT-mapped fixed keypoint lies within `dist_mm` (9 mm) of the moving
keypoint and both the normal and binormal angles agree within `angle_deg`
(20 deg).  Reports goodAtFirst / goodIn10 / goodAtAll counts and the rank
of the first good candidate.  Batched over queries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lrr_tpu_torch.config import IndexingConfig
from lrr_tpu_torch.matching.indexing import descriptor_nn_table, generate_candidates
from lrr_tpu_torch.types import DescriptorSet


class IndexingEval(NamedTuple):
    good_at_first: torch.Tensor  # [Q] bool
    good_in_10: torch.Tensor
    good_at_all: torch.Tensor
    first_good_rank: torch.Tensor  # [Q] int (-1 if none)
    n_candidates: torch.Tensor  # [Q]


def _angles_ok(v_mapped, v_ref, angle_deg):
    c = (v_mapped * v_ref).sum(-1).abs()
    ang = torch.rad2deg(torch.acos(torch.clamp(c, -1.0, 1.0)))
    return ang <= angle_deg


def evaluate_indexing(
    queries: torch.Tensor,  # [Q, 3] fixed-space query locations
    moving: DescriptorSet,
    fixed: DescriptorSet,
    gt_apply,  # fixed-space -> moving-space point map on [..., P, 3]
    cfg: IndexingConfig,
) -> IndexingEval:
    table = descriptor_nn_table(fixed, moving)
    c = generate_candidates(queries, moving, fixed, cfg, nn_table=table)

    fk, mk = fixed.keypoints, moving.keypoints
    f_xyz = fk.xyz[c.fixed_idx]  # [Q, C, 3]
    m_xyz = mk.xyz[c.moving_idx]
    mapped = gt_apply(f_xyz)
    dist_ok = torch.linalg.norm(mapped - m_xyz, dim=-1) <= cfg.good_distance_mm

    # map fixed frames through the local GT Jacobian by finite steps
    def map_dir(x, v):
        step = gt_apply(x + v) - gt_apply(x)
        return step / torch.clamp(torch.linalg.norm(step, dim=-1, keepdim=True), min=1e-12)

    n_ok = _angles_ok(
        map_dir(f_xyz, fk.normal[c.fixed_idx]), mk.normal[c.moving_idx], cfg.good_angle_deg
    )
    b_ok = _angles_ok(
        map_dir(f_xyz, fk.binormal[c.fixed_idx]), mk.binormal[c.moving_idx], cfg.good_angle_deg
    )
    good = c.mask & dist_ok & n_ok & b_ok

    any_good = good.any(1)
    first = good.to(torch.int8).argmax(1)
    return IndexingEval(
        good_at_first=good[:, 0] & c.mask[:, 0],
        good_in_10=good[:, : min(10, good.shape[1])].any(1),
        good_at_all=any_good,
        first_good_rank=torch.where(any_good, first, torch.full_like(first, -1)),
        n_candidates=c.mask.sum(1),
    )

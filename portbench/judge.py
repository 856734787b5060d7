"""How `correct` is decided: the program's outputs against the plain
reference (`reference/`), number by number, each against the limit that
`limits/<workload>.json` gives it.

What a run hands in (the driver takes it from the program's objects;
nothing here imports the program), as tensors or arrays:

  stage1   a pair's stage-1 outputs: both feature sets, keypoints and
           descriptors, the fixed -> moving descriptor-NN table, both
           Voronoi index maps (and each read at voxels drawn from the seed),
           the watershed region of every feature, and the two volumes;
  request  per checked request: its queries, true transform, the seed and
           sizes of its sampling plan, and the `LocationResult` fields of
           PASS 1 and of the refined lanes.

The numbers (each the worst over everything checked; lower is better):

  nn_gap         stage 1, K2: the NN table against float64 brute force, the
                 distance reported vs the distance to the index reported and
                 that vs the least, over the median least distance;
  voronoi_gap    stage 1, Voronoi maps: at the sampled voxels, the distance
                 (mm) to the feature the map names minus the least distance;
  desc_gap_q90   stage 1, descriptors: per valid keypoint the largest of its
                 descriptor's and its frame's distance to the reference's,
                 recomputed from the keypoints and features; the 90th
                 percentile over both volumes' keypoints;
  label_miss     stage 1, watershed regions: the features' regions against
                 the reference's watershed of the volumes, the share of
                 features outside their region's largest overlap;
  cand_gap       PASS 1, candidates: the candidates' float64 NN distances
                 against the reference's own choice, over the median least
                 distance; 1e9 for another number of candidates;
  init_gap       PASS 1, initial transforms: the query carried into moving
                 space (mm) by each candidate's keypoint frames;
  rank_miss      PASS 1, ranks: queries whose rank order is not the stable
                 order of the reported keys;
  trace_gap      waves: each refined lane's transfer-error trace from its own
                 transform and covariance against its measurements;
  lane_T_q90, lane_cov_q90, lane_meas_q90
                 waves: every refined lane refined again by the reference
                 (ICP, backward covariance, measurements, verifier) from its
                 initial transform; per lane the transform's largest
                 distance (mm) at the corners of its 50 mm ROI box, the
                 covariance's relative Frobenius distance, and the largest
                 relative gap of the 8 measurements and of the probability
                 (1e9 where the valid or oscillation flags differ); the 90th
                 percentile over the lanes, since a sampled robust ICP may
                 end apart on a few lanes at float32's rounding (the medians
                 beside them are reported, not limited);
  svm_gap        waves, verifier: each refined lane's probability against the
                 plain SVM of its measurements;
  select_miss    early exit: queries whose selection is not the first
                 verified candidate in rank order;
  gt_median_mm   the median over selected queries of the error against the
                 true transform;
  unverified_share  the share of queries with no verified candidate.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import draws
from portbench.reference import icp, plain, stage1 as ref1
from portbench.yardstick import gt_errors_mm

BIG = 1e9
LANE_CHUNK = 256
PLAN_LANE_FIELDS = ("icp_scores_m", "icp_scores_f", "icp_offsets_f", "icp_offsets_b",
                    "icp_stats_offset_f", "icp_stats_offset_b", "cov_scores_f", "cov_scores_m",
                    "cov_offset_b", "cov_offset_f")


def _t(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def _h(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kp_index(xyz_all: np.ndarray, mask: np.ndarray):
    """{(x, y, z) bytes: index} of the valid keypoints."""
    return {xyz_all[i].astype(np.float32).tobytes(): i for i in np.nonzero(mask)[0]}


def _fs(d: dict, device) -> dict:
    return {k: _t(v, device) for k, v in d.items()}


def _quantile(x: list, q: float) -> float:
    v = np.concatenate(x) if x else np.zeros(0)
    return float(np.quantile(v, q)) if v.size else 0.0


# ---------------------------------------------------------------------------
# what the numbers are computed from
# ---------------------------------------------------------------------------


def candidates_of(r: dict, f_of: dict, m_of: dict):
    """The program's candidates as (fixed, moving) keypoint indices [Q, C]
    (-1 where none or not found among the keypoints), by their positions."""
    cmask = np.asarray(r["cmask"])
    Q, C = cmask.shape
    f_p = np.full((Q, C), -1, np.int64)
    m_p = np.full((Q, C), -1, np.int64)
    for i, j in zip(*np.nonzero(cmask)):
        f_p[i, j] = f_of.get(np.asarray(r["kpf_xyz"][i, j], np.float32).tobytes(), -1)
        m_p[i, j] = m_of.get(np.asarray(r["kpm_xyz"][i, j], np.float32).tobytes(), -1)
    return f_p, m_p


def lane_inputs(stage1: dict, r: dict, lanes_q, lanes_c, fi, mi, config: dict, device,
                mode: str) -> dict:
    """A lane's query, its initial transform from the candidate's keypoint
    frames, its ROIs grown from the regions, and its draws (the sampling
    plan made again from its seed)."""
    est = config["pipeline"]["estimation"]
    q = _t(r["queries"], device)[torch.as_tensor(lanes_q, device=device)]
    kf, km = _fs(stage1["kp_f"], device), _fs(stage1["kp_m"], device)
    fi_t, mi_t = torch.as_tensor(fi, device=device), torch.as_tensor(mi, device=device)
    init = plain.initial_transform(q, kf["xyz"][fi_t], kf["normal"][fi_t], kf["binormal"][fi_t],
                                   km["xyz"][mi_t], km["normal"][mi_t], km["binormal"][mi_t],
                                   mode)
    half = est["roi_mm"] / 2.0
    fs_m, fs_f = _fs(stage1["fs_m"], device), _fs(stage1["fs_f"], device)
    lab_m, lab_f = _t(stage1["labels_m"], device), _t(stage1["labels_f"], device)
    qm, qd = init[2].double(), q.double()
    m_sel, f_sel = [], []
    for a in range(0, len(lanes_q), LANE_CHUNK):
        s = slice(a, a + LANE_CHUNK)
        m_sel.append(ref1.select_regions(fs_m["xyz"], fs_m["mask"], lab_m, qm[s],
                                         est["target_region_features"], qm[s] - half,
                                         qm[s] + half))
        f_sel.append(ref1.select_regions(fs_f["xyz"], fs_f["mask"], lab_f, qd[s],
                                         est["target_region_features"], qd[s] - half,
                                         qd[s] + half))
    seed, Q, C, T, Nm, Nf = r["plan"]
    plan = draws.plan_fields(seed, Q, C, T, Nm, Nf, device)
    lq, lc = torch.as_tensor(lanes_q, device=device), torch.as_tensor(lanes_c, device=device)
    out = {k: plan[k][lq, lc] for k in PLAN_LANE_FIELDS}
    del plan
    return {**out, "query": q, "init": init, "m_sel": torch.cat(m_sel), "f_sel": torch.cat(f_sel)}


def refine_lanes(stage1: dict, lanes: dict, config: dict, device, mode: str) -> dict:
    """The reference's refinement, measurements and probability of the
    lanes, in chunks."""
    est = dict(config["pipeline"]["estimation"])
    vor = [{"index": _t(v["index"], device), "origin": _t(v["origin"], device),
            "spacing": _t(v["spacing"], device)} for v in (stage1["vor_m"], stage1["vor_f"])]
    fs_m, fs_f = _fs(stage1["fs_m"], device), _fs(stage1["fs_f"], device)
    model = plain.read_libsvm(config["verifier"])
    parts = []
    n = lanes["query"].shape[0]
    for a in range(0, n, LANE_CHUNK):
        s = slice(a, a + LANE_CHUNK)
        sub = {k: (tuple(x[s] for x in v) if k == "init" else v[s]) for k, v in lanes.items()}
        with plain.no_tf32():
            res = icp.lanes_result(sub, fs_m, fs_f, vor[0], vor[1], est, mode)
        res["probs"] = plain.svm_probability(model, res["meas"], mode)
        parts.append(res)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]} if parts else {}


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------


def judge(stage1: dict, requests: list[dict], config: dict, device) -> dict:
    """The numbers above ({name: value}) of one pair and its checked
    requests."""
    pipe = config["pipeline"]
    out = {}
    # -- stage 1: the NN table
    desc_f, desc_m = _t(stage1["desc_f"], device), _t(stage1["desc_m"], device)
    mask_f, mask_m = _t(stage1["kp_f"]["mask"], device), _t(stage1["kp_m"]["mask"], device)
    d2 = torch.cat([plain.sq_dists(desc_f[i : i + 1024], desc_m, "f64")
                    for i in range(0, desc_f.shape[0], 1024)])
    d2 = torch.clamp(torch.where(mask_m[None, :], d2, torch.full_like(d2, math.inf)), min=0)
    d_min = torch.sqrt(d2.min(1).values)
    nn_idx, nn_dist = _t(stage1["nn_idx"], device).long(), _t(stage1["nn_dist"], device)
    live = mask_f & torch.isfinite(d_min)
    scale = float(d_min[live].median()) if bool(live.any()) else 1.0
    d_at = torch.sqrt(d2.gather(1, nn_idx.clamp(0, desc_m.shape[0] - 1)[:, None])[:, 0])
    gap = torch.maximum((nn_dist.double() - d_at).abs(), d_at - d_min)
    gap = torch.nan_to_num(gap, nan=BIG, posinf=BIG)
    out["nn_gap"] = float(gap[live].max()) / scale if bool(live.any()) else 0.0

    # -- stage 1: the Voronoi maps at the sampled voxels
    vgap = 0.0
    for side in stage1.get("voronoi", []):
        xyz, fmask = _t(side["xyz"], device).double(), _t(side["mask"], device)
        pts = plain.voxel_centres(_t(side["vox_zyx"], device), _t(side["origin"], device),
                                  _t(side["spacing"], device))
        best = plain.nearest_feature(pts, xyz, fmask, "f64")
        got = _t(side["index"], device).long()
        if best.numel() == 0 or int(best[0]) < 0:
            continue
        d_best = torch.linalg.norm(pts - xyz[best], dim=1)
        ok = (got >= 0) & (got < xyz.shape[0])
        d_got = torch.linalg.norm(pts - xyz[got.clamp(0, xyz.shape[0] - 1)], dim=1)
        d_got = torch.where(ok & fmask[got.clamp(0, xyz.shape[0] - 1)], d_got,
                            torch.full_like(d_got, BIG))
        vgap = max(vgap, float((d_got - d_best).max()))
    out["voronoi_gap"] = vgap

    # -- stage 1: descriptors and keypoint frames, from the keypoints and features
    dgaps = []
    for kp, desc, fs in ((stage1["kp_f"], desc_f, stage1["fs_f"]),
                         (stage1["kp_m"], desc_m, stage1["fs_m"])):
        k = _fs(kp, device)
        valid = k["mask"]
        rd, rdir, rbi, rok = ref1.descriptors(k["xyz"][valid], _fs(fs, device),
                                              pipe["descriptors"], "f64")
        g = torch.stack([torch.linalg.norm(desc[valid].double() - rd, dim=1),
                         torch.linalg.norm(k["normal"][valid].double() - rdir, dim=1),
                         torch.linalg.norm(k["binormal"][valid].double() - rbi, dim=1)]).amax(0)
        g = torch.where(rok, torch.nan_to_num(g, nan=BIG), torch.full_like(g, BIG))
        dgaps.append(_h(g))
    out["desc_gap_q90"] = _quantile(dgaps, 0.9)

    # -- stage 1: the watershed regions of the features
    miss = 0.0
    for vol, fs, lab in ((stage1["vol_f"], stage1["fs_f"], stage1["labels_f"]),
                         (stage1["vol_m"], stage1["fs_m"], stage1["labels_m"])):
        f = _fs(fs, device)
        ref_lab = ref1.labels_at(ref1.watershed(_t(vol, device), "f64"), f["xyz"],
                                 config["volume"]["spacing_xyz"])
        m = _h(f["mask"]).astype(bool)
        miss = max(miss, ref1.partition_miss(_h(lab)[m], _h(ref_lab)[m]))
    out["label_miss"] = miss

    # -- PASS 1 and the waves, request by request
    ref_nn = torch.sqrt(d2.min(1).values)  # float64 NN distance of each fixed keypoint
    kpf, kpm = stage1["kp_f"], stage1["kp_m"]
    f_of = _kp_index(_h(kpf["xyz"]), _h(kpf["mask"]))
    m_of = _kp_index(_h(kpm["xyz"]), _h(kpm["mask"]))
    kf, km = _fs(kpf, device), _fs(kpm, device)
    idx = pipe["indexing"]
    roi_mm = pipe["estimation"]["roi_mm"]
    model = plain.read_libsvm(config["verifier"])
    cand_gap = init_gap = trace_gap = svm_gap = 0.0
    rank_miss = select_miss = 0
    errs, n_queries, n_unverified = [], 0, 0
    lane_T, lane_cov, lane_meas = [], [], []
    for r in requests:
        q = _t(r["queries"], device)
        Q, C = np.asarray(r["cmask"]).shape
        n_queries += Q
        _, key_r, ok_r = plain.candidates(q, kf["xyz"], kf["mask"], ref_nn,
                                          idx["keypoint_radius_mm"], idx["max_query_keypoints"], C)
        f_p, m_p = candidates_of(r, f_of, m_of)
        cmask = np.asarray(r["cmask"])
        known = cmask & (f_p >= 0) & (m_p >= 0)
        if (cmask & ~known).any():
            cand_gap = BIG
        n_ref = _h(ok_r.sum(1))
        key_r_h, ref_nn_h = _h(key_r), _h(ref_nn)
        d_pair = _h(d2[torch.as_tensor(np.maximum(f_p, 0), device=device),
                       torch.as_tensor(np.maximum(m_p, 0), device=device)].sqrt())
        for i in range(Q):
            sel = np.nonzero(known[i])[0]
            if len(sel) != n_ref[i] or len(sel) != cmask[i].sum():
                cand_gap = BIG
                continue
            got = np.sort(ref_nn_h[f_p[i, sel]])
            want = np.sort(key_r_h[i, : n_ref[i]])
            g = max(np.abs(got - want).max(initial=0.0),
                    (d_pair[i, sel] - ref_nn_h[f_p[i, sel]]).max(initial=0.0))
            cand_gap = max(cand_gap, g / scale)
        # initial transforms: the query carried into moving space
        fi = torch.as_tensor(np.maximum(f_p, 0), device=device)
        mi = torch.as_tensor(np.maximum(m_p, 0), device=device)
        qm_ref = plain.query_in_moving(q[:, None, :].expand(Q, C, 3), kf["xyz"][fi],
                                       kf["normal"][fi], kf["binormal"][fi], km["xyz"][mi],
                                       km["normal"][mi], km["binormal"][mi], "f64")
        kn = torch.as_tensor(known, device=device)
        if bool(kn.any()):
            dq = torch.linalg.norm(_t(r["qm"], device).double() - qm_ref, dim=-1)[kn]
            init_gap = max(init_gap, float(torch.nan_to_num(dq, nan=BIG).max()))
        # ranks from the reported keys: usable first, stable
        usable = cmask & np.asarray(r["enough"])
        keys = np.where(usable, np.asarray(r["angles"], np.float64), np.inf)
        want_rank = np.argsort(keys, axis=1, kind="stable")
        rank = np.asarray(r["rank"])
        rank_miss += int((want_rank != rank).any(1).sum())
        # refined lanes: the trace of their own measurements, the verifier
        refined = np.asarray(r["refined"])
        rl = torch.as_tensor(refined & known, device=device)
        if bool(rl.any()):
            c_rl = _t(r["center"], device)[rl].double()
            tr = icp.max_transfer_trace((None, None, c_rl), _t(r["covar"], device)[rl].double(),
                                        qm_ref[rl] - roi_mm / 2.0, roi_mm, "f64")
            m = _t(r["meas"], device)[rl].double()
            near = torch.minimum((tr - m[:, 1]).abs(), (tr - m[:, 5]).abs()) \
                / tr.abs().clamp(min=1e-30)
            fin = torch.isfinite(m[:, 1]) & torch.isfinite(m[:, 5])
            if bool(fin.any()):
                trace_gap = max(trace_gap, float(torch.nan_to_num(near[fin], nan=BIG).max()))
        rt = torch.as_tensor(refined, device=device)
        meas = _t(r["meas"], device)[rt]
        p_ref = plain.svm_probability(model, meas, "f64")
        p_got = _t(r["probs"], device)[rt].double()
        both = torch.isfinite(p_ref) & torch.isfinite(p_got)
        if bool((torch.isfinite(p_ref) != torch.isfinite(p_got)).any()):
            svm_gap = BIG
        if bool(both.any()):
            svm_gap = max(svm_gap, float((p_ref - p_got)[both].abs().max()))
        # the lanes refined again by the reference
        lq, lc = np.nonzero(refined & known)
        if len(lq):
            lanes = lane_inputs(stage1, r, lq, lc, f_p[lq, lc], m_p[lq, lc], config, device,
                                "f64")
            ref = refine_lanes(stage1, lanes, config, device, "f64")
            gT, gC, gM = lane_gaps(r, lq, lc, lanes, ref, device)
            lane_T.append(gT)
            lane_cov.append(gC)
            lane_meas.append(gM)
            del lanes, ref
        # the early exit and the truth
        verified = refined & np.asarray(r["valid"]) & ~np.asarray(r["oscillated"]) \
            & (np.asarray(r["probs"]) > pipe["verify"]["accept_probability"]) & usable
        want_sel = plain.early_exit_selection(rank, usable, refined, verified)
        selected = np.asarray(r["selected"])
        select_miss += int((want_sel != selected).sum())
        s = np.nonzero(selected >= 0)[0]
        n_unverified += Q - len(s)
        if len(s):
            c = selected[s]
            errs.append(gt_errors_mm(np.asarray(r["A"])[s, c], np.asarray(r["t"])[s, c],
                                     np.asarray(r["center"])[s, c], np.asarray(r["queries"])[s],
                                     r["truth"], ids=s))
    out.update(cand_gap=cand_gap, init_gap=init_gap, rank_miss=rank_miss, trace_gap=trace_gap,
               svm_gap=svm_gap, select_miss=select_miss)
    for name, g in (("lane_T", lane_T), ("lane_cov", lane_cov), ("lane_meas", lane_meas)):
        out[name + "_q50"] = _quantile(g, 0.5)
        out[name + "_q90"] = _quantile(g, 0.9)
    out["lanes_checked"] = int(sum(len(g) for g in lane_T))
    e = np.concatenate(errs) if errs else np.zeros(0)
    out["gt_median_mm"] = float(np.median(e)) if e.size else BIG
    out["gt_max_mm"] = float(e.max()) if e.size else BIG
    out["unverified_share"] = n_unverified / max(n_queries, 1)
    return out


def lane_gaps(r: dict, lq, lc, lanes: dict, ref: dict, device):
    """Per lane: the transform's distance (mm) to the reference's at the 8
    corners of the ROI box, the covariance's relative distance, and the
    largest relative gap of the measurements and the probability."""
    def at(name, dtype=torch.float64):
        return _t(np.asarray(r[name])[lq, lc], device).to(dtype)

    qm = lanes["init"][2].double()
    corners = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                           dtype=torch.float64, device=device) * 25.0
    x = qm[:, None, :] + corners[None]
    A, t, c = at("A"), at("t"), at("center")
    got = torch.einsum("lij,lpj->lpi", A, x - c[:, None]) + t[:, None]
    want = torch.einsum("lij,lpj->lpi", ref["A"].double(), x - ref["c"].double()[:, None]) \
        + ref["t"].double()[:, None]
    gT = torch.linalg.norm(got - want, dim=-1).amax(1)
    cp, cr = at("covar"), ref["covar"].double()
    gC = torch.linalg.norm((cp - cr).flatten(1), dim=1) \
        / torch.linalg.norm(cr.flatten(1), dim=1).clamp(min=1e-30)
    mp, mr = at("meas"), ref["meas"].double()
    gM = ((mp - mr).abs() / mr.abs().clamp(min=1e-6)).amax(1)
    gM = torch.maximum(gM, (at("probs") - ref["probs"].double()).abs())
    flags = (at("valid", torch.bool) != ref["valid"]) | (at("oscillated", torch.bool)
                                                        != ref["oscillated"])
    gM = torch.where(flags, torch.full_like(gM, BIG), gM)
    return tuple(_h(torch.nan_to_num(g, nan=BIG, posinf=BIG)) for g in (gT, gC, gM))


# ---------------------------------------------------------------------------
# the control
# ---------------------------------------------------------------------------


def control(stage1: dict, requests: list[dict], config: dict, device):
    """The control of `correct`: the reference in TF32 (`plain.tf32`) put in
    the program's place.  Returns a copy of (stage1, requests) whose
    outputs are the control's wherever the reference computes them; the
    candidates, ranks and the lanes chosen for refinement stay the
    program's.  Judged as a run's outputs are, it has to come out not
    correct."""
    pipe = config["pipeline"]
    s1 = dict(stage1)
    for kp, dk, fs in (("kp_f", "desc_f", "fs_f"), ("kp_m", "desc_m", "fs_m")):
        k = _fs(stage1[kp], device)
        valid = k["mask"]
        rd, rdir, rbi, rok = ref1.descriptors(k["xyz"][valid], _fs(stage1[fs], device),
                                              pipe["descriptors"], "tf32")
        desc = _t(stage1[dk], device).clone()
        normal, binormal = k["normal"].clone(), k["binormal"].clone()
        desc[valid], normal[valid], binormal[valid] = rd, rdir, rbi
        s1[dk] = desc
        s1[kp] = {**stage1[kp], "normal": normal, "binormal": binormal}
    desc_f, desc_m = _t(s1["desc_f"], device), _t(s1["desc_m"], device)
    s1["nn_idx"], s1["nn_dist"] = plain.nn_table(
        desc_f, desc_m, _t(stage1["kp_m"]["mask"], device), "tf32")
    s1["voronoi"] = []
    for side in stage1.get("voronoi", []):
        pts = plain.voxel_centres(_t(side["vox_zyx"], device), _t(side["origin"], device),
                                  _t(side["spacing"], device))
        s1["voronoi"].append({**side, "index": plain.nearest_feature(
            pts, _t(side["xyz"], device), _t(side["mask"], device), "tf32")})
    for vol, fs, lab in (("vol_f", "fs_f", "labels_f"), ("vol_m", "fs_m", "labels_m")):
        s1[lab] = ref1.labels_at(ref1.watershed(_t(stage1[vol], device), "tf32"),
                                 _t(stage1[fs]["xyz"], device), config["volume"]["spacing_xyz"])
    kpf, kpm = s1["kp_f"], s1["kp_m"]
    f_of = _kp_index(_h(kpf["xyz"]), _h(kpf["mask"]))
    m_of = _kp_index(_h(kpm["xyz"]), _h(kpm["mask"]))
    kf, km = _fs(kpf, device), _fs(kpm, device)
    reqs = []
    for r in requests:
        r = dict(r)
        q = _t(r["queries"], device)
        Q, C = np.asarray(r["cmask"]).shape
        f_p, m_p = candidates_of(r, f_of, m_of)
        fi = torch.as_tensor(np.maximum(f_p, 0), device=device)
        mi = torch.as_tensor(np.maximum(m_p, 0), device=device)
        r["qm"] = _h(plain.query_in_moving(
            q[:, None, :].expand(Q, C, 3), kf["xyz"][fi], kf["normal"][fi], kf["binormal"][fi],
            km["xyz"][mi], km["normal"][mi], km["binormal"][mi], "tf32"))
        known = np.asarray(r["cmask"]) & (f_p >= 0) & (m_p >= 0)
        lq, lc = np.nonzero(np.asarray(r["refined"]) & known)
        if len(lq):
            lanes = lane_inputs(s1, r, lq, lc, f_p[lq, lc], m_p[lq, lc], config, device, "tf32")
            res = refine_lanes(s1, lanes, config, device, "tf32")
            for name, src in (("A", "A"), ("t", "t"), ("center", "c"), ("covar", "covar"),
                              ("meas", "meas"), ("probs", "probs"), ("valid", "valid"),
                              ("oscillated", "oscillated")):
                a = np.array(r[name], copy=True)
                a[lq, lc] = _h(res[src]).astype(a.dtype)
                r[name] = a
        usable = np.asarray(r["cmask"]) & np.asarray(r["enough"])
        refined = np.asarray(r["refined"])
        verified = refined & r["valid"] & ~r["oscillated"] \
            & (r["probs"] > pipe["verify"]["accept_probability"]) & usable
        r["selected"] = plain.early_exit_selection(np.asarray(r["rank"]), usable, refined,
                                                   verified)
        reqs.append(r)
    return s1, reqs


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) over the numbers that have a limit;
    a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        checks[name] = [v, limit]
    return ok, checks

"""Stage command-line tools (lrr_tpu/cli.py).

One subcommand per reference executable so the file-based pipeline can be
reproduced end to end (README.md:18-53):

  extract-features      <- features/ExtractFeatures.cxx
  extract-keypoints     <- features/ExtractKeypoints.cxx
  compute-descriptors   <- features/ComputeDescriptors.cxx
  compute-distance-map  <- rrl/examples/compute_distance_map.cxx
  watershed             <- features/WatershedSegmentation1.cxx
  indexing              <- rrl/examples/indexing_one_descriptor.cxx
  register              <- rrl/examples/location_registration.cxx
  estimate              <- cdcl/examples/estimate.cxx

plus `batch`, the evaluation and inspection tools and the libsvm-style
verifier tools.  Every subcommand that computes takes `--device` (default:
the CUDA card; it raises where there is none, `--device cpu` runs on the
CPU); `register` and `batch` take `--seed`, from which their sampling plans
are drawn.

Usage: python -m lrr_tpu_torch.cli <subcommand> ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from lrr_tpu_torch.types import Volume, resolve_device


def _device(args) -> torch.device:
    return resolve_device(args.device, "lrr_tpu_torch.cli")


def _load_volume(path, device) -> Volume:
    """MetaImage file or DICOM series directory (the reference's dual
    ingest, ExtractFeatures.cxx:88-172)."""
    from lrr_tpu_torch.io.dicom import read_volume_any

    return read_volume_any(path, device)


def _load_labels(path, device) -> Volume:
    """A watershed label volume.  A MetaImage file keeps its integer labels
    exactly (float32 would merge labels above 2^24); anything else goes
    through the volume reader."""
    from lrr_tpu_torch.io.mhd import read_mhd

    if not path.lower().endswith((".mhd", ".mha")):
        return _load_volume(path, device)
    data, origin, spacing = read_mhd(path)
    return Volume(
        data=torch.from_numpy(np.ascontiguousarray(data).astype(np.int64)).to(device),
        origin=torch.from_numpy(origin).to(device),
        spacing=torch.from_numpy(spacing).to(device),
    )


def _read_locs(path) -> list[list[float]]:
    with open(path) as f:
        return [
            [float(v) for v in line.split()[:3]]
            for line in f
            if len(line.split()) >= 3
        ]


def _load_svm(path):
    from lrr_tpu_torch.verify.svm import load_default_verifier, parse_libsvm_model

    if path:
        with open(path) as f:
            return parse_libsvm_model(f.read())
    # the shipped verifier: the reference loads training_data_all.model
    # from the CWD by default (itkLocationRegistration.cxx:2088-2109)
    print("using shipped verifier (lrr_tpu_torch/data/verifier_default.model)")
    return load_default_verifier()


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def cmd_extract_features(args):
    from lrr_tpu_torch.config import FeatureConfig
    from lrr_tpu_torch.features.extract import detect_features
    from lrr_tpu_torch.io import write_features
    from lrr_tpu_torch.ops.resample import resample_isotropic

    vol = _load_volume(args.image, _device(args))
    if args.resample:
        vol = resample_isotropic(vol, args.spacing)
    cfg = FeatureConfig(
        max_features=args.max_features,
        min_distance_mm=args.min_distance,
        contrast_radius_mm=args.contrast_radius,
    )
    t0 = time.time()
    fs = detect_features(vol, cfg)
    n = int(fs.count())
    print(f"detected {n} features in {time.time()-t0:.1f}s")
    write_features(args.output, fs)


def cmd_extract_keypoints(args):
    from lrr_tpu_torch.config import KeypointConfig
    from lrr_tpu_torch.features.extract import extract_keypoints
    from lrr_tpu_torch.io import read_features, write_keypoints

    fs = read_features(args.features, device=_device(args))
    kp = extract_keypoints(
        fs, KeypointConfig(min_distance_mm=args.min_distance, max_keypoints=args.max_keypoints)
    )
    print(f"extracted {int(kp.count())} keypoints")
    write_keypoints(args.output, kp)


def cmd_compute_descriptors(args):
    from lrr_tpu_torch.config import DescriptorConfig
    from lrr_tpu_torch.io import read_features, read_keypoints, write_descriptors
    from lrr_tpu_torch.ops.descriptors import compute_descriptors

    dev = _device(args)
    kp = read_keypoints(args.keypoints, device=dev)
    fs = read_features(args.features, device=dev)
    cfg = DescriptorConfig(min_neighbors=args.min_neighbors)
    ds = compute_descriptors(kp, fs, cfg)
    print(f"computed {int(ds.keypoints.mask.sum())} descriptors")
    write_descriptors(args.output, ds)


def cmd_compute_distance_map(args):
    from lrr_tpu_torch.io import read_features, write_mhd
    from lrr_tpu_torch.ops.voronoi import build_feature_voronoi

    fs = read_features(args.features, device=_device(args))
    vol, origin, spacing = build_feature_voronoi(
        fs.xyz, fs.mask, args.spacing, max_shape=args.max_shape
    )
    if args.validate:
        # CompareMapTree analog (compute_distance_map.cxx:37-138): check the
        # map lookup against exact brute force on the feature points
        from lrr_tpu_torch.ops.knn import nn1
        from lrr_tpu_torch.ops.voronoi import lookup

        idx_map = lookup(vol, origin, spacing, fs.xyz)
        _, idx_bf = nn1(fs.xyz, fs.xyz, fs.mask)
        m = _np(fs.mask)
        agree = (_np(idx_map) == _np(idx_bf))[m].mean()
        print(f"voronoi-vs-bruteforce agreement on feature points: {agree:.4f}")
    write_mhd(
        args.output,
        _np(vol).astype(np.int32),
        origin=tuple(_np(origin)),
        spacing=(args.spacing,) * 3,
    )
    print(f"voronoi map {tuple(vol.shape)} written to {args.output}")


def cmd_watershed(args):
    from lrr_tpu_torch.io import write_mhd
    from lrr_tpu_torch.ops.watershed import watershed_segmentation

    vol = _load_volume(args.image, _device(args))
    labels = watershed_segmentation(
        vol.data,
        conductance=args.conductance,
        iterations=args.iterations,
        lower_threshold=args.lower,
        scale_level=args.scale,
    )
    write_mhd(
        args.output,
        _np(labels).astype(np.uint32),
        origin=tuple(_np(vol.origin)),
        spacing=tuple(_np(vol.spacing)),
    )
    print(f"watershed labels written: {int(labels.max())} regions")


def cmd_indexing(args):
    from lrr_tpu_torch.config import IndexingConfig
    from lrr_tpu_torch.io import read_descriptors
    from lrr_tpu_torch.matching.indexing import generate_candidates

    dev = _device(args)
    moving = read_descriptors(args.moving, device=dev)
    fixed = read_descriptors(args.fixed, device=dev)
    cfg = IndexingConfig(num_candidates=args.candidates)

    if args.locs:
        queries = _read_locs(args.locs)
    else:
        queries = [[float(v) for v in args.query.split(",")]]

    os.makedirs(args.out, exist_ok=True)
    cands = generate_candidates(
        torch.tensor(queries, dtype=torch.float32, device=dev), moving, fixed, cfg
    )
    m_xyz, f_xyz = _np(moving.keypoints.xyz), _np(fixed.keypoints.xyz)
    mask, midx, fidx, dist = (
        _np(x) for x in (cands.mask, cands.moving_idx, cands.fixed_idx, cands.desc_dist)
    )
    for t, q in enumerate(queries):
        n = int(mask[t].sum())
        for c in range(n):
            mi = int(midx[t, c])
            fi = int(fidx[t, c])
            rec = {
                "query": q,
                "moving_index": mi,
                "fixed_index": fi,
                "descriptor_distance": float(dist[t, c]),
                "moving_keypoint": m_xyz[mi].tolist(),
                "fixed_keypoint": f_xyz[fi].tolist(),
            }
            with open(
                os.path.join(args.out, f"match{t:06d}_{c:02d}.json"), "w"
            ) as f:
                json.dump(rec, f, indent=1)
        print(f"query {t}: wrote {n} candidates")


def register_config(candidates=20, max_matches=8000, max_iterations=70, min_region_features=1000):
    """The pipeline config `register` serves with."""
    from lrr_tpu_torch.config import EstimationConfig, IndexingConfig, PipelineConfig

    return PipelineConfig(
        indexing=IndexingConfig(
            num_candidates=candidates,
            max_query_keypoints=max(candidates, 32),
        ),
        estimation=EstimationConfig(
            max_matches=max_matches,
            max_iterations=max_iterations,
            min_region_features=min_region_features,
        ),
    )


def context_from_files(
    moving_features, fixed_features, moving_descriptors, fixed_descriptors, device,
    segment_moving=None, segment_fixed=None,
):
    """The pair context of four stage files: the sets as written, Voronoi
    maps rebuilt from the features at the default spacing, and the derived
    state from the same `assemble_pair_context` that ends `prepare_pair`;
    with both label volumes, the watershed regions attached."""
    from lrr_tpu_torch.estimation.icp import VoronoiGrid
    from lrr_tpu_torch.io import read_descriptors, read_features
    from lrr_tpu_torch.ops.voronoi import build_feature_voronoi
    from lrr_tpu_torch.pipeline.registration import assemble_pair_context, attach_regions

    fs_m = read_features(moving_features, device=device)
    fs_f = read_features(fixed_features, device=device)
    ds_m = read_descriptors(moving_descriptors, device=device)
    ds_f = read_descriptors(fixed_descriptors, device=device)
    ctx = assemble_pair_context(
        fs_m, fs_f, ds_m, ds_f,
        VoronoiGrid(*build_feature_voronoi(fs_m.xyz, fs_m.mask)),
        VoronoiGrid(*build_feature_voronoi(fs_f.xyz, fs_f.mask)),
    )
    if segment_moving and segment_fixed:
        ctx = attach_regions(
            ctx, _load_labels(segment_moving, device), _load_labels(segment_fixed, device)
        )
        print("watershed region selection enabled")
    elif segment_moving or segment_fixed:
        raise SystemExit(
            "--segment-moving and --segment-fixed must be given together"
        )
    return ctx


def register_queries(ctx, queries, cfg, svm, out_dir, plan=None, seed=0, model="affine",
                     watch=False):
    """`register` on a context: serve `queries` and write the result files
    under `out_dir`.  `plan` is the [Q, C] `SamplingPlan` of the run (query
    t's rigid refinement and replay use `plan.query(t)`); without one it is
    drawn from a CPU generator seeded with `seed` and moved to the
    context's device.
    Returns the batched `LocationResult` (None for the rigid model)."""
    from lrr_tpu_torch.pipeline.registration import (
        register_location_rigid,
        register_locations_staged,
        result_at,
        watch_candidate,
    )
    from lrr_tpu_torch.pipeline.results import write_reference_artifacts, write_results
    from lrr_tpu_torch.sampling import draw_sampling_plan

    dev = ctx.device
    if plan is None:
        g = torch.Generator().manual_seed(seed)
        plan = draw_sampling_plan(
            g, len(queries), cfg, ctx.moving_features.capacity, ctx.fixed_features.capacity,
            dev,
        )
    q_dev = torch.tensor(queries, dtype=torch.float32, device=dev)
    os.makedirs(out_dir, exist_ok=True)

    if model == "rigid":
        for t, q in enumerate(queries):
            res, best, any_usable = register_location_rigid(ctx, q_dev[t], cfg, plan.query(t))
            path = os.path.join(out_dir, f"results{t:06d}_rigid.json")
            with open(path, "w") as f:
                json.dump(
                    {
                        "query": list(q),
                        "candidate": int(best),
                        "any_usable": bool(any_usable),
                        "R": _np(res.trans.A).tolist(),
                        "t": _np(res.trans.t).tolist(),
                        "center": _np(res.trans.center).tolist(),
                        "converged": bool(res.converged),
                        "weighted_error": float(res.weighted_error),
                    },
                    f, indent=1,
                )
            print(f"query {t}: rigid candidate {int(best)} "
                  f"converged={bool(res.converged)}")
        return None

    # the serving path: all queries batched through the staged early-exit
    # waves, the reference's sequential refine-in-rank-order early exit
    # (itkLocationRegistration.cxx:2332-2528)
    outs = register_locations_staged(ctx, q_dev, cfg, svm, plan)
    for t, q in enumerate(queries):
        out = result_at(outs, t)
        write_results(os.path.join(out_dir, f"results{t:06d}"), out, q)
        write_reference_artifacts(
            os.path.join(out_dir, "reference_format"), t, out, q,
            roi_mm=cfg.estimation.roi_mm,
        )
        sel = int(out.selected)
        print(f"query {t}: selected candidate {sel}")
        if watch and sel >= 0:
            # per-iteration convergence stream of the accepted candidate:
            # the reference's display callback + LAST_ITER replay
            # (cdcl_display.h:16, itkLocationRegistration.cxx:2550-2581)
            def show(iteration, weighted_error, number_matches):
                print(
                    f"  iter {int(iteration):3d}  weighted_error "
                    f"{float(weighted_error):.6f}  matches "
                    f"{int(number_matches)}", flush=True,
                )

            # replay with the draws the staged run gave this query, so the
            # stream matches the recorded result
            res = watch_candidate(ctx, q_dev[t], cfg, plan.query(t), sel, show)
            print(f"  replay converged={bool(res.converged)} "
                  f"final weighted_error={float(res.weighted_error):.6f}")
    return outs


def cmd_register(args):
    dev = _device(args)
    cfg = register_config(
        args.candidates, args.max_matches, args.max_iterations, args.min_region_features
    )
    ctx = context_from_files(
        args.moving_features, args.fixed_features, args.moving_descriptors,
        args.fixed_descriptors, dev, args.segment_moving, args.segment_fixed,
    )
    svm = _load_svm(args.svm_model)
    register_queries(
        ctx, _read_locs(args.locs), cfg, svm, args.out, seed=args.seed,
        model=args.model, watch=args.watch,
    )


def _reference_order_transform(path, device):
    """An `Affine3D` (zero center) from a file of 12 numbers [A row-major,
    t]; the identity without a file."""
    from lrr_tpu_torch.models.affine import Affine3D

    if not path:
        return Affine3D.identity(device=device)
    p = np.loadtxt(path, dtype=np.float32).reshape(-1)
    return Affine3D.from_params_reference_order(
        torch.from_numpy(p).to(device), torch.zeros(3, device=device)
    )


def cmd_estimate(args):
    """Point-set estimation demo (cdcl/examples/estimate.cxx): raw point
    files, selectable model and method."""
    from lrr_tpu_torch.estimation.cdc import CovFeatures, run_cdc
    from lrr_tpu_torch.estimation.icp_classic import icp_classic
    from lrr_tpu_torch.models.affine import Affine3D

    dev = _device(args)

    def load_pts(path, dim=3):
        pts = np.loadtxt(path, dtype=np.float32)
        if pts.ndim == 1:
            pts = pts[None]
        return torch.from_numpy(np.ascontiguousarray(pts[:, :dim])).to(dev)

    def every(pts):
        return torch.ones(len(pts), dtype=torch.bool, device=dev)

    if args.model == "similarity2d":
        # the 2-D demo path (estimate.cxx:86-110, cdcl_trans_similarity2d)
        from lrr_tpu_torch.estimation.similarity2d import icp_similarity2d
        from lrr_tpu_torch.models.similarity import Similarity2D

        mov, fix = load_pts(args.moving, 2), load_pts(args.fixed, 2)
        res = icp_similarity2d(mov, every(mov), fix, every(fix), Similarity2D.identity(device=dev),
                               max_iterations=args.iterations)
        tr = res.trans
        print(
            f"converged={bool(res.converged)} rms={float(res.rms):.4f} "
            f"scale={float(tr.scale):.6g} angle={float(tr.angle):.6g}"
        )
        p = np.concatenate([_np(tr.A).reshape(-1), _np(tr.t)])
        print("A (row-major):", " ".join(f"{v:.6g}" for v in p[:4]))
        print("t:", " ".join(f"{v:.6g}" for v in p[4:]))
        if args.output:
            np.savetxt(args.output, p[None])
        return

    mov, fix = load_pts(args.moving), load_pts(args.fixed)
    init = Affine3D.identity(device=dev)
    if args.method == "icp":
        # as lrr_tpu: --iterations is not passed on (30 a level by default)
        res = icp_classic(mov, every(mov), fix, every(fix), init)
        trans = res.trans
        print(f"converged={bool(res.converged)} rms={float(res.rms):.4f}")
    else:
        iso = args.feature_cov * torch.eye(3, device=dev)
        state = run_cdc(
            CovFeatures(mov, iso.expand(len(mov), 3, 3), every(mov)),
            CovFeatures(fix, iso.expand(len(fix), 3, 3), every(fix)),
            init,
            use_transfer="transfer" in args.method,
            symmetric="symmetric" in args.method,
            max_iterations=args.iterations,
        )
        trans = state.trans
        print(f"converged={bool(state.converged)} iterations={int(state.iteration)}")

    p = _np(trans.params_reference_order())
    print("A (row-major):", " ".join(f"{v:.6g}" for v in p[:9]))
    print("t:", " ".join(f"{v:.6g}" for v in p[9:]))
    if args.output:
        np.savetxt(args.output, p[None])


def cmd_repeatability(args):
    from lrr_tpu_torch.eval import feature_repeatability
    from lrr_tpu_torch.io import read_features

    dev = _device(args)
    fixed = read_features(args.fixed, device=dev)
    moving = read_features(args.moving, device=dev)
    gt = _reference_order_transform(args.transform, dev).apply if args.transform else (lambda x: x)
    res = feature_repeatability(
        fixed, moving, gt, dist_mm=args.dist, angle_deg=args.angle
    )
    print(
        f"repeatable: {float(res.fraction_repeatable):.4f} "
        f"(distance-only: {float(res.fraction_distance_ok):.4f}, "
        f"n={int(res.n_evaluated)})"
    )


def cmd_compare_descriptors(args):
    from lrr_tpu_torch.eval import compare_descriptor_sets
    from lrr_tpu_torch.io import read_descriptors

    dev = _device(args)
    a = read_descriptors(args.a, device=dev)
    b = read_descriptors(args.b, device=dev)
    res = compare_descriptor_sets(a, b, args.tol)
    print(
        f"pairs={int(res.n_pairs)} mean={float(res.mean_distance):.5f} "
        f"median={float(res.median_distance):.5f} max={float(res.max_distance):.5f}"
    )


def cmd_panels(args):
    from lrr_tpu_torch.viz import checkerboard_panels, save_png

    dev = _device(args)
    fixed = _load_volume(args.fixed, dev)
    moving = _load_volume(args.moving, dev)
    tr = _reference_order_transform(args.transform, dev)
    q = [float(v) for v in args.query.split(",")]
    panels = checkerboard_panels(fixed, moving, tr, q, args.extent)
    save_png(args.output, panels)
    print(f"panels written to {args.output}")


def cmd_batch(args):
    from lrr_tpu_torch.config import PipelineConfig
    from lrr_tpu_torch.pipeline.batch import load_pair_list, run_batch

    dev = _device(args)
    jobs = load_pair_list(args.pairs)
    svm = _load_svm(args.svm_model)
    report = run_batch(jobs, PipelineConfig(), svm, args.out, seed=args.seed, device=dev)
    print(
        f"completed={report['completed']} failed={report['failed']} "
        f"skipped={report['skipped']}"
    )


def cmd_crop_volume(args):
    """features/CropDicom.cxx: crop a sub-volume by voxel start/size."""
    from lrr_tpu_torch.io.dicom import write_dicom_series
    from lrr_tpu_torch.io.mhd import write_mhd

    vol = _load_volume(args.image, _device(args))
    i0, j0, k0 = (int(v) for v in args.start.split(","))
    di, dj, dk = (int(v) for v in args.size.split(","))
    nz, ny, nx = vol.data.shape
    i0, j0, k0 = max(i0, 0), max(j0, 0), max(k0, 0)
    data = vol.data[k0 : min(k0 + dk, nz), j0 : min(j0 + dj, ny), i0 : min(i0 + di, nx)]
    origin = vol.origin + vol.spacing * torch.tensor(
        [i0, j0, k0], dtype=vol.origin.dtype, device=vol.origin.device
    )
    out = Volume(data=data, origin=origin, spacing=vol.spacing)
    if os.path.splitext(args.output)[1].lower() in (".mhd", ".mha"):
        write_mhd(args.output, _np(out.data), _np(out.origin), _np(out.spacing))
    else:
        write_dicom_series(args.output, out)
    print(f"cropped {tuple(int(v) for v in data.shape)} -> {args.output}")


def cmd_extract_slice(args):
    """features/ExtractSlice.cxx: ROI slice around a location, as PNG."""
    from lrr_tpu_torch.viz.panels import save_png, slice_panel

    vol = _load_volume(args.image, _device(args))
    q = [float(v) for v in args.location.split(",")]
    axis = {"axial": 2, "coronal": 1, "sagittal": 0}[args.axis]
    arr = slice_panel(vol, q, axis, args.extent)
    lo, hi = np.percentile(arr, [1, 99])
    arr8 = np.clip((arr - lo) / max(hi - lo, 1e-6) * 255, 0, 255).astype(np.uint8)
    save_png(args.output, arr8)
    print(f"{args.axis} slice at {q} written to {args.output}")


def cmd_svm_scale(args):
    """libsvm/svm-scale.cpp: fit or apply a [-1,1] per-feature rescale."""
    from lrr_tpu_torch.io.svmlight import (
        apply_scale, fit_scale, read_range_file, read_svmlight,
        write_range_file, write_svmlight,
    )

    x, y = read_svmlight(args.data)
    if args.restore:
        rng = read_range_file(args.restore)
    else:
        rng = fit_scale(x, args.lower, args.upper)
        if args.save:
            write_range_file(args.save, rng)
    write_svmlight(args.output, apply_scale(x, rng), y)
    print(f"scaled {x.shape[0]} rows -> {args.output}")


def cmd_svm_train(args):
    """libsvm/svm-train.cpp: fit the RBF verifier, write libsvm model.

    --solver smo (default) runs the C-SVC SMO dual solver with Platt
    probability fitting, model-compatible with the reference's svm-train
    (same dual optimum, SV set and decision values), on the host.
    --solver klr is the fast dense kernel-logistic surrogate, trained on
    `--device`."""
    from lrr_tpu_torch.io.svmlight import read_svmlight
    from lrr_tpu_torch.verify.smo import train_c_svc
    from lrr_tpu_torch.verify.svm import fit_rbf_classifier, serialize_libsvm_model

    x, y = read_svmlight(args.data)
    if args.solver == "smo":
        model = train_c_svc(
            x, y, C=args.cost, gamma=args.gamma, eps=args.epsilon,
            probability=not args.no_probability,
        )
    else:
        model = fit_rbf_classifier(
            x, (y > 0).astype(np.float32), gamma=args.gamma, steps=args.steps,
            device=_device(args),
        )
    with open(args.model, "w") as f:
        f.write(serialize_libsvm_model(model))
    print(
        f"trained on {x.shape[0]} rows ({args.solver}, "
        f"{model.sv.shape[0]} SVs) -> {args.model}"
    )


def cmd_svm_predict(args):
    """libsvm/svm-predict.cpp: predict labels (+probability) for a file."""
    from lrr_tpu_torch.io.svmlight import read_svmlight
    from lrr_tpu_torch.verify.svm import parse_libsvm_model, predict_probability

    dev = _device(args)
    x, y = read_svmlight(args.data)
    with open(args.model) as f:
        model = parse_libsvm_model(f.read())
    probs = _np(predict_probability(model.to(dev), torch.from_numpy(x).to(dev)))
    pred = (probs > 0.5).astype(np.float32)
    with open(args.output, "w") as f:
        if args.probability:
            f.write("labels 1 0\n")
            for p_ in probs:
                f.write(f"{1.0 if p_ > 0.5 else 0.0:g} {p_:.6g} {1-p_:.6g}\n")
        else:
            for v in pred:
                f.write(f"{v:g}\n")
    acc = float(np.mean(pred == (y > 0)))
    print(f"Accuracy = {acc*100:.4f}% ({int(acc*len(y))}/{len(y)})")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lrr_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn, device=True, seed=False):
        s = sub.add_parser(name)
        s.set_defaults(fn=fn, device=None)
        if device:
            s.add_argument(
                "--device", default=None,
                help="torch device; default: the CUDA card (raises without one)",
            )
        if seed:
            s.add_argument("--seed", type=int, default=0,
                           help="seed of the generator the sampling plan is drawn from")
        return s

    s = command("extract-features", cmd_extract_features)
    s.add_argument("image")
    s.add_argument("output")
    s.add_argument("--spacing", type=float, default=1.0)
    s.add_argument("--resample", action="store_true")
    s.add_argument("--max-features", type=int, default=65536)
    s.add_argument("--min-distance", type=float, default=2.0)
    s.add_argument("--contrast-radius", type=float, default=30.0)

    s = command("extract-keypoints", cmd_extract_keypoints)
    s.add_argument("features")
    s.add_argument("output")
    s.add_argument("--min-distance", type=float, default=6.0)
    s.add_argument("--max-keypoints", type=int, default=4096)

    s = command("compute-descriptors", cmd_compute_descriptors)
    s.add_argument("keypoints")
    s.add_argument("features")
    s.add_argument("output")
    s.add_argument("--min-neighbors", type=int, default=100)

    s = command("compute-distance-map", cmd_compute_distance_map)
    s.add_argument("features")
    s.add_argument("output")
    s.add_argument("--spacing", type=float, default=1.0)
    s.add_argument("--max-shape", type=int, default=512)
    s.add_argument("--validate", action="store_true")

    s = command("watershed", cmd_watershed)
    s.add_argument("image")
    s.add_argument("output")
    s.add_argument("--conductance", type=float, default=2.0)
    s.add_argument("--iterations", type=int, default=10)
    s.add_argument("--lower", type=float, default=0.001)
    s.add_argument("--scale", type=float, default=0.10)

    s = command("indexing", cmd_indexing)
    s.add_argument("moving")
    s.add_argument("fixed")
    s.add_argument("--locs")
    s.add_argument("--query", help="x,y,z")
    s.add_argument("--candidates", type=int, default=20)
    s.add_argument("--out", default="matches")

    s = command("register", cmd_register, seed=True)
    s.add_argument("moving_features")
    s.add_argument("fixed_features")
    s.add_argument("moving_descriptors")
    s.add_argument("fixed_descriptors")
    s.add_argument("--locs", required=True)
    s.add_argument("--svm-model")
    s.add_argument("--out", default="results")
    s.add_argument("--candidates", type=int, default=20)
    s.add_argument("--max-matches", type=int, default=8000)
    s.add_argument("--max-iterations", type=int, default=70)
    s.add_argument("--min-region-features", type=int, default=1000)
    s.add_argument(
        "--model", choices=("affine", "rigid"), default="affine",
        help="transform family: affine (12 dof, full verify pipeline) or "
        "rigid (6 dof refinement of the best indexed candidate, BASELINE "
        "config 3)",
    )
    s.add_argument(
        "--segment-moving", default=None,
        help="watershed label volume (mhd) for the moving side; with "
        "--segment-fixed, estimation features are selected by growing whole "
        "watershed regions (FeaturesInRegions) instead of an ROI box",
    )
    s.add_argument("--segment-fixed", default=None)
    s.add_argument(
        "--watch", action="store_true",
        help="stream the accepted candidate's per-iteration convergence "
        "(weighted error, match count) after selection: the headless "
        "analog of the reference's interactive display callback",
    )

    s = command("estimate", cmd_estimate)
    s.add_argument("moving")
    s.add_argument("fixed")
    s.add_argument(
        "--method",
        choices=["icp", "cdc", "cdc-transfer", "cdc-symmetric", "cdc-symmetric-transfer"],
        default="icp",
    )
    s.add_argument(
        "--model", choices=("affine3d", "similarity2d"), default="affine3d",
        help="similarity2d runs the 2D demo path (estimate.cxx 2D mode) on "
        "2-column point files",
    )
    s.add_argument("--iterations", type=int, default=30)
    s.add_argument("--feature-cov", type=float, default=0.5)
    s.add_argument("--output")

    s = command("repeatability", cmd_repeatability)
    s.add_argument("fixed")
    s.add_argument("moving")
    s.add_argument("--transform", help="file with 12 params [A row-major, t]")
    s.add_argument("--dist", type=float, default=2.0)
    s.add_argument("--angle", type=float, default=20.0)

    s = command("compare-descriptors", cmd_compare_descriptors)
    s.add_argument("a")
    s.add_argument("b")
    s.add_argument("--tol", type=float, default=1.0)

    s = command("panels", cmd_panels)
    s.add_argument("fixed")
    s.add_argument("moving")
    s.add_argument("output")
    s.add_argument("--query", required=True, help="x,y,z")
    s.add_argument("--transform")
    s.add_argument("--extent", type=float, default=25.0)

    s = command("batch", cmd_batch, seed=True)
    s.add_argument("pairs", help="pairs list: name moving fixed [locs.txt]")
    s.add_argument("--out", default="batch_out")
    s.add_argument("--svm-model")

    s = command("crop-volume", cmd_crop_volume)
    s.add_argument("image", help="mhd/mha file or DICOM directory")
    s.add_argument("output", help=".mhd/.mha file or DICOM output directory")
    s.add_argument("--start", required=True, help="i,j,k voxel start")
    s.add_argument("--size", required=True, help="di,dj,dk voxel size")

    s = command("extract-slice", cmd_extract_slice)
    s.add_argument("image")
    s.add_argument("output", help="PNG path")
    s.add_argument("--location", required=True, help="x,y,z in mm")
    s.add_argument("--axis", choices=["axial", "coronal", "sagittal"], default="axial")
    s.add_argument("--extent", type=float, default=25.0)

    s = command("svm-scale", cmd_svm_scale, device=False)
    s.add_argument("data")
    s.add_argument("output")
    s.add_argument("-l", "--lower", type=float, default=-1.0)
    s.add_argument("-u", "--upper", type=float, default=1.0)
    s.add_argument("-s", "--save", help="save range file")
    s.add_argument("-r", "--restore", help="restore range file")

    s = command("svm-train", cmd_svm_train)
    s.add_argument("data")
    s.add_argument("model")
    s.add_argument("-g", "--gamma", type=float, default=0.125)
    s.add_argument("-c", "--cost", type=float, default=1.0)
    s.add_argument("-e", "--epsilon", type=float, default=1e-3)
    s.add_argument("--solver", choices=("smo", "klr"), default="smo")
    s.add_argument("--no-probability", action="store_true")
    s.add_argument("--steps", type=int, default=500, help="klr only")

    s = command("svm-predict", cmd_svm_predict)
    s.add_argument("data")
    s.add_argument("model")
    s.add_argument("output")
    s.add_argument("-b", "--probability", action="store_true")

    return p


def main(argv=None):
    # several processes (parallel.distributed): the process group comes up
    # first; a no-op unless LRR_COORDINATOR / LRR_DISTRIBUTED is set
    from lrr_tpu_torch.parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

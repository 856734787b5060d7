"""Result artifact writing (lrr_tpu/pipeline/results.py).

Semantically equivalent to LocationRegistration::WriteResults
(rrl/itkLocationRegistration.cxx:1874-2030): per query location a results
text file (final transform parameters in the reference ordering [A
row-major, t], parameter covariance, 8-d measurement vector, convergence
flags, the mapped query point) plus machine-readable JSON.

A `LocationResult` is brought to the host once (`_host`) and printed from
float64 copies of its float32 values, so the text is lrr_tpu's for the same
values.  Only the transfer covariance of the reference-format files is
computed here, in float32 on the result's device.
"""

from __future__ import annotations

import json

import os
import types

import numpy as np
import torch

from lrr_tpu_torch.estimation.measurements import transfer_error_stats
from lrr_tpu_torch.models.affine import Affine3D


def _host(obj):
    """A result dataclass with every tensor as a numpy array on the host
    (None stays None)."""
    if obj is None or isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return types.SimpleNamespace(
        **{k: _host(v) for k, v in vars(obj).items()}
    )


def _params_reference_order(trans, c) -> np.ndarray:
    """[A row-major, t] of candidate `c` of a host-side transform."""
    return np.concatenate([trans.A[c].reshape(9), trans.t[c]])


def write_results(prefix: str, out, query_xyz) -> None:
    """Write `<prefix>.txt` and `<prefix>.json` for a LocationResult."""
    out = _host(out)
    sel = int(out.selected)
    q = np.asarray(query_xyz, np.float64).tolist()

    rec = {
        "query": q,
        "selected": sel,
        "candidates": [],
    }
    C = out.probability.shape[0]
    for c in range(C):
        rec["candidates"].append(
            {
                "params_reference_order": _params_reference_order(
                    out.trans, c
                ).tolist(),
                "center": np.asarray(out.trans.center[c]).tolist(),
                "probability": float(out.probability[c]),
                "verified": bool(out.verified[c]),
                "converged": bool(out.converged[c]),
                "valid": bool(out.valid[c]),
                "oscillated": bool(out.oscillated[c]),
                "measurements": np.asarray(out.measurements[c]).tolist(),
                "query_mapped": np.asarray(out.query_mapped[c]).tolist(),
            }
        )

    with open(prefix + ".json", "w") as f:
        json.dump(rec, f, indent=1)

    lines = [f"query: {q[0]:.6f} {q[1]:.6f} {q[2]:.6f}", f"selected: {sel}"]
    if sel >= 0:
        p = _params_reference_order(out.trans, sel)
        cov = np.asarray(out.covar[sel])
        meas = np.asarray(out.measurements[sel])
        lines.append("transform (A row-major, t):")
        lines.append(" ".join(f"{v:.9g}" for v in p))
        lines.append("covariance:")
        for row in cov:
            lines.append(" ".join(f"{v:.6g}" for v in row))
        lines.append("measurements: " + " ".join(f"{v:.6g}" for v in meas))
        lines.append(f"probability: {float(out.probability[sel]):.6f}")
        lines.append(f"converged: {int(bool(out.converged[sel]))}")
        qm = np.asarray(out.query_mapped[sel])
        lines.append(f"query_mapped: {qm[0]:.6f} {qm[1]:.6f} {qm[2]:.6f}")
    with open(prefix + ".txt", "w") as f:
        f.write("\n".join(lines) + "\n")


def _fmt_mat(M) -> str:
    """vnl_matrix operator<< layout: rows space-separated, one per line."""
    return "\n".join(" ".join(f"{v:g}" for v in row) for row in np.asarray(M))


def _fmt_point(p) -> str:
    """itk::Point operator<< layout."""
    p = np.asarray(p, np.float64)
    return "[" + ", ".join(f"{v:g}" for v in p) + "]"


def _fmt_vnl_vec(p) -> str:
    return " ".join(f"{v:g}" for v in np.asarray(p, np.float64))


def write_itk_transform(path: str, A, t, center) -> None:
    """ITK transform file (TransformFileWriter text format, v1.0) holding an
    AffineTransform_double_3_3 — the format of the reference's
    transform%06d_%02d.vtk files (itkLocationRegistration.cxx:2004-2026)."""
    A = np.asarray(A, np.float64).reshape(3, 3)
    t = np.asarray(t, np.float64)
    c = np.asarray(center, np.float64)
    # ITK stores (A, translation) with x' = A (x - C) + translation + C,
    # Translation parameter = t - C for our x' = A (x - C) + t
    params = list(A.reshape(-1)) + list(t - c)
    with open(path, "w") as f:
        f.write("#Insight Transform File V1.0\n")
        f.write("#Transform 0\n")
        f.write("Transform: AffineTransform_double_3_3\n")
        f.write("Parameters: " + " ".join(f"{v:.17g}" for v in params) + "\n")
        f.write("FixedParameters: " + " ".join(f"{v:.17g}" for v in c) + "\n")


def read_itk_transform(path: str):
    """Inverse of write_itk_transform; returns (A, t, center)."""
    params = fixed = None
    with open(path) as f:
        for line in f:
            if line.startswith("Parameters:"):
                params = [float(v) for v in line.split()[1:]]
            elif line.startswith("FixedParameters:"):
                fixed = [float(v) for v in line.split()[1:]]
    A = np.asarray(params[:9], np.float64).reshape(3, 3)
    c = np.asarray(fixed, np.float64)
    t = np.asarray(params[9:12], np.float64) + c
    return A, t, c


def _displacement(gt_field, pts: np.ndarray) -> np.ndarray:
    """`gt_field.displacement` of float64 host points [N, 3], evaluated on
    float32 tensors, back as float64 on the host."""
    d = gt_field.displacement(torch.from_numpy(pts.astype(np.float32)))
    if isinstance(d, torch.Tensor):
        d = d.detach().cpu().numpy()
    return np.asarray(d, np.float64)


def _gt_error_lines(
    gt_field, q, kp_f, kp_m, A_init, t_init, A_final, t_final, roi_mm
) -> list:
    """Ground-truth error block of WriteResults when a deformation field is
    given (itkLocationRegistration.cxx:1912-1942, FitAffineTransformTo
    DeformationField .cxx:2604-2696, MeanAndScaleOfAffineApproximationError
    .cxx:2698-2790): LS affine fit to the field over the query ROI, then
    median + MAD scale of || defo(s) - (A (s - kp_f) + t - s + kp_m) || for
    the LS fit and for the candidate's initial/final INVERSE transforms
    (which map fixed -> moving, as the field does).

    `gt_field` is any object with .displacement([N, 3] fixed points) ->
    [N, 3] deformation vectors, both float32 tensors on the CPU."""
    def median_and_scale(vals, dof=1):
        # rrel_util_median_and_scale: median, then MAD scale with the
        # small-sample correction 1.4826 * (1 + 5/(n - dof))
        v = np.asarray(vals, np.float64)
        med = float(np.median(v))
        n = max(v.size - dof, 1)
        scale = 1.4826 * (1.0 + 5.0 / n) * float(np.median(np.abs(v - med)))
        return med, scale

    half = roi_mm / 2.0
    ax = np.linspace(-half, half, 9)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.asarray(q, np.float64) + np.stack([gx, gy, gz], -1).reshape(-1, 3)
    defo = _displacement(gt_field, pts)

    # LS fit of defo(s) ~ A (s - kp_f) + t - s + kp_m over the ROI grid
    # (FitAffineTransformToDeformationField: source centered on the fixed
    # keypoint, target centered on the moving keypoint)
    sc = pts - np.asarray(kp_f, np.float64)
    H = np.concatenate([sc, np.ones((sc.shape[0], 1))], axis=1)  # [N, 4]
    target = pts + defo - np.asarray(kp_m, np.float64)
    sol, *_ = np.linalg.lstsq(H, target, rcond=None)
    A_ls = sol[:3].T
    t_ls = sol[3]

    def med_scale(A, t):
        defo_affine = sc @ np.asarray(A, np.float64).T + np.asarray(
            t, np.float64
        ) - pts + np.asarray(kp_m, np.float64)
        comp = np.linalg.norm(defo - defo_affine, axis=1)
        return median_and_scale(comp, dof=1)

    med_ls, scale_ls = med_scale(A_ls, t_ls)
    med_i, scale_i = med_scale(A_init, t_init)
    med_f, scale_f = med_scale(A_final, t_final)

    lines = []
    lines.append(
        f"Affine Approximation Squared Error: {med_ls:g} scale: {scale_ls:g}"
    )
    lines.append("")
    lines.append("Affine transform fitted to deformation: ")
    lines.append(_fmt_mat(A_ls))
    lines.append(_fmt_vnl_vec(t_ls))
    lines.append("")
    lines.append(
        f"CDC Initial Error: {np.sqrt(max(med_i, 0.0)):g} "
        f"scale: {np.sqrt(max(scale_i, 0.0)):g}"
    )
    lines.append(
        f"CDC Final Error: {np.sqrt(max(med_f, 0.0)):g} "
        f"scale: {np.sqrt(max(scale_f, 0.0)):g}"
    )
    lines.append(f"CDC Error reduced: {1 if med_i > med_f else 0}")
    return lines


def write_reference_artifacts(
    out_dir: str,
    k: int,
    out,
    query_xyz,
    roi_mm: float = 50.0,
    prefix: str = "",
    gt_field=None,
    initial_trans=None,
) -> list:
    """Reference-format result artifacts for one query location.

    Writes, for every refined candidate c (the reference writes these for
    each PASS-2 attempt, itkLocationRegistration.cxx:2534-2539):
      {prefix}results%06d_%02d.txt  — the WriteResults text layout
                                      (.cxx:1874-2030): final transform A +
                                      centered translation, 12x12 parameter
                                      covariance, 3x3 transfer covariance +
                                      eigenvalues, keypoint locations,
                                      convergence flags, query mapping, and
                                      the 8-d measurement line;
      transform%06d_%02d.vtk        — ITK transform file of the final
                                      transform (despite the extension the
                                      reference writes the ITK transform
                                      text format via TransformFileWriter);
      transform_inverse%06d_%02d.vtk — its inverse.

    With `gt_field` (an object with .displacement([N,3]) — a ground-truth
    deformation field), each results file opens with the reference's GT
    error block: the LS affine fit to the field over the ROI and median/MAD
    errors of the fit and of the candidate's initial/final transforms
    (.cxx:1912-1942).  `initial_trans` ([C] Affine3D pytree of the PASS-2
    initializations) supplies the initial transform for that block; when
    absent the final transform stands in (Error reduced then reads 0).

    Returns the list of paths written."""
    os.makedirs(out_dir, exist_ok=True)
    q = np.asarray(query_xyz, np.float64)
    # the transfer covariance of every candidate, on the result's device
    roi_start = torch.as_tensor(q - roi_mm / 2.0, dtype=torch.float32, device=out.covar.device)
    covJ_all, _, _ = transfer_error_stats(
        Affine3D(out.trans.A, out.trans.t, out.trans.center), out.covar,
        roi_start.expand(out.covar.shape[0], 3), roi_mm,
    )
    covJ_all = covJ_all.cpu().numpy()
    out = _host(out)
    initial_trans = _host(initial_trans)
    refined = (
        np.asarray(out.refined)
        if out.refined is not None
        else np.ones(out.probability.shape[0], bool)
    )
    paths = []
    for c in np.flatnonzero(refined):
        A = np.asarray(out.trans.A[c], np.float64)
        t = np.asarray(out.trans.t[c], np.float64)
        ctr = np.asarray(out.trans.center[c], np.float64)
        kp_f = (
            np.asarray(out.keypoint_fixed[c], np.float64)
            if out.keypoint_fixed is not None else q
        )
        kp_m = (
            np.asarray(out.keypoint_moving[c], np.float64)
            if out.keypoint_moving is not None
            else np.asarray(out.query_mapped[c], np.float64)
        )

        # the reference writes the forward A with the INVERSE transform's
        # centered translation t_c = T^-1.t + T^-1.A kp_f - T^-1.A c - kp_m
        # (itkLocationRegistration.cxx:1889-1892)
        # T: x -> A (x - ctr) + t; T^-1: y -> Ainv y + (ctr - Ainv t), center 0
        Ainv = np.linalg.inv(A)
        tinv = ctr - Ainv @ t
        t_centered = tinv + Ainv @ kp_f - kp_m

        covJ = covJ_all[c]

        lines = []
        if gt_field is not None:
            if initial_trans is not None:
                A0 = np.asarray(initial_trans.A[c], np.float64).reshape(3, 3)
                t0 = np.asarray(initial_trans.t[c], np.float64)
                c0 = np.asarray(initial_trans.center[c], np.float64)
                A0inv = np.linalg.inv(A0)
                t0inv = c0 - A0inv @ t0
                t0_centered = t0inv + A0inv @ kp_f - kp_m
            else:
                A0inv, t0_centered = Ainv, t_centered
            lines.extend(
                _gt_error_lines(
                    gt_field, q, kp_f, kp_m,
                    A0inv, t0_centered, Ainv, t_centered, roi_mm,
                )
            )
        lines.append("")
        lines.append("Final estimated transform: ")
        lines.append(_fmt_mat(A))
        lines.append(_fmt_vnl_vec(t_centered))
        lines.append("")
        lines.append("Final estimated covariance: ")
        lines.append(_fmt_mat(np.asarray(out.covar[c], np.float64)))
        lines.append("")
        lines.append("Final estimated covarianceJ from moving points: ")
        lines.append(_fmt_mat(np.asarray(covJ, np.float64)))
        ev = np.linalg.eigvalsh(np.asarray(covJ, np.float64))
        lines.append(
            f"covarianceJ from points evalues: {ev[0]:g}  {ev[1]:g}  {ev[2]:g}"
        )
        lines.append("")
        lines.append(f"Fixed keypoint location: {_fmt_vnl_vec(kp_f)}")
        lines.append(f"Moving keypoint location: {_fmt_vnl_vec(kp_m)}")
        lines.append(f"Converged: {int(bool(np.asarray(out.converged)[c]))}")
        # feature RMS after iteration 0 vs. at the final state, tracked in
        # the ICP carry (estimation/icp.py; the reference's initialRMS /
        # RMS_error(), itkLocationRegistration.cxx:1965-1974)
        rms_i = (
            float(np.asarray(out.initial_rms)[c])
            if getattr(out, "initial_rms", None) is not None else 0.0
        )
        rms_f = (
            float(np.asarray(out.final_rms)[c])
            if getattr(out, "final_rms", None) is not None else 0.0
        )
        lines.append(f"Initial RMS: {rms_i:g}")
        lines.append(f"Final RMS: {rms_f:g}")
        lines.append(f"RMS reduced: {1 if rms_i > rms_f else 0}")
        qm = np.asarray(out.query_mapped[c], np.float64)
        lines.append(f"Query point: {_fmt_point(q)}")
        lines.append(f"Query point mapped: {_fmt_point(qm)}")
        if gt_field is not None:
            # Query point deformed + distance (itkLocationRegistration
            # .cxx:1995-2002): the field maps the FIXED query; the mapped
            # query is the candidate's fixed->moving estimate of it
            dq = _displacement(gt_field, q[None, :])[0]
            q_def = q + dq
            lines.append(f"Query point deformed: {_fmt_point(q_def)}")
            lines.append(
                f"Distance between mapped and deformed: "
                f"{np.linalg.norm(q_def - qm):g}"
            )
        lines.append(
            "Final alignment error : Maximum trace : Sheet angles (deg): "
            "Tube angles (deg)"
        )
        meas = np.asarray(out.measurements[c], np.float64)
        lines.append(
            "Classification:\t" + "\t".join(f"{v:g}" for v in meas) + "\t"
        )

        res_path = os.path.join(
            out_dir, f"{prefix}results{k:06d}_{int(c):02d}.txt"
        )
        with open(res_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(res_path)

        fwd_path = os.path.join(out_dir, f"transform{k:06d}_{int(c):02d}.vtk")
        write_itk_transform(fwd_path, A, t, ctr)
        paths.append(fwd_path)
        inv_path = os.path.join(
            out_dir, f"transform_inverse{k:06d}_{int(c):02d}.vtk"
        )
        write_itk_transform(inv_path, Ainv, tinv, np.zeros(3))
        paths.append(inv_path)
    return paths

"""The file-based pipeline of the PyTorch port as a whole: the stage commands
chained through files on a 32^3 phantom pair on the CPU, against
`prepare_pair` and against lrr_tpu's own commands on lrr_tpu's own files;
`run_batch`'s failure isolation and resume; the evaluation and
inspection tools against lrr_tpu's."""

from __future__ import annotations

import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.cli as jcli
import lrr_tpu.eval as jeval
import lrr_tpu.types as jtypes
import lrr_tpu.viz.panels as jviz
from lrr_tpu.models import Affine3D as JAffine

import lrr_tpu_torch.cli as tcli
import lrr_tpu_torch.eval as teval
import lrr_tpu_torch.viz.panels as tviz
from lrr_tpu_torch.config import (
    DescriptorConfig, FeatureConfig, KeypointConfig, PipelineConfig,
)
from lrr_tpu_torch.estimation.icp import bake_target_grid
from lrr_tpu_torch.io import read_descriptors, read_features, write_mhd
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.pipeline import artifacts, batch
from lrr_tpu_torch.pipeline.registration import prepare_pair
from lrr_tpu_torch.utils.synthetic import make_pair
from lrr_tpu_torch.verify.svm import load_default_verifier

from tests import torch_parity as tp

CPU = ["--device", "cpu"]
FEATURE_FLAGS = ["--max-features", "1024", "--contrast-radius", "100"]
KEYPOINT_FLAGS = ["--max-keypoints", "32"]
DESCRIPTOR_FLAGS = ["--min-neighbors", "8"]
REGISTER_FLAGS = ["--candidates", "4", "--max-matches", "512", "--max-iterations", "12",
                  "--min-region-features", "32"]
# the configuration those flags spell out
STAGE1_CFG = PipelineConfig(
    features=FeatureConfig(max_features=1024, contrast_radius_mm=100.0),
    keypoints=KeypointConfig(max_keypoints=32),
    descriptors=DescriptorConfig(min_neighbors=8),
)


@functools.lru_cache(maxsize=None)
def pair():
    """The small fixture's phantom pair (32^3) on the CPU."""
    p = tp.small_meta()["pair"]
    return make_pair(tuple(p["shape_zyx"]), rotation_deg=p["rotation_deg"],
                     translation=tuple(p["translation"]), seed=p["seed"], device="cpu")


def write_pair(d, names=("fixed", "moving")):
    fixed, moving, _ = pair()
    for name, vol in zip(names, (fixed, moving)):
        write_mhd(os.path.join(d, f"{name}.mhd"), vol.data.numpy(),
                  tuple(vol.origin.numpy()), tuple(vol.spacing.numpy()))


def stage_commands(cli, d, extra):
    """extract-features -> extract-keypoints -> compute-descriptors ->
    compute-distance-map --validate -> watershed, both sides."""
    for side in ("fixed", "moving"):
        p = lambda name: os.path.join(d, f"{side}_{name}")  # noqa: E731
        vol = os.path.join(os.path.dirname(d), f"{side}.mhd")
        cli.main(["extract-features", vol, p("feat.vtk")] + FEATURE_FLAGS + extra)
        cli.main(["extract-keypoints", p("feat.vtk"), p("kp.vtk")] + KEYPOINT_FLAGS + extra)
        cli.main(["compute-descriptors", p("kp.vtk"), p("feat.vtk"), p("desc.vtk")]
                 + DESCRIPTOR_FLAGS + extra)
        cli.main(["compute-distance-map", p("feat.vtk"), p("vor.mhd"), "--validate"] + extra)
        cli.main(["watershed", vol, p("ws.mhd")] + extra)


def stage_files(d):
    return [os.path.join(d, f"{side}_{kind}.vtk")
            for kind in ("feat", "desc") for side in ("moving", "fixed")]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The pair as .mhd, and both packages' stage files from it."""
    root = str(tmp_path_factory.mktemp("clichain"))
    write_pair(root)
    with open(os.path.join(root, "locs.txt"), "w") as f:
        for q in tp.small_queries():
            f.write(" ".join(f"{v:.6f}" for v in q) + "\n")
    for side in ("t", "j"):
        os.makedirs(os.path.join(root, side))
    stage_commands(tcli, os.path.join(root, "t"), CPU)
    stage_commands(jcli, os.path.join(root, "j"), [])
    return root


def test_help_lists_lrr_tpus_commands_but_estimate(capsys):
    """The port's subcommands are lrr_tpu's.  (`estimate` came last; the
    name of the test is older than it.)"""
    def commands(cli_module, argv_parser):
        with pytest.raises(SystemExit):
            argv_parser(["--help"])
        text = capsys.readouterr().out
        return set(text.split("{")[1].split("}")[0].split(","))

    ours = commands(tcli, tcli.main)
    theirs = commands(jcli, jcli.main)
    assert ours == theirs
    parser = tcli.build_parser()
    sub = next(a for a in parser._actions if a.dest == "cmd").choices
    for name, s in sub.items():
        opts = {o for a in s._actions for o in a.option_strings}
        assert ("--device" in opts) == (name != "svm-scale"), name
        assert ("--seed" in opts) == (name in ("register", "batch")), name
    # flags and defaults are lrr_tpu's
    args = parser.parse_args(["register", "a", "b", "c", "d", "--locs", "l"])
    assert (args.candidates, args.max_matches, args.max_iterations, args.min_region_features,
            args.model, args.out, args.seed, args.device) == (
        20, 8000, 70, 1000, "affine", "results", 0, None)
    args = parser.parse_args(["extract-features", "a", "b"])
    assert (args.max_features, args.min_distance, args.contrast_radius, args.spacing) == (
        65536, 2.0, 30.0, 1.0)


def test_commands_raise_without_a_card_and_compute_nothing(work, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = os.path.join(work, "t")
    out = str(tmp_path / "results")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["register", *stage_files(t), "--locs", os.path.join(work, "locs.txt"),
                   "--out", out] + REGISTER_FLAGS)
    assert not os.path.exists(out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["extract-features", os.path.join(work, "fixed.mhd"), str(tmp_path / "f.vtk")])
    assert not os.path.exists(str(tmp_path / "f.vtk"))


def test_stage_files_equal_lrr_tpus(work):
    """The two packages' stage files from one pair of volumes: feature and
    keypoint files hold the same points in the same order; descriptors
    within the stage-1 parity tolerance; the Voronoi maps equal but at
    ties; printed lines alike."""
    from lrr_tpu_torch.io import read_mhd, read_vtp

    for side in ("moving", "fixed"):
        for kind in ("feat", "kp", "desc"):
            a = read_vtp(os.path.join(work, "t", f"{side}_{kind}.vtk"))
            b = read_vtp(os.path.join(work, "j", f"{side}_{kind}.vtk"))
            assert a.points.shape == b.points.shape and len(a.points) >= 3, (side, kind)
            np.testing.assert_allclose(a.points, b.points, atol=1e-3)
            assert a.point_data.keys() == b.point_data.keys()
            for k in a.point_data:
                if k == "shapes":
                    np.testing.assert_array_equal(a.point_data[k], b.point_data[k])
                elif k == "descriptors":
                    np.testing.assert_allclose(a.point_data[k], b.point_data[k], atol=1e-4)
        ta, to, ts = read_mhd(os.path.join(work, "t", f"{side}_vor.mhd"))
        ja, jo, js = read_mhd(os.path.join(work, "j", f"{side}_vor.mhd"))
        assert ta.dtype == ja.dtype == np.int32 and ta.shape == ja.shape
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(ts, js)
        assert (ta != ja).mean() <= 0.001
        tw, _, _ = read_mhd(os.path.join(work, "t", f"{side}_ws.mhd"))
        jw, _, _ = read_mhd(os.path.join(work, "j", f"{side}_ws.mhd"))
        assert tw.dtype == jw.dtype == np.uint32 and tw.shape == jw.shape
        assert (tw != jw).mean() <= 0.01


def test_context_from_files_equals_prepare_pair(work):
    """The files route and `prepare_pair` give the same context: the valid
    rows in order (a file holds no padding), maps and NN table included."""
    fixed, moving, _ = pair()
    mem = prepare_pair(moving, fixed, STAGE1_CFG)
    files = tcli.context_from_files(*stage_files(os.path.join(work, "t")), "cpu")
    for side in ("moving", "fixed"):
        a, b = getattr(files, side + "_features"), getattr(mem, side + "_features")
        n = int(b.count())
        assert a.capacity == n and bool(a.mask.all()) and bool(b.mask[:n].all())
        for f in ("xyz", "strength", "shape", "projector"):
            assert torch.equal(getattr(a, f), getattr(b, f)[:n]), (side, f)
        # rows 0 and 1 are the file's normals and binormals; a corner's third
        # direction is rebuilt from them
        assert torch.equal(a.directions[:, 0], b.directions[:n, 0])
        np.testing.assert_allclose(a.directions.numpy(), b.directions[:n].numpy(), atol=1e-5)
        da, db = getattr(files, side + "_descriptors"), getattr(mem, side + "_descriptors")
        live = db.keypoints.mask
        assert da.keypoints.capacity == int(live.sum()) >= 3
        assert torch.equal(da.descriptors, db.descriptors[live])
        for f in ("xyz", "normal", "binormal"):
            assert torch.equal(getattr(da.keypoints, f), getattr(db.keypoints, f)[live]), (side, f)
        va, vb = getattr(files, side + "_vor"), getattr(mem, side + "_vor")
        for f in ("index_vol", "origin", "spacing"):
            assert torch.equal(getattr(va, f), getattr(vb, f)), (side, f)
        # the target rows every match reads through the map
        assert torch.equal(bake_target_grid(a, va), bake_target_grid(b, vb))
    # the NN table over live fixed keypoints, in compacted moving indices
    live_f, live_m = mem.fixed_descriptors.keypoints.mask, mem.moving_descriptors.keypoints.mask
    compact = torch.cumsum(live_m.long(), 0) - 1
    assert torch.equal(files.nn_table[0].long(), compact[mem.nn_table[0].long()[live_f]])
    assert torch.equal(files.nn_table[1], mem.nn_table[1][live_f])


def jax_context_from_files(d):
    """lrr_tpu's context of its own stage files, as its `register` builds it."""
    from lrr_tpu.estimation import VoronoiGrid
    from lrr_tpu.io import read_descriptors as jread_d
    from lrr_tpu.io import read_features as jread_f
    from lrr_tpu.matching.indexing import descriptor_nn_table
    from lrr_tpu.ops.voronoi import build_feature_voronoi
    from lrr_tpu.pipeline import PairContext

    mf, ff, md, fd = stage_files(d)
    fs_m, fs_f, ds_m, ds_f = jread_f(mf), jread_f(ff), jread_d(md), jread_d(fd)
    return PairContext(
        moving_features=fs_m, fixed_features=fs_f, moving_descriptors=ds_m,
        fixed_descriptors=ds_f,
        moving_vor=VoronoiGrid(*build_feature_voronoi(fs_m.xyz, fs_m.mask)),
        fixed_vor=VoronoiGrid(*build_feature_voronoi(fs_f.xyz, fs_f.mask)),
        nn_table=descriptor_nn_table(ds_f, ds_m),
    )


def test_register_selects_what_lrr_tpus_register_selects(work, capsys):
    """`lrr_tpu.cli register` on lrr_tpu's files against the port's register
    on the port's files with lrr_tpu's draws (base key `key(0)`)."""
    locs = os.path.join(work, "locs.txt")
    jout, tout = os.path.join(work, "j", "results"), os.path.join(work, "t", "results")
    capsys.readouterr()
    jcli.main(["register", *stage_files(os.path.join(work, "j")), "--locs", locs,
               "--out", jout] + REGISTER_FLAGS)
    jlines = capsys.readouterr().out

    cfg = tcli.register_config(4, 512, 12, 32)
    jcfg = tp.jax_config(cfg)
    queries = np.asarray(tcli._read_locs(locs), np.float32)
    _, m_sel, f_sel, _ = tp.jax_candidates(
        jax_context_from_files(os.path.join(work, "j")), queries, jcfg)
    plan = tp.plan_from_jax_keys(jax.random.key(0), m_sel, f_sel, jcfg)
    ctx = tcli.context_from_files(*stage_files(os.path.join(work, "t")), "cpu")
    assert ctx.moving_features.capacity == m_sel[0][0].shape[0], "feature counts differ"
    outs = tcli.register_queries(
        ctx, tcli._read_locs(locs), cfg, load_default_verifier(), tout, plan=plan)
    tlines = capsys.readouterr().out
    assert tlines.splitlines() == [
        line for line in jlines.splitlines() if line.startswith("query ")]

    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    n_selected = 0
    for t in range(len(queries)):
        jr = json.load(open(os.path.join(jout, f"results{t:06d}.json")))
        tr = json.load(open(os.path.join(tout, f"results{t:06d}.json")))
        assert tr["query"] == jr["query"] and tr["selected"] == jr["selected"]
        assert tr["selected"] == int(outs.selected[t])
        if jr["selected"] < 0:
            continue
        n_selected += 1
        jc, tc = jr["candidates"][jr["selected"]], tr["candidates"][tr["selected"]]
        a, b = np.asarray(jc["params_reference_order"]), np.asarray(tc["params_reference_order"])
        assert np.abs(a[:9] - b[:9]).max() <= 5e-3 * np.abs(a[:9]).max()
        assert np.abs(a[9:] - b[9:]).max() <= 5e-3 * np.abs(a[9:]).max()
        assert np.abs(np.asarray(jc["query_mapped"]) - np.asarray(tc["query_mapped"])).max() <= 0.05
        assert tc["verified"] and jc["verified"]
    assert n_selected >= 2, "the pair should verify most queries"
    jref = sorted(os.listdir(os.path.join(jout, "reference_format")))
    assert sorted(os.listdir(os.path.join(tout, "reference_format"))) == jref and jref


@pytest.mark.parametrize("mode", ["affine_watch_regions", "rigid"])
def test_register_command_runs(work, tmp_path, capsys, mode):
    """`register` through `main` with the port's own draws (`--seed`): the
    affine model with watershed regions and `--watch`, and the rigid model."""
    t = os.path.join(work, "t")
    out = str(tmp_path / "results")
    argv = ["register", *stage_files(t), "--locs", os.path.join(work, "locs.txt"), "--out", out,
            "--seed", "3"] + REGISTER_FLAGS + CPU
    if mode == "rigid":
        argv += ["--model", "rigid"]
    else:
        argv += ["--watch", "--segment-moving", os.path.join(t, "moving_ws.mhd"),
                 "--segment-fixed", os.path.join(t, "fixed_ws.mhd")]
    capsys.readouterr()
    tcli.main(argv)
    text = capsys.readouterr().out
    assert "using shipped verifier" in text
    n = len(tp.small_queries())
    if mode == "rigid":
        assert text.count("rigid candidate") == n
        rec = json.load(open(os.path.join(out, "results000000_rigid.json")))
        R = np.asarray(rec["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert set(rec) == {"query", "candidate", "any_usable", "R", "t", "center", "converged",
                            "weighted_error"}
    else:
        assert "watershed region selection enabled" in text
        assert text.count("selected candidate") == n
        assert "  iter   0  weighted_error" in text and "  replay converged=" in text
        # the run again gives the same files
        tcli.main(argv[:argv.index("--out") + 1] + [out + "2"] + argv[argv.index("--out") + 2:])
        for name in sorted(os.listdir(out)):
            if name.endswith((".txt", ".json")):
                assert filecmp.cmp(os.path.join(out, name), os.path.join(out + "2", name),
                                   shallow=False), name


def test_register_wants_both_label_volumes(work, tmp_path):
    t = os.path.join(work, "t")
    with pytest.raises(SystemExit, match="must be given together"):
        tcli.main(["register", *stage_files(t), "--locs", os.path.join(work, "locs.txt"),
                   "--out", str(tmp_path / "results"), "--segment-moving",
                   os.path.join(t, "moving_ws.mhd")] + REGISTER_FLAGS + CPU)


def test_indexing_command_matches_lrr_tpu(work):
    locs = os.path.join(work, "locs.txt")
    for side, cli, extra in (("j", jcli, []), ("t", tcli, CPU)):
        d = os.path.join(work, side)
        cli.main(["indexing", os.path.join(d, "moving_desc.vtk"), os.path.join(d, "fixed_desc.vtk"),
                  "--locs", locs, "--candidates", "4", "--out", os.path.join(d, "matches")] + extra)
    names = sorted(os.listdir(os.path.join(work, "j", "matches")))
    assert names and names == sorted(os.listdir(os.path.join(work, "t", "matches")))
    for name in names:
        a = json.load(open(os.path.join(work, "j", "matches", name)))
        b = json.load(open(os.path.join(work, "t", "matches", name)))
        assert (a["moving_index"], a["fixed_index"]) == (b["moving_index"], b["fixed_index"])
        assert abs(a["descriptor_distance"] - b["descriptor_distance"]) <= 1e-4
        np.testing.assert_allclose(a["moving_keypoint"], b["moving_keypoint"], atol=1e-3)


# ---------------------------------------------------------------------------
# run_batch: failure isolation, .done markers, resume from the cache
# ---------------------------------------------------------------------------

BATCH_CFG = tp.small_configs()[1]


def read_outputs(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d)) if "_results" in name}


def test_run_batch_isolates_failures_and_resumes(tmp_path, capsys):
    d = str(tmp_path)
    write_pair(d, names=("f0", "m0"))
    write_pair(d, names=("f1", "m1"))
    qs = [[float(v) for v in q] for q in tp.small_queries()[:3]]
    with open(os.path.join(d, "locs.txt"), "w") as f:
        f.write("".join(f"{q[0]} {q[1]} {q[2]}\n" for q in qs))
    with open(os.path.join(d, "pairs.txt"), "w") as f:
        f.write("# name moving fixed locs\n")
        f.write(f"first {d}/m0.mhd {d}/f0.mhd {d}/locs.txt\n")
        f.write(f"broken {d}/missing.mhd {d}/f0.mhd {d}/locs.txt\n")
        f.write(f"second {d}/m1.mhd {d}/f1.mhd {d}/locs.txt\n")
    jobs = batch.load_pair_list(os.path.join(d, "pairs.txt"))
    assert [j.name for j in jobs] == ["first", "broken", "second"] and jobs[0].queries == qs
    svm = load_default_verifier()
    out = os.path.join(d, "out")

    rep = batch.run_batch(jobs, BATCH_CFG, svm, out, query_batch=2, device="cpu")
    assert (rep["completed"], rep["failed"], rep["skipped"]) == (2, 1, 0)
    assert [p["status"] for p in rep["pairs"]] == ["ok", "failed", "ok"]  # the run went on
    assert "missing.mhd" in rep["pairs"][1]["error"]
    # the pair behind the failed one got its own volumes: the same pair, the same answers
    assert rep["pairs"][0]["locations"] == rep["pairs"][2]["locations"]
    assert len(rep["pairs"][0]["locations"]) == 3
    assert any(loc["selected"] >= 0 for loc in rep["pairs"][0]["locations"])
    on_disk = json.load(open(os.path.join(out, "batch_report.json")))
    assert on_disk["completed"] == 2 and set(on_disk["timers"]) == {"load", "prepare", "register"}
    assert os.path.exists(os.path.join(out, "first.done"))
    assert not os.path.exists(os.path.join(out, "broken.done"))
    first = read_outputs(out)
    assert len(first) == 2 * 2 * 3  # .txt and .json, two pairs, three queries

    # a second call skips on the markers and writes nothing anew
    stamp = os.path.getmtime(os.path.join(out, "first_results000000.json"))
    rep2 = batch.run_batch(jobs, BATCH_CFG, svm, out, query_batch=2, device="cpu")
    assert (rep2["completed"], rep2["failed"], rep2["skipped"]) == (0, 1, 2)
    assert os.path.getmtime(os.path.join(out, "first_results000000.json")) == stamp

    # markers gone: resumed from the cached contexts, byte-equal results
    cache = os.path.join(out, "artifacts", "first.npz")
    cache_stamp = os.path.getmtime(cache)
    for name in ("first", "second"):
        os.remove(os.path.join(out, name + ".done"))
    calls = []
    real = artifacts.prepare_pair
    artifacts.prepare_pair = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        rep3 = batch.run_batch(jobs, BATCH_CFG, svm, out, query_batch=2, device="cpu")
        assert rep3["completed"] == 2 and not calls, "stage 1 ran again despite the cache"
        assert os.path.getmtime(cache) == cache_stamp
        assert read_outputs(out) == first

        # a corrupt cache file is recomputed, and the results are the same again
        with open(cache, "wb") as f:
            f.write(b"not an npz")
        os.remove(os.path.join(out, "first.done"))
        rep4 = batch.run_batch(jobs, BATCH_CFG, svm, out, query_batch=2, device="cpu")
        assert (rep4["completed"], rep4["skipped"]) == (1, 1) and len(calls) == 1
        assert read_outputs(out) == first
        assert not os.path.exists(cache + ".tmp.npz")
    finally:
        artifacts.prepare_pair = real

    # the command hands the pairs file, the default configuration, the
    # seed and the device to `run_batch` and prints its counts
    seen = {}

    def fake(jobs_, cfg, svm_, out_dir, seed, device):
        seen.update(names=[j.name for j in jobs_], cfg=cfg, out=out_dir, seed=seed, device=device)
        return rep

    real_run, batch.run_batch = batch.run_batch, fake
    try:
        capsys.readouterr()
        tcli.main(["batch", os.path.join(d, "pairs.txt"), "--out", os.path.join(d, "cmd"),
                   "--seed", "1"] + CPU)
    finally:
        batch.run_batch = real_run
    assert "completed=2 failed=1 skipped=0" in capsys.readouterr().out
    assert seen == dict(names=["first", "broken", "second"], cfg=PipelineConfig(),
                        out=os.path.join(d, "cmd"), seed=1, device=torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["batch", os.path.join(d, "pairs.txt"), "--out", os.path.join(d, "never")])
        assert not os.path.exists(os.path.join(d, "never"))


# ---------------------------------------------------------------------------
# eval and viz
# ---------------------------------------------------------------------------


def jax_sets(work):
    from lrr_tpu.io import read_descriptors as jread_d
    from lrr_tpu.io import read_features as jread_f

    t = os.path.join(work, "t")
    return (jread_f(os.path.join(t, "fixed_feat.vtk")), jread_f(os.path.join(t, "moving_feat.vtk")),
            jread_d(os.path.join(t, "fixed_desc.vtk")), jread_d(os.path.join(t, "moving_desc.vtk")))


def torch_sets(work):
    t = os.path.join(work, "t")
    return (read_features(os.path.join(t, "fixed_feat.vtk"), device="cpu"),
            read_features(os.path.join(t, "moving_feat.vtk"), device="cpu"),
            read_descriptors(os.path.join(t, "fixed_desc.vtk"), device="cpu"),
            read_descriptors(os.path.join(t, "moving_desc.vtk"), device="cpu"))


def true_transforms():
    true = tp.small_meta()["true"]
    return (JAffine(*(jnp.asarray(true[k], jnp.float32) for k in ("A", "t", "center"))),
            Affine3D(*(torch.tensor(true[k]) for k in ("A", "t", "center"))))


def test_eval_tools_match_lrr_tpu(work, tmp_path, capsys):
    jf, jm, jdf, jdm = jax_sets(work)
    tf, tm, tdf, tdm = torch_sets(work)
    jtrue, ttrue = true_transforms()

    jr = jeval.feature_repeatability(jf, jm, jtrue.inverse().apply)
    tr = teval.feature_repeatability(tf, tm, ttrue.inverse().apply)
    assert float(tr.fraction_distance_ok) > 0.5
    for k in ("fraction_repeatable", "fraction_distance_ok", "n_evaluated"):
        np.testing.assert_allclose(float(getattr(tr, k)), float(getattr(jr, k)), atol=1e-5)
    for k in ("distance_hist", "angle_hist"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)))

    jc = jeval.compare_descriptor_sets(jdf, jdm, 3.0)
    tc = teval.compare_descriptor_sets(tdf, tdm, 3.0)
    assert int(tc.n_pairs) == int(jc.n_pairs)
    jc0, tc0 = jeval.compare_descriptor_sets(jdf, jdf), teval.compare_descriptor_sets(tdf, tdf)
    assert int(tc0.n_pairs) == int(jc0.n_pairs) == tdf.keypoints.capacity
    for a, b in ((tc, jc), (tc0, jc0)):
        if int(b.n_pairs):
            for k in ("mean_distance", "median_distance", "max_distance"):
                np.testing.assert_allclose(float(getattr(a, k)), float(getattr(b, k)), atol=1e-5)

    cfg = tcli.register_config(4, 512, 12, 32).indexing
    q = tp.small_queries()
    je = jeval.evaluate_indexing(jnp.asarray(q), jdm, jdf, jtrue.inverse().apply, tp.jax_config(cfg))
    te = teval.evaluate_indexing(torch.from_numpy(q), tdm, tdf, ttrue.inverse().apply, cfg)
    for k in te._fields:
        np.testing.assert_array_equal(getattr(te, k).numpy(), np.asarray(getattr(je, k)), err_msg=k)
    assert bool(te.good_at_all.any())

    # the two commands print what lrr_tpu's print
    p = np.concatenate([np.asarray(jtrue.inverse().A).reshape(-1), np.asarray(jtrue.inverse().t)])
    np.savetxt(str(tmp_path / "gt.txt"), p[None])
    t = os.path.join(work, "t")
    lines = {}
    for side, cli, extra in (("j", jcli, []), ("t", tcli, CPU)):
        capsys.readouterr()
        cli.main(["repeatability", os.path.join(t, "fixed_feat.vtk"),
                  os.path.join(t, "moving_feat.vtk"), "--transform", str(tmp_path / "gt.txt")] + extra)
        cli.main(["compare-descriptors", os.path.join(t, "fixed_desc.vtk"),
                  os.path.join(t, "fixed_desc.vtk")] + extra)
        lines[side] = capsys.readouterr().out
    assert lines["t"] == lines["j"] and "repeatable: " in lines["t"]


def test_viz_tools_match_lrr_tpu(work, tmp_path, capsys):
    fixed, moving, _ = pair()
    jfixed, jmoving = tp.jax_like(fixed, jtypes.Volume), tp.jax_like(moving, jtypes.Volume)
    jtrue, ttrue = true_transforms()
    q = tp.small_queries()[0]
    for axis in (0, 1, 2):
        np.testing.assert_allclose(
            tviz.slice_panel(fixed, q, axis, 12.0, 48),
            jviz.slice_panel(jfixed, jnp.asarray(q), axis, 12.0, 48), atol=1e-5)
    tpanels = tviz.checkerboard_panels(fixed, moving, ttrue, q, 12.0, 48)
    jpanels = jviz.checkerboard_panels(jfixed, jmoving, jtrue, q, 12.0, 48)
    assert tpanels.shape == (144, 144)
    np.testing.assert_allclose(tpanels, jpanels, atol=1e-5)
    a, b = np.arange(36.0).reshape(6, 6), -np.ones((6, 6))
    np.testing.assert_array_equal(tviz.checkerboard(a, b, 3), jviz.checkerboard(a, b, 3))

    # one array through both writers and both overlays: equal bytes
    tf, _, _, _ = torch_sets(work)
    panel = jpanels[:48, 48:96]
    covs = np.random.default_rng(0).normal(size=(5, 3, 3))
    covs = covs @ covs.transpose(0, 2, 1)
    centers = q[None] + np.random.default_rng(1).uniform(-2, 2, (5, 3)).astype(np.float32)
    outs = {}
    for side, viz in (("j", jviz), ("t", tviz)):
        marked = viz.overlay_features(panel, tf.xyz.numpy(), tf.mask.numpy(), q, 2, 12.0)
        marked = viz.overlay_covariance_ellipses(marked, centers, covs, q, 2, 12.0)
        assert (marked != panel).any()
        viz.save_png(str(tmp_path / f"{side}.png"), marked)
        viz.save_png(str(tmp_path / f"{side}_rgb.png"),
                     np.stack([marked, marked, panel], -1).astype(np.float32))
        outs[side] = marked
    np.testing.assert_array_equal(outs["t"], outs["j"])
    for name in ("{}.png", "{}_rgb.png"):
        assert filecmp.cmp(str(tmp_path / name.format("j")), str(tmp_path / name.format("t")),
                           shallow=False)
    assert open(str(tmp_path / "t.png"), "rb").read(8) == b"\x89PNG\r\n\x1a\n"

    # panels, extract-slice, crop-volume: the commands against lrr_tpu's
    fx, mv = os.path.join(work, "fixed.mhd"), os.path.join(work, "moving.mhd")
    query = ",".join(f"{v:.4f}" for v in q)
    p = np.concatenate([np.asarray(jtrue.A).reshape(-1), np.asarray(jtrue.t - jtrue.A @ jtrue.center)])
    np.savetxt(str(tmp_path / "tr.txt"), p[None])
    for side, cli, extra in (("j", jcli, []), ("t", tcli, CPU)):
        d = tmp_path / side
        d.mkdir()
        cli.main(["panels", fx, mv, str(d / "panels.png"), "--query", query,
                  "--transform", str(tmp_path / "tr.txt"), "--extent", "12"] + extra)
        cli.main(["extract-slice", fx, str(d / "slice.png"), "--location", query,
                  "--axis", "coronal", "--extent", "12"] + extra)
        cli.main(["crop-volume", fx, str(d / "crop.mha"), "--start", "4,5,6", "--size", "9,8,40"]
                 + extra)
        cli.main(["crop-volume", fx, str(d / "crop_dicom"), "--start", "4,5,6", "--size", "9,8,7"]
                 + extra)
    for name in ("crop.mha", "slice.png", "panels.png"):
        assert filecmp.cmp(str(tmp_path / "j" / name), str(tmp_path / "t" / name), shallow=False), name
    slices = sorted(os.listdir(str(tmp_path / "t" / "crop_dicom")))
    assert len(slices) == 7 and slices == sorted(os.listdir(str(tmp_path / "j" / "crop_dicom")))
    for name in slices:
        assert filecmp.cmp(str(tmp_path / "j" / "crop_dicom" / name),
                           str(tmp_path / "t" / "crop_dicom" / name), shallow=False)

"""The yardstick on hand-made inputs, and the frozen copies pinned against
the program sources they were copied from."""

from __future__ import annotations

import filecmp
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import draws, phantom, run, yardstick
from portbench.reference import plain, stage1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reader(name):
    return run.metric_reader(REPO, name)


def test_union_of_intervals():
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert yardstick.union_seconds([]) == 0.0


def test_idle_gaps_are_named_by_the_host_range_that_holds_them():
    kernels = [("a", 0, 10), ("b", 30, 40), ("c", 45, 100)]
    gaps = yardstick.idle_gaps(kernels, [("portbench.wave", 25, 50)], (0, 100))
    assert [g[0] for g in gaps] == ["host", "portbench.wave"]
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 5e-6])


def test_end_to_end_rates_take_the_whole_window():
    reqs = [{"queries": 300}, {"queries": 300}, {"queries": 300, "error": "x"}]
    e2e = run.end_to_end(reqs, window_s=12.0, setup_s=20.0)
    assert e2e == {"setup_s": 20.0, "pair_s": 6.0, "locations_per_s": 50.0}


def test_metric_readers_on_a_hand_made_record():
    rec = {
        "requests": [
            {"queries": 16, "profiled": False, "graph_build_s": 0.8, "waves": 2, "syncs": 50,
             "spans": {"prepare_pair": 3.0, "segment_pair": 0.2, "build_feature_voronoi": 2.2}},
            {"queries": 16, "profiled": True, "graph_build_s": 9.0, "waves": 2, "syncs": 54,
             "lanes": 300, "k1_bound_ms": 2.0, "k3_bound_ms": 0.001,
             "spans": {"prepare_pair": 30.0, "segment_pair": 2.0, "build_feature_voronoi": 22}},
            {"queries": 16, "profiled": False, "graph_build_s": 1.0, "waves": 1, "syncs": 26,
             "spans": {"prepare_pair": 3.4, "segment_pair": 0.2, "build_feature_voronoi": 2.4}},
        ],
        "waves": [(300, 512), (60, 64), (20, 32)],
        "traced_request": 1,
        "profile": {"busy_s": 3.0, "window_s": 4.0, "wave_device_s": 0.6, "k1_s": 0.01,
                    "k3_s": 0.5},
    }
    assert reader("stage1_s.pair")(rec) == pytest.approx(3.4)
    assert reader("voronoi_s.pair")(rec) == pytest.approx(2.3)
    assert reader("graph_build_s.pair")(rec) == pytest.approx(0.9)
    assert reader("device_idle.pair")(rec) == pytest.approx(25.0)
    assert reader("device_idle.batch")(rec) == pytest.approx(25.0)
    assert reader("lane_fill.batch")(rec) == pytest.approx(100 * 380 / 608)
    assert reader("host_reads_per_wave.batch")(rec) == pytest.approx(130 / 5)
    assert reader("device_ms_per_lane.batch")(rec) == pytest.approx(2.0)
    assert reader("k1_roofline.batch")(rec) == pytest.approx(20.0)
    assert reader("k3_roofline.batch")(rec) == pytest.approx(0.0002)
    rec["profile"] = None
    for name in ("device_idle.pair", "k1_roofline.batch", "device_ms_per_lane.batch"):
        assert reader(name)(rec) is None  # nothing to read: no number, never 0


def test_every_metric_of_the_benchmark_has_its_reader():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(reader(m["name"]))


def test_k1_bytes_are_sols():
    from lrr_tpu_torch.utils import sol

    L, mf, mb = 64, 8000, 4096
    z = torch.zeros  # weights all zero: sol's operation term is 0, its bytes term remains
    fwd = (None, None, None, None, z(L, mf))
    bwd = (None, None, None, None, z(L, mb))
    ms, by = sol.k1_bound_ms(fwd, bwd)
    assert by == "bytes"
    assert yardstick.k1_bytes(L, mf, mb) / (yardstick.PEAK_HBM_GBS * 1e6) == pytest.approx(
        ms, rel=1e-12)
    # at every weight live the operations stay under the bytes bound
    ms_live, by_live = sol.k1_bound_ms((None,) * 4 + (torch.ones(L, mf),),
                                       (None,) * 4 + (torch.ones(L, mb),))
    assert by_live == "bytes" and ms_live == pytest.approx(ms, rel=1e-12)


def test_least_bytes_take_the_l2_and_the_sms_load_path():
    assert yardstick.PEAK_ONCHIP_GBS == pytest.approx(132 * 128 * 1.98)
    small = 20 * 2**20  # fits the L2: the SMs' load path bounds it
    assert yardstick.least_bytes_ms(small) == pytest.approx(small / 33454.08e6)
    big = 400 * 2**20  # 350 MB of it must come from HBM
    assert yardstick.least_bytes_ms(big) == pytest.approx(350 * 2**20 / 3350e6)
    # a K1 launch at bucket 512 with 1,000 + 1,000 matches (45 MB) and with
    # 4,000 + 4,000 (180 MB)
    assert yardstick.k1_bound_ms(512, 1000, 1000) == pytest.approx(
        yardstick.k1_bytes(512, 1000, 1000) / 33454.08e6)
    assert yardstick.k1_bound_ms(512, 4000, 4000) == pytest.approx(
        (yardstick.k1_bytes(512, 4000, 4000) - 50 * 2**20) / 3350e6)
    # never above the HBM-only bound it replaces
    for L, m in ((64, 1000), (512, 2000), (1024, 8000)):
        assert yardstick.k1_bound_ms(L, m, m) <= yardstick.k1_bytes(L, m, m) / 3350e6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("L,n", [(64, 12), (1, 4), (512, 12), (8, 6)])
def test_k3_bound_is_chip_smokes_counts_over_the_l2_aware_bytes(L, n):
    ms, by = _chip_smoke().pinv_bound_ms(L, n)
    t_ops = L * 10 * n**3 / 67e9
    if by == "operations":
        assert ms == pytest.approx(t_ops, rel=1e-12)
    else:
        assert ms == pytest.approx(2 * L * n * n * 4 / 3350e6, rel=1e-12)
    want = max(yardstick.least_bytes_ms(2 * L * n * n * 4), t_ops)
    assert yardstick.k3_bound_ms(L, n) == pytest.approx(want, rel=1e-12)


def test_gt_errors_are_chip_smokes():
    from lrr_tpu_torch.models.affine import Affine3D

    rng = np.random.default_rng(3)
    Q, C = 5, 4
    A = np.eye(3) + 0.01 * rng.standard_normal((Q, C, 3, 3))
    t = rng.uniform(100, 110, (Q, C, 3))
    c = rng.uniform(90, 100, (Q, C, 3))
    queries = rng.uniform(80, 120, (Q, 3)).astype(np.float32)
    sel = np.array([1, -1, 0, 3, 2])
    tA, tt, tc = phantom.true_transform(rng, {"rotation_deg": 6, "rotation_jitter_deg": 1,
                                              "translation_mm": [3, -2, 1.5],
                                              "translation_jitter_mm": 1}, np.full(3, 100.0))
    f32 = torch.float32
    out = types.SimpleNamespace(
        selected=torch.as_tensor(sel),
        trans=Affine3D(torch.as_tensor(A, dtype=f32), torch.as_tensor(t, dtype=f32),
                       torch.as_tensor(c, dtype=f32)))
    true = Affine3D(torch.as_tensor(tA, dtype=f32), torch.as_tensor(tt, dtype=f32),
                    torch.as_tensor(tc, dtype=f32))
    want = _chip_smoke().query_errors(out, queries, true)
    s = np.nonzero(sel >= 0)[0]
    got = yardstick.gt_errors_mm(A[s, sel[s]], t[s, sel[s]], c[s, sel[s]], queries[s],
                                 (tA, tt, tc), ids=s)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_phantom_assembly_is_the_programs_at_1mm():
    from lrr_tpu_torch.utils import synthetic

    shape = (96, 96, 96)
    g = torch.Generator().manual_seed(5)
    A = torch.randn((shape[0] // 18 + 2,) * 3, generator=g)
    B = torch.randn((shape[0] // 24 + 2,) * 3, generator=g)
    C = torch.randn((shape[0] // 24 + 2,) * 3, generator=g)
    imp = torch.zeros(shape)
    idx = torch.randint(20, 76, (40, 3), generator=g)
    imp[idx[:, 0], idx[:, 1], idx[:, 2]] = torch.randint(80, 221, (40,), generator=g).float()
    want = synthetic._assemble_dense(A, B, C, imp, None, shape=shape, cell_a=18, cell_bc=24,
                                     sigma_blob=1.5, noise=0.0)
    got = phantom.assemble(A, B, C, imp, (1.0, 1.0, 1.0))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


def test_phantom_is_the_same_bits_from_the_same_seed():
    a = phantom.dense_phantom((40, 48, 48), (0.625, 0.625, 2.5), 7, torch.device("cpu"))
    b = phantom.dense_phantom((40, 48, 48), (0.625, 0.625, 2.5), 7, torch.device("cpu"))
    assert torch.equal(a, b)


def test_queries_are_the_reference_profiles_draws():
    from lrr_tpu_torch.verify import train_default

    shape = (400, 350, 350)
    want = train_default.reference_queries(shape, 11, 16)
    got = draws.queries(np.random.default_rng(111), 16, (350.0, 350.0, 400.0), 0.3, 0.7)
    np.testing.assert_array_equal(got, want)


def test_plan_fields_are_the_programs_plan_fields():
    from lrr_tpu_torch.config import pipeline_config_from_dict
    from lrr_tpu_torch.sampling import draw_sampling_plan

    with open(os.path.join(REPO, "portbench", "configs", "copd512.json")) as f:
        cfg = pipeline_config_from_dict(json.load(f)["pipeline"])
    want = draw_sampling_plan(torch.Generator().manual_seed(0), 2, cfg, 96, 80)
    got = draws.plan_fields(1, 2, cfg.indexing.num_candidates, cfg.estimation.max_iterations,
                            96, 80, torch.device("cpu"))
    for name, v in got.items():
        w = getattr(want, name)
        assert v.shape == w.shape and v.dtype == w.dtype, name
        if v.is_floating_point():
            assert 0.0 <= float(v.min()) and float(v.max()) < 1.0
        else:
            assert 0 <= int(v.min()) and int(v.max()) < draws.OFFSET_RANGE
    # every per-candidate stream; the rigid refinement's, which the staged
    # entry point never reads, is not drawn
    assert {f for f in vars(want) if not f.startswith("rigid_")} == set(got)


def test_verifier_copy_and_plain_svm_are_the_programs():
    from lrr_tpu_torch.verify import svm

    path = os.path.join(REPO, "portbench", "reference", "verifier_default.model")
    assert filecmp.cmp(path, svm.DEFAULT_MODEL_PATH, shallow=False)
    model = svm.load_default_verifier()
    meas = torch.as_tensor(np.random.default_rng(0).uniform(
        plain.FEATURE_MIN, plain.FEATURE_MAX, (200, 8)), dtype=torch.float32)
    want = svm.predict_probability(model, svm.scale_measurements(meas))
    got = plain.svm_probability(plain.read_libsvm(path), meas, "f64")
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-6)


def test_partition_miss_counts_what_falls_outside_the_largest_overlap():
    a = np.array([0, 0, 0, 1, 1, 2])
    assert stage1.partition_miss(a, a + 7) == 0.0
    assert stage1.partition_miss(a, np.array([5, 5, 6, 1, 1, 2])) == pytest.approx(1 / 6)
    assert stage1.partition_miss(a, np.zeros(6)) == pytest.approx(1 - 3 / 6)  # merged


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 2**-11 + 2**-13, -3.0])
    assert plain.tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-10, -3.0]


def _top_level_modules(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    mods = _top_level_modules(
        "import portbench.run, portbench.drivers.pair, portbench.drivers.serve\n"
        "from portbench import program\n"
        "program.registration(); program.wave_stats(); program.kernel_counts()\n"
        "import lrr_tpu_torch.pipeline.wave_graph, lrr_tpu_torch.sampling")
    assert "lrr_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "lrr_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules("import portbench.judge, portbench.reference.plain, "
                              "portbench.reference.icp, portbench.reference.stage1, "
                              "portbench.yardstick, portbench.phantom, portbench.draws")
    assert not mods & {"jax", "jaxlib", "flax", "lrr_tpu", "lrr_tpu_torch"}


def test_main_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "copd512.pair300",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# the reference's pieces against the program's, at test size on the CPU
# ---------------------------------------------------------------------------


def _features(n, seed, box=60.0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n, 3, generator=g) * box
    d0 = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    d1 = torch.nn.functional.normalize(torch.linalg.cross(d0, torch.randn(n, 3, generator=g)), dim=1)
    dirs = torch.stack([d0, d1, torch.linalg.cross(d0, d1)], 1)
    shape = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    eye = torch.eye(3).expand(n, 3, 3)
    nn_ = d0[:, :, None] * d0[:, None, :]
    proj = torch.where((shape == 2)[:, None, None], nn_,
                       torch.where((shape == 1)[:, None, None], eye - nn_, eye))
    mask = torch.rand(n, generator=g) > 0.1
    strength = torch.rand(n, generator=g) * 100 + 1
    return {"xyz": xyz, "strength": strength, "shape": shape, "projector": proj,
            "directions": dirs, "mask": mask}


def test_reference_descriptors_are_the_programs():
    from lrr_tpu_torch.config import DescriptorConfig
    from lrr_tpu_torch.ops.descriptors import compute_descriptors
    from lrr_tpu_torch.types import FeatureSet, KeypointSet

    f = _features(1500, 1)
    kp = torch.rand(40, 3, generator=torch.Generator().manual_seed(2)) * 40 + 10
    cfg = {"radius_mm": 30.0, "radius_bins": 5, "orient_bins": 4, "min_neighbors": 20,
           "max_neighbors": 256}
    fs = FeatureSet(f["xyz"], f["strength"], f["shape"], f["projector"], f["directions"], f["mask"])
    ks = KeypointSet(kp, torch.ones(40), torch.zeros(40, 3), torch.zeros(40, 3),
                     torch.ones(40, dtype=torch.bool))
    want = compute_descriptors(ks, fs, DescriptorConfig(**cfg))
    desc, direction, bidirection, ok = stage1.descriptors(kp, f, cfg, "f64")
    assert torch.equal(ok, want.keypoints.mask)
    torch.testing.assert_close(desc[ok].float(), want.descriptors[ok], rtol=0, atol=2e-5)
    torch.testing.assert_close(direction[ok].float(), want.keypoints.normal[ok], rtol=0, atol=2e-5)


def test_reference_watershed_is_the_programs():
    from lrr_tpu_torch.ops.watershed import watershed_segmentation

    vol = phantom.dense_phantom((24, 40, 40), (0.625, 0.625, 2.5), 3, torch.device("cpu"))
    want = watershed_segmentation(vol)
    got = stage1.watershed(vol, "f64")
    assert stage1.partition_miss(want.reshape(-1).numpy(), got.reshape(-1).numpy()) < 1e-3
    assert len(torch.unique(want)) > 10


def test_reference_regions_are_the_programs():
    from lrr_tpu_torch.pipeline.regions import select_features_by_labels
    from lrr_tpu_torch.types import FeatureSet

    f = _features(3000, 4, box=100.0)
    labels = torch.randint(0, 200, (3000,), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    q = torch.rand(8, 3, generator=torch.Generator().manual_seed(6)) * 60 + 20
    fs = FeatureSet(f["xyz"], f["strength"], f["shape"], f["projector"], f["directions"], f["mask"])
    want = select_features_by_labels(fs, labels, q, 300, box_lo=q - 25, box_hi=q + 25)
    got = stage1.select_regions(f["xyz"], f["mask"], labels, q, 300, q - 25, q + 25)
    assert torch.equal(got, want)


def test_reference_scales_are_the_programs():
    from lrr_tpu_torch.estimation.icp import _mad_scale_dof
    from lrr_tpu_torch.ops.robust import muse_scale

    from portbench.reference import icp as ricp

    g = torch.Generator().manual_seed(7)
    r = torch.randn(5, 2000, generator=g).abs() * 2
    m = torch.rand(5, 2000, generator=g) > 0.3
    torch.testing.assert_close(ricp.muse_scale(r.double(), m, 0.1, 0.9).float(),
                               muse_scale(r, m, 0.1, 0.9), rtol=1e-5, atol=0)
    torch.testing.assert_close(ricp.mad_scale_dof(r.double(), m).float(), _mad_scale_dof(r, m),
                               rtol=1e-6, atol=0)

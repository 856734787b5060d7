"""The port's serving slice against lrr_tpu: config, context loading,
indexing, PASS 1 and `register_locations_staged` end to end on the
committed small pair context, with the draws lrr_tpu makes."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.config as jconfig
import lrr_tpu_torch.config as tconfig
import torch_parity as tp
from lrr_tpu.matching import generate_candidates as jgen
from lrr_tpu.matching import initial_transforms as jinit
from lrr_tpu.pipeline.registration import register_locations_staged as jstaged
from lrr_tpu.verify import load_default_verifier as jload_svm
from lrr_tpu_torch.estimation.icp import bake_target_grid
from lrr_tpu_torch.matching.indexing import generate_candidates as tgen
from lrr_tpu_torch.matching.indexing import initial_transforms as tinit
from lrr_tpu_torch.models.affine import Affine3D
from lrr_tpu_torch.ops import kernels
from lrr_tpu_torch.ops.robust import nanmedian as _nanmedian
from lrr_tpu_torch.pipeline.registration import register_locations_staged as tstaged
from lrr_tpu_torch.sampling import draw_sampling_plan
from lrr_tpu_torch.verify.svm import load_default_verifier as tload_svm

KEY = jax.random.key(7)


@pytest.mark.parametrize(
    "name",
    ["FeatureConfig", "KeypointConfig", "DescriptorConfig", "IndexingConfig",
     "EstimationConfig", "VerifyConfig", "PipelineConfig"],
)
def test_config_fields_match(name):
    jf = dataclasses.fields(getattr(jconfig, name))
    tf = dataclasses.fields(getattr(tconfig, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        if a.default is dataclasses.MISSING:
            assert b.default is dataclasses.MISSING
        else:
            assert dataclasses.asdict(a.default) == dataclasses.asdict(b.default) \
                if dataclasses.is_dataclass(a.default) else a.default == b.default, a.name


def test_config_round_trips_through_dict():
    cfg = tconfig.PipelineConfig(
        estimation=tconfig.EstimationConfig(max_matches=4096, singular_value_bounds=(0.2, 5.0))
    )
    d = dataclasses.asdict(cfg)
    d["estimation"]["singular_value_bounds"] = list(d["estimation"]["singular_value_bounds"])
    assert tconfig.pipeline_config_from_dict(d) == cfg


def test_load_pair_context_matches_lrr_tpu():
    jctx, tctx = tp.small_contexts()
    for side in ("moving_features", "fixed_features"):
        for f in ("xyz", "strength", "shape", "projector", "directions", "mask"):
            np.testing.assert_array_equal(
                tp.np_(getattr(getattr(tctx, side), f)), np.asarray(getattr(getattr(jctx, side), f))
            )
    for side in ("moving_descriptors", "fixed_descriptors"):
        np.testing.assert_array_equal(
            tp.np_(getattr(tctx, side).descriptors), np.asarray(getattr(jctx, side).descriptors)
        )
        np.testing.assert_array_equal(
            tp.np_(getattr(tctx, side).keypoints.mask), np.asarray(getattr(jctx, side).keypoints.mask)
        )
    np.testing.assert_array_equal(tp.np_(tctx.fixed_vor.index_vol), np.asarray(jctx.fixed_vor.index_vol))
    live = np.asarray(jctx.fixed_descriptors.keypoints.mask)
    np.testing.assert_array_equal(tp.np_(tctx.nn_table[0])[live], np.asarray(jctx.nn_table[0])[live])
    np.testing.assert_allclose(tp.np_(tctx.nn_table[1])[live], np.asarray(jctx.nn_table[1])[live],
                               rtol=1e-4)
    # the rows the map lookup gives, baked, against lrr_tpu's grid: they
    # hold the unit projector direction, so equal up to an ulp
    np.testing.assert_allclose(
        tp.np_(bake_target_grid(tctx.moving_features, tctx.moving_vor)),
        np.asarray(jctx.moving_grid), rtol=1e-6, atol=1e-6)


def test_candidates_and_initial_transforms_match():
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    q = tp.small_queries()
    tc = tgen(torch.from_numpy(q), tctx.moving_descriptors, tctx.fixed_descriptors,
              tcfg.indexing, nn_table=tctx.nn_table)
    ti = tinit(tc, tctx.moving_descriptors, tctx.fixed_descriptors, torch.from_numpy(q))
    for i in range(len(q)):
        jc = jgen(jnp.asarray(q[i]), jctx.moving_descriptors, jctx.fixed_descriptors,
                  jcfg.indexing, nn_table=jctx.nn_table)
        ji = jinit(jc, jctx.moving_descriptors, jctx.fixed_descriptors, jnp.asarray(q[i]))
        np.testing.assert_array_equal(tc.mask[i].numpy(), np.asarray(jc.mask))
        m = np.asarray(jc.mask)
        np.testing.assert_array_equal(tc.moving_idx[i].numpy()[m], np.asarray(jc.moving_idx)[m])
        np.testing.assert_array_equal(tc.fixed_idx[i].numpy()[m], np.asarray(jc.fixed_idx)[m])
        np.testing.assert_allclose(ti.A[i].numpy()[m], np.asarray(ji.A)[m], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ti.t[i].numpy()[m], np.asarray(ji.t)[m], rtol=1e-5, atol=1e-4)


def test_nanmedian_averages_the_middle_pair():
    """H4: jnp.nanmedian averages the two middle values; torch.nanmedian
    would return the lower one."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    x[0, ::3] = np.nan  # 26 valid: even count
    x[1, :21] = np.nan  # 19 valid: odd count
    x[2] = np.nan  # none valid
    got = _nanmedian(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def test_sampling_plan_draws():
    _, tcfg = tp.small_configs()
    plan = draw_sampling_plan(torch.Generator().manual_seed(1), 3, tcfg, 50, 60)
    C, T = tcfg.indexing.num_candidates, tcfg.estimation.max_iterations + 1
    assert plan.icp_scores_f.shape == (3, C, 60) and plan.icp_offsets_b.shape == (3, C, T)
    assert float(plan.rank_scores.min()) >= 0.0 and float(plan.rank_scores.max()) < 1.0
    assert int(plan.cov_offset_f.min()) >= 0
    again = draw_sampling_plan(torch.Generator().manual_seed(1), 3, tcfg, 50, 60)
    assert torch.equal(plan.icp_offsets_f, again.icp_offsets_f)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; any other
    device launches the kernel (CUDA) or raises."""
    x = torch.zeros((1, 3, 4), device="meta")
    w = torch.zeros((1, 4), device="meta")
    c = torch.zeros((1, 3), device="meta")
    r = torch.ones(1, device="meta")
    with pytest.raises(ValueError):
        kernels.normal_equations_sym((x, x, x, w, w), (x, x, x, w, w), c, c, r, r, c)
    with pytest.raises(ValueError):
        kernels.knn(torch.zeros((2, 16), device="meta"), torch.zeros((3, 16), device="meta"),
                    torch.ones(3, dtype=torch.bool, device="meta"), 1)


def test_port_imports_no_jax():
    """The port and its smoke script import neither jax nor lrr_tpu, and
    open no file under lrr_tpu/ (the shipped verifier is the port's own)."""
    code = (
        "import builtins, os, sys\n"
        "opened = []\n"
        "real_open = builtins.open\n"
        "def spy(path, *a, **k):\n"
        "    opened.append(os.path.abspath(str(path)))\n"
        "    return real_open(path, *a, **k)\n"
        "builtins.open = spy\n"
        "import lrr_tpu_torch.pipeline.registration, lrr_tpu_torch.pipeline.artifacts\n"
        "import lrr_tpu_torch.parallel as par\n"
        "import lrr_tpu_torch.parallel.distributed, lrr_tpu_torch.parallel.sharding\n"
        "import lrr_tpu_torch.parallel.spatial\n"
        "import lrr_tpu_torch.verify.train_default\n"
        "assert len(par.__all__) == 10 and all(getattr(par, n) for n in par.__all__)\n"
        "import chip_smoke\n"
        "from lrr_tpu_torch.verify.svm import load_default_verifier\n"
        "load_default_verifier()\n"
        "assert 'jax' not in sys.modules and 'lrr_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'lrr_tpu.')))\n"
        "inside = [p for p in opened if 'lrr_tpu' in p.split(os.sep)]\n"
        "assert not inside, inside\n"
        "assert any(p.endswith('verifier_default.model') for p in opened)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
    # and no source of the port names that directory as a path component
    sources = [os.path.join(root, "chip_smoke.py")]
    for folder, _, files in os.walk(os.path.join(root, "lrr_tpu_torch")):
        sources += [os.path.join(folder, f) for f in files if f.endswith((".py", ".cu"))]
    pattern = re.compile(r"""["']lrr_tpu["']""")
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_register_locations_staged_matches_lrr_tpu():
    """The same draws through both serving paths: rank, selected and
    verified equal; the selected transforms within the reference's own
    ~0.5 % spread."""
    jcfg, tcfg = tp.small_configs()
    jctx, tctx = tp.small_contexts()
    queries = tp.small_queries()
    _, m_sel, f_sel, _ = tp.jax_candidates(jctx, queries, jcfg)
    plan = tp.plan_from_jax_keys(KEY, m_sel, f_sel, jcfg)

    want = jstaged(jctx, jnp.asarray(queries), jcfg, jload_svm(), KEY)
    got = tstaged(tctx, torch.from_numpy(queries), tcfg, tload_svm(), plan)

    sel = np.asarray(want.selected)
    assert (sel >= 0).sum() >= 2, "fixture should verify most queries"
    np.testing.assert_array_equal(got.selected.numpy(), sel)
    usable = np.asarray(want.candidate_mask & want.enough_features)
    np.testing.assert_array_equal(got.candidate_mask.numpy(), np.asarray(want.candidate_mask))
    np.testing.assert_array_equal(got.enough_features.numpy(), np.asarray(want.enough_features))
    # ranks are compared over usable candidates; the unusable tail ties at +inf
    for q in range(len(queries)):
        n = int(usable[q].sum())
        np.testing.assert_array_equal(got.rank[q, :n].numpy(), np.asarray(want.rank)[q, :n])
    np.testing.assert_array_equal(got.verified.numpy(), np.asarray(want.verified))
    np.testing.assert_array_equal(got.refined.numpy(), np.asarray(want.refined))
    np.testing.assert_allclose(got.initial_angle.numpy()[usable],
                               np.asarray(want.initial_angle)[usable], rtol=1e-4, atol=1e-5)
    for q in np.nonzero(sel >= 0)[0]:
        for g, w in ((got.trans.A, want.trans.A), (got.trans.t, want.trans.t)):
            g, w = g[q, sel[q]].numpy(), np.asarray(w)[q, sel[q]]
            assert np.abs(g - w).max() <= 5e-3 * np.abs(w).max()


def test_register_locations_staged_recovers_true_transform():
    """The port alone, with draws from a torch.Generator: every query
    verifies and the selected transforms sit near the ground truth."""
    _, tcfg = tp.small_configs()
    _, tctx = tp.small_contexts()
    queries = torch.from_numpy(tp.small_queries())
    plan = draw_sampling_plan(torch.Generator().manual_seed(0), len(queries), tcfg,
                              tctx.moving_features.capacity, tctx.fixed_features.capacity)
    out = tstaged(tctx, queries, tcfg, tload_svm(), plan)
    true = Affine3D(*(torch.tensor(tp.small_meta()["true"][k]) for k in ("A", "t", "center")))
    assert bool((out.selected >= 0).all())
    rng = np.random.default_rng(0)
    for q in range(len(queries)):
        tr = out.trans[q, int(out.selected[q])]
        src = true.inverse().apply(queries[q][None] + torch.tensor(
            rng.uniform(-10, 10, (20, 3)), dtype=torch.float32))
        err = torch.linalg.norm(tr.apply(src) - true.apply(src), dim=1)
        assert float(err.median()) < 1.5

"""The port's kernels K1 (normal equations) and K2 (k-NN) against lrr_tpu.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels (interpret mode) and the XLA paths of lrr_tpu on
the same numpy inputs.  The CUDA kernels themselves are tested on the card
by tests/test_torch_gpu.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrr_tpu.models.affine import Affine3D as JAffine
from lrr_tpu.estimation.icp import _normal_equations_packed
from lrr_tpu.ops.knn import knn as jknn
from lrr_tpu.ops.pallas_kernels import knn_pallas, normal_equations_pallas
from lrr_tpu_torch.models.affine import solve_normal_equations
from lrr_tpu_torch.ops import kernels, native
from lrr_tpu_torch.ops.knn import knn as tknn
from lrr_tpu_torch.pipeline.artifacts import load_pair_context
from lrr_tpu_torch.verify import svm as tsvm

K1_TOL = 2e-5  # x the largest entry: fp32 sums in another order


@pytest.mark.parametrize(
    "q_n,p_n,dim,k", [(37, 129, 195, 1), (200, 700, 195, 20), (64, 300, 3, 4)]
)
def test_knn_matches_lrr_tpu(q_n, p_n, dim, k):
    rng = np.random.default_rng(q_n + p_n)
    q = rng.standard_normal((q_n, dim)).astype(np.float32)
    p = rng.standard_normal((p_n, dim)).astype(np.float32)
    mask = rng.uniform(size=p_n) > 0.15

    d_t, i_t = tknn(torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(mask), k)
    for d_ref, i_ref in (
        jknn(jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), k),
        knn_pallas(jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), k, interpret=True),
    ):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_ref), rtol=2e-4, atol=2e-3)


def test_knn_all_masked():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((8, 195)), dtype=torch.float32)
    p = torch.tensor(rng.standard_normal((16, 195)), dtype=torch.float32)
    d, i = kernels.knn(q, p, torch.zeros(16, dtype=torch.bool), 2)
    assert d.shape == (8, 2) and i.dtype == torch.int32
    assert bool(torch.isinf(d).all())


def test_knn_ties_go_to_lower_index():
    p = torch.zeros((6, 16))
    p[3] = 1.0
    mask = torch.tensor([False, True, True, True, True, True])
    d, i = kernels.knn(torch.zeros((2, 16)), p, mask, 3)
    assert i.tolist() == [[1, 2, 4], [1, 2, 4]]
    assert d.tolist() == [[0.0, 0.0, 0.0]] * 2


def test_knn_rejects_k_above_128():
    with pytest.raises(ValueError):
        kernels.knn(torch.zeros((2, 16)), torch.zeros((4, 16)), torch.ones(4, dtype=torch.bool), 129)


def _decomposed_matches(rng, m):
    """Sheet / tube / corner projectors as (d, c1, c2), and their 3x3 form."""
    d = rng.standard_normal((m, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kind = np.arange(m) % 3
    c1 = np.where(kind == 0, 0.0, 1.0)
    c2 = np.select([kind == 0, kind == 1], [1.0, -1.0], 0.0)
    proj = c1[:, None, None] * np.eye(3) + c2[:, None, None] * np.einsum("mi,mj->mij", d, d)
    f32 = np.float32
    return d.astype(f32), c1.astype(f32), c2.astype(f32), proj.astype(f32)


def _tags(c1, c2):
    """Row tags of the (c1, c2) pairs: corner 1, sheet 2, tube 3."""
    return np.where(c1 == 0.0, 2.0, np.where(c2 < 0.0, 3.0, 1.0)).astype(np.float32)


def _one_direction(center, fx, ty, d, c1, c2, w):
    """A single direction through `normal_equations_sym`: the other one is
    empty and the frame is the identity, so nothing is rescaled."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    fwd = (t(fx.T[None]), t(ty.T[None]), t(d.T[None]), t(_tags(c1, c2)[None]), t(w[None]))
    bwd = (torch.zeros(1, 3, 0), torch.zeros(1, 3, 0), torch.zeros(1, 3, 0),
           torch.zeros(1, 0), torch.zeros(1, 0))
    zero3, one = torch.zeros(1, 3), torch.ones(1)
    return kernels.normal_equations_sym(fwd, bwd, zero3, zero3, one, one, t(center[None]))


def test_normal_equations_matches_lrr_tpu():
    rng = np.random.default_rng(5)
    m = 500
    fx = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    ty = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    d, c1, c2, proj = _decomposed_matches(rng, m)
    w = rng.uniform(0, 2, m).astype(np.float32)
    w[::7] = 0.0
    w[::11] = -0.5  # negative weights contribute nothing
    center = np.asarray([0.1, -0.2, 0.05], np.float32)

    tr = JAffine(A=jnp.eye(3), t=jnp.zeros(3), center=jnp.asarray(center))
    ata_pl, atb_pl = normal_equations_pallas(
        tr.homogeneous(jnp.asarray(fx)), jnp.asarray(proj), jnp.asarray(ty),
        jnp.asarray(w), interpret=True,
    )
    ata_x, atb_x = _normal_equations_packed(
        tr, jnp.asarray(fx.T), jnp.asarray(ty.T), jnp.asarray(d.T),
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(w),
    )
    ata_t, atb_t = _one_direction(center, fx, ty, d, c1, c2, w)
    for ata_ref, atb_ref in ((ata_pl, atb_pl), (ata_x, atb_x)):
        ata_ref, atb_ref = np.asarray(ata_ref), np.asarray(atb_ref)
        np.testing.assert_allclose(ata_t[0].numpy(), ata_ref, atol=K1_TOL * np.abs(ata_ref).max())
        np.testing.assert_allclose(atb_t[0].numpy(), atb_ref, atol=K1_TOL * np.abs(atb_ref).max())


def test_normal_equations_solution_parity():
    rng = np.random.default_rng(6)
    m = 400
    fx = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    true = np.asarray([[1.02, 0.05, 0.0], [-0.03, 0.97, 0.02], [0.01, 0.0, 1.01]], np.float32)
    ty = fx @ true.T + np.asarray([0.3, -0.2, 0.1], np.float32)
    d, c1, c2, proj = _decomposed_matches(rng, m)
    w = np.ones(m, np.float32)
    ata_j, atb_j = normal_equations_pallas(
        JAffine.identity().homogeneous(jnp.asarray(fx)), jnp.asarray(proj),
        jnp.asarray(ty), jnp.asarray(w), interpret=True,
    )
    theta_j = np.asarray(jnp.linalg.pinv(ata_j, hermitian=True) @ atb_j)
    ata, atb = _one_direction(np.zeros(3, np.float32), fx, ty, d, c1, c2, w)
    est, _ = solve_normal_equations(ata, atb, torch.zeros(1, 3))
    np.testing.assert_allclose(est.A[0].numpy(), true, atol=1e-3)
    np.testing.assert_allclose(est.A[0].numpy(), theta_j.reshape(3, 4)[:, :3], atol=1e-3)


def _sym_inputs(rng, L, m_f, m_b):
    """Both directions of a lane batch in world coordinates, with a frame."""
    f32 = np.float32

    def direction(m):
        d = rng.standard_normal((L, 3, m))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tag = rng.integers(0, 4, (L, m)).astype(f32)
        w = rng.uniform(-0.2, 2.0, (L, m))
        w[:, ::7] = 0.0
        return [rng.uniform(-40, 40, (L, 3, m)).astype(f32),
                rng.uniform(-40, 40, (L, 3, m)).astype(f32), d.astype(f32), tag, w.astype(f32)]

    frame = [rng.uniform(-5, 5, (L, 3)).astype(f32), rng.uniform(-5, 5, (L, 3)).astype(f32),
             rng.uniform(20, 30, L).astype(f32), rng.uniform(20, 30, L).astype(f32),
             rng.uniform(-0.1, 0.1, (L, 3)).astype(f32)]
    return direction(m_f), direction(m_b), frame


def _sym_reference(fwd, bwd, frame):
    """lrr_tpu's `_normal_equations_packed` per lane and direction on the
    normalised points, summed over the two directions."""
    cm, cf, rm, rf, center = frame
    L = cm.shape[0]
    ata = np.zeros((L, 12, 12), np.float32)
    atb = np.zeros((L, 12), np.float32)
    for fx, ty, d, tag, w in (fwd, bwd):
        sheet = ((tag > 1.5) & (tag < 2.5)).astype(np.float32)
        tube = (tag > 2.5).astype(np.float32)
        for l in range(L):
            tr = JAffine(A=jnp.eye(3), t=jnp.zeros(3), center=jnp.asarray(center[l]))
            a, b = _normal_equations_packed(
                tr, jnp.asarray((fx[l] - cm[l][:, None]) / rm[l]),
                jnp.asarray((ty[l] - cf[l][:, None]) / rf[l]), jnp.asarray(d[l]),
                jnp.asarray(1.0 - sheet[l]), jnp.asarray(sheet[l] - tube[l]), jnp.asarray(w[l]),
            )
            ata[l] += np.asarray(a)
            atb[l] += np.asarray(b)
    return ata, atb


@pytest.mark.parametrize("L,m_f,m_b", [(3, 256, 256), (2, 300, 170), (1, 37, 0)])
def test_normal_equations_sym_matches_lrr_tpu(L, m_f, m_b):
    """Equal and unequal match counts per direction (and an empty one)."""
    fwd, bwd, frame = _sym_inputs(np.random.default_rng(L + m_f), L, m_f, m_b)
    ata_ref, atb_ref = _sym_reference(fwd, bwd, frame)
    t = lambda arrays: tuple(torch.from_numpy(a) for a in arrays)
    ata, atb = kernels.normal_equations_sym(t(fwd), t(bwd), *t(frame))
    assert ata.shape == (L, 12, 12) and atb.shape == (L, 12)
    np.testing.assert_allclose(ata.numpy(), ata_ref, atol=K1_TOL * np.abs(ata_ref).max())
    np.testing.assert_allclose(atb.numpy(), atb_ref, atol=K1_TOL * np.abs(atb_ref).max())
    np.testing.assert_allclose(ata.numpy(), ata.numpy().transpose(0, 2, 1), atol=1e-6 * np.abs(ata_ref).max())


def test_normal_equations_sym_reads_strided_views():
    """The ICP hands K1 views of row gathers ([L, M, 8] rows seen as
    [L, 3, M]); they give what their contiguous copies give."""
    fwd, bwd, frame = _sym_inputs(np.random.default_rng(9), 2, 120, 90)
    t = lambda arrays: tuple(torch.from_numpy(a) for a in arrays)

    def as_rows(direction):
        fx, ty, d, tag, w = t(direction)
        rows_a = torch.cat([fx, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
        rows_b = torch.cat([ty, w[:, None], d, tag[:, None]], 1).permute(0, 2, 1).contiguous()
        va, vb = rows_a.permute(0, 2, 1), rows_b.permute(0, 2, 1)
        return va[:, 0:3], vb[:, 0:3], va[:, 4:7], vb[:, 7], w

    want = kernels.normal_equations_sym(t(fwd), t(bwd), *t(frame))
    got = kernels.normal_equations_sym(as_rows(fwd), as_rows(bwd), *t(frame))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=K1_TOL * float(w.abs().max()))


def test_normal_equations_sym_zero_weights_give_zero_system():
    fwd, bwd, frame = _sym_inputs(np.random.default_rng(2), 2, 64, 48)
    fwd[4][:] = 0.0
    bwd[4][:] = -1.0  # negative weights contribute nothing either
    t = lambda arrays: tuple(torch.from_numpy(a) for a in arrays)
    ata, atb = kernels.normal_equations_sym(t(fwd), t(bwd), *t(frame))
    assert not ata.any() and not atb.any()


def test_verifier_copy_is_byte_equal_to_lrr_tpu():
    """The port ships its own copy of the trained verifier; it must not
    drift from the JAX package's file."""
    import lrr_tpu

    theirs = os.path.join(os.path.dirname(lrr_tpu.__file__), "data", "verifier_default.model")
    assert os.path.dirname(tsvm.DEFAULT_MODEL_PATH).endswith(os.path.join("lrr_tpu_torch", "data"))
    for suffix in ("", ".json"):
        with open(theirs + suffix, "rb") as a, open(tsvm.DEFAULT_MODEL_PATH + suffix, "rb") as b:
            assert a.read() == b.read()


def test_load_pair_context_defaults_to_the_card(monkeypatch):
    """No device means CUDA: without a card it raises instead of carrying on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_pair_small.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pair_context(small)
    assert load_pair_context(small, "cpu").device.type == "cpu"


def test_kernel_library_is_named_by_source_hash():
    """Building is deferred to first CUDA use; each library's name is a pure
    function of its source and the flags, under the git-ignored build dir."""
    srcs = native.sources()
    assert {os.path.basename(s) for s in srcs} >= {"normal_equations.cu", "knn.cu"}
    for src in srcs:
        path = native.library_path(src)
        assert path == native.library_path(src)
        assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert len({native.library_path(s) for s in srcs}) == len(srcs)
    assert "build" in native.BUILD_DIR.split("/")

"""Verifier training of the PyTorch port against lrr_tpu's on seeded data:
the SMO solver and Platt fit (float64 host code, equal to 1e-9), the
kernel-logistic fit (500 float32 gradient steps, held by its probabilities),
the libsvm text format and the three svm-* commands."""

from __future__ import annotations

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lrr_tpu.cli as jcli
import lrr_tpu.verify.smo as jsmo
import lrr_tpu.verify.svm as jsvm
from lrr_tpu.verify.surrogate import surrogate_verifier as jsurrogate

import lrr_tpu_torch.cli as tcli
import lrr_tpu_torch.verify.smo as tsmo
import lrr_tpu_torch.verify.svm as tsvm
from lrr_tpu_torch.io.svmlight import write_svmlight
from lrr_tpu_torch.verify.surrogate import surrogate_verifier as tsurrogate

from tests import torch_parity as tp


def two_classes(seed: int, n: int = 60, d: int = 8, gap: float = 0.9):
    """Two overlapping Gaussian classes in [-1, 1]-ish measurement space."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=n) > 0.45, 1.0, 0.0)
    x = rng.normal(0, 0.5, (n, d)) + np.where(y[:, None] > 0, gap / 2, -gap / 2)
    return x.astype(np.float32), y.astype(np.float32)


def probabilities(model, x: np.ndarray) -> np.ndarray:
    if isinstance(model.sv, torch.Tensor):
        return tsvm.predict_probability(model, torch.from_numpy(x)).numpy()
    return np.asarray(jsvm.predict_probability(model, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# SMO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,C", [(0, 1.0), (1, 10.0), (2, 0.3)])
def test_smo_solve_matches_lrr_tpu(seed, C):
    x, y = two_classes(seed)
    yy = np.where(y > 0, 1.0, -1.0)
    K = tsmo.rbf_kernel(x.astype(np.float64), 0.125)
    np.testing.assert_allclose(K, jsmo.rbf_kernel(x.astype(np.float64), 0.125), rtol=0, atol=1e-15)
    ta, trho, tit = tsmo.smo_solve(K, yy, C)
    ja, jrho, jit_ = jsmo.smo_solve(K, yy, C)
    assert tit == jit_ and tit > 10
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-9)
    assert abs(trho - jrho) <= 1e-9
    assert abs(float(yy @ ta)) < 1e-9 and ta.min() >= 0 and ta.max() <= C + 1e-12


def test_sigmoid_train_matches_lrr_tpu():
    rng = np.random.default_rng(3)
    dec = rng.normal(0, 2, 80)
    labels = (dec + rng.normal(0, 1, 80)) > 0
    ta, tb = tsmo.sigmoid_train(dec, labels)
    ja, jb = jsmo.sigmoid_train(dec, labels)
    assert abs(ta - ja) <= 1e-9 and abs(tb - jb) <= 1e-9 and ta < 0


@pytest.mark.parametrize("probability", [True, False], ids=["platt", "no_probability"])
def test_train_c_svc_matches_lrr_tpu(probability):
    x, y = two_classes(4, n=70)
    t = tsmo.train_c_svc(x, y, probability=probability)
    j = jsmo.train_c_svc(x, y, probability=probability)
    assert isinstance(t.sv, torch.Tensor) and t.sv.dtype == torch.float32
    np.testing.assert_array_equal(t.sv.numpy(), j.sv)
    np.testing.assert_array_equal(t.sv_coef.numpy(), j.sv_coef)
    for k in ("rho", "prob_a", "prob_b", "gamma"):
        assert abs(getattr(t, k) - getattr(j, k)) <= 1e-9, k
    assert t.labels == j.labels and 0 < t.sv.shape[0] < len(y)
    held, _ = two_classes(5, n=40)
    np.testing.assert_allclose(probabilities(t, held), probabilities(j, held), atol=1e-5)
    acc = ((probabilities(t, x) > 0.5) == (y > 0)).mean()
    assert acc >= 0.85


# ---------------------------------------------------------------------------
# the kernel-logistic fit
# ---------------------------------------------------------------------------


def assert_probabilities_agree(t_model, j_model, sets):
    for x in sets:
        pt, pj = probabilities(t_model, x), probabilities(j_model, x)
        np.testing.assert_allclose(pt, pj, atol=2e-3)
        clear = np.abs(pj - 0.5) > 0.02
        assert clear.sum() >= len(pj) // 2
        np.testing.assert_array_equal((pt > 0.5)[clear], (pj > 0.5)[clear])


def test_fit_rbf_classifier_probabilities_match_lrr_tpu():
    x, y = two_classes(6, n=96)
    held, _ = two_classes(7, n=64)
    t = tsvm.fit_rbf_classifier(x, y, device="cpu")
    j = jsvm.fit_rbf_classifier(x, y)
    assert t.prob_a == -1.0 and t.prob_b == 0.0 and t.labels == (1, -1)
    assert t.sv.shape == (96, 8) and t.sv_coef.dtype == torch.float32
    assert_probabilities_agree(t, j, (x, held))
    assert ((probabilities(t, x) > 0.5) == (y > 0)).mean() >= 0.85


def test_fit_rbf_classifier_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = two_classes(6, n=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsvm.fit_rbf_classifier(x, y, steps=1)


def test_surrogate_verifier_probabilities_match_lrr_tpu():
    t, j = tsurrogate(seed=7, device="cpu"), jsurrogate(seed=7)
    np.testing.assert_array_equal(t.sv.numpy(), j.sv)  # the same seeded corpus, scaled alike
    rng = np.random.default_rng(8)
    probes = rng.uniform(-1.2, 1.2, (200, 8)).astype(np.float32)
    assert_probabilities_agree(t, j, (np.asarray(j.sv), probes))


# ---------------------------------------------------------------------------
# the libsvm text format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["smo", "klr", "shipped"])
def test_serialize_libsvm_model_text_is_lrr_tpus(kind):
    if kind == "shipped":
        t, j = tsvm.load_default_verifier(), jsvm.load_default_verifier()
    else:
        x, y = two_classes(9, n=40)
        j = jsmo.train_c_svc(x, y) if kind == "smo" else jsvm.fit_rbf_classifier(x, y, steps=50)
        t = tp.torch_svm(j)
    text = tsvm.serialize_libsvm_model(t)
    assert text == jsvm.serialize_libsvm_model(j)
    back = tsvm.parse_libsvm_model(text)
    assert tsvm.serialize_libsvm_model(back) == text  # %g is stable from here on
    held, _ = two_classes(10, n=30)
    np.testing.assert_allclose(probabilities(back, held), probabilities(t, held), atol=1e-5)
    jback = jsvm.parse_libsvm_model(text)
    np.testing.assert_array_equal(back.sv.numpy(), jback.sv)
    np.testing.assert_array_equal(back.sv_coef.numpy(), jback.sv_coef)
    assert (back.gamma, back.rho, back.prob_a, back.prob_b, back.labels) == \
        (jback.gamma, jback.rho, jback.prob_a, jback.prob_b, jback.labels)


# ---------------------------------------------------------------------------
# svm-scale, svm-train, svm-predict
# ---------------------------------------------------------------------------


def test_svm_commands_write_what_lrr_tpus_write(tmp_path, capsys):
    x, y = two_classes(11, n=50)
    x = x * 20 + 5  # unscaled, as measurements come
    data = str(tmp_path / "data.txt")
    write_svmlight(data, x, np.where(y > 0, 1.0, -1.0))
    out = {}
    for side, cli, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        cli.main(["svm-scale", data, str(d / "scaled.txt"), "-s", str(d / "range.txt")])
        cli.main(["svm-scale", data, str(d / "restored.txt"), "-r", str(d / "range.txt")])
        cli.main(["svm-train", str(d / "scaled.txt"), str(d / "smo.model"), "-c", "2"] + dev)
        cli.main(["svm-train", str(d / "scaled.txt"), str(d / "klr.model"), "--solver", "klr",
                  "--steps", "60"] + dev)
        cli.main(["svm-predict", str(d / "scaled.txt"), str(d / "smo.model"),
                  str(d / "pred_b.txt"), "-b"] + dev)
        cli.main(["svm-predict", str(d / "scaled.txt"), str(d / "smo.model"),
                  str(d / "pred.txt")] + dev)
        out[side] = capsys.readouterr().out
    assert out["t"].replace(str(tmp_path / "t"), "") == out["j"].replace(str(tmp_path / "j"), "")
    assert "Accuracy = " in out["t"] and "(smo, " in out["t"]
    for name in ("scaled.txt", "range.txt", "restored.txt", "smo.model", "pred.txt"):
        assert filecmp.cmp(str(tmp_path / "j" / name), str(tmp_path / "t" / name), shallow=False), name
    assert filecmp.cmp(str(tmp_path / "t" / "scaled.txt"), str(tmp_path / "t" / "restored.txt"),
                       shallow=False)
    # probabilities are printed with six digits: equal to the last one or two
    jp = np.loadtxt(str(tmp_path / "j" / "pred_b.txt"), skiprows=1)
    tpd = np.loadtxt(str(tmp_path / "t" / "pred_b.txt"), skiprows=1)
    np.testing.assert_allclose(tpd, jp, atol=1e-5)
    # the kernel-logistic model: same support vectors, coefficients close
    jk = jsvm.parse_libsvm_model(open(str(tmp_path / "j" / "klr.model")).read())
    tk = tsvm.parse_libsvm_model(open(str(tmp_path / "t" / "klr.model")).read())
    np.testing.assert_array_equal(tk.sv.numpy(), jk.sv)
    scaled = np.asarray(jk.sv)
    np.testing.assert_allclose(probabilities(tk, scaled), probabilities(jk, scaled), atol=2e-3)

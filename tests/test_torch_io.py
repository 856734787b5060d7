"""File formats of the PyTorch port against lrr_tpu's: every file one
package writes, the other reads, with equal arrays; where the format is text
the two writers give equal bytes.  Seeded numpy inputs, CPU."""

from __future__ import annotations

import base64
import filecmp
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import lrr_tpu.io as jio
import lrr_tpu.io.dicom as jdicom
import lrr_tpu.io.mhd as jmhd
import lrr_tpu.io.svmlight as jsvml
import lrr_tpu.pipeline.artifacts as jart
import lrr_tpu.types as jtypes
import lrr_tpu.utils.timers as jtimers
from lrr_tpu.pipeline.results import read_itk_transform as jread_itk
from lrr_tpu.pipeline.results import write_itk_transform as jwrite_itk

import lrr_tpu_torch.io as tio
import lrr_tpu_torch.io.dicom as tdicom
import lrr_tpu_torch.io.mhd as tmhd
import lrr_tpu_torch.io.native_loader as tnative
import lrr_tpu_torch.io.svmlight as tsvml
import lrr_tpu_torch.pipeline.artifacts as tart
from lrr_tpu_torch.pipeline.results import read_itk_transform as tread_itk
from lrr_tpu_torch.pipeline.results import write_itk_transform as twrite_itk
from lrr_tpu_torch.types import CORNER, SHEET, DescriptorSet, FeatureSet, KeypointSet
from lrr_tpu_torch.utils import timers as ttimers

from tests import torch_parity as tp

MET_TYPES = sorted(tmhd._MET_TO_DTYPE)


def _volume(dtype, seed=0, shape=(5, 6, 7)):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 100, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -30000), min(info.max, 30000), shape).astype(dtype)


def _same_bytes(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


# ---------------------------------------------------------------------------
# MetaImage
# ---------------------------------------------------------------------------


def test_met_tables_are_lrr_tpus():
    assert tmhd._MET_TO_DTYPE == jmhd._MET_TO_DTYPE


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("met", MET_TYPES)
def test_mhd_crosses_the_packages(tmp_path, met, compressed):
    """.mhd + external data file and .mha, every element type: both writers
    give the same bytes, and each reader reads the other's file."""
    data = _volume(tmhd._MET_TO_DTYPE[met])
    origin, spacing = (1.5, -2.0, 3.25), (0.7, 0.7, 1.25)
    for ext in (".mhd", ".mha"):
        jp, tpth = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
        jmhd.write_mhd(jp, data, origin, spacing, compressed=compressed)
        tmhd.write_mhd(tpth, data, origin, spacing, compressed=compressed)
        if ext == ".mha":
            assert _same_bytes(jp, tpth)
        else:  # the header names its own data file
            raw = ".zraw" if compressed else ".raw"
            assert _same_bytes(jp[:-4] + raw, tpth[:-4] + raw)
            assert open(jp).read().replace("j" + raw, "t" + raw) == open(tpth).read()
        for reader, path in ((tmhd.read_mhd, jp), (jmhd.read_mhd, tpth)):
            got, o, s = reader(path)
            assert got.dtype == data.dtype
            np.testing.assert_array_equal(got, data)
            np.testing.assert_array_equal(o, np.asarray(origin, np.float32))
            np.testing.assert_array_equal(s, np.asarray(spacing, np.float32))


def test_read_mhd_volume_on_the_cpu_and_default_device(tmp_path):
    data = _volume(np.int16)
    p = str(tmp_path / "v.mhd")
    tmhd.write_mhd(p, data, (1, 2, 3), (1, 1, 2))
    vol = tmhd.read_mhd_volume(p, "cpu")
    want = jmhd.read_mhd_volume(p)
    assert vol.data.dtype == torch.float32 and vol.device.type == "cpu"
    for f in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(getattr(vol, f).numpy(), np.asarray(getattr(want, f)))
    vol.data[0, 0, 0] = 1.0  # a tensor of its own, not a view of the file's bytes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmhd.read_mhd_volume(p)


@pytest.mark.parametrize("code", sorted(tnative._ELEMENT_DTYPES))
def test_native_reader_matches_python_reader(tmp_path, code):
    if tnative.reader_kind() != "native":
        pytest.skip("no C++ toolchain on this host: the pure-Python reader serves")
    data = _volume(tnative._ELEMENT_DTYPES[code], seed=code)
    for name, compressed in (("a.mhd", False), ("b.mha", True)):
        p = str(tmp_path / name)
        tmhd.write_mhd(p, data, (1.5, 2, 3), (1, 0.5, 2), compressed=compressed)
        got = tnative.read_mhd_native(p)
        want = tmhd.read_mhd(p)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_native_library_builds_outside_the_package():
    if tnative.reader_kind() != "native":
        pytest.skip("no C++ toolchain on this host")
    path = tnative.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(root, "build", "lrr_tpu_torch") + os.sep)
    assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.join(root, "lrr_tpu_torch", "io", "native"))
                if f.endswith(".so")]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_volume_loader_keeps_order_past_a_missing_file(tmp_path, monkeypatch, native):
    if native and tnative.reader_kind() != "native":
        pytest.skip("no C++ toolchain on this host")
    if not native:
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    vols = [_volume(np.float32, seed=i) for i in range(3)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"v{i}.mha"))
        tmhd.write_mhd(paths[-1], v, compressed=bool(i % 2))
    paths.insert(1, str(tmp_path / "missing.mhd"))
    loader = tnative.VolumeLoader(paths, n_threads=2, max_queue=2)
    np.testing.assert_array_equal(next(loader)[0], vols[0])
    with pytest.raises(OSError):
        next(loader)
    np.testing.assert_array_equal(next(loader)[0], vols[1])
    np.testing.assert_array_equal(next(loader)[0], vols[2])
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()


def test_b64_decode_native_matches_stdlib():
    if tnative.reader_kind() != "native":
        pytest.skip("no C++ toolchain on this host")
    raw = np.random.default_rng(0).integers(0, 256, 1001).astype(np.uint8).tobytes()
    text = base64.b64encode(raw)
    broken = b"\n  ".join(text[i : i + 60] for i in range(0, len(text), 60))
    assert tnative.b64_decode_native(broken).tobytes() == raw


# ---------------------------------------------------------------------------
# VTK XML polydata: features, keypoints, descriptors
# ---------------------------------------------------------------------------


def _sets(seed=0, n=40, cap=64, k=9, kcap=16):
    """A feature set and a descriptor set as stage 1 leaves them: valid rows
    scattered among masked ones, unit direction frames by shape class."""
    rng = np.random.default_rng(seed)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    mask = np.zeros(cap, bool)
    mask[rng.permutation(cap)[:n]] = True
    shape = rng.integers(0, 3, cap).astype(np.int32)
    normal = unit(rng.normal(size=(cap, 3)))
    binormal = unit(np.cross(normal, rng.normal(size=(cap, 3))))
    dirs = np.zeros((cap, 3, 3), np.float32)
    dirs[:, 0] = normal
    dirs[shape != SHEET, 1] = binormal[shape != SHEET]
    dirs[shape == CORNER, 2] = unit(np.cross(
        normal.astype(np.float32), binormal.astype(np.float32)))[shape == CORNER]
    fs = FeatureSet(
        xyz=torch.tensor(rng.uniform(0, 60, (cap, 3)), dtype=torch.float32),
        strength=torch.tensor(rng.uniform(0.1, 9, cap), dtype=torch.float32),
        shape=torch.tensor(shape), projector=torch.tensor(rng.normal(size=(cap, 3, 3)), dtype=torch.float32),
        directions=torch.tensor(dirs), mask=torch.tensor(mask),
    )
    kmask = np.zeros(kcap, bool)
    kmask[rng.permutation(kcap)[:k]] = True
    kp = KeypointSet(
        xyz=torch.tensor(rng.uniform(0, 60, (kcap, 3)), dtype=torch.float32),
        strength=torch.tensor(rng.uniform(0.1, 9, kcap), dtype=torch.float32),
        normal=torch.tensor(unit(rng.normal(size=(kcap, 3))), dtype=torch.float32),
        binormal=torch.tensor(unit(rng.normal(size=(kcap, 3))), dtype=torch.float32),
        mask=torch.tensor(kmask),
    )
    ds = DescriptorSet(kp, torch.tensor(rng.uniform(0, 1, (kcap, 195)), dtype=torch.float32))
    return fs, kp, ds


def _jax_set(obj):
    if isinstance(obj, DescriptorSet):
        return jtypes.DescriptorSet(
            keypoints=tp.jax_like(obj.keypoints, jtypes.KeypointSet),
            descriptors=tp.np_(obj.descriptors))
    return tp.jax_like(obj, getattr(jtypes, type(obj).__name__))


def _flat(obj) -> dict:
    if hasattr(obj, "descriptors"):
        return {"descriptors": tp.np_(obj.descriptors),
                **{"kp." + k: v for k, v in _flat(obj.keypoints).items()}}
    return {k: tp.np_(getattr(obj, k)) for k in type(obj).__dataclass_fields__}


KINDS = {
    "features": (0, "write_features", "read_features"),
    "keypoints": (1, "write_keypoints", "read_keypoints"),
    "descriptors": (2, "write_descriptors", "read_descriptors"),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_polydata_sets_cross_the_packages(tmp_path, kind):
    """Both writers give the same bytes; each reader gives the other's
    arrays; what comes back holds the valid rows in order, padded to the
    capacity asked for."""
    which, wname, rname = KINDS[kind]
    obj = _sets()[which]
    jp, tpth = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    getattr(jio, wname)(jp, _jax_set(obj))
    getattr(tio, wname)(tpth, obj)
    assert _same_bytes(jp, tpth)
    cap = (obj.keypoints if kind == "descriptors" else obj).capacity
    for capacity in (None, cap):
        got = _flat(getattr(tio, rname)(jp, capacity=capacity, device="cpu"))
        want = _flat(getattr(jio, rname)(tpth, capacity=capacity))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the set read back is the set written: order and mask
    src = _flat(obj)
    mkey = "kp.mask" if kind == "descriptors" else "mask"
    m = src[mkey]
    n = int(m.sum())
    assert got[mkey][:n].all() and not got[mkey][n:].any()
    for k in got:
        if k in (mkey, "kp.strength"):  # a descriptor file carries no strengths
            continue
        np.testing.assert_array_equal(got[k][:n], src[k][m], err_msg=k)
        assert not got[k][n:].any()


def test_readers_take_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fs, kp, ds = _sets()
    p = str(tmp_path / "f.vtk")
    tio.write_features(p, fs)
    for reader in (tio.read_features, tio.read_keypoints, tio.read_descriptors):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reader(p)


def _vtp_variant(poly, encoding: str) -> str:
    """A polydata file in an encoding neither package writes: appended
    base64, inline base64 with zlib blocks, or big-endian inline base64."""
    order = ">" if encoding == "big_endian" else "<"

    def block(arr):
        raw = arr.astype(arr.dtype.newbyteorder(order)).tobytes()
        if encoding == "zlib":
            comp = zlib.compress(raw)
            return struct.pack("<IIII", 1, len(raw), len(raw), len(comp)) + comp
        return struct.pack(order + "I", len(raw)) + raw

    arrays = [(name, np.asarray(a)) for name, a in poly.point_data.items()]
    arrays.append((None, np.asarray(poly.points, np.float32)))
    appended, offsets = b"", []
    for _, a in arrays:
        offsets.append(len(appended))
        appended += block(a)

    def tag(i, name, a):
        ncomp = a.shape[1] if a.ndim > 1 else 1
        head = (f'<DataArray type="{tio.vtk_xml._DTYPE_TO_VTK[a.dtype]}"'
                + (f' Name="{name}"' if name else "") + f' NumberOfComponents="{ncomp}" ')
        if encoding == "appended":
            return head + f'format="appended" offset="{offsets[i]}"/>'
        return head + 'format="binary">' + base64.b64encode(block(a)).decode() + "</DataArray>"

    tags = [tag(i, name, a) for i, (name, a) in enumerate(arrays)]
    attrs = {"appended": 'byte_order="LittleEndian" header_type="UInt32"',
             "zlib": 'byte_order="LittleEndian" header_type="UInt32" '
                     'compressor="vtkZlibDataCompressor"',
             "big_endian": 'byte_order="BigEndian" header_type="UInt32"'}[encoding]
    tail = ""
    if encoding == "appended":
        tail = '<AppendedData encoding="base64">_' + base64.b64encode(appended).decode() + \
            "</AppendedData>"
    return (f'<?xml version="1.0"?><VTKFile type="PolyData" version="0.1" {attrs}><PolyData>'
            f'<Piece NumberOfPoints="{poly.points.shape[0]}"><PointData>' + "".join(tags[:-1])
            + "</PointData><Points>" + tags[-1] + "</Points></Piece></PolyData>" + tail
            + "</VTKFile>")


@pytest.mark.parametrize("encoding", ["ascii", "appended", "zlib", "big_endian"])
def test_vtp_encodings_read_alike(tmp_path, encoding):
    rng = np.random.default_rng(3)
    poly = tio.PolyData(
        points=rng.normal(size=(11, 3)).astype(np.float32),
        point_data={"normals": rng.normal(size=(11, 3)).astype(np.float32),
                    "shapes": rng.integers(0, 3, 11).astype(np.uint8),
                    "strengths": rng.uniform(size=11).astype(np.float32)},
    )
    p = str(tmp_path / "p.vtp")
    if encoding == "ascii":
        tio.write_vtp(p, poly, ascii_fmt=True)
        jp = str(tmp_path / "j.vtp")
        jio.write_vtp(jp, jio.PolyData(poly.points, poly.point_data), ascii_fmt=True)
        assert _same_bytes(p, jp)
    else:
        with open(p, "w") as f:
            f.write(_vtp_variant(poly, encoding))
    got, want = tio.read_vtp(p), jio.read_vtp(p)
    if encoding == "zlib":  # VTK's own spelling of the compressor, which the port takes too
        vtk = str(tmp_path / "vtk.vtp")
        with open(vtk, "w") as f:
            f.write(_vtp_variant(poly, encoding).replace("vtkZlibData", "vtkZLibData"))
        np.testing.assert_array_equal(tio.read_vtp(vtk).points, poly.points)
    for g in (got, want):
        # ascii prints %g: six significant digits
        tol = dict(rtol=1e-5, atol=1e-6) if encoding == "ascii" else dict(rtol=0, atol=0)
        np.testing.assert_allclose(g.points, poly.points, **tol)
        for k, v in poly.point_data.items():
            np.testing.assert_allclose(g.point_data[k], v, **tol)
    np.testing.assert_array_equal(got.points, want.points)
    for k in poly.point_data:
        assert got.point_data[k].dtype == want.point_data[k].dtype
        np.testing.assert_array_equal(got.point_data[k], want.point_data[k])


# ---------------------------------------------------------------------------
# DICOM, svmlight, ITK transform
# ---------------------------------------------------------------------------


def test_dicom_series_crosses_the_packages(tmp_path):
    from lrr_tpu_torch.types import Volume

    data = _volume(np.int16, seed=5, shape=(4, 6, 5)).astype(np.float32)
    origin, spacing = np.float32([1.0, -2.5, 10.0]), np.float32([0.8, 0.9, 2.5])
    tvol = Volume(torch.tensor(data), torch.tensor(origin), torch.tensor(spacing))
    jvol = tp.jax_like(tvol, jtypes.Volume)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jdicom.write_dicom_series(jd, jvol)
    tdicom.write_dicom_series(td, tvol)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert _same_bytes(os.path.join(jd, name), os.path.join(td, name)), name
    got = tdicom.read_dicom_series(jd, "cpu")
    want = jdicom.read_dicom_series(td)
    for f in ("data", "origin", "spacing"):
        np.testing.assert_array_equal(tp.np_(getattr(got, f)), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(tp.np_(got.data), data)
    # one slice, a directory and an .mhd through the auto-detecting reader
    one = os.path.join(jd, sorted(os.listdir(jd))[1])
    px, meta = tdicom.read_dicom_slice(one)
    jpx, jmeta = jdicom.read_dicom_slice(one)
    np.testing.assert_array_equal(px, jpx)
    assert meta == jmeta
    for path in (one, jd):
        got, want = tdicom.read_volume_any(path, "cpu"), jdicom.read_volume_any(path)
        for f in ("data", "origin", "spacing"):
            np.testing.assert_array_equal(tp.np_(getattr(got, f)), np.asarray(getattr(want, f)))


def test_svmlight_and_range_files_cross_the_packages(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 30, (17, 8)).astype(np.float32)
    x[3, 2] = 0.0
    y = np.where(rng.uniform(size=17) > 0.5, 1.0, -1.0).astype(np.float32)
    jp, tpth = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jsvml.write_svmlight(jp, x, y)
    tsvml.write_svmlight(tpth, x, y)
    assert _same_bytes(jp, tpth)
    for got, want in zip(tsvml.read_svmlight(jp), jsvml.read_svmlight(tpth)):
        np.testing.assert_array_equal(got, want)
    jr, tr = jsvml.fit_scale(x, -1.0, 1.0), tsvml.fit_scale(x, -1.0, 1.0)
    jsvml.write_range_file(jp + ".range", jr)
    tsvml.write_range_file(tpth + ".range", tr)
    assert _same_bytes(jp + ".range", tpth + ".range")
    back_t, back_j = tsvml.read_range_file(jp + ".range"), jsvml.read_range_file(tpth + ".range")
    for k in ("lower", "upper", "min", "max"):
        np.testing.assert_array_equal(back_t[k], back_j[k])
        np.testing.assert_array_equal(back_t[k], tr[k])
    np.testing.assert_array_equal(tsvml.apply_scale(x, back_t), jsvml.apply_scale(x, back_j))


def test_itk_transform_file_crosses_the_packages(tmp_path):
    rng = np.random.default_rng(4)
    A = (np.eye(3) + 0.05 * rng.normal(size=(3, 3))).astype(np.float32)
    t, c = rng.normal(size=3).astype(np.float32), rng.normal(0, 20, 3).astype(np.float32)
    jp, tpth = str(tmp_path / "j.vtk"), str(tmp_path / "t.vtk")
    jwrite_itk(jp, A, t, c)
    twrite_itk(tpth, A, t, c)
    assert _same_bytes(jp, tpth)
    for got, want, src in zip(tread_itk(jp), jread_itk(tpth), (A, t, c)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, src, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the pair context
# ---------------------------------------------------------------------------


def _assert_contexts_equal(t, j):
    for side in ("moving_features", "fixed_features"):
        for f in ("xyz", "strength", "shape", "projector", "directions", "mask"):
            np.testing.assert_array_equal(
                tp.np_(getattr(getattr(t, side), f)), np.asarray(getattr(getattr(j, side), f)))
    for side in ("moving_descriptors", "fixed_descriptors"):
        np.testing.assert_array_equal(
            tp.np_(getattr(t, side).descriptors), np.asarray(getattr(j, side).descriptors))
        for f in ("xyz", "strength", "normal", "binormal", "mask"):
            np.testing.assert_array_equal(
                tp.np_(getattr(getattr(t, side).keypoints, f)),
                np.asarray(getattr(getattr(j, side).keypoints, f)))
    for side in ("moving_vor", "fixed_vor"):
        for f in ("index_vol", "origin", "spacing"):
            np.testing.assert_array_equal(
                tp.np_(getattr(getattr(t, side), f)), np.asarray(getattr(getattr(j, side), f)))


def test_pair_context_crosses_the_packages(tmp_path):
    """What the port saves, lrr_tpu loads, and back; the region ids ride
    along in the port's file and lrr_tpu's loader passes over them."""
    jctx, tctx = tp.small_region_contexts()
    p = str(tmp_path / "t.npz")
    tart.save_pair_context(p, tctx)
    _assert_contexts_equal(tctx, jart.load_pair_context(p))
    back = tart.load_pair_context(p, "cpu")
    _assert_contexts_equal(back, jctx)
    for a, b in ((back.moving_region_labels, tctx.moving_region_labels),
                 (back.fixed_region_labels, tctx.fixed_region_labels)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert torch.equal(back.nn_table[0], tctx.nn_table[0])
    assert torch.equal(back.nn_table[1], tctx.nn_table[1])
    # lrr_tpu's own save (no region ids) into the port
    jp = str(tmp_path / "j.npz")
    jart.save_pair_context(jp, jctx)
    from_j = tart.load_pair_context(jp, "cpu")
    _assert_contexts_equal(from_j, jctx)
    assert from_j.moving_region_labels is None and from_j.fixed_region_labels is None


@pytest.mark.parametrize("name", ["tests/data/torch_pair_small.npz",
                                  "lrr_tpu_torch/data/bench_pair_s64.npz"])
def test_committed_contexts_resave_to_the_same_arrays(tmp_path, name):
    """The committed contexts through the port's load and save: every array
    of the file comes back as it was (the fixtures themselves stay as
    committed)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, name)
    p = str(tmp_path / "resaved.npz")
    tart.save_pair_context(p, tart.load_pair_context(src, "cpu"))
    with np.load(src) as a, np.load(p) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype or k in ("mr.0", "fr.0"), k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# stage timers
# ---------------------------------------------------------------------------


def test_stage_timers_count_and_report_as_lrr_tpus():
    """Counts, the dictionary `batch_report.json` carries and the report's
    layout are lrr_tpu's; a stage that raises is still counted."""
    tt, jt = ttimers.StageTimers(), jtimers.StageTimers(sync=False)
    for timers in (tt, jt):
        for name in ("load", "register", "register"):
            with timers.time(name):
                pass
        with pytest.raises(ValueError):
            with timers.time("prepare"):
                raise ValueError("stage failed")
        timers.totals.update({"load": 0.25, "register": 1.5, "prepare": 0.125})
    assert tt.as_dict() == jt.as_dict() == {
        "load": {"total_s": 0.25, "count": 1}, "register": {"total_s": 1.5, "count": 2},
        "prepare": {"total_s": 0.125, "count": 1}}
    assert tt.report() == jt.report()
    assert tt.report().splitlines()[0].split() == ["register", "1.500s", "x2"]


def test_new_modules_import_neither_jax_nor_lrr_tpu():
    """Importing the port's command line, every module of the file-based
    pipeline and every module of the estimate family leaves jax and lrr_tpu
    out of `sys.modules`."""
    mods = [
        "cli", "io", "io.mhd", "io.native_loader", "io.vtk_xml", "io.features_io", "io.dicom",
        "io.svmlight", "utils.timers", "pipeline.results", "pipeline.artifacts", "pipeline.batch",
        "verify.svm", "verify.smo", "verify.surrogate", "eval", "eval.repeatability",
        "eval.compare", "eval.indexing_eval", "viz", "viz.panels",
        "ops.robust", "ops.knn", "ops.geometry", "ops.subsample", "models.affine",
        "models.similarity", "models.bspline", "estimation.icp_classic",
        "estimation.similarity2d", "estimation.lbfgs", "estimation.cdc", "pipeline.intensity",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('lrr_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'lrr_tpu' or m.startswith('lrr_tpu.'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)

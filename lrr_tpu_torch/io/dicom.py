"""Minimal DICOM series reader for CT volumes (lrr_tpu/io/dicom.py).

The reference ingests either MetaImage volumes or DICOM series via ITK/GDCM
(features/ExtractFeatures.cxx:88-172, features/CropDicom.cxx).  This is a
dependency-free equivalent for the common CT case: Part-10 files, little
endian, explicit or implicit VR, uncompressed (native) PixelData, monochrome
integer pixels.  Compressed transfer syntaxes raise with a clear message.

Slices are ordered by the projection of ImagePositionPatient onto the slice
normal (fallback: InstanceNumber), stacked into a Volume whose voxel array is
indexed [z, y, x] with `origin`/`spacing` in mm, matching io/mhd.py
conventions.  RescaleSlope/Intercept are applied so intensities are in
Hounsfield units, as ITK does.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from lrr_tpu_torch.io.mhd import read_mhd_volume, volume_from_arrays
from lrr_tpu_torch.types import Volume, resolve_device

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}

# (group, element) tags we care about
_TAGS = {
    (0x0008, 0x0018): "sop_uid",
    (0x0020, 0x000E): "series_uid",
    (0x0020, 0x0013): "instance_number",
    (0x0020, 0x0032): "position",
    (0x0020, 0x0037): "orientation",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x0002, 0x0010): "transfer_syntax",
    (0x7FE0, 0x0010): "pixel_data",
}

_UNCOMPRESSED = {
    "1.2.840.10008.1.2",  # implicit VR LE
    "1.2.840.10008.1.2.1",  # explicit VR LE
}


@dataclass
class _Slice:
    path: str
    fields: dict = field(default_factory=dict)


def _parse_file(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 140 or data[128:132] != b"DICM":
        raise ValueError(f"{path}: not a Part-10 DICOM file")

    out: dict = {}
    pos = 132
    explicit = True  # file meta group is always explicit VR LE
    n = len(data)
    while pos + 8 <= n:
        group, element = struct.unpack_from("<HH", data, pos)
        pos += 4
        if explicit or group == 0x0002:
            vr = data[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                (length,) = struct.unpack_from("<I", data, pos + 4)
                pos += 8
            elif vr.isalpha() and vr.isupper():
                (length,) = struct.unpack_from("<H", data, pos + 2)
                pos += 4
            else:  # actually implicit VR after the meta group
                (length,) = struct.unpack_from("<I", data, pos)
                pos += 4
                vr = b""
        else:
            (length,) = struct.unpack_from("<I", data, pos)
            pos += 4
            vr = b""

        if group == 0x0002 and element == 0x0010:
            ts = data[pos : pos + length].decode("ascii", "ignore").strip("\x00 ")
            out["transfer_syntax"] = ts
            explicit = ts != "1.2.840.10008.1.2"
            pos += length
            continue
        key = _TAGS.get((group, element))
        if length == 0xFFFFFFFF:
            raise ValueError(
                f"{path}: undefined-length element (compressed or sequence "
                "pixel data) — only native little-endian DICOM is supported"
            )
        if key == "pixel_data":
            out["pixel_data"] = (pos, length)
            pos += length
            continue
        if key is not None:
            raw = data[pos : pos + length]
            out[key] = raw
        pos += length
    out["_bytes"] = data
    return out


def _ascii(v: bytes) -> str:
    return v.decode("ascii", "ignore").strip("\x00 ")


def _floats(v: bytes) -> list[float]:
    return [float(x) for x in _ascii(v).split("\\") if x]


def read_dicom_slice(path: str) -> tuple[np.ndarray, dict]:
    """One slice: (pixel array [rows, cols] float32 in HU, metadata dict)."""
    f = _parse_file(path)
    ts = f.get("transfer_syntax", "1.2.840.10008.1.2.1")
    if ts not in _UNCOMPRESSED:
        raise ValueError(f"{path}: unsupported transfer syntax {ts}")
    rows = struct.unpack("<H", f["rows"][:2])[0]
    cols = struct.unpack("<H", f["cols"][:2])[0]
    bits = struct.unpack("<H", f.get("bits_allocated", b"\x10\x00")[:2])[0]
    signed = struct.unpack("<H", f.get("pixel_representation", b"\x00\x00")[:2])[0]
    dtype = {8: np.uint8, 16: np.int16 if signed else np.uint16}.get(bits)
    if dtype is None:
        raise ValueError(f"{path}: unsupported BitsAllocated {bits}")
    off, length = f["pixel_data"]
    px = np.frombuffer(f["_bytes"], dtype=dtype, count=rows * cols, offset=off)
    px = px.reshape(rows, cols).astype(np.float32)
    slope = _floats(f["rescale_slope"])[0] if "rescale_slope" in f else 1.0
    inter = _floats(f["rescale_intercept"])[0] if "rescale_intercept" in f else 0.0
    px = px * slope + inter

    meta = {
        "position": _floats(f["position"]) if "position" in f else None,
        "orientation": _floats(f["orientation"]) if "orientation" in f else None,
        "pixel_spacing": _floats(f["pixel_spacing"])
        if "pixel_spacing" in f
        else [1.0, 1.0],
        "instance_number": int(_ascii(f["instance_number"]) or 0)
        if "instance_number" in f
        else 0,
        "slice_thickness": _floats(f["slice_thickness"])[0]
        if "slice_thickness" in f
        else None,
        "spacing_between": _floats(f["spacing_between"])[0]
        if "spacing_between" in f
        else None,
        "series_uid": _ascii(f["series_uid"]) if "series_uid" in f else "",
    }
    return px, meta


def read_dicom_series(directory: str, device=None) -> Volume:
    """Read all DICOM slices in `directory` into one Volume (z, y, x) on
    `device` (`None`: the CUDA card)."""
    device = resolve_device(device, "read_dicom_series")
    paths = sorted(
        os.path.join(directory, p)
        for p in os.listdir(directory)
        if not p.startswith(".")
    )
    slices = []
    for p in paths:
        if not os.path.isfile(p):
            continue
        try:
            px, meta = read_dicom_slice(p)
        except ValueError:
            continue  # non-DICOM file in the directory
        slices.append((px, meta))
    if not slices:
        raise ValueError(f"{directory}: no readable DICOM slices")

    # slice normal from orientation (row x col), default +z
    ori = slices[0][1]["orientation"]
    if ori and len(ori) == 6:
        r = np.asarray(ori[:3])
        c = np.asarray(ori[3:])
        normal = np.cross(r, c)
    else:
        normal = np.asarray([0.0, 0.0, 1.0])

    def sort_key(item):
        meta = item[1]
        if meta["position"] is not None:
            return float(np.dot(np.asarray(meta["position"]), normal))
        return float(meta["instance_number"])

    slices.sort(key=sort_key)
    vol = np.stack([s[0] for s in slices], axis=0)

    m0 = slices[0][1]
    sy, sx = (m0["pixel_spacing"] + [1.0, 1.0])[:2]
    if len(slices) > 1 and slices[0][1]["position"] and slices[1][1]["position"]:
        zs = [sort_key(s) for s in slices]
        dz = float(np.median(np.diff(zs)))
    else:
        dz = m0["spacing_between"] or m0["slice_thickness"] or 1.0
    origin = np.asarray(m0["position"] or [0.0, 0.0, 0.0], np.float32)

    return volume_from_arrays(vol, origin, [float(sx), float(sy), abs(dz)], device)


def _element(group: int, element: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr != b"UI" else b"\x00"
    if vr in _EXPLICIT_LONG_VRS:
        return struct.pack("<HH2sHI", group, element, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, element, vr, len(value)) + value


def write_dicom_series(directory: str, vol: Volume, series_uid: str = "1.2.3.4"):
    """Write a Volume as one explicit-VR-LE DICOM file per slice (CT-like,
    int16 pixels).  Enough for round-trips and for the crop utility to mirror
    CropDicom.cxx's DICOM-in/DICOM-out behavior."""
    os.makedirs(directory, exist_ok=True)
    data = vol.data.cpu().numpy()
    origin = vol.origin.cpu().numpy().astype(np.float64)
    sx, sy, sz = [float(s) for s in vol.spacing.cpu().numpy()]
    nz, ny, nx = data.shape
    px_all = np.clip(np.round(data), -32768, 32767).astype(np.int16)

    meta_ts = _element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    for z in range(nz):
        pos = [origin[0], origin[1], origin[2] + z * sz]
        body = b"".join(
            [
                _element(0x0008, 0x0018, b"UI", f"{series_uid}.{z+1}".encode()),
                _element(0x0020, 0x000E, b"UI", series_uid.encode()),
                _element(0x0020, 0x0013, b"IS", str(z + 1).encode()),
                _element(
                    0x0020, 0x0032, b"DS",
                    "\\".join(f"{v:.6f}" for v in pos).encode(),
                ),
                _element(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"),
                _element(0x0028, 0x0010, b"US", struct.pack("<H", ny)),
                _element(0x0028, 0x0011, b"US", struct.pack("<H", nx)),
                _element(
                    0x0028, 0x0030, b"DS", f"{sy:.6f}\\{sx:.6f}".encode()
                ),
                _element(0x0018, 0x0050, b"DS", f"{sz:.6f}".encode()),
                _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
                _element(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
                _element(0x0028, 0x1052, b"DS", b"0"),
                _element(0x0028, 0x1053, b"DS", b"1"),
                _element(0x7FE0, 0x0010, b"OW", px_all[z].tobytes()),
            ]
        )
        with open(os.path.join(directory, f"slice{z:04d}.dcm"), "wb") as f:
            f.write(b"\x00" * 128 + b"DICM" + meta_ts + body)


def read_volume_any(path: str, device=None) -> Volume:
    """MHD file or DICOM directory/file, auto-detected (the reference's
    dual mhd-or-GDCM ingest, ExtractFeatures.cxx:88-172), on `device`
    (`None`: the CUDA card)."""
    device = resolve_device(device, "read_volume_any")
    if os.path.isdir(path):
        return read_dicom_series(path, device)
    if path.lower().endswith((".mhd", ".mha")):
        return read_mhd_volume(path, device)
    px, meta = read_dicom_slice(path)
    sy, sx = (meta["pixel_spacing"] + [1.0, 1.0])[:2]
    return volume_from_arrays(
        px[None], meta["position"] or [0.0, 0.0, 0.0],
        [float(sx), float(sy), meta["slice_thickness"] or 1.0], device,
    )

"""VTK XML PolyData (.vtp/.vtk-XML) read/write (lrr_tpu/io/vtk_xml.py).

The reference exchanges every stage artifact as vtkXMLPolyData files —
features `*_00.vtk`, keypoints `*keypoints.vtk`, descriptors `*desc.vtk`,
transforms `transform*.vtk` (README.md:42-53, cdcl/cdcl_utils_VTK.h:55-63).
This is a dependency-free reader/writer for the point-cloud subset those
files use: Points + named PointData arrays, in ascii, inline-base64
("binary") or appended (base64 or raw) encodings, optionally
zlib-compressed, both endiannesses and 32/64-bit headers.
"""

from __future__ import annotations

import base64
import dataclasses
import struct
import zlib
from typing import Dict
from xml.etree import ElementTree as ET

import numpy as np

_VTK_TO_DTYPE = {
    "Int8": np.int8, "UInt8": np.uint8,
    "Int16": np.int16, "UInt16": np.uint16,
    "Int32": np.int32, "UInt32": np.uint32,
    "Int64": np.int64, "UInt64": np.uint64,
    "Float32": np.float32, "Float64": np.float64,
}
_DTYPE_TO_VTK = {np.dtype(v): k for k, v in _VTK_TO_DTYPE.items()}


@dataclasses.dataclass
class PolyData:
    points: np.ndarray  # [N, 3]
    point_data: Dict[str, np.ndarray]  # name -> [N] or [N, C]


def _b64(text: str) -> bytes:
    """Base64 decode through the native runtime when available (handles
    embedded whitespace without a Python-side join/split pass), falling back
    to the stdlib."""
    from lrr_tpu_torch.io.native_loader import b64_decode_native

    out = b64_decode_native(text.encode("ascii", "ignore"))
    if out is not None:
        return out.tobytes()
    return base64.b64decode("".join(text.split()))


def _decode_inline_b64(text: str, dtype, header_dtype, compressed: bool) -> np.ndarray:
    return _decode_raw(_b64(text), dtype, header_dtype, compressed)


def _decode_raw(raw: bytes, dtype, header_dtype, compressed: bool) -> np.ndarray:
    hsize = np.dtype(header_dtype).itemsize
    if not compressed:
        (nbytes,) = np.frombuffer(raw[:hsize], header_dtype)
        data = raw[hsize : hsize + int(nbytes)]
    else:
        nblocks = int(np.frombuffer(raw[:hsize], header_dtype)[0])
        header_len = hsize * (3 + nblocks)
        header = np.frombuffer(raw[:header_len], header_dtype)
        sizes = header[3 : 3 + nblocks].astype(np.int64)
        body = raw[header_len:]
        out = []
        off = 0
        for s in sizes:
            out.append(zlib.decompress(body[off : off + int(s)]))
            off += int(s)
        data = b"".join(out)
    return np.frombuffer(data, dtype)


def read_vtp(path: str) -> PolyData:
    tree = ET.parse(path)
    root = tree.getroot()
    byte_order = root.get("byte_order", "LittleEndian")
    header_type = root.get("header_type", "UInt32")
    header_dtype = np.dtype(_VTK_TO_DTYPE[header_type])
    compressor = root.get("compressor", "")
    compressed = "zlib" in compressor.lower()  # VTK spells it vtkZLibDataCompressor
    swap = (byte_order == "BigEndian")

    appended = None
    app_el = root.find("AppendedData")
    if app_el is not None:
        text = app_el.text or ""
        idx = text.find("_")
        appended_text = text[idx + 1 :] if idx >= 0 else text
        encoding = app_el.get("encoding", "base64")
        if encoding == "base64":
            appended = ("b64", appended_text)
        else:
            raise ValueError("raw appended data unsupported in text parse")

    def read_array(el) -> np.ndarray:
        dtype = np.dtype(_VTK_TO_DTYPE[el.get("type")])
        ncomp = int(el.get("NumberOfComponents", "1"))
        fmt = el.get("format", "ascii")
        if fmt == "ascii":
            arr = np.array((el.text or "").split(), dtype=np.float64).astype(dtype)
        elif fmt == "binary":
            arr = _decode_inline_b64(el.text or "", dtype, header_dtype, compressed)
        elif fmt == "appended":
            off = int(el.get("offset", "0"))
            kind, text = appended
            # each array's data starts at byte offset `off` of the decoded
            # appended stream; decode once and slice
            raw = _b64(text)
            arr = _decode_raw(raw[off:], dtype, header_dtype, compressed)
        else:
            raise ValueError(f"unknown format {fmt}")
        if swap:
            arr = arr.byteswap()
        if ncomp > 1:
            arr = arr.reshape(-1, ncomp)
        return arr

    piece = root.find(".//Piece")
    pts_el = piece.find("Points/DataArray")
    points = read_array(pts_el).reshape(-1, 3)

    point_data = {}
    pd = piece.find("PointData")
    if pd is not None:
        for el in pd.findall("DataArray"):
            point_data[el.get("Name")] = read_array(el)
    return PolyData(points=points, point_data=point_data)


def write_vtp(path: str, poly: PolyData, ascii_fmt: bool = False):
    n = poly.points.shape[0]

    def encode(arr: np.ndarray) -> str:
        raw = np.ascontiguousarray(arr).tobytes()
        header = struct.pack("<I", len(raw))
        return base64.b64encode(header + raw).decode()

    def array_xml(name, arr, indent):
        arr = np.asarray(arr)
        ncomp = arr.shape[1] if arr.ndim > 1 else 1
        vtype = _DTYPE_TO_VTK[arr.dtype]
        name_attr = f' Name="{name}"' if name else ""
        if ascii_fmt:
            flat = arr.reshape(-1)
            body = " ".join(
                f"{v:g}" if arr.dtype.kind == "f" else str(v) for v in flat
            )
            fmt = "ascii"
        else:
            body = encode(arr)
            fmt = "binary"
        return (
            f'{indent}<DataArray type="{vtype}"{name_attr} '
            f'NumberOfComponents="{ncomp}" format="{fmt}">\n'
            f"{indent}  {body}\n{indent}</DataArray>\n"
        )

    parts = [
        '<?xml version="1.0"?>\n',
        '<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian" '
        'header_type="UInt32">\n',
        "  <PolyData>\n",
        f'    <Piece NumberOfPoints="{n}" NumberOfVerts="0" NumberOfLines="0" '
        'NumberOfStrips="0" NumberOfPolys="0">\n',
        "      <PointData>\n",
    ]
    for name, arr in poly.point_data.items():
        parts.append(array_xml(name, arr, "        "))
    parts += [
        "      </PointData>\n",
        "      <Points>\n",
        array_xml(None, np.asarray(poly.points, np.float32), "        "),
        "      </Points>\n",
        "    </Piece>\n",
        "  </PolyData>\n",
        "</VTKFile>\n",
    ]
    with open(path, "w") as f:
        f.write("".join(parts))

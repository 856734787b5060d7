"""MetaImage (.mhd/.mha) volume IO (lrr_tpu/io/mhd.py).

The reference reads/writes volumes, Voronoi maps and watershed labels as
MetaImage via ITK (features/ExtractFeatures.cxx:88-172,
rrl/examples/compute_distance_map.cxx:178).  This is a dependency-free
implementation of the subset the pipeline uses: 3D volumes, common element
types, raw or zlib-compressed data, local or .raw-file storage.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

import torch

from lrr_tpu_torch.types import Volume, resolve_device

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


def read_mhd(path: str):
    """Returns (data [D,H,W] numpy, origin (x,y,z), spacing (x,y,z))."""
    header = {}
    data_start = None
    with open(path, "rb") as f:
        if path.endswith((".mha",)):
            # header terminated by ElementDataFile = LOCAL
            while True:
                line = f.readline()
                if not line:
                    break
                text = line.decode("latin1").strip()
                if "=" not in text:
                    continue
                k, v = (s.strip() for s in text.split("=", 1))
                header[k] = v
                if k == "ElementDataFile":
                    data_start = f.tell()
                    break
            raw = f.read() if data_start is not None else b""
        else:
            for text in f.read().decode("latin1").splitlines():
                if "=" not in text:
                    continue
                k, v = (s.strip() for s in text.split("=", 1))
                header[k] = v
            raw = None

    ndims = int(header.get("NDims", "3"))
    dims = [int(x) for x in header["DimSize"].split()]  # (x, y, z)
    dtype = np.dtype(_MET_TO_DTYPE[header.get("ElementType", "MET_SHORT")])
    spacing = np.asarray(
        [float(x) for x in header.get(
            "ElementSpacing", header.get("ElementSize", "1 1 1")
        ).split()],
        np.float32,
    )
    origin = np.asarray(
        [float(x) for x in header.get("Offset", header.get("Origin", "0 0 0")).split()],
        np.float32,
    )
    byte_order_msb = header.get("ElementByteOrderMSB", "False").lower() == "true" or (
        header.get("BinaryDataByteOrderMSB", "False").lower() == "true"
    )
    compressed = header.get("CompressedData", "False").lower() == "true"

    datafile = header.get("ElementDataFile", "LOCAL")
    if raw is None or datafile != "LOCAL":
        data_path = os.path.join(os.path.dirname(path), datafile)
        with open(data_path, "rb") as f:
            raw = f.read()

    if compressed:
        raw = zlib.decompress(raw)

    count = int(np.prod(dims))
    arr = np.frombuffer(raw, dtype=dtype, count=count)
    if byte_order_msb:
        arr = arr.byteswap()
    shape_zyx = tuple(reversed(dims))
    data = arr.reshape(shape_zyx)
    if ndims != 3:
        raise ValueError(f"only 3D supported, got NDims={ndims}")
    return data, origin, spacing


def volume_from_arrays(data, origin, spacing, device) -> Volume:
    """A float32 `Volume` on `device` from host arrays as `read_mhd` gives
    them."""
    data = np.ascontiguousarray(data, np.float32)
    if not data.flags.writeable:  # a view of the file's bytes
        data = data.copy()
    return Volume(
        data=torch.from_numpy(data).to(device),
        origin=torch.from_numpy(np.asarray(origin, np.float32)).to(device),
        spacing=torch.from_numpy(np.asarray(spacing, np.float32)).to(device),
    )


def read_mhd_volume(path: str, device=None) -> Volume:
    """The volume on `device`; `None` means the CUDA card
    (`types.resolve_device`)."""
    device = resolve_device(device, "read_mhd_volume")
    return volume_from_arrays(*read_mhd(path), device)


def write_mhd(
    path: str,
    data: np.ndarray,  # [D, H, W]
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    compressed: bool = False,
):
    """Writes .mha (local data) or .mhd + .raw pair depending on suffix."""
    data = np.ascontiguousarray(data)
    met = _DTYPE_TO_MET[data.dtype]
    dims = list(reversed(data.shape))  # (x, y, z)
    payload = data.tobytes()
    if compressed:
        payload = zlib.compress(payload)

    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(payload)}")
    lines += [
        "TransformMatrix = 1 0 0 0 1 0 0 0 1",
        f"Offset = {origin[0]:g} {origin[1]:g} {origin[2]:g}",
        "CenterOfRotation = 0 0 0",
        f"ElementSpacing = {spacing[0]:g} {spacing[1]:g} {spacing[2]:g}",
        f"DimSize = {dims[0]} {dims[1]} {dims[2]}",
        f"ElementType = {met}",
    ]
    if path.endswith(".mha"):
        lines.append("ElementDataFile = LOCAL")
        with open(path, "wb") as f:
            f.write(("\n".join(lines) + "\n").encode())
            f.write(payload)
    else:
        rawname = os.path.basename(path)[:-4] + (".zraw" if compressed else ".raw")
        lines.append(f"ElementDataFile = {rawname}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(os.path.dirname(path), rawname), "wb") as f:
            f.write(payload)

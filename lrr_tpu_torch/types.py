"""Core data model: padded struct-of-arrays sets as dataclasses of tensors.

Counterpart of lrr_tpu/types.py.  Every set has a fixed (padded) leading
dimension and a validity mask; the fields and their order are the JAX
package's, so saved artifacts load field for field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Feature shape classes (cdcl/cdcl_feature_with_shape.h:30).
CORNER = 0
TUBE = 1
SHEET = 2

DESCRIPTOR_DIM = 195


def resolve_device(device, who: str) -> torch.device:
    """The device an entry point creates its data on.  `None` means the CUDA
    card: it raises where there is none and never carries on on the CPU by
    itself (a caller that wants the CPU, as the tests do, says "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; lrr_tpu_torch runs on the GPU unless the "
                'caller asks for the CPU (pass device="cpu")'
            )
        device = "cuda"
    return torch.device(device)


def no_tf32() -> None:
    """H3: nothing on the port's paths may run in TF32 (a matmul or a
    convolution would round its operands to 10 bits of mantissa)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _to(obj, device):
    return type(obj)(
        **{f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)}
    )


def pad_rows(obj, pad: int):
    """A set with `pad` zero (masked-out) rows appended to every field."""
    if pad == 0:
        return obj
    return type(obj)(
        **{
            f.name: torch.cat(
                [getattr(obj, f.name),
                 getattr(obj, f.name).new_zeros((pad,) + getattr(obj, f.name).shape[1:])]
            )
            for f in dataclasses.fields(obj)
        }
    )


@dataclasses.dataclass
class FeatureSet:
    """xyz [N, 3] mm, strength [N], shape [N] int32, projector [N, 3, 3]
    (e^T P e residual metric), directions [N, 3, 3] (row 0 = sheet normal /
    tube tangent), mask [N] bool."""

    xyz: torch.Tensor
    strength: torch.Tensor
    shape: torch.Tensor
    projector: torch.Tensor
    directions: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def take(self, idx: torch.Tensor, valid: torch.Tensor | None = None) -> "FeatureSet":
        """Gather rows by index; optionally AND the mask with `valid`."""
        mask = self.mask[idx]
        if valid is not None:
            mask = mask & valid
        return FeatureSet(
            xyz=self.xyz[idx], strength=self.strength[idx], shape=self.shape[idx],
            projector=self.projector[idx], directions=self.directions[idx], mask=mask,
        )

    def to(self, device) -> "FeatureSet":
        return _to(self, device)


@dataclasses.dataclass
class KeypointSet:
    """xyz [K, 3], strength [K], normal [K, 3], binormal [K, 3], mask [K]."""

    xyz: torch.Tensor
    strength: torch.Tensor
    normal: torch.Tensor
    binormal: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def to(self, device) -> "KeypointSet":
        return _to(self, device)


@dataclasses.dataclass
class DescriptorSet:
    """Keypoints plus their 195-d shape-context descriptors [K, 195]."""

    keypoints: KeypointSet
    descriptors: torch.Tensor

    def to(self, device) -> "DescriptorSet":
        return DescriptorSet(self.keypoints.to(device), self.descriptors.to(device))


@dataclasses.dataclass
class Volume:
    """A 3D scalar volume with physical geometry: data [D, H, W] indexed
    [z, y, x]; origin and spacing [3] are (x, y, z) in mm."""

    data: torch.Tensor
    origin: torch.Tensor
    spacing: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "Volume":
        return _to(self, device)


def concat_feature_sets(a: FeatureSet, b: FeatureSet) -> FeatureSet:
    return FeatureSet(
        **{
            f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)], dim=0)
            for f in dataclasses.fields(a)
        }
    )


@dataclasses.dataclass
class MatchSet:
    """Fixed-shape correspondences of one estimation direction
    (cdcl/cdcl_match.h:18): moving point i (from_xyz [M, 3], untransformed)
    matches to_xyz [M, 3], with the fixed feature's projector [M, 3, 3], a
    robust weight [M] and a validity mask [M]."""

    from_xyz: torch.Tensor
    to_xyz: torch.Tensor
    projector: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor

    def to(self, device) -> "MatchSet":
        return _to(self, device)


def pad_to(x: np.ndarray, n: int, axis: int = 0, fill=0) -> np.ndarray:
    """numpy-side helper: pad an array to length n along `axis`."""
    pad = n - x.shape[axis]
    if pad < 0:
        raise ValueError(f"cannot pad {x.shape[axis]} down to {n}")
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def feature_set_from_numpy(
    xyz: np.ndarray,
    strength: np.ndarray,
    shape: np.ndarray,
    projector: np.ndarray,
    directions: np.ndarray,
    capacity: int | None = None,
    dtype=np.float32,
    device=None,
) -> FeatureSet:
    """A padded FeatureSet on `device` (default: the CUDA card) from host
    arrays of true length n."""
    device = resolve_device(device, "feature_set_from_numpy")
    n = xyz.shape[0]
    cap = capacity if capacity is not None else n
    mask = np.zeros((cap,), bool)
    mask[:n] = True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FeatureSet(
        xyz=dev(pad_to(xyz.astype(dtype), cap)),
        strength=dev(pad_to(strength.astype(dtype), cap)),
        shape=dev(pad_to(shape.astype(np.int32), cap)),
        projector=dev(pad_to(projector.astype(dtype), cap)),
        directions=dev(pad_to(directions.astype(dtype), cap)),
        mask=dev(mask),
    )

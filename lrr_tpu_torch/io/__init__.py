from lrr_tpu_torch.io.mhd import read_mhd, read_mhd_volume, write_mhd
from lrr_tpu_torch.io.vtk_xml import PolyData, read_vtp, write_vtp
from lrr_tpu_torch.io.features_io import (
    read_descriptors,
    read_features,
    read_keypoints,
    write_descriptors,
    write_features,
    write_keypoints,
)

__all__ = [
    "read_mhd", "read_mhd_volume", "write_mhd", "PolyData", "read_vtp", "write_vtp",
    "read_features", "write_features", "read_keypoints", "write_keypoints",
    "read_descriptors", "write_descriptors",
]

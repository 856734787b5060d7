from lrr_tpu_torch.viz.panels import (
    checkerboard,
    checkerboard_panels,
    overlay_covariance_ellipses,
    overlay_features,
    save_png,
    slice_panel,
)

__all__ = [
    "save_png", "slice_panel", "checkerboard", "checkerboard_panels",
    "overlay_covariance_ellipses", "overlay_features",
]

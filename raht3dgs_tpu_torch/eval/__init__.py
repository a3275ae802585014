"""Quality evaluation: metrics of reconstructed attributes (``metrics``),
random evaluation cameras (``cameras``), the volumetric 3DGS rasterizer
(``rasterize``) and the render comparison (``render``)."""

from raht3dgs_tpu_torch.eval.metrics import (  # noqa: F401
    compute_attribute_metrics,
    gs_group_psnr,
    image_psnr,
)
from raht3dgs_tpu_torch.eval.cameras import generate_random_cameras  # noqa: F401

__all__ = [
    "compute_attribute_metrics",
    "gs_group_psnr",
    "image_psnr",
    "generate_random_cameras",
]

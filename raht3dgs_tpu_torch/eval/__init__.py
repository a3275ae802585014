"""Quality metrics of reconstructed attributes (rendering comes with
ROADMAP queue A, item 16)."""

from raht3dgs_tpu_torch.eval.metrics import (  # noqa: F401
    compute_attribute_metrics,
    gs_group_psnr,
    image_psnr,
)

__all__ = ["compute_attribute_metrics", "gs_group_psnr", "image_psnr"]

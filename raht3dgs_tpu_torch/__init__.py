"""raht3dgs_tpu_torch — the RAHT attribute codec in PyTorch, with its TPU
kernels written by hand for NVIDIA Hopper.

The port of ``raht3dgs_tpu`` (the JAX package, which stays the reference).
It imports neither JAX nor anything of ``raht3dgs_tpu``; it keeps the old
package's layout (``ops/``, ``codec/``, ``models/``, ``utils/``) so every
module has a counterpart at the same relative path. Entry points run on
CUDA unless the caller passes ``device="cpu"``. Float64 and int64 need no
switch. Morton codes are int32 (J <= 10) or int64 (J <= 20).
"""

__version__ = "0.1.0"

from raht3dgs_tpu_torch.models.pipeline import (  # noqa: E402
    AttributeCodec,
    VoxelFrame,
    prepare_voxel_frame,
    voxel_frame_from_arrays,
)
from raht3dgs_tpu_torch.ops.color import rgb_to_yuv, yuv_to_rgb  # noqa: E402
from raht3dgs_tpu_torch.ops.morton import morton_decode, morton_encode  # noqa: E402
from raht3dgs_tpu_torch.ops.raht_span import (  # noqa: E402
    raht_forward_span,
    raht_inverse_span,
    raht_structure_span,
)
from raht3dgs_tpu_torch.utils.device import resolve_device  # noqa: E402

__all__ = [
    "AttributeCodec",
    "VoxelFrame",
    "prepare_voxel_frame",
    "voxel_frame_from_arrays",
    "rgb_to_yuv",
    "yuv_to_rgb",
    "morton_encode",
    "morton_decode",
    "raht_forward_span",
    "raht_inverse_span",
    "raht_structure_span",
    "resolve_device",
    "__version__",
]

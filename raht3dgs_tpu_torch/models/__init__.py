"""The attribute codec pipeline."""

from raht3dgs_tpu_torch.models.pipeline import (  # noqa: F401
    AttributeCodec,
    EncodedFrame,
    VoxelFrame,
    prepare_voxel_frame,
    voxel_frame_from_arrays,
)

"""Batched frames on one device or over a (dp, sp, tp) device mesh, and
views rendered over a mesh axis."""

from raht3dgs_tpu_torch.parallel.sharding import (  # noqa: F401
    batched_roundtrip_step,
    batched_transform_step,
    batched_transform_step_tp,
    make_mesh,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "batched_transform_step",
    "batched_transform_step_tp",
    "batched_roundtrip_step",
]

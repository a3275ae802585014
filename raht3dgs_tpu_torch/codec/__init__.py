"""Host entropy coding (RLGR, RAC), lossless geometry and the R3TC frame
container."""
from raht3dgs_tpu_torch.codec.geometry import (
    decode_geometry,
    decode_geometry_lod,
    encode_geometry,
    geometry_from_positions,
    positions_from_geometry,
    positions_from_geometry_lod,
)
from raht3dgs_tpu_torch.codec.rlgr import rlgr_decode, rlgr_encode

__all__ = [
    "rlgr_decode", "rlgr_encode",
    "encode_geometry", "decode_geometry", "decode_geometry_lod",
    "geometry_from_positions", "positions_from_geometry",
    "positions_from_geometry_lod",
]

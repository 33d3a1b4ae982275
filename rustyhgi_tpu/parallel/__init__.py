"""SPMD tier: device meshes, sharded batch/tile codecs, multi-host drive.

The reference is single-threaded scalar code with no parallel tier
(SURVEY.md §2); everything here is designed for device meshes from scratch.
"""

from .mesh import DATA_AXIS, TILE_AXIS, make_mesh
from .multihost import (
    MultiHostConfig,
    TiledEncodeResult,
    decode_tiled_multihost,
    encode_tiled_multihost,
    write_thgit_multihost,
)
from .sharded import (
    decode_batch_sharded,
    encode_batch_sharded,
    pad_batch,
    sharded_histogram,
    tile_plane,
    untile_plane,
)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "make_mesh",
    "encode_batch_sharded",
    "decode_batch_sharded",
    "sharded_histogram",
    "tile_plane",
    "untile_plane",
    "pad_batch",
    "MultiHostConfig",
    "TiledEncodeResult",
    "encode_tiled_multihost",
    "decode_tiled_multihost",
    "write_thgit_multihost",
]

from .mesh import BLOCK_AXIS, DATA_AXIS, make_mesh
from .decode import (
    decode_stream_sharded,
    decode_transform_sharded,
    shard_inputs,
)
from .encode import quantize_window_sharded
from .temporal import sharded_segmented_scan

__all__ = [
    "BLOCK_AXIS",
    "DATA_AXIS",
    "make_mesh",
    "decode_stream_sharded",
    "quantize_window_sharded",
    "decode_transform_sharded",
    "shard_inputs",
    "sharded_segmented_scan",
]

"""Sharded device decode: the multi-chip transform step.

Composes the mesh axes (parallel/mesh.py) with the decode transform:

  * "data" shards the frame axis.  With GOP-aligned shards the temporal scan
    is shard-local (GOPs are independent, SURVEY.md §5.7); with arbitrary
    frame sharding the cross-device carry is one all-gather
    (parallel/temporal.py).
  * "block" shards the block axis of every (F, B, 64) tensor.  The transform
    is elementwise over blocks, so this needs no collectives at all — the
    analog of the reference accelerator consuming an arbitrary sub-stream of
    blocks (idct_ycbcr_to_rgb_accel.c:28-37).

The returned frames stay sharded (data axis over frames, block axis over
raster rows); callers gather only what they consume.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import transform_jax
from .mesh import BLOCK_AXIS, DATA_AXIS
from .temporal import _local_scan, _sharded_scan_body


@functools.partial(
    jax.jit, static_argnames=("mesh", "blocks_h", "blocks_w", "gop_aligned"),
)
def decode_transform_sharded(
    amps_y: jnp.ndarray,
    amps_cb: jnp.ndarray,
    amps_cr: jnp.ndarray,
    is_iframe: jnp.ndarray,
    *,
    mesh: Mesh,
    blocks_h: int,
    blocks_w: int,
    gop_aligned: bool = False,
) -> jnp.ndarray:
    """Sharded decode: (F, B, 64) int16 amplitudes x3 -> (F, H, W) uint32.

    Frames shard over "data", blocks over "block".  F must divide by the
    data-axis size and B by the block-axis size.  gop_aligned=True asserts
    every data-shard starts with an I-frame (skips the carry exchange);
    callers that shard by GOP boundaries should pass it for zero collectives.

    The block->raster reassembly needs whole block-rows per device, so inside
    each shard the frame is built from the local block range; the output
    raster is sharded (F over "data", rows over "block") — valid because the
    block axis is row-major (blocks_w divides evenly into the block shards
    when B % n_block == 0 and (B/n_block) % blocks_w == 0; otherwise the
    caller uses block-sharding only for the coefficient stages).
    """
    n_data = mesh.shape[DATA_AXIS]
    n_block = mesh.shape[BLOCK_AXIS]
    local_rows = blocks_h // n_block
    if blocks_h % n_block:
        raise ValueError(
            f"blocks_h {blocks_h} must divide by block-axis size {n_block}"
        )
    yq, cq = transform_jax.quant_tensors()

    def body(ay, acb, acr, seg):
        states = []
        for amps, q in ((ay, yq), (acb, cq), (acr, cq)):
            deltas = transform_jax.dequantize(amps, q)
            if gop_aligned or n_data == 1:
                vals, _ = _local_scan(deltas, seg)
            else:
                vals = _sharded_scan_body(deltas, seg, n_data)
            states.append(vals)
        return transform_jax.decode_transform_states(
            *states, blocks_h=local_rows, blocks_w=blocks_w
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, BLOCK_AXIS, None),
            P(DATA_AXIS, BLOCK_AXIS, None),
            P(DATA_AXIS, BLOCK_AXIS, None),
            P(DATA_AXIS),
        ),
        out_specs=P(DATA_AXIS, BLOCK_AXIS, None),
    )
    return fn(amps_y, amps_cb, amps_cr, is_iframe)


def decode_stream_sharded(
    data: bytes,
    mesh: Mesh,
    *,
    gop_aligned: bool | None = None,
) -> "jnp.ndarray":
    """Whole-container sharded decode: bytes -> (F, H, W) uint32 frames.

    Host-parses every frame (native batch decoder) and runs the mesh decode
    (frames over "data", blocks over "block").  Partitioning is GOP-aligned
    by default whenever the stream has at least one GOP per data shard:
    each shard's frame range starts at an I-frame (multihost.partition_gops,
    balanced by frame count, padded with zero-delta frames to the widest
    shard), so the temporal scan is shard-local and the decode step runs
    with zero collectives — the whole-pipeline analog of the
    reference's architecture (playback.c:80-134).  gop_aligned=False forces
    equal frame splits with the cross-device carry all-gather instead.

    The GOP-aligned data-axis case (the production configuration) is a
    thin wrapper over the mesh STREAMING pipeline
    (``DecodePipeline(mesh=...).decode_array``): windows parse per
    partition on demand with bounded inflight, so peak host RSS is
    O(windows), not O(stream) — one code path owns multi-chip batch
    decode.  Only the research configurations that structurally need the
    whole frame axis at once stay whole-stream here: block-axis sharding
    (amplitudes shard over blocks, every frame participates in one
    dispatch) and non-GOP-aligned splits (the cross-device carry
    all-gather runs over the full segmented scan).
    """
    import numpy as np

    from ..core.format import index_frames
    from .multihost import partition_gops
    from ..runtime.pipeline import DecodePipeline

    n_data = mesh.shape[DATA_AXIS]
    index = index_frames(data)
    nf = index.header.num_frames
    gop_starts = index.gop_starts()
    if gop_aligned is None:
        gop_aligned = len(gop_starts) >= n_data > 1
    blocks_h = index.header.blocks_h
    blocks_w = index.header.blocks_w

    block_sharded = (
        BLOCK_AXIS in mesh.axis_names and mesh.shape[BLOCK_AXIS] > 1
    )
    if gop_aligned and not block_sharded:
        pipe = DecodePipeline(mesh=mesh)
        return jnp.asarray(pipe.decode_array(data))

    pipe = DecodePipeline()

    def parse_range(lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.zeros(
                (3, 0, index.header.blocks_per_plane, 64), np.int16
            )
        return pipe.parse_window(data, index, lo, hi - lo)

    if not gop_aligned:
        amps = parse_range(0, nf)
        pad = (-nf) % n_data
        if pad:
            amps = np.concatenate(
                [amps, np.zeros((3, pad) + amps.shape[2:], np.int16)], axis=1
            )
        seg = np.zeros(amps.shape[1], dtype=bool)
        seg[:nf] = index.is_iframe
        args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
        frames = decode_transform_sharded(
            *args, mesh=mesh, blocks_h=blocks_h, blocks_w=blocks_w,
            gop_aligned=False,
        )
        return frames[:nf]

    # GOP-aligned: shard d decodes frames [part.frame_lo, part.frame_hi),
    # padded to the widest shard with zero-delta frames (seg False: they
    # repeat the last real frame and are dropped on output).
    parts = partition_gops(gop_starts, nf, n_data)
    fmax = max(p.num_frames for p in parts)
    nb = index.header.blocks_per_plane
    seg = np.zeros(n_data * fmax, dtype=bool)
    amps = np.zeros((3, n_data * fmax, nb, 64), dtype=np.int16)
    for p in parts:
        lo, hi = p.host * fmax, p.host * fmax + p.num_frames
        seg[lo:hi] = index.is_iframe[p.frame_lo:p.frame_hi]
        amps[:, lo:hi] = parse_range(p.frame_lo, p.frame_hi)
    args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
    padded = decode_transform_sharded(
        *args, mesh=mesh, blocks_h=blocks_h, blocks_w=blocks_w,
        gop_aligned=True,
    )
    h, w = blocks_h * 8, blocks_w * 8
    out = np.empty((nf, h, w), dtype=np.uint32)
    host = np.asarray(padded)
    for p in parts:
        out[p.frame_lo:p.frame_hi] = host[
            p.host * fmax:p.host * fmax + p.num_frames
        ]
    return jnp.asarray(out)


def shard_inputs(
    mesh: Mesh,
    amps_y, amps_cb, amps_cr, is_iframe,
):
    """Place host arrays with the decode sharding (device_put, the mSGDMA
    feed analog — SURVEY.md §5.8)."""
    fb = NamedSharding(mesh, P(DATA_AXIS, BLOCK_AXIS, None))
    fo = NamedSharding(mesh, P(DATA_AXIS))
    return (
        jax.device_put(amps_y, fb),
        jax.device_put(amps_cb, fb),
        jax.device_put(amps_cr, fb),
        jax.device_put(is_iframe, fo),
    )

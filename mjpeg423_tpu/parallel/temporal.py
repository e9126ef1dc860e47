"""Cross-device temporal parallelism: the frame axis sharded mid-GOP.

The P-frame recurrence S_t = S_{t-1} + D_t (int16, segments reset at
I-frames; reference: lossless_decode.c:76-128) is a segmented prefix sum.
When the frame axis is sharded over the "data" mesh axis *without* GOP
alignment, each device computes its local segmented scan and the cross-shard
carry is resolved with one all-gather of per-shard summaries —
the build's sequence-parallelism analog (SURVEY.md §5.7: the recurrence is
linear, so the carry is an exact int16 segment-combine, no drift).

Cost: the all-gather moves one (B, 64) int16 state per device — a single
frame-plane of coefficients (~600 KB at 1080p), negligible next to the
decode payload.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.transform_jax import segmented_scan_flags as _local_scan
from .mesh import DATA_AXIS


def _sharded_scan_body(deltas: jnp.ndarray, seg: jnp.ndarray, n_shards: int):
    """shard_map body: local scan + exclusive cross-shard carry combine."""
    vals, seen = _local_scan(deltas, seg)
    last_val = vals[-1]
    last_seen = seen[-1]
    # One all-gather of per-shard summaries (the mailbox/pointer-passing
    # analog of §5.8, made functional).
    all_vals = jax.lax.all_gather(last_val, DATA_AXIS)    # (D, ...)
    all_seen = jax.lax.all_gather(last_seen, DATA_AXIS)   # (D, ...)
    idx = jax.lax.axis_index(DATA_AXIS)

    # Exclusive prefix combine over shards 0..idx-1.  Identity = (0, False).
    carry_val = jnp.zeros_like(last_val)
    carry_seen = jnp.zeros_like(last_seen, dtype=bool)
    for j in range(n_shards):
        take = j < idx
        v = jnp.where(take, all_vals[j], jnp.zeros_like(last_val))
        s = jnp.where(take, all_seen[j], False)
        carry_val = jnp.where(s, v, (carry_val + v).astype(jnp.int16))
        carry_seen = carry_seen | s

    # Frames before the first local I-frame inherit the carry.
    adjusted = jnp.where(seen, vals, (carry_val[None] + vals).astype(jnp.int16))
    return adjusted


def sharded_segmented_scan(
    deltas: jnp.ndarray,
    is_iframe: jnp.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Segmented scan with the frame axis sharded over mesh axis "data".

    deltas: (F, B, 64) int16 per-frame dequantized deltas; is_iframe: (F,)
    bool.  F must divide evenly by the data-axis size.  Exact (wrapping int16)
    match of transform_jax.segmented_scan.
    """
    n_shards = mesh.shape[DATA_AXIS]
    body = functools.partial(_sharded_scan_body, n_shards=n_shards)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )
    return fn(deltas, is_iframe)

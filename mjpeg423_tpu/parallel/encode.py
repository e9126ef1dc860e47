"""Sharded device encode: the encoder's device step over a device mesh.

The device step (FDCT + quantize, ops/encode_jax.quantize_window; reference:
encoder/fdct.c + quantize.c) emits ABSOLUTE quantized planes and has no
temporal recurrence — the host packer forms the I-DC chain and the P
differences (quantize.c:18-42) — so frames shard over the "data" axis with
no collective at all.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.encode_jax import quantize_window
from .mesh import DATA_AXIS


@functools.partial(jax.jit, static_argnames=("mesh",))
def quantize_window_sharded(samples: jnp.ndarray, *, mesh: Mesh) -> jnp.ndarray:
    """Mesh-sharded quantize_window: frames over "data", zero collectives.

    samples: (3, F, B, 64) uint8 blocked planes, F divisible by the
    data-axis size.  Returns (3, F, B, 64) int16 ABSOLUTE quantized
    amplitudes.
    """
    spec = P(None, DATA_AXIS)
    fn = jax.shard_map(
        quantize_window, mesh=mesh, in_specs=(spec,), out_specs=spec,
    )
    return fn(samples)

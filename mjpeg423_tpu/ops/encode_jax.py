"""JAX device encode step: FDCT + exact quantize.

The device half of the encoder (the host half is color conversion — kept in
NumPy float64 for bit-exactness with C doubles, rgb_to_ycbcr.c:58-70 — and
the serial entropy pack).  Everything here is exact integer arithmetic:

  * LL&M forward DCT: int32 adds/mults/shifts with int16 stores between
    passes (reference: encoder/fdct.c:17-161) — same modular semantics as
    the reference, batched over (F, B).
  * Quantization: round-half-away-from-zero division computed exactly in
    integers: sign(c) * ((2|c| + q) // (2q)).  This equals C's
    round((double)c / q) for all int16 c and the table's q <= 121, because
    the true quotient is never within a double ulp of a half-integer unless
    it IS one (denominators are tiny), so both round identically
    (reference: quantize.c:16).
  * The I-frame DC differential along blocks and the P differential along
    frames are applied by the host packer from these absolute planes — the
    encoder has NO temporal recurrence (the reference's prev/next buffer
    dance, mjpeg423_encoder.c:154-185, keeps plain per-frame quantized
    states), so the whole device step is frame-parallel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import tables as T
from .transform_jax import quant_tensors

_I32 = jnp.int32


def _descale(x, n: int):
    return jax.lax.shift_right_arithmetic(x + _I32(1 << (n - 1)), _I32(n))


def _fdct_butterfly(x: list, pass1: bool) -> list:
    """LL&M forward butterfly over 8 int32 tensors (fdct.c:33-160)."""
    tmp0 = x[0] + x[7]
    tmp7 = x[0] - x[7]
    tmp1 = x[1] + x[6]
    tmp6 = x[1] - x[6]
    tmp2 = x[2] + x[5]
    tmp5 = x[2] - x[5]
    tmp3 = x[3] + x[4]
    tmp4 = x[3] - x[4]

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    if pass1:
        out0 = jax.lax.shift_left(tmp10 + tmp11, _I32(T.PASS1_BITS))
        out4 = jax.lax.shift_left(tmp10 - tmp11, _I32(T.PASS1_BITS))
        n = T.CONST_BITS - T.PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, T.PASS1_BITS + 3)
        out4 = _descale(tmp10 - tmp11, T.PASS1_BITS + 3)
        n = T.CONST_BITS + T.PASS1_BITS + 3

    z1 = (tmp12 + tmp13) * _I32(T.FIX_0_541196100)
    out2 = _descale(z1 + tmp13 * _I32(T.FIX_0_765366865), n)
    out6 = _descale(z1 + tmp12 * _I32(-T.FIX_1_847759065), n)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _I32(T.FIX_1_175875602)

    tmp4 = tmp4 * _I32(T.FIX_0_298631336)
    tmp5 = tmp5 * _I32(T.FIX_2_053119869)
    tmp6 = tmp6 * _I32(T.FIX_3_072711026)
    tmp7 = tmp7 * _I32(T.FIX_1_501321110)
    z1 = z1 * _I32(-T.FIX_0_899976223)
    z2 = z2 * _I32(-T.FIX_2_562915447)
    z3 = z3 * _I32(-T.FIX_1_961570560) + z5
    z4 = z4 * _I32(-T.FIX_0_390180644) + z5

    out7 = _descale(tmp4 + z1 + z3, n)
    out5 = _descale(tmp5 + z2 + z4, n)
    out3 = _descale(tmp6 + z2 + z3, n)
    out1 = _descale(tmp7 + z1 + z4, n)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def fdct_blocks(samples: jnp.ndarray) -> jnp.ndarray:
    """(..., 8, 8) uint8 samples -> (..., 8, 8) int16 coefficients (x8 scale).

    Pass-1 outputs truncate to int16 between passes exactly as the reference
    stores them into DCTELEM arrays (fdct.c:52-87).
    """
    x = samples.astype(_I32)
    # Pass 1 over rows: input index = column position within each row.
    p1 = _fdct_butterfly([x[..., :, c] for c in range(8)], pass1=True)
    p1 = [v.astype(jnp.int16).astype(_I32) for v in p1]  # DCTELEM stores
    w = jnp.stack(p1, axis=-1)  # (..., 8[row], 8[col])
    # Pass 2 over columns: input index = row position within each column.
    p2 = _fdct_butterfly([w[..., r, :] for r in range(8)], pass1=False)
    return jnp.stack(p2, axis=-2).astype(jnp.int16)  # (..., 8[row], 8[col])


def quantize(coeffs: jnp.ndarray, quant64: jnp.ndarray) -> jnp.ndarray:
    """Exact round-half-away-from-zero quantize: (..., 64) int16 -> int16."""
    c = coeffs.astype(_I32)
    q = quant64.astype(_I32)
    mag = (2 * jnp.abs(c) + q) // (2 * q)
    return (jnp.sign(c) * mag).astype(jnp.int16)


@jax.jit
def quantize_window(samples: jnp.ndarray) -> jnp.ndarray:
    """Device encode step: FDCT + exact quantize of a frame window.

    samples: (3, W, B, 64) uint8 blocked Y/Cb/Cr sample planes (each 8x8
    block flattened row-major).  Returns (3, W, B, 64) int16 ABSOLUTE
    quantized amplitudes — the encoder's round(coef/quant) state.  No I-DC
    chain and no P differencing: the host packer (encoder.FramePacker)
    applies both inline, so every frame and block is independent here.
    """
    yq, cq = quant_tensors()
    blocks = samples.reshape(samples.shape[:-1] + (8, 8))
    return jnp.stack([
        quantize(fdct_blocks(blocks[p]).reshape(samples.shape[1:]), q)
        for p, q in ((0, yq), (1, cq), (2, cq))
    ])

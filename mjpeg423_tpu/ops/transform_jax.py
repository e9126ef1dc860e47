"""JAX device transform: dequant -> temporal scan -> IDCT -> color, bit-exact.

This is the jit-compiled XLA device step of the decoder: the one device path
on every backend.  All arithmetic is exact modular integer math mirroring the
C semantics — see ops/transform_ref.py for the stage-by-stage reference
citations.

Design notes:
  * Everything is batched over the block axis: (F, B, 64) coefficient tensors,
    elementwise int32 ops that XLA fuses; there is no per-block Python.
  * The P-frame recurrence S_t = S_{t-1} + D_t (int16, wrapping) is a
    *segmented prefix sum* over the frame axis, with segments reset at
    I-frames (reference: lossless_decode.c:76-128 — I zeroes state, P
    accumulates).  Implemented with jax.lax.associative_scan, exact in int16.
  * No data-dependent control flow: frame types enter as a mask tensor.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import tables as T

_I32 = jnp.int32


def quant_tensors() -> tuple[jnp.ndarray, jnp.ndarray]:
    yq = jnp.asarray(T.YQUANT64, dtype=jnp.int16)
    cq = jnp.asarray(T.CQUANT64, dtype=jnp.int16)
    return yq, cq


def dequantize(amps: jnp.ndarray, quant64: jnp.ndarray) -> jnp.ndarray:
    """amps (..., 64) int16 * quant (64,) int16 -> per-frame coefficient deltas.

    int16 modular multiply (reference: lossless_decode.c:91,95,122,125).
    """
    return (amps.astype(jnp.int16) * quant64.astype(jnp.int16)).astype(jnp.int16)


def segmented_scan_flags(
    deltas: jnp.ndarray, is_iframe: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Segmented int16 prefix sum, also returning the seen-I flags.

    deltas: (F, ...) int16 per-frame dequantized deltas (an I-frame's delta IS
    its full state).  is_iframe: (F,) bool.  Returns (vals, seen), both
    (F, ...): vals the int16 states, seen[f] = any(is_iframe[:f+1]) — whether
    frame f's state is already absolute (frames before the first I-frame
    still need the previous window's carry added).

    The combine op ((v1,s1),(v2,s2)) -> (s2 ? v2 : v1+v2, s1|s2) is
    associative, so this parallelizes the sequential recurrence exactly
    (int16 addition is associative under wraparound).
    """
    f = deltas.shape[0]
    seg = is_iframe.reshape((f,) + (1,) * (deltas.ndim - 1))
    seg = jnp.broadcast_to(seg, deltas.shape)

    def combine(a, b):
        av, aseg = a
        bv, bseg = b
        return jnp.where(bseg, bv, (av + bv).astype(jnp.int16)), aseg | bseg

    return jax.lax.associative_scan(combine, (deltas, seg), axis=0)


def segmented_scan(deltas: jnp.ndarray, is_iframe: jnp.ndarray) -> jnp.ndarray:
    """Per-frame coefficient states (segmented_scan_flags without flags)."""
    vals, _ = segmented_scan_flags(deltas, is_iframe)
    return vals


def _descale(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """(x + 2^(n-1)) >> n, arithmetic shift on int32 (dct_math.h:48)."""
    return jax.lax.shift_right_arithmetic(x + _I32(1 << (n - 1)), _I32(n))


def _idct_butterfly(x: list[jnp.ndarray], pass1: bool) -> list[jnp.ndarray]:
    """One islow butterfly over 8 int32 tensors (reference: idct.c:41-180)."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _I32(T.FIX_0_541196100)
    tmp2 = z1 + z3 * _I32(-T.FIX_1_847759065)
    tmp3 = z1 + z2 * _I32(T.FIX_0_765366865)
    z2, z3 = x[0], x[4]
    tmp0 = jax.lax.shift_left(z2 + z3, _I32(T.CONST_BITS))
    tmp1 = jax.lax.shift_left(z2 - z3, _I32(T.CONST_BITS))
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _I32(T.FIX_1_175875602)
    t0 = t0 * _I32(T.FIX_0_298631336)
    t1 = t1 * _I32(T.FIX_2_053119869)
    t2 = t2 * _I32(T.FIX_3_072711026)
    t3 = t3 * _I32(T.FIX_1_501321110)
    z1 = z1 * _I32(-T.FIX_0_899976223)
    z2 = z2 * _I32(-T.FIX_2_562915447)
    z3 = z3 * _I32(-T.FIX_1_961570560) + z5
    z4 = z4 * _I32(-T.FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    n = (T.CONST_BITS - T.PASS1_BITS) if pass1 else (T.CONST_BITS + T.PASS1_BITS + 3)
    return [
        _descale(tmp10 + t3, n),
        _descale(tmp11 + t2, n),
        _descale(tmp12 + t1, n),
        _descale(tmp13 + t0, n),
        _descale(tmp13 - t0, n),
        _descale(tmp12 - t1, n),
        _descale(tmp11 - t2, n),
        _descale(tmp10 - t3, n),
    ]


def idct_blocks(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Batched bit-exact islow IDCT: (..., 8, 8) int16 -> (..., 8, 8) int32 in [0, 255]."""
    x = coeffs.astype(_I32)
    ws = _idct_butterfly([x[..., r, :] for r in range(8)], pass1=True)
    ws_rows = jnp.stack(ws, axis=-2)  # (..., 8, 8) workspace
    out = _idct_butterfly([ws_rows[..., :, c] for c in range(8)], pass1=False)
    pix = jnp.stack(out, axis=-1)  # (..., 8, 8)
    return jnp.clip(pix, 0, 255)


def ycbcr_to_rgba(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """Fixed-point color convert + RGBA pack (reference: ycbcr_to_rgb.c:26-49).

    Inputs are int32 samples in [0, 255]; returns packed uint32
    (b | g<<8 | r<<16, alpha 0 — rgb_pixel_t byte order)."""
    cbb = cb - 128
    crr = cr - 128
    yy = jax.lax.shift_left(y, _I32(T.COLOR_SHIFT))
    r = _normalize_rgb(yy + _I32(T.C_CR_R) * crr)
    g = _normalize_rgb(yy - _I32(T.C_CB_G) * cbb - _I32(T.C_CR_G) * crr)
    b = _normalize_rgb(yy + _I32(T.C_CB_B) * cbb)
    packed = b | jax.lax.shift_left(g, _I32(8)) | jax.lax.shift_left(r, _I32(16))
    return packed.astype(jnp.uint32)


def _normalize_rgb(x: jnp.ndarray) -> jnp.ndarray:
    """if x < 0 -> 0 else min(x >> 14, 255) (ycbcr_to_rgb.c:19)."""
    shifted = jax.lax.shift_right_arithmetic(x, _I32(T.COLOR_SHIFT))
    return jnp.where(x < 0, _I32(0), jnp.minimum(shifted, _I32(255)))


def blocks_to_raster(blocks: jnp.ndarray, blocks_h: int, blocks_w: int) -> jnp.ndarray:
    """(..., bh*bw, 8, 8) -> (..., 8*bh, 8*bw) raster reassembly."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(lead + (blocks_h, blocks_w, 8, 8))
    perm = tuple(range(len(lead))) + tuple(
        len(lead) + i for i in (0, 2, 1, 3)
    )
    return x.transpose(perm).reshape(lead + (blocks_h * 8, blocks_w * 8))


@functools.partial(jax.jit, static_argnames=("blocks_h", "blocks_w"))
def decode_transform(
    amps_y: jnp.ndarray,
    amps_cb: jnp.ndarray,
    amps_cr: jnp.ndarray,
    is_iframe: jnp.ndarray,
    *,
    blocks_h: int,
    blocks_w: int,
) -> jnp.ndarray:
    """Full device-side decode: amplitudes -> RGBA frames.

    amps_*: (F, B, 64) int16 entropy-decoded amplitudes (natural order,
    I-frame DC cumsum pre-applied by the host parser).
    is_iframe: (F,) bool.
    Returns (F, H, W) uint32 packed RGBA.
    """
    yq, cq = quant_tensors()
    frames = []
    for amps, q in ((amps_y, yq), (amps_cb, cq), (amps_cr, cq)):
        deltas = dequantize(amps, q)
        state = segmented_scan(deltas, is_iframe)
        f, b, _ = state.shape
        frames.append(idct_blocks(state.reshape(f, b, 8, 8)))
    rgba_blocks = ycbcr_to_rgba(*frames)  # (F, B, 8, 8) uint32
    return blocks_to_raster(rgba_blocks, blocks_h, blocks_w)


@functools.partial(jax.jit, static_argnames=("blocks_h", "blocks_w"))
def decode_transform_states(
    y_state: jnp.ndarray,
    cb_state: jnp.ndarray,
    cr_state: jnp.ndarray,
    *,
    blocks_h: int,
    blocks_w: int,
) -> jnp.ndarray:
    """Transform pre-accumulated coefficient states (no temporal scan).

    states: (..., B, 64) int16 -> (..., H, W) uint32 RGBA.
    """
    planes = []
    for st in (y_state, cb_state, cr_state):
        shape = st.shape[:-1] + (8, 8)
        planes.append(idct_blocks(st.reshape(shape)))
    rgba = ycbcr_to_rgba(*planes)
    return blocks_to_raster(rgba, blocks_h, blocks_w)


@functools.partial(jax.jit, static_argnames=("blocks_h", "blocks_w"))
def decode_window(
    amps: jnp.ndarray,
    seg: jnp.ndarray,
    carry: jnp.ndarray,
    *,
    blocks_h: int,
    blocks_w: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The streaming pipeline's device step: one window with state carry.

    amps:  (3, W, B, 64) int16 entropy-decoded amplitudes (Y, Cb, Cr).
    seg:   (W,) bool I-frame mask.
    carry: (3, B, 64) int16 coefficient state of the frame before the window
           (zeros for a stream's first window — its leading I-frame
           overwrites it).
    Returns (frames (W, H, Wd) uint32 raster, new carry (3, B, 64) int16).
    Window boundaries need no GOP alignment: the carry is exact.
    """
    yq, cq = quant_tensors()
    states = []
    for p, q in ((0, yq), (1, cq), (2, cq)):
        vals, seen = segmented_scan_flags(dequantize(amps[p], q), seg)
        # Frames before the window's first I-frame continue from carry.
        states.append(
            jnp.where(seen, vals, (carry[p][None] + vals).astype(jnp.int16))
        )
    frames = decode_transform_states(
        *states, blocks_h=blocks_h, blocks_w=blocks_w
    )
    return frames, jnp.stack([s[-1] for s in states])

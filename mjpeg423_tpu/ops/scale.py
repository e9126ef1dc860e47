"""Device-side box downscaling of decoded frames (preview/thumbnail egress).

Serving previews at full resolution wastes the most expensive resource in
the decode path — device->host egress (DESIGN.md §2: frames dominate
transfer bytes; the reference's equivalent cost center is the framebuffer
DMA, ece423_vid_ctl.c:96-116).  A 2^j box filter applied ON DEVICE before
transfer cuts egress 4^j x for thumbnail farms and preview scrubbing.

Semantics (beyond-reference, so chosen rather than ported): per channel,
each output pixel is the rounded mean of an f x f input box —
(sum + f*f/2) >> log2(f*f), i.e. round-half-up.  f must divide 8 so boxes
never straddle 8x8 blocks.
"""
from __future__ import annotations

import numpy as np

_SHIFTS = (0, 8, 16, 24)  # packed BGRA byte lanes


def check_factor(f: int) -> int:
    if f not in (1, 2, 4, 8):
        raise ValueError(
            f"scale must be 1, 2, 4 or 8 (boxes must divide the 8x8 "
            f"block), got {f}"
        )
    return f


_check_factor = check_factor


def _avg_pack(channels, f: int, jnp):
    """Rounded per-channel mean of pre-summed boxes, repacked to uint32."""
    half = (f * f) // 2
    shift = 2 * (f.bit_length() - 1)
    out = None
    for ch, s in zip(channels, _SHIFTS):
        v = (ch + half) >> shift
        out = v << s if out is None else out | (v << s)
    return out


def downscale_raster(x, f: int):
    """(W, H, Wd) uint32 raster frames -> (W, H/f, Wd/f), on device."""
    import jax.numpy as jnp

    _check_factor(f)
    w, h, wd = x.shape
    x5 = x.reshape(w, h // f, f, wd // f, f)
    chans = [
        ((x5 >> s) & jnp.uint32(0xFF)).sum(axis=(2, 4), dtype=jnp.uint32)
        for s in _SHIFTS
    ]
    return _avg_pack(chans, f, jnp)


def downscale_raster_host(x: np.ndarray, f: int) -> np.ndarray:
    """NumPy oracle of downscale_raster (tests + host-side fallback)."""
    _check_factor(f)
    if f == 1:
        return x
    w, h, wd = x.shape
    x5 = x.reshape(w, h // f, f, wd // f, f)
    half = (f * f) // 2
    shift = 2 * (f.bit_length() - 1)
    out = np.zeros((w, h // f, wd // f), np.uint32)
    for s in _SHIFTS:
        ch = ((x5 >> s) & np.uint32(0xFF)).sum(
            axis=(2, 4), dtype=np.uint32
        )
        out |= ((ch + half) >> shift) << s
    return out

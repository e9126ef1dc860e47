"""The pipeline's device step (transform_jax.decode_window) vs the oracle.

decode_window is the one device decode path on every backend: dequant,
segmented temporal scan with a carry between windows, islow IDCT, colour
pack, raster.  These cases cover geometries, window lengths that do and do
not align with the GOP, carry chaining, and extreme coefficient states.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import tables as T
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu.ops import transform_jax, transform_ref
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames


def _window_ref(amps, seg, carry, blocks_h, blocks_w):
    """Sequential NumPy reference: the reference decoder's per-frame state
    update (lossless_decode.c:76-128) followed by the oracle transform."""
    quants = (T.YQUANT64, T.CQUANT64, T.CQUANT64)
    state = [carry[p].copy() for p in range(3)]
    frames = []
    for f in range(amps.shape[1]):
        for p in range(3):
            if seg[f]:
                state[p] = transform_ref.dequant_i(amps[p, f], quants[p])
            else:
                state[p] = transform_ref.accumulate_p(
                    state[p], amps[p, f], quants[p]
                )
        frames.append(decoder.transform_frame_numpy(
            *state, blocks_h=blocks_h, blocks_w=blocks_w
        ))
    return np.stack(frames), np.stack(state)


def _decode_windows(amps, seg, w, blocks_h, blocks_w):
    """Run the device step window by window, chaining the carry."""
    carry = jnp.zeros((3, amps.shape[2], 64), jnp.int16)
    outs = []
    for s in range(0, amps.shape[1], w):
        frames, carry = transform_jax.decode_window(
            jnp.asarray(amps[:, s:s + w]), jnp.asarray(seg[s:s + w]), carry,
            blocks_h=blocks_h, blocks_w=blocks_w,
        )
        outs.append(np.asarray(frames))
    return np.concatenate(outs), np.asarray(carry)


@pytest.mark.parametrize("h,w,nf,gop,window", [
    (32, 48, 11, 4, 11),   # one window holds the whole stream
    (32, 48, 11, 4, 3),    # windows of 3/3/3/2, unaligned to GOP 4
    (32, 48, 11, 4, 4),    # windows aligned to the GOP
    (24, 32, 7, 3, 2),     # window 2: carry on every step
    (24, 32, 7, 3, 1),     # window 1: every frame its own step
    (8, 8, 5, 2, 3),       # one block per plane
    (8, 64, 6, 5, 4),      # one block-row
    (64, 8, 6, 5, 4),      # one block-column
    (16, 120, 6, 3, 5),    # odd block width (15)
    (48, 64, 9, 24, 20),   # window longer than the stream
])
def test_decode_window_matches_oracle(h, w, nf, gop, window):
    rng = np.random.default_rng(h * 7919 + w * 31 + window)
    frames = make_test_frames(rng, num_frames=nf, h=h, w=w)
    data = encoder.encode_frames(frames, max_i_interval=gop)
    want = decoder.decode_stream_array(data)
    coefs = decoder.parse_coefficient_deltas(parse_file(data))
    amps = np.stack([coefs.y, coefs.cb, coefs.cr])
    got, _ = _decode_windows(
        amps, coefs.frame_types == 0, window, h // 8, w // 8
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bh,bw,f,lead_i", [
    (3, 5, 4, True),
    (1, 257, 3, True),     # degenerate raster: one long block-row
    (4, 4, 6, False),      # window opens on P-frames: continues the carry
])
def test_decode_window_random_amps(bh, bw, f, lead_i):
    """Random amplitudes (far outside what the encoder emits) and a random
    incoming carry: frames AND the new carry match the sequential oracle."""
    rng = np.random.default_rng(bh * 100 + bw)
    b = bh * bw
    amps = rng.integers(-300, 300, size=(3, f, b, 64)).astype(np.int16)
    carry = rng.integers(-2048, 2048, size=(3, b, 64)).astype(np.int16)
    seg = np.zeros(f, dtype=bool)
    seg[0] = lead_i
    seg[f // 2] = True
    want, want_carry = _window_ref(amps, seg, carry, bh, bw)
    got, got_carry = transform_jax.decode_window(
        jnp.asarray(amps), jnp.asarray(seg), jnp.asarray(carry),
        blocks_h=bh, blocks_w=bw,
    )
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(got_carry), want_carry)


def test_decode_window_extreme_states():
    """int16 extremes in the carry and wrapping P accumulation exercise the
    IDCT clamps and the modular state update."""
    bh, bw, f = 2, 2, 3
    b = bh * bw
    carry = np.zeros((3, b, 64), np.int16)
    carry[:, 0, 0] = 32767
    carry[:, 1, 1] = -32768
    carry[:, 2] = 32767
    carry[:, 3] = -32768
    amps = np.zeros((3, f, b, 64), np.int16)
    amps[:, :, 0, 0] = 1000        # wraps the DC state on the first P step
    amps[:, 1, 3, 5] = -2047
    seg = np.zeros(f, dtype=bool)
    want, want_carry = _window_ref(amps, seg, carry, bh, bw)
    got, got_carry = transform_jax.decode_window(
        jnp.asarray(amps), jnp.asarray(seg), jnp.asarray(carry),
        blocks_h=bh, blocks_w=bw,
    )
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(got_carry), want_carry)


def test_decode_window_zero_input_color():
    """All-zero coefficients: Y=Cb=Cr=0 samples.  Cb=Cr=0 is extreme negative
    chroma (offset -128), so R and B clamp to 0 and
    G = (5638+11700)*128>>14 = 135 (ycbcr_to_rgb.c:34-37) -> 135<<8."""
    amps = np.zeros((3, 2, 16, 64), np.int16)
    seg = np.array([True, False])
    frames, carry = transform_jax.decode_window(
        jnp.asarray(amps), jnp.asarray(seg),
        jnp.zeros((3, 16, 64), jnp.int16), blocks_h=4, blocks_w=4,
    )
    assert frames.shape == (2, 32, 32)
    assert np.all(np.asarray(frames) == np.uint32(135 << 8))
    assert not np.asarray(carry).any()


@pytest.mark.parametrize("window", [2, 3])
def test_pipeline_wide_amplitudes(window):
    """AC amplitudes beyond int8 (up to the VLI's 11 bits) stream through
    the pipeline bit-exact at window sizes that split the GOPs."""
    from tests_helpers_overflow import craft_wide_stream

    data, _ = craft_wide_stream(np.random.default_rng(5 + window))
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=window))
    np.testing.assert_array_equal(pipe.decode_array(data), want)

"""Sharded decode on the 8-device virtual CPU mesh vs the single-device path."""
import jax
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu.ops import transform_jax
from mjpeg423_tpu.parallel import (
    decode_transform_sharded,
    make_mesh,
    shard_inputs,
    sharded_segmented_scan,
)

from conftest import make_test_frames


@pytest.fixture(scope="module")
def stream(rng_module):
    # 16 frames, 64x64: blocks_h = 8 (divides all block-axis sizes), F
    # divides 8-way on the data axis.
    frames = make_test_frames(rng_module, num_frames=16, h=64, w=64)
    data = encoder.encode_frames(frames, max_i_interval=5)
    mpg = parse_file(data)
    coefs = decoder.parse_coefficient_deltas(mpg)
    want = decoder.decode_stream_array(data)
    return coefs, want


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(77)


def test_sharded_segmented_scan_matches_local(rng_module):
    mesh = make_mesh(n_data=8)
    f, b = 16, 4
    deltas = rng_module.integers(-300, 300, size=(f, b, 64)).astype(np.int16)
    seg = np.zeros(f, dtype=bool)
    seg[[0, 5, 11]] = True  # I-frames not aligned to the 8-way shard edges
    want = np.asarray(transform_jax.segmented_scan(deltas, seg))
    got = np.asarray(sharded_segmented_scan(deltas, seg, mesh))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_data,n_block", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_decode_sharded_matches_oracle(stream, n_data, n_block):
    coefs, want = stream
    mesh = make_mesh(n_data=n_data, n_block=n_block)
    args = shard_inputs(
        mesh, coefs.y, coefs.cb, coefs.cr, coefs.frame_types == 0
    )
    got = decode_transform_sharded(
        *args,
        mesh=mesh,
        blocks_h=coefs.height // 8,
        blocks_w=coefs.width // 8,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_decode_sharded_fused_gop_aligned(rng_module):
    # Synthetic amps with I-frames exactly at the 4-way shard boundaries:
    # the recurrence runs shard-locally with zero carry.
    f, bh, bw = 16, 4, 8
    b = bh * bw
    amps = rng_module.integers(-200, 200, size=(3, f, b, 64)).astype(np.int16)
    seg = np.zeros(f, dtype=bool)
    seg[[0, 4, 8, 12]] = True
    want = np.asarray(
        transform_jax.decode_transform(
            amps[0], amps[1], amps[2], seg, blocks_h=bh, blocks_w=bw
        )
    )
    mesh = make_mesh(n_data=4, n_block=1)
    args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
    got = decode_transform_sharded(
        *args, mesh=mesh, blocks_h=bh, blocks_w=bw, gop_aligned=True,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_decode_stream_sharded_convenience(stream):
    from mjpeg423_tpu.parallel.decode import decode_stream_sharded
    from mjpeg423_tpu.codec import encoder as enc_mod

    # 13 frames: NOT a multiple of the 4-way data axis (exercises padding).
    rng = np.random.default_rng(99)
    frames = make_test_frames(rng, num_frames=13, h=32, w=32)
    data = enc_mod.encode_frames(frames, max_i_interval=5)
    from mjpeg423_tpu.codec import decoder as dec_mod

    want = dec_mod.decode_stream_array(data)
    mesh = make_mesh(n_data=4, n_block=2)
    got = np.asarray(decode_stream_sharded(data, mesh))
    np.testing.assert_array_equal(got, want)

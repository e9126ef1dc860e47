"""The native coefficient-major parse emitter (decode_batch_cm) vs the
block-major one, and through the device step's carry chain."""
import numpy as np
import pytest

import jax.numpy as jnp

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.ops import transform_jax

from conftest import make_test_frames


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(88)
    frames = make_test_frames(rng, num_frames=9, h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)
    return data, want


@pytest.mark.skipif(not centropy.native_available(), reason="no native codec")
def test_native_cm_parse_matches_reordered_block_major(stream):
    data, want = stream
    index = fmt.index_frames(data)
    nb = index.header.blocks_per_plane
    bw = index.header.blocks_w
    bh = index.header.blocks_h
    offs = index.plane_off.reshape(-1)
    lens = index.plane_len.reshape(-1)
    nf = index.num_frames
    is_p = np.broadcast_to(index.frame_type != 0, (3, nf)).reshape(-1)
    cm = centropy.decode_batch_cm(data, offs, lens, is_p, nb, bw)
    bm = centropy.decode_batch(data, offs, lens, is_p, nb)
    want_cm = bm.reshape(-1, bh, bw, 64).transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(cm, want_cm)


@pytest.mark.skipif(not centropy.native_available(), reason="no native codec")
def test_cm_end_to_end_carry_chain(stream):
    data, want = stream
    index = fmt.index_frames(data)
    nb = index.header.blocks_per_plane
    bh, bw = index.header.blocks_h, index.header.blocks_w
    nf = index.num_frames
    carry = jnp.zeros((3, nb, 64), jnp.int16)
    outs = []
    w = 4
    for s in range(0, nf, w):
        c = min(w, nf - s)
        sl = slice(s, s + c)
        offs = index.plane_off[:, sl].reshape(-1)
        lens = index.plane_len[:, sl].reshape(-1)
        is_p = np.broadcast_to(index.frame_type[sl] != 0, (3, c)).reshape(-1)
        cm = centropy.decode_batch_cm(data, offs, lens, is_p, nb, bw)
        # Undo the cm relayout on the host, then run the device step.
        amps = cm.reshape(3, c, bh, 64, bw).swapaxes(-1, -2).reshape(
            3, c, nb, 64
        )
        frames, carry = transform_jax.decode_window(
            jnp.asarray(amps), jnp.asarray(index.is_iframe[sl]), carry,
            blocks_h=bh, blocks_w=bw,
        )
        outs.append(np.asarray(frames))
    got = np.concatenate(outs, axis=0)
    np.testing.assert_array_equal(got, want)

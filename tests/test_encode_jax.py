"""Device encoder path: byte-identical containers vs the NumPy path."""
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.ops import encode_jax, encode_ref

from conftest import make_test_frames


def test_fdct_matches_reference(rng):
    samples = rng.integers(0, 256, size=(97, 8, 8)).astype(np.uint8)
    want = encode_ref.fdct_blocks(samples)
    got = np.asarray(encode_jax.fdct_blocks(samples))
    np.testing.assert_array_equal(got, want)


def test_quantize_integer_matches_double_round(rng):
    from mjpeg423_tpu.core import tables as T

    coefs = rng.integers(-32768, 32768, size=(50, 64)).astype(np.int16)
    for q64 in (T.YQUANT64, T.CQUANT64):
        want = encode_ref.quantize_blocks(coefs, q64)
        got = np.asarray(encode_jax.quantize(coefs, q64))
        np.testing.assert_array_equal(got, want)


def test_quantize_all_boundary_values():
    # Exhaustive over every int16 coefficient for one luma quant value per
    # distinct magnitude class: proves the integer round == C double round.
    from mjpeg423_tpu.core import tables as T

    coefs = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    coefs = coefs.reshape(1024, 64)
    want = encode_ref.quantize_blocks(coefs, T.YQUANT64)
    got = np.asarray(encode_jax.quantize(coefs, T.YQUANT64))
    np.testing.assert_array_equal(got, want)


def test_encode_frames_device_byte_identical(rng):
    frames = make_test_frames(rng, num_frames=9, h=40, w=56)
    want = encoder.encode_frames(frames, max_i_interval=4)
    got = encoder.encode_frames_device(frames, max_i_interval=4)
    assert got == want
    # And it decodes bit-exact.
    np.testing.assert_array_equal(
        decoder.decode_stream_array(got), decoder.decode_stream_array(want)
    )


def test_encode_frames_device_serial_entropy(rng):
    """The pure-Python bit-packer (serial, no native codec) behind the
    device step: still byte-identical."""
    from mjpeg423_tpu.ops import entropy_ref

    frames = make_test_frames(rng, num_frames=3, h=24, w=24)
    want = encoder.encode_frames(frames, max_i_interval=24)
    got = encoder.encode_frames_device(
        frames, max_i_interval=24, entropy_encode=entropy_ref.encode_plane
    )
    assert got == want


def test_encoder_native_default_byte_identical():
    """The default bit-packer is the native C encoder and its containers are
    byte-identical to the Python oracle's; EncodeConfig is honored."""
    import numpy as np

    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.ops import entropy_ref
    from mjpeg423_tpu.utils.config import EncodeConfig

    rng = np.random.default_rng(2)
    frames = [
        rng.integers(0, 256, (24, 32, 3)).astype(np.uint8) for _ in range(5)
    ]
    a = encoder.encode_frames(frames, max_i_interval=3)
    b = encoder.encode_frames(
        frames, max_i_interval=3, entropy_encode=entropy_ref.encode_plane
    )
    c = encoder.encode_frames(
        frames, max_i_interval=3, config=EncodeConfig(use_native_entropy=False)
    )
    d = encoder.encode_frames(frames, config=EncodeConfig(max_i_interval=3))
    assert a == b == c == d


def test_encode_frames_device_windowed_halo(rng):
    """Multi-window device encode (frames_per_batch < nf): the packer's
    P candidate reads the previous window's last frame; bytes match the
    host encoder exactly, including at every window boundary."""
    from mjpeg423_tpu.utils.config import EncodeConfig

    frames = make_test_frames(rng, num_frames=11, h=32, w=40)
    want = encoder.encode_frames(frames, max_i_interval=5)
    for w_ in (3, 4, 11):
        got = encoder.encode_frames_device(
            frames, max_i_interval=5,
            config=EncodeConfig(frames_per_batch=w_),
        )
        assert got == want, f"window={w_}"

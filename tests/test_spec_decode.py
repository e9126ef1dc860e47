"""Speculative intra-plane parallel entropy decode vs the serial decoder."""
import numpy as np
import pytest

from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.ops import entropy_ref

pytestmark = pytest.mark.skipif(
    not centropy.native_available(), reason="no native codec"
)


def _make_plane(rng, nb, dense=False):
    amps = np.zeros((nb, 64), np.int16)
    amps[:, 0] = rng.integers(-500, 500, size=nb)
    if dense:
        amps[:, 1:] = rng.integers(-40, 40, size=(nb, 63))
    else:
        mask = rng.random((nb, 63)) < 0.2
        amps[:, 1:] = np.where(
            mask, rng.integers(-30, 30, size=(nb, 63)), 0
        ).astype(np.int16)
    return amps


@pytest.mark.parametrize("segments", [2, 3, 8, 16])
@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_spec_matches_serial(segments, is_p, dense):
    rng = np.random.default_rng(segments * 10 + is_p + dense * 3)
    nb = 20000  # big enough that segments exceed the 4096-byte guard
    amps = _make_plane(rng, nb, dense)
    if not is_p:
        d = amps.copy()
        d[1:, 0] = (amps[1:, 0] - amps[:-1, 0]).astype(np.int16)
        bits = centropy.encode_plane(d)
    else:
        bits = centropy.encode_plane(amps)
    want = centropy.decode_plane(bits, nb, is_p)
    got = centropy.decode_plane_spec(bits, nb, is_p, segments)
    np.testing.assert_array_equal(got, want)


def test_spec_small_stream_falls_back():
    rng = np.random.default_rng(0)
    amps = _make_plane(rng, 12)
    bits = centropy.encode_plane(amps)
    got = centropy.decode_plane_spec(bits, 12, True, 8)
    np.testing.assert_array_equal(got, centropy.decode_plane(bits, 12, True))


def test_spec_corrupt_raises():
    with pytest.raises(ValueError):
        # ZRL spam drives the zig-zag index out of range.
        centropy.decode_plane_spec(b"\xf0" * 40000, 30000, True, 4)


def test_pipeline_spec_mode_matches_oracle():
    from mjpeg423_tpu.codec import decoder, encoder
    from mjpeg423_tpu.runtime import DecodePipeline
    from mjpeg423_tpu.utils.config import DecodeConfig
    from conftest import make_test_frames

    rng = np.random.default_rng(3)
    frames = make_test_frames(rng, num_frames=5, h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=3)
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=2, spec_segments=4)
    )
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, want)

"""Golden end-to-end test at the reference's native geometry (640x480).

30 frames (one full GOP + change at MAX_IFRAME_OFFSET 24 — config.h:54),
4800 blocks/plane (config.h:56-62), encoded with the device encoder and
byte-compared against the compiled reference C decoder through the
production pipeline.
"""
import numpy as np
import pytest

from mjpeg423_tpu.codec import encoder
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames
from oracle.harness import Oracle, oracle_available

pytestmark = pytest.mark.skipif(
    not oracle_available(), reason="reference oracle unavailable"
)


def test_vga_30_frames_bit_exact_vs_reference():
    rng = np.random.default_rng(640480)
    frames = make_test_frames(rng, num_frames=30, h=480, w=640)
    data = encoder.encode_frames_device(frames, max_i_interval=24)
    ref = Oracle().decode(data, 30, 640, 480).astype(np.uint32)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=8))
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, ref)

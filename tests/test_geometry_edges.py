"""Extreme geometries through the production pipeline vs the oracle.

bw=1 (single-block rows), bh=1 (single block-row), and odd sizes stress the
device step's block layouts and the raster reassembly.
"""
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames


@pytest.mark.parametrize("h,w", [(64, 8), (8, 64), (8, 8), (24, 40), (16, 120)])
def test_pipeline_fused_odd_geometries(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    frames = make_test_frames(rng, num_frames=4, h=h, w=w, motion=False)
    data = encoder.encode_frames(frames, max_i_interval=2)
    want = decoder.decode_stream_array(data)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3))
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, want)

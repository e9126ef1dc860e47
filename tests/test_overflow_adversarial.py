"""Pathological int16-overflow streams: the pipeline vs the C reference.

SURVEY.md hard-parts: C accumulates P deltas in DCTELEM int16 with
wraparound; every build path must reproduce that exactly.  This crafts
streams whose coefficient state wraps int16 repeatedly and byte-compares the
production pipeline output (at two window sizes) against the compiled
reference C decoder.
"""
import numpy as np
import pytest

from mjpeg423_tpu.core.format import Frame, serialize_file
from mjpeg423_tpu.ops import entropy_ref
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

from oracle.harness import Oracle, oracle_available

pytestmark = pytest.mark.skipif(
    not oracle_available(), reason="reference oracle unavailable"
)

H = W = 16
NB = (H // 8) * (W // 8)


def _craft_stream(rng, num_frames=7):
    """Frames of near-max VLI amplitudes so P accumulation wraps int16."""
    frames = []
    for fi in range(num_frames):
        is_p = fi not in (0, 4)  # I at 0 and 4 (second GOP)
        planes = []
        for _ in range(3):
            amps = rng.integers(-2047, 2048, size=(NB, 64)).astype(np.int16)
            if not is_p:
                # I-frame: encoder emits DC as block-to-block diffs
                # (quantize.c:18-25); craft diffs whose cumsum is our amps.
                d = amps.copy()
                d[1:, 0] = (amps[1:, 0] - amps[:-1, 0]).astype(np.int16)
                enc = entropy_ref.encode_plane(d)
            else:
                enc = entropy_ref.encode_plane(amps)
            planes.append(enc)
        frames.append(Frame(1 if is_p else 0, *planes))
    return serialize_file(W, H, frames), num_frames


def test_fused_pipeline_wraps_exactly_like_c(rng):
    data, nf = _craft_stream(rng)
    ref = Oracle().decode(data, nf, W, H).astype(np.uint32)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3))
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, ref)


def test_xla_pipeline_wraps_exactly_like_c(rng):
    data, nf = _craft_stream(rng)
    ref = Oracle().decode(data, nf, W, H).astype(np.uint32)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, ref)

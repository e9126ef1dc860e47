"""End-to-end example: synthesize frames, encode, decode, seek, verify.

Run: python examples/roundtrip.py   (default JAX backend: the GPU if there
     is one, else the CPU)
"""
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from mjpeg423_tpu.codec.decoder import decode_stream_array
from mjpeg423_tpu.codec.encoder import encode_frames_device
from mjpeg423_tpu.io import bmp
from mjpeg423_tpu.runtime import DecodePipeline, Player
from mjpeg423_tpu.utils.config import DecodeConfig
from mjpeg423_tpu.utils.profile import Profiler


def synthesize(num_frames=12, h=96, w=128):
    """A moving gradient scene (exercises I- and P-frames)."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(num_frames):
        f = np.stack(
            [
                (xx * 2 + t * 9) % 256,
                (yy * 3) % 256,
                ((xx + yy) + t * 4) % 256,
            ],
            axis=-1,
        ).astype(np.uint8)
        frames.append(f)
    return frames


def main():
    frames = synthesize()
    mpg = encode_frames_device(frames, max_i_interval=6)
    print(f"encoded {len(frames)} frames -> {len(mpg)} bytes")

    # Production streaming decode (host parse + the XLA device step).
    prof = Profiler()
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), prof)
    rgba = pipe.decode_array(mpg)
    print(f"decoded: {rgba.shape} uint32 raster frames")

    # Bit-exactness vs the NumPy oracle path.
    assert np.array_equal(rgba, decode_stream_array(mpg))
    print("bit-exact vs the oracle path: OK")

    # Playback with trailer-driven seek.
    player = Player(mpg, DecodeConfig(fps=24.0))
    player.SKIP_SECONDS = 0.25  # small stream: jump ~6 frames
    player.fast_forward()
    stats = player.play(paced=False)
    print(f"played from frame {player.index.gop_starts()[1] if len(player.index.gop_starts())>1 else 0}: "
          f"{stats.frames_delivered} frames at {stats.fps:.0f} fps (unpaced)")

    bmp.write_bmp32("/tmp/mjpeg423_example_frame0.bmp", rgba[0])
    print("wrote /tmp/mjpeg423_example_frame0.bmp")
    print("\nstage timing:")
    print(prof.format_report())


if __name__ == "__main__":
    main()

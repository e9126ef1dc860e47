"""Multi-device decode example: every sharding mode over all devices.

Run: python examples/sharded_decode.py   (default JAX backend: every GPU
of the host; on the CPU backend XLA_FLAGS below gives 8 virtual devices.)
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

import numpy as np

from mjpeg423_tpu.codec.decoder import decode_stream_array
from mjpeg423_tpu.codec.encoder import encode_frames
from mjpeg423_tpu.parallel import decode_stream_sharded, make_mesh
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.runtime.serve import StreamPool
from mjpeg423_tpu.utils.config import DecodeConfig


def synthesize(num_frames, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(num_frames):
        f = np.stack(
            [(xx * 2 + t * 9) % 256, (yy * 3) % 256, ((xx + yy) + t * 4) % 256],
            axis=-1,
        ).astype(np.uint8)
        f = np.clip(
            f.astype(int) + rng.integers(0, 8, f.shape), 0, 255
        ).astype(np.uint8)
        out.append(f)
    return out


def main():
    data = encode_frames(synthesize(48), max_i_interval=6)
    want = decode_stream_array(data)
    print(f"stream: {len(data)} bytes, {want.shape[0]} frames "
          f"{want.shape[2]}x{want.shape[1]}, {len(jax.devices())} devices")

    n = len(jax.devices())
    # Mode 1: streams over devices (serving) — one copy of the stream per
    # device, one pinned pipeline per device.
    pool = StreamPool(DecodeConfig(), devices=jax.devices())
    stats = pool.decode_all([data] * n, max_concurrent=n)
    print(f"mode 1 streams-over-chips: {stats.frames} frames, "
          f"{stats.frames_per_s:.0f} frames/s aggregate")

    # Mode 2: one stream's GOPs over chips, streaming.
    mesh = make_mesh(n_data=n, n_block=1)
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=3), mesh=mesh)
    got = pipe.decode_array(data)
    assert (got == want).all()
    print(f"mode 2 gop-sharded streaming: bit-exact on the {n}-device mesh")

    # Mode 3: batch decode, auto GOP-aligned partitioning.
    got = np.asarray(decode_stream_sharded(data, mesh))
    assert (got == want).all()
    print("mode 3 gop-aligned batch: bit-exact")


if __name__ == "__main__":
    main()

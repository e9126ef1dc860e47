"""Small-clip serving example: thumbnails + packed multi-clip windows.

A clip farm (many short same-geometry videos) is the worst case for
per-stream decoding — most device window slots are padded tails and every
clip pays a dispatch.  The segmented temporal scan makes both fixes exact:

  1. decode_iframes: an archive's preview strip from GOP heads only.
  2. decode_streams / StreamPool.decode_all_packed: frames of consecutive
     clips PACK into shared windows; seg resets at every clip seam.

Run: python examples/clip_farm.py   (default JAX backend; same code on CPU or GPU.)
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from mjpeg423_tpu.codec.decoder import decode_stream_array
from mjpeg423_tpu.codec.encoder import encode_frames
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.runtime.serve import StreamPool
from mjpeg423_tpu.utils.config import DecodeConfig


def clip(rng, n, h=64, w=96):
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    frames = [
        np.clip(base.astype(np.int16) + 6 * t, 0, 255).astype(np.uint8)
        for t in range(n)
    ]
    return encode_frames(frames, max_i_interval=6)


def main():
    rng = np.random.default_rng(0)
    window = 20
    clips = [clip(rng, int(n)) for n in rng.integers(2, 9, size=12)]
    total = sum(
        int.from_bytes(c[:4], "little") for c in clips
    )

    # Per-clip decoding would use ceil(len/W) windows per clip; packed uses
    # ceil(total/W) overall.
    per_clip = sum(
        -(-int.from_bytes(c[:4], "little") // window) for c in clips
    )
    packed = -(-total // window)
    print(f"{len(clips)} clips, {total} frames: per-clip decode = "
          f"{per_clip} windows, packed = {packed} windows "
          f"({per_clip / packed:.1f}x less device work)")

    pool = StreamPool(DecodeConfig(frames_per_batch=window))
    got: dict[tuple[int, int], np.ndarray] = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = win.frames[i]

    stats = pool.decode_all_packed(clips, sink=sink)
    print(f"packed decode: {stats.frames} frames in {stats.wall_s:.3f}s")

    for si, data in enumerate(clips):
        want = decode_stream_array(data)
        for fi in range(want.shape[0]):
            assert (got[(si, fi)] == want[fi]).all()
    print("bit-exact vs per-clip standalone decode")

    # Preview strips: only the I-frames of each archive.
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=window))
    idx, thumbs = pipe.decode_iframes_array(clips[0])
    print(f"clip 0 preview: I-frames at {list(idx)} -> {thumbs.shape}")


if __name__ == "__main__":
    main()

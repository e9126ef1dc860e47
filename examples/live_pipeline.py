"""Live streaming: camera-sim -> LiveEncoder -> pipe -> decode_live.

The reference's actual operating mode is forward-only streaming (core1
reads the SD card strictly forward, one frame ahead of the decoder);
this example runs that shape end to end over a REAL pipe with both ends
live simultaneously:

  producer thread: synthesizes frames at a paced rate, encodes each one
      as it "arrives" (LiveEncoder: open-ended header, no trailer), and
      writes complete container frames into the pipe;
  consumer: decode_live chains the bytes into windows as they land and
      runs the same jit decode step as the stored path.

Backpressure is end-to-end: a slow consumer fills the pipe, which stalls
the producer's write — no unbounded buffering anywhere.

Run: python examples/live_pipeline.py   (default JAX backend; same code on CPU or GPU.)
"""
import os
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from mjpeg423_tpu.codec.encoder import LiveEncoder
from mjpeg423_tpu.runtime import decode_live
from mjpeg423_tpu.utils.config import DecodeConfig

W, H, N_FRAMES, FPS = 320, 240, 48, 120.0


def synth_frame(t: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.zeros((H, W, 3), np.uint8)
    rgb[..., 0] = ((xx + 3 * t) * 255 // W) % 256
    rgb[..., 1] = (yy * 255 // H) % 256
    rgb[..., 2] = ((xx + yy + 7 * t)) % 256
    x0 = (t * 9) % (W - 32)
    rgb[H // 3:H // 3 + 32, x0:x0 + 32] = 255
    return rgb


def main() -> int:
    r, w = os.pipe()

    def producer():
        with open(w, "wb") as f:
            enc = LiveEncoder(f, W, H, max_i_interval=12)
            for t in range(N_FRAMES):
                enc.write_frame(synth_frame(t))
                f.flush()
                time.sleep(1.0 / FPS)  # the camera's frame cadence

    th = threading.Thread(target=producer)
    t0 = time.perf_counter()
    th.start()

    # Small window + 1-deep ring for glass-to-glass latency.
    cfg = DecodeConfig(frames_per_batch=8, num_output_buffers=1)
    n = 0
    with open(r, "rb") as f:
        for win in decode_live(f, config=cfg):
            n += win.count
            lat = time.perf_counter() - t0 - (win.start_frame + win.count) / FPS
            print(
                f"  window @{win.start_frame:3d} +{win.count} frames, "
                f"{lat * 1e3:6.1f} ms behind the live edge"
            )
    th.join()
    dt = time.perf_counter() - t0
    assert n == N_FRAMES, (n, N_FRAMES)
    print(f"decoded {n} live frames in {dt:.2f}s "
          f"(source paced at {FPS:.0f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

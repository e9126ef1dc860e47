"""Device-resident serving: decoded frames feed a model with NO host egress.

The production configuration for model-input pipelines: the decode step
and the consumer run on-device in the SAME jit — only the model's output
(here, per-frame logits) ever crosses back to the host.

Run: python examples/device_consumer.py   (default JAX backend.)
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from mjpeg423_tpu.codec.decoder import parse_coefficient_deltas
from mjpeg423_tpu.codec.encoder import encode_frames
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu.ops.transform_jax import decode_window


def synthesize(num_frames, h=64, w=96, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    frames = [base]
    for t in range(num_frames - 1):
        f = frames[-1].copy()
        f[(t * 8) % h:(t * 8) % h + 8] ^= 7
        frames.append(f)
    return frames


def main():
    h, w, F = 64, 96, 8
    bh, bw = h // 8, w // 8
    data = encode_frames(synthesize(F, h, w), max_i_interval=4)

    # Host parse -> amplitude window (the streaming pipeline does this in a
    # thread pool; one window is enough for the demo).
    coefs = parse_coefficient_deltas(parse_file(data))
    amps = np.stack([coefs.y, coefs.cb, coefs.cr])
    # (3, F, B, 64) int16, I-DC cumsum applied per the parse contract
    seg = coefs.frame_types == 0

    @jax.jit
    def decode_and_classify(amps, seg, carry, weights):
        # Decode window -- stays on device.
        frames, new_carry = decode_window(
            amps, seg, carry, blocks_h=bh, blocks_w=bw,
        )
        # frames: (F, H, W) uint32 BGRA-packed.  Unpack channels with
        # integer ops (fused by XLA) and global-pool.
        b = (frames & 0xFF).astype(jnp.float32)
        g = ((frames >> 8) & 0xFF).astype(jnp.float32)
        r = ((frames >> 16) & 0xFF).astype(jnp.float32)
        feats = jnp.stack([
            r.mean(axis=(1, 2)),
            g.mean(axis=(1, 2)),
            b.mean(axis=(1, 2)),
            r.std(axis=(1, 2)),
        ], axis=-1)                      # (F, 4)
        return feats @ weights, new_carry  # (F, n_classes) logits

    carry = jnp.zeros((3, bh * bw, 64), jnp.int16)
    weights = jnp.asarray(
        np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    )
    logits, _ = decode_and_classify(
        jnp.asarray(amps), jnp.asarray(seg), carry, weights
    )
    print("logits per frame (only these crossed back to the host):")
    print(np.asarray(logits).round(2))
    assert logits.shape == (F, 5)
    print("ok: decode -> model consumed", F, "frames device-resident")

    # The same configuration through the PRODUCTION pipeline API: the
    # streaming decoder keeps every window on device
    # (decode(device_resident=True)); the consumer jit reads the frames
    # directly and only its scalar output is fetched.
    from mjpeg423_tpu.runtime import DecodePipeline

    @jax.jit
    def consume(frames):  # frames: (W, H, Wd) uint32, padded rows ok
        return (frames & 0xFF).astype(jnp.float32).mean()

    pipe = DecodePipeline()
    outs = [
        # Rows beyond win.count are PAD (repeats of the last frame) —
        # device-resident consumers must slice to .count.
        (win.count, float(consume(win.frames[:win.count])))
        for win in pipe.decode(data, device_resident=True)
    ]
    assert sum(c for c, _ in outs) == F
    print("ok: streaming pipeline, device-resident windows:", outs)


if __name__ == "__main__":
    main()

"""Grand parity soak: every encode path x every decode path, random inputs.

Each round draws a random geometry / content class / GOP structure, then:

  encode:  host native pack == pure-Python oracle pack == device step ==
           mesh-sharded device step (8-dev virtual mesh)
           -> all byte-identical containers
  decode:  NumPy oracle == streaming pipeline at two window sizes ==
           GOP-aligned sharded batch == compiled reference C decoder
           -> all byte-identical frames
  regop:   decode(regop(x)) == decode(x)
  live:    decode_live over random-size chunks (stored or open-ended
           header) == stored decode; LiveEncoder+finalize == stored
           encoder bytes

The fixed-seed test suite proves each equality once; this soak walks the
geometry/content space (odd block counts, bw=1/bh=1 edges, dense noise,
flat fields, P-heavy motion).  Usage: python scripts/parity_soak.py
[rounds] [seed].  CPU-only (forces the 8-device virtual mesh).
"""
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.codec.transcode import regop
from mjpeg423_tpu.ops import entropy_ref
from mjpeg423_tpu.parallel import decode_stream_sharded, make_mesh
from mjpeg423_tpu.runtime import (
    DecodePipeline,
    decode_live_array,
    live_stream_bytes,
)
from mjpeg423_tpu.utils.config import DecodeConfig, EncodeConfig

import io as _io


def _chunked(data, sizes):
    i = k = 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        yield data[i:i + n]
        i += n
        k += 1

try:
    from tests.oracle import harness

    ORACLE = harness.Oracle() if harness.oracle_available() else None
except Exception:  # pragma: no cover — reference tree absent
    ORACLE = None


def synth(rng):
    h = 8 * int(rng.integers(1, 8))
    w = 8 * int(rng.integers(1, 10))
    nf = int(rng.integers(2, 12))
    kind = rng.integers(0, 4)
    frames = []
    if kind == 0:  # noise (dense entropy)
        frames = [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                  for _ in range(nf)]
    elif kind == 1:  # flat + tiny motion (P-heavy)
        base = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        for t in range(nf):
            f = base.copy()
            f[t % h, :, t % 3] ^= 5
            frames.append(f)
            base = f
    elif kind == 2:  # gradients with scene cuts
        yy, xx = np.mgrid[0:h, 0:w]
        for t in range(nf):
            s = int(rng.integers(1, 9)) if t % 4 == 0 else 0
            f = np.stack([(xx * 3 + t * 11 + s) % 256, (yy * 5) % 256,
                          (xx + yy + 7 * t) % 256], -1).astype(np.uint8)
            frames.append(f)
    else:  # extremes: saturated blocks + checkerboards
        for t in range(nf):
            f = np.zeros((h, w, 3), np.uint8)
            f[: h // 2] = 255
            f[:, :: 2] ^= 255 * (t % 2)
            frames.append(f)
    return frames, h, w, nf


def one_round(rng, mesh):
    frames, h, w, nf = synth(rng)
    maxi = int(rng.integers(1, 7))

    # --- encode paths ---
    a = encoder.encode_frames(frames, max_i_interval=maxi)
    b = encoder.encode_frames(frames, max_i_interval=maxi,
                              entropy_encode=entropy_ref.encode_plane)
    assert a == b, "host native pack != python oracle pack"
    c = encoder.encode_frames_device(
        frames, max_i_interval=maxi,
        config=EncodeConfig(frames_per_batch=int(rng.integers(2, 6))),
    )
    assert a == c, "device encoder != host encoder"
    if nf >= 8 and rng.random() < 0.5:
        d = encoder.encode_frames_device(
            frames, max_i_interval=maxi, mesh=mesh)
        assert a == d, "mesh device encoder != host encoder"

    # --- decode paths ---
    want = np.asarray(decoder.decode_stream_array(a))
    p1 = DecodePipeline(DecodeConfig(
        frames_per_batch=int(rng.integers(2, 6))))
    assert (p1.decode_array(a) == want).all(), "pipeline mismatch"
    p2 = DecodePipeline(DecodeConfig(frames_per_batch=4))
    assert (p2.decode_array(a) == want).all(), "pipeline W=4 mismatch"
    got = np.asarray(decode_stream_sharded(a, mesh))
    assert (got == want).all(), "sharded batch mismatch"
    if ORACLE is not None:
        ref = np.asarray(ORACLE.decode(a, nf, w, h))
        assert (want == ref).all(), "oracle decoder mismatch vs reference C"

    # --- live ingest (forward-only chaining; random chunk sizes) ---
    live_src = live_stream_bytes(a) if rng.random() < 0.5 else a
    sizes = [int(s) for s in rng.integers(1, 4096, size=7)]
    lv = decode_live_array(
        _chunked(live_src, sizes),
        config=DecodeConfig(frames_per_batch=int(rng.integers(2, 6))),
    )
    assert (lv == want).all(), "live decode mismatch"
    sink = _io.BytesIO()
    le = encoder.LiveEncoder(sink, w, h, max_i_interval=maxi)
    for fr in frames:
        le.write_frame(fr)
    assert le.finalize() and sink.getvalue() == a, \
        "LiveEncoder finalize != stored encoder bytes"

    # --- segmented-scan serving modes ---
    idx, thumbs = p2.decode_iframes_array(a)
    assert (thumbs == want[idx]).all(), "decode_iframes mismatch"
    if nf >= 3:
        # Split the clip at random cuts and decode the pieces PACKED into
        # shared windows; each piece must equal its standalone decode.
        k = int(rng.integers(1, min(3, nf - 1) + 1))
        cuts = np.sort(rng.choice(np.arange(1, nf), size=k, replace=False))
        clips = [
            encoder.encode_frames(
                [frames[int(i)] for i in part], max_i_interval=maxi
            )
            for part in np.split(np.arange(nf), cuts)
        ]
        pk = DecodePipeline(DecodeConfig(
            frames_per_batch=int(rng.integers(2, 6)),
        ))
        for cdata, g in zip(clips, pk.decode_streams_arrays(clips)):
            ww = np.asarray(decoder.decode_stream_array(cdata))
            assert (g == ww).all(), "packed decode_streams mismatch"

    # --- lossless re-GOP ---
    re = regop(a, max_i_interval=max(1, maxi // 2))
    assert (np.asarray(decoder.decode_stream_array(re)) == want).all(), \
        "regop changed pixels"
    return h, w, nf


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else int(time.time())
    print(f"parity soak: {rounds} rounds, seed {seed}, "
          f"oracle={'yes' if ORACLE else 'no'}", flush=True)
    rng = np.random.default_rng(seed)
    mesh = make_mesh(n_data=8, n_block=1)
    t0 = time.time()
    for r in range(rounds):
        h, w, nf = one_round(rng, mesh)
        print(f"round {r}: {w}x{h} x{nf} ok ({time.time() - t0:.0f}s)",
              flush=True)
    print("ALL PARITY ROUNDS CLEAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Corruption-fuzz campaign against the native codec (opt-in, long-running).

For each round: build a random container (random geometry/content/GOP
structure), then hammer the native parse surfaces with byte corruptions:

  * every parse must either succeed or raise ValueError — never crash the
    process (ctypes: a native fault kills Python) and never hang;
  * uncorrupted parses must stay byte-exact vs the Python oracle;
  * the container indexer must reject corrupt frame chains.

Usage: python scripts/fuzz_native.py [rounds] [seed]
The pytest suite runs a bounded version (tests/test_fuzz_native.py); this
script is the soak — run it for as long as you like, it prints a line per
round and exits nonzero on the first invariant violation.
"""
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# The resilient-decode campaign drives the streaming pipeline; keep the
# soak on the CPU backend so it can run beside a process that holds the GPU.
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
from struct import error as struct_error

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.native import centropy
from mjpeg423_tpu.ops import entropy_ref

_PIPE = None  # lazy singleton: per-geometry jit steps cache inside it


def _pipe():
    global _PIPE
    if _PIPE is None:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mjpeg423_tpu.runtime import DecodePipeline
        from mjpeg423_tpu.utils.config import DecodeConfig

        _PIPE = DecodePipeline(DecodeConfig(frames_per_batch=5))
    return _PIPE


def one_round(rng: np.random.Generator) -> dict:
    h = 8 * int(rng.integers(1, 7))
    w = 8 * int(rng.integers(1, 9))
    nf = int(rng.integers(1, 9))
    maxi = int(rng.integers(1, 6))
    nb = (h // 8) * (w // 8)
    frames = []
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for i in range(nf):
        if rng.random() < 0.3:
            base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        else:
            base = base.copy()
            base[rng.integers(0, h)] ^= int(rng.integers(1, 32))
        frames.append(base)
    data = bytearray(encoder.encode_frames(frames, max_i_interval=maxi))
    index = fmt.index_frames(bytes(data))

    stats = {"ok": 0, "raised": 0, "decoded_differently": 0}
    # clean parse must match the oracle
    for p in range(3):
        for fi in range(nf):
            o = int(index.plane_off[p, fi])
            ln = int(index.plane_len[p, fi])
            is_p = bool(index.frame_type[fi])
            got = centropy.decode_plane(bytes(data[o:o + ln]), nb, is_p)
            want = entropy_ref.decode_plane(bytes(data[o:o + ln]), nb, is_p)
            assert (got == want).all(), "clean parse diverged from oracle"

    # corruption hammering: flip/zero/truncate random plane bytes
    for _ in range(60):
        p = int(rng.integers(0, 3))
        fi = int(rng.integers(0, nf))
        o = int(index.plane_off[p, fi])
        ln = int(index.plane_len[p, fi])
        if ln == 0:
            continue
        blob = bytearray(data[o:o + ln])
        mode = rng.integers(0, 4)
        if mode == 0:
            blob[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
        elif mode == 1:
            blob = blob[: int(rng.integers(0, len(blob)))]
        elif mode == 2:
            for _k in range(int(rng.integers(1, 6))):
                blob[int(rng.integers(0, max(1, len(blob))))] = 0xFF
        else:
            blob = bytearray(rng.integers(0, 256, len(blob)).astype(np.uint8))
        is_p = bool(index.frame_type[fi])
        try:
            got = centropy.decode_plane(bytes(blob), nb, is_p)
        except ValueError:
            stats["raised"] += 1
            continue
        # A parse that "succeeds" on corrupt input must equal the oracle's
        # parse of the same bytes (both see the same stream).
        try:
            want = entropy_ref.decode_plane(bytes(blob), nb, is_p)
        except ValueError:
            raise AssertionError(
                "native accepted a stream the oracle rejects"
            )
        assert (got == want).all(), "corrupt-parse divergence"
        stats["ok"] += 1

        # speculative decoder must agree or fall back, never crash
        spec = centropy.decode_plane_spec(bytes(blob), nb, is_p, 3)
        assert (spec == got).all(), "speculative decoder diverged"

    # whole-container corruption: the pipeline/decoder must raise or give
    # byte-exact output, never crash or silently truncate
    from mjpeg423_tpu.codec.transcode import regop

    for _ in range(10):
        mut = bytearray(data)
        pos = int(rng.integers(20, len(mut)))
        mut[pos] ^= int(rng.integers(1, 256))
        try:
            out = decoder.decode_stream_array(bytes(mut))
            if out.shape[0] != nf:
                raise AssertionError("silent truncation on corrupt container")
            stats["ok"] += 1
        except (ValueError, AssertionError) as e:
            if isinstance(e, AssertionError):
                raise
            stats["raised"] += 1
        # the indexer must reject corrupt chains with ValueError, not crash
        try:
            fmt.index_frames(bytes(mut))
        except ValueError:
            pass
        # the lossless transcoder must raise or stay decode-identical
        try:
            re = regop(bytes(mut), max_i_interval=3)
        except (ValueError, struct_error):
            stats["raised"] += 1
        else:
            try:
                a = decoder.decode_stream_array(bytes(mut))
            except ValueError:
                raise AssertionError(
                    "regop accepted a container the decoder rejects"
                )
            b = decoder.decode_stream_array(re)
            # regop runs strict_range: it must RAISE when the stream's
            # amplitude state exceeds the VLI's 11-bit range, so any
            # successful transcode must be decode-identical.
            assert (np.asarray(a) == np.asarray(b)).all(), (
                "regop succeeded but changed decoded output"
            )
            stats["ok"] += 1

    # resilient decode: random payload/trailer corruption.  Invariants that
    # hold even for UNDETECTABLE corruption (no checksums in the format):
    # frames before the damaged frame are byte-exact; frames at/after the
    # next I-frame following it are byte-exact or inside a reported skipped
    # range (I-frames rebuild all state); trailer-only corruption with an
    # intact chain must decode fully byte-exact (no resync ever consulted).
    want = decoder.decode_stream_array(bytes(data))
    hdr_offs = [
        int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
        for f in range(nf)
    ]
    payload_end = fmt.FILE_HEADER_BYTES + index.header.payload_size
    is_i = index.is_iframe
    for _ in range(8):
        in_trailer = rng.random() < 0.25 and payload_end < len(data)
        lo_b = payload_end if in_trailer else fmt.FILE_HEADER_BYTES
        hi_b = len(data) if in_trailer else payload_end
        off = int(rng.integers(lo_b, hi_b))
        n = int(rng.integers(1, 32))
        mut = bytearray(data)
        garbage = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        # Clamp the write to the region it targets: a payload mutation must
        # not spill into the trailer (the invariants below assume an intact
        # trailer), nor a trailer mutation past EOF.
        end = min(off + n, hi_b)
        mut[off:end] = garbage[: end - off]
        try:
            got, rec = _pipe().decode_resilient_array(bytes(mut))
        except ValueError:
            stats["raised"] += 1
            continue
        assert got.shape[0] == nf, "resilient output lost frame slots"
        skipped = rec.skipped
        assert skipped == sorted(skipped) and all(
            0 <= a < b <= nf for a, b in skipped
        ), f"malformed skip ranges {skipped}"
        if in_trailer:
            assert not skipped and (got == want).all(), (
                "trailer corruption with an intact chain must decode "
                "fully byte-exact"
            )
            stats["ok"] += 1
            continue
        # The damage spans [off, end): map BOTH edges to frames — the next
        # I-frame must follow the LAST damaged frame, not the first.
        f_bad = max(f for f in range(nf) if hdr_offs[f] <= off)
        f_last = max(f for f in range(nf) if hdr_offs[f] <= end - 1)
        nz = np.flatnonzero(is_i[f_last + 1:])
        nxt = f_last + 1 + int(nz[0]) if nz.size else nf
        in_skip = np.zeros(nf, dtype=bool)
        for a, b in skipped:
            in_skip[a:b] = True
        # Frames before the damage are byte-exact or reported skipped (the
        # trailer cross-check invalidates back to the last verified anchor
        # when it cannot localize a parse-valid chain rewrite).
        for g in range(f_bad):
            assert in_skip[g] or (got[g] == want[g]).all(), (
                f"frame {g} before the damage neither skipped nor "
                f"byte-exact (off={off}, f_bad={f_bad})"
            )
        for g in range(nxt, nf):
            assert in_skip[g] or (got[g] == want[g]).all(), (
                f"frame {g} past the next I-frame neither skipped nor "
                f"byte-exact (off={off}, f_last={f_last})"
            )
        stats["ok"] += 1
    return stats


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else int(time.time())
    print(f"fuzzing {rounds} rounds, seed {seed}")
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for r in range(rounds):
        stats = one_round(rng)
        print(f"round {r}: {stats} ({time.time() - t0:.0f}s)", flush=True)
    print("ALL ROUNDS CLEAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())

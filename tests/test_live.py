"""Live-ingest decode: incremental byte sources, no trailer, no seeking.

The reference's actual operating mode is forward-only streaming off the SD
card (core1/software/main.c:135-164); these tests feed containers through
pipes / chunked iterables and require bit-exact agreement with the stored
whole-buffer decode path.
"""
import io
import os
import threading

import numpy as np
import pytest

from conftest import make_test_frames
from mjpeg423_tpu.codec import encoder
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.runtime import (
    DecodePipeline,
    LiveWriter,
    decode_live,
    decode_live_array,
    live_stream_bytes,
)
from mjpeg423_tpu.utils.config import DecodeConfig


@pytest.fixture(scope="module")
def rgb_frames(rng_mod):
    return make_test_frames(rng_mod, num_frames=23, h=48, w=64)


@pytest.fixture(scope="module")
def stream(rgb_frames):
    return encoder.encode_frames(rgb_frames, max_i_interval=6)


@pytest.fixture(scope="module")
def rng_mod():
    return np.random.default_rng(77)


@pytest.fixture(scope="module")
def stored_frames(stream):
    return DecodePipeline(DecodeConfig(frames_per_batch=7)).decode_array(
        stream
    )


def _chunked(data: bytes, sizes):
    """Yield data split into pseudo-random chunk sizes (stresses partial
    frame headers / bodies straddling read boundaries)."""
    i = 0
    k = 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        yield data[i:i + n]
        i += n
        k += 1


def test_live_matches_stored_decode(stream, stored_frames):
    # Awkward chunk sizes: 1-byte reads, sizes straddling the 16-byte
    # frame header, large gulps.
    got = decode_live_array(
        _chunked(stream, [1, 7, 16, 3, 4096, 2, 33]),
        config=DecodeConfig(frames_per_batch=7),
    )
    np.testing.assert_array_equal(got, stored_frames)


def test_live_filelike_source(stream, stored_frames):
    got = decode_live_array(
        io.BytesIO(stream), config=DecodeConfig(frames_per_batch=5)
    )
    np.testing.assert_array_equal(got, stored_frames)


def test_live_open_ended_stream(stream, stored_frames):
    # num_frames = 0 sentinel, no trailer: frames chain until EOF.
    live = live_stream_bytes(stream)
    assert fmt.FileHeader.unpack(live).num_frames == 0
    assert len(live) < len(stream)  # trailer + pad dropped
    got = decode_live_array(
        _chunked(live, [13, 256, 5]), config=DecodeConfig(frames_per_batch=6)
    )
    np.testing.assert_array_equal(got, stored_frames)


def test_live_through_real_pipe(stream, stored_frames):
    r, w = os.pipe()

    def writer():
        with open(w, "wb") as f:
            # Dribble in small writes so the reader sees partial frames.
            for i in range(0, len(stream), 777):
                f.write(stream[i:i + 777])

    th = threading.Thread(target=writer)
    th.start()
    with open(r, "rb") as f:
        got = decode_live_array(f, config=DecodeConfig(frames_per_batch=8))
    th.join()
    np.testing.assert_array_equal(got, stored_frames)


def test_live_writer_round_trip(stream, stored_frames):
    hdr = fmt.FileHeader.unpack(stream)
    sink = io.BytesIO()
    lw = LiveWriter(sink, hdr.width, hdr.height)
    n = lw.write_container(stream)
    assert n == hdr.num_frames == lw.frames_written
    got = decode_live_array(
        io.BytesIO(sink.getvalue()), config=DecodeConfig(frames_per_batch=9)
    )
    np.testing.assert_array_equal(got, stored_frames)


def test_live_writer_frame_by_frame(stream, stored_frames):
    # Streaming producer: frames written one at a time into a pipe while
    # the decoder runs concurrently (the camera-encoder shape).
    mpg = fmt.parse_file(stream)
    r, w = os.pipe()

    def producer():
        with open(w, "wb", buffering=0) as f:
            lw = LiveWriter(f, mpg.width, mpg.height)
            for fr in mpg.frames:
                lw.write_frame(fr)

    th = threading.Thread(target=producer)
    th.start()
    with open(r, "rb") as f:
        got = decode_live_array(f, config=DecodeConfig(frames_per_batch=4))
    th.join()
    np.testing.assert_array_equal(got, stored_frames)


def test_live_reuses_warm_pipeline(stream, stored_frames):
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=7))
    a = decode_live_array(io.BytesIO(stream), pipeline=pipe)
    b = decode_live_array(
        io.BytesIO(live_stream_bytes(stream)), pipeline=pipe
    )
    np.testing.assert_array_equal(a, stored_frames)
    np.testing.assert_array_equal(b, stored_frames)
    # One compiled step cached, shared across both streams.
    assert len(pipe._step_cache) == 1


def test_live_truncated_mid_frame_raises(stream):
    # Cut inside a frame body (past the first window so the pipeline is
    # already running — the error must cross the stage queue).
    cut = stream[: len(stream) // 2]
    with pytest.raises(ValueError, match="truncated|corrupt"):
        decode_live_array(
            io.BytesIO(cut), config=DecodeConfig(frames_per_batch=4)
        )


def test_live_open_ended_truncated_raises(stream):
    live = live_stream_bytes(stream)
    # EOF NOT at a frame boundary: drop the last 5 bytes.
    with pytest.raises(ValueError, match="truncated"):
        decode_live_array(
            io.BytesIO(live[:-5]), config=DecodeConfig(frames_per_batch=4)
        )


def test_live_corrupt_frame_type_raises(stream):
    offs = fmt.frame_offsets(stream)
    bad = bytearray(stream)
    # frame_type of frame 1 -> 7 (only 0/1 exist, mjpeg423_types.h)
    bad[offs[1] + 4:offs[1] + 8] = (7).to_bytes(4, "little")
    with pytest.raises(ValueError, match="corrupt"):
        decode_live_array(
            io.BytesIO(bytes(bad)), config=DecodeConfig(frames_per_batch=4)
        )


def test_live_insane_frame_size_raises(stream):
    offs = fmt.frame_offsets(stream)
    bad = bytearray(stream)
    # frame_size of frame 1 -> ~4 GB: the reader must reject it without
    # attempting to buffer it (worst-case frame budget, config.h:58-62).
    bad[offs[1]:offs[1] + 4] = (0xF000_0000).to_bytes(4, "little")
    with pytest.raises(ValueError, match="corrupt"):
        decode_live_array(
            io.BytesIO(bytes(bad)), config=DecodeConfig(frames_per_batch=4)
        )


def _frame_bounds(stream):
    """[(lo, hi) byte span per frame] + the index, from the stored walk."""
    index = fmt.index_frames(stream)
    lo = [int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
          for f in range(index.num_frames)]
    hi = [int(index.plane_off[2, f] + index.plane_len[2, f])
          for f in range(index.num_frames)]
    return list(zip(lo, hi)), index


def test_live_resync_reconnect_mid_gop(stream, stored_frames):
    """Kill the feed mid-GOP, reconnect at an arbitrary later offset:
    delivery resumes at the next I-frame, bit-exact, with a RecoveryLog
    entry (VERDICT r2 #9 — decode_resilient's GOP-tail skip for live)."""
    from mjpeg423_tpu.runtime import RecoveryLog

    live = live_stream_bytes(stream)
    bounds, index = _frame_bounds(stream)
    # The live chain has no trailer: frame f's live span is offset by the
    # (identical) file header only.  Cut mid-frame-9 (inside GOP 6..11),
    # reconnect 100 bytes later — the resumed bytes start mid-garbage.
    shift = fmt.FILE_HEADER_BYTES - bounds[0][0]
    cut = bounds[9][0] + shift + 11  # 11 bytes into frame 9's header/body
    resume = cut + 100
    src1 = live[:cut]
    src2 = live[resume:]

    def sources():
        yield io.BytesIO(src1)  # dies mid-frame (no EOF marker: just ends)
        yield _chunked(src2, [3, 17, 4096])  # reconnection, odd chunks

    rec = RecoveryLog()
    got = decode_live_array(
        sources(), config=DecodeConfig(frames_per_batch=5),
        resync=True, recovery=rec,
    )
    # Delivered: frames 0..8 complete before the cut, then the next
    # I-frame at or after frame 10 (max_i_interval=6 -> frame 12).
    next_i = next(f for f in range(10, index.num_frames)
                  if index.is_iframe[f])
    want = np.concatenate(
        [stored_frames[:9], stored_frames[next_i:]], axis=0
    )
    np.testing.assert_array_equal(got, want)
    assert rec.resyncs == 1
    assert len(rec.gaps) == 1
    assert rec.gaps[0][0] == 9  # resumed at delivery index 9
    assert rec.gaps[0][1] > 0  # bytes were discarded while scanning


def test_live_resync_corrupt_header_same_source(stream, stored_frames):
    """In-stream structural damage (no disconnect): a corrupted frame
    header skips to the next I-frame under resync=True."""
    from mjpeg423_tpu.runtime import RecoveryLog

    live = bytearray(live_stream_bytes(stream))
    bounds, index = _frame_bounds(stream)
    shift = fmt.FILE_HEADER_BYTES - bounds[0][0]
    hdr9 = bounds[9][0] + shift
    live[hdr9 + 4:hdr9 + 8] = b"\xee\xee\xee\xee"  # frame_type trashed
    rec = RecoveryLog()
    got = decode_live_array(
        io.BytesIO(bytes(live)), config=DecodeConfig(frames_per_batch=5),
        resync=True, recovery=rec,
    )
    next_i = next(f for f in range(10, index.num_frames)
                  if index.is_iframe[f])
    want = np.concatenate(
        [stored_frames[:9], stored_frames[next_i:]], axis=0
    )
    np.testing.assert_array_equal(got, want)
    assert rec.resyncs == 1
    # EXACT byte-loss accounting: everything from frame 9's header to the
    # recovery I-frame's header was discarded (incl. the pos+=1 escape
    # byte — the accounting was once off by one).
    assert rec.gaps == [(9, bounds[next_i][0] - bounds[9][0])]


def test_live_resync_requires_flag(stream):
    from mjpeg423_tpu.runtime import RecoveryLog

    with pytest.raises(ValueError, match="resync"):
        list(decode_live(io.BytesIO(stream), recovery=RecoveryLog()))


def test_live_resync_final_iframe_survives_midheader_cut(
    stream, stored_frames
):
    """The feed dies a few bytes INTO the header following the recovery
    I-frame: chain validation is impossible, but the I-frame's body is
    complete — it must be delivered, not dropped for the stray tail."""
    from mjpeg423_tpu.runtime import RecoveryLog

    live = live_stream_bytes(stream)
    bounds, index = _frame_bounds(stream)
    shift = fmt.FILE_HEADER_BYTES - bounds[0][0]
    cut = bounds[9][0] + shift + 11
    next_i = next(f for f in range(10, index.num_frames)
                  if index.is_iframe[f])
    # Reconnection carries exactly the recovery I-frame + 10 bytes of the
    # following frame's header, then dies for good.
    end = bounds[next_i][1] + shift + 10
    src2 = live[cut + 100:end]

    def sources():
        yield io.BytesIO(live[:cut])
        yield io.BytesIO(src2)

    rec = RecoveryLog()
    got = decode_live_array(
        sources(), config=DecodeConfig(frames_per_batch=5),
        resync=True, recovery=rec,
    )
    want = np.concatenate(
        [stored_frames[:9], stored_frames[next_i:next_i + 1]], axis=0
    )
    np.testing.assert_array_equal(got, want)
    assert rec.resyncs == 1


def test_live_resync_rejects_ambiguous_buffer_list(stream):
    """A list of several raw byte buffers is ambiguous (chunks of one
    connection vs one buffer per reconnection) and must be rejected, not
    silently spliced across the gap."""
    with pytest.raises(ValueError, match="ambiguous"):
        decode_live_array(
            [stream[:100], stream[100:]],
            config=DecodeConfig(frames_per_batch=4),
            resync=True,
        )


def test_live_resync_clean_stream_no_gaps(stream, stored_frames):
    """resync=True on an intact stream is a no-op: bit-exact, zero
    recovery entries (the happy path costs nothing)."""
    from mjpeg423_tpu.runtime import RecoveryLog

    rec = RecoveryLog()
    got = decode_live_array(
        live_stream_bytes(stream), config=DecodeConfig(frames_per_batch=6),
        resync=True, recovery=rec,
    )
    np.testing.assert_array_equal(got, stored_frames)
    assert rec.resyncs == 0 and not rec.gaps


def test_live_abandoned_generator_shuts_down(stream):
    # Track only the threads THIS generator creates (other tests' daemon
    # threads may still be unwinding — a global count races).
    before = {t.ident for t in threading.enumerate()}
    gen = decode_live(
        io.BytesIO(stream), config=DecodeConfig(frames_per_batch=4)
    )
    next(gen)
    gen.close()
    # Reader/deliverer/parse-executor threads exit (in-memory source never
    # blocks).  Filter to the threads decode_live OWNS — default CPython
    # thread names carry the target ("Thread-N (reader)") and executor
    # workers are "ThreadPoolExecutor-K_J" — so an unrelated thread
    # spawning late elsewhere in the process (e.g. a runtime-internal
    # pool) cannot flake this assertion.
    def ours():
        return [
            t for t in threading.enumerate()
            if t.ident not in before
            and ("(reader)" in t.name or "(deliverer)" in t.name
                 or t.name.startswith("ThreadPoolExecutor"))
        ]

    for _ in range(300):
        mine = ours()
        if not mine:
            break
        threading.Event().wait(0.1)
    assert not mine, f"lingering decode_live threads: {mine}"


def test_live_stop_predicate(stream):
    seen = []
    for win in decode_live(
        io.BytesIO(stream),
        config=DecodeConfig(frames_per_batch=4, num_output_buffers=1),
        stop=lambda: len(seen) >= 2,
    ):
        seen.append(win)
    assert 0 < len(seen) < 6


def test_live_rejects_mesh_pipeline(stream):
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), mesh=mesh)
    with pytest.raises(ValueError, match="single-device"):
        next(decode_live(io.BytesIO(stream), pipeline=pipe))


def test_live_encoder_finalize_byte_identical(rng_mod):
    # LiveEncoder to a seekable sink + finalize == the stored encoder,
    # byte for byte (the reference's back-patch fixup,
    # mjpeg423_encoder.c:204-225).
    frames = make_test_frames(rng_mod, num_frames=17, h=48, w=64)
    stored = encoder.encode_frames(frames, max_i_interval=6)
    sink = io.BytesIO()
    le = encoder.LiveEncoder(sink, 64, 48, max_i_interval=6)
    for fr in frames:
        le.write_frame(fr)
    assert le.finalize() is True
    assert sink.getvalue() == stored
    with pytest.raises(ValueError, match="finalized"):
        le.write_frame(frames[0])


def test_live_encode_to_live_decode_chain(rng_mod):
    # Full live transcode chain: camera-sim -> LiveEncoder -> pipe ->
    # decode_live, running concurrently; must match the stored round trip.
    frames = make_test_frames(rng_mod, num_frames=15, h=48, w=64)
    stored = encoder.encode_frames(frames, max_i_interval=5)
    want = DecodePipeline(DecodeConfig(frames_per_batch=6)).decode_array(
        stored
    )
    r, w = os.pipe()

    def producer():
        with open(w, "wb") as f:
            le = encoder.LiveEncoder(f, 64, 48, max_i_interval=5)
            for fr in frames:
                le.write_frame(fr)
            assert le.finalize() is False  # pipes are not seekable

    th = threading.Thread(target=producer)
    th.start()
    with open(r, "rb") as f:
        got = decode_live_array(f, config=DecodeConfig(frames_per_batch=6))
    th.join()
    np.testing.assert_array_equal(got, want)


def test_live_encoder_rejects_geometry_mismatch(rng_mod):
    le = encoder.LiveEncoder(io.BytesIO(), 64, 48)
    with pytest.raises(ValueError, match="feed is"):
        le.write_frame(np.zeros((48, 72, 3), np.uint8))
    with pytest.raises(ValueError, match="multiples of 8"):
        encoder.LiveEncoder(io.BytesIO(), 60, 48)


def test_play_live_paced(stream, stored_frames):
    from mjpeg423_tpu.runtime import play_live

    got = {}
    stats = play_live(
        io.BytesIO(stream),
        sink=lambda fi, fr: got.__setitem__(fi, fr),
        paced=True,
        config=DecodeConfig(fps=2000.0, frames_per_batch=6),
    )
    assert stats.frames_delivered == len(stored_frames)
    np.testing.assert_array_equal(
        np.stack([got[k] for k in sorted(got)]), stored_frames
    )
    assert stats.wall_s >= (len(stored_frames) - stats.frames_late) / 2000.0


def test_play_live_catchup_drops(stream, stored_frames):
    # With an impossible fps and zero tolerance, every frame past the
    # first window's deadlines gets dropped to stay at the live edge.
    from mjpeg423_tpu.runtime import play_live

    seen = []
    stats = play_live(
        io.BytesIO(stream),
        sink=lambda fi, fr: seen.append(fi),
        paced=True,
        config=DecodeConfig(fps=100000.0, frames_per_batch=6),
        max_behind_s=0.0,
    )
    assert stats.frames_delivered + stats.frames_dropped == len(
        stored_frames
    )
    assert stats.frames_dropped > 0
    assert stats.frames_delivered == len(seen)
    # The newest frame of every window always delivers — catching up
    # never blanks the display.
    assert len(stored_frames) - 1 in seen


def test_stream_pool_live_feeds(stream, stored_frames):
    from mjpeg423_tpu.runtime.serve import StreamPool

    pool = StreamPool(DecodeConfig(frames_per_batch=6))
    wins: dict = {}
    feeds = [io.BytesIO(stream), io.BytesIO(live_stream_bytes(stream))]
    stats = pool.decode_all_live(
        feeds, sink=lambda si, win: wins.setdefault(si, []).append(win)
    )
    assert stats.streams == 2
    assert stats.frames == 2 * len(stored_frames)
    for si in (0, 1):
        frames = np.concatenate([w.frames for w in sorted(
            wins[si], key=lambda w: w.start_frame
        )])
        np.testing.assert_array_equal(frames, stored_frames)


def test_stream_pool_live_feed_failure_isolated(stream, stored_frames):
    from mjpeg423_tpu.runtime.serve import StreamPool

    pool = StreamPool(DecodeConfig(frames_per_batch=6))
    ok: list = []
    feeds = [io.BytesIO(stream[: len(stream) // 2]), io.BytesIO(stream)]
    with pytest.raises(ValueError, match="truncated|corrupt"):
        pool.decode_all_live(
            feeds,
            sink=lambda si, win: ok.append(win) if si == 1 else None,
        )
    # The healthy feed still decoded fully.
    assert sum(w.count for w in ok) == len(stored_frames)


def test_live_stop_interrupts_stalled_source(stream):
    # A live source that stalls forever after half the stream: the stop
    # predicate must still end the decode (review finding: stop was only
    # polled after a yield, so a stalled feed blocked forever).
    half = stream[: len(stream) // 2]
    release = threading.Event()

    def stalling():
        yield half
        release.wait(timeout=30)  # never released during the test

    flag = threading.Event()
    got = []
    t = threading.Thread(
        target=lambda: got.extend(decode_live(
            stalling(), config=DecodeConfig(frames_per_batch=4),
            stop=flag.is_set,
        )),
        daemon=True,
    )
    t.start()
    threading.Event().wait(0.5)
    flag.set()
    t.join(timeout=5)
    assert not t.is_alive(), "stop did not interrupt a stalled live decode"
    release.set()


def test_live_array_rejects_device_resident(stream):
    with pytest.raises(ValueError, match="device_resident"):
        decode_live_array(io.BytesIO(stream), device_resident=True)


def test_live_encoder_finalize_idempotent_and_offset(rgb_frames, stream):
    hdr = fmt.FileHeader.unpack(stream)
    # Sink with prior content: the header lands at offset 32 and finalize
    # must patch THERE, never offset 0 (review finding).
    sink = io.BytesIO()
    prefix = b"\xab" * 32
    sink.write(prefix)
    le = encoder.LiveEncoder(sink, hdr.width, hdr.height, max_i_interval=6)
    for fr in rgb_frames:
        le.write_frame(fr)
    assert le.finalize() is True
    assert le.finalize() is True  # idempotent: no duplicate trailer/pad
    blob = sink.getvalue()
    assert blob[:32] == prefix
    # Byte-identical stored container, embedded at the offset.
    assert blob[32:] == stream


def test_live_bad_header_raises():
    with pytest.raises(ValueError, match="truncated"):
        decode_live_array(io.BytesIO(b"\x01\x02"))
    # 20-byte header with zero geometry
    hdr = fmt.FileHeader(0, 0, 0, 0, 0).pack()
    with pytest.raises(ValueError, match="geometry"):
        decode_live_array(io.BytesIO(hdr))


def test_live_awkward_chunks_odd_window(stream, stored_frames):
    """Live ingest with a window (7) that splits GOPs, fed across awkward
    chunk boundaries, stays bit-exact with the stored decode."""
    got = decode_live_array(
        _chunked(stream, [5, 4096, 1, 31]),
        config=DecodeConfig(frames_per_batch=7),
    )
    np.testing.assert_array_equal(got, stored_frames)

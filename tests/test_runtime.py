"""Streaming pipeline + playback orchestrator vs the NumPy oracle."""
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.runtime import DecodePipeline, Player
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(5)
    frames = make_test_frames(rng, num_frames=23, h=48, w=64)
    data = encoder.encode_frames(frames, max_i_interval=7)
    want = decoder.decode_stream_array(data)
    return data, want


def test_pipeline_full_decode_matches_oracle(stream):
    data, want = stream
    # Window size NOT aligned to the GOP structure: exercises the carry.
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=5))
    got = pipe.decode_array(data)
    np.testing.assert_array_equal(got, want)


def test_pipeline_seek_from_iframe(stream):
    data, want = stream
    import mjpeg423_tpu.core.format as fmt

    index = fmt.index_frames(data)
    starts = index.gop_starts()
    assert len(starts) >= 2
    s = starts[1]
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    got = pipe.decode_array(data, start_frame=s)
    np.testing.assert_array_equal(got, want[s:])


def test_pipeline_rejects_non_iframe_start(stream):
    data, _ = stream
    pipe = DecodePipeline(DecodeConfig())
    with pytest.raises(ValueError):
        list(pipe.decode(data, start_frame=1))


def test_player_unpaced_delivers_all(stream):
    data, want = stream
    got = {}
    player = Player(data, DecodeConfig(frames_per_batch=6))
    stats = player.play(sink=lambda fi, fr: got.__setitem__(fi, fr), paced=False)
    assert stats.frames_delivered == want.shape[0]
    for fi, fr in got.items():
        np.testing.assert_array_equal(fr, want[fi])


def test_player_ff_rw_land_on_iframes(stream):
    data, want = stream
    player = Player(data, DecodeConfig(fps=24.0))
    starts = player.index.gop_starts()
    # 5 s @ 24 fps = 120 frames > stream length: FF stays, RW goes to start.
    assert player.fast_forward() == 0
    player.current_frame = want.shape[0] - 1
    assert player.rewind() == 0
    # Shrink the skip to 0.1 s so jumps land on real entries.
    player.SKIP_SECONDS = 0.1
    player.current_frame = 0
    ff = player.fast_forward()
    assert ff in starts and ff > 0


def test_player_paced_counts_late_frames(stream):
    data, want = stream
    # Absurd fps -> every frame misses its deadline except ones that arrive
    # within the same tick; just assert accounting fields are consistent.
    player = Player(data, DecodeConfig(fps=100000.0))
    stats = player.play(paced=True, max_frames=8)
    assert stats.frames_delivered == 8
    assert 0 <= stats.frames_late <= 8


def test_pipeline_surfaces_corrupt_stream(stream):
    data, _ = stream
    # Truncate mid-payload: the frame-size chain walks past the buffer.
    bad = data[: len(data) // 3]
    pipe = DecodePipeline(DecodeConfig())
    with pytest.raises(Exception):
        pipe.decode_array(bad)


def test_player_interactive_pause_ff_rw_stop():
    """Scripted mid-play control: pause/resume, FF +5 s, RW, stop — frame
    indices follow the trailer math (main.c:54-127 / playback.c:136-227)."""
    import threading
    import time as _time

    rng = np.random.default_rng(9)
    frames = make_test_frames(rng, num_frames=48, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=6)
    want = decoder.decode_stream_array(data)

    player = Player(data, DecodeConfig(
        fps=24.0, frames_per_batch=4
    ))
    player.SKIP_SECONDS = 0.5  # skip = 12 frames @ 24 fps
    starts = player.index.gop_starts()
    skip = 12

    seen: list[int] = []
    stamps: list[float] = []
    events = {}

    def sink(fi, frame):
        seen.append(fi)
        stamps.append(_time.perf_counter())
        np.testing.assert_array_equal(frame, want[fi])
        if fi == 2 and "ff" not in events:
            events["ff"] = fi
            player.request_fast_forward()
        elif "ff" in events and "pause" not in events and len(seen) >= 6:
            events["pause"] = fi
            player.pause()
            threading.Timer(0.15, player.resume).start()
        elif "pause" in events and "rw" not in events and fi >= 30:
            events["rw"] = fi
            player.request_rewind()
        elif "rw" in events and "stop" not in events and len(seen) > 14:
            events["stop"] = fi
            player.request_stop()

    stats = player.play(sink=sink, paced=False)

    # FF from frame 2: next delivered is the first I-frame >= 2 + 12.
    i_ff = seen.index(events["ff"])
    expect_ff = min(s for s in starts if s >= events["ff"] + skip)
    assert seen[i_ff + 1] == expect_ff
    # Pause: >= 100 ms gap between the paused frame and the next.
    i_p = seen.index(events["pause"])
    assert stamps[i_p + 1] - stamps[i_p] >= 0.1
    # RW from frame r: next delivered is the last I-frame <= r - 12.
    i_rw = seen.index(events["rw"])
    expect_rw = max(
        [s for s in starts if s <= events["rw"] - skip], default=0
    )
    assert seen[i_rw + 1] == expect_rw
    # Stop: the stop frame is the last delivered.
    assert seen[-1] == events["stop"]
    assert stats.frames_delivered == len(seen)


def test_pipeline_raises_on_midstream_corrupt_plane(stream):
    """A corrupt plane bitstream mid-stream must RAISE, not silently truncate
    the decoded output (the parse failure happens in a producer thread; the
    exception must propagate to the consumer)."""
    data, want = stream
    import mjpeg423_tpu.core.format as fmt

    index = fmt.index_frames(data)
    nf = index.num_frames
    fi = nf - 3  # frame in the final window
    o = int(index.plane_off[0, fi])
    ln = int(index.plane_len[0, fi])
    bad = bytearray(data)
    bad[o:o + ln] = b"\xff" * ln  # run-15/size-15 symbols: zig-zag overrun
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=5)
    )
    with pytest.raises(ValueError):
        pipe.decode_array(bytes(bad))


def test_pipeline_bounded_lookahead():
    """The producer must not parse the whole container ahead of the consumer:
    look-ahead is bounded by prefetch + queue + the output ring, regardless
    of stream length."""
    from mjpeg423_tpu.codec import encoder

    rng = np.random.default_rng(11)
    frames = make_test_frames(rng, num_frames=60, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=6)
    cfg = DecodeConfig(
        frames_per_batch=2, prefetch_batches=1, num_output_buffers=1,
    )
    pipe = DecodePipeline(cfg)
    seen = []
    orig = pipe.parse_window

    def counting(data_, index_, s, c, *a, **kw):
        seen.append(s)
        return orig(data_, index_, s, c, *a, **kw)

    pipe.parse_window = counting
    gen = pipe.decode(data)
    next(gen)  # one window consumed
    # 30 windows total; in flight: 3 submitted + 1 queued + ring(2) + slack.
    assert len(seen) <= 10
    total = 2 + sum(w.frames.shape[0] for w in gen)
    assert total == 60


def test_pipeline_early_stop_reaps_producer(stream):
    import threading
    import time as _time

    data, _ = stream
    base = threading.active_count()
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=2, prefetch_batches=1)
    )
    gen = pipe.decode(data)
    next(gen)       # consume one window
    gen.close()     # abandon mid-stream: producer must not stay parked
    _time.sleep(0.2)
    assert threading.active_count() <= base + 1  # thread pool may linger briefly


def test_pipeline_warmup_precompiles(stream):
    """warmup() compiles the step for a geometry; decode then reuses the
    cached step (no new cache entries)."""
    data, want = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=5))
    pipe.warmup(64, 48)
    n_cached = len(pipe._step_cache)
    assert n_cached >= 1
    got = pipe.decode_array(data)
    assert len(pipe._step_cache) == n_cached
    np.testing.assert_array_equal(got, want)


def test_pipeline_warmup_mesh():
    from mjpeg423_tpu.parallel import make_mesh

    rng = np.random.default_rng(12)
    frames = make_test_frames(rng, num_frames=12, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)
    mesh = make_mesh(n_data=4, n_block=1)
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=2), mesh=mesh
    )
    pipe.warmup(16, 16)
    n_cached = len(pipe._step_cache)
    got = pipe.decode_array(data)
    assert len(pipe._step_cache) == n_cached
    np.testing.assert_array_equal(got, want)


def test_pipeline_end_frame_bound(stream):
    data, want = stream
    import mjpeg423_tpu.core.format as fmt

    starts = fmt.index_frames(data).gop_starts()
    lo, hi = starts[1], starts[2]
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    got = pipe.decode_array(data, start_frame=lo, end_frame=hi)
    np.testing.assert_array_equal(got, want[lo:hi])


def test_pipeline_end_frame_bound_mesh(stream):
    from mjpeg423_tpu.parallel import make_mesh

    data, want = stream
    import mjpeg423_tpu.core.format as fmt

    starts = fmt.index_frames(data).gop_starts()
    lo, hi = starts[0], starts[2]
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=3),
        mesh=make_mesh(n_data=2, n_block=1),
    )
    got = pipe.decode_array(data, start_frame=lo, end_frame=hi)
    np.testing.assert_array_equal(got, want[lo:hi])


def test_pipeline_decodes_mmap_buffer(tmp_path):
    """The pipeline accepts mmap'd containers (multi-GB streams stay
    OS-paged instead of RAM-resident)."""
    import mmap

    rng = np.random.default_rng(13)
    frames = make_test_frames(rng, num_frames=10, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)
    p = tmp_path / "m.mpg"
    p.write_bytes(data)
    with open(p, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=3)
        )
        got = pipe.decode_array(mm)
        mm.close()
    np.testing.assert_array_equal(got, want)


class TestDecodeIframes:
    """I-frame-only decode (thumbnail extraction): GOP heads batch into
    windows with zero carry (every I-frame resets all state)."""

    def test_matches_full_decode(self, stream):
        data, want = stream
        from mjpeg423_tpu.core import format as fmt

        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=5)
        )
        idx, thumbs = pipe.decode_iframes_array(data)
        index = fmt.index_frames(data)
        np.testing.assert_array_equal(idx, np.flatnonzero(index.is_iframe))
        np.testing.assert_array_equal(thumbs, want[idx])

    def test_window_not_aligned_to_iframe_count(self, stream):
        data, want = stream
        # batch 3 does not divide the I-frame count (noise content makes
        # smaller-wins insert extra I's): exercises the padded tail window
        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=3)
        )
        idx, thumbs = pipe.decode_iframes_array(data)
        assert len(idx) % 3 != 0 and len(idx) > 3
        np.testing.assert_array_equal(thumbs, want[idx])

    def test_stop_predicate(self, stream):
        data, _ = stream
        pipe = DecodePipeline(DecodeConfig(
            frames_per_batch=2, num_output_buffers=1,
        ))
        n_if = len(pipe.decode_iframes_array(data)[0])
        got = []
        it = pipe.decode_iframes(data, stop=lambda: len(got) >= 2)
        for fi, _f in it:
            got.append(fi)
        assert 2 <= len(got) < n_if  # stops at a window boundary

    def test_mesh_rejected(self, stream):
        data, _ = stream
        import jax

        from mjpeg423_tpu.parallel import make_mesh

        mesh = make_mesh(n_data=len(jax.devices()), n_block=1)
        with pytest.raises(ValueError, match="single-device"):
            next(DecodePipeline(mesh=mesh).decode_iframes(data))


class TestDecodeStreams:
    """Packed multi-stream decode: many same-geometry clips through one
    window stream; seams reset the segmented scan."""

    def _clips(self, rng, lengths, h=24, w=32):
        clips = []
        for n in lengths:
            frames = make_test_frames(rng, num_frames=n, h=h, w=w)
            clips.append(encoder.encode_frames(frames, max_i_interval=6))
        return clips

    @pytest.mark.parametrize("batch", [3, 5, 8])
    def test_matches_per_clip_decode(self, rng, batch):
        clips = self._clips(rng, [7, 2, 11, 1, 4])
        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=batch)
        )
        got = pipe.decode_streams_arrays(clips)
        for data, g in zip(clips, got):
            np.testing.assert_array_equal(
                g, decoder.decode_stream_array(data)
            )

    def test_p_first_clip_at_a_seam(self, rng):
        """A doctored P-first clip mid-batch must decode exactly like its
        standalone zero-carry decode — the seam seg reset must not leak the
        previous clip's coefficient state into it."""
        clips = self._clips(rng, [5, 4, 3])
        mid = bytearray(clips[1])
        mid[24] = 1  # frame 0: I -> P (decoder accepts: delta from zero)
        clips[1] = bytes(mid)
        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=4)
        )
        got = pipe.decode_streams_arrays(clips)
        for data, g in zip(clips, got):
            np.testing.assert_array_equal(
                g, decoder.decode_stream_array(data)
            )

    def test_geometry_mismatch_rejected(self, rng):
        a = self._clips(rng, [3], h=24, w=32)[0]
        b = self._clips(rng, [3], h=32, w=32)[0]
        pipe = DecodePipeline(DecodeConfig())
        with pytest.raises(ValueError, match="same-geometry"):
            next(pipe.decode_streams([a, b]))

    def test_empty_and_order(self, rng):
        clips = self._clips(rng, [2, 3])
        pipe = DecodePipeline(
            DecodeConfig(frames_per_batch=4)
        )
        seen = [(si, fi) for si, fi, _ in pipe.decode_streams(clips)]
        assert seen == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2)]
        assert pipe.decode_streams_arrays([]) == []


def test_decode_streams_iframes_only_thumbnail_farm(rng):
    """GOP heads of MANY archives pack into shared windows (thumbnail
    farm); each archive's thumbs equal its standalone I-frame decode."""
    from mjpeg423_tpu.core import format as fmt

    clips = []
    for n in (9, 4, 7):
        frames = make_test_frames(rng, num_frames=n, h=24, w=32)
        clips.append(encoder.encode_frames(frames, max_i_interval=3))
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    per: dict[int, dict[int, np.ndarray]] = {}
    for si, fi, frame in pipe.decode_streams(clips, iframes_only=True):
        per.setdefault(si, {})[fi] = frame
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        iframes = np.flatnonzero(fmt.index_frames(data).is_iframe)
        assert sorted(per[si]) == list(iframes)
        for fi in iframes:
            np.testing.assert_array_equal(per[si][fi], want[fi])


def test_decode_device_resident(stream):
    """device_resident=True yields device arrays (no host transfer); the
    reassembled frames match the standard decode."""
    data, want = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=5))
    got = np.empty_like(want)
    for win in pipe.decode(data, device_resident=True):
        host = np.asarray(win.frames)  # consumer-side transfer
        got[win.start_frame:win.start_frame + win.count] = host[:win.count]
    np.testing.assert_array_equal(got, want)


def test_decode_streams_abandoned_generator_cleans_up(rng):
    """Abandoning the generator mid-farm must not leak the look-ahead
    worker thread."""
    import threading

    clips = []
    for n in (6, 6, 6):
        frames = make_test_frames(rng, num_frames=n, h=16, w=16)
        clips.append(encoder.encode_frames(frames, max_i_interval=3))
    base = threading.active_count()
    pipe = DecodePipeline(
        DecodeConfig(frames_per_batch=2,
                     prefetch_batches=2)
    )
    gen = pipe.decode_streams(clips)
    next(gen)
    gen.close()  # runs the generator's finally: executor shutdown
    import time as _t

    for _ in range(50):
        if threading.active_count() <= base:
            break
        _t.sleep(0.05)
    assert threading.active_count() <= base + 1


def test_latency_mode_bit_identical(stream):
    """latency=True reorders delivery bookkeeping only: every window's
    pixels are bit-identical to the pipelined default, across a multi-GOP
    stream and from a mid-stream seek."""
    data, _ = stream
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=5))
    base = [
        (win.start_frame, win.count, np.asarray(win.frames).copy())
        for win in pipe.decode(data)
    ]
    lat = [
        (win.start_frame, win.count, np.asarray(win.frames).copy())
        for win in pipe.decode(data, latency=True)
    ]
    assert [(s, c) for s, c, _ in base] == [(s, c) for s, c, _ in lat]
    for (_, _, a), (_, _, b) in zip(base, lat):
        np.testing.assert_array_equal(a, b)

    from mjpeg423_tpu.core import format as fmt
    index = fmt.index_frames(data)
    gops = index.gop_starts()
    if len(gops) > 1:
        s0 = gops[1]
        base = [np.asarray(w_.frames).copy()
                for w_ in pipe.decode(data, start_frame=s0)]
        lat = [np.asarray(w_.frames).copy()
               for w_ in pipe.decode(data, start_frame=s0, latency=True)]
        assert len(base) == len(lat)
        for a, b in zip(base, lat):
            np.testing.assert_array_equal(a, b)

"""Multi-stream serving pool vs per-stream oracle decode."""
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.runtime.serve import StreamPool
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames


def test_pool_decodes_concurrent_streams_bit_exact():
    rng = np.random.default_rng(21)
    streams, oracles = [], []
    for k in range(3):
        frames = make_test_frames(rng, num_frames=6 + k, h=32, w=48)
        data = encoder.encode_frames(frames, max_i_interval=4)
        streams.append(data)
        oracles.append(decoder.decode_stream_array(data))

    got = {i: {} for i in range(len(streams))}

    def sink(si, win):
        for j in range(win.count):
            got[si][win.start_frame + j] = win.frames[j]

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    stats = pool.decode_all(streams, sink=sink, max_concurrent=2)

    assert stats.streams == 3
    assert stats.frames == sum(o.shape[0] for o in oracles)
    assert stats.pixels == sum(o.shape[0] * o.shape[1] * o.shape[2] for o in oracles)
    for si, want in enumerate(oracles):
        assert len(got[si]) == want.shape[0]
        for fi, fr in got[si].items():
            np.testing.assert_array_equal(fr, want[fi])


def test_pool_bounds_worker_threads():
    """decode_all over many streams creates at most max_concurrent worker
    threads (a 10,000-clip archive must not spawn 10,000 OS threads)."""
    import threading

    rng = np.random.default_rng(3)
    frames = make_test_frames(rng, num_frames=4, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)
    streams = [data] * 24
    peak = []

    def sink(si, win):
        peak.append(threading.active_count())

    before = threading.active_count()
    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    stats = pool.decode_all(streams, sink=sink, max_concurrent=3)
    assert stats.frames == 4 * 24
    # 3 workers + each stream's pipeline producer threads; the old
    # thread-per-stream code put all 24 stream threads up at once.
    assert max(peak) - before < 24


def test_pool_retry_surfaces_attempt_to_sink():
    """A mid-decode failure retries the stream and redelivers with
    attempt > 0 so non-idempotent sinks can de-duplicate (VERDICT r1
    weak-6)."""
    rng = np.random.default_rng(22)
    frames = make_test_frames(rng, num_frames=8, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)

    deliveries = []
    fail_once = {"done": False}

    def sink(si, win, attempt):
        deliveries.append((si, win.start_frame, attempt))
        if not fail_once["done"]:
            fail_once["done"] = True
            raise RuntimeError("transient sink failure")

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    stats = pool.decode_all([data], sink=sink, retries=1)
    assert stats.frames == want.shape[0]
    attempts = {a for _, _, a in deliveries}
    assert attempts == {0, 1}
    # the retry redelivered the failed window
    firsts = [(s, a) for (si, s, a) in deliveries]
    assert (0, 0) in firsts and (0, 1) in firsts


def test_pool_two_arg_sink_still_works():
    rng = np.random.default_rng(23)
    frames = make_test_frames(rng, num_frames=5, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=3)
    seen = []
    pool = StreamPool(DecodeConfig(frames_per_batch=3))
    stats = pool.decode_all([data], sink=lambda si, w: seen.append(w.count))
    assert sum(seen) == stats.frames == 5


def test_pool_spreads_streams_over_devices():
    """devices=... pins one pipeline per chip; streams round-robin across
    them and every stream stays bit-exact (stream-level DP on the virtual
    8-device mesh)."""
    import jax

    rng = np.random.default_rng(24)
    streams, oracles = [], []
    for k in range(8):
        frames = make_test_frames(rng, num_frames=4 + (k % 3), h=16, w=16)
        data = encoder.encode_frames(frames, max_i_interval=3)
        streams.append(data)
        oracles.append(decoder.decode_stream_array(data))

    got = {i: {} for i in range(len(streams))}

    def sink(si, win):
        for j in range(win.count):
            got[si][win.start_frame + j] = win.frames[j]

    pool = StreamPool(
        DecodeConfig(frames_per_batch=3),
        devices=jax.devices(),
    )
    assert len(pool.pipelines) == len(jax.devices())
    stats = pool.decode_all(streams, sink=sink, max_concurrent=8)
    assert stats.frames == sum(o.shape[0] for o in oracles)
    for si, want in enumerate(oracles):
        for fi, fr in got[si].items():
            np.testing.assert_array_equal(fr, want[fi])


def test_pool_kwargs_sink_gets_two_args():
    """def sink(si, win, **kw) takes 2 positional args — must not be
    mistaken for an attempt-aware 3-arg sink."""
    rng = np.random.default_rng(25)
    frames = make_test_frames(rng, num_frames=4, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=3)
    seen = []

    def sink(si, win, **kw):
        seen.append(win.count)

    pool = StreamPool(DecodeConfig(frames_per_batch=3))
    stats = pool.decode_all([data], sink=sink)
    assert sum(seen) == stats.frames == 4


def test_decode_all_packed_matches(rng):
    """Packed small-clip serving: same output, seam-split windows."""
    from mjpeg423_tpu.codec import decoder

    clips = []
    for n in (5, 2, 7, 1):
        frames = make_test_frames(rng, num_frames=n, h=24, w=32)
        clips.append(encoder.encode_frames(frames, max_i_interval=4))
    got: dict[tuple[int, int], np.ndarray] = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = win.frames[i]

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    stats = pool.decode_all_packed(clips, sink=sink)
    assert stats.frames == 15
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        for fi in range(want.shape[0]):
            np.testing.assert_array_equal(got[(si, fi)], want[fi])


def test_decode_all_packed_buckets_geometries(rng):
    """Mixed geometries split into buckets instead of failing."""
    a = encoder.encode_frames(
        make_test_frames(rng, num_frames=3, h=24, w=32), max_i_interval=4)
    b = encoder.encode_frames(
        make_test_frames(rng, num_frames=2, h=16, w=16), max_i_interval=4)
    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    stats = pool.decode_all_packed([a, b, a])
    assert stats.frames == 8


def test_decode_all_packed_splits_single_geometry_over_pipelines(rng):
    """One geometry bucket must still fan out over all pool pipelines."""
    from mjpeg423_tpu.codec import decoder
    import jax

    clips = []
    for n in (3, 2, 4, 2, 3):
        frames = make_test_frames(rng, num_frames=n, h=16, w=16)
        clips.append(encoder.encode_frames(frames, max_i_interval=3))
    d = jax.devices()[0]
    pool = StreamPool(
        DecodeConfig(frames_per_batch=3), devices=[d, d]
    )
    assert len(pool.pipelines) == 2
    got: dict[tuple[int, int], np.ndarray] = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = win.frames[i]

    stats = pool.decode_all_packed(clips, sink=sink)
    assert stats.frames == 14
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        for fi in range(want.shape[0]):
            np.testing.assert_array_equal(got[(si, fi)], want[fi])


def test_decode_all_packed_iframes_only(rng):
    """Thumbnail-farm mode: only GOP heads decode, packed."""
    from mjpeg423_tpu.codec import decoder
    from mjpeg423_tpu.core import format as fmt

    clips = []
    for n in (7, 4):
        frames = make_test_frames(rng, num_frames=n, h=16, w=16)
        clips.append(encoder.encode_frames(frames, max_i_interval=3))
    got: dict[tuple[int, int], np.ndarray] = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = win.frames[i]

    pool = StreamPool(DecodeConfig(frames_per_batch=3))
    stats = pool.decode_all_packed(clips, sink=sink, iframes_only=True)
    n_if = 0
    for si, data in enumerate(clips):
        want = decoder.decode_stream_array(data)
        iframes = np.flatnonzero(fmt.index_frames(data).is_iframe)
        n_if += len(iframes)
        for fi in iframes:
            np.testing.assert_array_equal(got[(si, fi)], want[fi])
    assert stats.frames == n_if == len(got)


def test_decode_all_packed_windows_bounded(rng):
    """A long clip must stream bounded windows, not one whole-clip merge."""
    frames = make_test_frames(rng, num_frames=13, h=16, w=16)
    data = encoder.encode_frames(frames, max_i_interval=4)
    counts = []
    pool = StreamPool(DecodeConfig(frames_per_batch=3))
    pool.decode_all_packed([data], sink=lambda si, win: counts.append(win.count))
    assert max(counts) <= 3 and sum(counts) == 13


def test_decode_all_packed_isolates_corrupt_clip(rng):
    """One corrupt clip in a bucket: healthy clips deliver EXACTLY once and
    stay counted; the call still raises for the corrupt one."""
    clips = []
    for n in (4, 3, 5):
        frames = make_test_frames(rng, num_frames=n, h=16, w=16)
        clips.append(encoder.encode_frames(frames, max_i_interval=3))
    # Corrupt clip 1's frame chain: frame 0's frame_size walks out of
    # bounds -> index_frames raises ValueError.
    bad = bytearray(clips[1])
    bad[20:24] = b"\xff\xff\xff\xff"
    clips[1] = bytes(bad)
    seen: list[tuple[int, int, int]] = []

    def sink(si, win, attempt):
        for i in range(win.count):
            seen.append((si, win.start_frame + i, attempt))

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    with pytest.raises(Exception):
        pool.decode_all_packed(clips, sink=sink, retries=1)
    healthy = [(si, fi) for si, fi, _ in seen if si != 1]
    assert sorted(set(healthy)) == sorted(healthy), "healthy clip re-delivered"
    assert {si for si, _ in healthy} == {0, 2}
    assert len([1 for si, fi in healthy if si == 0]) == 4
    assert len([1 for si, fi in healthy if si == 2]) == 5


def test_decode_all_packed_midstream_failure_no_redelivery(rng):
    """A clip whose bitstream fails MID-decode (after earlier clips already
    delivered) must not cause healthy clips to re-deliver: completion is
    detected on each clip's own last frame, and the isolation replay uses
    a fresh attempt number."""
    from mjpeg423_tpu.core import format as fmt

    def clip(n):
        frames = make_test_frames(rng, num_frames=n, h=32, w=32)
        return encoder.encode_frames(frames, max_i_interval=3)

    clips = [clip(4), clip(8), clip(4)]
    # Corrupt a clip-1 plane in its second window with run-15/size-15
    # symbols: the zig-zag overruns (needs >= ~12 bytes of 0xFF to raise
    # before the bit reader pads zeros) -> decode ValueError AFTER clip 0
    # has fully delivered.
    ix = fmt.index_frames(clips[1])
    fi_bad = next(
        f for f in range(4, 8) if int(ix.plane_len[0, f]) >= 12
    )
    o, ln = int(ix.plane_off[0, fi_bad]), int(ix.plane_len[0, fi_bad])
    bad = bytearray(clips[1])
    bad[o:o + ln] = b"\xff" * ln
    clips[1] = bytes(bad)

    seen: list[tuple[int, int, int]] = []

    def sink(si, win, attempt):
        for i in range(win.count):
            seen.append((si, win.start_frame + i, attempt))

    pool = StreamPool(DecodeConfig(
        frames_per_batch=4,
        num_output_buffers=1, prefetch_batches=1,
    ))
    with pytest.raises(ValueError):
        pool.decode_all_packed(clips, sink=sink, retries=1)
    healthy = [(si, fi) for si, fi, _ in seen if si != 1]
    assert sorted(set(healthy)) == sorted(healthy), "healthy re-delivered"
    assert len([1 for si, _ in healthy if si == 0]) == 4
    assert len([1 for si, _ in healthy if si == 2]) == 4


def test_pool_warmup_precompiles_all_pipelines():
    import jax

    devs = jax.devices()[:2]
    pool = StreamPool(
        DecodeConfig(frames_per_batch=4), devices=devs
    )
    pool.warmup(48, 32)
    assert all(len(p._step_cache) == 1 for p in pool.pipelines)
    # Warm pool serves without recompiling a new geometry key.
    rng = np.random.default_rng(77)
    frames = make_test_frames(rng, num_frames=5, h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=3)
    stats = pool.decode_all([data, data])
    assert stats.frames == 10
    assert all(len(p._step_cache) == 1 for p in pool.pipelines)


def test_pool_resilient_mixed_streams():
    """resilient=True: a damaged archive delivers its recoverable frames
    and aggregates skip/resync counters; clean streams are untouched
    (ADVICE r2: ServeStats.frames_skipped/resyncs must be real)."""
    import mjpeg423_tpu.core.format as fmt
    from test_resilient import corrupt_plane, next_iframe_after

    rng = np.random.default_rng(24)
    clean = encoder.encode_frames(
        make_test_frames(rng, num_frames=7, h=32, w=48), max_i_interval=4
    )
    victim = encoder.encode_frames(
        make_test_frames(rng, num_frames=9, h=32, w=48), max_i_interval=4
    )
    index = fmt.index_frames(victim)
    bad_f = int(np.flatnonzero(~index.is_iframe)[0])  # first P frame
    nxt = next_iframe_after(index, bad_f)
    damaged = corrupt_plane(victim, index, bad_f)
    want_clean = decoder.decode_stream_array(clean)
    want_victim = decoder.decode_stream_array(victim)

    got = {0: {}, 1: {}}

    def sink(si, win):
        for j in range(win.count):
            got[si][win.start_frame + j] = win.frames[j]

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    # Without resilient, the pool raises on the damaged stream.
    with pytest.raises(ValueError):
        pool.decode_all([clean, damaged])
    stats = pool.decode_all([clean, damaged], sink=sink, resilient=True)
    assert stats.streams == 2
    assert stats.frames_skipped == nxt - bad_f
    assert stats.resyncs >= 1
    assert stats.frames == want_clean.shape[0] + want_victim.shape[0] - (nxt - bad_f)
    for fi, fr in got[0].items():
        np.testing.assert_array_equal(fr, want_clean[fi])
    assert sorted(got[1]) == [f for f in range(want_victim.shape[0])
                              if not (bad_f <= f < nxt)]
    for fi, fr in got[1].items():
        np.testing.assert_array_equal(fr, want_victim[fi])


def test_cli_serve_resilient(tmp_path, capsys):
    import mjpeg423_tpu.core.format as fmt
    from mjpeg423_tpu import cli
    from test_resilient import corrupt_plane

    rng = np.random.default_rng(25)
    data = encoder.encode_frames(
        make_test_frames(rng, num_frames=7, h=32, w=48), max_i_interval=4
    )
    index = fmt.index_frames(data)
    damaged = corrupt_plane(data, index, 1)
    p = tmp_path / "d.mpg"
    p.write_bytes(damaged)
    rc = cli.main(["serve", str(p), "--resilient"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "skipped" in err
    rc = cli.main(["serve", str(p), "--resilient", "--packed"])
    assert rc == 2

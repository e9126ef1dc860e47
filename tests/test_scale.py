"""Device-side box downscale (ops/scale.py) and its pipeline plumbing.

Semantics: per channel, each output pixel is the round-half-up mean of an
f x f input box — verified against the NumPy oracle and against scaling
the full-resolution decode on the host.
"""
import numpy as np
import pytest

from conftest import make_test_frames
from mjpeg423_tpu.codec import encoder
from mjpeg423_tpu.ops import scale as S
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig


@pytest.fixture(scope="module")
def rng_mod():
    return np.random.default_rng(31)


@pytest.fixture(scope="module")
def stream(rng_mod):
    frames = make_test_frames(rng_mod, num_frames=13, h=48, w=64)
    return encoder.encode_frames(frames, max_i_interval=5)


@pytest.fixture(scope="module")
def full(stream):
    return DecodePipeline(DecodeConfig(frames_per_batch=5)).decode_array(
        stream
    )


def test_downscale_raster_matches_oracle(rng_mod):
    import jax.numpy as jnp

    x = rng_mod.integers(0, 2**32, size=(3, 16, 24), dtype=np.uint32)
    for f in (2, 4, 8):
        got = np.asarray(S.downscale_raster(jnp.asarray(x), f))
        np.testing.assert_array_equal(got, S.downscale_raster_host(x, f))


def test_bad_factor_raises(rng_mod):
    x = np.zeros((1, 8, 8), np.uint32)
    with pytest.raises(ValueError, match="scale"):
        S.downscale_raster_host(x, 3)
    with pytest.raises(ValueError, match="scale"):
        S.downscale_raster_host(x, 16)


@pytest.mark.parametrize("latency", [False, True])
def test_decode_scaled(stream, full, latency):
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=5))
    got = pipe.decode_array(stream, scale=2, latency=latency)
    np.testing.assert_array_equal(got, S.downscale_raster_host(full, 2))


def test_decode_streams_scaled(stream, full):
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    a, b = pipe.decode_streams_arrays([stream, stream], scale=4)
    want = S.downscale_raster_host(full, 4)
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(b, want)


def test_thumbs_scaled(stream, full):
    from mjpeg423_tpu.core import format as fmt

    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
    idx, thumbs = pipe.decode_iframes_array(stream, scale=2)
    want = S.downscale_raster_host(full, 2)
    np.testing.assert_array_equal(thumbs, want[idx])
    ix = fmt.index_frames(stream)
    np.testing.assert_array_equal(idx, np.flatnonzero(ix.is_iframe))


def test_pool_packed_scaled(stream, full):
    from mjpeg423_tpu.runtime.serve import StreamPool

    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    got: dict = {}

    def sink(si, win):
        got.setdefault(si, {})[win.start_frame] = win.frames

    stats = pool.decode_all_packed(
        [stream, stream], sink=sink, iframes_only=True, scale=2
    )
    want = S.downscale_raster_host(full, 2)
    from mjpeg423_tpu.core import format as fmt

    iidx = np.flatnonzero(fmt.index_frames(stream).is_iframe)
    assert stats.frames == 2 * len(iidx)
    for si in (0, 1):
        frames = np.concatenate(
            [got[si][k] for k in sorted(got[si])]
        )
        np.testing.assert_array_equal(frames, want[iidx])


def test_scale_rejected_on_mesh(stream):
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    pipe = DecodePipeline(DecodeConfig(frames_per_batch=4), mesh=mesh)
    with pytest.raises(ValueError, match="single-device"):
        next(pipe.decode(stream, scale=2))


# ----- scale through the live + interactive-play paths -------------------


def test_decode_live_scaled(stream, full):
    from mjpeg423_tpu.runtime.live import decode_live_array

    got = decode_live_array(
        iter([stream[:97], stream[97:1001], stream[1001:]]),
        config=DecodeConfig(frames_per_batch=4),
        scale=2,
    )
    np.testing.assert_array_equal(got, S.downscale_raster_host(full, 2))


def test_decode_live_bad_scale_fails_fast(stream):
    from mjpeg423_tpu.runtime.live import decode_live

    consumed = []

    def src():
        consumed.append(1)  # a bad scale must raise BEFORE any read
        yield stream

    with pytest.raises(ValueError, match="scale"):
        next(decode_live(src(), config=DecodeConfig(), scale=3))
    assert not consumed


def test_player_play_scaled_with_midplay_seek(stream, full):
    """Proxy playback stays downscaled across a mid-play restart (the
    seek command tears down and recreates the decode generator, which
    must keep scale=)."""
    from mjpeg423_tpu.core import format as fmt
    from mjpeg423_tpu.runtime.playback import Player

    player = Player(stream, DecodeConfig(frames_per_batch=4))
    want = S.downscale_raster_host(full, 2)
    gop1 = int(fmt.index_frames(stream).gop_starts()[1])
    got = {}

    def sink(fi, frame):
        got[fi] = frame
        if fi == 0:
            player.request_seek(gop1 + 1)  # restart mid-play

    stats = player.play(sink=sink, paced=False, scale=2)
    assert stats.frames_delivered == 1 + (full.shape[0] - gop1)
    for fi, frame in got.items():
        np.testing.assert_array_equal(frame, want[fi])


def test_player_play_bad_scale_raises(stream):
    from mjpeg423_tpu.runtime.playback import Player

    player = Player(stream, DecodeConfig(frames_per_batch=4))
    with pytest.raises(ValueError, match="scale"):
        player.play(paced=False, scale=5)


def test_play_live_scaled(stream, full):
    from mjpeg423_tpu.runtime.playback import play_live

    want = S.downscale_raster_host(full, 4)
    got = {}
    stats = play_live(
        iter([stream]),
        sink=lambda fi, fr: got.__setitem__(fi, fr),
        paced=False,
        config=DecodeConfig(frames_per_batch=4),
        scale=4,
    )
    assert stats.frames_delivered == full.shape[0]
    for fi, frame in got.items():
        np.testing.assert_array_equal(frame, want[fi])

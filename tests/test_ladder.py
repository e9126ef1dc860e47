"""The BASELINE.json config ladder, verified end-to-end.

  1. 320x240 I-frame-only clip decoded to RGB (bit-exact vs reference C decoder)
  2. 320x240 I+P (delta reconstruction) end-to-end
  3. 640x480 multi-GOP stream, batched block transform on one device
  4. 1080p-equivalent synthetic stream, GOP-sharded across devices (virtual mesh)
  5. Multi-host / concurrent streams: tests/test_multiprocess.py (2 real
     jax.distributed processes) + the StreamPool concurrency test here.
"""
import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.core.format import parse_file
from mjpeg423_tpu.parallel import decode_transform_sharded, make_mesh, shard_inputs
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.runtime.serve import StreamPool
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames
from oracle.harness import Oracle, oracle_available

needs_oracle = pytest.mark.skipif(
    not oracle_available(), reason="reference oracle unavailable"
)


@needs_oracle
def test_ladder_1_qvga_i_only():
    rng = np.random.default_rng(1)
    frames = make_test_frames(rng, num_frames=4, h=240, w=320)
    data = encoder.encode_frames_device(frames, max_i_interval=1)  # all I
    mpg = parse_file(data)
    assert all(f.is_iframe for f in mpg.frames)
    got = DecodePipeline(DecodeConfig()).decode_array(data)
    ref = Oracle().decode(data, 4, 320, 240).astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


@needs_oracle
def test_ladder_2_qvga_ip():
    rng = np.random.default_rng(2)
    frames = make_test_frames(rng, num_frames=8, h=240, w=320)
    data = encoder.encode_frames_device(frames, max_i_interval=4)
    mpg = parse_file(data)
    assert any(not f.is_iframe for f in mpg.frames)  # P frames present
    got = DecodePipeline(DecodeConfig()).decode_array(data)
    ref = Oracle().decode(data, 8, 320, 240).astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


@needs_oracle
def test_ladder_3_vga_multigop():
    rng = np.random.default_rng(3)
    frames = make_test_frames(rng, num_frames=10, h=480, w=640)
    data = encoder.encode_frames_device(frames, max_i_interval=4)
    mpg = parse_file(data)
    assert len(mpg.trailer) >= 2  # multiple GOPs
    got = DecodePipeline(
        DecodeConfig(frames_per_batch=4)
    ).decode_array(data)
    ref = Oracle().decode(data, 10, 640, 480).astype(np.uint32)
    np.testing.assert_array_equal(got, ref)


def test_ladder_4_1080p_gop_sharded():
    # 1080p-equivalent geometry, frames GOP-sharded over the 8-device mesh
    # (synthetic amplitudes; oracle cross-check at this size is covered by
    # smaller ladder rungs — here we verify the sharded path against the
    # single-device XLA transform).
    from mjpeg423_tpu.ops import transform_jax

    f, bh, bw = 8, 136, 240
    b = bh * bw
    rng = np.random.default_rng(4)
    amps = np.zeros((3, f, b, 64), dtype=np.int16)
    amps[..., :6] = rng.integers(-48, 48, size=(3, f, b, 6))
    seg = np.zeros(f, dtype=bool)
    seg[[0, 4]] = True
    want = np.asarray(
        transform_jax.decode_transform(
            amps[0], amps[1], amps[2], seg, blocks_h=bh, blocks_w=bw
        )
    )
    mesh = make_mesh(n_data=8, n_block=1)
    args = shard_inputs(mesh, amps[0], amps[1], amps[2], seg)
    got = decode_transform_sharded(
        *args, mesh=mesh, blocks_h=bh, blocks_w=bw
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_ladder_5_concurrent_streams():
    rng = np.random.default_rng(5)
    streams, oracles = [], []
    for k in range(3):
        fr = make_test_frames(rng, num_frames=5, h=48, w=64)
        d = encoder.encode_frames(fr, max_i_interval=3)
        streams.append(d)
        oracles.append(decoder.decode_stream_array(d))
    got = {}
    pool = StreamPool(DecodeConfig(frames_per_batch=3))
    stats = pool.decode_all(
        streams,
        sink=lambda si, win: got.setdefault(si, {}).update(
            {win.start_frame + j: win.frames[j] for j in range(win.count)}
        ),
    )
    assert stats.frames == 15
    for si, want in enumerate(oracles):
        for fi in range(want.shape[0]):
            np.testing.assert_array_equal(got[si][fi], want[fi])


@needs_oracle
def test_ladder_6_1080p_multi_gop_vs_oracle():
    """A real (short) 1080p multi-GOP container, byte-compared against the
    compiled reference C decoder through BOTH the single-device pipeline and
    the GOP-aligned sharded path (VERDICT r1: the 1080p rung previously only
    met transform_jax, never the oracle)."""
    from mjpeg423_tpu.parallel import decode_stream_sharded

    rng = np.random.default_rng(10)
    w, h, nf = 1920, 1088, 6
    frames = make_test_frames(rng, num_frames=nf, h=h, w=w)
    data = encoder.encode_frames_device(frames, max_i_interval=3)
    mpg = parse_file(data)
    assert len(mpg.trailer) >= 2  # multi-GOP

    ref = Oracle().decode(data, nf, w, h).astype(np.uint32)

    got = DecodePipeline(
        DecodeConfig(frames_per_batch=4)
    ).decode_array(data)
    np.testing.assert_array_equal(got, ref)

    mesh = make_mesh(n_data=2, n_block=1)
    got_sharded = np.asarray(decode_stream_sharded(data, mesh))
    np.testing.assert_array_equal(got_sharded, ref)

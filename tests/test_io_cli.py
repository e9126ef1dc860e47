"""BMP I/O, stream reader, profiler, and CLI round-trips."""
import json
import os

import numpy as np
import pytest

from mjpeg423_tpu import cli
from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.io import bmp
from mjpeg423_tpu.io.reader import StreamReader
from mjpeg423_tpu.utils.profile import Profiler

from conftest import make_test_frames


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(9)
    frames = make_test_frames(rng, num_frames=10, h=32, w=48)
    data = encoder.encode_frames(frames, max_i_interval=4)
    return data, frames


def test_bmp32_roundtrip(tmp_path, rng):
    packed = rng.integers(0, 2**24, size=(16, 24)).astype(np.uint32)
    path = str(tmp_path / "t.bmp")
    bmp.write_bmp32(path, packed)
    rgb = bmp.read_bmp(path)
    np.testing.assert_array_equal(rgb, bmp.packed_to_rgb(packed))
    np.testing.assert_array_equal(bmp.rgb_to_packed(rgb), packed & 0xFFFFFF)


def test_stream_reader_gops_cover_stream(stream):
    data, _ = stream
    reader = StreamReader(data)
    chunks = list(reader.iter_gops())
    total = sum(c.num_frames for c in chunks)
    assert total == reader.num_frames
    assert [c.start_frame for c in chunks] == reader.gop_starts
    # Every chunk starts with an I-frame.
    for c in chunks:
        assert c.frames[0].is_iframe


def test_stream_reader_seek(stream):
    data, _ = stream
    reader = StreamReader(data)
    starts = reader.gop_starts
    chunks = list(reader.iter_gops(start_gop=1))
    assert chunks[0].start_frame == starts[1]


def test_profiler_aggregates():
    p = Profiler()
    with p.time("x"):
        pass
    p.probe("y").add(2.0)
    p.probe("y").add(4.0)
    rep = p.report()
    assert rep["y"]["count"] == 2
    assert rep["y"]["total"] == 6.0
    assert rep["y"]["max"] == 4.0
    assert "x" in p.format_report()


def test_cli_info_decode_encode_roundtrip(tmp_path, stream, capsys):
    data, _frames = stream
    mpg = str(tmp_path / "in.mpg")
    with open(mpg, "wb") as f:
        f.write(data)

    assert cli.main(["info", mpg]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["num_frames"] == 10
    assert meta["iframe_count_check"] == meta["num_iframes"]

    outdir = str(tmp_path / "out")
    assert cli.main(["decode", mpg, "-o", outdir]) == 0
    files = sorted(os.listdir(outdir))
    assert len(files) == 10

    # BMP output matches the oracle decode exactly.
    want = decoder.decode_stream_array(data)
    got0 = bmp.read_bmp(os.path.join(outdir, files[0]))
    np.testing.assert_array_equal(got0, bmp.packed_to_rgb(want[0]))

    # Re-encode the decoded BMPs and decode again: stable (already quantized).
    out2 = str(tmp_path / "re.mpg")
    assert cli.main([
        "encode", *[os.path.join(outdir, f) for f in files], "-o", out2,
        "--max-i-interval", "4",
    ]) == 0
    assert os.path.getsize(out2) > 0


def test_cli_serve(tmp_path, stream, capsys):
    data, _ = stream
    paths = []
    for k in range(2):
        p = str(tmp_path / f"s{k}.mpg")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    assert cli.main(["serve", *paths]) == 0


def test_cli_play_unpaced(tmp_path, stream, capsys):
    data, _ = stream
    mpg = str(tmp_path / "p.mpg")
    with open(mpg, "wb") as f:
        f.write(data)
    assert cli.main(["play", mpg, "--no-pace"]) == 0


def test_cli_selftest():
    assert cli.main(["selftest", "--frames", "4"]) == 0


def test_player_state_snapshot(stream):
    from mjpeg423_tpu.runtime import Player
    from mjpeg423_tpu.utils.config import DecodeConfig

    data, _ = stream
    player = Player(data, DecodeConfig())
    player.current_frame = 6
    st = player.get_state()
    player2 = Player(data, DecodeConfig())
    player2.set_state(st)
    # Snaps to the GOP's I-frame at or before frame 6.
    assert player2.current_frame in player2.index.gop_starts()
    assert player2.current_frame <= 6


def test_serve_retry_commits_once(stream):
    from mjpeg423_tpu.runtime.serve import StreamPool
    from mjpeg423_tpu.utils.config import DecodeConfig

    data, want_frames = stream
    calls = {"n": 0}
    pool = StreamPool(DecodeConfig(frames_per_batch=4))
    orig = pool.pipeline.decode

    def flaky(d, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected fault")
        return orig(d, **kw)

    pool.pipeline.decode = flaky
    stats = pool.decode_all([data], retries=1)
    assert stats.frames == 10  # counted once despite the retry


def test_cli_play_playlist(tmp_path, stream, capsys):
    data, _ = stream
    paths = []
    for k in range(2):
        p = str(tmp_path / f"pl{k}.mpg")
        with open(p, "wb") as f:
            f.write(data)
        paths.append(p)
    assert cli.main(["play", *paths, "--no-pace"]) == 0
    err = capsys.readouterr().err
    assert "playlist total: 20 frames" in err


def test_cli_play_out_dir_matches_decode(tmp_path, stream):
    """`play --out DIR` delivers frames to numbered BMPs that byte-match
    the decode output (VERDICT r2 #4: playback must deliver pixels — the
    framebuffer/HDMI path, ece423_vid_ctl.c:96-116)."""
    data, _ = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    outdir = str(tmp_path / "played")
    assert cli.main(
        ["play", mpg, "--no-pace", "--out", outdir]
    ) == 0
    want = decoder.decode_stream_array(data)
    files = sorted(os.listdir(outdir))
    assert files == [f"frame_{i:06d}.bmp" for i in range(10)]
    for i, name in enumerate(files):
        got = bmp.rgb_to_packed(bmp.read_bmp(os.path.join(outdir, name)))
        np.testing.assert_array_equal(got, want[i] & 0xFFFFFF)


def test_cli_play_out_ppm(tmp_path, stream):
    data, _ = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    outdir = str(tmp_path / "ppm")
    assert cli.main(
        ["play", mpg, "--no-pace", "--out", outdir,
         "--out-format", "ppm"]
    ) == 0
    want = decoder.decode_stream_array(data)
    got = bmp.read_ppm(os.path.join(outdir, "frame_000003.ppm"))
    np.testing.assert_array_equal(got, bmp.packed_to_rgb(want[3]))


def test_cli_play_pipe(tmp_path, stream, monkeypatch):
    """`play --pipe` streams raw little-endian BGRX words on stdout —
    the `ffplay -f rawvideo` delivery path."""
    import io as _io

    data, frames = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    buf = _io.BytesIO()
    monkeypatch.setattr(
        "sys.stdout",
        type("W", (), {"buffer": buf, "write": lambda s, t: None,
                       "flush": lambda s: None})(),
    )
    assert cli.main(
        ["play", mpg, "--no-pace", "--pipe"]
    ) == 0
    want = decoder.decode_stream_array(data)
    raw = np.frombuffer(buf.getvalue(), dtype="<u4")
    np.testing.assert_array_equal(raw.reshape(want.shape), want)


def test_cli_play_out_pipe_exclusive(tmp_path, stream):
    data, _ = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    with pytest.raises(SystemExit):
        cli.main(["play", mpg, "--no-pace",
                  "--out", str(tmp_path / "x"), "--pipe"])


def test_cli_play_interactive_keys(tmp_path, stream, monkeypatch):
    """Piped key input drives the interactive player: pause toggles twice,
    FF, then quit — exits cleanly."""
    import io

    from mjpeg423_tpu import cli

    data, _ = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    monkeypatch.setattr("sys.stdin", io.StringIO("p p f q"))
    assert cli.main(
        ["play", mpg, "--no-pace", "--interactive"]
    ) == 0


@pytest.mark.skipif(not hasattr(os, "openpty"), reason="pty required")
def test_cli_play_interactive_tty(tmp_path, stream):
    """Drive `play --interactive` under a REAL pty (VERDICT r2 #6): the
    stdin key loop runs in cbreak mode, pause/resume/FF land mid-play,
    `q` ends a playlist that would otherwise loop for minutes, and the
    tty state is restored on exit (key_controls.c:15-72 analog)."""
    import pty
    import subprocess
    import sys as _sys
    import termios
    import time as _time

    data, _ = stream
    mpg = str(tmp_path / "v.mpg")
    open(mpg, "wb").write(data)
    outdir = str(tmp_path / "tty_out")
    master, slave = pty.openpty()
    try:
        attrs_before = termios.tcgetattr(slave)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        # --loop 1000 paced at 24 fps would run ~7 minutes: only the `q`
        # key can end this process inside the timeout.
        proc = subprocess.Popen(
            [_sys.executable, "-m", "mjpeg423_tpu.cli", "play", mpg,
             "--interactive", "--loop", "1000",
             "--out", outdir],
            stdin=slave, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env, text=True,
        )
        # Wait for frames to start landing (play is underway), then drive
        # the keys: pause, resume, FF +5s, quit.
        deadline = _time.time() + 120
        while _time.time() < deadline:
            if os.path.isdir(outdir) and len(os.listdir(outdir)) >= 2:
                break
            if proc.poll() is not None:
                break
            _time.sleep(0.05)
        assert proc.poll() is None, (
            f"player exited early: {proc.communicate()[1]}"
        )
        for key in (b"p", b"p", b"f", b"q"):
            os.write(master, key)
            _time.sleep(0.3)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "keys:" in err  # the banner printed under --interactive
        assert "frames in" in err  # at least one playlist entry reported
        # `q` ended the 1000-loop playlist early.
        assert err.count("v.mpg:") < 1000
        # Frames were delivered while keys were in flight.
        assert len(os.listdir(outdir)) >= 2
        # The child put the pty into cbreak and MUST have restored it.
        attrs_after = termios.tcgetattr(slave)
        assert attrs_after == attrs_before, "tty state not restored"
    finally:
        os.close(master)
        os.close(slave)


def _bmp_file(path, w, h, bpp, compression, palette=None, pixel_bytes=b"",
              masks=None):
    """Hand-assemble a BMP for reader tests."""
    import struct

    pal = b""
    if palette is not None:
        for r, g, b in palette:
            pal += bytes([b, g, r, 0])
    mask_bytes = b""
    if masks is not None:
        mask_bytes = struct.pack("<III", *masks)
    offset = 14 + 40 + len(mask_bytes) + len(pal)
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, bpp, compression,
        len(pixel_bytes), 2835, 2835,
        len(palette) if palette else 0, 0,
    )
    hdr = struct.pack("<2sIHHI", b"BM", offset + len(pixel_bytes), 0, 0, offset)
    with open(path, "wb") as f:
        f.write(hdr + info + mask_bytes + pal + pixel_bytes)


def test_bmp_paletted_8bit(tmp_path):
    # 4x2 8-bpp paletted, bottom-up, rows padded to 4 bytes.
    palette = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (10, 20, 30)]
    rows = bytes([2, 3, 0, 1]) + bytes([0, 1, 2, 3])  # bottom row first
    p = str(tmp_path / "p8.bmp")
    _bmp_file(p, 4, 2, 8, 0, palette, rows)
    img = bmp.read_bmp(p)
    want = np.array([
        [palette[0], palette[1], palette[2], palette[3]],
        [palette[2], palette[3], palette[0], palette[1]],
    ], dtype=np.uint8)
    np.testing.assert_array_equal(img, want)


def test_bmp_paletted_4bit_and_1bit(tmp_path):
    palette4 = [(i * 16, 255 - i * 16, i) for i in range(16)]
    # 3x1 4-bpp: indices 5, 9, 2 -> bytes 0x59, 0x20, pad to 4 bytes
    p = str(tmp_path / "p4.bmp")
    _bmp_file(p, 3, 1, 4, 0, palette4, bytes([0x59, 0x20, 0, 0]))
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(
        img[0], np.array([palette4[5], palette4[9], palette4[2]], np.uint8)
    )
    # 10x1 1-bpp: bits 1100110011 -> bytes 0xCC, 0xC0, pad
    p1 = str(tmp_path / "p1.bmp")
    _bmp_file(p1, 10, 1, 1, 0, [(0, 0, 0), (255, 255, 255)],
              bytes([0xCC, 0xC0, 0, 0]))
    img1 = bmp.read_bmp(p1)
    bits = [1, 1, 0, 0, 1, 1, 0, 0, 1, 1]
    np.testing.assert_array_equal(img1[0, :, 0], np.array(bits) * 255)


def test_bmp_rle8(tmp_path):
    palette = [(i, i, i) for i in range(256)]
    # 6x2 RLE8 (bottom-up): row0(bottom): run 3x7, abs run 3 (1,2,3), EOL;
    # row1(top): run 6x9, EOB.
    rle = bytes([3, 7, 0, 3, 1, 2, 3, 0, 0, 0, 6, 9, 0, 1])
    p = str(tmp_path / "r8.bmp")
    _bmp_file(p, 6, 2, 8, 1, palette, rle)
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(img[1, :, 0], [7, 7, 7, 1, 2, 3])
    np.testing.assert_array_equal(img[0, :, 0], [9, 9, 9, 9, 9, 9])


def test_bmp_rle4(tmp_path):
    palette = [(i * 17, 0, 0) for i in range(16)]
    # 5x1 RLE4: encoded run 5 pixels alternating 0xA,0xB -> A B A B A; EOB.
    rle = bytes([5, 0xAB, 0, 1])
    p = str(tmp_path / "r4.bmp")
    _bmp_file(p, 5, 1, 4, 2, palette, rle)
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(
        img[0, :, 0], [17 * v for v in (0xA, 0xB, 0xA, 0xB, 0xA)]
    )


def test_bmp_16bpp_555_and_bitfields(tmp_path):
    import struct

    # 2x1 16-bpp 555: (31,0,0)->0x7C00, (0,0,31)->0x001F
    px = struct.pack("<HH", 0x7C00, 0x001F)
    p = str(tmp_path / "b16.bmp")
    _bmp_file(p, 2, 1, 16, 0, None, px)
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(img[0, 0], [255, 0, 0])
    np.testing.assert_array_equal(img[0, 1], [0, 0, 255])
    # 565 BITFIELDS: green max = 0x07E0
    px = struct.pack("<HH", 0x07E0, 0xF800)
    p2 = str(tmp_path / "b565.bmp")
    _bmp_file(p2, 2, 1, 16, 3, None, px, masks=(0xF800, 0x07E0, 0x001F))
    img2 = bmp.read_bmp(p2)
    np.testing.assert_array_equal(img2[0, 0], [0, 255, 0])
    np.testing.assert_array_equal(img2[0, 1], [255, 0, 0])


def test_ppm_roundtrip_and_encode(tmp_path, rng):
    rgb = rng.integers(0, 256, (16, 24, 3)).astype(np.uint8)
    p = str(tmp_path / "f.ppm")
    bmp.write_ppm(p, rgb)
    back = bmp.read_ppm(p)
    np.testing.assert_array_equal(back, rgb)
    assert bmp.read_image(p).shape == (16, 24, 3)


def test_cli_encode_from_ppm(tmp_path):
    rng = np.random.default_rng(6)
    paths = []
    for t in range(3):
        rgb = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
        p = str(tmp_path / f"f{t}.ppm")
        bmp.write_ppm(p, rgb)
        paths.append(p)
    out = str(tmp_path / "o.mpg")
    assert cli.main(["encode", *paths, "-o", out, "--no-device"]) == 0
    got = decoder.decode_stream_array(open(out, "rb").read())
    assert got.shape == (3, 16, 16)


def test_bmp_reader_fuzz_no_crashes(tmp_path):
    """Random and truncated BMPs must raise ValueError (or decode), never
    crash with IndexError/struct errors — the libnsbmp robustness bar."""
    import struct

    rng = np.random.default_rng(31)
    p = str(tmp_path / "fz.bmp")
    for trial in range(200):
        kind = trial % 4
        if kind == 0:        # pure random bytes after a BM magic
            blob = b"BM" + rng.bytes(int(rng.integers(12, 200)))
        else:                # structured header + random payload
            bpp = int(rng.choice([1, 4, 8, 16, 24, 32]))
            comp = int(rng.choice([0, 1, 2, 3]))
            w = int(rng.integers(1, 16))
            h = int(rng.integers(1, 16))
            off = int(rng.integers(0, 200))
            info = struct.pack(
                "<IiiHHIIiiII", 40, w, h, 1, bpp, comp, 0, 0, 0,
                int(rng.integers(0, 300)), 0,
            )
            payload = rng.bytes(int(rng.integers(0, 120)))
            blob = struct.pack(
                "<2sIHHI", b"BM", 54 + len(payload), 0, 0, off
            ) + info + payload
        open(p, "wb").write(blob)
        try:
            bmp.read_bmp(p)
        except ValueError:
            pass  # corrupt input correctly rejected


def test_bmp_32bpp_bitfields_rgba_order(tmp_path):
    """A 32-bpp BITFIELDS BMP with RGBA byte order must honor the masks
    (not assume BGRA)."""
    import struct

    # one pixel: R=10, G=20, B=30 stored as bytes [R,G,B,A]
    px = bytes([10, 20, 30, 0])
    p = str(tmp_path / "bf32.bmp")
    _bmp_file(p, 1, 1, 32, 3, None, px,
              masks=(0x000000FF, 0x0000FF00, 0x00FF0000))
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(img[0, 0], [10, 20, 30])
    # standard BGRA masks give the same answer as the BI_RGB path
    px2 = bytes([30, 20, 10, 0])  # B,G,R,A
    p2 = str(tmp_path / "bf32b.bmp")
    _bmp_file(p2, 1, 1, 32, 3, None, px2,
              masks=(0x00FF0000, 0x0000FF00, 0x000000FF))
    np.testing.assert_array_equal(bmp.read_bmp(p2)[0, 0], [10, 20, 30])


def test_cli_decode_all_devices(tmp_path, stream):
    """decode --all-devices GOP-shards over the virtual mesh; npy output
    is in frame order and bit-exact."""
    data, _src = stream
    want = decoder.decode_stream_array(data)
    mpg = str(tmp_path / "m.mpg")
    open(mpg, "wb").write(data)
    outdir = str(tmp_path / "out")
    assert cli.main([
        "decode", mpg, "-o", outdir, "--npy",
        "--all-devices", "--batch", "3",
    ]) == 0
    arr = np.load(os.path.join(outdir, "frameframes.npy"))
    np.testing.assert_array_equal(arr, want)


def test_cli_info_verify(tmp_path, stream, capsys):
    data, _ = stream
    good = str(tmp_path / "g.mpg")
    open(good, "wb").write(data)
    assert cli.main(["info", good, "--verify"]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["verify"] == "OK"

    # corrupt one plane without breaking the frame chain
    import mjpeg423_tpu.core.format as fmt

    index = fmt.index_frames(data)
    fi = 4
    o = int(index.plane_off[1, fi])
    ln = int(index.plane_len[1, fi])
    bad = bytearray(data)
    bad[o:o + ln] = b"\xff" * ln
    badp = str(tmp_path / "b.mpg")
    open(badp, "wb").write(bytes(bad))
    assert cli.main(["info", badp, "--verify"]) == 1
    meta = json.loads(capsys.readouterr().out)
    assert meta["verify"]["corrupt"]["frame"] == fi
    assert meta["verify"]["corrupt"]["plane"] == "cb"


def test_bmp_rle8_absolute_run_overshoot(tmp_path):
    """An RLE8 absolute run starting past the row width must clamp like the
    encoded-run path does, not raise a numpy broadcast error (review
    regression: negative slice length)."""
    palette = [(i, i, i) for i in range(256)]
    # 8x1: encoded run of 10 (overshoots the 8-px row), then an absolute
    # run of 4 while x=10 > w, then EOL, EOB.
    rle = bytes([10, 5, 0, 4, 1, 2, 3, 4, 0, 0, 0, 1])
    p = str(tmp_path / "r8over.bmp")
    _bmp_file(p, 8, 1, 8, 1, palette, rle)
    img = bmp.read_bmp(p)
    np.testing.assert_array_equal(img[0, :, 0], [5] * 8)


def test_cli_thumbs(tmp_path, stream, capsys):
    import glob as _glob

    data, _ = stream
    mpg = str(tmp_path / "t.mpg")
    open(mpg, "wb").write(data)
    outdir = str(tmp_path / "thumbs")
    assert cli.main(["thumbs", mpg, "-o", outdir]) == 0
    from mjpeg423_tpu.core import format as fmt

    n_if = int(fmt.index_frames(data).is_iframe.sum())
    assert len(_glob.glob(outdir + "/thumb*.bmp")) == n_if


def test_cli_serve_packed_thumbs(tmp_path, stream, capsys):
    data, _ = stream
    p1 = str(tmp_path / "a.mpg")
    p2 = str(tmp_path / "b.mpg")
    open(p1, "wb").write(data)
    open(p2, "wb").write(data)
    assert cli.main([
        "serve", p1, p2, "--packed", "--thumbs",
    ]) == 0


def test_read_image_png_via_pil(tmp_path):
    """Non-BMP/PPM formats route through PIL when available: a real PNG
    round-trips through encode -> decode."""
    PIL = pytest.importorskip("PIL")  # noqa: F841
    from PIL import Image

    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(rgb).save(p)
    got = bmp.read_image(p)
    np.testing.assert_array_equal(got, rgb)  # PNG is lossless
    # and it flows through the encoder CLI path
    out = str(tmp_path / "x.mpg")
    assert cli.main(["encode", p, p, "-o", out, "--no-device"]) == 0

"""Corruption-resilient decode: GOP skip-and-resync.

The recovery unit is the reference's own (SURVEY §5.3): every I-frame
rebuilds all coefficient state (lossless_decode.c:76-78) and the trailer
addresses every I-frame (playback.c:136-152 seeks them) — so a corrupt
frame costs exactly [frame, next_I) and nothing else.
"""
import numpy as np
import pytest

import mjpeg423_tpu.core.format as fmt
from mjpeg423_tpu.codec import decoder, encoder
from mjpeg423_tpu.runtime import DecodePipeline, RecoveryLog
from mjpeg423_tpu.utils.config import DecodeConfig

from conftest import make_test_frames


def _cfg(**kw):
    kw.setdefault("frames_per_batch", 5)
    return DecodeConfig(**kw)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(17)
    frames = make_test_frames(rng, num_frames=23, h=48, w=64)
    data = encoder.encode_frames(frames, max_i_interval=7)
    want = decoder.decode_stream_array(data)
    index = fmt.index_frames(data)
    # The GOP structure the tests rely on: I-frames at least every 7.
    assert bool(index.is_iframe[0]) and bool(index.is_iframe.sum() >= 3)
    return data, want, index


def corrupt_plane(data: bytes, index: fmt.FrameIndex, frame: int,
                  plane: int = 0) -> bytes:
    """Overwrite one plane's bitstream with garbage the parser REJECTS.

    Different patterns trip different checks (zig-zag overrun, bitstream
    exhaustion); assert one does — resilience only covers detectable
    corruption (the format has no checksums, same as the reference).
    """
    o = int(index.plane_off[plane, frame])
    l = int(index.plane_len[plane, frame])
    assert l > 0
    probe = DecodePipeline(_cfg())
    for pattern in (b"\xff", b"\xf1", b"\x9f\xff", b"\x7f\xf8"):
        trial = bytearray(data)
        trial[o:o + l] = (pattern * (l // len(pattern) + 1))[:l]
        trial = bytes(trial)
        try:
            probe.parse_window(trial, fmt.index_frames(trial), frame, 1)
        except ValueError:
            return trial
    raise AssertionError("no corruption pattern tripped the parser")


def next_iframe_after(index: fmt.FrameIndex, f: int) -> int:
    nz = np.flatnonzero(index.is_iframe[f + 1:])
    return f + 1 + int(nz[0]) if nz.size else index.num_frames


class TestCleanStream:
    def test_matches_strict_decode(self, stream):
        data, want, _ = stream
        pipe = DecodePipeline(_cfg())
        rec = RecoveryLog()
        got, rec2 = pipe.decode_resilient_array(data, recovery=rec)
        assert rec2 is rec
        np.testing.assert_array_equal(got, want)
        assert rec.skipped == [] and rec.resyncs == 0

    def test_mesh_rejected(self, stream):
        data, _, _ = stream
        pipe = DecodePipeline(_cfg())
        pipe.mesh = object()
        with pytest.raises(ValueError, match="single-device"):
            list(pipe.decode_resilient(data))


class TestPlaneCorruption:
    def test_mid_gop_p_frame(self, stream):
        data, want, index = stream
        bad_f = 9
        assert not index.is_iframe[bad_f]
        nxt = next_iframe_after(index, bad_f)
        corrupt = corrupt_plane(data, index, bad_f)

        # Strict decode refuses the stream outright...
        pipe = DecodePipeline(_cfg())
        with pytest.raises(ValueError):
            pipe.decode_array(corrupt)
        # ...resilient decode delivers everything outside [bad_f, next_I).
        got, rec = pipe.decode_resilient_array(corrupt, fill=7)
        assert rec.skipped == [(bad_f, nxt)]
        assert rec.resyncs == 1
        assert rec.frames_skipped == nxt - bad_f
        np.testing.assert_array_equal(got[:bad_f], want[:bad_f])
        np.testing.assert_array_equal(got[nxt:], want[nxt:])
        assert (got[bad_f:nxt] == 7).all()

    def test_corrupt_iframe_skips_to_next(self, stream):
        data, want, index = stream
        gops = index.gop_starts()
        bad_f = gops[1]
        nxt = next_iframe_after(index, bad_f)
        corrupt = corrupt_plane(data, index, bad_f, plane=1)
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(corrupt)
        assert rec.skipped == [(bad_f, nxt)]
        np.testing.assert_array_equal(got[:bad_f], want[:bad_f])
        np.testing.assert_array_equal(got[nxt:], want[nxt:])

    def test_corrupt_tail_gop(self, stream):
        data, want, index = stream
        nf = index.num_frames
        bad_f = nf - 1
        corrupt = corrupt_plane(data, index, bad_f, plane=2)
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(corrupt)
        assert rec.skipped == [(bad_f, nf)]
        np.testing.assert_array_equal(got[:bad_f], want[:bad_f])

    def test_two_corrupt_gops(self, stream):
        data, want, index = stream
        f1, f2 = 2, 16
        assert not index.is_iframe[f1] and not index.is_iframe[f2]
        n1, n2 = next_iframe_after(index, f1), next_iframe_after(index, f2)
        corrupt = corrupt_plane(data, index, f1)
        corrupt = corrupt_plane(corrupt, index, f2)
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(corrupt)
        assert rec.skipped == [(f1, n1), (f2, n2)]
        assert rec.resyncs == 2
        np.testing.assert_array_equal(got[:f1], want[:f1])
        np.testing.assert_array_equal(got[n1:f2], want[n1:f2])
        np.testing.assert_array_equal(got[n2:], want[n2:])


class TestChainCorruption:
    def _smash_frame_size(self, data: bytes, index: fmt.FrameIndex,
                          frame: int) -> bytes:
        # The frame header sits FRAME_HEADER_BYTES before its Y-plane bytes.
        hdr_off = int(index.plane_off[0, frame]) - fmt.FRAME_HEADER_BYTES
        trial = bytearray(data)
        trial[hdr_off:hdr_off + 4] = b"\xff\xff\xff\xff"
        return bytes(trial)

    def test_resilient_index_resyncs_at_trailer(self, stream):
        data, _, index = stream
        bad_f = 9
        nxt = next_iframe_after(index, bad_f)
        corrupt = self._smash_frame_size(data, index, bad_f)
        with pytest.raises(ValueError):
            fmt.index_frames(corrupt)
        rindex, bad = fmt.index_frames_resilient(corrupt)
        assert bad == [(bad_f, nxt)]
        # Bad rows are zeroed non-I rows; good rows match the clean index.
        assert not rindex.is_iframe[bad_f:nxt].any()
        assert (rindex.plane_len[:, bad_f:nxt] == 0).all()
        np.testing.assert_array_equal(
            rindex.plane_off[:, nxt:], index.plane_off[:, nxt:]
        )
        np.testing.assert_array_equal(
            rindex.frame_type[:bad_f], index.frame_type[:bad_f]
        )

    def test_decode_skips_broken_chain(self, stream):
        data, want, index = stream
        bad_f = 9
        nxt = next_iframe_after(index, bad_f)
        corrupt = self._smash_frame_size(data, index, bad_f)
        pipe = DecodePipeline(_cfg())
        with pytest.raises(ValueError):
            pipe.decode_array(corrupt)
        got, rec = pipe.decode_resilient_array(corrupt)
        assert rec.skipped == [(bad_f, nxt)]
        np.testing.assert_array_equal(got[:bad_f], want[:bad_f])
        np.testing.assert_array_equal(got[nxt:], want[nxt:])

    def test_parse_valid_rewrite_caught_at_anchor(self, stream):
        """frame_size rewritten to land on a LATER genuine frame header:
        the chain walks clean but misaligned; the trailer cross-check must
        catch it at the next I-frame and never deliver wrong bytes under
        wrong indices (the ADVICE round-2 medium finding)."""
        data, want, index = stream
        bad_f = 9  # P-frame inside GOP [7, 14)
        assert not index.is_iframe[bad_f]
        hdr = int(index.plane_off[0, bad_f]) - fmt.FRAME_HEADER_BYTES
        next_hdr = int(index.plane_off[0, bad_f + 2]) - fmt.FRAME_HEADER_BYTES
        trial = bytearray(data)
        # New size swallows frame bad_f+1: every later row shifts one frame.
        import struct
        trial[hdr:hdr + 4] = struct.pack("<I", next_hdr - hdr)
        trial = bytes(trial)

        gop = max(g for g in index.gop_starts() if g <= bad_f)
        nxt = next_iframe_after(index, bad_f)
        rindex, bad = fmt.index_frames_resilient(trial)
        assert bad == [(gop, nxt)]
        np.testing.assert_array_equal(
            rindex.plane_off[:, nxt:], index.plane_off[:, nxt:]
        )
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(trial, fill=3)
        assert rec.skipped == [(gop, nxt)]
        np.testing.assert_array_equal(got[:gop], want[:gop])
        np.testing.assert_array_equal(got[nxt:], want[nxt:])
        assert (got[gop:nxt] == 3).all()

    def test_parse_valid_rewrite_in_tail_gop(self, stream):
        """Same damage class in the LAST GOP (no next anchor): the
        end-of-walk payload-boundary check must invalidate the tail."""
        data, want, index = stream
        nf = index.num_frames
        bad_f = nf - 1
        last_i = max(g for g in index.gop_starts() if g <= bad_f)
        hdr = int(index.plane_off[0, bad_f]) - fmt.FRAME_HEADER_BYTES
        import struct
        fsize, ftyp, ysz, cbsz = struct.unpack_from("<4I", data, hdr)
        new_size = fmt.FRAME_HEADER_BYTES + ysz + cbsz  # drop Cr + pad
        assert new_size < fsize
        trial = bytearray(data)
        trial[hdr:hdr + 4] = struct.pack("<I", new_size)
        trial = bytes(trial)

        rindex, bad = fmt.index_frames_resilient(trial)
        assert bad == [(last_i, nf)]
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(trial, fill=5)
        assert rec.skipped == [(last_i, nf)]
        np.testing.assert_array_equal(got[:last_i], want[:last_i])
        assert (got[last_i:] == 5).all()

    def test_trailer_damage_with_intact_chain(self, stream):
        """A damaged trailer POSITION with an intact chain: the tiebreak
        (no parseable I-frame header at the trailer's offset) must trust
        the chain and deliver everything byte-exact."""
        data, want, index = stream
        hdr = index.header
        toff = (
            fmt.FILE_HEADER_BYTES + hdr.payload_size
            + fmt.TRAILER_ENTRY_BYTES + 4  # entry 1's frame_position field
        )
        trial = bytearray(data)
        trial[toff:toff + 4] = b"\xfe\xff\xff\xff"
        trial = bytes(trial)
        rindex, bad = fmt.index_frames_resilient(trial)
        assert bad == []
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(trial)
        assert rec.skipped == []
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("entry", [2, "last"])
    def test_trailer_index_rewrite_with_intact_chain(self, stream, entry):
        """A trailer entry's frame_INDEX rewritten to another in-range
        value while the chain is intact.  The position still holds a
        genuine I-frame header (it is one — just not that frame's), so
        tiebreak 1 cannot catch it; the chain-corroboration walk must
        (against the next anchor for a middle entry, against the
        payload-end boundary for the last one) — else good rows get
        invalidated and later frames are delivered under earlier indices.
        """
        if entry == "last":
            # The LAST entry has no later anchor: corroboration must use
            # the payload-end boundary.  Static frames make P always win,
            # so I-frames land exactly every max_i_interval and the last
            # GOP is multi-frame.
            rng = np.random.default_rng(5)
            frames = make_test_frames(rng, num_frames=17, h=48, w=64,
                                      motion=False)
            data = encoder.encode_frames(frames, max_i_interval=5)
            want = decoder.decode_stream_array(data)
            index = fmt.index_frames(data)
        else:
            data, want, index = stream
        hdr = index.header
        n_entries = len(index.trailer)
        ei = n_entries - 1 if entry == "last" else entry
        assert 0 < ei < n_entries
        true_fi = index.trailer[ei].frame_index
        prev_fi = index.trailer[ei - 1].frame_index
        assert true_fi - prev_fi >= 2, "need an in-between index to fake"
        fake_fi = true_fi - 1  # in-range, between the two anchors
        toff = (
            fmt.FILE_HEADER_BYTES + hdr.payload_size
            + ei * fmt.TRAILER_ENTRY_BYTES  # entry's frame_index field
        )
        trial = bytearray(data)
        trial[toff:toff + 4] = int(fake_fi).to_bytes(4, "little")
        trial = bytes(trial)
        rindex, bad = fmt.index_frames_resilient(trial)
        assert bad == []
        pipe = DecodePipeline(_cfg())
        got, rec = pipe.decode_resilient_array(trial)
        assert rec.skipped == []
        np.testing.assert_array_equal(got, want)

    def test_unrecoverable_frame0_raises(self, stream):
        data, _, index = stream
        corrupt = self._smash_frame_size(data, index, 0)
        # Kill every trailer resync target too: claim zero I-frames.
        hdr = fmt.FileHeader.unpack(corrupt)
        broken = fmt.FileHeader(
            hdr.num_frames, hdr.width, hdr.height, 0, hdr.payload_size
        )
        corrupt = broken.pack() + corrupt[fmt.FILE_HEADER_BYTES:]
        with pytest.raises(ValueError):
            fmt.index_frames_resilient(corrupt)


class TestCorruptionCampaign:
    """Randomized payload corruption: invariants that hold even when the
    damage parses "validly" (the format has no checksums, so a bit flip
    inside VLI amplitude bits decodes to garbage undetected):

      * frames strictly BEFORE the damaged frame are byte-exact;
      * every frame at/after the next I-frame following the damage is
        byte-exact OR inside a reported skipped range (I-frames rebuild
        all state, so garbage cannot outlive its GOP);
      * skipped ranges are sorted, disjoint, in bounds;
      * the only acceptable exception is ValueError.
    """

    def test_random_plane_and_header_corruption(self, stream):
        data, want, index = stream
        nf = index.num_frames
        # Frame-header byte offsets, for mapping a corrupted byte -> frame.
        hdr_offs = [
            int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
            for f in range(nf)
        ]
        payload_end = fmt.FILE_HEADER_BYTES + index.header.payload_size
        rng = np.random.default_rng(423)
        pipe = DecodePipeline(_cfg())
        for round_i in range(30):
            off = int(rng.integers(fmt.FILE_HEADER_BYTES, payload_end))
            n = int(rng.integers(1, 48))
            garbage = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            trial = bytearray(data)
            # Clamp to the payload: the invariants assume an intact trailer.
            end = min(off + n, payload_end)
            trial[off:end] = garbage[: end - off]
            trial = bytes(trial)
            # The damage spans [off, end): the next I-frame must follow the
            # LAST damaged frame, not the first.
            f_bad = max(f for f in range(nf) if hdr_offs[f] <= off)
            f_last = max(f for f in range(nf) if hdr_offs[f] <= end - 1)
            nxt = next_iframe_after(index, f_last)
            try:
                got, rec = pipe.decode_resilient_array(trial, fill=0)
            except ValueError:
                continue  # fail-fast is always acceptable
            skipped = rec.skipped
            assert skipped == sorted(skipped)
            for (a, b), (c, d) in zip(skipped, skipped[1:]):
                assert b < c  # disjoint, non-adjacent after the merge
            assert all(0 <= a < b <= nf for a, b in skipped)
            in_skip = np.zeros(nf, dtype=bool)
            for a, b in skipped:
                in_skip[a:b] = True
            # Frames before the damage: byte-exact or reported skipped (the
            # trailer cross-check invalidates back to the last verified
            # anchor when a parse-valid chain rewrite cannot be localized).
            for g in range(f_bad):
                if not in_skip[g]:
                    np.testing.assert_array_equal(
                        got[g], want[g],
                        err_msg=f"round {round_i}: frame {g} before the "
                                f"damage not skipped yet differs (off={off})",
                    )
            for g in range(nxt, nf):
                if not in_skip[g]:
                    np.testing.assert_array_equal(
                        got[g], want[g],
                        err_msg=f"round {round_i}: frame {g} not skipped "
                                f"yet differs (off={off}, f_last={f_last})",
                    )


def test_cli_resilient(tmp_path, stream):
    data, want, index = stream
    bad_f = 9
    nxt = next_iframe_after(index, bad_f)
    corrupt = corrupt_plane(data, index, bad_f)
    src = tmp_path / "c.mpg"
    src.write_bytes(corrupt)
    out = tmp_path / "out"
    from mjpeg423_tpu import cli

    rc = cli.main([
        "decode", str(src), "-o", str(out), "--resilient",
        "--batch", "5",
    ])
    assert rc == 0
    import os

    made = sorted(os.listdir(out))
    # One BMP per delivered frame; none inside the skipped range.
    assert len(made) == index.num_frames - (nxt - bad_f)
    assert f"frame{bad_f:04d}.bmp" not in made
    assert f"frame{nxt:04d}.bmp" in made


def test_cli_resilient_npy_keeps_frame_alignment(tmp_path, stream):
    """--resilient --npy must keep row i == container frame i (fill skipped
    slots) and save the delivered-index sidecar (ADVICE r2 low)."""
    data, want, index = stream
    bad_f = 9
    nxt = next_iframe_after(index, bad_f)
    corrupt = corrupt_plane(data, index, bad_f)
    src = tmp_path / "c.mpg"
    src.write_bytes(corrupt)
    out = tmp_path / "out"
    from mjpeg423_tpu import cli

    rc = cli.main([
        "decode", str(src), "-o", str(out), "--resilient", "--npy", "--batch", "5",
    ])
    assert rc == 0
    arr = np.load(out / "frameframes.npy")
    delivered = np.load(out / "framedelivered.npy")
    nf = index.num_frames
    assert arr.shape[0] == nf
    assert delivered.tolist() == [
        f for f in range(nf) if not (bad_f <= f < nxt)
    ]
    np.testing.assert_array_equal(arr[:bad_f], want[:bad_f])
    np.testing.assert_array_equal(arr[nxt:], want[nxt:])
    assert (arr[bad_f:nxt] == 0).all()


class TestWindowIndependence:
    @pytest.mark.parametrize("window", [2, 7])
    def test_corrupt_plane_any_window(self, stream, window):
        """Resilient decode at window sizes that split GOPs differently:
        the corrupt GOP range is skipped identically and every delivered
        frame stays bit-exact (recovery keys on frames, not windows)."""
        data, want, index = stream
        bad = corrupt_plane(data, index, frame=9, plane=1)
        pipe = DecodePipeline(_cfg(frames_per_batch=window))
        got, log = pipe.decode_resilient_array(bad)
        ref_pipe = DecodePipeline(_cfg())
        ref, ref_log = ref_pipe.decode_resilient_array(bad)
        np.testing.assert_array_equal(got, ref)
        assert log.skipped == ref_log.skipped
        assert log.frames_skipped > 0  # the corruption was actually hit

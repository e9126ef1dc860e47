"""Streaming decode pipeline: parse stage ∥ device transform ∥ output.

The device re-architecture of the reference's 3-stage dual-core + HW
pipeline (reference: playback.c:80-134 `process`, core1/software/main.c:227-335
message loop):

  Stage A (host threads)  — entropy parse: native C batch decoder over
      (frames x planes) byte ranges indexed straight into the container
      buffer (zero copy; the core1 + Cb/Cr-on-core0 analog).
  Stage B (device)        — one jit-compiled windowed decode step: dequant +
      segmented temporal scan + IDCT/color + raster (transform_jax).  Windows
      of W frames carry the int16 coefficient state of their last frame
      forward, so window boundaries need no GOP alignment — the carry is the
      device-resident analog of the reference's persistent DCAC buffers
      (MPEG_WORKING_BUFFER, mpeg423_decoder_ext.h:35-41).
  Stage C (host)          — device->host transfer + delivery.

Backpressure: bounded queues between stages (the 1-deep OK/DONE mailbox
handshake generalized to N-deep; reference: mailbox.h:8-16).  Async dispatch:
stage B enqueues the next window before the previous transfer completes
(XLA async dispatch = the reference's post-early/join-late mSGDMA pattern,
playback.c:102-121).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np

from ..core import format as fmt
from ..native import centropy
from ..ops import entropy_ref
from ..utils.config import DecodeConfig
from ..utils.profile import Profiler, default_profiler

PLANE_COUNT = 3


class _StageError:
    """Producer-thread exception carried across the stage queue.

    The reference at least spins loudly on a failed read
    (assert_persistent, core1/main.c:154); a silent truncated decode would
    be worse, so parse failures re-raise in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class DecodedWindow:
    """A batch of decoded frames: [start, start + count) of the stream."""

    start_frame: int
    count: int
    frames: np.ndarray  # (W, H, W) uint32 packed BGRA; rows beyond count are pad


@dataclasses.dataclass
class RecoveryLog:
    """decode_resilient's account of what was skipped and where it resynced.

    skipped: [lo, hi) frame ranges dropped (corrupt frame up to the next
    I-frame — P-frames after a corrupt frame depend on its state, so the
    recovery unit is the GOP tail, SURVEY §5.3).  Sorted and merged once
    the generator completes.
    """

    skipped: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    resyncs: int = 0
    # Live resyncs (runtime.live decode_live(resync=True)): one entry per
    # recovery, (delivery index where the feed resumed at an I-frame,
    # bytes discarded while scanning).  Frames lost inside the gap are
    # unknowable without a trailer, so live recovery accounts BYTES, not
    # frame ranges.
    gaps: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def frames_skipped(self) -> int:
        return sum(hi - lo for lo, hi in self.skipped)


class DecodePipeline:
    """End-to-end streaming decoder for one MJPEG423 container.

    With mesh=None (default) the pipeline runs single-device.  Passing a
    jax.sharding.Mesh shards the stream's GOPs across the mesh's "data"
    axis: each device streams its own GOP-aligned frame partition through
    the SAME jit step (shard_map over per-device windows with per-device
    coefficient carry), so the decode step runs on every device
    with zero collectives — the reference's whole architecture (core1
    streaming + core0 consuming, core1/main.c:227-335) at pod scale.
    Windows parse per partition on demand; nothing whole-stream is ever
    materialized.
    """

    def __init__(
        self,
        config: DecodeConfig | None = None,
        profiler: Profiler | None = None,
        mesh=None,
        device=None,
    ):
        self.config = config or DecodeConfig()
        self.profiler = profiler or default_profiler
        self.mesh = mesh
        # Pin this pipeline's device work to one chip (stream-level data
        # parallelism: runtime.serve.StreamPool runs one pinned pipeline
        # per device).  None = the process default device.
        self.device = device
        self._executor: ThreadPoolExecutor | None = None
        self._step_cache: dict = {}

    def _put(self, x):
        """Host array -> device (the mSGDMA feed analog), honoring the pin."""
        import jax
        import jax.numpy as jnp

        if self.device is not None:
            return jax.device_put(x, self.device)
        return jnp.asarray(x)

    # ----- Stage A: host entropy parse ---------------------------------

    def _decode_plane_fn(self):
        if self.config.use_native_entropy and centropy.native_available():
            return None  # use batch API
        return entropy_ref.decode_plane

    def parse_window(
        self, data: bytes, index: fmt.FrameIndex, start: int, count: int,
        frames: np.ndarray | None = None,
    ) -> np.ndarray:
        """Entropy-decode frames [start, start+count).

        frames: an explicit array of frame indices overrides start/count —
        the windows need not be contiguous (decode_iframes batches GOP
        heads this way).

        Returns (3, count, B, 64) int16 amplitudes.
        """
        if frames is None:
            fsel = np.arange(start, start + count)
        else:
            fsel = np.asarray(frames)
            count = len(fsel)
        nb = index.header.blocks_per_plane
        spec = self.config.spec_segments
        with self.profiler.time("parse/window"):
            if spec > 1 and centropy.native_available():
                # Latency mode: speculative intra-plane parallelism (each
                # plane split across `spec` workers; see centropy.c).
                out = np.empty((3, count, nb, 64), dtype=np.int16)
                for p in range(3):
                    for i in range(count):
                        fi = int(fsel[i])
                        o = int(index.plane_off[p, fi])
                        l = int(index.plane_len[p, fi])
                        out[p, i] = centropy.decode_plane_spec(
                            data[o:o + l], nb,
                            bool(index.frame_type[fi]), spec,
                        )
                self.profiler.probe("parse/spec_windows").add(1)
                return out
            if self._decode_plane_fn() is None:
                # One native call over all count*3 plane bitstreams.
                offs = index.plane_off[:, fsel].reshape(-1)
                lens = index.plane_len[:, fsel].reshape(-1)
                is_p = np.broadcast_to(
                    index.frame_type[fsel] != 0, (3, count)
                ).reshape(-1)
                out = centropy.decode_batch(data, offs, lens, is_p, nb)
                return out.reshape(3, count, nb, 64)
            out = np.empty((3, count, nb, 64), dtype=np.int16)
            fn = self._decode_plane_fn()
            for p in range(3):
                for i in range(count):
                    fi = int(fsel[i])
                    o = int(index.plane_off[p, fi])
                    l = int(index.plane_len[p, fi])
                    out[p, i] = fn(
                        data[o:o + l], nb, bool(index.frame_type[fi])
                    )
            return out

    # ----- Stage B: device step ----------------------------------------

    def _get_step(self, blocks_h: int, blocks_w: int):
        """The jit'd window step (transform_jax.decode_window) for one
        geometry: (amps, seg, carry) -> (frames, new_carry)."""
        key = (blocks_h, blocks_w)
        if key not in self._step_cache:
            import functools

            from ..ops import transform_jax

            self._step_cache[key] = functools.partial(
                transform_jax.decode_window,
                blocks_h=blocks_h, blocks_w=blocks_w,
            )
        return self._step_cache[key]

    def _get_downscale(self, blocks_h: int, blocks_w: int, f: int):
        """jit'd device-side box downscale (ops/scale.py): applied to the
        step output BEFORE transfer, so preview/thumbnail egress drops
        f^2 x."""
        from ..ops import scale as _scale

        _scale.check_factor(f)  # fail at the API boundary, not inside jit
        key = ("ds", blocks_h, blocks_w, f)
        if key not in self._step_cache:
            import functools

            import jax

            self._step_cache[key] = jax.jit(
                functools.partial(_scale.downscale_raster, f=f)
            )
        return self._step_cache[key]

    # ----- Full pipeline ------------------------------------------------

    def warmup(self, width: int, height: int) -> None:
        """Pre-compile the device step for a geometry before streams arrive
        (serving cold-start: the first compile of a geometry takes seconds;
        the reference's equivalent is all-at-load init, main.c:141-171).
        Runs one zero-delta window through the step, then discards it.
        """
        import jax
        import numpy as np

        bh, bw = height // 8, width // 8
        nb = bh * bw
        w = self.config.frames_per_batch
        seg = np.zeros(w, dtype=bool)
        seg[0] = True
        amps = np.zeros((3, w, nb, 64), np.int16)
        carry = np.zeros((3, nb, 64), np.int16)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import DATA_AXIS

            n_dev = self.mesh.shape[DATA_AXIS]
            sh = NamedSharding(self.mesh, P(DATA_AXIS))
            step = self._get_mesh_step(bh, bw)
            frames, _ = step(*(
                jax.device_put(np.broadcast_to(x, (n_dev,) + x.shape), sh)
                for x in (amps, seg, carry)
            ))
        else:
            step = self._get_step(bh, bw)
            frames, _ = step(self._put(amps), self._put(seg),
                             self._put(carry))
        frames.block_until_ready()

    def decode(
        self,
        data: bytes,
        start_frame: int = 0,
        stop: Callable[[], bool] | None = None,
        end_frame: int | None = None,
        device_resident: bool = False,
        scale: int = 1,
        latency: bool | None = None,
        _index: fmt.FrameIndex | None = None,
    ) -> Iterator[DecodedWindow]:
        """Decode frames [start_frame, end_frame) , yielding frame windows.

        _index: a prebuilt FrameIndex overriding the container chain walk
        (decode_resilient passes the trailer-resynced index whose bad
        ranges a strict index_frames would refuse; callers must only
        request frames the index actually addresses).

        scale (1, 2, 4 or 8): device-side box downscale before transfer —
        windows carry (H/scale, W/scale) raster frames and egress drops
        scale^2 x (preview scrubbing / proxy playback).  Single-device
        only; with device_resident the on-device windows are raster at
        the reduced size.

        latency (None = config.latency_mode): prioritize the FIRST
        window's delivery over stream throughput — it parses alone,
        dispatches, and is drained before any later window's H2D is
        posted, so the first frame never queues behind prefetch traffic
        (the reference displays the sought frame immediately,
        playback.c:245).  Player.play/seek pass True; the stream reverts
        to fully pipelined decode after that first window.

        start_frame must be an I-frame index (seek targets come from the
        trailer, like the reference — playback.c:136-152).  end_frame
        (default: stream end) bounds the decode — the per-host GOP
        partition case (multihost.local_partition) decodes exactly its
        [frame_lo, frame_hi) range with no wasted tail work.

        device_resident=True yields windows whose .frames is the DEVICE
        array ((W, H, Wd) uint32; rows beyond .count are pad) — zero
        device->host transfer, for consumers that feed the frames straight
        into another on-device computation (examples/device_consumer.py).
        Single-device mode only.

        Note: with mesh=..., windows are yielded in per-step order across
        device partitions, NOT in global frame order; consumers key on
        DecodedWindow.start_frame (decode_array reassembles by index).
        """
        if self.mesh is not None:
            if device_resident:
                raise ValueError(
                    "device_resident decode is single-device (mesh windows "
                    "are sharded; consume them inside shard_map instead)"
                )
            if scale != 1:
                raise ValueError(
                    "scale is single-device; shard downscaled previews via "
                    "StreamPool instead"
                )
            yield from self._decode_mesh(data, start_frame, stop, end_frame)
            return
        cfg = self.config
        latency_first = cfg.latency_mode if latency is None else latency
        index = _index if _index is not None else fmt.index_frames(data)
        hdr = index.header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        nb = hdr.blocks_per_plane
        w = cfg.frames_per_batch
        step = self._get_step(bh, bw)
        downscale = self._get_downscale(bh, bw, scale) if scale != 1 else None

        if start_frame and not index.is_iframe[start_frame]:
            raise ValueError(f"start_frame {start_frame} is not an I-frame")

        nf = hdr.num_frames
        if end_frame is not None:
            nf = min(nf, end_frame)
        windows = [
            (s, min(w, nf - s)) for s in range(start_frame, nf, w)
        ]

        # Stage A prefetch: parse windows ahead on a thread pool.
        workers = cfg.parse_workers or None
        parse_q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_batches, 1))
        stop_flag = threading.Event()

        def _put_or_drop(item) -> bool:
            """Put unless the consumer abandoned the generator (stop set).
            A plain blocking put can deadlock the producer: a data or
            sentinel put that lands AFTER the consumer's final teardown
            drain blocks forever on a full queue nobody reads (observed
            in decode_live's deliverer; same shape here)."""
            while True:
                try:
                    parse_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop_flag.is_set():
                        return False

        def producer():
            err: BaseException | None = None
            try:
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    # Bounded look-ahead: at most max_inflight windows are
                    # parsed ahead of the consumer (completed futures hold
                    # int16 amplitude tensors ~1.5x raw video size, so
                    # submitting everything upfront would buffer the whole
                    # container in host RAM).
                    max_inflight = max(cfg.prefetch_batches, 1) + 2
                    win_iter = iter(windows)
                    futs: list = []

                    def submit_next() -> None:
                        try:
                            s, c = next(win_iter)
                        except StopIteration:
                            return
                        futs.append((s, c, ex.submit(
                            self.parse_window, data, index, s, c,
                        )))

                    # Latency mode: the first window's parse runs with
                    # the whole host to itself; prefetch resumes once it
                    # resolves.
                    for _ in range(1 if latency_first else max_inflight):
                        submit_next()
                    while futs:
                        if stop_flag.is_set():
                            for _, _, f2 in futs:
                                f2.cancel()
                            break
                        s, c, fut = futs.pop(0)
                        res = fut.result()
                        while len(futs) < max_inflight:
                            prev = len(futs)
                            submit_next()
                            if len(futs) == prev:
                                break
                        if not _put_or_drop((s, c, res)):
                            for _, _, f2 in futs:
                                f2.cancel()
                            break
            except BaseException as e:
                err = e
            finally:
                _put_or_drop(_StageError(err) if err is not None else None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        carry = self._put(np.zeros((3, nb, 64), dtype=np.int16))
        pending: list[tuple[int, int, object]] = []
        try:
            while True:
                item = parse_q.get()
                if item is None:
                    break
                if isinstance(item, _StageError):
                    raise item.exc
                s, c, amps = item
                dev_amps = self._put_window(amps, c, w, nb)
                seg = np.zeros(w, dtype=bool)
                seg[: min(c, w)] = index.is_iframe[s:s + c]
                with self.profiler.time("device/dispatch"):
                    frames, carry = step(
                        dev_amps, self._put(seg), carry
                    )
                    if downscale is not None:
                        frames = downscale(frames)
                pending.append((s, c, frames))
                if latency_first and s == start_frame:
                    # Deliver the first window NOW — before any later
                    # window's H2D is posted behind it.
                    yield self._drain(pending.pop(0), device_resident)
                    if stop is not None and stop():
                        stop_flag.set()
                        return
                # The output ring: up to num_output_buffers decoded windows
                # stay device-resident in flight (the N-deep framebuffer
                # ring, ece423_vid_ctl.c:96-116); drain the oldest beyond it.
                ring = max(1, cfg.num_output_buffers)
                while len(pending) > ring:
                    yield self._drain(pending.pop(0), device_resident)
                    if stop is not None and stop():
                        stop_flag.set()
                        return
            while pending:
                yield self._drain(pending.pop(0), device_resident)
                if stop is not None and stop():
                    return
        finally:
            # Unblock the producer if the consumer abandoned the generator
            # mid-stream: it may be parked on a full queue.  Drain, give it a
            # moment to observe the flag, then drain again (it re-checks
            # stop_flag before every put, so at most one more item arrives).
            stop_flag.set()
            for _ in range(2):
                while True:
                    try:
                        parse_q.get_nowait()
                    except queue.Empty:
                        break
                t.join(timeout=1.0)
                if not t.is_alive():
                    break

    # ----- Mesh-sharded streaming (multi-chip pipeline) ------------------

    def _get_mesh_step(self, blocks_h: int, blocks_w: int):
        key = ("mesh", blocks_h, blocks_w)
        if key in self._step_cache:
            return self._step_cache[key]
        import jax
        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        base = self._get_step(blocks_h, blocks_w)

        def body(amps, seg, carry):
            # Leading device axis is 1 inside the shard.
            frames, new_carry = base(amps[0], seg[0], carry[0])
            return frames[None], new_carry[None]

        spec = P(DATA_AXIS)
        step = jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(spec, spec, spec), out_specs=(spec, spec),
        ))
        self._step_cache[key] = step
        return step

    def _decode_mesh(
        self,
        data: bytes,
        start_frame: int = 0,
        stop: Callable[[], bool] | None = None,
        end_frame: int | None = None,
    ) -> Iterator[DecodedWindow]:
        """Sharded streaming decode over the mesh's "data" axis.

        Each device owns a contiguous GOP-aligned frame partition
        (multihost.partition_gops balanced by frame count) and advances
        through it window by window with its own device-resident carry —
        the same step for all devices, one jit dispatch per super-window.
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import BLOCK_AXIS, DATA_AXIS
        from ..parallel.multihost import partition_gops

        mesh = self.mesh
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(f'mesh must have a "{DATA_AXIS}" axis')
        if BLOCK_AXIS in mesh.axis_names and mesh.shape[BLOCK_AXIS] > 1:
            raise ValueError(
                "streaming decode shards GOPs over the data axis only; "
                "use parallel.decode_stream_sharded for block-axis sharding"
            )
        n_dev = mesh.shape[DATA_AXIS]

        cfg = self.config
        index = fmt.index_frames(data)
        hdr = index.header
        bh, bw = hdr.blocks_h, hdr.blocks_w
        nb = hdr.blocks_per_plane
        w = cfg.frames_per_batch
        if start_frame and not index.is_iframe[start_frame]:
            raise ValueError(f"start_frame {start_frame} is not an I-frame")
        nf = hdr.num_frames
        if end_frame is not None:
            nf = min(nf, end_frame)
        gop_starts = [
            g for g in index.gop_starts() if start_frame <= g < nf
        ]
        if not gop_starts or gop_starts[0] != start_frame:
            gop_starts = [start_frame] + gop_starts
        parts = partition_gops(gop_starts, nf, n_dev)
        n_steps = max(
            (p.num_frames + w - 1) // w for p in parts
        ) if any(p.num_frames for p in parts) else 0

        step = self._get_mesh_step(bh, bw)

        def parse_super(t: int):
            """Parse step t's window of every partition -> stacked arrays."""
            amps = np.zeros((n_dev, 3, w, nb, 64), np.int16)
            seg = np.zeros((n_dev, w), dtype=bool)
            spans = []
            for p in parts:
                lo = p.frame_lo + t * w
                cnt = max(0, min(w, p.frame_hi - lo))
                spans.append((lo, cnt))
                if cnt == 0:
                    continue
                # Rows past cnt stay zero deltas: they repeat the last
                # frame and are dropped on yield.
                amps[p.host, :, :cnt] = self.parse_window(data, index, lo, cnt)
                seg[p.host, :cnt] = index.is_iframe[lo:lo + cnt]
            return amps, seg, spans

        # Stage A: bounded producer over super-windows.
        parse_q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch_batches, 1))
        stop_flag = threading.Event()

        def _put_or_drop(item) -> bool:
            """See decode()'s _put_or_drop: a put landing after the
            consumer's final teardown drain must not block forever."""
            while True:
                try:
                    parse_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop_flag.is_set():
                        return False

        def producer():
            err: BaseException | None = None
            try:
                with ThreadPoolExecutor(max_workers=cfg.parse_workers or None) as ex:
                    max_inflight = max(cfg.prefetch_batches, 1) + 1
                    futs: list = []
                    nxt = 0

                    def submit_next():
                        nonlocal nxt
                        if nxt < n_steps:
                            futs.append((nxt, ex.submit(parse_super, nxt)))
                            nxt += 1

                    for _ in range(max_inflight):
                        submit_next()
                    while futs:
                        if stop_flag.is_set():
                            for _, f2 in futs:
                                f2.cancel()
                            break
                        t_, fut = futs.pop(0)
                        res = fut.result()
                        submit_next()
                        if not _put_or_drop(res):
                            for _, f2 in futs:
                                f2.cancel()
                            break
            except BaseException as e:
                err = e
            finally:
                _put_or_drop(_StageError(err) if err is not None else None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()

        dev_sharding = NamedSharding(mesh, P(DATA_AXIS))
        carry = jax.device_put(
            jnp.zeros((n_dev, 3, nb, 64), jnp.int16), dev_sharding
        )

        pending: list[tuple[list, object]] = []

        def drain(item) -> list[DecodedWindow]:
            spans, frames = item
            with self.profiler.time("output/transfer"):
                host = np.asarray(frames)  # gathers all shards
            return [
                DecodedWindow(lo, cnt, host[d, :cnt])
                for d, (lo, cnt) in enumerate(spans)
                if cnt > 0
            ]

        try:
            while True:
                item = parse_q.get()
                if item is None:
                    break
                if isinstance(item, _StageError):
                    raise item.exc
                amps, seg, spans = item
                dev_amps = jax.device_put(amps, dev_sharding)
                dev_seg = jax.device_put(seg, dev_sharding)
                with self.profiler.time("device/dispatch"):
                    frames, carry = step(dev_amps, dev_seg, carry)
                pending.append((spans, frames))
                ring = max(1, cfg.num_output_buffers)
                while len(pending) > ring:
                    for win in drain(pending.pop(0)):
                        yield win
                    if stop is not None and stop():
                        stop_flag.set()
                        return
            while pending:
                for win in drain(pending.pop(0)):
                    yield win
                if stop is not None and stop():
                    return
        finally:
            stop_flag.set()
            for _ in range(2):
                while True:
                    try:
                        parse_q.get_nowait()
                    except queue.Empty:
                        break
                th.join(timeout=1.0)
                if not th.is_alive():
                    break

    def _put_window(self, amps: np.ndarray, c: int, w: int, nb: int):
        """Pad a parsed window to the jit window length (zero deltas repeat
        the last frame; padded rows are dropped at drain) and device_put
        it."""
        if c < w:
            pad = np.zeros((3, w, nb, 64), dtype=np.int16)
            pad[:, :c] = amps
            amps = pad
        return self._put(amps)

    def decode_iframes(
        self, data: bytes, stop: Callable[[], bool] | None = None,
        scale: int = 1,
    ) -> Iterator[tuple[int, np.ndarray]]:
        """Decode ONLY the stream's I-frames (thumbnail / preview strip).

        Every I-frame resets all decoder state (lossless_decode.c:76-78),
        so GOP heads decode with zero carry and batch into full windows —
        a whole archive's preview costs only its I-frame bitstreams (the
        trailer indexes them; the same property the reference exploits for
        seek, playback.c:136-152).  Yields (frame_index, (H, W) uint32
        packed BGRA) in stream order.  Thin wrapper over
        decode_streams([data], iframes_only=True); thumbnail FARMS pass
        many archives to decode_streams directly (or use
        StreamPool.decode_all_packed).
        """
        for _si, fi, frame in self.decode_streams(
            [data], stop=stop, iframes_only=True, scale=scale
        ):
            yield fi, frame

    def decode_streams(
        self,
        datas: Sequence[bytes],
        stop: Callable[[], bool] | None = None,
        iframes_only: bool = False,
        scale: int = 1,
    ) -> Iterator[tuple[int, int, np.ndarray]]:
        """Batch-decode MANY same-geometry containers through ONE window
        stream (the small-clip serving path).

        Frames from consecutive containers pack into shared device windows:
        a window may hold [tail of clip A | all of clip B | head of clip C].
        The temporal recurrence is a SEGMENTED scan, so marking every
        stream's first frame as a segment start resets the coefficient
        state exactly at the seams — a P-first stream decodes as
        0 + delta, identical to its standalone zero-carry decode.  Compared
        to per-stream decode() calls this wastes no window slots on short
        tails and pays one jit dispatch per window, not per clip (the
        reference's NextVideo loop, batched; core1/main.c:166-219).

        iframes_only=True decodes just the GOP heads of every container —
        the thumbnail-farm mode (every selected frame is an I-frame, so all
        windows are pure resets and the carry never contributes).

        Yields (stream_idx, frame_idx, (H, W) uint32 frame)
        in global order.

        scale (1, 2, 4, 8): device-side box downscale before transfer —
        frames come back (H/scale, W/scale) and egress drops scale^2 x
        (ops/scale.py; the thumbnail-farm bandwidth lever).
        """
        if self.mesh is not None:
            raise ValueError(
                "decode_streams is single-device; use StreamPool to spread "
                "clips over chips, or one mesh pipeline per long stream"
            )
        cfg = self.config
        indices = [fmt.index_frames(d) for d in datas]
        if not indices:
            return
        hdr = indices[0].header
        for ix in indices[1:]:
            if (ix.header.width, ix.header.height) != (
                hdr.width, hdr.height,
            ):
                raise ValueError(
                    "decode_streams requires same-geometry containers "
                    f"({ix.header.width}x{ix.header.height} != "
                    f"{hdr.width}x{hdr.height})"
                )
        bh, bw = hdr.blocks_h, hdr.blocks_w
        nb = hdr.blocks_per_plane
        w = cfg.frames_per_batch
        step = self._get_step(bh, bw)
        downscale = self._get_downscale(bh, bw, scale) if scale != 1 else None
        # Global frame list in stream order; each window is a slice of it.
        entries = [
            (si, int(fi))
            for si, ix in enumerate(indices)
            for fi in (
                np.flatnonzero(ix.is_iframe) if iframes_only
                else range(ix.num_frames)
            )
        ]
        carry = self._put(np.zeros((3, nb, 64), np.int16))

        def emit(item):
            ents, c, frames = item
            with self.profiler.time("output/transfer"):
                host = np.asarray(frames)
            for i in range(c):
                si, fi = ents[i]
                yield si, fi, host[i]

        def parse_ents(ents):
            # Per-stream runs inside this window (frame indices may be
            # non-contiguous in iframes_only mode — parse_window takes
            # explicit selections).
            runs: list[tuple[int, list[int]]] = []  # (si, frame indices)
            for si, fi in ents:
                if runs and runs[-1][0] == si:
                    runs[-1][1].append(fi)
                else:
                    runs.append((si, [fi]))
            parts = [
                self.parse_window(
                    datas[si], indices[si], 0, 0, frames=np.asarray(fis),
                )
                for si, fis in runs
            ]
            return parts[0] if len(parts) == 1 else np.concatenate(
                parts, axis=1
            )

        windows = [entries[s:s + w] for s in range(0, len(entries), w)]
        pending: list[tuple[list, int, object]] = []
        ring = max(1, cfg.num_output_buffers)
        ahead = max(1, cfg.prefetch_batches)
        # Bounded look-ahead: window N+1's host parse overlaps window N's
        # device compute and drain (the decode() producer pattern, sized
        # down to one worker — parse_window is OpenMP-parallel inside).
        ex = ThreadPoolExecutor(max_workers=1)
        futs: list = [ex.submit(parse_ents, e) for e in windows[:ahead]]
        nxt = len(futs)
        try:
            for wi, ents in enumerate(windows):
                if stop is not None and stop():
                    break
                amps = futs[wi].result()
                futs[wi] = None  # free the parsed window once consumed
                if nxt < len(windows):
                    futs.append(ex.submit(parse_ents, windows[nxt]))
                    nxt += 1
                c = len(ents)
                dev_amps = self._put_window(amps, c, w, nb)
                seg = np.zeros(w, dtype=bool)
                for i, (si, fi) in enumerate(ents):
                    # Stream starts are segment resets regardless of their
                    # frame type (0 + delta == standalone zero-carry
                    # decode).
                    seg[i] = fi == 0 or bool(indices[si].is_iframe[fi])
                with self.profiler.time("device/dispatch"):
                    frames, carry = step(dev_amps, self._put(seg), carry)
                    if downscale is not None:
                        frames = downscale(frames)
                pending.append((ents, c, frames))
                while len(pending) > ring:
                    yield from emit(pending.pop(0))
            while pending:
                yield from emit(pending.pop(0))
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def decode_streams_arrays(
        self, datas: Sequence[bytes], scale: int = 1,
    ) -> list[np.ndarray]:
        """decode_streams, reassembled into one (F, H, W) array per clip."""
        per: dict[int, dict[int, np.ndarray]] = {}
        for si, fi, frame in self.decode_streams(datas, scale=scale):
            per.setdefault(si, {})[fi] = frame
        out = []
        for si in range(len(datas)):
            d = per.get(si, {})
            out.append(
                np.stack([d[k] for k in sorted(d)])
                if d else np.zeros((0, 0, 0), np.uint32)
            )
        return out

    def decode_iframes_array(
        self, data: bytes, scale: int = 1,
    ) -> tuple[np.ndarray, np.ndarray]:
        """All I-frames at once: (indices (K,), frames (K, H, W) uint32)."""
        pairs = list(self.decode_iframes(data, scale=scale))
        if not pairs:
            return (np.zeros(0, np.int64),
                    np.zeros((0, 0, 0), dtype=np.uint32))
        idx = np.array([i for i, _ in pairs], dtype=np.int64)
        return idx, np.stack([f for _, f in pairs])

    def _drain(self, item, device_resident: bool = False) -> DecodedWindow:
        s, c, frames = item
        if device_resident:
            # Serving-to-model path: the window stays on device — no
            # transfer.  `frames` rows beyond `c` are pad.
            return DecodedWindow(s, c, frames)
        with self.profiler.time("output/transfer"):
            host = np.asarray(frames)
        return DecodedWindow(s, c, host[:c])

    def decode_array(self, data: bytes, **kw) -> np.ndarray:
        """Decode fully into one (F, H, W) uint32 array.

        Windows may arrive out of global frame order (mesh mode yields one
        window per device partition per step); reassembly is by
        start_frame index.
        """
        if kw.get("device_resident"):
            raise ValueError(
                "decode_array assembles HOST frames; consume "
                "device-resident windows from decode(device_resident=True) "
                "directly (rows beyond .count are pad)"
            )
        wins = list(self.decode(data, **kw))
        if not wins:
            return np.zeros((0, 0, 0), dtype=np.uint32)
        lo = min(w.start_frame for w in wins)
        hi = max(w.start_frame + w.count for w in wins)
        out = np.empty(
            (hi - lo,) + wins[0].frames.shape[1:], wins[0].frames.dtype
        )
        for w in wins:
            out[w.start_frame - lo:w.start_frame - lo + w.count] = w.frames
        return out

    # ----- Corruption-resilient decode (GOP skip-and-resync) -------------

    def _find_corrupt_frame(
        self, data: bytes, index: fmt.FrameIndex, lo: int, hi: int
    ) -> int | None:
        """First frame in [lo, hi) whose entropy parse raises, else None."""
        for f in range(lo, hi):
            try:
                self.parse_window(data, index, f, 1)
            except ValueError:
                return f
        return None

    def decode_resilient(
        self,
        data: bytes,
        *,
        stop: Callable[[], bool] | None = None,
        device_resident: bool = False,
        scale: int = 1,
        recovery: RecoveryLog | None = None,
    ) -> Iterator[DecodedWindow]:
        """Decode, skipping corrupt GOP tails instead of raising.

        The strict paths treat any corruption as fatal (a silent truncated
        decode is worse than an error).  A serving fleet replaying a damaged
        archive wants the third option: deliver every decodable frame, drop
        [corrupt_frame, next_I) — P-frames after the damage depend on its
        state, and every I-frame rebuilds all of it (reference:
        lossless_decode.c:76-78) — and resync at the next trailer I-frame,
        exactly the reference's seek machinery (playback.c:136-152) driven
        by damage instead of the user.  Covers both corruption classes:
        broken frame_size chains (trailer-resynced index,
        format.index_frames_resilient) and corrupt plane bitstreams (parse
        failure -> per-frame probe -> GOP-tail skip).

        Pass a RecoveryLog to observe what was lost; it is finalized
        (sorted, adjacent ranges merged) when the generator completes.
        Frames inside skipped ranges are never yielded — consumers key on
        DecodedWindow.start_frame as always.  Undetectable corruption
        (bit flips that still parse) is out of scope, as it is for the
        reference: the format carries no checksums.
        """
        if self.mesh is not None:
            raise ValueError(
                "decode_resilient is single-device (mesh partitions assume "
                "an intact chain; StreamPool retries cover fleet failures)"
            )
        rec = recovery if recovery is not None else RecoveryLog()
        index, bad = fmt.index_frames_resilient(data)
        rec.skipped.extend(bad)
        rec.resyncs += len(bad)
        nf = index.num_frames
        is_i = index.is_iframe
        spans: list[tuple[int, int]] = []
        pos = 0
        for lo, hi in bad:
            if pos < lo:
                spans.append((pos, lo))
            pos = hi
        if pos < nf:
            spans.append((pos, nf))
        try:
            for lo, hi in spans:
                if not is_i[lo]:
                    # A span must start at an I-frame: prior coefficient
                    # state is gone (resynced spans start at trailer
                    # I-frames; this guards a corrupt frame 0 / lying
                    # trailer).
                    nz = np.flatnonzero(is_i[lo:hi])
                    if nz.size == 0:
                        rec.skipped.append((lo, hi))
                        continue
                    s2 = lo + int(nz[0])
                    rec.skipped.append((lo, s2))
                    lo = s2
                cur = lo
                while cur < hi:
                    delivered = cur
                    try:
                        for win in self.decode(
                            data, start_frame=cur, stop=stop, end_frame=hi,
                            device_resident=device_resident, scale=scale,
                            _index=index,
                        ):
                            yield win
                            delivered = win.start_frame + win.count
                            if stop is not None and stop():
                                return
                        cur = hi
                    except ValueError:
                        f = self._find_corrupt_frame(
                            data, index, delivered, hi
                        )
                        if f is None:
                            # Not a localizable data error (bad config,
                            # geometry, device failure): resilience does
                            # not paper over those.
                            raise
                        rec.resyncs += 1
                        if f > delivered:
                            # Deliver the good prefix [delivered, f).  The
                            # failed attempt lost its in-flight output ring,
                            # so re-decode from the I-frame at/before
                            # `delivered` and trim the head.
                            nz = np.flatnonzero(is_i[lo:delivered + 1])
                            prev_i = lo + int(nz[-1])
                            for win in self.decode(
                                data, start_frame=prev_i, end_frame=f,
                                device_resident=device_resident, scale=scale,
                                _index=index,
                            ):
                                k = max(0, delivered - win.start_frame)
                                if k >= win.count:
                                    continue
                                if k:
                                    win = DecodedWindow(
                                        win.start_frame + k, win.count - k,
                                        win.frames[k:],
                                    )
                                yield win
                                if stop is not None and stop():
                                    return
                        nz = np.flatnonzero(is_i[f + 1:hi])
                        nxt = f + 1 + int(nz[0]) if nz.size else hi
                        rec.skipped.append((f, nxt))
                        cur = nxt
        finally:
            rec.skipped.sort()
            merged: list[tuple[int, int]] = []
            for lo2, hi2 in rec.skipped:
                if merged and lo2 <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], hi2))
                else:
                    merged.append((lo2, hi2))
            rec.skipped[:] = merged

    def decode_resilient_array(
        self, data: bytes, fill: int = 0, **kw
    ) -> tuple[np.ndarray, RecoveryLog]:
        """decode_resilient into one (F, H, W) uint32 array + RecoveryLog.

        Skipped frames hold `fill` (default 0); F is the header's
        num_frames, so frame indices stay aligned with the container.
        """
        if kw.get("device_resident"):
            raise ValueError(
                "decode_resilient_array assembles HOST raster frames; "
                "consume device-resident windows from decode_resilient("
                "device_resident=True) directly"
            )
        rec = kw.pop("recovery", None) or RecoveryLog()
        hdr = fmt.FileHeader.unpack(data)
        f = kw.get("scale", 1)
        out = np.full(
            (hdr.num_frames, hdr.height // f, hdr.width // f),
            fill, dtype=np.uint32,
        )
        for win in self.decode_resilient(data, recovery=rec, **kw):
            out[win.start_frame:win.start_frame + win.count] = win.frames
        return out, rec

"""Typed runtime configuration (the reference's config.h made first-class).

Every compile-time #define knob from the reference (reference:
core0/software/common/config.h:23-62) appears here as a dataclass field,
plus the device-pipeline knobs (window size, prefetch depth, host parse).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DecodeConfig:
    """Decode/playback configuration.

    Reference knob mapping:
      fps / frame_period_us     <- FRAME_RATE_US 41666 (config.h:29)
      num_output_buffers        <- DISPLAY_NUM_OUTPUT_BUFFERS 4 (config.h:27)
      force_periodic            <- FORCE_PERIODIC (config.h:31)
      max_i_interval            <- MAX_IFRAME_OFFSET 24 (config.h:54)
    """

    # Playback pacing
    fps: float = 24.0
    force_periodic: bool = True
    num_output_buffers: int = 4

    # Stream structure
    max_i_interval: int = 24

    # Device execution
    frames_per_batch: int = 20        # device window.  Window boundaries
                                      # need no GOP alignment (the
                                      # coefficient carry is exact)
    prefetch_batches: int = 2          # host->device in-flight batches
    latency_mode: bool = False         # first-window latency over
                                       # throughput: the FIRST window of a
                                       # decode() parses alone, dispatches,
                                       # and is drained BEFORE any later
                                       # window's H2D is posted, so its
                                       # delivery never queues behind
                                       # prefetch traffic (the reference
                                       # shows the sought frame
                                       # immediately, playback.c:245).
                                       # Player.play/seek force this per
                                       # call; bulk decode keeps the
                                       # pipelined default.

    # Host entropy decode
    parse_workers: int = 0             # 0 = os.cpu_count()
    use_native_entropy: bool = True
    spec_segments: int = 0             # >0: speculative intra-plane parallel
                                       # parse with this many segments per
                                       # plane (single-stream latency mode;
                                       # ~S/2 speedup when concurrent plane
                                       # count is below the core count)

    # Multi-chip execution is explicit, not config-driven: pass a mesh to
    # DecodePipeline(mesh=...) for GOP-sharded streaming, use
    # parallel.decode_stream_sharded(data, mesh) for batch decode, or
    # runtime.serve.StreamPool(devices=...) to spread whole streams/clip
    # farms over chips.

    @property
    def frame_period_us(self) -> float:
        return 1e6 / self.fps


@dataclasses.dataclass
class EncodeConfig:
    """Encoder knobs (reference: mjpeg423_encoder.h:14 arguments)."""

    max_i_interval: int = 24
    use_native_entropy: bool = True
    # Device-path transform batch (encode_frames_device): frames staged,
    # transformed, and packed per window — bounds host memory at
    # O(window) blocked planes instead of the whole clip.
    frames_per_batch: int = 16
    # Device-path stage overlap: host convert (window N+1) and serial pack
    # (window N) run concurrently with the device FDCT+quantize + D2H of
    # the windows between them (producer thread + bounded staging slots —
    # the reference's post-early/join-late shape, playback.c:80-134).
    # False: strict convert -> transform -> pack sequence per window.
    overlap_device: bool = True
    inflight_windows: int = 2          # staged windows in flight (device
                                       # path); host memory O(inflight+1
                                       # windows)
    fetch_i8: bool = False             # device path: narrow quantized
                                       # planes ON DEVICE to int16 DC +
                                       # int8 AC before D2H (halves the
                                       # dominant transfer of device-
                                       # assisted encode; per-window
                                       # overflow falls back to the full
                                       # int16 fetch, byte-identical).
                                       # Off by default: wins only where
                                       # the device->host link, not the
                                       # host pack, is the bottleneck.
                                       # Single-device path only (ignored
                                       # with mesh=: the sharded transform
                                       # returns per-shard layouts the
                                       # packer consumes whole)

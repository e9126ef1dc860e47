"""mjpeg423_tpu — MJPEG423 video decode/encode framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
dual-core Nios-II MJPEG423 player (ghananigans/mjpeg423-video-decoder-software):
the complete bit-exact codec, a stage-decoupled decode pipeline, GOP-sharded
and sequence-parallel multi-chip execution, playback control (play/seek/FF/RW)
and a native C entropy codec for the serial host-side bit parsing.

Layers (bottom-up):
  core/      container format, tables, config        (ref L2/L3 analogs)
  ops/       entropy + transform math: NumPy oracles, JAX device steps
  native/    C entropy codec (the hot host-side op)
  codec/     end-to-end encoder/decoder APIs          (ref 2.1e/2.1j)
  parallel/  mesh / GOP sharding / temporal scan      (ref §2 parallelism)
  runtime/   pipeline, playback orchestrator, metrics (ref 2.5/2.7/2.13)
  io/        BMP + stream readers                     (ref 2.2/2.14)
"""

import os as _os

# NumPy madvise(MADV_HUGEPAGE)s every >=4 MB allocation; on hosts with
# THP defrag=madvise the first touch of such a buffer then runs
# synchronous compaction — measured 11 MB/s vs 2.2 GB/s with it off
# (a 1080p encode frame stalled ~2.5 s on allocation alone).  The TLB
# win never repays that for this workload's allocate-use-free pattern.
# numpy is typically preloaded before us (sitecustomize), so the
# NUMPY_MADVISE_HUGEPAGE env var is too late — use the runtime toggle.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # private API, present in numpy 1.x and 2.x
    from numpy._core.multiarray import _set_madvise_hugepage
except ImportError:  # pragma: no cover
    try:
        from numpy.core.multiarray import _set_madvise_hugepage
    except ImportError:
        _set_madvise_hugepage = None
if (
    _set_madvise_hugepage is not None
    # Respect an explicit user opt-in through EITHER knob: the package
    # one, or numpy's own env var if the user set it before we imported
    # (we must not silently defeat a deliberate process-wide choice).
    and _os.environ.get("MJPEG423_MADVISE_HUGEPAGE", "0") != "1"
    and _os.environ.get("NUMPY_MADVISE_HUGEPAGE", "0") != "1"
):
    _set_madvise_hugepage(False)

__version__ = "0.1.0"

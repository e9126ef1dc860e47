"""Multi-host decode: per-host GOP partitions + DCN control plane.

The reference's distribution unit is the core boundary: core1 owns the SD
stream and Y-plane entropy work, core0 owns the rest, coordinated by mailbox
handshakes over shared DDR (reference: SURVEY.md §5.8).  The device-native
equivalent (the build contract from SURVEY.md §5.8):

  * control plane   — jax.distributed over DCN (initialize() below);
  * data locality   — each host parses ONLY its own GOP partition from its
    own copy/range of the container (no bulk data over DCN: the zero-copy
    pointer-passing analog is "shard the byte ranges, not the bytes");
  * compute         — each host runs the single-host sharded decode over its
    local devices (parallel/decode.py);
  * aggregation     — global frames/s via a psum on the global mesh.

GOPs are fully independent (I-frames reset all coefficient state,
lossless_decode.c:76-78), so the partition needs no cross-host collectives
in the decode path at all; a failed host's GOP range is simply re-assigned
and re-decoded (GOP-restart elasticity, SURVEY.md §5.3).
"""
from __future__ import annotations

import dataclasses


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize jax.distributed if multi-process; returns (pid, nprocs).

    No-ops (0, 1) when unconfigured so single-host code paths are identical.
    """
    import jax

    if coordinator_address is None:
        return 0, 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


@dataclasses.dataclass(frozen=True)
class GopPartition:
    """One host's contiguous GOP range [gop_lo, gop_hi) and its frame span."""

    host: int
    gop_lo: int
    gop_hi: int
    frame_lo: int
    frame_hi: int

    @property
    def num_frames(self) -> int:
        return self.frame_hi - self.frame_lo


def partition_gops(
    gop_starts: list[int], num_frames: int, num_hosts: int
) -> list[GopPartition]:
    """Split GOPs into contiguous per-host ranges balanced by frame count.

    Contiguity keeps each host's byte range sequential (the bulk-read lesson
    from the reference SD stack, FatFileSystem.c:417-504).  Balanced by
    frames because transform cost is per-frame; returns one entry per host
    (possibly empty ranges when hosts > GOPs).
    """
    bounds = list(gop_starts) + [num_frames]
    n_gops = len(gop_starts)
    parts: list[GopPartition] = []
    # Greedy walk: cut when the running frame count reaches the ideal share
    # of the remaining frames over the remaining hosts.
    g = 0
    for h in range(num_hosts):
        lo = g
        remaining_hosts = num_hosts - h
        remaining_frames = num_frames - bounds[g]
        share = remaining_frames / remaining_hosts if remaining_hosts else 0
        acc = 0
        while g < n_gops and (acc < share or remaining_hosts == 1):
            acc += bounds[g + 1] - bounds[g]
            g += 1
            if acc >= share and remaining_hosts > 1:
                break
        parts.append(
            GopPartition(h, lo, g, bounds[lo], bounds[g])
        )
    return parts


def local_partition(
    gop_starts: list[int], num_frames: int
) -> GopPartition:
    """This process's partition under the current jax.distributed config."""
    import jax

    parts = partition_gops(
        gop_starts, num_frames, jax.process_count()
    )
    return parts[jax.process_index()]


def aggregate_counts(local_count: float) -> float:
    """Global sum of a per-host scalar over all processes (DCN psum).

    Used for aggregate frames/s and dropped-frame accounting; single-process
    it is the identity.
    """
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return float(local_count)
    from jax.experimental import multihost_utils

    return float(
        multihost_utils.process_allgather(jnp.float32(local_count)).sum()
    )

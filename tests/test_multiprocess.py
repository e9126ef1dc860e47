"""Real multi-process decode: 2 jax.distributed CPU processes split GOPs.

Each process parses and decodes only its GOP partition (the per-host input
pipeline of SURVEY.md §7 step 6) and reports its frame count; the test
verifies the partition covers the stream and every decoded frame is
bit-exact vs the single-process oracle.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from mjpeg423_tpu.codec import decoder, encoder

from conftest import make_test_frames

_WORKER = r"""
import os, sys
import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.environ["REPO_ROOT"])
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.parallel import multihost
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

pid, nprocs = multihost.initialize(
    coordinator_address=os.environ["COORD"],
    num_processes=int(os.environ["NPROCS"]),
    process_id=int(os.environ["PID"]),
)
assert nprocs == int(os.environ["NPROCS"]), nprocs

data = open(os.environ["STREAM"], "rb").read()
index = fmt.index_frames(data)
part = multihost.local_partition(index.gop_starts(), index.num_frames)

# Decode only the local partition (GOP-aligned start -> zero carry is valid).
pipe = DecodePipeline(DecodeConfig(frames_per_batch=4))
frames = {}
if part.num_frames:
    for win in pipe.decode(data, start_frame=part.frame_lo):
        for j in range(win.count):
            fi = win.start_frame + j
            if fi >= part.frame_hi:
                break
            frames[fi] = win.frames[j]

total = multihost.aggregate_counts(float(len(frames)))
out = os.environ["OUT"] + f".{pid}"
np.savez(out, idx=np.array(sorted(frames)),
         frames=np.stack([frames[i] for i in sorted(frames)])
         if frames else np.zeros((0, 1, 1), np.uint32),
         total=total)
print("OK", pid, len(frames), total)
"""


def test_two_process_gop_partition_decode(tmp_path):
    rng = np.random.default_rng(61)
    frames = make_test_frames(rng, num_frames=12, h=24, w=32)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)

    stream = tmp_path / "s.mpg"
    stream.write_bytes(data)
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out = tmp_path / "result"

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            REPO_ROOT=str(pathlib.Path(__file__).resolve().parent.parent),
            COORD="localhost:12423",
            NPROCS="2",
            PID=str(pid),
            STREAM=str(stream),
            OUT=str(out),
            JAX_PLATFORMS="cpu",
        )
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        assert "OK" in stdout

    got = {}
    total = None
    for pid in range(2):
        z = np.load(f"{out}.{pid}.npz")
        total = float(z["total"])
        for i, fi in enumerate(z["idx"]):
            got[int(fi)] = z["frames"][i]
    assert total == 12.0  # cross-process psum saw every frame
    assert sorted(got) == list(range(12))
    for fi in range(12):
        np.testing.assert_array_equal(got[fi], want[fi])


_WORKER_MESH = r"""
import os, sys
import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.environ["REPO_ROOT"])
from mjpeg423_tpu.core import format as fmt
from mjpeg423_tpu.parallel import multihost
from mjpeg423_tpu.parallel.mesh import make_mesh
from mjpeg423_tpu.runtime import DecodePipeline
from mjpeg423_tpu.utils.config import DecodeConfig

pid, nprocs = multihost.initialize(
    coordinator_address=os.environ["COORD"],
    num_processes=int(os.environ["NPROCS"]),
    process_id=int(os.environ["PID"]),
)
assert len(jax.local_devices()) == 2, jax.local_devices()

data = open(os.environ["STREAM"], "rb").read()
index = fmt.index_frames(data)
part = multihost.local_partition(index.gop_starts(), index.num_frames)

# Host x chip composition: this process's GOP partition decodes over a mesh
# of its LOCAL devices (the per-host input pipeline feeding per-chip GOP
# sub-partitions -- SURVEY.md section 7 step 6 composed with step 5).
mesh = make_mesh(n_data=2, n_block=1, devices=jax.local_devices())
pipe = DecodePipeline(
    DecodeConfig(frames_per_batch=2), mesh=mesh
)
frames = {}
if part.num_frames:
    for win in pipe.decode(
        data, start_frame=part.frame_lo, end_frame=part.frame_hi
    ):
        for j in range(win.count):
            frames[win.start_frame + j] = win.frames[j]
assert len(frames) == part.num_frames, (len(frames), part)

total = multihost.aggregate_counts(float(len(frames)))
out = os.environ["OUT"] + f".{pid}"
np.savez(out, idx=np.array(sorted(frames)),
         frames=np.stack([frames[i] for i in sorted(frames)])
         if frames else np.zeros((0, 1, 1), np.uint32),
         total=total)
print("OK", pid, len(frames), total)
"""


def test_two_process_mesh_pipeline_decode(tmp_path):
    """Multi-host x multi-chip composition: 2 jax.distributed processes,
    each decoding its GOP partition over a 2-device local mesh with the
    sharded streaming pipeline; merged output bit-exact."""
    rng = np.random.default_rng(62)
    frames = make_test_frames(rng, num_frames=16, h=16, w=32)
    data = encoder.encode_frames(frames, max_i_interval=4)
    want = decoder.decode_stream_array(data)

    stream = tmp_path / "s.mpg"
    stream.write_bytes(data)
    worker = tmp_path / "worker_mesh.py"
    worker.write_text(_WORKER_MESH)
    out = tmp_path / "result"

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            REPO_ROOT=str(pathlib.Path(__file__).resolve().parent.parent),
            COORD="localhost:12427",
            NPROCS="2",
            PID=str(pid),
            STREAM=str(stream),
            OUT=str(out),
            JAX_PLATFORMS="cpu",
        )
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        assert "OK" in stdout

    got = {}
    total = None
    for pid in range(2):
        z = np.load(f"{out}.{pid}.npz")
        total = float(z["total"])
        for i, fi in enumerate(z["idx"]):
            got[int(fi)] = z["frames"][i]
    assert total == 16.0
    assert sorted(got) == list(range(16))
    for fi in range(16):
        np.testing.assert_array_equal(got[fi], want[fi])

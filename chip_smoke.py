"""Smoke run of the codec's main paths on an NVIDIA GPU.

    python chip_smoke.py          # one card: phases 0-5 below
    python chip_smoke.py --four   # four cards: only the multi-card paths

Drives the entry points a user calls, at the sizes users run, and checks
every output bit-exact against the in-repo NumPy oracle (the device does
integer arithmetic only, so the tolerance is zero):

  0. environment: card, JAX, compile cache, native codec build;
  1. bulk decode, DecodePipeline().decode_array, 1920x1088 GOP 24, 120 frames;
  2. the reference player, Player.play at 640x480 24 fps, paced, one FF seek;
  3. decode(device_resident=True) at 640x480, compared on the device;
  4. encode_frames_device at 640x480, byte-identical to encode_frames;
  5. StreamPool.decode_all_packed over short 640x480 clips.

With --four: the mesh pipeline at 1080p against one-card output, the
non-GOP-aligned sharded decode (all_gather carry), the sharded encoder and
StreamPool over every device.

The last line of standard output is a JSON object {"ok": true, "device":
{...}} — printed only when every phase passed on a GPU.  Without a GPU, or
without the package beside this file, the script exits non-zero and prints
no such line.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
import traceback

import numpy as np

FULL_HD = (1920, 1088)  # BT.709 1080p padded to the 8-row block grid
VGA = (640, 480)


def camera_frames(width: int, height: int, n: int, seed: int) -> list:
    """Seeded camera-like RGB frames: a fixed camera on a smooth gradient
    scene, two moving shapes and light sensor noise, so P-frames carry real
    deltas and win over I-frames where the scene holds still."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    scene = np.stack([
        128 + 90 * np.sin(xx / (width / 3.1)),
        128 + 80 * np.cos(yy / (height / 2.3)),
        100 + 0.2 * ((xx + yy) % 400),
    ], axis=-1)
    frames = []
    for t in range(n):
        img = scene.copy()
        cx = (width // 5 + 7 * t) % width
        cy = height // 3
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < (height // 8) ** 2
        img[disc] = (230.0, 40.0, 60.0)
        x0 = (width - 9 * t) % width
        y0 = (height // 2 + 4 * t) % max(height - height // 6, 1)
        img[y0:y0 + height // 6, x0:x0 + width // 8] = (30.0, 200.0, 90.0)
        img += rng.normal(0.0, 1.0, img.shape).astype(np.float32)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def oracle_range(data: bytes, lo: int, hi: int) -> np.ndarray:
    """NumPy oracle decode of frames [lo, hi); lo must be an I-frame."""
    from mjpeg423_tpu.codec import decoder
    from mjpeg423_tpu.core import format as fmt

    mpg = fmt.parse_file(data)
    if not mpg.frames[lo].is_iframe:
        raise ValueError(f"frame {lo} is not an I-frame")
    sub = fmt.serialize_file(mpg.width, mpg.height, mpg.frames[lo:hi])
    return decoder.decode_stream_array(sub)


def _assert_equal(got, want, what: str) -> None:
    got = np.asarray(got)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    bad = np.count_nonzero(got != want)
    if bad:
        raise AssertionError(f"{what}: {bad} values differ from the oracle")


def phase_environment() -> dict:
    import jax

    from mjpeg423_tpu.native import centropy
    from mjpeg423_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next(
                (ln.split(":", 1)[1].strip() for ln in f
                 if ln.startswith("model name")), cpu,
            )
    except OSError:
        pass
    info = {
        "jax": jax.__version__,
        "devices": [str(d) for d in jax.devices()],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "compile_cache": cache,
        "native_codec": centropy.native_available(),
        "native_build": centropy.build_rung(),
        "host_cpu": cpu,
    }
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev.platform}")
    if not info["native_codec"]:
        raise RuntimeError("native entropy codec unavailable")
    return info


def phase_bulk_decode(width=FULL_HD[0], height=FULL_HD[1], nframes=120,
                      gop=24, seed=423) -> dict:
    import jax

    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.ops import transform_jax
    from mjpeg423_tpu.runtime import DecodePipeline

    data = encoder.encode_frames(
        camera_frames(width, height, nframes, seed), max_i_interval=gop
    )
    pipe = DecodePipeline()
    w = pipe.config.frames_per_batch
    nb = (width // 8) * (height // 8)
    compiled = transform_jax.decode_window.lower(
        jax.ShapeDtypeStruct((3, w, nb, 64), np.int16),
        jax.ShapeDtypeStruct((w,), np.bool_),
        jax.ShapeDtypeStruct((3, nb, 64), np.int16),
        blocks_h=height // 8, blocks_w=width // 8,
    ).compile()
    t0 = time.perf_counter()
    pipe.warmup(width, height)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = pipe.decode_array(data)
    wall_s = time.perf_counter() - t0
    from mjpeg423_tpu.core import format as fmt

    starts = fmt.index_frames(data).gop_starts() + [nframes]
    first, last = starts[1], starts[-2]
    _assert_equal(got[:first], oracle_range(data, 0, first), "first GOP")
    _assert_equal(got[last:], oracle_range(data, last, nframes), "last GOP")
    return {
        "geometry": f"{width}x{height}", "frames": nframes, "window": w,
        "container_bytes": len(data), "gops": len(starts) - 1,
        "step_memory": str(compiled.memory_analysis()),
        "warmup_s": round(warm_s, 3), "wall_s": round(wall_s, 3),
        "wall_frames_per_s": round(nframes / wall_s, 1),
    }


def phase_player(width=VGA[0], height=VGA[1], seconds=10, fps=24.0,
                 play_s=3.0, ff_after_s=1.0, seed=7) -> dict:
    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.runtime import Player
    from mjpeg423_tpu.utils.config import DecodeConfig

    nframes = int(seconds * fps)
    gop = 24
    data = encoder.encode_frames(
        camera_frames(width, height, nframes, seed), max_i_interval=gop
    )
    want = oracle_range(data, 0, nframes)
    player = Player(data, DecodeConfig(fps=fps))
    player.pipeline.warmup(width, height)
    total = int(play_s * fps)
    ff_at = int(ff_after_s * fps)
    got: dict = {}

    def sink(fi, frame):
        got[fi] = np.array(frame)
        if len(got) == ff_at:
            player.request_fast_forward()
        if len(got) >= total:
            player.request_stop()

    stats = player.play(sink=sink, paced=True)
    order = sorted(got)
    jumped = [b for a, b in zip(order, order[1:]) if b != a + 1]
    skip = int(Player.SKIP_SECONDS * fps)
    if len(jumped) != 1 or jumped[0] < order[ff_at - 1] + skip:
        raise AssertionError(f"expected one FF jump of >= 5 s, got {jumped}")
    for fi in order:
        _assert_equal(got[fi], want[fi], f"player frame {fi}")
    return {
        "geometry": f"{width}x{height}", "fps": fps,
        "frames_delivered": stats.frames_delivered,
        "frames_late": stats.frames_late,
        "wall_s": round(stats.wall_s, 3), "ff_to": jumped[0],
    }


def phase_device_resident(width=VGA[0], height=VGA[1], nframes=48,
                          seed=11) -> dict:
    import jax
    import jax.numpy as jnp

    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.runtime import DecodePipeline

    data = encoder.encode_frames(
        camera_frames(width, height, nframes, seed), max_i_interval=24
    )
    want = oracle_range(data, 0, nframes)
    windows = 0
    for win in DecodePipeline().decode(data, device_resident=True):
        if not isinstance(win.frames, jax.Array):
            raise AssertionError("device_resident window is not a jax.Array")
        ref = jnp.asarray(want[win.start_frame:win.start_frame + win.count])
        same = jnp.array_equal(win.frames[:win.count], ref)
        if not bool(same):
            raise AssertionError(f"window at {win.start_frame} differs")
        windows += 1
    return {"geometry": f"{width}x{height}", "frames": nframes,
            "windows": windows,
            "frames_device": str(win.frames.devices())}


def phase_encode(width=VGA[0], height=VGA[1], nframes=24, seed=5) -> dict:
    from mjpeg423_tpu.codec import encoder

    frames = camera_frames(width, height, nframes, seed)
    want = encoder.encode_frames(frames, max_i_interval=24)
    t0 = time.perf_counter()
    got = encoder.encode_frames_device(frames, max_i_interval=24)
    wall_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("encode_frames_device container differs")
    return {"geometry": f"{width}x{height}", "frames": nframes,
            "bytes": len(got), "wall_s": round(wall_s, 3)}


def phase_stream_pool(width=VGA[0], height=VGA[1], clips=4, nframes=30,
                      seed=21, devices=None) -> dict:
    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.runtime.serve import StreamPool

    datas = [
        encoder.encode_frames(
            camera_frames(width, height, nframes + 3 * i, seed + i),
            max_i_interval=12,
        )
        for i in range(clips)
    ]
    got: dict = {}

    def sink(si, win):
        for i in range(win.count):
            got[(si, win.start_frame + i)] = np.array(win.frames[i])

    stats = StreamPool(devices=devices).decode_all_packed(datas, sink=sink)
    for si, data in enumerate(datas):
        want = oracle_range(data, 0, nframes + 3 * si)
        for fi in range(want.shape[0]):
            _assert_equal(got[(si, fi)], want[fi], f"clip {si} frame {fi}")
    return {"clips": clips, "frames": stats.frames,
            "devices": len(devices) if devices else 1}


def phase_four_mesh_pipeline(width=FULL_HD[0], height=FULL_HD[1],
                             nframes=96, gop=24, seed=31) -> dict:
    import jax

    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.parallel import make_mesh
    from mjpeg423_tpu.runtime import DecodePipeline

    data = encoder.encode_frames(
        camera_frames(width, height, nframes, seed), max_i_interval=gop
    )
    one = DecodePipeline(device=jax.devices()[0]).decode_array(data)
    mesh = make_mesh(n_data=4, n_block=1)
    pipe = DecodePipeline(mesh=mesh)
    pipe.warmup(width, height)
    t0 = time.perf_counter()
    got = pipe.decode_array(data)
    wall_s = time.perf_counter() - t0
    _assert_equal(got, one, "4-card mesh pipeline vs one card")
    return {"geometry": f"{width}x{height}", "frames": nframes,
            "wall_s": round(wall_s, 3),
            "wall_frames_per_s": round(nframes / wall_s, 1)}


def phase_four_sharded_carry(width=VGA[0], height=VGA[1], nframes=50,
                             seed=41) -> dict:
    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.parallel import decode_stream_sharded, make_mesh

    data = encoder.encode_frames(
        camera_frames(width, height, nframes, seed), max_i_interval=24
    )
    got = decode_stream_sharded(
        data, make_mesh(n_data=4, n_block=1), gop_aligned=False
    )
    _assert_equal(got, oracle_range(data, 0, nframes), "sharded carry")
    return {"geometry": f"{width}x{height}", "frames": nframes}


def phase_four_sharded_encode(width=VGA[0], height=VGA[1], nframes=26,
                              seed=51) -> dict:
    from mjpeg423_tpu.codec import encoder
    from mjpeg423_tpu.parallel import make_mesh

    frames = camera_frames(width, height, nframes, seed)
    want = encoder.encode_frames(frames, max_i_interval=24)
    got = encoder.encode_frames_device(
        frames, max_i_interval=24, mesh=make_mesh(n_data=4, n_block=1)
    )
    if got != want:
        raise AssertionError("sharded encoder container differs")
    return {"geometry": f"{width}x{height}", "frames": nframes}


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            ok = False
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
                  flush=True)
            traceback.print_exc()
            if name == "environment":
                break
            continue
        print(f"[{name}] ok {time.perf_counter() - t0:.1f}s "
              f"{json.dumps(res)}", flush=True)
    return ok


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        print(f"unknown arguments: {unknown}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    phases = [("environment", phase_environment)]
    if four:
        import jax

        devs = jax.devices()
        if len(devs) < 4:
            print(f"--four needs 4 devices, JAX has {len(devs)}",
                  file=sys.stderr)
            return 2
        phases += [
            ("mesh_pipeline_1080p", phase_four_mesh_pipeline),
            ("sharded_carry", phase_four_sharded_carry),
            ("sharded_encode", phase_four_sharded_encode),
            ("stream_pool", lambda: phase_stream_pool(devices=devs[:4])),
        ]
    else:
        phases += [
            ("bulk_decode_1080p", phase_bulk_decode),
            ("player_vga", phase_player),
            ("device_resident_vga", phase_device_resident),
            ("encode_device_vga", phase_encode),
            ("stream_pool_vga", phase_stream_pool),
        ]
    if not run_phases(phases):
        print("chip smoke FAILED", file=sys.stderr)
        return 1
    import jax

    dev = jax.devices()[0]
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if four else len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

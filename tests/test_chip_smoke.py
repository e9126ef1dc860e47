"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to report
success without a GPU, and the compile-cache rule it shares with the CLI."""
import json

import numpy as np
import pytest

import chip_smoke


def test_camera_frames_seeded_and_moving():
    a = chip_smoke.camera_frames(32, 24, 3, seed=1)
    b = chip_smoke.camera_frames(32, 24, 3, seed=1)
    assert len(a) == 3 and a[0].shape == (24, 32, 3) and a[0].dtype == np.uint8
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])  # content moves: P-frames differ


def test_phase_bulk_decode_tiny():
    res = chip_smoke.phase_bulk_decode(width=48, height=32, nframes=11,
                                       gop=4)
    assert res["frames"] == 11 and res["wall_frames_per_s"] > 0


def test_phase_player_tiny():
    # 2 s at 24 fps with a 5 s FF jump needs a clip of > 7 s.
    res = chip_smoke.phase_player(width=32, height=24, seconds=8,
                                  play_s=1.0, ff_after_s=0.5)
    assert res["frames_delivered"] == 24
    assert res["ff_to"] >= 11 + 120  # FF requested while showing frame 11


def test_phase_device_resident_tiny():
    res = chip_smoke.phase_device_resident(width=32, height=24, nframes=30)
    assert res["windows"] == 2


def test_phase_encode_tiny():
    assert chip_smoke.phase_encode(width=32, height=24, nframes=5)["bytes"]


def test_phase_stream_pool_tiny():
    res = chip_smoke.phase_stream_pool(width=32, height=24, clips=3,
                                       nframes=5)
    assert res["frames"] == 5 + 8 + 11


def test_four_card_phases_tiny_on_virtual_devices():
    """The --four phases on four of the virtual CPU devices."""
    chip_smoke.phase_four_mesh_pipeline(width=48, height=32, nframes=12,
                                        gop=3)
    chip_smoke.phase_four_sharded_carry(width=32, height=24, nframes=9)
    chip_smoke.phase_four_sharded_encode(width=32, height=24, nframes=6)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_ok_line_without_gpu(capsys, argv):
    rc = chip_smoke.main(argv)
    out = capsys.readouterr().out
    assert rc != 0
    for line in out.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok"))


def test_rejects_unknown_arguments(capsys):
    assert chip_smoke.main(["--eight"]) == 2


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device):
    """The single-card phases at reduced sizes, compiled for the card."""
    assert chip_smoke.phase_environment()["platform"] == "gpu"
    chip_smoke.phase_bulk_decode(width=640, height=480, nframes=30, gop=12)
    chip_smoke.phase_device_resident(nframes=24)
    chip_smoke.phase_encode(nframes=6)


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from mjpeg423_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, "/some/cache/dir")
    assert cache.enable_compile_cache() == "/some/cache/dir"
    # Set by the environment: nothing is set in code.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import pathlib

    import jax

    from mjpeg423_tpu.utils import cache

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cache.enable_compile_cache()
        root = pathlib.Path(chip_smoke.__file__).resolve().parent
        assert got == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

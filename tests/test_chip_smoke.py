"""The parts of chip_smoke.py (and of bench.py's device table) that a CPU
can reach: refusal without a GPU, the last line's format, phase
selection, compile-cache placement."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import conftest  # noqa: F401

import jax

import bench
import chip_smoke
from omega_tpu.infra import compile_cache

ROOT = Path(chip_smoke.__file__).resolve().parent


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_ok_line_format():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.ok_line(dev, 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_unknown_device_kind_raises():
    assert bench.device_peaks("NVIDIA H100 80GB HBM3")[
        "hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="Some Other Card"):
        bench.device_peaks("Some Other Card")


def test_roofline_estimate_divides_by_the_card_peak():
    peak = bench.device_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    t1 = bench._roofline_estimate(65536, 196608, 131072, 100, 2, peak)
    t2 = bench._roofline_estimate(65536, 196608, 131072, 100, 2, 2 * peak)
    assert t1 > 0 and abs(t1 / t2 - 2.0) < 1e-12


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # restored by the fixture before anything compiles into the checkout
    jax.config.update("jax_compilation_cache_dir", None)


def _fake_main(monkeypatch, argv):
    """Run chip_smoke.main with every phase recorded instead of run."""
    calls = []
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(chip_smoke, "environment",
                        lambda: (dev, "NVIDIA H100 80GB HBM3, 700.00 W"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: "-")
    monkeypatch.setattr(chip_smoke, "OUT", Path("/nonexistent-smoke-out"))
    monkeypatch.setattr(chip_smoke, "compare_phase",
                        lambda name, doc, **kw: calls.append(name))
    monkeypatch.setattr(chip_smoke, "time_steady",
                        lambda model, card: calls.append("timing"))
    monkeypatch.setattr(chip_smoke, "sharded_phase",
                        lambda name, doc, method: calls.append(
                            f"{name} x4 {method}"))
    assert chip_smoke.main(argv) == 0
    return calls


def test_four_runs_only_the_sharded_phase(monkeypatch, capsys):
    calls = _fake_main(monkeypatch, ["--four"])
    assert calls == ["planar x4 structured", "icos48 x4 sfc"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["count"] == len(jax.devices())


def test_default_runs_single_card_phases_in_order(monkeypatch, capsys):
    calls = _fake_main(monkeypatch, [])
    assert calls == ["planar flagship fb", "timing", "icos48 patch",
                     "icos48 gather", "rk4", "split-explicit",
                     "physics wind+drag+pp81", "fct"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": len(jax.devices())}}


def test_interval_strings():
    assert chip_smoke.interval(30) == "0000_00:00:30"
    assert chip_smoke.interval(1800) == "0000_00:30:00"
    assert chip_smoke.interval(90061) == "0001_01:01:01"


def test_rel_error_and_conservation_metrics():
    rng = np.random.default_rng(0)
    h = 10.0 + rng.random((5, 3))
    u = rng.standard_normal((7, 3))
    tr = 10.0 + rng.random((2, 5, 3))
    depth = np.full(5, 30.0)
    err, parts = chip_smoke.rel_error((h, u, tr), (h, u, tr), depth)
    assert err == 0.0 and set(parts) == {"ssh", "u", "tracer"}
    err, parts = chip_smoke.rel_error((h, 1.01 * u, tr), (h, u, tr), depth)
    assert abs(parts["u"] - 0.01) < 1e-12 and err == 0.0
    err, parts = chip_smoke.rel_error((h, u, 1.01 * tr), (h, u, tr), depth)
    assert err == parts["tracer"] > 0
    mesh = types.SimpleNamespace(area_cell=np.ones(5))
    dv, dm = chip_smoke.conservation(mesh, (h, u, tr), (1.5 * h, u, tr))
    assert abs(dv - 0.5) < 1e-12 and abs(dm - 0.5) < 1e-12


def test_initial_state_is_f32_representable():
    from omega_tpu.mesh import planar_hex_mesh
    mesh = planar_hex_mesh(8, 8, dc=5000.0, bottom_depth=1000.0)
    for a in chip_smoke.initial_state(mesh, 4):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, a.astype(np.float32))

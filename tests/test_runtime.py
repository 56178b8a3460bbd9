"""Runtime settings (compile cache, device checks), the benchmark's peak
table, and every chip_smoke phase at a tiny size on the CPU."""

import json
import os

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from eqvio_tpu.app import _env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, "/some/cache"),
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
])
def test_compile_cache_dir(environ, expected):
    assert _env.compile_cache_dir(environ) == expected


@pytest.mark.parametrize("env_value", [None, "/elsewhere/cache"])
def test_configure_runtime_sets_cache_only_without_env(monkeypatch, env_value):
    before = jax.config.jax_compilation_cache_dir
    if env_value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        dtype = _env.configure_runtime()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert got == (_env.DEFAULT_CACHE_DIR if env_value is None else None)
    assert dtype == np.float64  # the CPU reference numerics
    assert jax.config.jax_default_matmul_precision == "float32"


def test_require_gpu_raises_off_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        _env.require_gpu()


def test_chip_peaks_h100_and_unknown_kind():
    assert bench.chip_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    with pytest.raises(KeyError, match="no published peaks"):
        bench.chip_peaks("cpu")
    f, b = bench._utilization(6.7e12, 3.35e11, "NVIDIA H100 80GB HBM3")
    assert f == pytest.approx(10.0) and b == pytest.approx(10.0)


def test_result_line():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture(scope="module")
def tiny_sequence(tmp_path_factory):
    _env.configure_runtime()
    root = str(tmp_path_factory.mktemp("smoke"))
    return chip_smoke.ensure_sequence(root, end_time=2.0, width=320, height=240,
                                      num_points=300)


def test_phase_main_and_reference_tiny(tiny_sequence, tmp_path, monkeypatch):
    """On the CPU the main path and the reference run the same numerics,
    so their trajectories agree exactly."""
    monkeypatch.setattr(chip_smoke, "MIN_MEAN_TRACKED", 0.0)
    out = str(tmp_path / "main")
    summary = chip_smoke.phase_main(tiny_sequence, out, 35)
    assert summary["healthy"] and summary["frames"] == 35
    gap = chip_smoke.phase_reference(tiny_sequence, out, str(tmp_path / "ref"), 20, 0.0)
    assert gap < 1e-9


@pytest.mark.gpu
def test_phase_main_on_gpu_matches_cpu_reference(gpu, tiny_sequence, tmp_path, monkeypatch):
    """The fused main path compiled for the card, against the CPU f64
    reference, within chip_smoke's bound."""
    monkeypatch.setattr(chip_smoke, "MIN_MEAN_TRACKED", 0.0)
    out = str(tmp_path / "main")
    summary = chip_smoke.phase_main(tiny_sequence, out, 35)
    assert summary["healthy"] and summary["frames"] == 35
    gap = chip_smoke.phase_reference(tiny_sequence, out, str(tmp_path / "ref"), 20,
                                     chip_smoke.D_CPU_M)
    assert gap <= chip_smoke.REF_FLOOR_M


def test_phase_main_fails_on_frame_count(tiny_sequence, tmp_path):
    with pytest.raises(chip_smoke.SmokeFailure, match="frames"):
        chip_smoke.phase_main(tiny_sequence, str(tmp_path / "main"), 36)


def test_phase_sim_tiny(tmp_path):
    res = chip_smoke.phase_sim(str(tmp_path / "sim"), seconds=3.0,
                               extra=("--maxFeatures", "10", "--capacity", "12"))
    assert res["rmse"] < chip_smoke.SIM_RMSE_BOUND_M


def test_phase_multi_virtual_mesh():
    """The four-card phase's logic on the 8 virtual CPU devices."""
    n = len(jax.devices())
    err_seq, err_lm = chip_smoke.phase_multi(n_devices=n, batch=n, seconds=1.0,
                                             lm_capacity=16, lm_frames=2)
    assert err_seq < 1e-3 and err_lm < 1e-3

"""Long-horizon proxy regression tests (slow — gated by EQVIO_SLOW=1).

The repo's accuracy spine when real datasets are unavailable: the 144 s
V1_01 proxy and the 60 s racing proxy must complete with ATE inside the
reference's committed envelopes scaled to the proxy path lengths
(``configs/EQVIO_results_EuRoC_stationary.yaml`` pos RMSE 0.056-0.277 m over
36-127 m; ``EQVIO_results_UZHFPV.yaml`` indoor 0.149-0.405 m over 53-315 m).
The committed results live in ``results/`` (produced by ``app.batch`` over
``configs/proxy_sequences.yaml``); these tests re-derive them from scratch.

Run:  EQVIO_SLOW=1 ./run_tests.sh tests/test_proxy_slow.py   (~1 h on CPU)
"""

import os

import numpy as np
import pytest

SLOW = os.environ.get("EQVIO_SLOW") == "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# about 1.2x the committed CPU f64 result (0.0471 m,
# results/proxy_cpu_f64/mh03_proxy; reference MH_03: 0.0943 m)
MH03_GATE = 0.056


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_racing_proxy_60s_within_uzhfpv_envelope(tmp_path):
    """60 s aggressive fisheye circuit: the equidistant-camera pipeline's
    long-horizon number (beyond the 3 s smoke tests)."""
    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_racing_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/racing"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "racing")
        generate_racing_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_racing_proxy.yaml"))
    out = str(tmp_path / "out")
    _, summary = run_dataset(
        ds, cfg, mode="uzhfpv", output_dir=out,
        camera_yaml=os.path.join(ds, "camchain-imucam.yaml"),
    )
    assert summary["healthy"], summary
    res = analyse_output_dir(out, os.path.join(ds, "groundtruth.txt"),
                             gt_format="uzhfpv")
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    # regression gate at 1.2x the committed CPU-f64 result (0.213 m,
    # results/proxy_cpu_f64/racing_proxy) — tight enough to catch real
    # regressions, not just disasters
    rmse = res["position (m)"]["rmse"]
    budget = 0.256
    assert rmse < budget, (rmse, budget, res)


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_v101_proxy_144s_within_euroc_envelope(tmp_path):
    """144 s V1_01 motion-statistics proxy: full bias observability, landmark
    churn at scale, yaw drift, scale stability."""
    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_v101_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/v101"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "v101")
        generate_v101_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_v101_proxy.yaml"))
    out = str(tmp_path / "out")
    _, summary = run_dataset(ds, cfg, output_dir=out)
    assert summary["healthy"], summary
    gt = os.path.join(ds, "mav0", "state_groundtruth_estimate0", "data.csv")
    res = analyse_output_dir(out, gt)
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    # regression gate at 1.2x the committed CPU-f64 result (0.0806 m,
    # results/proxy_cpu_f64/v101_proxy)
    rmse = res["position (m)"]["rmse"]
    assert rmse < 0.097, (rmse, res)
    assert abs(res["scale"] - 1.0) < 0.05, res["scale"]


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_racing_proxy_f32_sqrt_production_mode(tmp_path):
    """The PRODUCTION numerics mode (f32 + sqrt covariance, auto-enabled on
    every accelerator run) must itself meet the accuracy bar — not just the
    f64 cross-check.  Budget: the UZH-FPV envelope top 0.405 m over
    314.5 m scaled to the proxy path."""
    import jax.numpy as jnp

    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_racing_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/racing"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "racing")
        generate_racing_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_racing_proxy.yaml"))
    out = str(tmp_path / "out_f32")
    _, summary = run_dataset(
        ds, cfg, mode="uzhfpv", output_dir=out,
        camera_yaml=os.path.join(ds, "camchain-imucam.yaml"),
        dtype=jnp.float32,  # auto-enables the sqrt covariance filter
    )
    assert summary["healthy"], summary
    res = analyse_output_dir(out, os.path.join(ds, "groundtruth.txt"),
                             gt_format="uzhfpv")
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    rmse = res["position (m)"]["rmse"]
    # 1.2x the CPU f32 + sqrt result (0.2128 m, RESULTS.md)
    assert rmse < 0.256, (rmse, res)


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_v101_proxy_f32_sqrt_production_mode(tmp_path):
    """f32+sqrt production mode on the V1_01 proxy: within 2x of the
    sequence-matched reference result (0.0561 m, EQVIO_results_EuRoC_
    stationary.yaml:55)."""
    import jax.numpy as jnp

    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_v101_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/v101"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "v101")
        generate_v101_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_v101_proxy.yaml"))
    out = str(tmp_path / "out_f32")
    _, summary = run_dataset(ds, cfg, output_dir=out, dtype=jnp.float32)
    assert summary["healthy"], summary
    gt = os.path.join(ds, "mav0", "state_groundtruth_estimate0", "data.csv")
    res = analyse_output_dir(out, gt)
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    rmse = res["position (m)"]["rmse"]
    # about 1.2x the CPU f32 + sqrt result (0.0804 m, RESULTS.md)
    assert rmse < 0.097, (rmse, res)
    assert abs(res["scale"] - 1.0) < 0.05, res["scale"]


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_mh03_proxy_132s_within_euroc_envelope(tmp_path):
    """132 s MH_03_medium motion-statistics proxy: the fast-motion,
    high-landmark-churn regime (BASELINE.json config #3).  Reference anchor: 0.0943 m over 127.4 m
    (EQVIO_results_EuRoC_stationary.yaml MH_03_medium)."""
    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_mh03_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/mh03"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "mh03")
        generate_mh03_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_mh03_proxy.yaml"))
    out = str(tmp_path / "out")
    _, summary = run_dataset(ds, cfg, output_dir=out)
    assert summary["healthy"], summary
    gt = os.path.join(ds, "mav0", "state_groundtruth_estimate0", "data.csv")
    res = analyse_output_dir(out, gt)
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    rmse = res["position (m)"]["rmse"]
    # 1.2x the committed CPU-f64 result (see results/proxy_cpu_f64/mh03_proxy)
    assert rmse < MH03_GATE, (rmse, res)
    assert abs(res["scale"] - 1.0) < 0.05, res["scale"]


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_mh03_proxy_f32_sqrt_production_mode(tmp_path):
    """f32+sqrt production mode on the MH_03 proxy."""
    import jax.numpy as jnp

    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_mh03_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/mh03"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "mh03")
        generate_mh03_proxy(ds)

    cfg = load_config(os.path.join(ROOT, "configs", "config_mh03_proxy.yaml"))
    out = str(tmp_path / "out_f32")
    _, summary = run_dataset(ds, cfg, output_dir=out, dtype=jnp.float32)
    assert summary["healthy"], summary
    gt = os.path.join(ds, "mav0", "state_groundtruth_estimate0", "data.csv")
    res = analyse_output_dir(out, gt)
    assert not res["flags"]["nan"] and not res["flags"]["early_finish"], res["flags"]
    rmse = res["position (m)"]["rmse"]
    assert rmse < MH03_GATE, (rmse, res)
    assert abs(res["scale"] - 1.0) < 0.05, res["scale"]


@pytest.mark.skipif(not SLOW, reason="slow proxy regression; set EQVIO_SLOW=1")
def test_ransac_gate_earns_accuracy_on_distractors(tmp_path):
    """With image-pinned distractor blobs in the scene (lens-dirt class:
    smooth image motion, geometrically impossible tracks), the epipolar
    RANSAC gate must deterministically IMPROVE accuracy over gate-off —
    the gate's first committed accuracy evidence."""
    import copy

    from eqvio_tpu.analysis import analyse_output_dir
    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_distractor_proxy
    from eqvio_tpu.io import load_config

    ds = "/tmp/eqvio_proxies/distractor"
    if not os.path.exists(os.path.join(ds, "proxy_info.yaml")):
        ds = str(tmp_path / "distractor")
        generate_distractor_proxy(ds)

    # the tuned EuRoC config EXACTLY as committed: minInliers=30 keeps the
    # gate active precisely when a large consensus certifies (40 features -
    # 8 distractors = 32 true tracks), which measured BEST (0.0446 m); a
    # lowered minInliers=12 admitted degenerate small-consensus hypotheses
    # and did worse than gate-off (0.0546 vs 0.0534 — round-5 measurement)
    cfg_on = load_config(os.path.join(ROOT, "configs", "config_v101_proxy.yaml"))
    cfg_off = copy.deepcopy(cfg_on)
    cfg_off["GIFT"]["ransacParams"]["inlierThreshold"] = 0.0  # gate disabled

    gt = None
    rmse = {}
    for name, cfg in (("on", cfg_on), ("off", cfg_off)):
        out = str(tmp_path / f"out_{name}")
        _, summary = run_dataset(ds, cfg, output_dir=out)
        gt = os.path.join(ds, "mav0", "state_groundtruth_estimate0", "data.csv")
        res = analyse_output_dir(out, gt)
        assert not res["flags"]["nan"], (name, res["flags"])
        rmse[name] = res["position (m)"]["rmse"]

    # the gate must strictly beat gate-off on the distractor scene, and the
    # gated run must stay within the clean-scene-class budget
    assert rmse["on"] < rmse["off"], rmse
    assert rmse["on"] < 0.15, rmse

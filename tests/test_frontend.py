"""Feature detection + KLT tracking on synthetic rendered frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eqvio_tpu.frontend import (
    TrackerConfig,
    TrackerState,
    build_pyramid,
    detect_features,
    harris_score,
    track_features,
    tracker_init,
    tracker_step,
)

H, W = 120, 160


def render_points(points_xy: np.ndarray, h=H, w=W, sigma=1.5):
    """Render gaussian blobs at (x, y) positions onto a dark image."""
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w), dtype=np.float64)
    for x, y in points_xy:
        img += np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sigma**2))
    return jnp.asarray(np.clip(img, 0, 1), dtype=jnp.float64)


@pytest.fixture
def blob_positions():
    rng = np.random.default_rng(8)
    pts = rng.uniform([30, 30], [W - 30, H - 30], size=(8, 2))
    # enforce pairwise separation
    keep = []
    for p in pts:
        if all(np.linalg.norm(p - q) > 25 for q in keep):
            keep.append(p)
    return np.asarray(keep)


def test_detect_features_finds_blobs(blob_positions):
    img = render_points(blob_positions)
    pos, valid = detect_features(img, max_features=16, min_dist=8, border=10)
    pos = np.asarray(pos)[np.asarray(valid)]
    assert len(pos) >= len(blob_positions) - 1
    # every blob matched by some detection within 2 px
    for b in blob_positions:
        d = np.linalg.norm(pos - b, axis=-1).min()
        assert d < 2.0, f"blob at {b} not detected (nearest {d:.1f} px)"


def test_klt_tracks_translation(blob_positions):
    shift = np.array([3.4, -2.2])
    img0 = render_points(blob_positions)
    img1 = render_points(blob_positions + shift)
    pyr0 = build_pyramid(img0, 3)
    pyr1 = build_pyramid(img1, 3)
    pos0 = jnp.asarray(blob_positions)
    mask = jnp.ones(len(blob_positions), dtype=bool)
    pos1, tracked = track_features(pyr0, pyr1, pos0, mask, win=15)
    assert bool(jnp.all(tracked))
    err = np.linalg.norm(np.asarray(pos1) - (blob_positions + shift), axis=-1)
    assert err.max() < 0.3, err


def test_tracker_full_loop(blob_positions):
    """Detect on frame 0, track over a drifting sequence, ids persist."""
    cfg = TrackerConfig(max_features=12, feature_dist=10, win_size=15, max_level=2,
                        max_error=0.2, tracked_feature_dist=10.0)
    state = tracker_init(cfg, (H, W), dtype=jnp.float64)
    vel = np.array([1.5, 1.0])
    ids_at = {}
    for k in range(6):
        img = render_points(blob_positions + k * vel)
        state = tracker_step(state, img, cfg)
        if k == 1:
            ids_at[1] = (np.asarray(state.ids).copy(), np.asarray(state.positions).copy())
    n_tracked = int(np.asarray(state.mask).sum())
    assert n_tracked >= len(blob_positions) - 1

    # ids persisted from frame 1 to the end for still-visible features
    ids1, _ = ids_at[1]
    ids_end = np.asarray(state.ids)
    common = set(ids1[ids1 >= 0]) & set(ids_end[ids_end >= 0])
    assert len(common) >= len(blob_positions) - 2

    # tracked positions match the true blob motion
    pos_end = np.asarray(state.positions)[np.asarray(state.mask)]
    true_end = blob_positions + 5 * vel
    for t in true_end:
        if (30 < t[0] < W - 30) and (30 < t[1] < H - 30):
            assert np.linalg.norm(pos_end - t, axis=-1).min() < 1.0


def test_median_flow_gate(blob_positions):
    """A track that jumps against the median flow gets dropped."""
    cfg = TrackerConfig(max_features=12, feature_dist=10, win_size=15, max_level=2,
                        max_error=0.2, tracked_feature_dist=10.0,
                        flow_outlier_threshold=3.0)
    state = tracker_init(cfg, (H, W), dtype=jnp.float64)
    vel = np.array([1.0, 0.5])
    state = tracker_step(state, render_points(blob_positions), cfg)
    n0 = int(np.asarray(state.mask).sum())
    # move all blobs uniformly except one that jumps wildly
    moved = blob_positions + vel
    moved[0] += np.array([12.0, -9.0])
    state = tracker_step(state, render_points(moved), cfg)
    # the outlier track is either dropped or re-detected with a NEW id
    ids = np.asarray(state.ids)
    pos = np.asarray(state.positions)[np.asarray(state.mask)]
    d_out = np.linalg.norm(pos - moved[0], axis=-1).min() if len(pos) else 1e9
    # the consistent tracks survive
    assert int(np.asarray(state.mask).sum()) >= n0 - 2


def test_tracker_matches_numpy_reference(blob_positions):
    """Batched pyramidal tracking == the plain numpy coarse-to-fine LK."""
    from .utils import np_track_features

    shift = np.array([2.1, -1.4])
    img0 = render_points(blob_positions)
    img1 = render_points(blob_positions + shift)
    pyr0 = build_pyramid(img0, 3)
    pyr1 = build_pyramid(img1, 3)
    pos = jnp.asarray(blob_positions)
    mask = jnp.ones(len(blob_positions), dtype=bool)
    p, t = track_features(pyr0, pyr1, pos, mask, win=15)
    p_ref, err_ref = np_track_features(pyr0, pyr1, blob_positions, blob_positions, win=15)
    np.testing.assert_allclose(np.asarray(p), p_ref, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(t), err_ref < 0.05)


def test_tracker_matches_numpy_reference_at_borders(blob_positions):
    """Features whose windows clip the image border — especially at coarse
    pyramid levels where the window covers a large image fraction — sample
    with per-sample clamping (edge replication), as the numpy reference
    does; whole patches are never shifted."""
    from .utils import np_track_features

    shift = np.array([1.6, -1.1])
    img0 = render_points(blob_positions)
    H, W = img0.shape
    img1 = render_points(blob_positions + shift)
    # 3 levels: at level 2 the image is ~H/4 x W/4, so a 15px window clips
    # the border for most features
    pyr0 = build_pyramid(img0, 3)
    pyr1 = build_pyramid(img1, 3)
    # features near (but inside) every border + corners
    m = 9.0
    border_pts = np.array([
        [m, H / 2], [W - m, H / 2], [W / 2, m], [W / 2, H - m],
        [m + 2, m + 2], [W - m - 2, m + 2], [m + 2, H - m - 2],
        [W - m - 2, H - m - 2],
    ])
    pos = jnp.asarray(border_pts)
    mask = jnp.ones(len(border_pts), dtype=bool)
    p, _ = track_features(pyr0, pyr1, pos, mask, win=15)
    p_ref, _ = np_track_features(pyr0, pyr1, border_pts, border_pts, win=15)
    np.testing.assert_allclose(np.asarray(p), p_ref, atol=1e-5)


def test_feature_search_threshold_gates_topup(blob_positions):
    """With featureSearchThreshold < 1, no new features are admitted while
    enough tracks survive (GIFT featureSearchThreshold semantics)."""
    cfg = TrackerConfig(max_features=8, feature_dist=8, win_size=9, max_level=1,
                        max_error=0.5, feature_search_threshold=0.5)
    img = render_points(blob_positions)
    ts = tracker_init(cfg, (H, W), dtype=img.dtype)
    ts = tracker_step(ts, img, cfg)  # initial fill: empty tracker searches
    n0 = int(jnp.sum(ts.mask))
    assert n0 >= 4
    ids0 = np.asarray(ts.ids)

    # same frame again: all tracks survive (>= 50% of capacity), so no top-up
    ts2 = tracker_step(ts, img, cfg)
    assert int(ts2.next_id) == int(ts.next_id)
    surviving = np.asarray(ts2.ids)[np.asarray(ts2.mask)]
    assert set(surviving).issubset(set(ids0[ids0 >= 0]))

    # threshold 1.0 keeps topping up free slots when some exist
    cfg_full = TrackerConfig(max_features=8, feature_dist=8, win_size=9,
                             max_level=1, max_error=0.5)
    ts3 = tracker_step(tracker_init(cfg_full, (H, W), dtype=img.dtype), img, cfg_full)
    assert int(jnp.sum(ts3.mask)) >= n0

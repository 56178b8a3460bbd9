"""Pyramidal KLT (``frontend.klt``) against a plain numpy reference: one
level, level chaining with predicted guesses, windows that cross the image
border, and the vmapped fleet form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eqvio_tpu.frontend.klt import _bilinear, _track_level, track_features
from eqvio_tpu.frontend.pyramid import _blur_downsample, build_pyramid

from .utils import np_bilinear, np_track_features, np_track_level

H, W = 128, 384


def render(points, h=H, w=W, sigma=1.5):
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w), dtype=np.float32)
    for x, y in points:
        img += np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sigma**2))
    return jnp.asarray(np.clip(img, 0, 1))


def test_single_level_recovers_subpixel_shift():
    """One level: every feature recovers a known sub-pixel shift."""
    rng = np.random.default_rng(3)
    pts = rng.uniform([25, 25], [W - 25, H - 25], size=(6, 2)).astype(np.float32)
    shift = np.array([2.3, -1.7], dtype=np.float32)
    img0, img1 = render(pts), render(pts + shift)
    pos = jnp.asarray(pts)
    out = [_track_level(img0, img1, p, p, 15, 8, jnp.float32) for p in pos]
    track_err = np.linalg.norm(np.stack([np.asarray(p) for p, _ in out]) - (pts + shift), axis=-1)
    assert track_err.max() < 0.3, track_err
    assert all(float(e) < 0.05 for _, e in out)


def test_level_chaining_matches_numpy_reference():
    """Three levels with level chaining and predicted guesses: equal to the
    coarse-to-fine numpy reference, and on target."""
    rng = np.random.default_rng(7)
    pts = rng.uniform([25, 25], [W - 25, H - 25], size=(8, 2)).astype(np.float32)
    shift = np.array([-1.4, 2.1], dtype=np.float32)
    pyr0 = build_pyramid(render(pts), 3)
    pyr1 = build_pyramid(render(pts + shift), 3)
    pos = jnp.asarray(pts)
    guess = pos + jnp.asarray([-1.0, 1.5], jnp.float32)
    p, tracked = track_features(pyr0, pyr1, pos, jnp.ones(len(pts), bool), guess, win=15)
    p_ref, err_ref = np_track_features(pyr0, pyr1, pts, np.asarray(guess), win=15)
    np.testing.assert_allclose(np.asarray(p), p_ref, atol=1e-3)
    assert np.asarray(tracked).all() and (err_ref < 0.05).all()
    np.testing.assert_allclose(np.asarray(p), pts + shift, atol=0.3)


def test_track_level_at_borders_matches_numpy_reference():
    """Border semantics (per-sample edge replication): features within one
    window of every border on a coarse-level-sized image, where a window
    covers a large part of the image."""
    rng = np.random.default_rng(0)
    h, w = 60, 80
    img0 = _blur_downsample(jnp.asarray(rng.uniform(0, 1, (2 * h, 2 * w)).astype(np.float32)))
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
                          indexing="ij")
    img1 = _bilinear(img0, jnp.stack([xx - 0.7, yy + 0.4], axis=-1))
    pts = np.array([[6.0, 30.0], [74.0, 30.0], [40.0, 5.0], [40.0, 55.0],
                    [7.0, 7.0], [73.0, 53.0], [40.0, 30.0]], np.float32)
    win, iters = 21, 8
    for p in pts:
        got, err = _track_level(img0, img1, jnp.asarray(p), jnp.asarray(p), win, iters,
                                jnp.float32)
        want, err_ref = np_track_level(np.asarray(img0, float), np.asarray(img1, float),
                                       p, p, win, iters)
        np.testing.assert_allclose(np.asarray(got), want, atol=2e-3)
        np.testing.assert_allclose(float(err), err_ref, atol=1e-4)


@pytest.mark.parametrize("x,y", [(-3.0, 10.0), (85.2, 10.5), (40.5, -1.0), (12.25, 70.0),
                                 (79.0, 59.0), (0.0, 0.0), (33.3, 21.7)])
def test_bilinear_clamps_each_sample(x, y):
    """Samples outside the image take the nearest edge value; inside, the
    bilinear blend — equal to the numpy reference everywhere."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (60, 80))
    got = _bilinear(jnp.asarray(img), jnp.asarray([[x, y]]))[0]
    np.testing.assert_allclose(float(got), np_bilinear(img, np.array(x), np.array(y)),
                               rtol=1e-12, atol=1e-12)


def test_track_features_dtypes_and_flags():
    """f64 inputs come back f64; features that leave the image are dropped."""
    pts = np.array([[60.0, 40.0], [200.0, 90.0], [300.0, 64.0], [381.0, 64.0]])
    pyr0 = build_pyramid(render(pts).astype(jnp.float64), 2)
    pyr1 = build_pyramid(render(pts + 1.0).astype(jnp.float64), 2)
    pos = jnp.asarray(pts)
    q, t = track_features(pyr0, pyr1, pos, jnp.ones(4, bool), win=9, iters=4)
    assert q.shape == (4, 2) and q.dtype == jnp.float64
    assert t.shape == (4,) and t.dtype == jnp.bool_
    assert np.asarray(t).tolist() == [True, True, True, False]


def test_vmapped_tracker_matches_per_sequence():
    """The tracker-inclusive fleet vmaps the tracker over sequences; each
    sequence's result equals its own call."""
    rng = np.random.default_rng(5)
    pts = rng.uniform([25, 25], [W - 25, H - 25], size=(2, 4, 2)).astype(np.float32)
    img0 = jnp.stack([render(p) for p in pts])
    img1 = jnp.stack([render(p + [1.2, -0.6]) for p in pts])
    pos = jnp.asarray(pts)
    mask = jnp.ones(4, bool)
    f = lambda a, b, p: track_features([a], [b], p, mask, win=11, iters=4)
    pb, tb = jax.vmap(f)(img0, img1, pos)
    for k in range(2):
        pk, tk = f(img0[k], img1[k], pos[k])
        np.testing.assert_allclose(np.asarray(pb[k]), np.asarray(pk), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(tk))

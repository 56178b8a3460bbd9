"""Corner detection: Shi-Tomasi/Harris response, NMS, masked top-K selection.

Equivalent of GIFT's feature detection (used by the reference via
``GIFT::PointFeatureTracker``, ``main_opt.cpp:153-208``; config keys
``maxFeatures / featureDist / minHarrisQuality`` from
``EQVIO_config_template.yaml:52-62``).

Every separable filter runs as two banded matmuls (``V @ img @ H^T``); the
NMS max-pool is decomposed into row and column passes; and the keep-away
zone around existing tracks is enforced in candidate space (K x M
distances) instead of a dense [M, H, W] field.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=64)
def _band_matrix(n: int, taps: tuple, stride: int = 1, dtype_str: str = "float32"):
    """[ceil(n/stride), n] banded matrix applying a centred 1-D filter.

    Returns a NUMPY array: caching a jnp array would capture a tracer when
    first built inside a jit trace and leak it into later traces.
    """
    k = len(taps)
    r = (k - 1) // 2
    rows = (n + stride - 1) // stride
    M = np.zeros((rows, n), dtype=dtype_str)
    for i in range(rows):
        c = i * stride
        for t, w in enumerate(taps):
            j = c + t - r
            if 0 <= j < n:
                M[i, j] += w
    return M


def _sep_filter(img: jnp.ndarray, v_taps: tuple, h_taps: tuple, stride: int = 1):
    """Separable filter as two banded matmuls (same zero-padding semantics)."""
    H, W = img.shape
    ds = str(img.dtype)
    V = _band_matrix(H, v_taps, stride, ds)
    Hm = _band_matrix(W, h_taps, stride, ds)
    return V @ img @ Hm.T


def sobel_gradients(img: jnp.ndarray):
    smooth = (0.25, 0.5, 0.25)
    diff = (-0.5, 0.0, 0.5)
    Ix = _sep_filter(img, smooth, diff)
    Iy = _sep_filter(img, diff, smooth)
    return Ix, Iy


def harris_score(img: jnp.ndarray, window: int = 5) -> jnp.ndarray:
    """Shi-Tomasi (min-eigenvalue) corner response [H, W]."""
    Ix, Iy = sobel_gradients(img)
    box = tuple([1.0 / window] * window)
    Ixx = _sep_filter(Ix * Ix, box, box)
    Iyy = _sep_filter(Iy * Iy, box, box)
    Ixy = _sep_filter(Ix * Iy, box, box)
    half_tr = 0.5 * (Ixx + Iyy)
    disc = jnp.sqrt(jnp.clip((0.5 * (Ixx - Iyy)) ** 2 + Ixy * Ixy, 0.0, None))
    return half_tr - disc  # min eigenvalue


def _max_pool_same(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Separable (row, then column) max filter — 2k ops/px instead of k^2."""
    row = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, size), (1, 1), "SAME")
    return jax.lax.reduce_window(row, -jnp.inf, jax.lax.max, (size, 1), (1, 1), "SAME")


def detect_features(
    img: jnp.ndarray,
    max_features: int,
    min_dist: int = 20,
    quality: float = 0.05,
    border: int = 21,
    exclude: jnp.ndarray | None = None,
    exclude_mask: jnp.ndarray | None = None,
    exclude_dist: float = 20.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Detect up to ``max_features`` corners with non-max suppression.

    ``exclude [M, 2]`` + ``exclude_mask [M]``: existing feature positions to
    stay ``exclude_dist`` away from (GIFT ``trackedFeatureDist``).

    Returns ``(positions [K, 2] (x, y) pixel coords, valid [K])``.
    """
    H, W = img.shape
    score = harris_score(img)
    peak = jnp.max(score)
    is_max = (score >= _max_pool_same(score, 2 * min_dist + 1) - 1e-12) & (
        score > quality * peak
    )
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )
    cand_score = jnp.where(is_max & inside, score, -jnp.inf)

    # take extra candidates, then reject those near existing tracks in
    # candidate space (K2 x M distances, not a dense image field)
    K2 = max_features * 3 if exclude is not None else max_features
    flat = cand_score.reshape(-1)
    vals, lin = jax.lax.top_k(flat, K2)
    pos = jnp.stack(
        [(lin % W).astype(img.dtype), (lin // W).astype(img.dtype)], axis=-1
    )
    valid = jnp.isfinite(vals) & (vals > 0)

    if exclude is not None:
        ex = jnp.where(exclude_mask[:, None], exclude, -1e6)
        d2 = jnp.sum((pos[:, None, :] - ex[None, :, :]) ** 2, axis=-1)  # [K2, M]
        clear = jnp.min(d2, axis=1) > exclude_dist**2
        valid = valid & clear
        # compact the first max_features surviving candidates (int32 sort
        # keys/indices: jnp.argsort would emit int64 under x64)
        _, order = jax.lax.sort(
            ((~valid).astype(jnp.int32),
             jax.lax.iota(jnp.int32, valid.shape[0])),
            num_keys=1, is_stable=True,
        )
        pos = pos[order][:max_features]
        valid = valid[order][:max_features]

    return pos, valid


def equalize_histogram(img: jnp.ndarray, bins: int = 256) -> jnp.ndarray:
    """Histogram equalisation of a [0, 1] image (GIFT ``equaliseImageHistogram``)."""
    flat = jnp.clip(img.reshape(-1), 0.0, 1.0)
    idx = jnp.clip((flat * (bins - 1)).astype(jnp.int32), 0, bins - 1)
    hist = jnp.zeros(bins, dtype=img.dtype).at[idx].add(1.0)
    cdf = jnp.cumsum(hist)
    cdf = (cdf - cdf[0]) / jnp.clip(cdf[-1] - cdf[0], 1.0, None)
    return cdf[idx].reshape(img.shape)

"""Pyramidal Lucas-Kanade feature tracking, batched over features.

Equivalent of GIFT's pyramidal KLT (``winSize / maxLevel / maxError`` config
keys, reference ``EQVIO_config_template.yaml:56-58``).  All features track
simultaneously: patch gathers are batched bilinear interpolations and the
per-feature 2x2 normal equations solve in closed form.  No data-dependent
control flow — fixed iteration counts.

One path serves every backend: ``_track_level`` per feature and level,
vmapped over features (its comparison with a fused kernel on the GPU is in
PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _bilinear(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of ``img [H, W]`` at ``xy [..., 2]`` (x, y) coords."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def _patch_coords(center: jnp.ndarray, win: int) -> jnp.ndarray:
    """[win, win, 2] sample coordinates around ``center`` (x, y)."""
    r = (win - 1) / 2.0
    offs = jnp.arange(win, dtype=center.dtype) - r
    ox = jnp.broadcast_to(offs[None, :], (win, win))
    oy = jnp.broadcast_to(offs[:, None], (win, win))
    return center[None, None, :] + jnp.stack([ox, oy], axis=-1)


def _track_level(img_prev, img_next, pos_prev, guess, win, iters, dtype):
    """One pyramid level of LK for a single feature.

    ``pos_prev``: feature position in the previous image (this level's scale).
    ``guess``: current estimate of the position in the next image.
    Returns ``(refined position, residual error)``.
    """
    coords = _patch_coords(pos_prev, win)  # [w,w,2]
    template = _bilinear(img_prev, coords)
    # spatial gradients of the template (central differences via sampling)
    ex = jnp.zeros((2,), dtype).at[0].set(0.5)
    ey = jnp.zeros((2,), dtype).at[1].set(0.5)
    gx = _bilinear(img_prev, coords + ex * 2) - _bilinear(img_prev, coords - ex * 2)
    gy = _bilinear(img_prev, coords + ey * 2) - _bilinear(img_prev, coords - ey * 2)
    # normal matrix (constant across iterations — inverse compositional flavour)
    gxx = jnp.sum(gx * gx)
    gxy = jnp.sum(gx * gy)
    gyy = jnp.sum(gy * gy)
    det = gxx * gyy - gxy * gxy
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    def body(_, carry):
        p, _err = carry
        patch = _bilinear(img_next, _patch_coords(p, win))
        diff = patch - template
        bx = jnp.sum(diff * gx)
        by = jnp.sum(diff * gy)
        dx = (gyy * bx - gxy * by) / det
        dy = (gxx * by - gxy * bx) / det
        p_new = p - jnp.stack([dx, dy])
        err = jnp.mean(jnp.abs(diff))
        return p_new, err

    p, err = jax.lax.fori_loop(0, iters, body, (guess, jnp.asarray(jnp.inf, dtype)))
    return p, err


def track_features(
    pyr_prev: list[jnp.ndarray],
    pyr_next: list[jnp.ndarray],
    positions: jnp.ndarray,  # [N, 2] (x, y) in full-res coords
    mask: jnp.ndarray,  # [N]
    predicted: jnp.ndarray | None = None,  # [N, 2] optional initial guesses
    win: int = 21,
    iters: int = 8,
    max_error: float = 0.05,
):
    """Track all features from ``pyr_prev`` to ``pyr_next``.

    Returns ``(new_positions [N, 2], tracked [N])`` where ``tracked`` clears
    features that left the image or exceeded ``max_error`` mean residual
    (GIFT ``maxError``).
    """
    dtype = positions.dtype
    levels = len(pyr_prev)
    H, W = pyr_prev[0].shape
    if predicted is None:
        predicted = positions

    def track_one(pos, guess):
        scale = 2.0 ** (levels - 1)
        p = guess / scale
        err = jnp.asarray(0.0, dtype)
        for lvl in range(levels - 1, -1, -1):
            s = 2.0**lvl
            p = p * (2.0 if lvl < levels - 1 else 1.0)
            p, err = _track_level(
                pyr_prev[lvl], pyr_next[lvl], pos / s, p, win, iters, dtype
            )
        return p, err

    new_pos, errs = jax.vmap(track_one)(positions, predicted)
    margin = (win - 1) / 2 + 2
    inside = (
        (new_pos[:, 0] >= margin)
        & (new_pos[:, 0] < W - margin)
        & (new_pos[:, 1] >= margin)
        & (new_pos[:, 1] < H - margin)
    )
    tracked = mask & inside & (errs < max_error)
    return new_pos, tracked

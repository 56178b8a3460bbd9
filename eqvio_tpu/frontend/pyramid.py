"""Image pyramids for coarse-to-fine tracking (GIFT ``maxLevel`` equivalent).

The 5-tap binomial blur + 2x decimation runs as two banded matmuls
(``V @ img @ H^T``) instead of a single-channel convolution.
"""

from __future__ import annotations

import jax.numpy as jnp

from .detector import _band_matrix


def _blur_downsample(img: jnp.ndarray) -> jnp.ndarray:
    """5-tap binomial blur + 2x decimation via banded matmuls."""
    H, W = img.shape
    taps = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    ds = str(img.dtype)
    V = _band_matrix(H, taps, 2, ds)
    Hm = _band_matrix(W, taps, 2, ds)
    return V @ img @ Hm.T


def build_pyramid(img: jnp.ndarray, levels: int) -> list[jnp.ndarray]:
    """List of ``levels`` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur_downsample(pyr[-1]))
    return pyr

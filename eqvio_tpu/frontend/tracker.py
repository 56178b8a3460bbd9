"""Slot-based point-feature tracker: GIFT ``PointFeatureTracker`` equivalent.

Combines KLT tracking with corner re-detection under the same fixed-capacity
slot protocol the filter uses (see ``eqvio_tpu.filter``): a feature keeps its
slot while tracked; freed slots are refilled from newly detected corners with
fresh ids.  The whole per-frame step is one jittable pure function.

Reference behaviour mirrored: ``GIFT::PointFeatureTracker::processImage``
with predicted coordinates (``main_opt.cpp:186-208``), config keys
``maxFeatures / featureDist / minHarrisQuality / winSize / maxLevel /
maxError / trackedFeatureDist`` (``EQVIO_config_template.yaml:52-62``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .detector import detect_features, equalize_histogram
from .klt import track_features
from .pyramid import build_pyramid
from .ransac import ransac_epipolar_mask


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_features: int = 30  # also the slot capacity
    feature_dist: int = 20  # NMS radius for new detections
    min_harris_quality: float = 0.05
    tracked_feature_dist: float = 20.0  # keep-away radius around live tracks
    win_size: int = 21
    max_level: int = 3
    max_error: float = 0.05
    # only admit new detections when live tracks < threshold * maxFeatures
    # (GIFT featureSearchThreshold semantics); 1.0 = always top up
    feature_search_threshold: float = 1.0
    equalize_histogram: bool = False
    flow_outlier_threshold: float = 0.0  # median-flow gate (px); 0 disables
    # batched epipolar RANSAC gate (GIFT ransacParams equivalent);
    # threshold is the Sampson inlier distance in px, 0 disables
    ransac_inlier_threshold: float = 0.0
    ransac_hypotheses: int = 64  # simultaneous minimal samples (maxIterations)
    ransac_min_inliers: int = 8  # keep-all guard (minInliers)


class TrackerState(NamedTuple):
    positions: jnp.ndarray  # [N, 2] (x, y)
    ids: jnp.ndarray  # [N] int32, -1 when free
    mask: jnp.ndarray  # [N] bool
    next_id: jnp.ndarray  # scalar int32
    pyramid: tuple  # previous frame pyramid
    # did the last step run the corner detector? (the featureSearchThreshold
    # cond-gate skips it on healthy frames; surfaced so the app can count the
    # searched-frame fraction and attribute per-frame device time)
    searched: jnp.ndarray = jnp.asarray(True)


def tracker_init(config: TrackerConfig, image_shape, dtype=jnp.float32) -> TrackerState:
    N = config.max_features
    H, W = image_shape
    levels = config.max_level + 1
    shapes = [(H, W)]
    for _ in range(levels - 1):
        h, w = shapes[-1]
        shapes.append((-(-h // 2), -(-w // 2)))  # ceil, matching _band_matrix
    pyr = tuple(jnp.zeros(s, dtype=dtype) for s in shapes)
    return TrackerState(
        positions=jnp.zeros((N, 2), dtype=dtype),
        ids=-jnp.ones((N,), dtype=jnp.int32),
        mask=jnp.zeros((N,), dtype=bool),
        next_id=jnp.asarray(0, dtype=jnp.int32),
        pyramid=pyr,
        searched=jnp.asarray(True),
    )


def tracker_step(
    state: TrackerState,
    image: jnp.ndarray,
    config: TrackerConfig,
    predicted: jnp.ndarray | None = None,
) -> TrackerState:
    """Process one frame: track live slots, drop failures, refill free slots.

    ``predicted [N, 2]``: optional filter-predicted coordinates used as the
    KLT initial guess (reference ``getFeaturePredictions``,
    ``VIOFilter.cpp:247-252``).
    """
    if config.equalize_histogram:
        image = equalize_histogram(image)
    pyr = build_pyramid(image, config.max_level + 1)

    # 1. track existing features
    new_pos, tracked = track_features(
        list(state.pyramid),
        list(pyr),
        state.positions,
        state.mask,
        predicted=predicted,
        win=config.win_size,
        max_error=config.max_error,
    )
    # epipolar RANSAC gate (GIFT ransacParams equivalent): drop tracks that
    # violate the consensus two-view geometry between previous and current
    # frame; all hypotheses solved in one batched eigendecomposition
    if config.ransac_inlier_threshold > 0:
        # uint32 seed: a python-int seed becomes an i64 random_seed op
        # under x64.  EQVIO_RANSAC_SEED exists for gate-stability
        # experiments.
        import os as _os

        _seed = np.uint32(int(_os.environ.get("EQVIO_RANSAC_SEED", "7")))
        key = jax.random.fold_in(jax.random.PRNGKey(_seed), state.next_id)
        tracked = ransac_epipolar_mask(
            state.positions,
            new_pos,
            tracked,
            key,
            threshold=config.ransac_inlier_threshold,
            hypotheses=config.ransac_hypotheses,
            min_inliers=config.ransac_min_inliers,
        )
    # median-flow outlier gate: drop tracks whose flow deviates from the
    # masked median flow (cheap complement to the RANSAC stage)
    if config.flow_outlier_threshold > 0:
        flow = new_pos - state.positions
        big = jnp.asarray(1e9, dtype=flow.dtype)
        fx = jnp.where(tracked, flow[:, 0], big)
        fy = jnp.where(tracked, flow[:, 1], big)
        n_tr = jnp.sum(tracked).astype(jnp.int32)  # i64 under x64 otherwise
        med_idx = jnp.clip(n_tr // 2, 0, flow.shape[0] - 1)
        med = jnp.stack([jnp.sort(fx)[med_idx], jnp.sort(fy)[med_idx]])
        dev = jnp.linalg.norm(flow - med, axis=-1)
        tracked = tracked & ((dev < config.flow_outlier_threshold) | (n_tr < 4))

    positions = jnp.where(tracked[:, None], new_pos, state.positions)
    ids = jnp.where(tracked, state.ids, -1)
    mask = tracked

    # 2. detect new corners away from live tracks
    N = config.max_features

    def _detect(_):
        return detect_features(
            image,
            max_features=N,
            min_dist=config.feature_dist,
            quality=config.min_harris_quality,
            border=config.win_size,
            exclude=positions,
            exclude_mask=mask,
            exclude_dist=config.tracked_feature_dist,
        )

    searching = jnp.asarray(True)
    if config.feature_search_threshold < 1.0:
        # GIFT featureSearchThreshold semantics: only look for new corners
        # when live tracks drop below threshold * maxFeatures.  lax.cond
        # executes only the taken branch, so a healthy tracker skips the
        # whole detector per frame.
        searching = jnp.sum(mask) < config.feature_search_threshold * N
        cand_pos, cand_valid = jax.lax.cond(
            searching,
            _detect,
            lambda _: (
                jnp.zeros((N, 2), dtype=positions.dtype),
                jnp.zeros((N,), dtype=bool),
            ),
            operand=None,
        )
    else:
        cand_pos, cand_valid = _detect(None)

    # 3. fill free slots in order with valid candidates
    free = ~mask
    k = jnp.arange(N, dtype=jnp.int32)
    free_slots = jnp.sort(jnp.where(free, k, N))
    cand_idx = jnp.sort(jnp.where(cand_valid, k, N))
    n_assign = jnp.minimum(
        jnp.sum(free).astype(jnp.int32), jnp.sum(cand_valid).astype(jnp.int32)
    )
    target_slot = jnp.where(k < n_assign, free_slots[k], N)
    src = jnp.clip(cand_idx[k], 0, N - 1)
    new_ids = state.next_id + jnp.arange(N, dtype=jnp.int32)
    positions = positions.at[target_slot].set(cand_pos[src], mode="drop")
    ids = ids.at[target_slot].set(jnp.where(k < n_assign, new_ids, -1), mode="drop")
    mask = mask.at[target_slot].set(k < n_assign, mode="drop")

    return TrackerState(
        positions=positions,
        ids=ids,
        mask=mask,
        next_id=state.next_id + n_assign.astype(jnp.int32),
        pyramid=tuple(pyr),
        searched=searching,
    )

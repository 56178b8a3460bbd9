"""Batched fundamental-matrix RANSAC gate for tracked features.

Replacement for GIFT's RANSAC outlier-rejection stage
(reference config keys ``GIFT:ransacParams:{inlierThreshold, maxIterations,
minDataPoints, minInliers}``, used by ``GIFT::PointFeatureTracker`` inside
``processImage``; see SURVEY.md section 2.8).  Instead of the classical
sequential hypothesise-and-verify loop (data-dependent iteration counts are
jit-hostile), ALL hypotheses are solved simultaneously:

- sample K hypotheses of 8 correspondences each with one masked argsort,
- solve the normalised 8-point problem for all K at once: the nullspace
  direction of ``A^T A`` via batched unrolled inverse iteration (no linalg
  custom-calls anywhere in the gate),
- enforce rank 2 from the smallest singular pairs, same machinery,
- score every correspondence against every hypothesis with one batched
  Sampson-distance evaluation ``[K, N]``,
- pick the hypothesis with the most masked inliers.

Everything is static-shape and fully jittable; the whole gate compiles into
a handful of fused XLA ops (K*N is tiny next to the image kernels).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _normalize(pts: jnp.ndarray, mask: jnp.ndarray):
    """Masked Hartley normalisation: centroid 0, RMS distance sqrt(2).

    Returns normalised points and the isotropic scale ``s`` (so a pixel
    distance d corresponds to ``s * d`` in normalised units).
    """
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.linalg.norm(pts - c, axis=-1)
    mean_d = jnp.maximum(jnp.sum(d * w) / n, 1e-9)
    s = jnp.sqrt(2.0).astype(pts.dtype) / mean_d
    return (pts - c) * s, s


def _constraint_rows(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Rows of the epipolar constraint ``x2^T F x1 = 0``: ``[..., 9]``."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(x1)
    return jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )


def _cholesky_small(G: jnp.ndarray) -> list:
    """Unrolled lower-Cholesky of a tiny batched SPD matrix ``[..., n, n]``.

    Returns the factor as a list-of-lists of batched scalars.  For n <= 9
    this is ~n^2/2 fused elementwise ops — no linalg custom-call, no loop
    carry, so XLA fuses the whole factorisation into a few vector kernels
    (the batched QDWH eigh it replaces cost ~1.3 ms/frame of custom-call
    device time in the round-5 XLA trace).
    """
    n = G.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_small(L: list, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``L L^T x = b`` with the unrolled factor; ``b: [..., n]``."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def smallest_eigvec(G: jnp.ndarray, iters: int = 6) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a tiny batched PSD
    ``G: [..., n, n]`` via regularised inverse iteration.

    The gate only ever needs the minimal eigenvector (the 8-point nullspace
    / smallest singular pair), never the full decomposition; per-iteration
    error contraction is ``(lam_min + eps) / (lam_next + eps)`` with
    ``eps ~ 1e-7 tr(G)``; six iterations give <1e-4 alignment error even
    for a benign 5x eigenvalue gap, and f32 round-off for the near-null
    gaps the gate actually produces.  All elementwise/fused ops — replaces the
    ``jnp.linalg.eigh`` QDWH custom-calls (the dominant non-KLT device cost
    of the tracker, round-5 trace).
    """
    n = G.shape[-1]
    tr = jnp.trace(G, axis1=-2, axis2=-1)[..., None, None]
    eye = jnp.eye(n, dtype=G.dtype)
    L = _cholesky_small(G + (1e-7 * tr + 1e-30) * eye)
    # deterministic, non-axis-aligned start (never orthogonal to the target
    # in any systematic way)
    v = jnp.broadcast_to(
        1.0 + 0.01 * jnp.arange(n, dtype=G.dtype), G.shape[:-1]
    )
    for _ in range(iters):
        v = _chol_solve_small(L, v)
        v = v / jnp.clip(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30, None)
    return v


def _rank2(F: jnp.ndarray) -> jnp.ndarray:
    """Rank-2 projection of ``F: [K, 3, 3]`` (subtract the smallest singular
    triplet).  The smallest singular pair is exactly the smallest
    eigenvectors of ``F^T F`` / ``F F^T``, so both come from
    :func:`smallest_eigvec` (no batched SVD or eigh solver calls).
    ``F - u3 (u3^T F v3) v3^T`` equals zeroing ``sigma_3`` (sign-invariant).
    """
    v3 = smallest_eigvec(jnp.einsum("kij,kil->kjl", F, F))  # F^T F
    u3 = smallest_eigvec(jnp.einsum("kij,klj->kil", F, F))  # F F^T
    s3 = jnp.einsum("ki,kij,kj->k", u3, F, v3)
    return F - s3[:, None, None] * u3[:, :, None] * v3[:, None, :]


def _eight_point(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Batched 8-point fundamental matrices.

    ``p1, p2: [K, 8, 2]`` normalised correspondences -> ``F: [K, 3, 3]``
    with rank 2 enforced, satisfying ``x2^T F x1 = 0``.
    """
    A = _constraint_rows(p1, p2)  # [K, 8, 9]
    G = jnp.einsum("kri,krj->kij", A, A)  # [K, 9, 9]
    f = smallest_eigvec(G)  # the 8-point nullspace direction
    return _rank2(f.reshape(-1, 3, 3))


def _sampson(F: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Sampson distance of every correspondence under every hypothesis.

    ``F: [K, 3, 3]``, ``p1, p2: [N, 2]`` -> ``[K, N]`` (first-order geometric
    reprojection error, in the units of the input coordinates).
    """
    ones = jnp.ones((p1.shape[0], 1), dtype=p1.dtype)
    x1 = jnp.concatenate([p1, ones], axis=-1)  # [N, 3]
    x2 = jnp.concatenate([p2, ones], axis=-1)
    Fx1 = jnp.einsum("kij,nj->kni", F, x1)  # [K, N, 3]
    Ftx2 = jnp.einsum("kji,nj->kni", F, x2)
    num = jnp.square(jnp.einsum("ni,kni->kn", x2, Fx1))
    den = (
        jnp.square(Fx1[..., 0])
        + jnp.square(Fx1[..., 1])
        + jnp.square(Ftx2[..., 0])
        + jnp.square(Ftx2[..., 1])
    )
    return num / jnp.maximum(den, 1e-12)


def ransac_epipolar_mask(
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    threshold: float = 1.0,
    hypotheses: int = 64,
    min_points: int = 8,
    min_inliers: int = 8,
) -> jnp.ndarray:
    """Refine ``mask`` by epipolar-consistency RANSAC between two frames.

    Args:
      prev, curr: ``[N, 2]`` pixel positions in the previous / current frame.
      mask: ``[N]`` bool, tracks considered.
      key: PRNG key for hypothesis sampling.
      threshold: Sampson-distance inlier threshold in PIXELS.
      hypotheses: number of simultaneous minimal-sample hypotheses (the
        batched analogue of ``ransacParams:maxIterations``).
      min_points: skip the gate when fewer tracks than this survive
        (8-point minimum; ``ransacParams:minDataPoints`` clamped up to 8).
      min_inliers: keep the original mask when the best hypothesis explains
        fewer tracks than this (``ransacParams:minInliers`` semantics —
        a degenerate/ambiguous geometry should not wipe out the tracker).

    Returns the refined ``[N]`` bool mask (a subset of ``mask``).
    """
    N = prev.shape[0]
    K = hypotheses
    n_tracked = jnp.sum(mask).astype(jnp.int32)  # i64 under x64 otherwise

    # masked Hartley normalisation (conditioning for the 8-point solve)
    p1n, s1 = _normalize(prev, mask)
    p2n, s2 = _normalize(curr, mask)

    # sample K draws of 8 distinct tracked indices: random scores, masked out
    # slots pushed to +inf, one argsort per hypothesis
    # dtype pinned: under x64 an unpinned uniform defaults to f64
    scores = jax.random.uniform(key, (K, N), dtype=jnp.float32)
    scores = jnp.where(mask[None, :], scores, jnp.inf)
    _, idx = jax.lax.top_k(-scores, 8)  # [K, 8] int32 (argsort gives i64 on x64)
    F = _eight_point(p1n[idx], p2n[idx])

    # score all correspondences under all hypotheses; threshold is given in
    # pixels -> convert to normalised units via the isotropic scales
    d2 = _sampson(F, p1n, p2n)  # [K, N] squared normalised Sampson distance
    thr2 = jnp.square(threshold) * s1 * s2  # d^2 scales by s1*s2 (bilinear F)

    # MSAC objective (truncated loss) instead of a raw inlier count: the
    # count is a cliff under the tight tuned thresholds, making the gate's
    # output (and downstream accuracy) depend on the hypothesis stream;
    # the truncated total varies smoothly across hypotheses
    rho = jnp.where(mask[None, :], jnp.minimum(d2, thr2), 0.0)
    best = jax.lax.argmax(-jnp.sum(rho, axis=-1), 0, jnp.int32)

    # one local-optimisation pass (LO-RANSAC): refit F on ALL inliers of the
    # best hypothesis with the same 9x9 eigh machinery, then re-score —
    # collapses hypothesis-sampling variance to the refit fixed point
    w = ((d2[best] < thr2) & mask).astype(p1n.dtype)
    A_all = _constraint_rows(p1n, p2n)  # [N, 9]
    G2 = jnp.einsum("ni,nj->ij", A_all * w[:, None], A_all)
    F_lo = _rank2(smallest_eigvec(G2[None]).reshape(1, 3, 3))
    d2_lo = _sampson(F_lo, p1n, p2n)[0]
    refined = (d2_lo < thr2) & mask
    counts_ref = jnp.sum(refined).astype(jnp.int32)

    # degenerate-geometry guards: not enough tracks to hypothesise, or the
    # best consensus is too small to be trusted -> leave the mask unchanged
    min_pts = max(int(min_points), 8)
    usable = (n_tracked >= min_pts) & (counts_ref >= min_inliers)
    return jnp.where(usable, refined, mask)

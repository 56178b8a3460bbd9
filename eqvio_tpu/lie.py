"""Batched Lie-group operations for VIO.

This module is the JAX equivalent of the LiePP header library used by the
reference EqVIO (see reference use sites: ``include/eqvio/mathematical/VIOState.h:20``,
``VIOGroup.h:22-23``).  Unlike LiePP's scalar C++ types, every function here is
a pure jnp function batched over arbitrary leading axes, so whole landmark sets
or particle populations are processed with a single call.

Groups provided:

- SO(3): rotations as ``[..., 3, 3]`` matrices.
- SE(3): rigid transforms as ``(R: [...,3,3], x: [...,3])`` named tuples.
- SOT(3): rotation + positive scale ``(R: [...,3,3], a: [...])``
  acting on points by ``p -> a * R @ p``.
- SE_2(3): extended poses ``(R, x1, x2)`` used for the coupled
  pose-velocity exponential (reference ``VIOGroup.cpp:273-290``).

All ops are numerically guarded (Taylor fallbacks near theta=0 and theta=pi)
so they are safe under jit and grad at any input.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

_SMALL = 1e-6


def _stack_last(*cols):
    return jnp.stack(cols, axis=-1)


def skew(w: jnp.ndarray) -> jnp.ndarray:
    """Hat operator: ``[..., 3] -> [..., 3, 3]`` (LiePP ``SO3d::skew``)."""
    zeros = jnp.zeros_like(w[..., 0])
    row0 = _stack_last(zeros, -w[..., 2], w[..., 1])
    row1 = _stack_last(w[..., 2], zeros, -w[..., 0])
    row2 = _stack_last(-w[..., 1], w[..., 0], zeros)
    return jnp.stack([row0, row1, row2], axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`skew`: ``[..., 3, 3] -> [..., 3]``."""
    return _stack_last(W[..., 2, 1], W[..., 0, 2], W[..., 1, 0])


def _safe_norm(w):
    """Norm over the last axis with a finite gradient at 0."""
    sq = jnp.sum(w * w, axis=-1)
    return jnp.sqrt(jnp.clip(sq, 1e-36, None))


def _sinc(theta):
    """sin(theta)/theta, safe at 0."""
    t2 = theta * theta
    small = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    safe = jnp.where(jnp.abs(theta) < _SMALL, 1.0, theta)
    return jnp.where(jnp.abs(theta) < _SMALL, small, jnp.sin(safe) / safe)


def _one_minus_cos_over_t2(theta):
    """(1 - cos(theta)) / theta^2, safe at 0."""
    t2 = theta * theta
    small = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    safe2 = jnp.where(t2 < _SMALL * _SMALL, 1.0, t2)
    return jnp.where(t2 < _SMALL * _SMALL, small, (1.0 - jnp.cos(theta)) / safe2)


def _theta_minus_sin_over_t3(theta):
    """(theta - sin(theta)) / theta^3, safe at 0."""
    t2 = theta * theta
    small = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    safe3 = jnp.where(t2 < _SMALL * _SMALL, 1.0, t2 * theta)
    return jnp.where(t2 < _SMALL * _SMALL, small, (theta - jnp.sin(theta)) / safe3)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map ``[..., 3] -> [..., 3, 3]`` (Rodrigues)."""
    theta = _safe_norm(w)
    W = skew(w)
    A = _sinc(theta)[..., None, None]
    B = _one_minus_cos_over_t2(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A * W + B * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map ``[..., 3, 3] -> [..., 3]``, robust near 0 and pi.

    Uses the double-``where`` pattern throughout so unused branches never
    produce NaN/Inf under ``jax.grad``.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    v = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sv2 = jnp.sum(v * v, axis=-1)
    sv = jnp.sqrt(jnp.clip(sv2, 1e-36, None))  # = |sin(theta)|

    near_zero = c > 1.0 - 1e-10
    near_pi = c < -1.0 + 1e-7

    # general branch: w = theta / sin(theta) * v with theta = atan2(sv, c)
    sv_safe = jnp.where(near_zero | near_pi, 1.0, sv)
    theta_general = jnp.arctan2(sv_safe, c)
    w_general = v * (theta_general / sv_safe)[..., None]

    # small-angle branch: theta^2 ~ sv^2, factor = 1 + t2/6 + ...
    w_small = v * (1.0 + sv2 / 6.0 + 0.3 * sv2 * sv2)[..., None]

    # near-pi branch: R = -I + 2 a a^T  =>  a a^T ~ (R + I)/2
    S = R + jnp.eye(3, dtype=R.dtype)
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    col = jnp.take_along_axis(S, k[..., None, None].repeat(3, axis=-2), axis=-1)[..., 0]
    col_norm = jnp.linalg.norm(col, axis=-1, keepdims=True)
    axis = col / jnp.clip(col_norm, 1e-30, None)
    # theta = pi - asin(|sin theta|), guarded so asin' stays finite off-branch
    sv_pi = jnp.where(near_pi, jnp.clip(sv, None, 1.0), 0.0)
    theta_pi = jnp.pi - jnp.arcsin(sv_pi)
    # choose the sign to agree with v when v != 0 (ambiguous exactly at pi)
    sign = jnp.where(jnp.sum(axis * v, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    w_pi = axis * sign * theta_pi[..., None]

    return jnp.where(
        near_zero[..., None], w_small, jnp.where(near_pi[..., None], w_pi, w_general)
    )


def so3_project(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthogonalise a near-rotation by one Newton step: R(3I - R^T R)/2.

    Matrix products accumulate non-orthogonality at machine epsilon per
    composition; in feedback chains (e.g. conjugation by an estimated frame)
    the error grows geometrically.  LiePP avoids this by storing quaternions;
    we store matrices and project after compositions.  One Newton step maps an
    eps-non-orthogonal matrix to eps^2.
    """
    RtR = jnp.swapaxes(R, -1, -2) @ R
    return R @ (1.5 * jnp.eye(3, dtype=R.dtype) - 0.5 * RtR)


def so3_from_vectors(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Rotation taking unit-ish vector ``a`` to ``b`` (LiePP ``SO3FromVectors``).

    Used for gravity-aligned initialisation (reference ``VIOFilter.cpp:76``)
    and discrete landmark lifts (``VIOGroup.cpp:265``).  Handles the
    antiparallel case by rotating pi about an axis orthogonal to ``a``.
    """
    an = a / jnp.clip(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-30, None)
    bn = b / jnp.clip(jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-30, None)
    v = jnp.cross(an, bn)
    c = jnp.sum(an * bn, axis=-1)  # cos(theta)
    V = skew(v)
    # R = I + V + V^2 / (1 + c); singular only at c = -1 (antiparallel)
    denom = jnp.clip(1.0 + c, 1e-12, None)[..., None, None]
    R_general = jnp.eye(3, dtype=a.dtype) + V + (V @ V) / denom

    # antiparallel: rotate by pi around any axis orthogonal to a
    helper = jnp.where(
        (jnp.abs(an[..., 0]) < 0.9)[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=a.dtype), an.shape),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dtype=a.dtype), an.shape),
    )
    ortho = jnp.cross(an, helper)
    ortho = ortho / jnp.clip(jnp.linalg.norm(ortho, axis=-1, keepdims=True), 1e-30, None)
    R_pi = so3_exp(jnp.pi * ortho)

    antiparallel = (c < -1.0 + 1e-9)[..., None, None]
    return jnp.where(antiparallel, R_pi, R_general)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


class SE3(NamedTuple):
    """Rigid-body transform with rotation ``R [...,3,3]`` and translation ``x [...,3]``."""

    R: jnp.ndarray
    x: jnp.ndarray

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


def se3_identity(dtype=jnp.float64, batch_shape=()) -> SE3:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    x = jnp.zeros(batch_shape + (3,), dtype=dtype)
    return SE3(R, x)


def se3_mul(a: SE3, b: SE3) -> SE3:
    return SE3(a.R @ b.R, jnp.einsum("...ij,...j->...i", a.R, b.x) + a.x)


def se3_inv(a: SE3) -> SE3:
    Rt = jnp.swapaxes(a.R, -1, -2)
    return SE3(Rt, -jnp.einsum("...ij,...j->...i", Rt, a.x))


def se3_apply(a: SE3, p: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...j->...i", a.R, p) + a.x


def _left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V(w) = I + B W + C W^2."""
    theta = _safe_norm(w)
    W = skew(w)
    B = _one_minus_cos_over_t2(theta)[..., None, None]
    C = _theta_minus_sin_over_t3(theta)[..., None, None]
    return jnp.eye(3, dtype=w.dtype) + B * W + C * (W @ W)


def _left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the SO(3) left Jacobian."""
    theta = _safe_norm(w)
    W = skew(w)
    t2 = theta * theta
    # D = 1/theta^2 - (1 + cos)/(2 theta sin); Taylor: 1/12 + theta^2/720 + ...
    small = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    s = jnp.sin(theta)
    safe = jnp.abs(s * theta) > _SMALL * _SMALL
    denom_t2 = jnp.where(t2 > 0, t2, 1.0)
    denom_st = jnp.where(safe, 2.0 * theta * s, 1.0)
    general = 1.0 / denom_t2 - (1.0 + jnp.cos(theta)) / denom_st
    D = jnp.where(safe, general, small)[..., None, None]
    return jnp.eye(3, dtype=w.dtype) - 0.5 * W + D * (W @ W)


def se3_exp(u: jnp.ndarray) -> SE3:
    """SE(3) exponential of ``u = (w, v) [..., 6]`` (angular first, as LiePP)."""
    w, v = u[..., 0:3], u[..., 3:6]
    R = so3_exp(w)
    x = jnp.einsum("...ij,...j->...i", _left_jacobian(w), v)
    return SE3(R, x)


def se3_log(a: SE3) -> jnp.ndarray:
    w = so3_log(a.R)
    v = jnp.einsum("...ij,...j->...i", _left_jacobian_inv(w), a.x)
    return jnp.concatenate([w, v], axis=-1)


def se3_Adjoint(a: SE3) -> jnp.ndarray:
    """Big Adjoint ``[..., 6, 6]`` with X exp(u) X^-1 = exp(Ad_X u), u=(w,v)."""
    top = jnp.concatenate([a.R, jnp.zeros_like(a.R)], axis=-1)
    bottom = jnp.concatenate([skew(a.x) @ a.R, a.R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def se3_adjoint(u: jnp.ndarray) -> jnp.ndarray:
    """Little adjoint ``ad_u [..., 6, 6]`` for u=(w,v)."""
    W = skew(u[..., 0:3])
    V = skew(u[..., 3:6])
    top = jnp.concatenate([W, jnp.zeros_like(W)], axis=-1)
    bottom = jnp.concatenate([V, W], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# SOT(3): rotation + scale, action p -> a * R p
# ---------------------------------------------------------------------------


class SOT3(NamedTuple):
    """Scaled rotation: ``R [...,3,3]`` and scale ``a [...]`` acting by ``a*R@p``."""

    R: jnp.ndarray
    a: jnp.ndarray


def sot3_identity(dtype=jnp.float64, batch_shape=()) -> SOT3:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    a = jnp.ones(batch_shape, dtype=dtype)
    return SOT3(R, a)


def sot3_mul(p: SOT3, q: SOT3) -> SOT3:
    return SOT3(p.R @ q.R, p.a * q.a)


def sot3_inv(p: SOT3) -> SOT3:
    return SOT3(jnp.swapaxes(p.R, -1, -2), 1.0 / p.a)


def sot3_apply(p: SOT3, x: jnp.ndarray) -> jnp.ndarray:
    return p.a[..., None] * jnp.einsum("...ij,...j->...i", p.R, x)


def sot3_exp(u: jnp.ndarray) -> SOT3:
    """Exponential of ``u = (w, s) [..., 4]``: (exp(w), e^s)."""
    return SOT3(so3_exp(u[..., 0:3]), jnp.exp(u[..., 3]))


def sot3_log(p: SOT3) -> jnp.ndarray:
    return jnp.concatenate([so3_log(p.R), jnp.log(p.a)[..., None]], axis=-1)


def sot3_Adjoint_inv_of(p: SOT3) -> jnp.ndarray:
    """Adjoint of p^{-1} as a ``[..., 4, 4]`` matrix: blockdiag(R^T, 1).

    Used in the equivariant output matrix (reference ``euclid.cpp:182``).
    """
    Rt = jnp.swapaxes(p.R, -1, -2)
    out = jnp.zeros(p.R.shape[:-2] + (4, 4), dtype=p.R.dtype)
    out = out.at[..., 0:3, 0:3].set(Rt)
    out = out.at[..., 3, 3].set(1.0)
    return out


# ---------------------------------------------------------------------------
# SE_2(3)
# ---------------------------------------------------------------------------


class SE23(NamedTuple):
    """Extended pose ``(R, x1, x2)`` with x1 ~ position, x2 ~ velocity column."""

    R: jnp.ndarray
    x1: jnp.ndarray
    x2: jnp.ndarray


def se23_exp(u: jnp.ndarray) -> SE23:
    """SE_2(3) exponential of ``u = (w, v1, v2) [..., 9]``."""
    w = u[..., 0:3]
    V = _left_jacobian(w)
    return SE23(
        so3_exp(w),
        jnp.einsum("...ij,...j->...i", V, u[..., 3:6]),
        jnp.einsum("...ij,...j->...i", V, u[..., 6:9]),
    )


def se23_log(g: SE23) -> jnp.ndarray:
    w = so3_log(g.R)
    Vi = _left_jacobian_inv(w)
    v1 = jnp.einsum("...ij,...j->...i", Vi, g.x1)
    v2 = jnp.einsum("...ij,...j->...i", Vi, g.x2)
    return jnp.concatenate([w, v1, v2], axis=-1)


__all__ = [
    "SE3",
    "SE23",
    "SOT3",
    "se3_Adjoint",
    "se3_adjoint",
    "se3_apply",
    "se3_exp",
    "se3_identity",
    "se3_inv",
    "se3_log",
    "se3_mul",
    "se23_exp",
    "se23_log",
    "skew",
    "so3_exp",
    "so3_from_vectors",
    "so3_log",
    "sot3_Adjoint_inv_of",
    "sot3_apply",
    "sot3_exp",
    "sot3_identity",
    "sot3_inv",
    "sot3_log",
    "sot3_mul",
    "vee",
]

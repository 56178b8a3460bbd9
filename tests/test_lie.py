"""Property tests for the batched Lie-group core.

Mirrors the reference's sampling-based group-axiom strategy
(``test/test_VIOGroup.cpp:26-59``) but runs every repetition as one batched
call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eqvio_tpu import lie

REPS = 25
TOL = 1e-9


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_so3(rng, n):
    return lie.so3_exp(jnp.asarray(rng.normal(size=(n, 3))))


def test_skew_vee_roundtrip(rng):
    w = jnp.asarray(rng.normal(size=(REPS, 3)))
    np.testing.assert_allclose(lie.vee(lie.skew(w)), w, atol=TOL)


def test_so3_exp_log_roundtrip(rng):
    w = jnp.asarray(rng.normal(size=(REPS, 3)))
    R = lie.so3_exp(w)
    # orthogonality and determinant
    np.testing.assert_allclose(
        R @ jnp.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), (REPS, 3, 3)), atol=TOL
    )
    np.testing.assert_allclose(np.linalg.det(R), np.ones(REPS), atol=TOL)
    # log o exp = id for |w| < pi
    w_small = jnp.asarray(rng.normal(size=(REPS, 3)))
    w_small = w_small / np.linalg.norm(w_small, axis=-1, keepdims=True) * rng.uniform(0, 3.0, size=(REPS, 1))
    np.testing.assert_allclose(lie.so3_log(lie.so3_exp(w_small)), w_small, atol=1e-8)


def test_so3_log_near_pi(rng):
    axis = rng.normal(size=(REPS, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    for angle in [np.pi - 1e-7, np.pi - 1e-3, np.pi]:
        w = jnp.asarray(axis * angle)
        R = lie.so3_exp(w)
        w_back = lie.so3_log(R)
        # recovered rotation must match (sign of axis may flip at exactly pi)
        np.testing.assert_allclose(lie.so3_exp(w_back), R, atol=1e-6)


def test_so3_log_identity():
    w = lie.so3_log(jnp.eye(3))
    np.testing.assert_allclose(w, np.zeros(3), atol=TOL)


def test_so3_from_vectors(rng):
    a = jnp.asarray(rng.normal(size=(REPS, 3)))
    b = jnp.asarray(rng.normal(size=(REPS, 3)))
    an = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    R = lie.so3_from_vectors(an, bn)
    np.testing.assert_allclose(
        jnp.einsum("nij,nj->ni", R, an), bn, atol=1e-8
    )


def test_so3_from_vectors_antiparallel():
    a = jnp.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    b = -a
    R = lie.so3_from_vectors(a, b)
    np.testing.assert_allclose(jnp.einsum("nij,nj->ni", R, a), b, atol=1e-8)


def test_se3_group_axioms(rng):
    u = jnp.asarray(rng.normal(size=(REPS, 6)))
    v = jnp.asarray(rng.normal(size=(REPS, 6)))
    X = lie.se3_exp(u)
    Y = lie.se3_exp(v)
    # inverse
    XinvX = lie.se3_mul(lie.se3_inv(X), X)
    np.testing.assert_allclose(XinvX.R, np.broadcast_to(np.eye(3), (REPS, 3, 3)), atol=TOL)
    np.testing.assert_allclose(XinvX.x, np.zeros((REPS, 3)), atol=TOL)
    # associativity against point action
    p = jnp.asarray(rng.normal(size=(REPS, 3)))
    np.testing.assert_allclose(
        lie.se3_apply(lie.se3_mul(X, Y), p),
        lie.se3_apply(X, lie.se3_apply(Y, p)),
        atol=1e-8,
    )


def _bounded_twist(rng, n, dim):
    """Random twists with rotation-part norm < pi (log is single-valued)."""
    u = rng.normal(size=(n, dim))
    wn = np.linalg.norm(u[:, :3], axis=-1, keepdims=True)
    u[:, :3] *= rng.uniform(0.01, 3.0, size=(n, 1)) / wn
    return jnp.asarray(u)


def test_se3_exp_log_roundtrip(rng):
    u = _bounded_twist(rng, REPS, 6)
    np.testing.assert_allclose(lie.se3_log(lie.se3_exp(u)), u, atol=1e-8)


def test_se3_adjoint_property(rng):
    """X exp(u) X^-1 = exp(Ad_X u)."""
    u = jnp.asarray(rng.normal(size=(REPS, 6))) * 0.5
    X = lie.se3_exp(jnp.asarray(rng.normal(size=(REPS, 6))))
    lhs = lie.se3_mul(lie.se3_mul(X, lie.se3_exp(u)), lie.se3_inv(X))
    rhs = lie.se3_exp(jnp.einsum("nij,nj->ni", lie.se3_Adjoint(X), u))
    np.testing.assert_allclose(lhs.R, rhs.R, atol=1e-8)
    np.testing.assert_allclose(lhs.x, rhs.x, atol=1e-7)


def test_se3_little_adjoint(rng):
    """ad_u v = d/dt Ad_{exp(tu)} v at t=0."""
    u = jnp.asarray(rng.normal(size=(REPS, 6)))
    v = jnp.asarray(rng.normal(size=(REPS, 6)))
    ad = jnp.einsum("nij,nj->ni", lie.se3_adjoint(u), v)
    eps = 1e-6
    Ad_p = jnp.einsum("nij,nj->ni", lie.se3_Adjoint(lie.se3_exp(eps * u)), v)
    Ad_m = jnp.einsum("nij,nj->ni", lie.se3_Adjoint(lie.se3_exp(-eps * u)), v)
    np.testing.assert_allclose(ad, (Ad_p - Ad_m) / (2 * eps), atol=1e-5)


def test_sot3_axioms(rng):
    u = jnp.asarray(rng.normal(size=(REPS, 4)))
    v = jnp.asarray(rng.normal(size=(REPS, 4)))
    P = lie.sot3_exp(u)
    Q = lie.sot3_exp(v)
    p = jnp.asarray(rng.normal(size=(REPS, 3)))
    np.testing.assert_allclose(
        lie.sot3_apply(lie.sot3_mul(P, Q), p),
        lie.sot3_apply(P, lie.sot3_apply(Q, p)),
        atol=1e-7,
    )
    PinvP = lie.sot3_mul(lie.sot3_inv(P), P)
    np.testing.assert_allclose(PinvP.R, np.broadcast_to(np.eye(3), (REPS, 3, 3)), atol=TOL)
    np.testing.assert_allclose(PinvP.a, np.ones(REPS), atol=TOL)
    # exp/log roundtrip
    u_small = _bounded_twist(rng, REPS, 4)
    np.testing.assert_allclose(lie.sot3_log(lie.sot3_exp(u_small)), u_small, atol=1e-8)


def test_se23_exp_log_roundtrip(rng):
    u = _bounded_twist(rng, REPS, 9)
    np.testing.assert_allclose(lie.se23_log(lie.se23_exp(u)), u, atol=1e-8)


def test_jit_and_grad_safe():
    """exp/log must not produce NaNs under grad at zero."""
    g = jax.grad(lambda w: jnp.sum(lie.so3_exp(w)))(jnp.zeros(3))
    assert not jnp.any(jnp.isnan(g))
    g2 = jax.grad(lambda u: jnp.sum(lie.se3_exp(u).x))(jnp.zeros(6))
    assert not jnp.any(jnp.isnan(g2))
    g3 = jax.grad(lambda R: jnp.sum(lie.so3_log(R)))(jnp.eye(3) + 1e-8)
    assert not jnp.any(jnp.isnan(g3))

"""Camera models: pinhole, radial-tangential, equidistant (fisheye).

Equivalent of the GIFT camera interface used by the reference
(``GIFT::GICameraPtr`` with ``projectPoint / undistortPoint /
projectionJacobian / isInDomain``; see reference use sites
``VIOState.cpp:70-78``, ``VIOGroup.cpp:57-69``, ``euclid.cpp:176``,
``VIOSimulator.cpp:242``).  Concrete models mirror GIFT's
``PinholeCamera`` / ``StandardCamera`` (radtan) / ``EquidistantCamera``
(reference readers: ``ASLDatasetReader.cpp:93``, ``UZHFPVDatasetReader.cpp:102``).

Every model is a NamedTuple pytree of arrays; all maps are batched over
leading axes and jit/grad safe.  Distortion inverses use fixed-iteration
solvers so shapes stay static under jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-9


def _normalize(v):
    return v / jnp.clip(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30, None)


class PinholeCamera(NamedTuple):
    """Ideal pinhole camera with intrinsics (fx, fy, cx, cy) and image size."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    width: int = 0  # 0 disables the image-bounds check
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, width=0, height=0, dtype=jnp.float64):
        return PinholeCamera(
            jnp.asarray(fx, dtype),
            jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype),
            jnp.asarray(cy, dtype),
            int(width),
            int(height),
        )

    def project(self, p: jnp.ndarray) -> jnp.ndarray:
        z = jnp.where(jnp.abs(p[..., 2]) < _EPS, _EPS, p[..., 2])
        u = self.fx * p[..., 0] / z + self.cx
        v = self.fy * p[..., 1] / z + self.cy
        return jnp.stack([u, v], axis=-1)

    def undistort(self, px: jnp.ndarray) -> jnp.ndarray:
        """Pixel -> unit bearing (GIFT ``undistortPoint``)."""
        x = (px[..., 0] - self.cx) / self.fx
        y = (px[..., 1] - self.cy) / self.fy
        ones = jnp.ones_like(x)
        return _normalize(jnp.stack([x, y, ones], axis=-1))

    def projection_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        """d project / d p: ``[..., 2, 3]`` analytic."""
        z = jnp.where(jnp.abs(p[..., 2]) < _EPS, _EPS, p[..., 2])
        zi = 1.0 / z
        zero = jnp.zeros_like(zi)
        row0 = jnp.stack([self.fx * zi, zero, -self.fx * p[..., 0] * zi * zi], axis=-1)
        row1 = jnp.stack([zero, self.fy * zi, -self.fy * p[..., 1] * zi * zi], axis=-1)
        return jnp.stack([row0, row1], axis=-2)

    def is_in_domain(self, p: jnp.ndarray) -> jnp.ndarray:
        ok = p[..., 2] > _EPS
        if self.width and self.height:
            px = self.project(p)
            ok = (
                ok
                & (px[..., 0] >= 0)
                & (px[..., 0] < self.width)
                & (px[..., 1] >= 0)
                & (px[..., 1] < self.height)
            )
        return ok


def _auto_jacobian(project_fn, p):
    """Exact batched d project / d p via forward-mode AD."""
    flat = p.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(project_fn))(flat)
    return J.reshape(p.shape[:-1] + (2, 3))


class RadTanCamera(NamedTuple):
    """Radial-tangential ("plumb bob") camera, GIFT ``StandardCamera`` equivalent.

    Distortion (k1, k2, p1, p2) on normalized image coordinates; matches the
    EuRoC ``sensor.yaml`` convention read by ``ASLDatasetReader.cpp:81-102``.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, dist, width=0, height=0, dtype=jnp.float64):
        k1, k2, p1, p2 = (jnp.asarray(d, dtype) for d in dist)
        return RadTanCamera(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            k1, k2, p1, p2, int(width), int(height),
        )

    def _distort(self, m: jnp.ndarray) -> jnp.ndarray:
        x, y = m[..., 0], m[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return jnp.stack([xd, yd], axis=-1)

    def project(self, p: jnp.ndarray) -> jnp.ndarray:
        z = jnp.where(jnp.abs(p[..., 2]) < _EPS, _EPS, p[..., 2])
        m = p[..., 0:2] / z[..., None]
        d = self._distort(m)
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def undistort(self, px: jnp.ndarray) -> jnp.ndarray:
        xd = (px[..., 0] - self.cx) / self.fx
        yd = (px[..., 1] - self.cy) / self.fy
        d = jnp.stack([xd, yd], axis=-1)

        def body(_, m):
            delta = self._distort(m) - m
            return d - delta

        m = jax.lax.fori_loop(0, 10, body, d)
        ones = jnp.ones_like(m[..., 0])
        return _normalize(jnp.concatenate([m, ones[..., None]], axis=-1))

    def projection_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        return _auto_jacobian(self.project, p)

    def is_in_domain(self, p: jnp.ndarray) -> jnp.ndarray:
        ok = p[..., 2] > _EPS
        if self.width and self.height:
            px = self.project(p)
            ok = (
                ok
                & (px[..., 0] >= 0)
                & (px[..., 0] < self.width)
                & (px[..., 1] >= 0)
                & (px[..., 1] < self.height)
            )
        return ok


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt equidistant fisheye, GIFT ``EquidistantCamera`` equivalent.

    Used for UZH-FPV kalibr camchains (``UZHFPVDatasetReader.cpp:38-131``).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    k3: jnp.ndarray
    k4: jnp.ndarray
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, dist, width=0, height=0, dtype=jnp.float64):
        k1, k2, k3, k4 = (jnp.asarray(d, dtype) for d in dist)
        return EquidistantCamera(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            k1, k2, k3, k4, int(width), int(height),
        )

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4))))

    def project(self, p: jnp.ndarray) -> jnp.ndarray:
        z = jnp.where(jnp.abs(p[..., 2]) < _EPS, _EPS, p[..., 2])
        m = p[..., 0:2] / z[..., None]
        r = jnp.sqrt(jnp.clip(jnp.sum(m * m, axis=-1), 1e-18, None))
        theta = jnp.arctan(r)
        scale = self._theta_d(theta) / r
        d = scale[..., None] * m
        u = self.fx * d[..., 0] + self.cx
        v = self.fy * d[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def undistort(self, px: jnp.ndarray) -> jnp.ndarray:
        xd = (px[..., 0] - self.cx) / self.fx
        yd = (px[..., 1] - self.cy) / self.fy
        theta_d = jnp.sqrt(jnp.clip(xd * xd + yd * yd, 1e-18, None))

        def newton(_, theta):
            t2 = theta * theta
            f = theta * (
                1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4)))
            ) - theta_d
            df = (
                1.0
                + 3.0 * self.k1 * t2
                + 5.0 * self.k2 * t2 * t2
                + 7.0 * self.k3 * t2 * t2 * t2
                + 9.0 * self.k4 * t2 * t2 * t2 * t2
            )
            return theta - f / jnp.where(jnp.abs(df) < 1e-9, 1e-9, df)

        theta = jax.lax.fori_loop(0, 8, newton, theta_d)
        scale = jnp.sin(theta) / theta_d
        bearing = jnp.stack([xd * scale, yd * scale, jnp.cos(theta)], axis=-1)
        return _normalize(bearing)

    def projection_jacobian(self, p: jnp.ndarray) -> jnp.ndarray:
        return _auto_jacobian(self.project, p)

    def is_in_domain(self, p: jnp.ndarray) -> jnp.ndarray:
        # fisheye FOV can exceed 180 deg; require in front-ish and in-image
        r = jnp.linalg.norm(p, axis=-1)
        ok = p[..., 2] > -0.5 * r
        if self.width and self.height:
            px = self.project(p)
            ok = (
                ok
                & (px[..., 0] >= 0)
                & (px[..., 0] < self.width)
                & (px[..., 1] >= 0)
                & (px[..., 1] < self.height)
            )
        return ok


def default_test_camera(dtype=jnp.float64) -> PinholeCamera:
    """A fake 800x480 pinhole camera mirroring the reference test fixture
    (``test/testing_utilities.cpp:175-184``)."""
    return PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=dtype)

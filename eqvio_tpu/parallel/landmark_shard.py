"""Landmark-block-sharded EqF vision update.

The per-frame Gram/Schur reduction ``C Sigma C^T`` (a single dense Eigen
product in the reference, ``VIO_eqf.cpp:116``) becomes a shard_map over the
landmark axis:

- each device holds the Sigma landmark block-columns of its shard and
  computes its partial ``Sigma C^T`` and ``S`` columns locally,
- the small ``S`` (2N x 2N) and ``Sigma C^T`` are assembled with
  ``all_gather``,
- the O(D^2 N) correction ``K (Sigma C^T)^T`` is reduced with ``psum``
  of per-shard outer products.

In square-root mode (``settings.sqrt_covariance``) the state carries the
lower Cholesky factor L and the update is the Kailath array form: the
pre-array block ``C L`` (the expensive O(N D^2) product) is computed
shard-locally over landmark block-rows and assembled with ``all_gather``;
the re-triangularising QR runs replicated.

Design note (deliberate small-N design): the replicated
QR is O((2N+D)^3) and is NOT distributed.  A QR is a long sequential chain
of Householder reflections with all-to-all column coupling; at the
pre-array's aspect ratio (rows ~ cols) a TSQR row-block split degenerates
(the merge stage is as large as the original), and block-sparse C offers no
factorisable structure because every landmark couples to the sensor block.
The scalable axes of this filter are the ``C L`` product, the Gram/Schur
reduction, and the sequence-batch axis — all distributed here and in
``parallel/batch.py``.  At very large N the O(N^3) QR dominates any
covariance-form filter equally (the dense path's Cholesky has the same
exponent); an O(N) landmark scale-out would need an information-form /
SLAM-graph redesign, which trades away the constant-time per-frame update
this framework (and the reference, ``VIO_eqf.cpp:105-135``) is built
around.  ``dryrun_multichip`` case 2c exercises this path at capacity 256
(pre-array 1301^2) and asserts equality with the local update.

For realistic capacities (N <= 128) a single chip wins; this path is the
scale-out pattern for very large landmark maps and the multi-chip dry-run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from .. import filter as F
from ..group import state_action
from ..states import SENSOR_DIM, measure_system


def sharded_vision_update(mesh: Mesh, settings: F.Settings, camera, axis: str = "lm"):
    """Build a landmark-sharded vision update ``update(state, pixels, vis) -> state``.

    Mathematically identical to :func:`eqvio_tpu.filter.update_vision`; the
    Gram reduction and covariance correction are distributed over the mesh
    axis ``axis``.
    """
    suite = settings.suite
    n_shards = mesh.shape[axis]

    def update(state: F.EqFState, pixels, vis_mask):
        xi0, X, Sigma = state.xi0, state.X, state.Sigma
        N = xi0.capacity
        D = xi0.dim()
        dtype = Sigma.dtype
        assert N % n_shards == 0, "capacity must divide the lm mesh axis size"
        n_loc = N // n_shards

        active = (xi0.mask & vis_mask).astype(dtype)
        xi_hat = state_action(X, xi0)
        y_hat, _ = measure_system(xi_hat, camera)
        resid = ((pixels - y_hat) * active[:, None]).reshape(-1)

        if settings.use_equivariant_output:
            C = suite.output_Ci_star(xi0.landmarks, X.Q, camera, pixels)
        else:
            C = suite.output_Ci(xi0.landmarks, X.Q, camera)
        C = C * active[:, None, None]  # [N,2,3] small, replicated

        r_diag = jnp.where(
            jnp.repeat(active, 2) > 0, settings.measurement_noise**2, 1.0
        ).astype(dtype)

        if settings.sqrt_covariance:
            return _sqrt_update(state, C, resid, r_diag)

        Sig_cols = Sigma[:, SENSOR_DIM:].reshape(D, N, 3)

        def shard_fn(C_full, Sig_cols_shard, resid_full, r_diag_full):
            i = jax.lax.axis_index(axis)
            C_my = jax.lax.dynamic_slice_in_dim(C_full, i * n_loc, n_loc, axis=0)
            # partial Sigma C^T for my landmark shard: [D, n_loc, 2]
            SigCt_part = jnp.einsum("djy,jby->djb", Sig_cols_shard, C_my)
            # my S columns: rows over all measurements, cols = my shard
            S_cols = jnp.einsum(
                "iax,ixb->iab", C_full, SigCt_part[SENSOR_DIM:].reshape(N, 3, 2 * n_loc)
            ).reshape(2 * N, 2 * n_loc)
            S_full = jax.lax.all_gather(S_cols, axis, axis=1, tiled=True)
            S_full = S_full + jnp.diag(r_diag_full)
            SigCt_full = jax.lax.all_gather(
                SigCt_part.reshape(D, 2 * n_loc), axis, axis=1, tiled=True
            )
            chol = jax.scipy.linalg.cho_factor(S_full, lower=True)
            K_full = jax.scipy.linalg.cho_solve(chol, SigCt_full.T).T  # [D, 2N]
            Gamma = K_full @ resid_full
            # covariance correction: psum of per-shard outer products over
            # the measurement axis
            K_my = jax.lax.dynamic_slice_in_dim(K_full, 2 * i * n_loc, 2 * n_loc, axis=1)
            M_part = K_my @ SigCt_part.reshape(D, 2 * n_loc).T  # [D, D]
            M = jax.lax.psum(M_part, axis)
            return Gamma, M

        Gamma, M = shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(None, axis, None), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )(C, Sig_cols, resid, r_diag)

        Sigma_new = Sigma - M
        Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)
        return _apply_innovation(state, Gamma, Sigma_new)

    def _sqrt_update(state: F.EqFState, C, resid, r_diag):
        """Kailath array update with ``C L`` sharded over landmark block-rows.

        Mathematically identical to the sqrt branch of
        :func:`eqvio_tpu.filter.update_vision`; the pre-array block ``CL``
        is computed per shard and assembled with ``all_gather``.
        """
        xi0, L = state.xi0, state.Sigma  # L: lower Cholesky factor
        N = xi0.capacity
        D = xi0.dim()
        dtype = L.dtype
        n_loc = N // n_shards
        m = 2 * N

        L_lm = L[SENSOR_DIM:].reshape(N, 3, D)

        def shard_fn(C_full, L_lm_shard):
            i = jax.lax.axis_index(axis)
            C_my = jax.lax.dynamic_slice_in_dim(C_full, i * n_loc, n_loc, axis=0)
            CL_part = jnp.einsum("iax,ixd->iad", C_my, L_lm_shard).reshape(
                2 * n_loc, D
            )
            return jax.lax.all_gather(CL_part, axis, axis=0, tiled=True)

        CL = shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(axis, None, None)),
            out_specs=P(),
            check_vma=False,
        )(C, L_lm)

        pre = jnp.zeros((m + D, m + D), dtype=dtype)
        pre = pre.at[:m, :m].set(jnp.diag(jnp.sqrt(r_diag)))
        pre = pre.at[:m, m:].set(CL)
        pre = pre.at[m:, m:].set(L)
        post = F.tria(pre)
        S_half = post[:m, :m]
        Kbar = post[m:, :m]
        L_new = post[m:, m:]
        Gamma = Kbar @ jax.scipy.linalg.solve_triangular(
            S_half, resid.reshape(-1), lower=True
        )
        return _apply_innovation(state, Gamma, L_new)

    def _apply_innovation(state: F.EqFState, Gamma, Sigma_new):
        xi0 = state.xi0
        if settings.use_discrete_innovation_lift:
            Delta = suite.lift_innovation_discrete(Gamma, xi0)
        else:
            from ..group import group_exp

            Delta = group_exp(suite.lift_innovation(Gamma, xi0))
        from ..group import group_mul, group_normalize

        X_new = group_normalize(group_mul(Delta, state.X))
        Sigma_new = F.sanitize_sigma(Sigma_new, xi0, settings)
        return state._replace(X=X_new, Sigma=Sigma_new)

    return update

"""Core pytree data types.

A re-design of the reference's mutable structs
(``GaussianPolicy`` at ``src/iLQG.jl:39-53``, ``Trace`` at ``src/iLQG.jl:6-21``):
frozen pytrees with time-major layout ``(T, ...)`` (scan-friendly), batchable by
adding leading axes via ``jax.vmap``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class GaussianPolicy(NamedTuple):
    """Time-varying affine-Gaussian controller ``u_t = k_t + K_t @ dx_t + noise``.

    Mirrors the reference ``GaussianPolicy`` (``src/iLQG.jl:39-53``) with
    time-major layout:

    - ``K``:   feedback gains, shape ``(T, m, n)``  (reference: ``(m, n, T)``)
    - ``k``:   feedforward controls, shape ``(T, m)``
    - ``sigma``:  controller covariance ``Σ = Quu⁻¹``, shape ``(T, m, m)``
      (``src/iLQGkl.jl:23``)
    - ``sigma_inv``: ``Σ⁻¹ = Quu``, shape ``(T, m, m)``
    """

    K: jax.Array
    k: jax.Array
    sigma: jax.Array
    sigma_inv: jax.Array

    @property
    def T(self) -> int:
        return self.k.shape[-2]

    @property
    def m(self) -> int:
        return self.k.shape[-1]

    @property
    def n(self) -> int:
        return self.K.shape[-1]

    @staticmethod
    def zeros(T: int, n: int, m: int, dtype=jnp.float32) -> "GaussianPolicy":
        """Zero-gain unit-covariance policy (reference ctor ``src/iLQG.jl:51``)."""
        eye = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (T, m, m))
        return GaussianPolicy(
            K=jnp.zeros((T, m, n), dtype),
            k=jnp.zeros((T, m), dtype),
            sigma=eye,
            sigma_inv=eye,
        )


class Derivs(NamedTuple):
    """Stacked derivatives of dynamics and cost along a trajectory.

    Equivalent of the reference user-``df`` tuple (``src/iLQG.jl:77-84``) but
    always materialized time-varying with shape ``(T, ...)`` — time-invariant
    inputs are broadcast once instead of using dispatch-on-rank, collapsing the
    five ``back_pass`` variants (``src/backward_pass.jl:81-252``) into one.

    Second-order dynamics terms (``fxx, fxu, fuu``) are ``None`` for iLQG
    (first-order dynamics model); supplying them switches on full DDP —
    the reference signals this via empty arrays (``src/iLQG.jl:231``).

    Index convention (0-based, t in [0, T)):
    - ``fx[t] = ∂f/∂x (n,n)``, ``fu[t] = ∂f/∂u (n,m)`` at ``(x_t, u_t)``
    - ``cx[t] (n,)``, ``cu[t] (m,)``, ``cxx[t] (n,n)``, ``cxu[t] (n,m)``,
      ``cuu[t] (m,m)``
    - ``fxx[t] (n,n,n)`` with ``fxx[t,a,i,j] = ∂²f_a/∂x_i∂x_j``; likewise
      ``fxu[t] (n,n,m)``, ``fuu[t] (n,m,m)``.
    """

    fx: jax.Array
    fu: jax.Array
    cx: jax.Array
    cu: jax.Array
    cxx: jax.Array
    cxu: jax.Array
    cuu: jax.Array
    fxx: Optional[jax.Array] = None
    fxu: Optional[jax.Array] = None
    fuu: Optional[jax.Array] = None


class Trace(NamedTuple):
    """Fixed-shape per-iteration convergence record.

    The equivalent of the reference's ``MVHistory`` trace keys
    (``src/iLQG.jl:175-177, 325-330``; ``src/iLQGkl.jl:161-166``): arrays of
    static length carried through the solver ``lax.while_loop``; entries past
    ``n_iters`` are zero/NaN padding.
    """

    lam: jax.Array           # λ per iteration
    dlam: jax.Array          # dλ
    alpha: jax.Array         # accepted line-search step (NaN when rejected)
    cost: jax.Array          # total trajectory cost
    grad_norm: jax.Array
    improvement: jax.Array   # Δcost
    reduce_ratio: jax.Array
    divergence: jax.Array    # KL divergence (iLQGkl) / 0
    eta: jax.Array           # η dual (iLQGkl) / 0
    accepted: jax.Array      # bool: step accepted

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "Trace":
        z = jnp.zeros((n,), dtype)
        return Trace(z, z, jnp.full((n,), jnp.nan, dtype), z, z, z, z, z, z,
                     jnp.zeros((n,), bool))


def sym(A: jax.Array) -> jax.Array:
    """Symmetrize: the reference does this to ``Vxx`` and ``Quu``
    (``src/backward_pass.jl:71-72,301``)."""
    return 0.5 * (A + jnp.swapaxes(A, -1, -2))

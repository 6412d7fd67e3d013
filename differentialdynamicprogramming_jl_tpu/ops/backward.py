"""Backward pass: regularized Riccati-like value recursion with feedback gains.

One implementation replaces the reference's five ``back_pass`` dispatch
variants (``src/backward_pass.jl:81-252``) *and* the KL-augmented GPS variant
``back_pass_gps`` (``src/backward_pass.jl:259-350``):

- time-invariant inputs are broadcast to ``(T, ...)`` once
  (see ``problem.broadcast_derivs``) instead of dispatch-on-rank;
- second-order dynamics terms switch on via ``fxx/fxu/fuu is not None``
  (the reference's ``isempty`` sentinels, ``src/iLQG.jl:231``);
- the GPS mode (Q-terms scaled by ``1/η`` and augmented with KL cost terms,
  ``src/backward_pass.jl:293-299``) switches on via ``eta is not None``;
- "Cholesky failed at timestep i" (``src/backward_pass.jl:36-38``) becomes a
  NaN-detection flag reduced over the scan — no exceptions under jit.

The T-recursion is inherently sequential (``for i = N-1:-1:1`` in the
reference); throughput comes from vmapping this whole function over a
scenario batch, which XLA vectorizes across the batch axis at every step.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve

from ..policy import Derivs, GaussianPolicy, sym
from .boxqp import boxqp, boxqp_1d
from .precision import highest_precision


class KLTerms(NamedTuple):
    """KL cost-expansion terms from the previous policy (``∇kl``,
    ``src/klutils.jl:8-23``). Note ``cxu`` here is Qux-shaped ``(T, m, n)``
    exactly as the reference builds it (``src/klutils.jl:12,20``)."""

    cx: jax.Array    # (T, n)
    cu: jax.Array    # (T, m)
    cxx: jax.Array   # (T, n, n)
    cxu: jax.Array   # (T, m, n)
    cuu: jax.Array   # (T, m, m)


class BackwardOut(NamedTuple):
    """Results of one backward pass (reference return
    ``(diverge, GaussianPolicy, Vx, Vxx, dV)``, ``src/backward_pass.jl:128``)."""

    diverged: jax.Array      # bool: any timestep failed
    diverge_idx: jax.Array   # int32 1-based timestep of first failure (0 = ok)
    policy: GaussianPolicy   # k (T,m), K (T,m,n), Σ=Quu⁻¹, Σi=Quu
    Vx: jax.Array            # (T, n)
    Vxx: jax.Array           # (T, n, n)
    dV: jax.Array            # (2,) expected cost reduction [linear, quadratic]


@highest_precision
@functools.partial(
    jax.jit,
    static_argnames=("reg_type", "use_limits", "qp_max_iter", "gps_mode"))
def backward_pass(derivs: Derivs,
                  u: jax.Array,
                  lam: jax.Array = 0.0,
                  reg_type: int = 1,
                  lims: Optional[jax.Array] = None,
                  use_limits: bool = False,
                  eta: Optional[jax.Array] = None,
                  kl_terms: Optional[KLTerms] = None,
                  qp_max_iter: int = 100,
                  gps_mode: bool = False) -> BackwardOut:
    """Run the backward recursion over a ``(T, ...)`` derivative stack.

    - ``lam``, ``reg_type``: Levenberg-Marquardt regularization; type 1 adds
      ``λI`` to ``Quu``, type 2 to ``Vxx`` (``src/backward_pass.jl:119-122``).
    - ``lims``: ``(m, 2)`` control limits (activates the boxQP gain solve,
      ``src/backward_pass.jl:43-61``) when ``use_limits=True``.
    - ``eta`` + ``kl_terms``: GPS mode (``gps_mode=True``), ``eta`` scalar or
      ``(T,)`` per-timestep duals (``src/backward_pass.jl:262-263,293-299``).
    """
    T, m = u.shape
    n = derivs.cx.shape[-1]
    dtype = u.dtype
    second_order = derivs.fxx is not None

    if gps_mode:
        assert eta is not None and kl_terms is not None
        eta_vec = jnp.broadcast_to(jnp.asarray(eta, dtype), (T,))
    else:
        eta_vec = jnp.ones((T,), dtype)  # unused
        kl_terms = KLTerms(
            cx=jnp.zeros((T, n), dtype), cu=jnp.zeros((T, m), dtype),
            cxx=jnp.zeros((T, n, n), dtype), cxu=jnp.zeros((T, m, n), dtype),
            cuu=jnp.zeros((T, m, m), dtype))

    lam = jnp.asarray(lam, dtype)
    if lims is not None:
        lims = jnp.asarray(lims, dtype)
    I_n = jnp.eye(n, dtype=dtype)
    I_m = jnp.eye(m, dtype=dtype)

    # ---- boundary at t = T-1 (reference index N: src/backward_pass.jl:97-99,
    #      280-283) — the last control is not optimized (k, K stay zero).
    Vx_T = derivs.cx[T - 1]
    Vxx_T = derivs.cxx[T - 1]
    if gps_mode:
        Quu_T = derivs.cuu[T - 1] / eta_vec[T - 1] + kl_terms.cuu[T - 1]
    else:
        Quu_T = derivs.cuu[T - 1]
    Quu_inv_T = jnp.linalg.inv(Quu_T)

    def solve_gains(Quu_gain, Qu_used, Qux_gain, u_t, k_warm):
        """Gain solve: Cholesky (no limits) or boxQP (limits).
        ``Quu_gain``/``Qux_gain`` are the (regularized) matrices used for the
        gain computation only (``src/backward_pass.jl:28-62``)."""
        if not use_limits:
            chol = jnp.linalg.cholesky(sym(Quu_gain))
            ok = jnp.all(jnp.isfinite(chol))
            chol_safe = jnp.where(ok, chol, I_m)
            k_i = -cho_solve((chol_safe, True), Qu_used)
            K_i = -cho_solve((chol_safe, True), Qux_gain)
            return k_i, K_i, ok
        # control limits: projected-Newton QP, warm-started with the k from
        # the previous (t+1) step (src/backward_pass.jl:49)
        lower = lims[:, 0] - u_t
        upper = lims[:, 1] - u_t
        if m == 1:
            qp = boxqp_1d(Quu_gain, Qu_used, lower, upper)
        else:
            qp = boxqp(Quu_gain, Qu_used, lower, upper, k_warm,
                       max_iter=qp_max_iter)
        ok = qp.result >= 1
        free = qp.free
        chol_safe = jnp.where(jnp.isfinite(qp.chol), qp.chol, I_m)
        K_free = -cho_solve((chol_safe, True),
                            Qux_gain * free[:, None].astype(dtype))
        K_i = jnp.where(free[:, None], K_free, 0.0)
        return qp.x, K_i, ok

    def step(carry, inputs):
        Vx, Vxx, dV, k_prev, diverged, div_idx = carry
        d, u_t, eta_t, kl_t, t = inputs

        fxT = d.fx.T
        fuT = d.fu.T
        cxuT = d.cxu.T  # (m, n)

        # ---- Q expansions (src/backward_pass.jl:103-123)
        Qu = d.cu + fuT @ Vx
        Qx = d.cx + fxT @ Vx
        Qux = cxuT + fuT @ Vxx @ d.fx
        Quu = d.cuu + fuT @ Vxx @ d.fu
        Qxx = d.cxx + fxT @ Vxx @ d.fx
        if second_order:
            fxuVx = jnp.einsum('a,aij->ji', Vx, d.fxu)   # (m, n)
            fuuVx = jnp.einsum('a,aij->ij', Vx, d.fuu)   # (m, m)
            fxxVx = jnp.einsum('a,aij->ij', Vx, d.fxx)   # (n, n)
            Qux = Qux + fxuVx
            Quu = Quu + fuuVx
            Qxx = Qxx + fxxVx

        if gps_mode:
            # η is the only regularizer (src/iLQGkl.jl:99); scale Q terms by
            # 1/η and add KL expansion terms (src/backward_pass.jl:293-299)
            Qu = Qu / eta_t + kl_t.cu
            Qux = Qux / eta_t + kl_t.cxu
            Quu = sym(Quu / eta_t + kl_t.cuu)
            Qx = Qx / eta_t + kl_t.cx
            Qxx = Qxx / eta_t + kl_t.cxx
            Quu_gain, Qux_gain = Quu, Qux
        else:
            # LM regularization (src/backward_pass.jl:119-123): gains use the
            # regularized matrices, value updates use the raw ones
            Vxx_reg = Vxx + (lam * I_n if reg_type == 2 else 0.0)
            Qux_reg = cxuT + fuT @ Vxx_reg @ d.fx
            QuuF = d.cuu + fuT @ Vxx_reg @ d.fu \
                + (lam * I_m if reg_type == 1 else 0.0)
            if second_order:
                Qux_reg = Qux_reg + fxuVx
                QuuF = QuuF + fuuVx
            Quu_gain, Qux_gain = QuuF, Qux_reg

        k_i, K_i, ok = solve_gains(Quu_gain, Qu, Qux_gain, u_t, k_prev)

        # ---- value update with the *unregularized* Q terms
        #      (src/backward_pass.jl:63-72, 336-341)
        Quu_k = Quu @ k_i
        dV_new = dV + jnp.stack([jnp.dot(k_i, Qu), 0.5 * jnp.dot(k_i, Quu_k)])
        Vx_new = Qx + K_i.T @ Quu_k + K_i.T @ Qu + Qux.T @ k_i
        Vxx_new = sym(Qxx + K_i.T @ Quu @ K_i + K_i.T @ Qux + Qux.T @ K_i)
        Quu_inv = jnp.linalg.inv(Quu)

        newly_bad = (~ok) & (~diverged)
        div_idx = jnp.where(newly_bad, (t + 1).astype(jnp.int32), div_idx)
        diverged = diverged | (~ok)

        carry = (Vx_new, Vxx_new, dV_new, k_i, diverged, div_idx)
        outs = (k_i, K_i, Vx_new, Vxx_new, Quu, Quu_inv)
        return carry, outs

    xs = (
        jax.tree_util.tree_map(lambda a: a[:T - 1], derivs),
        u[:T - 1],
        eta_vec[:T - 1],
        jax.tree_util.tree_map(lambda a: a[:T - 1], kl_terms),
        jnp.arange(T - 1),
    )
    init = (Vx_T, Vxx_T, jnp.zeros((2,), dtype), jnp.zeros((m,), dtype),
            jnp.zeros((), bool), jnp.zeros((), jnp.int32))
    (_, _, dV, _, diverged, div_idx), (k, K, Vx, Vxx, Quu, Quu_inv) = lax.scan(
        step, init, xs, reverse=True)

    # append the boundary timestep T-1
    cat = lambda a, b: jnp.concatenate([a, b[None]], axis=0)
    k = cat(k, jnp.zeros((m,), dtype))
    K = cat(K, jnp.zeros((m, n), dtype))
    Vx = cat(Vx, Vx_T)
    Vxx = cat(Vxx, Vxx_T)
    Quu = cat(Quu, Quu_T)
    Quu_inv = cat(Quu_inv, Quu_inv_T)

    policy = GaussianPolicy(K=K, k=k, sigma=Quu_inv, sigma_inv=Quu)
    return BackwardOut(diverged=diverged, diverge_idx=div_idx, policy=policy,
                       Vx=Vx, Vxx=Vxx, dV=dV)

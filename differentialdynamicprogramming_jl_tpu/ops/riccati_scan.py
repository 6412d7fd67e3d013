"""Parallel (associative-scan) Riccati backward pass — O(log T) depth.

The reference's backward recursion is strictly sequential in the horizon
(``for i = N-1:-1:1``, ``src/backward_pass.jl:102``); SURVEY.md §7 flags the
temporal parallelization of the Riccati recursion (PAPERS.md: "The
Parallelization of Riccati Recursion"; the element algebra below follows the
conditional-value-function formulation of Särkkä & García-Fernández's
temporal-parallelization line of work) as a stretch goal.

Idea: the map from the value function at time s to the value function at
time t < s is a Riccati flow on quadratics ``V(x) = ½xᵀJx − ηᵀx``. Such maps
form a semigroup parametrized by 5 arrays ``(A, b, C, η, J)`` — the optimal
segment cost between pinned endpoints

    V_{i→j}(x_i, x_j) = ½‖x_j − A x_i − b‖²_{C⁻¹} + ½x_iᵀJx_i − ηᵀx_i

with the associative combination (minimizing over the shared endpoint)

    A₁₂ = A₂ Z A₁             Z = (I + C₁ J₂)⁻¹
    b₁₂ = A₂ Z (b₁ + C₁ η₂) + b₂
    C₁₂ = A₂ Z C₁ A₂ᵀ + C₂
    η₁₂ = A₁ᵀ Zᵀ (η₂ − J₂ b₁) + η₁
    J₁₂ = A₁ᵀ Zᵀ J₂ A₁ + J₁

``jax.lax.associative_scan`` evaluates all suffix products in O(log T)
parallel steps, giving every timestep's cost-to-go (J_t, η_t) at once; the
gains k/K then follow pointwise (vmapped over T).

Scope: the exact unregularized, unconstrained LQR backward (λ=0, no control
limits, first-order dynamics, cross terms handled by the standard
completion-of-squares reduction). Useful when the batch axis is small and
the horizon is long — the lane kernels already saturate the chip for big
fleets; this trades ~5× more FLOPs per step for log-depth latency.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import Derivs, GaussianPolicy, sym
from .backward import BackwardOut
from .precision import highest_precision


class _Elem(NamedTuple):
    A: jax.Array    # (T+1, n, n)
    b: jax.Array    # (T+1, n)
    C: jax.Array    # (T+1, n, n)
    eta: jax.Array  # (T+1, n)
    J: jax.Array    # (T+1, n, n)


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Associative combination: e1 is the earlier segment, e2 the later
    (both batched over the leading axis by associative_scan)."""
    n = e1.A.shape[-1]
    I = jnp.eye(n, dtype=e1.A.dtype)
    # Z = (I + C1 J2)^-1 — solve instead of inverse
    M = I + e1.C @ e2.J
    Zt_eta = jnp.linalg.solve(
        jnp.swapaxes(M, -1, -2),
        (e2.eta - jnp.einsum('...ij,...j->...i', e2.J, e1.b))[..., None]
    )[..., 0]
    ZA1 = jnp.linalg.solve(M, e1.A)
    Zb = jnp.linalg.solve(
        M, (e1.b + jnp.einsum('...ij,...j->...i', e1.C, e2.eta))[..., None]
    )[..., 0]
    ZC1 = jnp.linalg.solve(M, e1.C)
    A12 = e2.A @ ZA1
    b12 = jnp.einsum('...ij,...j->...i', e2.A, Zb) + e2.b
    C12 = e2.A @ ZC1 @ jnp.swapaxes(e2.A, -1, -2) + e2.C
    eta12 = jnp.einsum('...ji,...j->...i', e1.A, Zt_eta) + e1.eta
    J12 = (jnp.swapaxes(e1.A, -1, -2)
           @ jnp.linalg.solve(jnp.swapaxes(M, -1, -2), e2.J @ e1.A)
           + e1.J)
    return _Elem(A=A12, b=b12, C=C12, eta=eta12, J=sym(J12))


@highest_precision
def parallel_riccati(derivs: Derivs, u: jax.Array) -> BackwardOut:
    """Unconstrained λ=0 backward pass via associative scan (parity
    interface with :func:`~.backward.backward_pass`).

    ``derivs``: (T, ...) stacks; cross terms ``cxu`` are removed by the
    completion-of-squares reduction ũ = u + R⁻¹Nᵀx. Returns the same
    gains/value outputs as the sequential recursion (``diverged`` flags
    non-PD ``cuu``/``Quu`` encountered pointwise).
    """
    T, m = u.shape
    n = derivs.cx.shape[-1]
    dtype = u.dtype
    I_n = jnp.eye(n, dtype=dtype)

    F = derivs.fx[:T - 1]
    G = derivs.fu[:T - 1]
    Q = derivs.cxx[:T - 1]
    q = derivs.cx[:T - 1]
    R = derivs.cuu[:T - 1]
    r = derivs.cu[:T - 1]
    N = derivs.cxu[:T - 1]                       # (T-1, n, m)

    # completion of squares: remove cross terms
    RiNt = jnp.linalg.solve(R, jnp.swapaxes(N, -1, -2))      # (T-1, m, n)
    Qt = Q - N @ RiNt
    Ft = F - G @ RiNt
    qt = q - jnp.einsum('...nm,...m->...n', N,
                        jnp.linalg.solve(R, r[..., None])[..., 0])

    Rinv_r = jnp.linalg.solve(R, r[..., None])[..., 0]
    elems = _Elem(
        A=Ft,
        b=-jnp.einsum('...nm,...m->...n', G, Rinv_r),
        C=G @ jnp.linalg.solve(R, jnp.swapaxes(G, -1, -2)),
        eta=-qt,
        J=Qt,
    )
    # terminal element: J = cxx_T, eta = -cx_T, no transition
    term = _Elem(
        A=jnp.zeros((1, n, n), dtype), b=jnp.zeros((1, n), dtype),
        C=jnp.zeros((1, n, n), dtype),
        eta=-derivs.cx[T - 1][None], J=derivs.cxx[T - 1][None])
    elems = _Elem(*[jnp.concatenate([a, b], axis=0)
                    for a, b in zip(elems, term)])

    # suffix combinations: scan reversed so position t holds the segment
    # [t, T] — (J_t, η_t) is the cost-to-go at t. With reverse=True the
    # operator receives (later, earlier); flip into _combine's convention.
    suffix = lax.associative_scan(lambda a, b: _combine(b, a), elems,
                                  reverse=True)
    J = suffix.J                                  # (T, n, n)
    eta = suffix.eta

    Vxx = sym(J)
    Vx = -eta

    # pointwise gains from V_{t+1} (vmapped over t — no sequential dep)
    J1 = J[1:]
    eta1 = eta[1:]

    def gains(F_t, G_t, R_t, r_t, N_t, J_n, eta_n):
        GtJ = jnp.swapaxes(G_t, -1, -2) @ J_n
        Quu = R_t + GtJ @ G_t
        Qux = jnp.swapaxes(N_t, -1, -2) + GtJ @ F_t
        Qu = r_t + jnp.einsum('mn,n->m', jnp.swapaxes(G_t, -1, -2), -eta_n)
        chol = jnp.linalg.cholesky(sym(Quu))
        ok = jnp.all(jnp.isfinite(chol))
        chol_s = jnp.where(ok, chol, jnp.eye(m, dtype=dtype))
        k_t = -jax.scipy.linalg.cho_solve((chol_s, True), Qu)
        K_t = -jax.scipy.linalg.cho_solve((chol_s, True), Qux)
        dv = jnp.stack([jnp.dot(k_t, Qu),
                        0.5 * jnp.dot(k_t, Quu @ k_t)])
        return k_t, K_t, Quu, ok, dv

    k, K, Quu, ok, dv = jax.vmap(gains)(F, G, R, r, N, J1, eta1)
    k = jnp.concatenate([k, jnp.zeros((1, m), dtype)], axis=0)
    K = jnp.concatenate([K, jnp.zeros((1, m, n), dtype)], axis=0)
    Quu = jnp.concatenate([Quu, derivs.cuu[T - 1][None]], axis=0)
    Quu_inv = jnp.linalg.inv(Quu)
    dV = jnp.sum(dv, axis=0)

    diverged = ~jnp.all(ok)
    # the sequential backward pass (and the reference, src/backward_pass.jl
    # scanning i=N-1:-1:1) latches the FIRST failure encountered going
    # backward, i.e. the LARGEST failing timestep — match that here
    bad_ts = jnp.where(~ok, jnp.arange(1, T, dtype=jnp.int32), 0)
    diverge_idx = jnp.where(diverged, jnp.max(bad_ts),
                            jnp.zeros((), jnp.int32)).astype(jnp.int32)

    policy = GaussianPolicy(K=K, k=k, sigma=Quu_inv, sigma_inv=Quu)
    return BackwardOut(diverged=diverged, diverge_idx=diverge_idx,
                       policy=policy, Vx=Vx, Vxx=Vxx, dV=dV)

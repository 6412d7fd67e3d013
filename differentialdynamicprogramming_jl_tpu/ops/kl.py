"""KL-divergence machinery for the GPS-style trust-region solver.

Reference: ``src/klutils.jl`` — KL cost-expansion terms ``∇kl`` (``:8-23``),
closed-form Gaussian-policy KL ``kl_div_wiki`` (``:70-100``), ``entropy``
(``:104``), dual bracketing ``calc_η`` (``:110-154``), and the ADAM optimizer
for the per-timestep-η variant (``:186-210``).

All functions are batched over the time axis with plain jnp (no Python
loops) and are jit/vmap-safe.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..policy import GaussianPolicy
from .backward import KLTerms
from .precision import highest_precision


@highest_precision
def grad_kl(traj_prev: GaussianPolicy) -> KLTerms:
    """Q-term additions from the KL constraint w.r.t. the previous policy
    (``∇kl``, ``src/klutils.jl:8-23``):

        cx = K'Σ⁻¹k, cu = -Σ⁻¹k, cxx = K'Σ⁻¹K, cuu = Σ⁻¹, cxu = -Σ⁻¹K
    """
    K, k, Si = traj_prev.K, traj_prev.k, traj_prev.sigma_inv
    Sik = jnp.einsum('tij,tj->ti', Si, k)            # (T, m)
    SiK = jnp.einsum('tij,tjn->tin', Si, K)          # (T, m, n)
    return KLTerms(
        cx=jnp.einsum('tmn,tm->tn', K, Sik),
        cu=-Sik,
        cxx=jnp.einsum('tmi,tmj->tij', K, SiK),
        cxu=-SiK,
        cuu=Si,
    )


def _logdet(A):
    return jnp.linalg.slogdet(A)[1]


def pd_ok(S: jax.Array) -> jax.Array:
    """Per-timestep PD flag for a (..., m, m) symmetric stack (smallest
    eigenvalue > 0). Julia's ``logdet`` throws a DomainError on indefinite
    input (the reference's ``kl_div_wiki`` hard-fails, ``src/klutils.jl:84``);
    under jit callers use this flag to abort/diagnose instead — ``slogdet``
    alone would silently return log|det| (sign > 0 does NOT imply PD: an
    even number of negative eigenvalues keeps the determinant positive)."""
    return jnp.linalg.eigvalsh(S)[..., 0] > 0


@highest_precision
def kl_div_wiki(x_new: jax.Array, x_old: jax.Array, sigma_new: jax.Array,
                traj_new: GaussianPolicy,
                traj_prev: GaussianPolicy) -> jax.Array:
    """Closed-form per-timestep KL divergence between the new and previous
    time-varying affine-Gaussian policies (``src/klutils.jl:70-100``):

        KL_t = ½(tr(Σp⁻¹Σn) + Δk'Σp⁻¹Δk - m + logdet Σp - logdet Σn)
             + ½(μ'ΔK'Σp⁻¹ΔK μ + tr(ΔK'Σp⁻¹ΔK Σxx))
             + Δk'Σp⁻¹ΔK μ,   clipped at 0

    where μ = x_new - x_old and Σxx is the state block of ``sigma_new``.
    """
    T, m, n = traj_new.T, traj_new.m, traj_new.n
    mu = x_new - x_old                                  # (T, n)
    Sxx = sigma_new[:, :n, :n]                          # (T, n, n)
    k_diff = traj_prev.k - traj_new.k                   # (T, m)
    K_diff = traj_prev.K - traj_new.K                   # (T, m, n)
    Sip = traj_prev.sigma_inv
    Sp, Sn = traj_prev.sigma, traj_new.sigma

    tr_term = jnp.einsum('tij,tji->t', Sip, Sn)
    kk = jnp.einsum('ti,tij,tj->t', k_diff, Sip, k_diff)
    ld = _logdet(Sp) - _logdet(Sn)
    kl = 0.5 * (tr_term + kk - m + ld)

    SipKd = jnp.einsum('tij,tjn->tin', Sip, K_diff)     # (T, m, n)
    KdSipKd = jnp.einsum('tmi,tmj->tij', K_diff, SipKd)  # (T, n, n)
    kl = kl + 0.5 * (jnp.einsum('ti,tij,tj->t', mu, KdSipKd, mu)
                     + jnp.einsum('tij,tji->t', KdSipKd, Sxx))
    kl = kl + jnp.einsum('ti,tin,tn->t', k_diff, SipKd, mu)
    return jnp.maximum(kl, 0.0)


@highest_precision
def kl_div_gaussian(x_new, x_old, u_new, sigma_new, traj_new, traj_prev):
    """The reference's alternative ``kl_div`` formulation
    (``src/klutils.jl:39-65``), which can go negative and is clipped; kept
    for API parity. Uses the stacked mean μ = [Δx; u_new]."""
    T, m, n = traj_new.T, traj_new.m, traj_new.n
    mu = jnp.concatenate([x_new - x_old, u_new], axis=-1)   # (T, n+m)

    def mv(Si, K, k):
        # (src/klutils.jl:28-34): M = [[K'SiK, -K'Si], [-SiK, Si]], v = [K'Sik; -Sik]
        KSi = jnp.einsum('tmn,tmj->tnj', K, Si)             # (T, n, m)
        M = jnp.concatenate([
            jnp.concatenate([jnp.einsum('tnm,tmj->tnj', KSi,  K), -KSi], -1),
            jnp.concatenate([-jnp.einsum('tij,tjn->tin', Si, K), Si], -1),
        ], axis=-2)
        Sik = jnp.einsum('tij,tj->ti', Si, k)
        v = jnp.concatenate([jnp.einsum('tmn,tm->tn', K, Sik), -Sik], -1)
        return M, v

    kp = traj_prev.k
    kn = traj_new.k + kp   # src/klutils.jl:51
    Mp, vp = mv(traj_prev.sigma_inv, traj_prev.K, kp)
    Mn, vn = mv(traj_new.sigma_inv, traj_new.K, kn)
    cp = 0.5 * jnp.einsum('ti,tij,tj->t', kp, traj_prev.sigma_inv, kp)
    cn = 0.5 * jnp.einsum('ti,tij,tj->t', kn, traj_new.sigma_inv, kn)
    dM, dv = Mn - Mp, vn - vp
    kl = (-0.5 * jnp.einsum('ti,tij,tj->t', mu, dM, mu)
          - jnp.einsum('ti,ti->t', mu, dv) - cn + cp
          - 0.5 * jnp.einsum('tij,tij->t', sigma_new, dM)
          - 0.5 * _logdet(traj_new.sigma) + 0.5 * _logdet(traj_prev.sigma))
    return jnp.maximum(kl, 0.0)


@highest_precision
def entropy(traj: GaussianPolicy) -> jax.Array:
    """Mean policy entropy (``src/klutils.jl:104``)."""
    return (jnp.mean(_logdet(traj.sigma)) / 2.0
            + traj.m * jnp.log(2.0 * jnp.pi) / 2.0)


def geom(bracket: jax.Array) -> jax.Array:
    """Geometric mean of the bracket endpoints (``src/klutils.jl:155-156``)."""
    return jnp.sqrt(bracket[0] * bracket[2])


def calc_eta(divergence: jax.Array, eta_bracket: jax.Array,
             kl_step: Union[float, jax.Array]
             ) -> Tuple[jax.Array, jax.Array]:
    """Dual-variable bracket update (``calc_η``, ``src/klutils.jl:110-154``).

    ``eta_bracket``: ``[η_min, η, η_max]`` — shape ``(3,)`` for a single KL
    constraint or ``(3, T)`` per-timestep. ``divergence``: measured KL
    (scalar or ``(T,)`` matching). Returns ``(new_bracket, satisfied)``.

    η too big (violation < 0): shrink from above — ``η_max ← η``,
    ``η ← max(√(η_min η_max), 0.1 η_max)``; too small: grow from below —
    ``η_min ← η``, ``η ← min(√(η_min η_max), 10 η_min)``.
    """
    kl_step = jnp.asarray(kl_step, eta_bracket.dtype)
    violation = divergence - kl_step
    satisfied_each = jnp.abs(violation) < 0.1 * kl_step
    satisfied = jnp.all(satisfied_each) | jnp.all(kl_step <= 0)

    too_big = violation < 0
    lo, mid, hi = eta_bracket[0], eta_bracket[1], eta_bracket[2]
    # too big: hi ← mid, mid ← max(geom, 0.1 hi_new)
    hi_b = mid
    mid_b = jnp.maximum(jnp.sqrt(lo * hi_b), 0.1 * hi_b)
    # too small: lo ← mid, mid ← min(geom, 10 lo_new)
    lo_s = mid
    mid_s = jnp.minimum(jnp.sqrt(lo_s * hi), 10.0 * lo_s)

    new_lo = jnp.where(too_big, lo, lo_s)
    new_mid = jnp.where(too_big, mid_b, mid_s)
    new_hi = jnp.where(too_big, hi_b, hi)

    # frozen when satisfied (per element, matching the reference's masked
    # updates in the vector overload, src/klutils.jl:144-152)
    keep = satisfied_each | (kl_step <= 0)
    new_bracket = jnp.stack([
        jnp.where(keep, lo, new_lo),
        jnp.where(keep, mid, new_mid),
        jnp.where(keep, hi, new_hi),
    ])
    return new_bracket, satisfied


# ---------------------------------------------------------------------------
# ADAM (functional) — reference ADAMOptimizer (src/klutils.jl:186-210)
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    m: jax.Array
    v: jax.Array


def adam_init(shape, dtype=jnp.float32) -> AdamState:
    return AdamState(m=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype))


def adam_update(state: AdamState, theta: jax.Array, g: jax.Array, t,
                alpha: float = 0.005, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8):
    """One ADAM step, exactly the reference update (``src/klutils.jl:203-210``).
    ``t`` is the 1-based iteration count."""
    t = jnp.asarray(t, theta.dtype)
    m = beta1 * state.m + (1 - beta1) * g
    v = beta2 * state.v + (1 - beta2) * g ** 2
    m_hat = m / (1 - beta1 ** t)
    v_hat = v / (1 - beta2 ** t)
    theta_new = theta - alpha * m_hat / (jnp.sqrt(v_hat) + eps)
    return theta_new, AdamState(m=m, v=v)

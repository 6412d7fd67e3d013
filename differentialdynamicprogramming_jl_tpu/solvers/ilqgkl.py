"""KL-divergence-constrained iLQG (GPS trust-region solver).

Reference: ``iLQGkl`` (``src/iLQGkl.jl:25-252``) — the trajectory optimizer
used inside Guided Policy Search: the previous ``GaussianPolicy`` is the
trust-region center, the dual variable η is adjusted by bracketing
(``src/klutils.jl:110-130``) or, in the per-timestep variant, by ADAM
gradient descent in log-space (``src/iLQGkl.jl:185-236``).

Behavioral contract mirrored from the reference:
- requires a pre-rolled trajectory + cost (``src/iLQGkl.jl:65-72``);
- derivatives are computed ONCE, not per iteration (``src/iLQGkl.jl:88``);
- forward passes always take the full step α=1 (``src/iLQGkl.jl:134``);
- η (not λ) is the only regularizer (``src/iLQGkl.jl:99``); on backward-pass
  divergence η is increased additively with doubling increments
  (``src/iLQGkl.jl:104-106``);
- acceptance of the final iterate is unconditional (``src/iLQGkl.jl:239-241``);
- warns when the final KL exceeds the bound (``src/iLQGkl.jl:248``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import GaussianPolicy, Trace
from ..problem import Problem
from ..ops.backward import backward_pass
from ..ops.forward import forward_pass, forward_covariance
from ..ops.kl import (grad_kl, kl_div_wiki, calc_eta, entropy, pd_ok,
                      adam_init, adam_update, AdamState)
from ..ops.precision import highest_precision


@dataclasses.dataclass(frozen=True)
class ILQGKLConfig:
    """Options of the reference ``iLQGkl`` (``src/iLQGkl.jl:25-42``)."""

    kl_step: float = 1.0
    constrain_per_step: bool = False
    max_iter: int = 50
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    eta_bracket: Tuple[float, float, float] = (1e-8, 1.0, 1e16)
    del0: float = 1e-4
    gd_alpha: float = 0.01          # ADAM step for per-timestep η
    verbosity: int = 0
    print_head: int = 10            # src/iLQGkl.jl:32
    print_period: int = 1           # src/iLQGkl.jl:33
    qp_max_iter: int = 100
    # retry-loop safety: the reference's scalar η-escalation loop has no
    # abort (src/iLQGkl.jl:111-121 commented out); we abort once η exceeds
    # the bracket maximum to keep the jitted loop bounded.
    retry_cap: int = 200


class ILQGKLResult(NamedTuple):
    x: jax.Array
    u: jax.Array
    policy: GaussianPolicy
    Vx: jax.Array
    Vxx: jax.Array
    cost: jax.Array
    trace: Trace
    n_iters: jax.Array
    eta: jax.Array              # final η (scalar or (T,))
    eta_bracket: jax.Array
    divergence: jax.Array       # final measured KL (scalar mean or (T,))
    satisfied: jax.Array
    kl_violated: jax.Array      # reference final warning (src/iLQGkl.jl:248)
    pd_failed: jax.Array = None  # a Σ went indefinite in the KL measurement
    #                              (Julia logdet DomainError analogue,
    #                              src/klutils.jl:84); aborted, not satisfied


@highest_precision
def ilqg_kl(problem: Problem,
            x0: jax.Array,
            traj_prev: GaussianPolicy,
            model,
            cost0: jax.Array,
            lims: Optional[jax.Array] = None,
            cfg: ILQGKLConfig = ILQGKLConfig(),
            iter_callback=None) -> ILQGKLResult:
    """Solve the KL-constrained problem from the pre-rolled trajectory ``x0``
    ``(T, n)`` around ``traj_prev`` (whose ``k`` is the nominal control
    sequence, ``src/iLQGkl.jl:47``). ``model`` supplies the linearization and
    prediction covariance for :func:`forward_covariance`
    (``src/iLQGkl.jl:135``). ``iter_callback``: per-iteration host hook
    ``f(it, x, u, cost)`` (the reference's ``plot_fun``,
    ``src/iLQGkl.jl:177``; single-solve use, not vmappable)."""
    assert x0.ndim == 2, "iLQGkl requires a pre-rolled trajectory (T, n)"
    return _ilqgkl_impl(problem, x0, traj_prev, model, cost0, lims, cfg,
                        iter_callback)


class _Carry(NamedTuple):
    eta_bracket: jax.Array      # (3,) or (3, T)
    delta: jax.Array            # η-escalation increment: scalar or (T,)
    x_new: jax.Array
    u_new: jax.Array
    cost_new: jax.Array
    policy: GaussianPolicy
    Vx: jax.Array
    Vxx: jax.Array
    divergence: jax.Array
    satisfied: jax.Array
    pd_failed: jax.Array
    adam: AdamState
    it: jax.Array
    done: jax.Array
    trace: Trace
    g_norm: jax.Array


@functools.partial(jax.jit,
                   static_argnames=("problem", "cfg", "iter_callback"))
def _ilqgkl_impl(problem, x0, traj_prev, model, cost0, lims, cfg,
                 iter_callback=None):
    T, m = traj_prev.k.shape
    n = x0.shape[-1]
    dtype = x0.dtype
    use_limits = lims is not None
    per_step = cfg.constrain_per_step

    u = traj_prev.k                            # src/iLQGkl.jl:47
    x = x0
    x_start = x0[0]
    # zero the previous feedforward for the KL bookkeeping (src/iLQGkl.jl:52)
    traj_prev = traj_prev._replace(k=jnp.zeros_like(traj_prev.k))

    kl_step = jnp.asarray(cfg.kl_step, dtype)
    if per_step:
        kl_step = jnp.broadcast_to(kl_step, (T,))
        eta0 = jnp.broadcast_to(
            jnp.asarray(cfg.eta_bracket, dtype)[:, None], (3, T))
        delta0 = jnp.full((T,), cfg.del0, dtype)
    else:
        eta0 = jnp.asarray(cfg.eta_bracket, dtype)
        delta0 = jnp.asarray(cfg.del0, dtype)

    # STEP 1: derivatives, once (src/iLQGkl.jl:88)
    derivs = problem.make_derivs()(x, u)
    kl_terms = grad_kl(traj_prev)              # src/iLQGkl.jl:92
    # Σ_prev is loop-invariant: PD-check it once (lane-tier parity —
    # solvers/batch_kl.py flags the same failure per lane)
    prev_pd = jnp.all(pd_ok(traj_prev.sigma))
    R1 = model.covariance(x, u)
    fx_model = model.fx_at(x, u)

    def run_bp(eta):
        return backward_pass(derivs, u, reg_type=1, lims=lims,
                             use_limits=use_limits, eta=eta,
                             kl_terms=kl_terms, qp_max_iter=cfg.qp_max_iter,
                             gps_mode=True)

    def bp_with_eta_retry(eta_bracket, delta):
        """η-inflation retry (src/iLQGkl.jl:97-124 scalar;
        :190-203 per-step)."""
        bp0 = run_bp(eta_bracket[1])

        def cond(s):
            bp, _, _, k, aborted = s
            return bp.diverged & (~aborted) & (k < cfg.retry_cap)

        def body(s):
            bp, eb, dl, k, _ = s
            if per_step:
                # escalate only the diverged timestep (src/iLQGkl.jl:193-195)
                idx = jnp.clip(bp.diverge_idx - 1, 0, T - 1)
                hot = jax.nn.one_hot(idx, T, dtype=dtype)
                eb = eb.at[1].add(dl * hot)
                dl = dl * (1.0 + hot)          # del[idx] *= 2
                aborted = jnp.all(eb[1] > 0.999 * eb[2])
            else:
                eb = eb.at[1].add(dl)          # src/iLQGkl.jl:104
                dl = dl * 2.0
                aborted = eb[1] > eb[2]
            bp2 = lax.cond(aborted, lambda: bp, lambda: run_bp(eb[1]))
            return (bp2, eb, dl, k + 1, aborted)

        bp, eb, dl, _, aborted = lax.while_loop(
            cond, body,
            (bp0, eta_bracket, delta, jnp.zeros((), jnp.int32),
             jnp.zeros((), bool)))
        return bp, eb, dl, aborted

    adam0 = adam_init((T,), dtype) if per_step else adam_init((), dtype)
    cap = cfg.max_iter + 1
    trace0 = Trace.zeros(cap, dtype)
    trace0 = _wt(trace0, 0, cap, cost=jnp.sum(cost0))

    carry0 = _Carry(
        eta_bracket=eta0, delta=delta0,
        x_new=x, u_new=u, cost_new=cost0,
        policy=GaussianPolicy.zeros(T, n, m, dtype),
        Vx=jnp.zeros((T, n), dtype), Vxx=jnp.zeros((T, n, n), dtype),
        divergence=jnp.zeros_like(kl_step),
        satisfied=jnp.zeros((), bool),
        pd_failed=jnp.zeros((), bool), adam=adam0,
        it=jnp.ones((), jnp.int32), done=jnp.zeros((), bool),
        trace=trace0, g_norm=jnp.zeros((), dtype))

    def loop_cond(c: _Carry):
        return (~c.done) & (c.it <= cfg.max_iter)

    def loop_body(c: _Carry) -> _Carry:
        # STEP 2: backward pass with η retry. The per-step variant resets the
        # escalation increments each outer iteration (src/iLQGkl.jl:189); the
        # scalar variant's del0 persists (src/iLQGkl.jl:104-106).
        delta_in = jnp.full((T,), cfg.del0, dtype) if per_step else c.delta
        bp, eb, delta, bp_aborted = bp_with_eta_retry(c.eta_bracket, delta_in)

        g_norm = jnp.mean(jnp.max(
            jnp.abs(bp.policy.k) / (jnp.abs(u) + 1.0), axis=-1))

        # STEP 3: full-step forward pass + covariance (src/iLQGkl.jl:132-143)
        ro = forward_pass(problem, x_start, u, x, 1.0, bp.policy, lims)
        sigma_new = forward_covariance(fx_model, R1, bp.policy)
        dcost = jnp.sum(cost0) - jnp.sum(ro.cost)

        div_t = kl_div_wiki(ro.x, x, sigma_new, bp.policy, traj_prev)
        # indefinite Σ anywhere = the reference's logdet DomainError
        # (src/klutils.jl:84): abort with a diagnostic flag
        pd_failed = (~prev_pd) | (~jnp.all(pd_ok(bp.policy.sigma)))
        if per_step:
            divergence = div_t
            # ADAM on log(η) against the constraint violation
            # (src/iLQGkl.jl:211-218)
            violation = divergence - kl_step
            log_eta, adam = adam_update(c.adam, jnp.log(eb[1]), -violation,
                                        c.it, alpha=cfg.gd_alpha)
            eta_new = jnp.clip(jnp.exp(log_eta), eb[0], eb[2])
            eb = eb.at[1].set(eta_new)
            satisfied = (jnp.all(divergence < 2.0 * kl_step)
                         & (jnp.mean(violation) < 0.1 * kl_step[0]))
            eta_maxed = jnp.all(eb[1] > 0.999 * eb[2])
        else:
            divergence = jnp.mean(div_t)
            eb, satisfied = calc_eta(divergence, eb, kl_step)
            adam = c.adam
            eta_maxed = eb[1] > 0.999 * eb[2]   # src/iLQGkl.jl:178

        satisfied = satisfied & (~pd_failed)
        done = satisfied | eta_maxed | bp_aborted | pd_failed

        if cfg.verbosity > 1:
            # reference period table (src/iLQGkl.jl:151-159): est. cost,
            # reduction, expected (α=1 → -(dV₁+dV₂)), gradient, log10(η),
            # mean divergence, policy entropy
            from ..utils import printing as _pr
            expected = -(bp.dV[0] + bp.dV[1])
            ent = entropy(bp.policy)
            _pr.ilqgkl_row(c.it, jnp.sum(ro.cost), dcost, expected, g_norm,
                           jnp.mean(eb[1]), jnp.mean(divergence), ent,
                           cfg.print_head, cfg.print_period)

        if iter_callback is not None:
            from jax.experimental import io_callback
            io_callback(iter_callback, None, c.it, ro.x, ro.u, ro.cost,
                        ordered=True)

        # reduce_ratio at α=1: Δcost / -(dV₁+dV₂) (src/iLQGkl.jl:137-140,
        # recorded at :164)
        expected = -(bp.dV[0] + bp.dV[1])
        trace = _wt(c.trace, c.it, cap,
                    alpha=jnp.ones((), dtype), improvement=dcost,
                    reduce_ratio=jnp.where(expected != 0, dcost / expected,
                                           jnp.zeros((), dtype)),
                    cost=jnp.sum(ro.cost), grad_norm=g_norm,
                    divergence=jnp.mean(divergence), eta=jnp.mean(eb[1]),
                    accepted=jnp.ones((), bool))

        return _Carry(
            eta_bracket=eb, delta=delta,
            x_new=ro.x, u_new=ro.u, cost_new=ro.cost,
            policy=bp.policy, Vx=bp.Vx, Vxx=bp.Vxx,
            divergence=divergence, satisfied=satisfied,
            pd_failed=c.pd_failed | pd_failed, adam=adam,
            it=c.it + 1, done=done, trace=trace, g_norm=g_norm)

    c = lax.while_loop(loop_cond, loop_body, carry0)

    # unconditional acceptance of the last iterate (src/iLQGkl.jl:239-241)
    policy = c.policy._replace(k=c.u_new)
    kl_violated = jnp.any((c.divergence > kl_step)
                          & (jnp.abs(c.divergence - kl_step)
                             > 0.1 * kl_step))   # src/iLQGkl.jl:248
    if cfg.verbosity > 0:
        from ..utils import printing as _pr
        eta_maxed = jnp.all(c.eta_bracket[1] > 0.999 * c.eta_bracket[2])
        _pr.ilqgkl_exit(c.satisfied, eta_maxed, kl_violated)
    return ILQGKLResult(
        x=c.x_new, u=c.u_new, policy=policy, Vx=c.Vx, Vxx=c.Vxx,
        cost=c.cost_new, trace=c.trace, n_iters=c.it - 1,
        eta=c.eta_bracket[1], eta_bracket=c.eta_bracket,
        divergence=c.divergence, satisfied=c.satisfied,
        kl_violated=kl_violated, pd_failed=c.pd_failed)


def _wt(trace: Trace, i, cap, **kv) -> Trace:
    idx = jnp.minimum(i, cap - 1)
    d = trace._asdict()
    for key, val in kv.items():
        d[key] = d[key].at[idx].set(val)
    return Trace(**d)

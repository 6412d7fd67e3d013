"""iLQG driver: the main entry point.

Reference: ``iLQG`` (``src/iLQG.jl:143-341``). The outer loop — derivative
step, λ-adaptive backward-pass retry, gradient-norm termination, backtracking
line search, accept/reject with λ update — is re-expressed as one jitted
``lax.while_loop`` with branchless ``lax.cond``/``where`` control flow, so the
whole solve vmaps over scenario batches and shards over device meshes.

Exit reasons (``reason`` field of :class:`ILQGResult`):
  0 running / max total iterations, 1 gradient norm < tol_grad
  (``src/iLQG.jl:258-261``), 2 cost change < tol_fun (``src/iLQG.jl:306-309``),
  3 λ > λmax (``src/iLQG.jl:319-322``), 4 max accepted iterations
  (``src/iLQG.jl:334``), 5 initial rollout diverged (``src/iLQG.jl:205-210``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import Derivs, GaussianPolicy, Trace
from ..problem import Problem
from ..ops.backward import BackwardOut, backward_pass
from ..ops.forward import forward_pass, line_search
from ..utils import printing as _pr
from ..ops.precision import highest_precision


def default_alphas(lo: float = 0.0, hi: float = -3.0, num: int = 11):
    """Reference backtracking coefficients 10^linspace(0,-3,11)
    (``src/iLQG.jl:145``)."""
    import numpy as np
    return tuple(float(a) for a in np.power(10.0, np.linspace(lo, hi, num)))


@dataclasses.dataclass(frozen=True)
class ILQGConfig:
    """Solver options — kwargs of the reference ``iLQG``
    (``src/iLQG.jl:143-163``). Static under jit."""

    alphas: Tuple[float, ...] = default_alphas()
    # cost-change exit threshold (src/iLQG.jl:150). The working threshold
    # is max(tol_fun, 8·eps(dtype)·|cost|) — see tol_fun_effective: the
    # reference's 1e-7 absolute is finer than f32 cost resolution for any
    # |cost| > ~0.1, so a pure-f32 solve could never take this exit and
    # instead burned ~15 rejected iterations escalating λ to λmax
    # (measured: tools/probe_f32_drift.py). At f64
    # the floor is ~8e-16·|cost|, inactive for every reference problem.
    tol_fun: float = 1e-7
    tol_grad: float = 1e-4
    max_iter: int = 500
    lam: float = 1.0
    dlam: float = 1.0
    lam_factor: float = 1.6
    lam_max: float = 1e10
    lam_min: float = 1e-6
    reg_type: int = 1
    reduce_ratio_min: float = 0.0
    # 0: silent, 1: begin/exit messages + final summary, 2: iteration table
    # with periodic headers, 3: + per-retry Cholesky failures
    # (src/iLQG.jl:133,158)
    verbosity: int = 0
    print_head: int = 10            # header every N rows (src/iLQG.jl:162)
    qp_max_iter: int = 100
    # backward-pass engine: "scan" = sequential T recursion (reference
    # semantics at any λ); "parallel" = O(log T) associative-scan Riccati
    # (ops/riccati_scan.py) used automatically whenever the iteration is in
    # the unconstrained λ≈0 regime (λ ≤ 10·lam_min, no limits, no GPS mode,
    # first-order dynamics), with the sequential recursion as fallback —
    # λ escalation after a divergence lands in the sequential branch.
    # Long-horizon/small-batch regime only (ROADMAP design item 5).
    backward: str = "scan"
    # total-iteration cap (accepted + rejected); the reference's loop counts
    # only accepted iterations (src/iLQG.jl:222) and is unbounded in rejects,
    # but each reject multiplies λ by ≥λfactor so rejects are bounded by
    # log(λmax/λmin)/log(λfactor) ≈ 90. None → max_iter + 128.
    iter_cap: Optional[int] = None

    def cap(self) -> int:
        return self.iter_cap if self.iter_cap is not None else self.max_iter + 128


def tol_fun_effective(tol_fun, cost_total):
    """Cost-change exit threshold floored at the dtype's cost resolution:
    ``max(tol_fun, 8·eps·|cost|)``. An improvement smaller than a few ulps
    of the total cost is unobservable in that dtype's cost evaluation, so
    waiting for ``dcost < 1e-7`` absolute (``src/iLQG.jl:306``) leaves an
    f32 solve stalling at its noise floor until λ escalation aborts it
    (exit 3 instead of 2, ~15 wasted rejected iterations — measured in
    tools/probe_f32_drift.py). Inactive at f64 for all reference-scale
    costs (floor ≈ 1.8e-15·|cost|)."""
    eps = jnp.finfo(jnp.asarray(cost_total).dtype).eps
    return jnp.maximum(jnp.asarray(tol_fun, jnp.asarray(cost_total).dtype),
                       8.0 * eps * jnp.abs(cost_total))


class ILQGResult(NamedTuple):
    """Return tuple of the reference ``iLQG`` (``src/iLQG.jl:340``) plus
    convergence metadata."""

    x: jax.Array              # (T, n) optimal state trajectory
    u: jax.Array              # (T, m) optimal control sequence
    policy: GaussianPolicy    # feedback policy; k == u on exit (src/iLQG.jl:303)
    Vx: jax.Array             # (T, n) cost-to-go gradient
    Vxx: jax.Array            # (T, n, n) cost-to-go Hessian
    cost: jax.Array           # (T,) per-step costs
    trace: Trace
    n_iters: jax.Array        # total iterations run
    n_accepted: jax.Array
    reason: jax.Array         # exit reason code (see module docstring)
    lam: jax.Array
    g_norm: jax.Array
    dlam: jax.Array = None    # λ-schedule rate — with lam/n_accepted, the
    #                           resume state (feed back via lam0/dlam0/
    #                           accepted0 to continue as one solve)


class _Carry(NamedTuple):
    x: jax.Array
    u: jax.Array
    cost: jax.Array
    derivs: Derivs
    flg_change: jax.Array
    lam: jax.Array
    dlam: jax.Array
    policy: GaussianPolicy
    Vx: jax.Array
    Vxx: jax.Array
    it: jax.Array
    accepted: jax.Array
    done: jax.Array
    reason: jax.Array
    trace: Trace
    g_norm: jax.Array


def _escalate(lam, dlam, factor, lam_min):
    """λ escalation with the reference's simultaneous-assignment semantics
    (``src/iLQG.jl:246,313``): λ_new uses the *old* dλ."""
    lam_new = jnp.maximum(lam * dlam, lam_min)
    dlam_new = jnp.maximum(dlam * factor, factor)
    return lam_new, dlam_new


def backward_with_retry(derivs, u, lam, dlam, cfg: ILQGConfig, lims,
                        use_limits: bool):
    """λ-adaptive backward pass (``src/iLQG.jl:234-251``): on divergence,
    escalate λ and re-run until PD or λ > λmax."""

    def run_seq(lam_):
        return backward_pass(derivs, u, lam_, reg_type=cfg.reg_type,
                             lims=lims, use_limits=use_limits,
                             qp_max_iter=cfg.qp_max_iter)

    second_order = derivs.fxx is not None
    if cfg.backward == "parallel" and not use_limits and not second_order:
        from ..ops.riccati_scan import parallel_riccati

        def run(lam_):
            # the associative-scan pass is exact only at λ=0; once λ has
            # escalated past the floor the sequential recursion takes over
            return lax.cond(lam_ <= 10.0 * cfg.lam_min,
                            lambda: parallel_riccati(derivs, u),
                            lambda: run_seq(lam_))
    else:
        run = run_seq

    out0 = run(lam)

    def cond(s):
        out, lam_, dlam_, aborted = s
        return out.diverged & (~aborted)

    def body(s):
        out, lam_, dlam_, _ = s
        lam_, dlam_ = _escalate(lam_, dlam_, cfg.lam_factor, cfg.lam_min)
        aborted = lam_ > cfg.lam_max
        out = lax.cond(aborted, lambda: out, lambda: run(lam_))
        return (out, lam_, dlam_, aborted)

    out, lam, dlam, aborted = lax.while_loop(
        cond, body, (out0, lam, dlam, jnp.zeros((), bool)))
    return out, lam, dlam, aborted


def _write_trace(trace: Trace, i, cap, **kv) -> Trace:
    idx = jnp.minimum(i, cap - 1)
    d = trace._asdict()
    for key, val in kv.items():
        d[key] = d[key].at[idx].set(val)
    return Trace(**d)


@highest_precision
def ilqg(problem: Problem, x0: jax.Array, u0: jax.Array,
         lims: Optional[jax.Array] = None,
         cfg: ILQGConfig = ILQGConfig(),
         cost0: Optional[jax.Array] = None,
         lam0: Optional[jax.Array] = None,
         dlam0: Optional[jax.Array] = None,
         accepted0: Optional[jax.Array] = None,
         iter_callback=None) -> ILQGResult:
    """Solve the optimal control problem from initial state ``x0`` (shape
    ``(n,)`` — initial rollout performed, ``src/iLQG.jl:181-192``) or from a
    pre-rolled trajectory ``x0`` of shape ``(T, n)`` with optional per-step
    ``cost0`` (``src/iLQG.jl:193-197``). ``u0``: initial controls ``(T, m)``.

    ``lam0``/``dlam0``/``accepted0``: optional scalar initial λ / dλ /
    accepted-iteration counters — the RESUME entry (same contract as the
    lane tier's, :func:`~.batch.ilqg_batch_lanes`): a solve continued from
    a prior :class:`ILQGResult` (pre-rolled ``x0`` + these three) behaves
    like one uninterrupted solve (λ schedule and iteration budget carry
    over — reference warm-start semantics, ``src/iLQG.jl:85-87,193-197``).

    ``iter_callback``: optional host callback — the reference's per-iteration
    ``plotFn`` hook (``src/iLQG.jl:160,330``) — invoked each iteration as
    ``f(it, x, u, cost, accepted)`` with NumPy arrays via an ordered
    ``io_callback`` (single-solve use; do not combine with ``vmap``).

    Fully jittable; batch with ``jax.vmap`` over leading axes of
    ``x0``/``u0`` (and ``lims`` if per-scenario).
    """
    pre_rolled = x0.ndim == 2
    x0 = jnp.asarray(x0, u0.dtype)
    return _ilqg_impl(problem, x0, u0, lims, cfg, cost0, pre_rolled,
                      lam0, dlam0, accepted0, iter_callback)


@functools.partial(jax.jit,
                   static_argnames=("problem", "cfg", "pre_rolled",
                                    "iter_callback"))
def _ilqg_impl(problem, x0, u0, lims, cfg, cost0, pre_rolled,
               lam0=None, dlam0=None, accepted0=None,
               iter_callback=None):
    T, m = u0.shape
    n = x0.shape[-1]
    dtype = u0.dtype
    use_limits = lims is not None
    derivs_fn = problem.make_derivs()
    cap = cfg.cap()
    alphas = jnp.asarray(cfg.alphas, dtype)

    # ---- initial trajectory (src/iLQG.jl:181-210)
    if pre_rolled:
        x_init = x0
        u_init = u0
        cost_init = (problem.trajectory_cost(x0, u0)
                     if cost0 is None else cost0)
        init_ok = jnp.ones((), bool)
        x_start = x0[0]
    else:
        x_start = x0
        # α-sweep: scale u0 by each α, take the first non-diverging rollout
        ro = jax.vmap(lambda a: forward_pass(problem, x0, a * u0,
                                             policy=None, lims=lims))(alphas)
        ok = jnp.all(jnp.abs(ro.x) < 1e8, axis=(1, 2))  # src/iLQG.jl:187
        init_ok = jnp.any(ok)
        idx = jnp.argmax(ok)
        x_init = ro.x[idx]
        u_init = ro.u[idx]
        cost_init = ro.cost[idx]

    derivs0 = derivs_fn(x_init, u_init)
    policy0 = GaussianPolicy.zeros(T, n, m, dtype)
    lam_init = (jnp.asarray(lam0, dtype) if lam0 is not None
                else jnp.asarray(cfg.lam, dtype))
    dlam_init = (jnp.asarray(dlam0, dtype) if dlam0 is not None
                 else jnp.asarray(cfg.dlam, dtype))
    acc_init = (jnp.asarray(accepted0, jnp.int32) + 1
                if accepted0 is not None else jnp.ones((), jnp.int32))
    trace0 = Trace.zeros(cap, dtype)
    trace0 = _write_trace(trace0, 0, cap, lam=lam_init,
                          dlam=dlam_init,
                          cost=jnp.sum(cost_init))

    carry0 = _Carry(
        x=x_init, u=u_init, cost=cost_init, derivs=derivs0,
        flg_change=jnp.ones((), bool),
        lam=lam_init, dlam=dlam_init,
        policy=policy0, Vx=jnp.zeros((T, n), dtype),
        Vxx=jnp.zeros((T, n, n), dtype),
        it=jnp.ones((), jnp.int32), accepted=acc_init,
        done=~init_ok,
        reason=jnp.where(init_ok, 0, 5).astype(jnp.int32),
        trace=trace0, g_norm=jnp.zeros((), dtype),
    )

    def loop_cond(c: _Carry):
        return (~c.done) & (c.accepted <= cfg.max_iter) & (c.it < cap)

    def loop_body(c: _Carry) -> _Carry:
        # == STEP 1: differentiate along the trajectory when it changed
        #    (src/iLQG.jl:226-229)
        derivs = lax.cond(c.flg_change,
                          lambda: derivs_fn(c.x, c.u),
                          lambda: c.derivs)

        # == STEP 2: backward pass with λ retry (src/iLQG.jl:234-251)
        bp, lam, dlam, bp_aborted = backward_with_retry(
            derivs, c.u, c.lam, c.dlam, cfg, lims, use_limits)

        # gradient-norm termination (src/iLQG.jl:256-261)
        g_norm = jnp.mean(jnp.max(
            jnp.abs(bp.policy.k) / (jnp.abs(c.u) + 1.0), axis=-1))
        grad_conv = (g_norm < cfg.tol_grad) & (lam < 1e-5) & (~bp_aborted)

        # == STEP 3: line search (src/iLQG.jl:264-283), masked out if the
        #    backward pass failed or we already converged on gradient
        ls = line_search(problem, x_start, c.u, c.x, jnp.sum(c.cost),
                         bp.policy, bp.dV, alphas, lims,
                         cfg.reduce_ratio_min)
        accept = ls.done & (~bp_aborted) & (~grad_conv)

        # == STEP 4: accept / reject, λ update (src/iLQG.jl:293-323)
        # accept: dλ decreases first, then λ uses the *new* dλ
        dlam_acc = jnp.minimum(dlam / cfg.lam_factor, 1.0 / cfg.lam_factor)
        lam_acc = jnp.maximum(lam * dlam_acc, cfg.lam_min)
        # reject: simultaneous semantics (λ uses old dλ)
        lam_rej, dlam_rej = _escalate(lam, dlam, cfg.lam_factor, cfg.lam_min)

        lam_new = jnp.where(accept, lam_acc, lam_rej)
        dlam_new = jnp.where(accept, dlam_acc, dlam_rej)

        cost_conv = accept & (ls.dcost < tol_fun_effective(
            cfg.tol_fun, jnp.sum(c.cost)))
        lam_exceeded = (~accept) & (lam_new > cfg.lam_max)

        done = grad_conv | cost_conv | lam_exceeded
        reason = jnp.where(grad_conv, 1,
                           jnp.where(cost_conv, 2,
                                     jnp.where(lam_exceeded, 3, 0)))

        # on gradient convergence the reference breaks *before* the line
        # search and λ update — freeze state in that case
        sel = lambda new, old: jax.tree_util.tree_map(
            lambda a, b: jnp.where(grad_conv, b, a), new, old)
        lam_new, dlam_new = sel((lam_new, dlam_new), (lam, dlam))

        x_new = jnp.where(accept, ls.x, c.x)
        u_new = jnp.where(accept, ls.u, c.u)
        cost_new = jnp.where(accept, ls.cost, c.cost)
        # reference sets traj_new.k = u on accept (src/iLQG.jl:303)
        pol_k = jnp.where(accept, u_new, bp.policy.k)
        policy = bp.policy._replace(k=pol_k)

        if cfg.verbosity > 2:
            _pr.ilqg_cholesky_failed(
                jnp.where(bp.diverged, bp.diverge_idx, 0))
        if cfg.verbosity > 1:
            _pr.ilqg_row(c.it, jnp.sum(c.cost), ls.dcost, ls.expected,
                         g_norm, lam_new, accept, cfg.print_head)
        if iter_callback is not None:
            from jax.experimental import io_callback
            io_callback(iter_callback, None, c.it, x_new, u_new,
                        cost_new, accept, ordered=True)

        trace = _write_trace(
            c.trace, c.it, cap,
            lam=lam_new, dlam=dlam_new,
            alpha=jnp.where(accept, ls.alpha, jnp.nan),
            improvement=ls.dcost, cost=jnp.sum(cost_new),
            grad_norm=g_norm, reduce_ratio=ls.reduce_ratio,
            divergence=bp.diverge_idx.astype(dtype), accepted=accept)

        return _Carry(
            x=x_new, u=u_new, cost=cost_new, derivs=derivs,
            flg_change=accept,
            lam=lam_new, dlam=dlam_new,
            policy=policy, Vx=bp.Vx, Vxx=bp.Vxx,
            it=c.it + 1,
            accepted=c.accepted + accept.astype(jnp.int32),
            done=done, reason=reason.astype(jnp.int32),
            trace=trace, g_norm=g_norm)

    if cfg.verbosity > 0:
        _pr.ilqg_begin()

    c = lax.while_loop(loop_cond, loop_body, carry0)

    reason = jnp.where((c.reason == 0) & (c.accepted > cfg.max_iter),
                       4, c.reason).astype(jnp.int32)

    if cfg.verbosity > 0:
        _pr.ilqg_exit(reason, c.it - 1, jnp.sum(c.cost), c.g_norm, c.lam)

    return ILQGResult(
        x=c.x, u=c.u, policy=c.policy, Vx=c.Vx, Vxx=c.Vxx, cost=c.cost,
        trace=c.trace, n_iters=c.it - 1, n_accepted=c.accepted - 1,
        reason=reason, lam=c.lam, g_norm=c.g_norm, dlam=c.dlam)

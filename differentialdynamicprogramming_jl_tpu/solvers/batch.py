"""Batched lane-layout iLQG driver — the GPU fast path for MPC fleets.

Runs the full iLQG outer loop (reference ``src/iLQG.jl:143-341``) for
thousands of scenarios at once with **all per-timestep data in lane layout**
(batch on the lanes, see ``ops/pallas/pack.py``), chaining the Pallas
backward kernel and the fused line-search kernel with zero transposes:

    trajectory stream  →  backward kernel (derivatives computed in-register)
         ↑                      ↓ gains stream
    accepted-α re-roll  ←  per-α totals → pick α per scenario  (one kernel)

The loop state is ONE trajectory stream (T, n+m+1, nB) + TILE holding
[x, u, running cost] — both kernels read partial slot windows of it, and the
line-search kernel emits the next iterate in exactly this format.

Control flow (λ retry, accept/reject, per-scenario termination) is
elementwise on (nB,) + TILE lane masks inside one ``lax.while_loop`` — the
reference's per-problem while loops run in lock-step with per-lane masking,
exactly the semantics of ``solvers/ilqg.py`` vmapped (PERF.md has the
measured speed of both tiers).

Restrictions of this fast path (the generic ``ilqg``/``ilqg_batched`` XLA
path covers the rest): f32 (full DDP supported when ``derivs_tiles``
returns second-order tiles), GPS/KL mode only at the kernel level
(``backward_lanes(prev=…, eta=…)``), per-iteration trace via
``record_trace=True``.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import GaussianPolicy
from ..ops.pallas.pack import (to_lanes, from_lanes, vec_to_lanes,
                               vec_from_lanes, padded_batch,
                               lane_valid as lane_valid_mask)
from ..ops.pallas.backward_kernel import OutLayout, backward_lanes
from ..ops.pallas.forward_kernel import (LanesModel, forward_lanes,
                                         linesearch_lanes)
from .ilqg import ILQGConfig, tol_fun_effective


class BatchTrace(NamedTuple):
    """Per-iteration convergence record for the whole fleet, batch-major
    (B, cap) — fast-path equivalent of :class:`~..policy.Trace`
    (reference MVHistory keys, ``src/iLQG.jl:325-330``)."""

    cost: jax.Array
    lam: jax.Array
    dlam: jax.Array
    grad_norm: jax.Array
    improvement: jax.Array
    reduce_ratio: jax.Array
    alpha: jax.Array
    accepted: jax.Array
    divergence: jax.Array   # backward-pass diverge timestep (0 = none)


class BatchILQGResult(NamedTuple):
    """Per-scenario results, batch-major (unpacked from lane layout)."""

    x: jax.Array          # (B, T, n)
    u: jax.Array          # (B, T, m)
    policy: GaussianPolicy  # leaves (B, T, ...); k == final u
    Vx: jax.Array         # (B, T, n)
    Vxx: jax.Array        # (B, T, n, n)
    cost: jax.Array       # (B, T) running costs
    cost_total: jax.Array  # (B,) incl. terminal component
    n_iters: jax.Array    # (B,)
    n_accepted: jax.Array  # (B,)
    reason: jax.Array     # (B,) exit codes as solvers.ilqg
    lam: jax.Array        # (B,)
    dlam: jax.Array       # (B,)
    g_norm: jax.Array     # (B,)
    trace: Optional[BatchTrace] = None   # with record_trace=True


class _Carry(NamedTuple):
    traj: jax.Array       # (T, n+m+1, nB) + TILE: x, u, running cost
    bwd_in: Optional[jax.Array]  # cached packed-derivs stream (None when
    #                              derivatives are computed in-kernel)
    cost_tot: jax.Array   # (nB,) + TILE incl. terminal
    lam: jax.Array        # (nB,) + TILE
    dlam: jax.Array
    traj_bwd: jax.Array   # x/u slots (T, n+m, ...) of the trajectory the
    #                       LAST executed backward pass saw (= traj at
    #                       iteration entry; done lanes frozen). Produced as
    #                       the line-search kernel's ECHO output (a fresh
    #                       value the carry position takes directly) — a
    #                       c.traj→traj_bwd rotation would instead cost a
    #                       full materializing copy per iteration, because
    #                       position buffers are fixed in XLA while loops
    #                       (tools/hlo_copy_audit.py).
    lam_used: jax.Array   # post-retry λ that backward ran with — together
    #                       with traj_bwd this replays the final backward
    #                       outputs once after the loop (see below)
    done: jax.Array       # bool lanes
    reason: jax.Array     # int32 lanes
    accepted: jax.Array   # int32 lanes
    it: jax.Array         # scalar int32
    it_lane: jax.Array    # int32 lanes: last iteration each scenario ran
    g_norm: jax.Array     # lanes
    trace: Optional[BatchTrace]  # lane-layout (cap, nB) + TILE or None


def _bc(mask, arr):
    """Broadcast a lane mask (nB,) + TILE against (T, s, nB) + TILE."""
    extra = arr.ndim - mask.ndim
    return mask.reshape((1,) * extra + mask.shape)


def split_lims(lims):
    """Sort a user ``lims`` into (static tuple, per-scenario array): tuples/
    lists of pairs stay static (hashable jit arg, folded into the kernel);
    a (B, m, 2) array becomes the traced per-scenario input."""
    if lims is None:
        return None, None
    if isinstance(lims, tuple) or isinstance(lims, list):
        return tuple((float(lo), float(hi)) for lo, hi in lims), None
    lims = jnp.asarray(lims)
    assert lims.ndim == 3 and lims.shape[-1] == 2, (
        f"per-scenario lims must be (B, m, 2), got {lims.shape}")
    return None, lims


def pack_lims(lims_batch, B):
    """(B, m, 2) per-scenario limits → (2m, nB) + TILE lane tiles, slot
    order [lo_0, hi_0, ...] (the kernels' dynamic-lims input). Lanes beyond
    B pad with zeros (lo=hi=0) — finite, and sliced away on unpack."""
    m = lims_batch.shape[1]
    flat = lims_batch.astype(jnp.float32).reshape(B, 1, 2 * m)
    return to_lanes(flat, B)[0]


def _eval_costs_lanes(model, x_l, u_l, par_l):
    """Per-step costs of a lane-layout trajectory, evaluated with the
    model's lane functions outside the kernel (pre-rolled init only)."""
    P = model.n_params
    par = [par_l[p] for p in range(P)] if P else None

    def ct(xt, ut, t):
        xs = [xt[i] for i in range(model.n)]
        us = [ut[mi] for mi in range(model.m)]
        return model.cost(xs, us, t, par) if P else model.cost(xs, us, t)

    return jax.vmap(ct)(x_l, u_l, jnp.arange(x_l.shape[0]))


def _eval_terminal_lanes(model, xT, par_l):
    """Terminal cost at the last stored state (the forward kernel's
    convention — evaluated at stream entry T-1)."""
    if model.terminal is None:
        return jnp.zeros(xT.shape[1:], jnp.float32)
    xs = [xT[i] for i in range(model.n)]
    if model.n_params:
        return model.terminal(xs, [par_l[p] for p in range(model.n_params)])
    return model.terminal(xs)


def ilqg_batch_lanes(model, packed_derivs, x0s, u0s,
                     lims=None, cfg: ILQGConfig = ILQGConfig(),
                     derivs_tiles=None, params=None, cost0=None,
                     warm_start: bool = False, lam0=None, dlam0=None,
                     accepted0=None, max_steps=None,
                     kt_backward: int = 1, kt_forward: int = 1,
                     record_trace: bool = False, interpret: bool = False):
    """Public entry — see :func:`_ilqg_batch_lanes_jit` for the full docs.
    Fills ``max_steps`` (always passed as a traced scalar) OUTSIDE the jit
    boundary, so bounded fleet-scheduler chunks and plain unbounded solves
    with the same cfg share one compiled program.

    ``lims`` may be a static ``((lo, hi),)*m`` tuple (fleet-wide limits,
    folded into the kernels) or a PER-SCENARIO array (B, m, 2) — the
    reference takes lims as runtime data (``src/iLQG.jl:124``), so
    heterogeneous actuator bounds ride a traced lane input and stay on
    this fast path in one compile."""
    lims, lims_batch = split_lims(lims)
    if max_steps is None:
        max_steps = cfg.cap() - 1
    return _ilqg_batch_lanes_jit(model, packed_derivs, x0s, u0s,
                                 lims=lims, lims_batch=lims_batch, cfg=cfg,
                                 derivs_tiles=derivs_tiles, params=params,
                                 cost0=cost0, warm_start=warm_start,
                                 lam0=lam0, dlam0=dlam0,
                                 accepted0=accepted0,
                                 max_steps=jnp.asarray(max_steps, jnp.int32),
                                 kt_backward=kt_backward,
                                 kt_forward=kt_forward,
                                 record_trace=record_trace,
                                 interpret=interpret)


@functools.partial(
    jax.jit,
    static_argnames=("model", "packed_derivs", "derivs_tiles", "lims", "cfg",
                     "warm_start", "kt_backward", "kt_forward",
                     "record_trace", "interpret"))
def _ilqg_batch_lanes_jit(model: LanesModel,
                     packed_derivs: Optional[Callable],
                     x0s: jax.Array,
                     u0s: jax.Array,
                     lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                     lims_batch: Optional[jax.Array] = None,
                     cfg: ILQGConfig = ILQGConfig(),
                     derivs_tiles: Optional[Callable] = None,
                     params: Optional[jax.Array] = None,
                     cost0: Optional[jax.Array] = None,
                     warm_start: bool = False,
                     lam0: Optional[jax.Array] = None,
                     dlam0: Optional[jax.Array] = None,
                     accepted0: Optional[jax.Array] = None,
                     max_steps: Optional[jax.Array] = None,
                     kt_backward: int = 1,
                     kt_forward: int = 1,
                     record_trace: bool = False,
                     interpret: bool = False) -> BatchILQGResult:
    """Solve B independent iLQG problems (reference semantics of
    ``src/iLQG.jl:143-341`` per scenario).

    - ``model``: :class:`LanesModel` (dynamics/cost on lane tiles).
    - ``derivs_tiles``: in-kernel derivative function (preferred — the
      backward kernel streams only the trajectory); or
      ``packed_derivs``: ``(x_lanes, u_lanes) → (T, D+m, ...)`` stream.
    - ``x0s``: (B, n) initial states (initial rollout α-sweep performed,
      ``src/iLQG.jl:181-192``) or **pre-rolled** (B, T, n) trajectories
      used verbatim with ``u0s`` (``src/iLQG.jl:193-197``) — the warm-start
      entry for MPC loops on the fast path.
    - ``cost0``: optional (B, T) per-step costs of a pre-rolled trajectory
      (reference ``cost`` kwarg, ``src/iLQG.jl:85-87``); computed from
      ``model`` when omitted.
    - ``warm_start``: with (B, n) ``x0s``, skip the initial α-sweep and
      roll ``u0s`` open-loop at α=1 (one kernel pass instead of two — the
      MPC re-roll of a shifted plan from newly measured states).
    - ``lam0``/``dlam0``/``accepted0``: optional per-scenario (B,) initial
      λ / dλ / accepted-iteration counters — the RESUME entry: a solve
      continued from a prior :class:`BatchILQGResult` (pre-rolled ``x0s`` +
      these three) behaves like one uninterrupted solve (λ schedule and
      iteration budget carry over; see :mod:`.fleet`).
    - ``max_steps``: optional TRACED scalar bounding this call's loop trips
      below ``cfg.cap()`` — lets the fleet scheduler vary the chunk length
      without changing the compiled program (a different static
      ``iter_cap`` is a fresh multi-minute cold compile).
    - ``params``: optional per-scenario dynamics/cost parameters (B, P) for
      heterogeneous fleets (requires a parametrized ``model``/
      ``derivs_tiles`` with ``n_params == P``).
    - ``lims``: static ``((lo, hi),) * m`` or None; ``lims_batch``:
      per-scenario (B, m, 2) limits as a traced input (heterogeneous
      actuator bounds, one compile — reference runtime-data lims,
      ``src/iLQG.jl:124``). The public wrapper sorts a user ``lims`` into
      the right one (:func:`split_lims`).

    Per-iteration introspection: the reference fires a ``plotFn`` host
    callback every iteration (``src/iLQG.jl:160,330``); a per-element host
    hook does not scale to 4096 lanes inside one jitted while_loop, so the
    sanctioned equivalents here are (a) ``record_trace=True`` — the full
    per-scenario per-iteration :class:`BatchTrace` (cost, λ, α,
    reduce_ratio, ...) returned as (B, cap) arrays to post-process — and
    (b) ``cfg.verbosity > 1`` fleet-aggregate rows during the solve. For a
    genuine per-iteration callback on a single scenario, use the XLA tier's
    ``iter_callback`` (:func:`~.ilqg.ilqg`).
    """
    assert derivs_tiles is not None or packed_derivs is not None
    n, m = model.n, model.m
    B, T = u0s.shape[0], u0s.shape[1]
    f32 = jnp.float32
    lay = OutLayout(n, m)
    cap = cfg.cap()
    pre_rolled = x0s.ndim == 3

    if pre_rolled:
        x_roll = to_lanes(x0s.astype(f32), B)               # (T, n, ...)
        x0_l = x_roll[0]
    else:
        x0_l = to_lanes(x0s.astype(f32)[:, None, :], B)[0]  # (n, nB) + TILE
    u_nom0 = to_lanes(u0s.astype(f32), B)                   # (T, m, ...)
    L = x0_l.shape[1:]                                      # (nB,) + TILE
    ones = jnp.ones(L, f32)
    zeros = jnp.zeros(L, f32)

    alphas = jnp.asarray(cfg.alphas, f32)
    A = alphas.shape[0]
    al_all = jnp.broadcast_to(alphas.reshape(A, 1, 1, 1), (A,) + L)
    g_sl = lay.K + m * n          # gains window of the backward out stream
    # The loop only consumes the k/K gain slots of the backward output (the
    # forward passes + the gradient-norm exit) and the reduced stats; the
    # full stream (Vx, Vxx, Σ) is ~5× larger and the kernel is
    # bandwidth-bound on writing it. So the hot loop runs the kernel in
    # "gains" emission and the full stream is replayed ONCE after the loop
    # from (traj_bwd, lam_used) — the exact inputs each lane's last backward
    # ran with, making the replay bit-identical to what the old carried
    # stream held.

    Bp = padded_batch(B)
    if params is not None:
        # pad ragged fleets with a BENIGN parameter row (params[0]), not
        # zeros: zero params can make padded lanes' dynamics NaN (e.g.
        # pendcart pole length l=0), and NaN lanes would otherwise drive the
        # λ-retry while_loop through ~90 full-fleet kernel relaunches before
        # aborting. Padded lanes are sliced away on unpack either way.
        pf = params.astype(f32)
        if Bp != B:
            pf = jnp.concatenate(
                [pf, jnp.broadcast_to(pf[:1], (Bp - B,) + pf.shape[1:])],
                axis=0)
        par_l = to_lanes(pf[:, None, :], Bp)[0]
    else:
        par_l = None
    lims_l = pack_lims(lims_batch, B) if lims_batch is not None else None
    # lanes beyond B are layout padding: never let them drive control flow
    lane_valid = lane_valid_mask(B)

    def run_fwd(traj, gains, al, gk, gK, emit, g_slots=None, echo=False):
        return forward_lanes(traj, gains, x0_l, al, par_l, lims_l,
                             model=model,
                             lims=lims, gk=gk, gK=gK, g_slots=g_slots,
                             emit_traj=emit, emit_echo=echo,
                             k_t=kt_forward,
                             interpret=interpret)

    def run_bwd(traj_or_dp, lam, emit="gains"):
        return backward_lanes(traj_or_dp, lam, n=n, m=m,
                              reg_type=cfg.reg_type, lims=lims,
                              k_t=kt_backward, derivs_tiles=derivs_tiles,
                              params=par_l, lims_lanes=lims_l, emit=emit,
                              interpret=interpret)

    if pre_rolled:
        # trust the supplied trajectory verbatim (src/iLQG.jl:193-197) —
        # no rollout; per-step costs from cost0 ((B, T), or (B, T+1) with
        # the XLA tier's trailing terminal row) or the model's lane fns
        if cost0 is not None:
            c0 = cost0.astype(f32)
            if c0.shape[1] == T + 1:
                c_l = to_lanes(c0[:, :T, None], B)[:, 0]
                cterm = to_lanes(c0[:, T:, None], B)[0, 0]
            else:
                c_l = to_lanes(c0[:, :, None], B)[:, 0]
                cterm = _eval_terminal_lanes(model, x_roll[T - 1], par_l)
        else:
            c_l = _eval_costs_lanes(model, x_roll, u_nom0, par_l)
            cterm = _eval_terminal_lanes(model, x_roll[T - 1], par_l)
        traj_init = jnp.concatenate([x_roll, u_nom0, c_l[:, None]], axis=1)
        tot_init = jnp.sum(c_l, axis=0) + cterm
        any0 = jnp.isfinite(tot_init) & (tot_init < 1e16)
    else:
        # ---- initial rollout α-sweep (src/iLQG.jl:181-210): u ← α·u0 via
        #      the trick k := u0, u_nom := 0; warm_start pins α=1 (the MPC
        #      re-roll of a shifted plan — one kernel pass, no sweep)
        traj0 = jnp.zeros((T, n + m) + L, f32)
        gains0 = jnp.concatenate(
            [u_nom0, jnp.zeros((T, m * n) + L, f32)], axis=1)
        if warm_start:
            al_init = jnp.ones(L, f32)
            any0 = jnp.ones(L, bool)  # guarded below by fb0 finiteness
        else:
            fa0 = run_fwd(traj0, gains0, al_all, 0, m, False)
            ok0 = jnp.isfinite(fa0.totals) & (fa0.totals < 1e16)  # |x|<1e8
            any0 = jnp.any(ok0, axis=0)
            idx0 = jnp.argmax(ok0, axis=0)
            al_init = jnp.where(any0, alphas[idx0], 0.0)
        fb0 = run_fwd(traj0, gains0, al_init[None], 0, m, True)
        traj_init, tot_init = fb0.traj, fb0.totals[0]
        if warm_start:
            any0 = jnp.isfinite(tot_init) & (tot_init < 1e16)
        # NaN scrub on init-diverged (reason 5) lanes: once x overflows to
        # Inf, the kernel's control law computes u = K·(Inf−0) = 0·Inf = NaN
        # and NaN then re-enters the dynamics. These lanes exit immediately
        # with this rollout as their result (see the restore after the
        # loop), so keep it Inf-marked but NaN-free, like the reference's
        # diverged rollout (big-but-finite values, src/iLQG.jl:187).
        bad0 = _bc(~any0, traj_init)
        traj_init = jnp.where(
            bad0 & jnp.isnan(traj_init), 0.0, traj_init)
        tot_init = jnp.where((~any0) & jnp.isnan(tot_init), jnp.inf,
                             tot_init)

    bwd_in0 = (packed_derivs(traj_init[:, :n], traj_init[:, n:n + m])
               if packed_derivs is not None else None)

    if record_trace:
        tz = jnp.zeros((cap,) + L, f32)
        trace0 = BatchTrace(cost=tz.at[0].set(tot_init), lam=tz, dlam=tz,
                            grad_norm=tz, improvement=tz, reduce_ratio=tz,
                            alpha=jnp.full((cap,) + L, jnp.nan, f32),
                            accepted=tz, divergence=tz)
    else:
        trace0 = None

    lam_init = (vec_to_lanes(lam0.astype(f32)) if lam0 is not None
                else cfg.lam * ones)
    dlam_init = (vec_to_lanes(dlam0.astype(f32)) if dlam0 is not None
                 else cfg.dlam * ones)
    acc_init = (vec_to_lanes(accepted0.astype(jnp.int32)) + 1
                if accepted0 is not None else jnp.ones(L, jnp.int32))

    carry0 = _Carry(
        traj=traj_init, bwd_in=bwd_in0, cost_tot=tot_init,
        lam=lam_init, dlam=dlam_init,
        traj_bwd=traj_init[:, :n + m], lam_used=lam_init,
        done=(~any0) | (~lane_valid),
        reason=jnp.where(any0, 0, 5).astype(jnp.int32),
        accepted=acc_init,
        it=jnp.ones((), jnp.int32),
        it_lane=jnp.zeros(L, jnp.int32),
        g_norm=zeros, trace=trace0)

    cap_rt = jnp.minimum(jnp.asarray(max_steps, jnp.int32) + 1, cap)

    def loop_cond(c: _Carry):
        return (~jnp.all(c.done)) & (c.it < cap_rt)

    def loop_body(c: _Carry) -> _Carry:
        active = ~c.done
        u_cur = c.traj[:, n:n + m]

        # == STEP 1+2: derivatives + backward pass with per-scenario λ retry
        #    (src/iLQG.jl:226-251). The packed-derivs stream is carried and
        #    rebuilt only after accepted iterations (flg_change caching,
        #    src/iLQG.jl:226-229); the derivs_tiles path recomputes
        #    derivatives in-register inside the kernel, where they are
        #    cheaper than the HBM traffic a cache would add.
        bwd_in = c.traj if derivs_tiles is not None else c.bwd_in
        res0 = run_bwd(bwd_in, c.lam)

        def retry_cond(s):
            _res, lam_, _dlam, aborted = s
            div = _res.stats[2] > 0.5
            return jnp.any(active & div & (~aborted))

        def retry_body(s):
            res_, lam_, dlam_, aborted = s
            div = (res_.stats[2] > 0.5) & active & (~aborted)
            lam_n = jnp.where(div, jnp.maximum(lam_ * dlam_, cfg.lam_min),
                              lam_)
            dlam_n = jnp.where(div, jnp.maximum(dlam_ * cfg.lam_factor,
                                                cfg.lam_factor), dlam_)
            aborted_n = aborted | (div & (lam_n > cfg.lam_max))
            res_n = run_bwd(bwd_in, lam_n)
            return (res_n, lam_n, dlam_n, aborted_n)

        res, lam, dlam, bp_aborted = lax.while_loop(
            retry_cond, retry_body,
            (res0, c.lam, c.dlam, jnp.zeros(L, bool)))
        bo = res.out
        dV1, dV2 = res.stats[0], res.stats[1]
        bp_bad = bp_aborted | (res.stats[2] > 0.5)

        # gradient-norm termination (src/iLQG.jl:256-261)
        k_s = bo[:, lay.k:lay.k + m]                        # (T, m, ...)
        g_norm = jnp.mean(jnp.max(
            jnp.abs(k_s) / (jnp.abs(u_cur) + 1.0), axis=1), axis=0)
        grad_conv = (g_norm < cfg.tol_grad) & (lam < 1e-5) & (~bp_bad)

        # == STEP 3: line search — FUSED kernel (src/iLQG.jl:264-283):
        #    per-α totals, the accept decision (in registers between the
        #    kernel's two loops), and the accepted-α re-roll in one launch. The
        #    re-roll uses α=0 on non-accepted lanes: u = u_nom + K(x−x_old)
        #    retraces a kernel-produced trajectory bit-exactly, so the
        #    accept-select on the (T, n+m+1, lanes) stream is only needed
        #    for user-supplied pre-rolled trajectories (which may be
        #    dynamics-inconsistent and must be kept verbatim on reject,
        #    src/iLQG.jl:193-197). The echo output carries the INPUT x/u
        #    slots (= the entry trajectory this iteration's backward
        #    linearized around) as a fresh kernel output the traj_bwd carry
        #    position can take directly — no position-to-position rotation
        #    copy (2×41 MB/iteration at B=4096, T=500;
        #    tools/hlo_copy_audit.py).
        allow = (~bp_bad) & (~grad_conv) & active
        sel = jnp.stack([dV1, dV2, c.cost_tot, allow.astype(f32)])
        fb = linesearch_lanes(c.traj, bo, x0_l, sel, par_l, lims_l,
                              model=model, alphas=cfg.alphas,
                              reduce_ratio_min=cfg.reduce_ratio_min,
                              lims=lims, gk=lay.k, gK=lay.K, g_slots=g_sl,
                              in_place=not pre_rolled,
                              k_t=kt_forward, interpret=interpret)
        al_sel = fb.ls[0]
        any_ok = fb.ls[1] > 0.5
        dcost_sel = fb.ls[2]
        accept = any_ok & allow

        # == STEP 4: accept / reject λ update (src/iLQG.jl:293-323)
        dlam_acc = jnp.minimum(dlam / cfg.lam_factor, 1.0 / cfg.lam_factor)
        lam_acc = jnp.maximum(lam * dlam_acc, cfg.lam_min)
        lam_rej = jnp.maximum(lam * dlam, cfg.lam_min)
        dlam_rej = jnp.maximum(dlam * cfg.lam_factor, cfg.lam_factor)
        lam_n = jnp.where(accept, lam_acc, lam_rej)
        dlam_n = jnp.where(accept, dlam_acc, dlam_rej)

        # dtype-resolution floor on the exit threshold (see
        # ilqg.tol_fun_effective): essential on this tier — the lane fast
        # path is f32-only, where dcost < 1e-7 absolute is unreachable
        cost_conv = accept & (dcost_sel < tol_fun_effective(
            cfg.tol_fun, c.cost_tot))
        lam_exceeded = (active & (~accept) & (~grad_conv)
                        & (lam_n > cfg.lam_max))

        # on gradient convergence the reference breaks before the λ update
        lam_n = jnp.where(grad_conv, lam, lam_n)
        dlam_n = jnp.where(grad_conv, dlam, dlam_n)

        newly_done = active & (grad_conv | cost_conv | lam_exceeded)
        reason_new = jnp.where(
            grad_conv, 1, jnp.where(cost_conv, 2, 3)).astype(jnp.int32)
        reason = jnp.where(newly_done, reason_new, c.reason)

        if pre_rolled:
            traj_n = jnp.where(_bc(accept, c.traj), fb.traj, c.traj)
            tot_n = jnp.where(accept, fb.ls[4], c.cost_tot)
        else:
            traj_n = fb.traj
            tot_n = fb.ls[4]

        accepted = c.accepted + accept.astype(jnp.int32)
        done = c.done | newly_done | (accepted > cfg.max_iter)

        if record_trace:
            ti = jnp.minimum(c.it, cap - 1)
            ratio_sel = fb.ls[3]
            trace = BatchTrace(
                cost=c.trace.cost.at[ti].set(tot_n),
                lam=c.trace.lam.at[ti].set(lam_n),
                dlam=c.trace.dlam.at[ti].set(dlam_n),
                grad_norm=c.trace.grad_norm.at[ti].set(g_norm),
                improvement=c.trace.improvement.at[ti].set(dcost_sel),
                reduce_ratio=c.trace.reduce_ratio.at[ti].set(ratio_sel),
                alpha=c.trace.alpha.at[ti].set(
                    jnp.where(accept, al_sel, jnp.nan)),
                accepted=c.trace.accepted.at[ti].set(
                    accept.astype(f32)),
                divergence=c.trace.divergence.at[ti].set(res.stats[3]))
        else:
            trace = None

        if cfg.verbosity > 1:
            # fleet-aggregate iteration row (the reference's per-problem
            # table, src/iLQG.jl:288-303, does not scale to 4096 lanes)
            from ..utils import printing as _pr
            n_act = jnp.sum(active.astype(jnp.int32))
            den = jnp.maximum(n_act, 1).astype(f32)
            _pr.lanes_row(
                c.it, n_act,
                jnp.sum(jnp.where(active, tot_n, 0.0)) / den,
                jnp.sum(accept.astype(f32)) / den,
                jnp.sum(jnp.where(active, lam_n, 0.0)) / den,
                jnp.sum(jnp.where(active, g_norm, 0.0)) / den,
                cfg.print_head)

        if packed_derivs is not None:
            # rebuild the cached stream only when some scenario moved; a
            # fleet-wide all-reject iteration skips the recomputation the
            # reference's flg_change would skip (src/iLQG.jl:226-229)
            bwd_in_n = lax.cond(
                jnp.any(accept),
                lambda: packed_derivs(traj_n[:, :n], traj_n[:, n:n + m]),
                lambda: c.bwd_in)
        else:
            bwd_in_n = None

        # for done lanes the retry loop never touched their λ, so `lam`
        # equals c.lam there — traj_bwd/lam_used carried unconditionally
        # are exactly the inputs of the backward pass that just ran (the
        # kernel computes every lane each iteration, done or not).
        # fb.echo == c.traj[:, :n+m] bit-exactly (the kernel echoes its
        # input), delivered as a fresh kernel output rather than a carry
        # rotation.
        return _Carry(
            traj=traj_n, bwd_in=bwd_in_n, cost_tot=tot_n,
            lam=jnp.where(active, lam_n, c.lam),
            dlam=jnp.where(active, dlam_n, c.dlam),
            traj_bwd=fb.echo, lam_used=lam,
            done=done, reason=reason,
            accepted=accepted, it=c.it + 1,
            it_lane=jnp.where(active, c.it, c.it_lane),
            g_norm=jnp.where(active, g_norm, c.g_norm), trace=trace)

    c = lax.while_loop(loop_cond, loop_body, carry0)
    reason = jnp.where((c.reason == 0) & (c.accepted > cfg.max_iter),
                       4, c.reason).astype(jnp.int32)

    # ---- replay the final backward outputs in FULL emission, once.
    # (traj_bwd, lam_used) are exactly the inputs of the last backward pass
    # the kernel ran per lane (see the carry comment), so this reproduces
    # the k/K/Vx/Vxx/Σ stream the loop used to carry — at the cost of one
    # kernel launch per solve instead of a 5× larger write stream per
    # iteration. (With max_steps=0 / an all-diverged-at-init fleet the loop
    # never ran; the replay then evaluates the initial state, and reason-5
    # lanes are sanitized below either way.)
    bwd_in_fin = (c.traj_bwd if derivs_tiles is not None
                  else packed_derivs(c.traj_bwd[:, :n],
                                     c.traj_bwd[:, n:n + m]))
    bo_full = run_bwd(bwd_in_fin, c.lam_used, emit="full").out

    # Lanes that diverged at init (reason 5) are done before the first
    # iteration, but their (possibly non-finite) trajectory still feeds
    # the kernels, whose α=0 retrace turns Inf into NaN (K·(Inf−Inf)).
    # Restore a zero-gain UNIT-covariance policy and zero value expansion
    # for them — ONE select outside the loop, so the hot path keeps
    # carrying the streams unmasked. The reference exits with the initial
    # trajectory and no policy in this case (src/iLQG.jl:205-210); the
    # XLA tier returns GaussianPolicy.zeros, whose Σ = Σ⁻¹ = I
    # (policy.py:47-55) — mirror that here so a downstream GPS/KL
    # consumer never sees a singular Σ on a failed lane.
    bad5 = ~any0
    eye_slots = jnp.zeros((bo_full.shape[1],), bo_full.dtype)
    for base in (lay.quui, lay.quu):          # σ and σ⁻¹ slot blocks
        for i in range(m):
            eye_slots = eye_slots.at[base + i * m + i].set(1.0)
    bo5 = eye_slots.reshape((1, -1) + (1,) * (bo_full.ndim - 2))
    bo_full = jnp.where(_bc(bad5, bo_full), bo5, bo_full)
    if not pre_rolled:
        # rollout entry: also restore the frozen initial rollout (a
        # pre-rolled lane instead keeps the user-supplied trajectory
        # verbatim through the in-loop masked select, src/iLQG.jl:193-197)
        c = c._replace(
            traj=jnp.where(_bc(bad5, c.traj), traj_init, c.traj),
            cost_tot=jnp.where(bad5, tot_init, c.cost_tot))

    # ---- unpack to batch-major
    x = from_lanes(c.traj[:, :n], B, (n,))
    u = from_lanes(c.traj[:, n:n + m], B, (m,))
    cost = from_lanes(c.traj[:, n + m:n + m + 1], B, ())
    K = from_lanes(bo_full[:, lay.K:lay.K + m * n], B, (m, n))
    sigma = from_lanes(bo_full[:, lay.quui:lay.quui + m * m], B, (m, m))
    sigma_inv = from_lanes(bo_full[:, lay.quu:lay.quu + m * m], B, (m, m))
    policy = GaussianPolicy(K=K, k=u, sigma=sigma, sigma_inv=sigma_inv)

    return BatchILQGResult(
        x=x, u=u, policy=policy,
        Vx=from_lanes(bo_full[:, lay.Vx:lay.Vx + n], B, (n,)),
        Vxx=from_lanes(bo_full[:, lay.Vxx:lay.Vxx + n * n], B, (n, n)),
        cost=cost,
        cost_total=vec_from_lanes(c.cost_tot, B),
        n_iters=vec_from_lanes(c.it_lane, B),
        n_accepted=vec_from_lanes(c.accepted, B) - 1,
        reason=vec_from_lanes(reason, B),
        lam=vec_from_lanes(c.lam, B),
        dlam=vec_from_lanes(c.dlam, B),
        g_norm=vec_from_lanes(c.g_norm, B),
        trace=(BatchTrace(*[jnp.transpose(f.reshape(cap, -1)[:, :B])
                            for f in c.trace]) if record_trace else None),
    )


def ilqg_iteration_lanes(model: LanesModel,
                         packed_derivs: Optional[Callable],
                         lims, cfg: ILQGConfig,
                         derivs_tiles: Optional[Callable] = None,
                         kt_backward: int = 1,
                         kt_forward: int = 1,
                         interpret: bool = False):
    """Build a jittable single-iteration step function on lane-layout state
    — the per-step hot path of an MPC loop (and of ``bench.py``). Returns
    ``step(traj, cost_tot, lam) -> (traj, cost_tot, lam)`` where ``traj`` is
    the (T, n+m+1, nB) + TILE trajectory stream. ``lims`` may be static
    ``((lo, hi),)*m`` or per-scenario (B, m, 2) (packed once here and
    closed over). The input ``traj`` buffer is DONATED to the fused
    line-search kernel (in-place update) — don't read it after the call
    (re-reading forces XLA to insert a protective full-stream copy)."""
    assert derivs_tiles is not None or packed_derivs is not None
    n, m = model.n, model.m
    lims, lims_batch = split_lims(lims)
    lims_l = (pack_lims(lims_batch, lims_batch.shape[0])
              if lims_batch is not None else None)
    lay = OutLayout(n, m)
    alphas = jnp.asarray(cfg.alphas, jnp.float32)
    A = alphas.shape[0]
    g_sl = lay.K + m * n

    def step(traj, cost_tot, lam):
        L = traj.shape[2:]
        x0_l = traj[0, :n]
        bwd_in = traj if derivs_tiles is not None else packed_derivs(
            traj[:, :n], traj[:, n:n + m])
        # gains-only emission: this step's consumers (the two forward
        # passes) never read Vx/Vxx/Σ, and the kernel is bandwidth-bound
        # on the output stream (see OutLayout)
        res = backward_lanes(bwd_in, lam, n=n, m=m, reg_type=cfg.reg_type,
                             lims=lims, k_t=kt_backward,
                             derivs_tiles=derivs_tiles, lims_lanes=lims_l,
                             emit="gains", interpret=interpret)
        bo = res.out
        dV1, dV2 = res.stats[0], res.stats[1]
        bad = res.stats[2] > 0.5
        # fused line search (per-α totals + in-register accept + accepted-α
        # re-roll in one launch); α=0 on rejected lanes retraces the
        # (kernel-produced) input trajectory bit-exactly — no
        # accept-select on the stream (the caller's traj must come from
        # forward_lanes, as in MPC loops)
        allow = ~bad
        sel = jnp.stack([dV1, dV2, cost_tot, allow.astype(jnp.float32)])
        fb = linesearch_lanes(traj, bo, x0_l, sel, None, lims_l,
                              model=model, alphas=cfg.alphas,
                              reduce_ratio_min=cfg.reduce_ratio_min,
                              lims=lims, gk=lay.k, gK=lay.K, g_slots=g_sl,
                              emit_echo=False, in_place=True,
                              k_t=kt_forward,
                              interpret=interpret)
        accept = (fb.ls[1] > 0.5) & allow
        traj_n = fb.traj
        tot_n = fb.ls[4]
        lam_n = jnp.where(accept, jnp.maximum(lam / cfg.lam_factor, 1e-6),
                          jnp.minimum(lam * cfg.lam_factor, cfg.lam_max))
        return traj_n, tot_n, lam_n

    return step


@functools.partial(
    jax.jit,
    static_argnames=("model", "packed_derivs", "plant", "n_steps", "lims",
                     "cfg", "derivs_tiles", "kt_backward", "kt_forward",
                     "interpret"))
def _mpc_rollout_lanes_jit(model: LanesModel,
                           packed_derivs: Optional[Callable],
                           x0s: jax.Array,
                           u0s: jax.Array,
                           plant: Callable,
                           n_steps: int,
                           lims=None,
                           lims_batch: Optional[jax.Array] = None,
                           cfg: ILQGConfig = ILQGConfig(),
                           derivs_tiles: Optional[Callable] = None,
                           params: Optional[jax.Array] = None,
                           kt_backward: int = 1,
                           kt_forward: int = 1,
                           interpret: bool = False):
    B, _, m = u0s.shape

    def body(carry, _):
        x_, u_ = carry
        res = _ilqg_batch_lanes_jit(
            model, packed_derivs, x_, u_, lims=lims, lims_batch=lims_batch,
            cfg=cfg, derivs_tiles=derivs_tiles, params=params,
            warm_start=True, max_steps=jnp.asarray(cfg.cap() - 1, jnp.int32),
            kt_backward=kt_backward, kt_forward=kt_forward,
            interpret=interpret)
        u_apply = res.u[:, 0]
        x_next = plant(x_, u_apply)
        u_shift = jnp.concatenate(
            [res.u[:, 1:], jnp.zeros((B, 1, m), u0s.dtype)], axis=1)
        return (x_next, u_shift), (x_next, u_apply, res.cost_total)

    (x_f, u_f), (xs, us, costs) = lax.scan(body, (x0s, u0s), None,
                                           length=n_steps)
    return x_f, u_f, xs, us, costs


def mpc_rollout_lanes(model, packed_derivs, x0s, u0s, plant, n_steps,
                      lims=None, cfg: ILQGConfig = ILQGConfig(),
                      derivs_tiles=None, params=None,
                      kt_backward: int = 1, kt_forward: int = 1,
                      interpret: bool = False):
    """On-device receding-horizon MPC rollout: ``n_steps`` chained steps of
    (warm-started bounded iLQG re-solve → apply the plan's first control
    through ``plant`` → shift the plan) inside ONE jitted ``lax.scan``.

    The host-loop equivalent (``demos.demo_mpc``) pays 2-3 dispatches per
    step; this chain pays one per ``n_steps``. Use this for
    latency-critical serving; the per-step warm-start semantics are the
    reference's pre-rolled trajectory entry (``src/iLQG.jl:193-197``).

    Args mirror :func:`ilqg_batch_lanes`, plus:
      plant: ``(x (B, n), u (B, m)) -> x_next (B, n)`` — the TRUE plant
        dynamics the first control of each plan is applied through (may
        differ from ``model``'s prediction dynamics; that mismatch is what
        receding-horizon re-solving absorbs). Must be jittable; static
        under jit, so pass a module-level or otherwise long-lived
        function (a fresh lambda per call recompiles the whole rollout).
      n_steps: number of closed-loop steps (static — one compile per value;
        reuse one chunk size and call repeatedly to cover long horizons).

    Returns ``(x_final (B, n), u_plan_final (B, T, m),
    states (n_steps, B, n), controls (n_steps, B, m),
    cost_totals (n_steps, B))`` — the closed-loop trace, scan-stacked.
    """
    lims, lims_batch = split_lims(lims)
    # the lane tier is f32-only and returns f32 — cast the scan-carry init
    # so f64 inputs don't mismatch the body's f32 carry on trace
    x0s = jnp.asarray(x0s, jnp.float32)
    u0s = jnp.asarray(u0s, jnp.float32)
    return _mpc_rollout_lanes_jit(
        model, packed_derivs, x0s, u0s, plant, int(n_steps), lims=lims,
        lims_batch=lims_batch, cfg=cfg, derivs_tiles=derivs_tiles,
        params=params, kt_backward=kt_backward, kt_forward=kt_forward,
        interpret=interpret)

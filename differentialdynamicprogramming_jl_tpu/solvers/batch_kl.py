"""Batched lane-layout iLQGkl (GPS trust-region) driver — GPU fast path.

Reference ``iLQGkl`` (``src/iLQGkl.jl:25-252``) with the scalar-η bracketing
dual update (``calc_η``, ``src/klutils.jl:110-130``), run for a whole fleet
of scenarios at once in lane layout:

- the backward kernel's GPS mode (η-scaled Q terms + in-register KL
  expansion from the previous-policy stream);
- α=1 forward re-roll (``src/iLQGkl.jl:134``) via the forward kernel;
- Σxx propagation as a plain ``lax.scan`` (:func:`covariance_lanes`);
- the closed-form policy KL (``kl_div_wiki``, ``src/klutils.jl:70-100``)
  evaluated elementwise on lane arrays (no scan — XLA fuses it);
- per-scenario η brackets, divergence retries, satisfaction tests.

Restrictions: f32 (the XLA path ``solvers/ilqgkl.py`` covers f64).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..policy import GaussianPolicy
from ..ops.pallas.pack import to_lanes, from_lanes, vec_from_lanes
from ..ops.pallas.backward_kernel import OutLayout, backward_lanes
from ..ops.pallas.forward_kernel import LanesModel, forward_lanes
from .ilqgkl import ILQGKLConfig


def covariance_lanes(fx: jax.Array, *, n: int,
                     r1: Tuple[Tuple[float, ...], ...]) -> jax.Array:
    """Forward state-covariance propagation on lane streams (reference
    ``forward_covariance``, ``src/forward_pass.jl:37-56``): the discrete
    Lyapunov iteration ``Σxx[0] = R1; Σxx[t+1] = fx[t] Σxx[t] fx[t]ᵀ + R1``
    whose xx block feeds the closed-form policy KL (``src/klutils.jl:77``).

    ``fx``: per-scenario linearizations (T, n², nB) + TILE (row-major);
    ``r1``: static (n, n). Returns the Σxx stream (T, n², nB) + TILE, entry
    t holding Σxx[t]. A plain ``lax.scan`` of elementwise lane arithmetic:
    it runs once per KL solve, before the loop."""
    def step(S_flat, F_flat):
        S = [[S_flat[i * n + j] for j in range(n)] for i in range(n)]
        F = [[F_flat[i * n + j] for j in range(n)] for i in range(n)]
        FS = [[sum(F[i][a] * S[a][b] for a in range(n)) for b in range(n)]
              for i in range(n)]
        S_n = jnp.stack([sum(FS[i][b] * F[j][b] for b in range(n))
                         + float(r1[i][j])
                         for i in range(n) for j in range(n)])
        return S_n, S_flat

    S0 = jnp.stack([jnp.full(fx.shape[2:], float(r1[i][j]), fx.dtype)
                    for i in range(n) for j in range(n)])
    _, sxx = lax.scan(step, S0, fx)
    return sxx


def _logdet_tiles(S, m):
    """log det of an m×m slot stream (T, m², L) — unrolled over m
    (closed-form for m ≤ 2, Cholesky diagonal product above).

    Returns ``(logdet, ok)``: ``ok`` is the per-entry PD flag. Julia's
    ``logdet`` throws a DomainError on an indefinite matrix (the reference's
    ``kl_div_wiki`` hard-fails, ``src/klutils.jl:84``); under jit the clamp
    keeps the arithmetic finite and ``ok`` carries the failure instead —
    callers must propagate it (silent clamping made pathological fleets
    disagree with the XLA tier on ``satisfied``)."""
    if m == 1:
        return jnp.log(jnp.maximum(S[:, 0], 1e-30)), S[:, 0] > 0
    if m == 2:
        det = S[:, 0] * S[:, 3] - S[:, 1] * S[:, 2]
        ok = (S[:, 0] > 0) & (det > 0)        # leading principal minors
        return jnp.log(jnp.maximum(det, 1e-30)), ok
    from ..ops.pallas.backward_kernel import _tiny_chol
    M = [[S[:, i * m + j] for j in range(m)] for i in range(m)]
    L, ok = _tiny_chol(M, m)
    return 2.0 * sum(jnp.log(jnp.maximum(L[j][j], 1e-30))
                     for j in range(m)), ok


def kl_div_wiki_lanes(mu, sxx, k_n, K_n, S_n, k_p, K_p, Si_p,
                      n: int, m: int) -> jax.Array:
    """Per-timestep policy KL on lane streams (``kl_div_wiki``,
    ``src/klutils.jl:70-100``). ``mu = x_new - x_old`` (T, n, L); ``sxx``
    (T, n², L); policies as slot streams; ``Si_p`` = previous Σ⁻¹.
    ``logdet Σp = -logdet Σp⁻¹``. Returns ``(kl, pd_ok)``, each (T, L) —
    ``pd_ok`` flags both covariances PD (see :func:`_logdet_tiles`)."""
    kd = [k_p[:, i] - k_n[:, i] for i in range(m)]
    Kd = [[K_p[:, i * n + j] - K_n[:, i * n + j] for j in range(n)]
          for i in range(m)]
    Sip = [[Si_p[:, i * m + j] for j in range(m)] for i in range(m)]
    Sn = [[S_n[:, i * m + j] for j in range(m)] for i in range(m)]

    tr_term = sum(Sip[i][j] * Sn[j][i] for i in range(m) for j in range(m))
    kk = sum(kd[i] * Sip[i][j] * kd[j] for i in range(m) for j in range(m))
    ld_p, ok_p = _logdet_tiles(Si_p, m)
    ld_n, ok_n = _logdet_tiles(S_n, m)
    ld = -ld_p - ld_n
    kl = 0.5 * (tr_term + kk - float(m) + ld)

    SipKd = [[sum(Sip[i][a] * Kd[a][j] for a in range(m))
              for j in range(n)] for i in range(m)]
    KdSipKd = [[sum(Kd[a][i] * SipKd[a][j] for a in range(m))
                for j in range(n)] for i in range(n)]
    muv = [mu[:, i] for i in range(n)]
    kl = kl + 0.5 * (
        sum(muv[i] * KdSipKd[i][j] * muv[j]
            for i in range(n) for j in range(n))
        + sum(KdSipKd[i][j] * sxx[:, j * n + i]
              for i in range(n) for j in range(n)))
    kl = kl + sum(kd[i] * SipKd[i][j] * muv[j]
                  for i in range(m) for j in range(n))
    return jnp.maximum(kl, 0.0), ok_p & ok_n


def calc_eta_lanes(divergence, bracket, kl_step):
    """Per-scenario dual bracket update (``calc_η``,
    ``src/klutils.jl:110-130``). ``divergence``: (L,) measured KL;
    ``bracket``: (3,) + L; returns (new_bracket, satisfied (L,))."""
    violation = divergence - kl_step
    satisfied = jnp.abs(violation) < 0.1 * kl_step
    too_big = violation < 0
    lo, mid, hi = bracket[0], bracket[1], bracket[2]
    hi_b = mid
    mid_b = jnp.maximum(jnp.sqrt(lo * hi_b), 0.1 * hi_b)
    lo_s = mid
    mid_s = jnp.minimum(jnp.sqrt(lo_s * hi), 10.0 * lo_s)
    new_lo = jnp.where(too_big, lo, lo_s)
    new_mid = jnp.where(too_big, mid_b, mid_s)
    new_hi = jnp.where(too_big, hi_b, hi)
    keep = satisfied
    return (jnp.stack([jnp.where(keep, lo, new_lo),
                       jnp.where(keep, mid, new_mid),
                       jnp.where(keep, hi, new_hi)]), satisfied)


class BatchKLTrace(NamedTuple):
    """Per-iteration fleet record, batch-major (B, cap) — the lane-tier
    equivalent of the reference's iLQGkl trace keys
    (``src/iLQGkl.jl:161-166``: cost, improvement, reduce_ratio,
    divergence, η)."""

    cost: jax.Array
    improvement: jax.Array
    reduce_ratio: jax.Array  # Δcost / -(dV₁+dV₂) (src/iLQGkl.jl:140,164)
    divergence: jax.Array
    eta: jax.Array


class BatchKLResult(NamedTuple):
    """Batch-major iLQGkl results (cf. ``ILQGKLResult``)."""

    x: jax.Array
    u: jax.Array
    policy: GaussianPolicy
    cost: jax.Array          # (B, T) running costs of the final rollout
    cost_total: jax.Array    # (B,)
    eta: jax.Array           # (B,)
    divergence: jax.Array    # (B,) mean KL
    satisfied: jax.Array     # (B,) bool
    kl_violated: jax.Array   # (B,) final warning (src/iLQGkl.jl:248)
    n_iters: jax.Array       # (B,)
    pd_failed: jax.Array = None  # (B,) a Σ went indefinite in the KL
    #                              measurement (Julia logdet DomainError
    #                              analogue); the lane aborted, not satisfied
    # resume state (the η-dual optimizer's internals) — feed back via
    # bracket0/delta0_in/adam0_in to continue the solve as if uninterrupted
    # (the KL-tier fleet scheduler's compaction entry, solvers/fleet.py)
    bracket: jax.Array = None    # (B, 3) scalar-η / (B, 3, T) per-step
    delta: jax.Array = None      # (B,) / (B, T) η-escalation increment
    adam: jax.Array = None       # (B, 2, T) per-step mode; zeros otherwise
    done: jax.Array = None       # (B,) lane terminated (satisfied, η maxed,
    #                              aborted or PD-failed) vs merely hitting
    #                              this call's max_steps chunk bound
    trace: Optional[BatchKLTrace] = None   # with record_trace=True


class _Carry(NamedTuple):
    bracket: jax.Array       # (3,) + L  (scalar-η)  or (3, T) + L (per-step)
    delta: jax.Array         # η-escalation increment
    traj_new: jax.Array      # (T, n+m+1, L)
    tot_new: jax.Array
    eta_used: jax.Array      # η the LAST executed backward ran with (the
    #                          post-retry bracket midpoint): (T,)+L per-step
    #                          or L scalar-mode. The policy stream is NOT
    #                          carried — an inner while-loop's output landing
    #                          in an outer carry position costs a full-stream
    #                          copy every iteration (~492 MB/iter at the GPS
    #                          fleet scale; tools/hlo_copy_audit.py), so the
    #                          final stream is replayed ONCE
    #                          after the loop from this η instead —
    #                          bit-identical inputs, bit-identical stream.
    div: jax.Array           # (L,) mean KL
    satisfied: jax.Array
    pd_bad: jax.Array        # (L,) PD failure latched (see BatchKLResult)
    done: jax.Array
    it: jax.Array
    it_lane: jax.Array
    adam: Optional[jax.Array]  # (2, T) + L ADAM state (per-step mode)
    trace: Optional[BatchKLTrace]


def ilqgkl_batch_lanes(model: LanesModel,
                       derivs_tiles: Callable,
                       x0s: jax.Array,
                       traj_prev: GaussianPolicy,
                       fx_model: jax.Array,
                       cost0: jax.Array,
                       lims: Optional[Tuple] = None,
                       cfg: ILQGKLConfig = ILQGKLConfig(),
                       r1: Optional[Tuple] = None,
                       kt: int = 1,
                       record_trace: bool = False,
                       interpret: bool = False) -> BatchKLResult:
    """Public entry — see :func:`_ilqgkl_batch_lanes_jit`. Sorts ``lims``
    into the static tuple / per-scenario (B, m, 2) traced input
    (:func:`~.batch.split_lims`) and fills the traced loop bound outside
    the jit boundary (fleet-scheduler chunks and plain solves with the same
    cfg share one compiled program)."""
    from .batch import split_lims
    lims, lims_batch = split_lims(lims)
    return _ilqgkl_batch_lanes_jit(model, derivs_tiles, x0s, traj_prev,
                                   fx_model, cost0, lims=lims,
                                   lims_batch=lims_batch, cfg=cfg, r1=r1,
                                   kt=kt,
                                   max_steps=jnp.int32(cfg.max_iter),
                                   it0=jnp.zeros((), jnp.int32),
                                   record_trace=record_trace,
                                   interpret=interpret)


@functools.partial(
    jax.jit,
    static_argnames=("model", "derivs_tiles", "lims", "cfg", "r1",
                     "kt", "record_trace", "interpret"))
def _ilqgkl_batch_lanes_jit(model: LanesModel,
                       derivs_tiles: Callable,
                       x0s: jax.Array,
                       traj_prev: GaussianPolicy,
                       fx_model: jax.Array,
                       cost0: jax.Array,
                       lims: Optional[Tuple] = None,
                       lims_batch: Optional[jax.Array] = None,
                       cfg: ILQGKLConfig = ILQGKLConfig(),
                       r1: Optional[Tuple] = None,
                       kt: int = 1,
                       bracket0: Optional[jax.Array] = None,
                       delta0_in: Optional[jax.Array] = None,
                       adam0_in: Optional[jax.Array] = None,
                       it0: Optional[jax.Array] = None,
                       max_steps: Optional[jax.Array] = None,
                       record_trace: bool = False,
                       interpret: bool = False) -> BatchKLResult:
    """KL-constrained solve for B scenarios. ``cfg.constrain_per_step``
    selects the per-timestep-η variant (duals updated by ADAM in log space,
    reference ``src/iLQGkl.jl:185-236``); otherwise the scalar-η bracketing
    branch (``src/iLQGkl.jl:93-181``).

    Resume entry (the KL-tier fleet scheduler, :mod:`.fleet`):
    ``bracket0`` (B, 3) / (B, 3, T), ``delta0_in`` (B,) / (B, T) and
    ``adam0_in`` (B, 2, T) restore the η-dual optimizer's state from a
    prior :class:`BatchKLResult`; ``it0`` (traced scalar) is the global
    iteration count already executed (lock-step lanes advance together, so
    all unfinished lanes share it — it also keeps the per-step ADAM's bias
    correction ``t`` consistent); ``max_steps`` (traced scalar) bounds this
    call's loop trips without changing the compiled program. The
    composition of chunked calls is semantically ONE uninterrupted solve
    per scenario (bit-identical: the η updates are elementwise per lane).

    - ``x0s``: pre-rolled trajectories (B, T, n) (mandatory, as in the
      reference ``src/iLQGkl.jl:65-72``); nominal controls = traj_prev.k.
    - ``traj_prev``: previous policy, leaves (B, T, ...).
    - ``fx_model``: model linearizations (B, T, n, n) for the covariance
      propagation; ``r1``: static (n, n) tuple (default identity).
    - ``cost0``: (B,) total cost of the pre-rolled trajectory.

    Per-iteration introspection: as on :func:`~.batch.ilqg_batch_lanes`,
    the sanctioned per-fleet-element record is ``record_trace=True``
    (:class:`BatchKLTrace`, (B, cap) arrays); the reference's per-iteration
    ``plot_fun`` host hook (``src/iLQGkl.jl:177``) exists on the XLA tier
    as ``iter_callback`` (:func:`~.ilqgkl.ilqg_kl`).
    """
    n, m = model.n, model.m
    B, T = x0s.shape[0], x0s.shape[1]
    f32 = jnp.float32
    # "policy" emission: this loop consumes k/K (forward pass) and
    # Quu/Quu⁻¹ (measured KL + returned policy) but never Vx/Vxx — skipping
    # their n + n² slots cuts the bandwidth-bound backward output stream
    # ~4.7× at LTI size (n=10, m=2), on every η-retry relaunch too.
    lay = OutLayout(n, m, emit="policy")
    if r1 is None:
        r1 = tuple(tuple(1.0 if i == j else 0.0 for j in range(n))
                   for i in range(n))

    u0 = traj_prev.k.astype(f32)                      # src/iLQGkl.jl:47
    traj = to_lanes(jnp.concatenate(
        [x0s.astype(f32), u0,
         jnp.zeros((B, T, 1), f32)], axis=-1), B)     # cost slot unused
    L = traj.shape[2:]
    x0_l = traj[0, :n]

    # prev-policy stream with k zeroed for the KL bookkeeping
    # (src/iLQGkl.jl:51-52)
    prev = to_lanes(jnp.concatenate(
        [jnp.zeros((B, T, m), f32),
         traj_prev.K.astype(f32).reshape(B, T, -1),
         traj_prev.sigma_inv.astype(f32).reshape(B, T, -1)], axis=-1), B)
    k_p = prev[:, :m]
    K_p = prev[:, m:m + m * n]
    Si_p = prev[:, m + m * n:]
    fx_l = to_lanes(fx_model.astype(f32).reshape(B, T, -1), B)
    sxx = covariance_lanes(fx_l, n=n, r1=r1)

    kl_step = jnp.asarray(cfg.kl_step, f32)
    per_step = bool(cfg.constrain_per_step)

    def _slot_lanes(a):
        """(B, s, T) batch-major resume leaf → (s, T) + L lane layout."""
        return jnp.swapaxes(
            to_lanes(jnp.moveaxis(a.astype(f32), 1, 2), B), 0, 1)

    if per_step:
        br0 = (_slot_lanes(bracket0) if bracket0 is not None
               else jnp.stack([jnp.full((T,) + L, v, f32)
                               for v in cfg.eta_bracket]))
        # per-step escalation increments RESET each outer iteration
        # (src/iLQGkl.jl:189), so a resumed chunk starts from del0 like
        # every lock-step iteration does — delta0_in is ignored here
        delta0 = jnp.full((T,) + L, cfg.del0, f32)
        adam0 = (_slot_lanes(adam0_in) if adam0_in is not None
                 else jnp.zeros((2, T) + L, f32))
    else:
        from ..ops.pallas.pack import vec_to_lanes
        br0 = (jnp.stack([vec_to_lanes(bracket0.astype(f32)[:, i])
                          for i in range(3)])
               if bracket0 is not None
               else jnp.stack([jnp.full(L, v, f32)
                               for v in cfg.eta_bracket]))
        delta0 = (vec_to_lanes(delta0_in.astype(f32))
                  if delta0_in is not None
                  else jnp.full(L, cfg.del0, f32))
        adam0 = None
    tot0 = to_lanes(cost0.astype(f32)[:, None, None], B)[0, 0]
    one_l = jnp.ones((1,) + L, f32)

    from .batch import pack_lims
    lims_l = pack_lims(lims_batch, B) if lims_batch is not None else None

    def run_bwd(eta_mid):
        if per_step:
            eta_s = eta_mid[:, None]                    # (T, 1) + L
        else:
            eta_s = jnp.broadcast_to(eta_mid[None, None], (T, 1) + L)
        return backward_lanes(traj, jnp.zeros(L, f32), n=n, m=m,
                              reg_type=1, lims=lims, k_t=kt,
                              derivs_tiles=derivs_tiles,
                              prev=prev, eta=eta_s, lims_lanes=lims_l,
                              emit="policy",
                              interpret=interpret)

    cap = cfg.max_iter + 1
    if record_trace:
        tz = jnp.zeros((cap,) + L, f32)
        trace0 = BatchKLTrace(cost=tz.at[0].set(tot0), improvement=tz,
                              reduce_ratio=tz, divergence=tz, eta=tz)
    else:
        trace0 = None

    it0_s = (jnp.zeros((), jnp.int32) if it0 is None
             else jnp.asarray(it0, jnp.int32))
    cap_rt = jnp.minimum(
        it0_s + (jnp.asarray(max_steps, jnp.int32)
                 if max_steps is not None else cfg.max_iter),
        cfg.max_iter)

    carry0 = _Carry(
        bracket=br0, delta=delta0,
        traj_new=traj, tot_new=tot0,
        eta_used=br0[1],
        div=jnp.zeros(L, f32),
        satisfied=jnp.zeros(L, bool),
        pd_bad=jnp.zeros(L, bool),
        done=jnp.zeros(L, bool),
        it=it0_s + 1, it_lane=jnp.zeros(L, jnp.int32),
        adam=adam0, trace=trace0)

    def loop_cond(c: _Carry):
        return (~jnp.all(c.done)) & (c.it <= cap_rt)

    def loop_body(c: _Carry) -> _Carry:
        active = ~c.done

        # η-inflation backward retry (src/iLQGkl.jl:97-124 scalar;
        # :190-203 per-step — escalate only the diverged timestep, and the
        # escalation increments reset each outer iteration, :189)
        delta_in = delta0 if per_step else c.delta
        res0 = run_bwd(c.bracket[1])

        def rcond(s):
            res_, br_, dl_, k_, ab_ = s
            div_ = res_.stats[2] > 0.5
            return jnp.any(active & div_ & (~ab_)) & (k_ < cfg.retry_cap)

        def rbody(s):
            res_, br_, dl_, k_, ab_ = s
            bad = (res_.stats[2] > 0.5) & active & (~ab_)
            if per_step:
                idx = jnp.clip(res_.stats[3].astype(jnp.int32) - 1, 0, T - 1)
                hot = (jnp.arange(T).reshape((T,) + (1,) * len(L))
                       == idx[None]) & bad[None]
                mid = jnp.where(hot, br_[1] + dl_, br_[1])
                dl_n = jnp.where(hot, dl_ * 2.0, dl_)
                ab_n = ab_ | (bad & jnp.all(mid > 0.999 * br_[2], axis=0))
            else:
                mid = jnp.where(bad, br_[1] + dl_, br_[1])
                dl_n = jnp.where(bad, dl_ * 2.0, dl_)
                ab_n = ab_ | (bad & (mid > br_[2]))
            br_n = br_.at[1].set(mid)
            return (run_bwd(mid), br_n, dl_n, k_ + 1, ab_n)

        res, br, delta, _k, bp_ab = lax.while_loop(
            rcond, rbody,
            (res0, c.bracket, delta_in, jnp.zeros((), jnp.int32),
             jnp.zeros(L, bool)))
        bo = res.out

        # full-step forward pass (α = 1, src/iLQGkl.jl:134)
        fb = forward_lanes(traj, bo, x0_l, one_l, None, lims_l,
                           model=model, lims=lims,
                           gk=lay.k, gK=lay.K, g_slots=lay.K + m * n,
                           emit_traj=True, k_t=kt, interpret=interpret)

        # measured KL (src/iLQGkl.jl:143) — new policy from the backward out
        mu = fb.traj[:, :n] - traj[:, :n]
        div_t, pdok_t = kl_div_wiki_lanes(
            mu, sxx, bo[:, lay.k:lay.k + m], bo[:, lay.K:lay.K + m * n],
            bo[:, lay.quui:lay.quui + m * m], k_p, K_p, Si_p, n, m)
        div = jnp.mean(div_t, axis=0)
        # an indefinite Σ anywhere along the horizon = the reference's
        # logdet DomainError (src/klutils.jl:84): abort the lane with a
        # diagnostic instead of silently trusting the clamped logdet
        pd_bad_now = active & (~jnp.all(pdok_t, axis=0))
        # reference reduce_ratio at α=1: Δcost / -(dV₁+dV₂), with Δcost
        # measured against the FIXED pre-rolled cost — the reference never
        # moves x/u/cost inside its loop (src/iLQGkl.jl:137-140,239-240),
        # so every iteration compares to the trust-region center, exactly
        # as the XLA tier's `sum(cost0) - sum(ro.cost)` does
        dcost = tot0 - fb.totals[0]
        expected = -(res.stats[0] + res.stats[1])
        ratio = jnp.where(expected != 0, dcost / expected, 0.0)

        if per_step:
            # ADAM on log η against the per-timestep constraint violation
            # (src/iLQGkl.jl:211-218, klutils.jl:203-210)
            violation = div_t - kl_step                # (T,) + L
            b1, b2, eps = 0.9, 0.999, 1e-8
            g = -violation
            m_a = b1 * c.adam[0] + (1 - b1) * g
            v_a = b2 * c.adam[1] + (1 - b2) * g * g
            t_f = c.it.astype(f32)
            m_hat = m_a / (1 - b1 ** t_f)
            v_hat = v_a / (1 - b2 ** t_f)
            log_eta = (jnp.log(jnp.maximum(br[1], 1e-30))
                       - cfg.gd_alpha * m_hat / (jnp.sqrt(v_hat) + eps))
            eta_new = jnp.clip(jnp.exp(log_eta), br[0], br[2])
            br_n = br.at[1].set(eta_new)
            adam_n = jnp.stack([m_a, v_a])
            satisfied = (jnp.all(div_t < 2.0 * kl_step, axis=0)
                         & (jnp.mean(violation, axis=0)
                            < 0.1 * float(cfg.kl_step)))
            eta_maxed = jnp.all(br_n[1] > 0.999 * br_n[2], axis=0)
        else:
            br_n, satisfied = calc_eta_lanes(div, br, kl_step)
            adam_n = c.adam
            eta_maxed = br_n[1] > 0.999 * br_n[2]     # src/iLQGkl.jl:178
        satisfied = satisfied & (~pd_bad_now)
        newly_done = active & (satisfied | eta_maxed | bp_ab | pd_bad_now)

        upd = active
        bc = lambda msk, a: msk.reshape((1,) * (a.ndim - msk.ndim)
                                        + msk.shape)
        # no masked selects on the trajectory stream: the nominal
        # trajectory and done lanes' η bracket are frozen, so the kernels
        # recompute bit-identical fb.traj/bo for them every iteration
        # (same HBM-traffic argument as solvers/batch.py)
        traj_new = fb.traj
        tot_new = fb.totals[0]
        br_mask = bc(upd, br_n)

        eta_mid = jnp.mean(br_n[1], axis=0) if per_step else br_n[1]
        if record_trace:
            ti = jnp.minimum(c.it, cap - 1)
            trace = BatchKLTrace(
                cost=c.trace.cost.at[ti].set(tot_new),
                improvement=c.trace.improvement.at[ti].set(dcost),
                reduce_ratio=c.trace.reduce_ratio.at[ti].set(ratio),
                divergence=c.trace.divergence.at[ti].set(
                    jnp.where(upd, div, c.div)),
                eta=c.trace.eta.at[ti].set(eta_mid))
        else:
            trace = None

        if cfg.verbosity > 1:
            from ..utils import printing as _pr
            n_act = jnp.sum(active.astype(jnp.int32))
            den = jnp.maximum(n_act, 1).astype(f32)
            _pr.kl_lanes_row(
                c.it, n_act,
                jnp.sum(jnp.where(active, tot_new, 0.0)) / den,
                jnp.sum(jnp.where(active, eta_mid, 0.0)) / den,
                jnp.sum(jnp.where(active, div, 0.0)) / den,
                jnp.sum((satisfied & active).astype(f32)) / den,
                cfg.print_head)

        return _Carry(
            bracket=jnp.where(br_mask, br_n, c.bracket),
            delta=jnp.where(bc(upd, delta), delta, c.delta),
            traj_new=traj_new, tot_new=tot_new,
            # post-retry midpoint: for done lanes the retry never touched
            # their η (masked by `active`), so this equals their frozen
            # c.bracket[1] — exactly the η every lane's backward just used
            eta_used=br[1],
            div=jnp.where(upd, div, c.div),
            satisfied=jnp.where(upd, satisfied, c.satisfied),
            pd_bad=c.pd_bad | pd_bad_now,
            done=c.done | newly_done,
            it=c.it + 1,
            it_lane=jnp.where(active, c.it, c.it_lane),
            adam=(jnp.where(bc(upd, adam_n), adam_n, c.adam)
                  if per_step else None),
            trace=trace)

    c = lax.while_loop(loop_cond, loop_body, carry0)

    # unconditional acceptance of the last iterate (src/iLQGkl.jl:239-241)
    x = from_lanes(c.traj_new[:, :n], B, (n,))
    u = from_lanes(c.traj_new[:, n:n + m], B, (m,))
    cost = from_lanes(c.traj_new[:, n + m:n + m + 1], B, ())
    # replay the final backward once from the carried η — bit-identical to
    # the stream the loop's last kernel call produced (emission-mode
    # pattern, solvers/batch.py; one extra launch per solve)
    bo_fin = run_bwd(c.eta_used).out
    policy = GaussianPolicy(
        K=from_lanes(bo_fin[:, lay.K:lay.K + m * n], B, (m, n)),
        k=u,
        sigma=from_lanes(bo_fin[:, lay.quui:lay.quui + m * m], B, (m, m)),
        sigma_inv=from_lanes(bo_fin[:, lay.quu:lay.quu + m * m], B, (m, m)))
    div = vec_from_lanes(c.div, B)
    kl_violated = (div > float(cfg.kl_step)) & (
        jnp.abs(div - float(cfg.kl_step)) > 0.1 * float(cfg.kl_step))
    eta_fin = (jnp.mean(c.bracket[1], axis=0) if per_step
               else c.bracket[1])

    def _slot_major(a):
        """(s, T) + L or (s,) + L lane leaf → (B, s[, T]) batch-major."""
        s = a.shape[0]
        return jnp.moveaxis(a.reshape((s, -1) if a.ndim == 4
                                      else (s, T, -1))[..., :B], -1, 0)

    if per_step:
        bracket_bm = _slot_major(c.bracket)          # (B, 3, T)
        delta_bm = _slot_major(c.delta[None])[:, 0]  # (B, T)
        adam_bm = _slot_major(c.adam)                # (B, 2, T)
    else:
        bracket_bm = _slot_major(c.bracket)          # (B, 3)
        delta_bm = vec_from_lanes(c.delta, B)        # (B,)
        adam_bm = jnp.zeros((B,), jnp.float32)
    return BatchKLResult(
        x=x, u=u, policy=policy, cost=cost,
        cost_total=vec_from_lanes(c.tot_new, B),
        eta=vec_from_lanes(eta_fin, B),
        divergence=div,
        satisfied=vec_from_lanes(c.satisfied, B),
        kl_violated=kl_violated,
        n_iters=vec_from_lanes(c.it_lane, B),
        pd_failed=vec_from_lanes(c.pd_bad, B),
        bracket=bracket_bm, delta=delta_bm, adam=adam_bm,
        done=vec_from_lanes(c.done, B),
        trace=(BatchKLTrace(*[jnp.transpose(f.reshape(cap, -1)[:, :B])
                              for f in c.trace]) if record_trace else None))


@functools.partial(
    jax.jit,
    static_argnames=("model", "derivs_tiles", "fx_fn", "outer_iters",
                     "lims", "cfg", "r1", "kt", "unroll", "interpret"))
def _gps_rollout_lanes_jit(model: LanesModel,
                           derivs_tiles: Callable,
                           x0s: jax.Array,
                           traj0: GaussianPolicy,
                           cost0: jax.Array,
                           fx_fn: Callable,
                           outer_iters: int,
                           lims=None,
                           lims_batch: Optional[jax.Array] = None,
                           cfg: ILQGKLConfig = ILQGKLConfig(),
                           r1: Optional[Tuple] = None,
                           kt: int = 1,
                           unroll: int = 1,
                           interpret: bool = False):
    def body(carry, _):
        x_, traj_, cost_ = carry
        fx = fx_fn(x_, traj_.k)
        res = _ilqgkl_batch_lanes_jit(
            model, derivs_tiles, x_, traj_, fx, cost_, lims=lims,
            lims_batch=lims_batch, cfg=cfg, r1=r1, kt=kt,
            max_steps=jnp.int32(cfg.max_iter),
            it0=jnp.zeros((), jnp.int32), interpret=interpret)
        ys = (res.cost_total, res.eta, res.divergence, res.satisfied,
              res.kl_violated)
        return (res.x, res.policy, res.cost_total), ys

    (x_f, traj_f, cost_f), ys = lax.scan(body, (x0s, traj0, cost0), None,
                                         length=outer_iters,
                                         unroll=unroll)
    return x_f, traj_f, ys


def gps_rollout_lanes(model, derivs_tiles, x0s, traj0, cost0, fx_fn,
                      outer_iters, lims=None, cfg: ILQGKLConfig = ILQGKLConfig(),
                      r1=None, kt: int = 1, unroll: Optional[int] = None,
                      interpret: bool = False):
    """GPS-style policy-improvement loop ON DEVICE: ``outer_iters`` chained
    iLQGkl trust-region solves, each re-centered on the previous result
    (``x ← res.x``, ``traj_prev ← res.policy``, ``cost ← res.cost_total``)
    — the reference's canonical 5× outer-loop usage pattern
    (``src/demo_linear.jl:124-130``) as ONE jitted ``lax.scan``, one
    dispatch for the whole policy-improvement run instead of one per outer
    iteration (cf. :func:`~.batch.mpc_rollout_lanes`).

    Args mirror :func:`ilqgkl_batch_lanes`, except the model-dynamics
    stream is recomputed per outer iteration:
      fx_fn: ``(x (B, T, n), u (B, T, m)) -> fx (B, T, n, n)`` — the
        covariance-propagation dynamics along the CURRENT rollout (the
        reference passes a fitted ``model`` per outer call,
        ``src/demo_linear.jl:118``; for an LTI model return broadcast
        constants). Static under jit: pass a long-lived function.
      outer_iters: number of policy-improvement iterations (static).

    Returns ``(x_final (B, T, n), policy_final (batched GaussianPolicy),
    per_outer)`` where ``per_outer`` is the scan-stacked
    ``(cost_total, eta, divergence, satisfied, kl_violated)`` —
    each ``(outer_iters, B)`` — for convergence monitoring.

    ``unroll`` (default: full unroll for ``outer_iters ≤ 8``, else scan):
    a rolled ``lax.scan`` pins the (B, T, n) trajectory and policy carries
    to fixed buffers, costing materializing copies per outer iteration
    (the while-loop buffer rule, CLAUDE.md); unrolled and rolled are
    bit-identical. Compile time scales with the unroll factor — use the
    scan default for large ``outer_iters``.
    """
    from .batch import split_lims
    lims, lims_batch = split_lims(lims)
    if unroll is None:
        unroll = int(outer_iters) if int(outer_iters) <= 8 else 1
    # the lane tier is f32-only and ilqgkl_batch_lanes RETURNS f32 even
    # for f64 inputs — cast the scan-carry init up front, or the first
    # body iteration's f32 carry mismatches an f64 init and lax.scan
    # raises on trace (the host loop this replaces casts implicitly)
    f32 = jnp.float32
    x0s = jnp.asarray(x0s, f32)
    cost0 = jnp.asarray(cost0, f32)
    traj0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f32), traj0)
    return _gps_rollout_lanes_jit(model, derivs_tiles, x0s, traj0, cost0,
                                  fx_fn, int(outer_iters), lims=lims,
                                  lims_batch=lims_batch, cfg=cfg, r1=r1,
                                  kt=kt, unroll=int(unroll),
                                  interpret=interpret)

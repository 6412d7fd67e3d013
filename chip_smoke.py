"""Smoke run of the fleet solver's main path on a CUDA GPU.

    python chip_smoke.py           # every phase, one card, one process
    python chip_smoke.py --four    # the four-card phase only (4 visible cards)
    python chip_smoke.py --sweep   # lane tile width x num_warps sweep

Phases (one card): the environment; parity of each compiled lane kernel with
the XLA reference at B=4096, T=500; a lane solve against the f64 XLA tier;
kernel and end-to-end timings against the XLA tier; the public lane entries
at their real sizes with their quality gates; an AOT export round trip; the
functions behind the tests marked ``gpu``. Each phase prints its result and
wall time. The last line is one JSON object, printed only when every phase
passed; without a GPU the script exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

B, T = 4096, 500


def card_line() -> str:
    """``nvidia-smi`` name and power limit of the visible cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(out.stdout.strip().splitlines()) or "nvidia-smi: none"


def wall(fn, *args, reps: int = 10):
    """Median wall time (s) of ``fn(*args)`` to completion, after two warm
    calls (the first compiles)."""
    import jax
    for _ in range(2):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def compare(name, got, ref, rtol, atol, ref64=None, xla32=None):
    """assert_allclose-style check of ``got`` against ``ref``; prints the
    worst absolute error and the worst error in units of the tolerance
    (<= 1 passes), plus the errors of the lane result and of the f32 XLA
    result against the f64 reference where given."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    ratio = float(np.max(err / (atol + rtol * np.abs(ref)))) if err.size \
        else 0.0
    line = (f"    {name:<28} max|err| {float(np.max(err)):.3e}  "
            f"err/tol {ratio:.3f}  (rtol {rtol:g}, atol {atol:g})")
    if ref64 is not None:
        r64 = np.asarray(ref64, np.float64)
        line += f"  lane-f64 {float(np.max(np.abs(got - r64))):.3e}"
        if xla32 is not None:
            x32 = np.asarray(xla32, np.float64)
            line += f"  xla32-f64 {float(np.max(np.abs(x32 - r64))):.3e}"
    print(line, flush=True)
    if not np.all(np.isfinite(got)) or ratio > 1.0:
        raise AssertionError(f"{name}: err/tol {ratio:.3f} > 1")


# ---------------------------------------------------------------------------
# problem set-up shared by the phases
# ---------------------------------------------------------------------------

def pendcart_rollout(B_, T_, seed=0):
    """A pendcart fleet rolled out from noisy controls, with its Euler
    derivatives — the same derivatives feed the kernel and the reference."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, make_pendcart_problem, default_x0)
    from differentialdynamicprogramming_jl_tpu.ops.forward import forward_pass
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs="euler", dtype=jnp.float32)
    lims = jnp.array([[-5.0, 5.0]], jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x0s = default_x0(jnp.float32)[None, :] + (
        0.2 * jax.random.normal(k1, (B_, 4), jnp.float32)
        * jnp.array([1, 0, 0, 0], jnp.float32))
    u0s = 0.4 * jax.random.normal(k2, (B_, T_, 1), jnp.float32)
    ro = jax.jit(jax.vmap(lambda a, b: forward_pass(prob, a, b, lims=lims)))(
        x0s, u0s)
    d = jax.jit(jax.vmap(prob.make_derivs()))(ro.x, ro.u)
    return spec, prob, lims, x0s, ro, d


@functools.lru_cache(maxsize=1)
def _pendcart_derivs():
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, make_pendcart_problem)
    prob = make_pendcart_problem(PendCartSpec(), derivs="euler",
                                 dtype=jnp.float32)
    return jax.vmap(prob.make_derivs())


def pendcart_fx(x, u):
    """Pendcart linearizations fx (B, T, 4, 4) along a fleet's rollout —
    the GPS loop's covariance-propagation model (a module-level function,
    so the jitted loop compiles once)."""
    return _pendcart_derivs()(x, u).fx


def backward_ref(d, u, lam, lims, reg_type, use_limits, eta=None,
                 prev=None):
    """The vmapped XLA backward pass (``precision=HIGHEST``), in the dtype of
    its inputs."""
    import jax
    from differentialdynamicprogramming_jl_tpu.ops.backward import (
        backward_pass)
    from differentialdynamicprogramming_jl_tpu.ops.kl import grad_kl
    if prev is None:
        fn = jax.vmap(lambda dd, uu, ll: backward_pass(
            dd, uu, lam=ll, reg_type=reg_type, lims=lims,
            use_limits=use_limits))
        return jax.jit(fn)(d, u, lam)
    fn = jax.vmap(lambda dd, uu, pv, et: backward_pass(
        dd, uu, lam=0.0, reg_type=1, lims=lims, use_limits=use_limits,
        eta=et, kl_terms=grad_kl(pv), gps_mode=True))
    return jax.jit(fn)(d, u, prev, eta)


def to64(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype.kind == "f" else a, tree)


BACKWARD_FIELDS = (("k", lambda r: r.policy.k), ("K", lambda r: r.policy.K),
                   ("dV", lambda r: r.dV))


def check_backward(label, out, ref, ref64, tol):
    for field, get in BACKWARD_FIELDS:
        compare(f"{label} {field}", get(out), get(ref), tol, tol,
                ref64=get(ref64), xla32=get(ref))
    same = np.asarray(out.diverged) == np.asarray(ref.diverged)
    print(f"    {label} diverged flags: {int(np.sum(~same))} of "
          f"{same.size} differ", flush=True)
    if not np.all(same):
        raise AssertionError(f"{label}: divergence flags differ")


def off_f64(res, ref64, tol):
    """Per scenario: does ``res`` leave the f64 reference beyond ``tol``
    (relative and absolute) in k, K or dV, or differ in its divergence
    flag?"""
    off = np.asarray(res.diverged) != np.asarray(ref64.diverged)
    for _, get in BACKWARD_FIELDS:
        a = np.asarray(get(res), np.float64)
        r = np.asarray(get(ref64), np.float64)
        e = np.abs(a - r) > tol * (1.0 + np.abs(r))
        off |= e.reshape(e.shape[0], -1).any(axis=1)
    return off


def check_backward_vs_f64(label, out, ref, ref64, tol):
    """For inputs on which f32 itself is not enough: count the scenarios
    where the kernel and the f32 XLA reference each leave the f64
    reference. The kernel passes when it leaves it on no more scenarios
    than the f32 XLA reference does."""
    lane, xla = off_f64(out, ref64, tol), off_f64(ref, ref64, tol)
    for field, get in BACKWARD_FIELDS:
        r64 = np.asarray(get(ref64), np.float64)
        ok = ~(lane | xla)
        if not ok.any():
            continue
        e_l = np.abs(np.asarray(get(out), np.float64) - r64)[ok]
        e_x = np.abs(np.asarray(get(ref), np.float64) - r64)[ok]
        print(f"    {label} {field:<3} on the {int(ok.sum())} scenarios both "
              f"f32 results keep: max|lane-f64| {float(e_l.max()):.3e}  "
              f"max|xla32-f64| {float(e_x.max()):.3e}", flush=True)
    print(f"    {label}: off the f64 reference (tol {tol:g}) on "
          f"{int(lane.sum())} scenarios (lane) and {int(xla.sum())} (f32 XLA) of {lane.size}; "
          f"both on {int((lane & xla).sum())}", flush=True)
    if lane.sum() > xla.sum():
        raise AssertionError(f"{label}: the kernel leaves the f64 reference "
                             f"more often than the f32 XLA reference")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_solver_parity(card, Bs=256):
    """Solver level: a lane pendcart solve of B=4096 scenarios from zero
    controls, 20-iteration budget, against the f64 XLA tier on its first
    ``Bs`` scenarios. The stop rule's cost tolerance is 0.1, above the f32
    floor of 8·eps·|cost| ≈ 0.02 at these costs, so both precisions stop by
    the same rule. Gates: the converged scenarios (reasons 1, 2) agree in
    total cost within 1e-3 relative, and the exit reasons agree except on at
    most 1 % of scenarios, each of which ended at the same cost within 1e-3
    (a cost change that straddles the tolerance in one precision only).
    Scenarios still descending at the budget (reason 4) are on different
    paths in f32 and f64; their difference is printed."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        make_pendcart_problem, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
        ilqg_batched)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)
    spec, _, lims, x0s, _, _ = pendcart_rollout(B, T)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=20, iter_cap=24, tol_fun=0.1)
    r = ilqg_batch_lanes(pendcart_lanes(spec), None, x0s,
                         jnp.zeros((B, T, 1), jnp.float32),
                         lims=((-5.0, 5.0),), cfg=cfg,
                         derivs_tiles=pendcart_derivs_tiles(spec))
    c32 = np.asarray(r.cost_total, np.float64)[:Bs]
    why32 = np.asarray(r.reason)[:Bs]
    with jax.enable_x64(True):
        f64 = jnp.float64
        prob = make_pendcart_problem(spec, derivs="euler", dtype=f64)
        ref = jax.jit(lambda a, b: ilqg_batched(
            prob, a, b, lims=jnp.asarray(lims, f64), cfg=cfg))(
                jnp.asarray(x0s[:Bs], f64), jnp.zeros((Bs, T, 1), f64))
        c64 = np.asarray(jnp.sum(ref.cost, -1))
        why64 = np.asarray(ref.reason)
    rel = np.abs(c32 - c64) / np.abs(c64)
    conv = (why64 == 1) | (why64 == 2)
    differ = int(np.sum(why32 != why64))
    worst_open = float(rel[~conv].max()) if (~conv).any() else 0.0
    print(f"    lane f32 vs XLA f64, {Bs} of {B} scenarios: exit reasons "
          f"differ on {differ}; {int(conv.sum())} converged, relative cost "
          f"difference max {float(rel[conv].max()):.3e}; "
          f"{int((~conv).sum())} at the budget, max {worst_open:.3e}",
          flush=True)
    it32 = np.asarray(r.n_iters)[:Bs]
    it64 = np.asarray(ref.n_iters)
    for i in np.flatnonzero(why32 != why64)[:8]:
        print(f"      scenario {i}: reason {why32[i]} after {it32[i]} "
              f"iterations (f32) vs {why64[i]} after {it64[i]} (f64), "
              f"relative cost difference {rel[i]:.2e}", flush=True)
    # an exit that differs is a stop-rule threshold flip only when both
    # solves ended at the same cost
    flips = why32 != why64
    assert differ <= Bs // 100 and np.all(rel[flips] <= 1e-3), \
        "exit reasons differ from the f64 XLA tier"
    assert rel[conv].max() <= 1e-3, "converged costs differ from f64"
    return (f"{differ} exit reasons differ, converged costs within "
            f"{float(rel[conv].max()):.1e}")


def phase_environment(card):
    import jax
    dev = jax.devices()[0]
    print(f"    jax {jax.__version__}, backend {jax.default_backend()}, "
          f"device_kind {dev.device_kind}, {len(jax.devices())} device(s)")
    print(f"    card: {card}")
    if jax.default_backend() != "gpu":
        raise RuntimeError(f"backend is {jax.default_backend()}, not gpu")
    return dev.device_kind


def phase_parity(card):
    """Each compiled lane kernel against the repo's plain reference at
    B=4096, T=500: backward (pendcart m=1 ±5; quadrotor m=2 with autodiff
    tiles; pendcart GPS mode), forward rollout and fused line search."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_lanes)
    from differentialdynamicprogramming_jl_tpu.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes, make_quadrotor_problem)
    from differentialdynamicprogramming_jl_tpu.ops.forward import (
        forward_pass, line_search)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import OutLayout, backward_lanes, backward_pass_pallas
    from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel \
        import forward_lanes, linesearch_lanes
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
        to_lanes, from_lanes, vec_to_lanes, vec_from_lanes)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        default_alphas)

    # backward: the interpret-mode tests' tolerance (tests/
    # test_pallas_kernels.py _cmp)
    tol_bwd = 3e-4
    spec, prob, lims, x0s, ro, d = pendcart_rollout(B, T)
    lam = jnp.ones((B,), jnp.float32)
    out = backward_pass_pallas(d, ro.u, lam, reg_type=2, lims=np.asarray(lims),
                               use_limits=True)
    ref = backward_ref(d, ro.u, lam, lims, 2, True)
    with jax.enable_x64(True):
        ref64 = backward_ref(to64(d), to64(ro.u), to64(lam), to64(lims), 2,
                             True)
    check_backward("pendcart m=1 ±5", out, ref, ref64, tol_bwd)

    # GPS mode on the same derivatives, the trust region centred on the
    # policy of the iLQG backward pass above, with a per-step η in [1, 5].
    # Below η≈1 the KL-weighted recursion itself overflows at T=500 (the
    # f64 reference's dV reaches 1e13 and the f32 one turns NaN), so such
    # inputs compare nothing.
    k2, k3 = jax.random.split(jax.random.PRNGKey(7))
    prev = ref.policy._replace(
        k=0.2 * jax.random.normal(k2, (B, T, 1), jnp.float32))
    eta = 1.0 + 4.0 * jax.random.uniform(k3, (B, T), jnp.float32)
    out = backward_pass_pallas(d, ro.u, jnp.zeros((B,), jnp.float32),
                               reg_type=1, lims=np.asarray(lims),
                               use_limits=True, eta=eta, traj_prev=prev)
    ref = backward_ref(d, ro.u, None, lims, 1, True, eta=eta, prev=prev)
    with jax.enable_x64(True):
        ref64 = backward_ref(to64(d), to64(ro.u), None, to64(lims), 1, True,
                             eta=to64(eta), prev=to64(prev))
    check_backward("pendcart GPS", out, ref, ref64, tol_bwd)

    # quadrotor m=2: the kernel differentiates the lane model in-register
    # (autodiff tiles); the reference autodiffs the Problem version. Starts
    # displaced from the hover goal, thrust noise mostly common to both
    # rotors, so the fleet drifts and tilts without tumbling. Over T=500 the
    # position terms of Vxx grow so large that f32 itself misses the f64
    # answer on some scenarios (a Quu that loses its digits to cancellation),
    # so the kernel is held to the f64 reference, scenario by scenario,
    # beside the f32 XLA version.
    qspec = QuadrotorSpec()
    qprob = make_quadrotor_problem(qspec, jnp.float32)
    qlims = jnp.asarray(qspec.lims, jnp.float32)
    qx0 = jnp.asarray(qspec.goal, jnp.float32)[None, :] + 0.3 * (
        jax.random.normal(jax.random.PRNGKey(3), (B, 6), jnp.float32)
        * jnp.array([1, 0, 1, 0, 0, 0], jnp.float32))
    kc, kd = jax.random.split(jax.random.PRNGKey(4))
    common = 0.2 * jax.random.normal(kc, (B, T, 1), jnp.float32)
    diff = 0.002 * jax.random.normal(kd, (B, T, 1), jnp.float32)
    qu0 = qspec.u_hover + jnp.concatenate([common + diff, common - diff], -1)
    qro = jax.jit(jax.vmap(lambda a, b: forward_pass(qprob, a, b,
                                                     lims=qlims)))(qx0, qu0)
    qd = jax.jit(jax.vmap(qprob.make_derivs()))(qro.x, qro.u)
    qlam = jnp.full((B,), 0.1, jnp.float32)
    traj = to_lanes(jnp.concatenate([qro.x, qro.u], -1), B)
    res = backward_lanes(traj, vec_to_lanes(qlam), n=6, m=2, reg_type=2,
                         lims=qspec.lims,
                         derivs_tiles=autodiff_derivs_tiles(
                             quadrotor_lanes(qspec)))
    lay = OutLayout(6, 2)
    st = res.stats.reshape(4, -1)[:, :B]

    class _Out:
        pass
    qout = _Out()
    qout.policy = GaussianPolicy(
        K=from_lanes(res.out[:, lay.K:lay.K + 12], B, (2, 6)),
        k=from_lanes(res.out[:, lay.k:lay.k + 2], B, (2,)),
        sigma=None, sigma_inv=None)
    qout.dV = jnp.transpose(st[:2])
    qout.diverged = st[2] > 0.5
    qref = backward_ref(qd, qro.u, qlam, qlims, 2, True)
    with jax.enable_x64(True):
        qref64 = backward_ref(to64(qd), to64(qro.u), to64(qlam), to64(qlims),
                              2, True)
    check_backward_vs_f64("quadrotor m=2 autodiff", qout, qref, qref64,
                          tol_bwd)

    # forward rollout and fused line search against ops/forward.py, on the
    # pendcart policy of the XLA backward pass: the forward tolerance of
    # the interpret-mode tests
    rtol_f, atol_f = 2e-5, 1e-4
    bp = backward_ref(d, ro.u, lam, lims, 2, True)
    model = pendcart_lanes(spec)
    alphas = default_alphas(0.2, -3.0, 6)
    A = len(alphas)
    traj = to_lanes(jnp.concatenate([ro.x, ro.u, ro.cost[:, :T, None]], -1),
                    B)
    gains = to_lanes(jnp.concatenate(
        [bp.policy.k, bp.policy.K.reshape(B, T, -1)], -1), B)
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    L = x0_l.shape[1:]
    al = jnp.stack([jnp.full(L, a, jnp.float32) for a in alphas])
    fl = forward_lanes(traj[:, :5], gains, x0_l, al, model=model,
                       lims=((-5.0, 5.0),), gk=0, gK=1)
    ro_a = jax.jit(jax.vmap(lambda a: jax.vmap(
        lambda x_i, u_i, pol: forward_pass(prob, x_i[0], u_i, x_i, a, pol,
                                           lims))(ro.x, ro.u, bp.policy)))(
        jnp.asarray(alphas, jnp.float32))
    compare("forward totals (6 α)", fl.totals.reshape(A, -1)[:, :B],
            jnp.sum(ro_a.cost, -1), rtol_f, atol_f)

    ctot = jnp.sum(ro.cost, -1)
    sel = jnp.stack([vec_to_lanes(bp.dV[:, 0]), vec_to_lanes(bp.dV[:, 1]),
                     vec_to_lanes(ctot),
                     vec_to_lanes(jnp.ones((B,), jnp.float32))])
    ls = linesearch_lanes(traj, gains, x0_l, sel, model=model,
                          alphas=tuple(alphas), lims=((-5.0, 5.0),),
                          gk=0, gK=1)
    lref = jax.jit(jax.vmap(lambda x_i, u_i, c_i, pol, dv: line_search(
        prob, x_i[0], u_i, x_i, c_i, pol, dv, jnp.asarray(alphas,
                                                          jnp.float32),
        lims)))(ro.x, ro.u, ctot, bp.policy, bp.dV)
    al_sel = vec_from_lanes(ls.ls[0], B)
    found = vec_from_lanes(ls.ls[1], B) > 0.5
    al_ref = jnp.where(lref.done, lref.alpha, 0.0)
    agree = (np.asarray(found) == np.asarray(lref.done)) & (
        np.asarray(al_sel) == np.asarray(al_ref))
    print(f"    line search: accepted α differs on {int(np.sum(~agree))} of "
          f"{B} scenarios", flush=True)
    if np.mean(agree) < 0.99:
        raise AssertionError("line search accept decisions disagree")
    ok = agree & np.asarray(found)
    compare("linesearch x (agreeing α)",
            from_lanes(ls.traj[:, :4], B, (4,))[ok], lref.x[ok],
            rtol_f, atol_f)
    compare("linesearch u (agreeing α)",
            from_lanes(ls.traj[:, 4:5], B, (1,))[ok], lref.u[ok],
            rtol_f, atol_f)
    compare("linesearch total",
            vec_from_lanes(ls.ls[4], B)[ok], jnp.sum(lref.cost, -1)[ok],
            rtol_f, atol_f)
    return "all kernels within tolerance"


def phase_kernel_timing(card):
    """Each hand-written kernel against its plain XLA version on the same
    inputs, and the end-to-end iteration time of both tiers, at B=4096,
    T=500, pendcart ±5, f32."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.forward import line_search
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import backward_lanes, pack_backward_inputs
    from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel \
        import linesearch_lanes
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
        to_lanes, vec_to_lanes)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
        ilqg_batched)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)

    spec, prob, lims, x0s, ro, d = pendcart_rollout(B, T)
    lam = jnp.ones((B,), jnp.float32)
    times = {}

    dp = pack_backward_inputs(d, ro.u, B)
    lam_l = vec_to_lanes(lam)
    bk = jax.jit(lambda dp_, l_: backward_lanes(
        dp_, l_, n=4, m=1, reg_type=2, lims=((-5.0, 5.0),), emit="gains"))
    times["backward_lanes (packed derivs, gains)"] = wall(bk, dp, lam_l)
    traj = to_lanes(jnp.concatenate([ro.x, ro.u, ro.cost[:, :T, None]], -1),
                    B)
    bt = jax.jit(lambda tr, l_: backward_lanes(
        tr, l_, n=4, m=1, reg_type=2, lims=((-5.0, 5.0),), emit="gains",
        derivs_tiles=pendcart_derivs_tiles(spec)))
    times["backward_lanes (in-kernel derivs, gains)"] = wall(bt, traj, lam_l)
    bref = jax.jit(lambda d_, u_, l_: backward_ref(d_, u_, l_, lims, 2, True))
    times["XLA vmap(backward_pass)"] = wall(bref, d, ro.u, lam, reps=5)

    bp = bref(d, ro.u, lam)
    alphas = default_alphas(0.2, -3.0, 6)
    gains = to_lanes(jnp.concatenate(
        [bp.policy.k, bp.policy.K.reshape(B, T, -1)], -1), B)
    x0_l = to_lanes(x0s[:, None, :], B)[0]
    ctot = jnp.sum(ro.cost, -1)
    sel = jnp.stack([vec_to_lanes(bp.dV[:, 0]), vec_to_lanes(bp.dV[:, 1]),
                     vec_to_lanes(ctot),
                     vec_to_lanes(jnp.ones((B,), jnp.float32))])
    model = pendcart_lanes(spec)
    lk = jax.jit(lambda tr, g_, s_: linesearch_lanes(
        tr, g_, x0_l, s_, model=model, alphas=tuple(alphas),
        lims=((-5.0, 5.0),), gk=0, gK=1))
    times["linesearch_lanes"] = wall(lk, traj, gains, sel)
    al32 = jnp.asarray(alphas, jnp.float32)
    lref = jax.jit(jax.vmap(lambda x_i, u_i, c_i, pol, dv: line_search(
        prob, x_i[0], u_i, x_i, c_i, pol, dv, al32, lims)))
    times["XLA vmap(line_search)"] = wall(lref, ro.x, ro.u, ctot, bp.policy,
                                          bp.dV, reps=5)

    # end to end: the same ILQGConfig and a 20-iteration budget
    cfg = ILQGConfig(alphas=alphas, reg_type=2, lam_max=1e15, max_iter=20,
                     iter_cap=24)
    u0s = jnp.zeros((B, T, 1), jnp.float32)
    tiles = pendcart_derivs_tiles(spec)
    lane = lambda x_, u_: ilqg_batch_lanes(model, None, x_, u_,
                                           lims=((-5.0, 5.0),), cfg=cfg,
                                           derivs_tiles=tiles)
    r = lane(x0s, u0s)
    it_l = int(np.max(np.asarray(r.n_iters)))
    t_lane = wall(lane, x0s, u0s, reps=5)
    xla = jax.jit(lambda x_, u_: ilqg_batched(prob, x_, u_, lims=lims,
                                              cfg=cfg))
    rx = xla(x0s, u0s)
    it_x = int(np.max(np.asarray(rx.n_iters)))
    t_xla = wall(xla, x0s, u0s, reps=3)
    for k, v in times.items():
        print(f"    {k:<44} {v * 1e3:9.3f} ms   [{card}]", flush=True)
    print(f"    {'ilqg_batch_lanes (lane tier)':<44} {t_lane * 1e3 / it_l:9.3f}"
          f" ms/iter ({it_l} iterations, {t_lane * 1e3:.1f} ms)   [{card}]")
    print(f"    {'ilqg_batched (XLA tier)':<44} {t_xla * 1e3 / it_x:9.3f}"
          f" ms/iter ({it_x} iterations, {t_xla * 1e3:.1f} ms)   [{card}]")
    return (f"lane {t_lane * 1e3 / it_l:.3f} ms/iter vs XLA "
            f"{t_xla * 1e3 / it_x:.3f} ms/iter")


def phase_main_path(card):
    """The public lane entries at their real sizes, with quality gates."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu import demos
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        default_x0, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes, default_x0 as quad_x0)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles \
        import autodiff_derivs_tiles
    from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import (
        to_lanes)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes, mpc_rollout_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        covariance_lanes, gps_rollout_lanes, ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig)

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        warm = time.perf_counter() - t0
        print(f"    {label:<40} first call {cold:7.2f} s, warm "
              f"{warm * 1e3:9.2f} ms   [{card}]", flush=True)
        return out, warm

    spec, prob, lims, x0s, ro, d = pendcart_rollout(B, T)
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)

    # iLQG fleet: pendcart B=4096, T=500, 20-iteration budget
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=20, iter_cap=24)
    u0 = jnp.zeros((B, T, 1), jnp.float32)
    def solved(label, r):
        """Gate: finite costs, no diverged initial rollout, and the fleet's
        mean cost below that of its initial rollout."""
        cost = np.asarray(r.cost_total)
        init = np.asarray(r.trace.cost[:, 0])
        reasons = np.bincount(np.asarray(r.reason), minlength=6)
        print(f"    {label}: mean cost {init.mean():.3f} -> {cost.mean():.3f},"
              f" exit reasons {reasons.tolist()}, mean iterations "
              f"{float(np.mean(np.asarray(r.n_iters))):.2f}")
        assert np.all(np.isfinite(cost)) and reasons[5] == 0
        assert cost.mean() < init.mean()

    r, _ = timed("ilqg_batch_lanes pendcart", lambda: ilqg_batch_lanes(
        model, None, x0s, u0, lims=((-5.0, 5.0),), cfg=cfg,
        derivs_tiles=tiles, record_trace=True))
    solved("pendcart", r)

    # quadrotor B=4096, T=400, autodiff tiles, m=2 thrust box
    qspec = QuadrotorSpec()
    qmodel = quadrotor_lanes(qspec)
    Tq = 400
    qx0 = quad_x0(jnp.float32)[None, :] + 0.3 * jax.random.normal(
        jax.random.PRNGKey(1), (B, 6), jnp.float32) * jnp.array(
            [1, 0, 1, 0, 0.5, 0], jnp.float32)
    qu0 = jnp.full((B, Tq, 2), qspec.u_hover, jnp.float32)
    qr, _ = timed("ilqg_batch_lanes quadrotor", lambda: ilqg_batch_lanes(
        qmodel, None, qx0, qu0, lims=qspec.lims, cfg=cfg,
        derivs_tiles=autodiff_derivs_tiles(qmodel), record_trace=True))
    solved("quadrotor", qr)
    print(f"    quadrotor: mean final height "
          f"{float(np.mean(np.asarray(qr.x[:, -1, 2]))):.3f} m (goal 1)")

    # iLQGkl fleet: B=4096, T=500, 10 iterations; every scenario satisfied
    prev = GaussianPolicy.zeros(T, 4, 1, jnp.float32)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)._replace(k=ro.u)
    cost0 = jnp.sum(ro.cost, -1)
    kcfg = ILQGKLConfig(kl_step=2.0, max_iter=10)
    kr, t_kl = timed("ilqgkl_batch_lanes", lambda: ilqgkl_batch_lanes(
        model, tiles, ro.x, prev, d.fx, cost0, lims=((-5.0, 5.0),),
        cfg=kcfg))
    sat = np.asarray(kr.satisfied)
    print(f"    KL: {int(sat.sum())} of {B} satisfied, mean η "
          f"{float(np.mean(np.asarray(kr.eta))):.3g}")
    fx_l = to_lanes(d.fx.reshape(B, T, -1), B)
    r1 = tuple(tuple(1.0 if i == j else 0.0 for j in range(4))
               for i in range(4))
    cov = jax.jit(lambda f: covariance_lanes(f, n=4, r1=r1))
    t_cov = wall(cov, fx_l)
    print(f"    Σxx propagation (plain lax.scan): {t_cov * 1e3:.3f} ms = "
          f"{100 * t_cov / t_kl:.1f} % of the KL solve   [{card}]")
    assert sat.all(), "KL constraint not satisfied everywhere"

    # MPC: B=4096, T=300, 5 inner iterations, two 20-step windows
    Tm, inner = 300, 5
    mcfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                      lam_max=1e15, max_iter=inner, iter_cap=inner + 4)
    cold_cfg = ILQGConfig(alphas=mcfg.alphas, reg_type=2, lam_max=1e15,
                          max_iter=200)
    mlims = ((-10.0, 10.0),)
    mx = default_x0(jnp.float32)[None, :] + 0.2 * jax.random.normal(
        jax.random.PRNGKey(0), (B, 4), jnp.float32) * jnp.array(
            [1, 1, 0, 0], jnp.float32)
    cold = ilqg_batch_lanes(model, None, mx, jnp.zeros((B, Tm, 1),
                                                       jnp.float32),
                            lims=mlims, cfg=cold_cfg, derivs_tiles=tiles)
    dyn0 = jax.jit(jax.vmap(lambda a, b: prob.dynamics(a, b, 0)))
    xs, us = mx, cold.u
    for w in range(2):
        (xs, us, _, _, _), t_w = timed(
            f"mpc_rollout_lanes window {w + 1} (20 steps)",
            lambda x_=xs, u_=us: mpc_rollout_lanes(
                model, None, x_, u_, dyn0, 20, lims=mlims, cfg=mcfg,
                derivs_tiles=tiles))
    err = float(jnp.mean(jnp.abs(xs[:, 0] - np.pi)))
    steady = ilqg_batch_lanes(model, None, xs, us, lims=mlims, cfg=mcfg,
                              derivs_tiles=tiles, warm_start=True)
    steady_cost = float(jnp.mean(steady.cost_total))
    cold_cost = float(jnp.mean(cold.cost_total))
    print(f"    MPC: {t_w * 1e3 / 20:.3f} ms/step, mean angle error "
          f"{err:.4f} rad (gate 0.85), steady plan cost {steady_cost:.2f} "
          f"vs cold {cold_cost:.2f}")
    assert err < 0.85 and steady_cost < cold_cost

    # GPS outer loop: B=4096, T=500, 2 outer iterations
    (xg, tg, ys), _ = timed("gps_rollout_lanes (2 outer)",
                            lambda: gps_rollout_lanes(
                                model, tiles, ro.x, prev, cost0, pendcart_fx,
                                2, lims=((-5.0, 5.0),), cfg=kcfg))
    gc = np.asarray(ys[0])
    print(f"    GPS: mean cost per outer iteration "
          f"{[round(float(v), 3) for v in gc.mean(axis=1)]}")
    assert np.all(np.isfinite(gc))

    # the demos at their on-card defaults
    res = demos.demo_fleet()
    assert res.cost_total.shape == (B,)
    res = demos.demo_quadrotor()
    assert res.cost_total.shape == (B,)
    return "all entries passed their gates"


def phase_aot(card):
    """Export a small lane solve, serialize, deserialize and compare. JAX
    serializes through the optional ``flatbuffers`` package; without it the
    exported program is called in-process instead, and the line says so."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)
    from differentialdynamicprogramming_jl_tpu.utils.aot import (
        export_solver, serialize_solver, deserialize_solver)
    spec = PendCartSpec()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=5)
    Bs, Ts = 256, 64
    x0s = default_x0(jnp.float32)[None, :] + 0.1 * jax.random.normal(
        jax.random.PRNGKey(0), (Bs, 4), jnp.float32)
    u0s = jnp.zeros((Bs, Ts, 1), jnp.float32)

    def solve(x_, u_):
        return ilqg_batch_lanes(pendcart_lanes(spec), None, x_, u_,
                                lims=((-5.0, 5.0),), cfg=cfg,
                                derivs_tiles=pendcart_derivs_tiles(spec))

    try:
        import flatbuffers  # noqa: F401 — jax.export's serializer needs it
    except ImportError:
        exported = export_solver(solve, x0s, u0s)
        got = jax.jit(exported.call)(x0s, u0s)
        what = ("exported program called in-process (flatbuffers is not "
                "installed, so JAX cannot serialize it)")
    else:
        blob = serialize_solver(solve, x0s, u0s)
        got = deserialize_solver(blob)(x0s, u0s)
        what = f"{len(blob)} byte artifact round-tripped"
    ref = solve(x0s, u0s)
    np.testing.assert_array_equal(np.asarray(got.reason),
                                  np.asarray(ref.reason))
    np.testing.assert_allclose(np.asarray(got.cost_total),
                               np.asarray(ref.cost_total), rtol=1e-6)
    return what


def phase_gpu_tests(card):
    """The functions behind the tests marked ``gpu``, called in-process (a
    second JAX process on the card would fail for want of memory)."""
    import jax
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import test_gpu
    names = [n for n in dir(test_gpu) if n.startswith("test_")]
    for n in names:
        t0 = time.perf_counter()
        getattr(test_gpu, n)(jax.devices()[0])
        print(f"    {n} passed ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return f"{len(names)} card-only tests passed"


PHASES = {
    "environment": phase_environment,
    "parity": phase_parity,
    "solver_parity": phase_solver_parity,
    "timing": phase_kernel_timing,
    "main_path": phase_main_path,
    "aot": phase_aot,
    "gpu_tests": phase_gpu_tests,
}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four(card):
    """Fleets sharded over four cards through the lane entries and the XLA
    entry, each compared per scenario with its shards solved alone on card
    0 in this process."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.parallel.mesh import (
        make_mesh, ilqg_batch_sharded, ilqgkl_batch_sharded, ilqg_sharded,
        ilqg_batched)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig)

    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"{len(jax.devices())} devices visible, need 4")
    mesh = make_mesh(n_dev)
    dev0 = jax.devices()[0]
    Bf = n_dev * B
    spec, prob, lims, x0s, ro, d = pendcart_rollout(Bf, T)
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=20, iter_cap=24)
    host = lambda a: np.asarray(a)

    def outcome(r):
        """Exit reason (iLQG) or satisfied flag (iLQGkl) per scenario."""
        return host(r.reason if hasattr(r, "reason") else r.satisfied)

    def check(label, res, stats, shard_results, cost_of, stat_fields):
        n_cards = len({s.device for s in res.u.addressable_shards})
        print(f"    {label}: result shards on {n_cards} distinct cards")
        assert n_cards == n_dev
        reason = outcome(res)
        iters = host(res.n_iters)
        cost = host(cost_of(res))
        per = [(outcome(r), host(r.n_iters), host(cost_of(r)))
               for r in shard_results]
        r1 = np.concatenate([p[0] for p in per])
        i1 = np.concatenate([p[1] for p in per])
        c1 = np.concatenate([p[2] for p in per])
        same_r = int(np.sum(reason != r1))
        same_i = int(np.sum(iters != i1))
        rel = float(np.max(np.abs(cost - c1) / (np.abs(c1) + 1e-6)))
        print(f"    {label}: vs one card — exit reasons differ on {same_r}, "
              f"iteration counts on {same_i} of {len(r1)}, max relative "
              f"cost difference {rel:.2e}")
        want = np.array([f(per) for f in stat_fields])
        got = host(stats)
        print(f"    {label}: psum stats {got.tolist()} vs sum of shards "
              f"{want.tolist()}")
        assert same_r == 0 and same_i == 0 and rel <= 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5)

    # lane iLQG
    u0 = jnp.zeros((Bf, T, 1), jnp.float32)
    t0 = time.perf_counter()
    res, stats = ilqg_batch_sharded(model, None, x0s, u0,
                                    lims=((-5.0, 5.0),), cfg=cfg, mesh=mesh,
                                    derivs_tiles=tiles, reduce_stats=True)
    jax.block_until_ready(res.u)
    print(f"    ilqg_batch_sharded B={Bf} T={T}: "
          f"{time.perf_counter() - t0:.1f} s incl. compile   [{card}]")
    shards = []
    for i in range(n_dev):
        sl = slice(i * B, (i + 1) * B)
        shards.append(ilqg_batch_lanes(
            model, None, jax.device_put(x0s[sl], dev0),
            jax.device_put(u0[sl], dev0), lims=((-5.0, 5.0),), cfg=cfg,
            derivs_tiles=tiles))
    check("lane iLQG", res, stats, shards, lambda r: r.cost_total,
          [lambda p: sum(float(np.sum(q[2])) for q in p),
           lambda p: sum(float(np.sum(q[1])) for q in p),
           lambda p: sum(float(np.sum((q[0] == 1) | (q[0] == 2)))
                         for q in p)])

    # lane iLQGkl
    prev = GaussianPolicy.zeros(T, 4, 1, jnp.float32)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (Bf,) + a.shape), prev)._replace(k=ro.u)
    cost0 = jnp.sum(ro.cost, -1)
    kcfg = ILQGKLConfig(kl_step=2.0, max_iter=10)
    kres, kstats = ilqgkl_batch_sharded(model, tiles, ro.x, prev, d.fx, cost0,
                                        lims=((-5.0, 5.0),), cfg=kcfg,
                                        mesh=mesh, reduce_stats=True)
    jax.block_until_ready(kres.u)
    kshards = []
    for i in range(n_dev):
        sl = slice(i * B, (i + 1) * B)
        put = lambda a: jax.device_put(a[sl], dev0)
        kshards.append(ilqgkl_batch_lanes(
            model, tiles, put(ro.x), jax.tree_util.tree_map(put, prev),
            put(d.fx), put(cost0), lims=((-5.0, 5.0),), cfg=kcfg))
    check("lane iLQGkl", kres, kstats, kshards, lambda r: r.cost_total,
          [lambda p: sum(float(np.sum(q[2])) for q in p),
           lambda p: sum(float(np.sum(q[1])) for q in p),
           lambda p: sum(float(np.sum(q[0])) for q in p)])

    # XLA tier at a smaller batch
    Bx, Tx = 4 * 256, 200
    xcfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=10, iter_cap=14)
    xu0 = jnp.zeros((Bx, Tx, 1), jnp.float32)
    xres, xstats = ilqg_sharded(prob, x0s[:Bx], xu0, lims=lims, cfg=xcfg,
                                mesh=mesh, reduce_stats=True)
    jax.block_until_ready(xres.u)
    xshards = []
    Bs = Bx // n_dev
    one = jax.jit(lambda a, b: ilqg_batched(prob, a, b, lims=lims,
                                            cfg=xcfg))
    for i in range(n_dev):
        sl = slice(i * Bs, (i + 1) * Bs)
        xshards.append(one(jax.device_put(x0s[sl], dev0),
                           jax.device_put(xu0[sl], dev0)))
    check("XLA iLQG", xres, xstats, xshards,
          lambda r: jnp.sum(r.cost, -1),
          [lambda p: sum(float(np.sum(q[2])) for q in p),
           lambda p: sum(float(np.sum(q[1])) for q in p),
           lambda p: sum(float(np.sum((q[0] == 1) | (q[0] == 2)))
                         for q in p)])
    return "sharded fleets agree with their one-card shards"


# ---------------------------------------------------------------------------
# tile sweep
# ---------------------------------------------------------------------------

def phase_sweep(card):
    """backward_lanes and linesearch_lanes at B=4096, T=500 (pendcart, the
    solver's in-kernel derivative path) for each tile width W and
    ``num_warps``."""
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.ops.pallas import pack
    from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel \
        import backward_lanes
    from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel \
        import linesearch_lanes
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        default_alphas)
    spec, prob, lims, x0s, ro, d = pendcart_rollout(B, T)
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    alphas = tuple(default_alphas(0.2, -3.0, 6))
    base = jnp.concatenate([ro.x, ro.u, ro.cost[:, :T, None]], -1)
    rows = []
    saved = (pack.W, pack.TILE, pack.B_TILE, pack.NUM_WARPS)
    try:
        for w in (32, 64, 128, 256):
            for nw in (1, 2, 4):
                pack.W, pack.TILE, pack.B_TILE, pack.NUM_WARPS = (
                    w, (1, w), w, nw)
                jax.clear_caches()
                traj = pack.to_lanes(base, B)
                lam = pack.vec_to_lanes(jnp.ones((B,), jnp.float32))
                bk = jax.jit(lambda tr, l_: backward_lanes(
                    tr, l_, n=4, m=1, reg_type=2, lims=((-5.0, 5.0),),
                    emit="gains", derivs_tiles=tiles))
                t_b = wall(bk, traj, lam)
                gains = bk(traj, lam).out
                x0_l = traj[0, :4]
                sel = jnp.stack([lam * 0.0 - 1.0, lam * 0.0,
                                 lam * 1e3, lam])
                lk = jax.jit(lambda tr, g_, s_: linesearch_lanes(
                    tr, g_, x0_l, s_, model=model, alphas=alphas,
                    lims=((-5.0, 5.0),), gk=0, gK=1, g_slots=5))
                t_l = wall(lk, traj, gains, sel)
                rows.append((w, nw, t_b, t_l))
                print(f"    W={w:<4} num_warps={nw}  backward "
                      f"{t_b * 1e3:8.3f} ms  linesearch {t_l * 1e3:8.3f} ms"
                      f"   [{card}]", flush=True)
    finally:
        pack.W, pack.TILE, pack.B_TILE, pack.NUM_WARPS = saved
        jax.clear_caches()
    best = min(rows, key=lambda r: r[2] + r[3])
    return f"fastest: W={best[0]} num_warps={best[1]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--sweep", action="store_true",
                    help="run only the tile width x num_warps sweep")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only the named one-card phase(s)")
    args = ap.parse_args(argv)

    import jax
    from differentialdynamicprogramming_jl_tpu.runtime import (
        enable_compile_cache)
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (backend {jax.default_backend()})",
              file=sys.stderr)
        return 1

    card = card_line()
    if args.four:
        phases = [("four", phase_four)]
    elif args.sweep:
        phases = [("environment", phase_environment), ("sweep", phase_sweep)]
    else:
        names = args.phase or list(PHASES)
        if "environment" not in names:
            names = ["environment"] + names
        phases = [(n, PHASES[n]) for n in names]

    t_all = time.perf_counter()
    failed = []
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            detail = fn(card)
            status = "ok"
        except Exception as e:  # noqa: BLE001 — report every phase
            traceback.print_exc()
            detail = f"{type(e).__name__}: {e}"
            status = "FAILED"
            failed.append(name)
        print(f"[{name}] {status} in {time.perf_counter() - t0:.1f} s: "
              f"{detail}", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

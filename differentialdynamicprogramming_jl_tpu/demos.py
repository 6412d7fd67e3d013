"""Runnable demos — parity with the reference's exported demo functions
(``demo_linear``, ``demo_linear_kl``, ``demo_pendcart``, ``demoQP``;
``src/DifferentialDynamicProgramming.jl:6``)."""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from .solvers.ilqg import ilqg, ILQGConfig, default_alphas
from .solvers.ilqgkl import ilqg_kl, ILQGKLConfig
from .policy import GaussianPolicy
from .ops.forward import forward_pass
from .ops.boxqp import demo_qp
from .models.linear import random_lti, make_lti_problem, SimpleLTVModel
from .models.pendcart import (PendCartSpec, make_pendcart_problem,
                              default_lims, default_x0, lqr,
                              linearized_upright, simulate_pendcart)
from .runtime import solver_tier
from .utils.plotting import (plot_linear, plot_pendcart, plotting_available)


def demo_linear(seed: int = 0, T: int = 1000, dtype=jnp.float64,
                plot: bool = False, **cfg_kwargs):
    """Random stable LTI problem solved with iLQG
    (reference ``demo_linear``, ``src/demo_linear.jl:5-60``)."""
    print("Running linear demo (iLQG)")
    spec = random_lti(jax.random.PRNGKey(seed), n=10, m=2, T=T, dtype=dtype)
    prob = make_lti_problem(spec, T)
    cfg = ILQGConfig(**cfg_kwargs)
    t0 = time.perf_counter()
    res = ilqg(prob, spec.x0, spec.u0, cfg=cfg)
    jax.block_until_ready(res.cost)
    dt = time.perf_counter() - t0
    print(f"  solved in {dt*1e3:.1f} ms ({int(res.n_iters)} iterations, "
          f"reason {int(res.reason)}), total cost "
          f"{float(jnp.sum(res.cost)):.4f}")
    if plot and plotting_available():
        plot_linear(res)
    return res


def demo_linear_kl(seed: int = 0, T: int = 1000, kl_step: float = 100.0,
                   outer_iters: int = 5, dtype=jnp.float64,
                   plot: bool = False, **cfg_kwargs):
    """GPS-style outer loop: 5 iLQGkl solves re-centered on the previous
    policy (reference ``demo_linear_kl``, ``src/demo_linear.jl:63-136``)."""
    print("Running linear demo with KL-divergence constraint")
    spec = random_lti(jax.random.PRNGKey(seed), n=10, m=2, T=T, dtype=dtype)
    prob = make_lti_problem(spec, T)
    model = SimpleLTVModel.from_lti(spec.A, spec.B, T)
    ro = forward_pass(prob, spec.x0, spec.u0)
    x, cost = ro.x, ro.cost
    traj = GaussianPolicy.zeros(T, 10, 2, dtype)._replace(k=spec.u0)
    cfg = ILQGKLConfig(kl_step=kl_step, **cfg_kwargs)
    res = None
    for it in range(outer_iters):
        res = ilqg_kl(prob, x, traj, model, cost, cfg=cfg)
        x, cost, traj = res.x, res.cost, res.policy
        print(f"  outer {it + 1}: cost = {float(jnp.sum(cost)):.4f}, "
              f"eta = {float(jnp.mean(res.eta)):.3g}, "
              f"KL = {float(jnp.mean(res.divergence)):.3g}")
    if plot and plotting_available():
        plot_linear(res)
    return res


def demo_pendcart(T: int = 600, dtype=jnp.float64, plot: bool = False,
                  derivs: str = "zoh", lims_val: float = 10.0,
                  **cfg_kwargs):
    """Control-limited pendulum-on-cart swing-up
    (reference ``demo_pendcart``, ``src/system_pendcart.jl:42-212``).

    Note: with the reference's exact constants and ±5 limits the upright goal
    is dynamically unreachable from x0 (holding torque needs |u| > 6.7; the
    d=0.99 damping kills pump-up) and the reference algorithm converges to
    the hanging local optimum (verified against the independent NumPy
    oracle; the Julia reference itself has never been executed here — see
    the provenance caveat in ``tests/test_pendcart.py``). The demo
    therefore defaults to feasible ±10 limits, where the swing-up
    succeeds; pass ``lims_val=5.0`` for the exact reference
    configuration."""
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs=derivs, dtype=dtype)
    x0 = default_x0(dtype)
    lims = jnp.array([[-lims_val, lims_val]], dtype)

    # the failing LQG baseline (src/system_pendcart.jl:187-188)
    A, B = linearized_upright(spec)
    L = lqr(A, B, np.diag(spec.Q), np.array([[spec.R]]))
    x00, u00, cost00 = simulate_pendcart(x0, L, spec, T, lims, dtype)
    print(f"clamped-LQG baseline final angle error: "
          f"{abs(float(x00[-1, 0]) - np.pi):.3f} rad, "
          f"cost {float(jnp.sum(cost00)):.1f}")

    defaults = dict(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                    lam_max=1e15, tol_fun=1e-8, tol_grad=1e-8, max_iter=1000)
    defaults.update(cfg_kwargs)
    cfg = ILQGConfig(**defaults)
    print("Entering iLQG")
    t0 = time.perf_counter()
    res = ilqg(prob, x0, jnp.zeros((T, 1), dtype), lims=lims, cfg=cfg)
    jax.block_until_ready(res.cost)
    dt = time.perf_counter() - t0
    print(f"  solved in {dt*1e3:.1f} ms ({int(res.n_iters)} iterations), "
          f"cost {float(jnp.sum(res.cost)):.1f}, final angle error "
          f"{abs(float(res.x[-1, 0]) - np.pi):.3f} rad")
    if plot and plotting_available():
        plot_pendcart(x00, u00, res)
    return res


def demo_mpc(B: int = 16, T: int = 300, mpc_steps: int = 40,
             dtype=jnp.float32, seed: int = 0, lims_val: float = 10.0,
             inner_iters: int = 5, verbose: bool = True,
             tier: str = "auto", interpret: bool = False):
    """Receding-horizon MPC over a fleet of pendulum-carts — the production
    workload the batched solvers are built for (BASELINE.json north star).

    Each MPC step warm-starts a short iLQG solve from the shifted previous
    plan, applies the first control through the true dynamics, and repeats.

    ``tier``: ``"lanes"`` runs the Pallas lane fast path with the
    ``warm_start=True`` entry (no α-sweep; compiled on a GPU, through the
    interpreter with ``interpret=True``); ``"vmap"`` the portable XLA
    path; ``"auto"`` asks :func:`~.runtime.solver_tier`.
    """
    from .parallel.mesh import ilqg_batched

    if tier == "auto":
        tier = "vmap" if solver_tier(interpret) == "xla" else "lanes"
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    lims = jnp.array([[-lims_val, lims_val]], dtype)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=inner_iters,
                     iter_cap=inner_iters + 4)
    key = jax.random.PRNGKey(seed)
    x = (default_x0(dtype)[None, :]
         + 0.2 * jax.random.normal(key, (B, 4), dtype)
         * jnp.array([1, 1, 0, 0], dtype))
    u_warm = jnp.zeros((B, T, 1), dtype)

    # cold-start config: one full-budget solve (warm starts carry it forward)
    cfg0 = ILQGConfig(alphas=cfg.alphas, reg_type=2, lam_max=1e15,
                      max_iter=200)

    if tier == "lanes":
        from .models.pendcart import pendcart_lanes, pendcart_derivs_tiles
        from .solvers.batch import ilqg_batch_lanes
        model = pendcart_lanes(spec)
        tiles = pendcart_derivs_tiles(spec)
        lims_t = ((-float(lims_val), float(lims_val)),)
        kt = dict(kt_backward=2, kt_forward=2) if interpret else {}

        def solve(x_, u_, cfg_, warm):
            return ilqg_batch_lanes(model, None, x_, u_, lims=lims_t,
                                    cfg=cfg_, derivs_tiles=tiles,
                                    warm_start=warm, interpret=interpret,
                                    **kt)

        dyn0 = jax.jit(jax.vmap(lambda a, b: prob.dynamics(a, b, 0)))

        def mpc_step(x_, u_):
            res = solve(x_, u_, cfg, True)
            x_next = dyn0(x_, res.u[:, 0])
            u_shift = jnp.concatenate(
                [res.u[:, 1:], jnp.zeros((B, 1, 1), dtype)], axis=1)
            return x_next, u_shift, res.cost_total
    else:
        @jax.jit
        def mpc_step(x, u_warm):
            # pre-rolled warm start (src/iLQG.jl:193-197) — no initial
            # α-sweep, the shifted previous plan is used verbatim
            ro = jax.vmap(lambda a, b: forward_pass(prob, a, b, lims=lims)
                          )(x, u_warm)
            res = jax.vmap(lambda xt, ut, ct: ilqg(
                prob, xt, ut, lims=lims, cfg=cfg, cost0=ct))(
                    ro.x, ro.u, ro.cost)
            u0 = res.u[:, 0]
            x_next = jax.vmap(lambda a, b: prob.dynamics(a, b, 0))(x, u0)
            u_shift = jnp.concatenate(
                [res.u[:, 1:], jnp.zeros((B, 1, 1), dtype)], axis=1)
            return x_next, u_shift, jnp.sum(res.cost, axis=-1)

    if verbose:
        print(f"MPC fleet: {B} pendcarts, horizon {T}, "
              f"{mpc_steps} steps, {inner_iters} iLQG iters/step "
              f"[{tier} tier]")
    if tier == "lanes":
        res0 = solve(x, u_warm, cfg0, False)
        u_warm = res0.u
        cold_cost = float(jnp.mean(res0.cost_total))
    else:
        res0 = ilqg_batched(prob, x, u_warm, lims=lims, cfg=cfg0)
        u_warm = res0.u
        cold_cost = float(jnp.mean(jnp.sum(res0.cost, -1)))
    if verbose:
        print(f"  cold-start solve: mean plan cost {cold_cost:.2f}")
    t0 = time.perf_counter()
    errs = []
    for step in range(mpc_steps):
        x, u_warm, costs = mpc_step(x, u_warm)
        err = float(jnp.mean(jnp.abs(x[:, 0] - np.pi)))
        errs.append(err)
        if verbose and (step + 1) % 10 == 0:
            print(f"  step {step + 1:3d}: mean |angle err| {err:7.4f} rad, "
                  f"mean plan cost {float(jnp.mean(costs)):9.2f}")
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    if verbose:
        print(f"  {mpc_steps} MPC steps in {dt*1e3:.0f} ms "
              f"({dt*1e3/mpc_steps:.1f} ms/step incl. host loop)")
    return x, errs


def demo_fleet(B: int = None, T: int = 500, dtype=jnp.float32,
               max_iter: int = 20, lims_val: float = 5.0,
               interpret: bool = False):
    """Fleet-scale batched solve — the BASELINE.json north-star workload.

    The tier comes from :func:`~.runtime.solver_tier`: on a GPU the
    compiled lane path at B=4096; on the CPU a small vmap fleet, or the
    lane path through the interpreter with ``interpret=True``.
    """
    tier = solver_tier(interpret)
    lanes = tier != "xla"
    if B is None:
        B = 4096 if tier == "lanes" else 16
    spec = PendCartSpec()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=max_iter, iter_cap=max_iter + 4)
    key = jax.random.PRNGKey(0)
    x0s = (default_x0(dtype)[None, :]
           + 0.2 * jax.random.normal(key, (B, 4), dtype)
           * jnp.array([1, 0, 0, 0], dtype))
    u0s = jnp.zeros((B, T, 1), dtype)
    print(f"Fleet solve: {B} pendcart scenarios, T={T}, "
          f"{max_iter}-iteration budget, ±{lims_val} limits "
          f"[{tier} tier]")
    t0 = time.perf_counter()
    if lanes:
        from .solvers.batch import ilqg_batch_lanes
        from .models.pendcart import pendcart_lanes, pendcart_derivs_tiles
        res = ilqg_batch_lanes(
            pendcart_lanes(spec), None, x0s, u0s,
            lims=((-lims_val, lims_val),), cfg=cfg,
            derivs_tiles=pendcart_derivs_tiles(spec),
            interpret=tier == "interpret")
        costs = res.cost_total
    else:
        from .parallel.mesh import ilqg_batched
        prob = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
        res = ilqg_batched(prob, x0s, u0s,
                           lims=jnp.array([[-lims_val, lims_val]], dtype),
                           cfg=cfg)
        costs = jnp.sum(res.cost, axis=-1)
    jax.block_until_ready(costs)
    dt = time.perf_counter() - t0
    mean_cost = float(jnp.mean(costs))
    print(f"  {B} solves in {dt*1e3:.0f} ms (incl. compile on first call) — "
          f"mean cost {mean_cost:.1f}, "
          f"mean iterations {float(jnp.mean(res.n_iters)):.1f}")
    return res


def demo_quadrotor(B: int = None, T: int = 400, dtype=jnp.float32,
                   max_iter: int = 30, interpret: bool = False):
    """Planar-quadrotor fleet: displaced/tilted starts → hover at the goal
    under per-rotor thrust limits (0, u_max) — the m=2 in-kernel box-QP
    enumeration path, with the backward kernel's derivative tiles derived
    ENTIRELY by autodiff (``autodiff_derivs_tiles``): no hand-written
    Jacobians anywhere in this model (``models/quadrotor.py``). The tier
    comes from :func:`~.runtime.solver_tier` (the XLA tier autodiffs the
    same model's ``Problem`` form)."""
    from .models.quadrotor import (QuadrotorSpec, quadrotor_lanes,
                                   make_quadrotor_problem,
                                   default_x0 as quad_x0)
    from .ops.pallas.autodiff_tiles import autodiff_derivs_tiles
    from .solvers.batch import ilqg_batch_lanes
    from .parallel.mesh import ilqg_batched
    tier = solver_tier(interpret)
    if B is None:
        B = 4096 if tier == "lanes" else 8
    spec = QuadrotorSpec()
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15, max_iter=max_iter, iter_cap=max_iter + 8)
    key = jax.random.PRNGKey(0)
    x0s = (quad_x0(dtype)[None, :]
           + 0.3 * jax.random.normal(key, (B, 6), dtype)
           * jnp.array([1, 0, 1, 0, 0.5, 0], dtype))
    u0s = jnp.full((B, T, 2), spec.u_hover, dtype)
    print(f"Quadrotor fleet: {B} scenarios, T={T}, thrust limits "
          f"(0, {spec.u_max}) [{tier} tier]")
    t0 = time.perf_counter()
    if tier == "xla":
        res = ilqg_batched(make_quadrotor_problem(spec, dtype), x0s, u0s,
                           lims=jnp.asarray(spec.lims, dtype), cfg=cfg)
        costs = jnp.sum(res.cost, axis=-1)
    else:
        model = quadrotor_lanes(spec)
        res = ilqg_batch_lanes(model, None, x0s, u0s, lims=spec.lims,
                               cfg=cfg, derivs_tiles=autodiff_derivs_tiles(
                                   model),
                               interpret=tier == "interpret")
        costs = res.cost_total
    jax.block_until_ready(costs)
    dt = time.perf_counter() - t0
    print(f"  {B} solves in {dt*1e3:.0f} ms (incl. compile) — mean cost "
          f"{float(jnp.mean(costs)):.2f}, mean iterations "
          f"{float(jnp.mean(res.n_iters)):.1f}, "
          f"mean final height {float(jnp.mean(res.x[:, -1, 2])):.2f} m")
    return res


def demo_boxqp(n: int = 500, seed: int = 0):
    """Standalone box-QP demo (reference ``demoQP``, ``src/boxQP.jl:190-199``)."""
    t0 = time.perf_counter()
    out = demo_qp(n=n, seed=seed)
    jax.block_until_ready(out.x)
    dt = time.perf_counter() - t0
    results = {-1: "Hessian is not positive definite",
               0: "No descent direction found",
               1: "Maximum main iterations exceeded",
               2: "Maximum line-search iterations exceeded",
               3: "No bounds, returning Newton point",
               4: "Improvement smaller than tolerance",
               5: "Gradient norm smaller than tolerance",
               6: "All dimensions are clamped"}
    print(f"boxQP n={n}: {results[int(out.result)]}; "
          f"iterations {int(out.iters)}, gradient {float(out.gnorm):.3g}, "
          f"value {float(out.value):.6g}, "
          f"factorizations {int(out.nfactor)}, {dt*1e3:.1f} ms")
    return out


def main(argv=None):
    """Console entry point (``ddp-demos [name ...]``) — run the named
    demos, or the default tour. The reference exposes its demos as exported
    functions (``src/DifferentialDynamicProgramming.jl:6``); a CLI is the
    installable-package equivalent."""
    import sys as _sys
    registry = {
        "boxqp": demo_boxqp,
        "linear": demo_linear,
        "linear_kl": demo_linear_kl,
        "pendcart": demo_pendcart,
        "mpc": demo_mpc,
        "fleet": demo_fleet,
        "quadrotor": demo_quadrotor,
    }
    names = list(argv) if argv is not None else _sys.argv[1:]
    if any(a in ("-h", "--help") for a in names):
        print("usage: ddp-demos [name ...]\n"
              f"available demos: {', '.join(registry)}\n"
              "default (no args): boxqp linear linear_kl pendcart fleet "
              "quadrotor")
        return 0
    unknown = [a for a in names if a not in registry]
    if unknown:
        print(f"unknown demo(s): {', '.join(unknown)} — "
              f"available: {', '.join(registry)}", file=_sys.stderr)
        return 2
    if not names:
        names = ["boxqp", "linear", "linear_kl", "pendcart", "fleet",
                 "quadrotor"]
    for name in names:
        registry[name]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

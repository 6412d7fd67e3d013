"""Benchmark: one JSON line per product tier on one CUDA GPU.

  1. ilqgkl_fleet_solve  — 10-iteration scalar-η GPS trust-region solve,
     B=4096 T=500 pendcart
  2. mpc_steady_step     — warm-started 5-iteration receding-horizon MPC
     step, B=4096 T=300, 20 steps chained on device per lax.scan window
  3. quadrotor_iter      — 20-iteration-budget quadrotor fleet solve per
     iteration, B=4096 T=400, m=2 thrust box, autodiff tiles
  4. ilqg_full_driver_iter (HEADLINE, last line) — 20-iteration-budget
     pendcart fleet solve per iteration, B=4096 T=500

Each value is the median over repeated runs of work that ends in
``jax.block_until_ready``; compilation happens in warm-up calls before the
window. Every line names the device as JAX reports it and the card's name
and power limit as ``nvidia-smi`` reports them. Without a GPU the script
exits non-zero and measures nothing. A tier that fails still emits its line
with ``value: null`` and the error — one broken tier must not hide the rest.
"""
import json
import statistics
import subprocess
import sys
import time
import traceback

# one metric name per tier — the SAME string on success and failure
METRIC_KL = "ilqgkl_fleet_solve_latency_b4096_T500_pendcart_10iter_f32"
METRIC_MPC = "mpc_steady_step_latency_b4096_T300_inner5_pendcart_f32"
METRIC_QUAD = "quadrotor_fleet_iter_latency_b4096_T400_m2_autodiff_f32"
METRIC_HEADLINE = "ilqg_full_driver_iter_latency_b4096_T500_pendcart_boxqp_f32"

REPS = 7


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _device():
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": _card()}


def _emit(metric, value, extra=None, error=None):
    rec = {"metric": metric, "value": value, "unit": "ms"}
    rec.update(_device())
    if extra:
        rec.update(extra)
    if error:
        rec["error"] = error
    print(json.dumps(rec), flush=True)
    return rec


def _median_time(run, *args, reps=REPS):
    """Median wall time (s) of ``run(*args)`` to completion; the first two
    calls (compile + one warm run) are not timed."""
    import jax
    for _ in range(2):
        out = jax.block_until_ready(run(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def bench_kl():
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles,
        make_pendcart_problem)
    from differentialdynamicprogramming_jl_tpu.ops.forward import (
        forward_pass)
    from differentialdynamicprogramming_jl_tpu.policy import GaussianPolicy
    from differentialdynamicprogramming_jl_tpu.solvers.batch_kl import (
        ilqgkl_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (
        ILQGKLConfig)

    B, T, MAX_ITER = 4096, 500, 10
    dtype = jnp.float32
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    problem = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    key = jax.random.PRNGKey(0)
    x0s = (default_x0(dtype)[None, :]
           + 0.2 * jax.random.normal(key, (B, 4), dtype)
           * jnp.array([1, 1, 0, 0], dtype))
    u0s = 0.2 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1), dtype)
    ro = jax.vmap(lambda a, b: forward_pass(problem, a, b))(x0s, u0s)
    prev = GaussianPolicy.zeros(T, 4, 1, dtype)
    prev = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), prev)
    prev = prev._replace(k=ro.u)
    d = jax.vmap(problem.make_derivs())(ro.x, ro.u)
    cost0 = jnp.sum(ro.cost, -1)
    cfg = ILQGKLConfig(kl_step=2.0, max_iter=MAX_ITER)

    t, _ = _median_time(lambda: ilqgkl_batch_lanes(model, tiles, ro.x, prev,
                                                   d.fx, cost0, cfg=cfg))
    return _emit(METRIC_KL, t * 1e3)


def bench_mpc():
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, make_pendcart_problem, pendcart_lanes,
        pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        mpc_rollout_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)

    B, T, INNER, N_STEADY = 4096, 300, 5, 20
    dtype = jnp.float32
    spec = PendCartSpec()
    prob = make_pendcart_problem(spec, derivs="euler", dtype=dtype)
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    lims_t = ((-10.0, 10.0),)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 4), reg_type=2,
                     lam_max=1e15, max_iter=INNER, iter_cap=INNER + 4)
    key = jax.random.PRNGKey(0)
    x = (default_x0(dtype)[None, :]
         + 0.2 * jax.random.normal(key, (B, 4), dtype)
         * jnp.array([1, 1, 0, 0], dtype))
    dyn0 = jax.jit(jax.vmap(lambda a, b: prob.dynamics(a, b, 0)))

    # the receding-horizon loop runs on the device: N_STEADY MPC steps
    # chained in one lax.scan per window, via the packaged serving entry
    def mpc_chunk(x_, u_):
        x_f, u_f, _, _, _ = mpc_rollout_lanes(
            model, None, x_, u_, dyn0, N_STEADY, lims=lims_t, cfg=cfg,
            derivs_tiles=tiles)
        return x_f, u_f

    # per-step latency is data-dependent (the driver loop exits early once
    # every lane's budget is spent or converged), so burn in real MPC steps
    # from a noisy plan before timing; each timed window continues from the
    # evolved state
    u_warm = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (B, T, 1),
                                     dtype)
    xs, us = jax.block_until_ready(mpc_chunk(x, u_warm))
    xs, us = jax.block_until_ready(mpc_chunk(xs, us))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        xs, us = jax.block_until_ready(mpc_chunk(xs, us))
        ts.append((time.perf_counter() - t0) / N_STEADY)
    return _emit(METRIC_MPC, statistics.median(ts) * 1e3)


def _iteration_time(run):
    import numpy as np
    t, r = _median_time(run)
    iters = int(np.max(np.asarray(r.n_iters)))
    assert iters >= 1, iters
    return t * 1e3 / iters, iters


def bench_quadrotor():
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.quadrotor import (
        QuadrotorSpec, quadrotor_lanes, default_x0 as quad_x0)
    from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
        autodiff_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)

    B, T, ITER_BUDGET = 4096, 400, 20
    dtype = jnp.float32
    spec = QuadrotorSpec()
    model = quadrotor_lanes(spec)
    tiles = autodiff_derivs_tiles(model)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15)
    x0s = (quad_x0(dtype)[None, :]
           + 0.3 * jax.random.normal(jax.random.PRNGKey(1), (B, 6), dtype)
           * jnp.array([1, 0, 1, 0, 0.5, 0], dtype))
    u0s = jnp.full((B, T, 2), spec.u_hover, dtype)
    ms, iters = _iteration_time(lambda: ilqg_batch_lanes(
        model, None, x0s, u0s, lims=spec.lims, cfg=cfg, derivs_tiles=tiles,
        max_steps=ITER_BUDGET))
    return _emit(METRIC_QUAD, ms, extra={"iters": iters})


def bench_headline():
    import jax
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)

    B, T, ITER_BUDGET = 4096, 500, 20
    dtype = jnp.float32
    spec = PendCartSpec()
    model = pendcart_lanes(spec)
    tiles = pendcart_derivs_tiles(spec)
    cfg = ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                     lam_max=1e15)
    x0 = default_x0(dtype)
    x0s = x0[None, :] + (0.2 * jax.random.normal(
        jax.random.PRNGKey(0), (B, 4), dtype)
        * jnp.array([1, 0, 0, 0], dtype))
    u0s = jnp.zeros((B, T, 1), dtype)
    ms, iters = _iteration_time(lambda: ilqg_batch_lanes(
        model, None, x0s, u0s, lims=((-5.0, 5.0),), cfg=cfg,
        derivs_tiles=tiles, max_steps=ITER_BUDGET))
    return _emit(METRIC_HEADLINE, ms, extra={"iters": iters})


def main():
    import jax
    from differentialdynamicprogramming_jl_tpu.runtime import (
        enable_compile_cache)
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"bench.py: no GPU (backend {jax.default_backend()}); "
              f"nothing measured", file=sys.stderr)
        sys.exit(1)

    failures = 0
    for tier, metric in ((bench_kl, METRIC_KL), (bench_mpc, METRIC_MPC),
                         (bench_quadrotor, METRIC_QUAD),
                         (bench_headline, METRIC_HEADLINE)):
        try:
            tier()
        except Exception as e:  # noqa: BLE001 — tier isolation is the point
            failures += 1
            traceback.print_exc()
            _emit(metric, None, error=f"{type(e).__name__}: {e}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

"""Long-horizon f32 evidence: lane-tier f32 solves vs the XLA f64 path.

The lane fast path is f32-only by design (SURVEY.md §7 hard part (c));
this probe measures what that costs at long horizons. For each benchmark
(pendcart ±5, LTI n=10 m=2 — the reference's two demo problems) and each
horizon T it solves the SAME scenarios twice:

  * ``lanes``  — `ilqg_batch_lanes`, f32, on the default backend (a GPU),
  * ``xla64``  — vmapped `ilqg`, f64, on CPU (in-process platform switch),

then compares final total cost, iterations-to-converge, and exit reasons.
Bitwise parity is not expected (CLAUDE.md: boxQP active-set chatter
amplifies f32 noise at long horizons) — the claim under test is that
solver-level OUTCOMES agree: the f32 cost drift stays within ~1e-4
relative, i.e. f32 lanes are production-adequate without an f64 variant.

Each leg runs in its own subprocess (backend + x64 configs are global);
``compare`` mode orchestrates and prints the drift tables. Only the
``lanes`` leg opens the card, so the legs never share it.

A third leg, ``xla32`` (vmapped `ilqg`, f32, CPU), splits the total drift
into precision-alone (xla32 vs xla64, same algorithm) and
implementation-at-equal-precision (lanes vs xla32) components.

Usage:
  python tools/probe_f32_drift.py compare [T ...]     # default 1000 3000 10000
  python tools/probe_f32_drift.py {lanes|xla32|xla64} OUT.json T...
Leg outputs go to chiprun_out/ in the checkout; with DRIFT_REUSE=1,
compare reuses any leg output already there.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B = 8                       # scenarios; f64 CPU at T=10000 bounds this
MAX_ITER = 100
LIMS_PC = 5.0


def _scenarios(bench, T, dtype):
    """Deterministic shared inputs, generated in numpy f64 then cast."""
    rng = np.random.default_rng(12345)
    if bench == "pendcart":
        x0 = np.array([np.pi - 0.6, 0.0, 0.0, 0.0])   # default_x0
        x0s = x0[None, :] + (0.2 * rng.standard_normal((B, 4))
                             * np.array([1.0, 1.0, 0.0, 0.0]))
        u0s = np.zeros((B, T, 1))
    else:                       # lti
        x0s = np.ones((B, 10)) * np.linspace(0.5, 2.0, B)[:, None]
        u0s = 0.1 * rng.standard_normal((B, T, 2))
    return x0s.astype(dtype), u0s.astype(dtype)


def _cfg():
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (
        ILQGConfig, default_alphas)
    return ILQGConfig(alphas=default_alphas(0.2, -3.0, 6), reg_type=2,
                      lam_max=1e15, max_iter=MAX_ITER,
                      iter_cap=2 * MAX_ITER)


def _lti_spec(dtype):
    """Reference-construction LTI spec with the matrices generated ONCE in
    NumPy f64 and cast to the leg dtype. (`random_lti` draws with
    jax.random in the requested dtype, and jax.random.normal consumes
    different bits in f32 vs f64 — the legs would solve different
    problems; the first probe run hit exactly that: a 20–43% apparent
    "drift" that was two different random A/B matrices.) MUST stay in
    sync with tests/test_ilqg_linear._fixed_lti_spec, which pins this
    construction for the tol_fun_effective regression test."""
    import jax.numpy as jnp
    import scipy.linalg
    from differentialdynamicprogramming_jl_tpu.models.linear import LTISpec
    n, m, h = 10, 2, 0.01
    rng = np.random.default_rng(7)
    M = rng.standard_normal((n, n))
    A = scipy.linalg.expm(h * (M - M.T))
    B = h * rng.standard_normal((n, m))
    return LTISpec(A=jnp.asarray(A, dtype), B=jnp.asarray(B, dtype),
                   Q=jnp.asarray(h * np.eye(n), dtype),
                   R=jnp.asarray(0.1 * h * np.eye(m), dtype),
                   x0=jnp.ones((n,), dtype),
                   u0=jnp.zeros((8, m), dtype))   # unused by the probe


def run_lanes(out_path, Ts):
    import jax
    # DRIFT_SMOKE=1: interpret-mode CPU smoke run (tiny T, tiny k_t) to
    # validate this leg end-to-end before spending card time on it
    smoke = bool(os.environ.get("DRIFT_SMOKE"))
    if smoke:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, pendcart_lanes, pendcart_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        lti_lanes, lti_derivs_tiles)
    from differentialdynamicprogramming_jl_tpu.solvers.batch import (
        ilqg_batch_lanes)

    kw = (dict(interpret=True, kt_backward=4, kt_forward=4) if smoke
          else {})
    cfg = _cfg()
    if smoke:   # wiring check only — tiny iteration budget
        import dataclasses
        cfg = dataclasses.replace(cfg, max_iter=3, iter_cap=5)
    spec_pc = PendCartSpec()
    model_pc = pendcart_lanes(spec_pc)
    tiles_pc = pendcart_derivs_tiles(spec_pc)
    spec_lti = _lti_spec(jnp.float32)
    model_lti = lti_lanes(spec_lti)
    tiles_lti = lti_derivs_tiles(spec_lti)

    out = {}
    for bench in ("pendcart", "lti"):
        for T in Ts:
            x0s, u0s = _scenarios(bench, T, np.float32)
            t0 = time.perf_counter()
            if bench == "pendcart":
                res = ilqg_batch_lanes(
                    model_pc, None, jnp.asarray(x0s), jnp.asarray(u0s),
                    lims=((-LIMS_PC, LIMS_PC),), cfg=cfg,
                    derivs_tiles=tiles_pc, **kw)
            else:
                # ±0.6 limits: active boxQP sets are where f32 noise bites
                res = ilqg_batch_lanes(
                    model_lti, None, jnp.asarray(x0s), jnp.asarray(u0s),
                    lims=((-0.6, 0.6), (-0.6, 0.6)), cfg=cfg,
                    derivs_tiles=tiles_lti, **kw)
            cost = np.asarray(res.cost_total, np.float64)
            dt = time.perf_counter() - t0
            out[f"{bench}:{T}"] = {
                "cost": cost.tolist(),
                "iters": np.asarray(res.n_accepted).tolist(),
                "total_iters": np.asarray(res.n_iters).tolist(),
                "reason": np.asarray(res.reason).tolist(),
                "wall_s": round(dt, 1),
            }
            print(f"[lanes f32/{jax.default_backend()}] {bench} T={T}: "
                  f"mean cost {cost.mean():.6f}  ({dt:.0f}s incl compile)",
                  flush=True)
    json.dump(out, open(out_path, "w"))


def run_xla64(out_path, Ts, x64=True):
    import jax
    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from differentialdynamicprogramming_jl_tpu.models.pendcart import (
        PendCartSpec, make_pendcart_problem)
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        make_lti_problem)
    from differentialdynamicprogramming_jl_tpu.solvers.ilqg import ilqg

    dt_ = jnp.float64 if x64 else jnp.float32
    np_dt = np.float64 if x64 else np.float32
    cfg = _cfg()
    spec_pc = PendCartSpec()
    prob_pc = make_pendcart_problem(spec_pc, derivs="euler", dtype=dt_)
    lims_pc = jnp.array([[-LIMS_PC, LIMS_PC]], dt_)
    spec_lti = _lti_spec(dt_)

    out = {}
    for bench in ("pendcart", "lti"):
        for T in Ts:
            x0s, u0s = _scenarios(bench, T, np_dt)
            t0 = time.perf_counter()
            if bench == "pendcart":
                res = jax.vmap(lambda a, b: ilqg(
                    prob_pc, a, b, lims=lims_pc, cfg=cfg))(
                        jnp.asarray(x0s), jnp.asarray(u0s))
            else:
                prob = make_lti_problem(spec_lti, T)
                lims = jnp.array([[-0.6, 0.6]] * 2, dt_)
                res = jax.vmap(lambda a, b: ilqg(
                    prob, a, b, lims=lims, cfg=cfg))(
                    jnp.asarray(x0s), jnp.asarray(u0s))
            cost = np.asarray(jnp.sum(res.cost, -1), np.float64)
            dt = time.perf_counter() - t0
            out[f"{bench}:{T}"] = {
                "cost": cost.tolist(),
                "iters": np.asarray(res.n_accepted).tolist(),
                "total_iters": np.asarray(res.n_iters).tolist(),
                "reason": np.asarray(res.reason).tolist(),
                "wall_s": round(dt, 1),
            }
            tag = "f64" if x64 else "f32"
            print(f"[xla {tag}/cpu] {bench} T={T}: "
                  f"mean cost {cost.mean():.6f}  ({dt:.0f}s)", flush=True)
    json.dump(out, open(out_path, "w"))


def _drift_rows(a, b):
    rows = []
    for k in a:
        ca = np.array(a[k]["cost"])
        cb = np.array(b[k]["cost"])
        drift = np.max(np.abs(ca - cb) / np.abs(cb))
        agree = int(np.sum(np.array(a[k]["reason"])
                           == np.array(b[k]["reason"])))
        rows.append(f"| {k.split(':')[0]} | {k.split(':')[1]} | {drift:.2e} "
                    f"| {np.mean(a[k]['iters']):.1f} / "
                    f"{np.mean(b[k]['iters']):.1f} | {agree}/{len(ca)} |")
    return rows


def compare(Ts):
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    paths = {m: os.path.join(out, f"drift_{m}.json")
             for m in ("xla64", "xla32", "lanes")}
    env = dict(os.environ)
    for mode, path in paths.items():
        if os.environ.get("DRIFT_REUSE") and os.path.exists(path):
            continue
        r = subprocess.run(
            [sys.executable, __file__, mode, path] + [str(t) for t in Ts],
            env=env)
        if r.returncode != 0:
            sys.exit(f"{mode} leg failed")
    lanes = json.load(open(paths["lanes"]))
    x64 = json.load(open(paths["xla64"]))
    x32 = json.load(open(paths["xla32"]))
    hdr = ("| bench | T | max |Δcost|/cost | mean iters {} "
           "| reasons agree |\n|---|---|---|---|---|")
    print("\nlanes f32 (GPU) vs XLA f64 (total drift):")
    print(hdr.format("lanes/f64"))
    print("\n".join(_drift_rows(lanes, x64)))
    print("\nXLA f32 vs XLA f64 (precision alone, same algorithm):")
    print(hdr.format("f32/f64"))
    print("\n".join(_drift_rows(x32, x64)))
    print("\nlanes f32 (GPU) vs XLA f32 (implementation at equal precision):")
    print(hdr.format("lanes/xla32"))
    print("\n".join(_drift_rows(lanes, x32)))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "compare"
    if mode == "compare":
        ts = [int(t) for t in sys.argv[2:]] or [1000, 3000, 10000]
        compare(ts)
    elif mode == "lanes":
        run_lanes(sys.argv[2], [int(t) for t in sys.argv[3:]])
    elif mode == "xla32":
        run_xla64(sys.argv[2], [int(t) for t in sys.argv[3:]], x64=False)
    else:
        run_xla64(sys.argv[2], [int(t) for t in sys.argv[3:]])

"""One process of a simulated 2-host cluster (spawned by test_multihost.py).

Each worker owns 4 virtual CPU devices; the two workers form one 8-device
global mesh connected by gloo cross-process collectives — the CPU stand-in
for a multi-host accelerator cluster (SURVEY.md §4's fake-multi-device trick
extended across process boundaries, SURVEY.md §7 step 7).

Protocol: argv = (process_id, num_processes, coordinator_port). Prints
``XLA_STATS ...`` / ``LANE_STATS ...`` lines the parent compares across
workers (fleet-wide psum results must be identical on every process), and
exits non-zero on any assertion failure.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

# own device count: strip any inherited forced-device-count flag first
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if not f.startswith("--xla_force_host_platform_device_count")]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=4"])

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# share the suite's persistent compile cache (tests/conftest.py) — the
# workers are fresh processes and would otherwise recompile both solver
# tiers every run; concurrent writers are safe (atomic renames)
from differentialdynamicprogramming_jl_tpu.runtime import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

from differentialdynamicprogramming_jl_tpu.parallel import (  # noqa: E402
    distributed as D)

D.init_distributed(f"localhost:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 4 * nproc
assert D.is_multiprocess()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from differentialdynamicprogramming_jl_tpu import ILQGConfig  # noqa: E402
from differentialdynamicprogramming_jl_tpu.models.linear import (  # noqa: E402
    random_lti, make_lti_problem)
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (  # noqa: E402
    ilqg_batched, ilqg_sharded, ilqg_batch_sharded)

mesh = D.global_mesh()
assert mesh.devices.size == 4 * nproc

# ---- XLA tier: 16-scenario LTI fleet sharded over the 2-process mesh -----
T, B = 40, 16
spec = random_lti(jax.random.PRNGKey(0), n=6, m=2, T=T, dtype=jnp.float64)
prob = make_lti_problem(spec, T)
x0s_full = (np.tile(np.asarray(spec.x0), (B, 1))
            * np.linspace(0.5, 2.0, B)[:, None])
u0s_full = np.tile(np.asarray(spec.u0), (B, 1, 1))
Bl = B // nproc
sl = slice(pid * Bl, (pid + 1) * Bl)
x0s = D.distribute_batch(x0s_full[sl], mesh)
u0s = D.distribute_batch(u0s_full[sl], mesh)
cfg = ILQGConfig(max_iter=10)

res, stats = ilqg_sharded(prob, x0s, u0s, cfg=cfg, mesh=mesh,
                          reduce_stats=True)
stats = np.asarray(stats)

# every process sees the same fleet-wide psum, and it must equal a local
# single-process full-fleet solve (per-element masking makes the math
# independent of how scenarios are grouped)
ref = ilqg_batched(prob, jnp.asarray(x0s_full), jnp.asarray(u0s_full),
                   cfg=cfg)
ref_cost = float(jnp.sum(ref.cost))
assert abs(float(stats[0]) - ref_cost) < 1e-9 * max(1.0, abs(ref_cost)), (
    float(stats[0]), ref_cost)
assert int(stats[1]) == int(jnp.sum(ref.n_iters))

# this process's rows round-trip through the global array
np.testing.assert_allclose(D.local_slice(res.u)[:, 0],
                           np.asarray(ref.u)[sl][:, 0], atol=1e-9)

print(f"XLA_STATS cost={float(stats[0]):.12g} iters={int(stats[1])} "
      f"solved={int(stats[2])}", flush=True)

# ---- flagship tier: Pallas lane driver (interpret mode) over the mesh ----
from differentialdynamicprogramming_jl_tpu.models.pendcart import (  # noqa: E402
    PendCartSpec, default_x0, pendcart_lanes, pendcart_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.solvers.ilqg import (  # noqa: E402
    default_alphas)

pspec = PendCartSpec()
Bp, Tp = 8, 6
x0p_full = np.asarray(
    default_x0(jnp.float32)[None, :]
    + 0.1 * jax.random.normal(jax.random.PRNGKey(1), (Bp, 4), jnp.float32))
u0p_full = np.zeros((Bp, Tp, 1), np.float32)
Bpl = Bp // nproc
slp = slice(pid * Bpl, (pid + 1) * Bpl)
x0p = D.distribute_batch(x0p_full[slp].astype(np.float32), mesh)
u0p = D.distribute_batch(u0p_full[slp].astype(np.float32), mesh)
cfgp = ILQGConfig(alphas=default_alphas(0.2, -3.0, 3), reg_type=2,
                  max_iter=2, iter_cap=3)
resl, statsl = ilqg_batch_sharded(
    pendcart_lanes(pspec), None, x0p, u0p, lims=((-5.0, 5.0),), cfg=cfgp,
    mesh=mesh, derivs_tiles=pendcart_derivs_tiles(pspec),
    kt_backward=2, kt_forward=2, reduce_stats=True, interpret=True)
statsl = np.asarray(statsl)
assert np.all(np.isfinite(statsl)), statsl
assert np.all(np.isfinite(D.local_slice(resl.u)))

print(f"LANE_STATS cost={float(statsl[0]):.9g} iters={int(statsl[1])} "
      f"solved={int(statsl[2])}", flush=True)

# ---- fleet scheduler × mesh: per-shard straggler compaction --------------
from differentialdynamicprogramming_jl_tpu.solvers.fleet import (  # noqa: E402
    ilqg_fleet_sharded)
from differentialdynamicprogramming_jl_tpu.solvers.batch import (  # noqa: E402
    ilqg_batch_lanes)
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

resf = ilqg_fleet_sharded(
    pendcart_lanes(pspec), None,
    x0p_full[slp].astype(np.float32), u0p_full[slp].astype(np.float32),
    lims=((-5.0, 5.0),), cfg=cfgp, derivs_tiles=pendcart_derivs_tiles(pspec),
    chunk_iters=1, kt_backward=2, kt_forward=2, interpret=True, mesh=mesh)
# per-scenario exactness vs a local single-process lock-step solve of the
# FULL fleet (chunked+compacted resume ≡ one uninterrupted solve)
reff = ilqg_batch_lanes(
    pendcart_lanes(pspec), None, jnp.asarray(x0p_full),
    jnp.asarray(u0p_full), lims=((-5.0, 5.0),), cfg=cfgp,
    derivs_tiles=pendcart_derivs_tiles(pspec), kt_backward=2, kt_forward=2,
    interpret=True)
np.testing.assert_array_equal(D.local_slice(resf.reason),
                              np.asarray(reff.reason)[slp])
np.testing.assert_allclose(D.local_slice(resf.cost_total),
                           np.asarray(reff.cost_total)[slp], rtol=1e-5)
np.testing.assert_allclose(D.local_slice(resf.u),
                           np.asarray(reff.u)[slp], atol=1e-4)
# replicated fleet-wide stat — must print identically on every process
_psum = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, PartitionSpec()))
print(f"FLEET_STATS cost={float(_psum(resf.cost_total)):.9g} "
      f"iters={int(_psum(resf.n_iters))}", flush=True)

# ---- GPS/KL tier: lane iLQGkl driver (interpret mode) over the mesh ------
from differentialdynamicprogramming_jl_tpu.models.pendcart import (  # noqa: E402
    make_pendcart_problem)
from differentialdynamicprogramming_jl_tpu.ops.forward import (  # noqa: E402
    forward_pass)
from differentialdynamicprogramming_jl_tpu.policy import (  # noqa: E402
    GaussianPolicy)
from differentialdynamicprogramming_jl_tpu.solvers.ilqgkl import (  # noqa: E402
    ILQGKLConfig)
from differentialdynamicprogramming_jl_tpu.parallel.mesh import (  # noqa: E402
    ilqgkl_batch_sharded)

prob32 = make_pendcart_problem(pspec, derivs="euler", dtype=jnp.float32)
u0k_full = np.asarray(0.1 * jax.random.normal(
    jax.random.PRNGKey(2), (Bp, Tp, 1), jnp.float32))
rok = jax.vmap(lambda a, b: forward_pass(prob32, a, b))(
    jnp.asarray(x0p_full), jnp.asarray(u0k_full))
prev_full = GaussianPolicy.zeros(Tp, 4, 1, jnp.float32)
prev_full = jax.tree_util.tree_map(
    lambda a: np.broadcast_to(np.asarray(a), (Bp,) + a.shape), prev_full)
prev_full = prev_full._replace(k=np.asarray(rok.u))
dk = jax.vmap(prob32.make_derivs())(rok.x, rok.u)
cost0_full = np.asarray(jnp.sum(rok.cost, -1))

# per-process local slices of every batch-leading input → global arrays
xk = D.distribute_batch(np.asarray(rok.x)[slp], mesh)
prevk = jax.tree_util.tree_map(
    lambda a: D.distribute_batch(a[slp], mesh), prev_full)
fxk = D.distribute_batch(np.asarray(dk.fx)[slp], mesh)
ck = D.distribute_batch(cost0_full[slp], mesh)
resk, statsk = ilqgkl_batch_sharded(
    pendcart_lanes(pspec), pendcart_derivs_tiles(pspec), xk, prevk, fxk, ck,
    cfg=ILQGKLConfig(kl_step=2.0, max_iter=2), kt=2, mesh=mesh,
    reduce_stats=True, interpret=True)
statsk = np.asarray(statsk)
assert np.all(np.isfinite(statsk)), statsk
assert np.all(np.isfinite(D.local_slice(resk.u)))

print(f"KL_STATS cost={float(statsk[0]):.9g} iters={int(statsk[1])} "
      f"satisfied={int(statsk[2])}", flush=True)
print(f"WORKER {pid} OK", flush=True)

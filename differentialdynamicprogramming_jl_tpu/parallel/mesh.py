"""Multi-device execution: scenario-batch data parallelism over a mesh.

The reference is single-process, CPU-only, with strictly sequential loops
(``src/backward_pass.jl:102``, ``src/forward_pass.jl:16`` — SURVEY.md §2
"Parallelism: ABSENT"). This design scales the *scenario axis*:
thousands of independent iLQG solves (varied x0 / targets / dynamics params)
are vmapped per device and sharded across a 1-D device mesh with
``shard_map``. Each shard's outer ``while_loop`` runs independently — no
cross-device synchronization per iteration (solves are embarrassingly
parallel); only scalar convergence statistics are reduced with ``psum``
when requested. The mesh is flat: on a host whose cards are joined all to
all (NVLink), every pair is equally close, so the mesh follows the batch
axis alone.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem import Problem
from ..solvers.ilqg import ILQGConfig, ILQGResult, ilqg


def make_mesh(n_devices: Optional[int] = None, axis: str = "b") -> Mesh:
    """1-D mesh over the scenario-batch axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def ilqg_batched(problem: Problem, x0s: jax.Array, u0s: jax.Array,
                 lims: Optional[jax.Array] = None,
                 cfg: ILQGConfig = ILQGConfig(),
                 cost0: Optional[jax.Array] = None,
                 lam0: Optional[jax.Array] = None,
                 dlam0: Optional[jax.Array] = None,
                 accepted0: Optional[jax.Array] = None) -> ILQGResult:
    """vmap the full solver over a leading scenario axis of ``x0s``/``u0s``.

    Each scenario keeps its own λ/α/termination state; JAX's while-loop
    batching runs until every scenario is done (lock-step with per-element
    masking) — the single-device building block for :func:`ilqg_sharded`.

    Warm start / resume at fleet scale (reference semantics
    ``src/iLQG.jl:85-87,193-197``, mirroring the lane tier's entries):
    ``x0s`` may be pre-rolled (B, T, n) trajectories with optional per-step
    ``cost0`` (B, T); ``lam0``/``dlam0``/``accepted0`` (B,) resume the λ
    schedule and iteration budget from a prior result. ``lims`` may be
    fleet-wide (m, 2) or per-scenario (B, m, 2).
    """
    per_lims = lims is not None and jnp.asarray(lims).ndim == 3
    in_axes = (0, 0, 0 if per_lims else None,
               0 if cost0 is not None else None,
               0 if lam0 is not None else None,
               0 if dlam0 is not None else None,
               0 if accepted0 is not None else None)
    return jax.vmap(
        lambda x0, u0, l, c0, l0, d0, a0: ilqg(
            problem, x0, u0, lims=l, cfg=cfg, cost0=c0,
            lam0=l0, dlam0=d0, accepted0=a0),
        in_axes=in_axes)(x0s, u0s, lims, cost0, lam0, dlam0, accepted0)


def ilqg_sharded(problem: Problem, x0s: jax.Array, u0s: jax.Array,
                 lims: Optional[jax.Array] = None,
                 cfg: ILQGConfig = ILQGConfig(),
                 mesh: Optional[Mesh] = None,
                 axis: str = "b",
                 reduce_stats: bool = False,
                 cost0: Optional[jax.Array] = None,
                 lam0: Optional[jax.Array] = None,
                 dlam0: Optional[jax.Array] = None,
                 accepted0: Optional[jax.Array] = None):
    """Shard a scenario batch over a device mesh and solve.

    ``shard_map`` gives each device an independent program: per-shard
    while-loops run to their own trip counts (no lock-step across devices,
    unlike a vmapped-then-pjit solve) and nothing crosses devices during the
    solve. With ``reduce_stats=True`` the per-shard mean cost / iteration
    counts are ``psum``-reduced over the mesh (trace-reduction pattern,
    SURVEY.md §5) and returned alongside.

    Warm start / resume: as :func:`ilqg_batched` — pre-rolled ``x0s`` +
    ``cost0`` and the (B,) ``lam0``/``dlam0``/``accepted0`` counters ride
    sharded ``P(axis)``, so MPC re-rolls and fleet resumes run on the
    portable tier across devices too.

    The batch axis must divide the mesh size. Returns an :class:`ILQGResult`
    with leading batch axis (sharded) and, optionally, the reduced stats.
    """
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_dev = mesh.devices.size
    B = x0s.shape[0]
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    per_lims = lims is not None and jnp.asarray(lims).ndim == 3
    opt = {"cost0": cost0, "lam0": lam0, "dlam0": dlam0,
           "accepted0": accepted0}
    opt_keys = tuple(k for k, v in opt.items() if v is not None)
    fn = _sharded_xla_solver(problem, cfg, mesh, axis, reduce_stats,
                             lims is not None, per_lims, opt_keys)
    args = (x0s, u0s)
    if lims is not None:
        args += (jnp.asarray(lims),)
    args += tuple(opt[k] for k in opt_keys)
    return fn(*args)


@functools.lru_cache(maxsize=64)
def _sharded_xla_solver(problem, cfg, mesh, axis, reduce_stats, has_lims,
                        per_lims=False, opt_keys=()):
    """Build (and cache — jit caches by function identity, so a fresh
    closure per call would silently recompile every solve) the jitted
    shard_map'd XLA-tier solver. ``lims`` rides as a replicated traced
    argument (or sharded, when per-scenario) so differing limit values hit
    the same compile; ``opt_keys`` names the warm-start/resume inputs
    present (each sharded ``P(axis)``)."""

    def solve_shard(x0_shard, u0_shard, *rest):
        rest = list(rest)
        lims = rest.pop(0) if has_lims else None
        kw = dict(zip(opt_keys, rest))
        res = ilqg_batched(problem, x0_shard, u0_shard, lims=lims, cfg=cfg,
                           **kw)
        if not reduce_stats:
            return res
        # scalar convergence stats over the whole fleet: one psum
        local_cost = jnp.sum(jnp.sum(res.cost, axis=-1))
        local_iters = jnp.sum(res.n_iters)
        local_solved = jnp.sum((res.reason == 1) | (res.reason == 2))
        stats = jnp.stack([local_cost,
                           local_iters.astype(x0_shard.dtype),
                           local_solved.astype(x0_shard.dtype)])
        stats = jax.lax.psum(stats, axis)
        return res, stats

    res_specs = jax.tree_util.tree_map(lambda _: P(axis),
                                       _result_structure())
    out_specs = (res_specs, P()) if reduce_stats else res_specs
    in_specs = ((P(axis), P(axis))
                + ((P(axis) if per_lims else P(),) if has_lims else ())
                + (P(axis),) * len(opt_keys))
    return jax.jit(jax.shard_map(solve_shard, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def ilqg_batch_sharded(model, packed_derivs, x0s: jax.Array, u0s: jax.Array,
                       lims=None,
                       cfg: Optional["ILQGConfig"] = None,
                       mesh: Optional[Mesh] = None,
                       axis: str = "b",
                       reduce_stats: bool = False,
                       derivs_tiles=None,
                       kt_backward: int = 1,
                       kt_forward: int = 1,
                       interpret: bool = False):
    """Shard the **lane-layout Pallas fast path**
    (:func:`~..solvers.batch.ilqg_batch_lanes`) over a device mesh.

    Each device runs the full batched solver on its scenario shard (B/n_dev
    scenarios, padded per-device to the lane tile); nothing crosses devices
    during the solve. With ``reduce_stats=True`` fleet-level scalars
    (total cost, iterations, solved count) are ``psum``-reduced over the mesh.

    ``model``: :class:`~..ops.pallas.forward_kernel.LanesModel`;
    ``packed_derivs``: lane-layout derivative generator; ``lims``: static
    ``((lo, hi),)*m``, a per-scenario (B, m, 2) array (sharded ``P(axis)``
    like every batch-leading input), or None.
    """
    from ..solvers.ilqg import ILQGConfig
    from ..solvers.batch import split_lims
    if cfg is None:
        cfg = ILQGConfig()
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_dev = mesh.devices.size
    B = x0s.shape[0]
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    lims, lims_batch = split_lims(lims)
    fn = _sharded_lane_solver(model, packed_derivs, derivs_tiles, lims, cfg,
                              mesh, axis, reduce_stats, kt_backward,
                              kt_forward, interpret,
                              lims_batch is not None)
    args = (x0s, u0s) + ((lims_batch,) if lims_batch is not None else ())
    return fn(*args)


@functools.lru_cache(maxsize=64)
def _sharded_lane_solver(model, packed_derivs, derivs_tiles, lims, cfg,
                         mesh, axis, reduce_stats, kt_backward, kt_forward,
                         interpret, has_lims_batch=False):
    """Build (and cache — jit caches by function identity, so a fresh
    closure per call would recompile every solve) the jitted shard_map'd
    lane solver."""
    from ..solvers.batch import _ilqg_batch_lanes_jit, BatchILQGResult

    def solve_shard(x0_shard, u0_shard, *maybe_lims):
        lims_b = maybe_lims[0] if has_lims_batch else None
        res = _ilqg_batch_lanes_jit(model, packed_derivs, x0_shard, u0_shard,
                                    lims=lims, lims_batch=lims_b, cfg=cfg,
                                    derivs_tiles=derivs_tiles,
                                    max_steps=jnp.int32(cfg.cap() - 1),
                                    kt_backward=kt_backward,
                                    kt_forward=kt_forward,
                                    interpret=interpret)
        if not reduce_stats:
            return res
        stats = jnp.stack([
            jnp.sum(res.cost_total),
            jnp.sum(res.n_iters).astype(x0_shard.dtype),
            jnp.sum((res.reason == 1) | (res.reason == 2)
                    ).astype(x0_shard.dtype)])
        return res, jax.lax.psum(stats, axis)

    res_specs = BatchILQGResult(
        x=P(axis), u=P(axis), policy=_gp_skel()._replace(
            K=P(axis), k=P(axis), sigma=P(axis), sigma_inv=P(axis)),
        Vx=P(axis), Vxx=P(axis), cost=P(axis), cost_total=P(axis),
        n_iters=P(axis), n_accepted=P(axis), reason=P(axis), lam=P(axis),
        dlam=P(axis), g_norm=P(axis))
    out_specs = (res_specs, P()) if reduce_stats else res_specs
    in_specs = (P(axis), P(axis)) + ((P(axis),) if has_lims_batch else ())
    return jax.jit(jax.shard_map(solve_shard, mesh=mesh,
                                 in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def ilqgkl_batch_sharded(model, derivs_tiles, x0s: jax.Array, traj_prev,
                         fx_model: jax.Array, cost0: jax.Array,
                         lims=None,
                         cfg=None,
                         r1=None,
                         kt: int = 1,
                         mesh: Optional[Mesh] = None,
                         axis: str = "b",
                         reduce_stats: bool = False,
                         record_trace: bool = False,
                         interpret: bool = False):
    """Shard the **GPS/KL lane fast path**
    (:func:`~..solvers.batch_kl.ilqgkl_batch_lanes`) over a device mesh —
    the fleet-scale ``iLQGkl`` (reference ``src/iLQGkl.jl:25-252``) over
    several cards.

    Arguments mirror :func:`~..solvers.batch_kl.ilqgkl_batch_lanes`:
    ``x0s`` (B, T, n) pre-rolled trajectories, ``traj_prev`` a
    :class:`GaussianPolicy` with (B, T, ...) leaves (the trust-region
    center), ``fx_model`` (B, T, n, n) model linearizations, ``cost0`` (B,).
    Every batch-leading input is sharded ``P(axis)``; each device runs the
    full KL-constrained solve on its scenario shard — per-scenario η
    brackets and divergence retries never cross devices. With
    ``reduce_stats=True`` the fleet scalars (total cost, iterations,
    satisfied count) are ``psum``-reduced over the mesh and returned
    alongside, replicated on every device/process.
    """
    from ..solvers.ilqgkl import ILQGKLConfig
    from ..solvers.batch import split_lims
    if cfg is None:
        cfg = ILQGKLConfig()
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_dev = mesh.devices.size
    B = x0s.shape[0]
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    lims, lims_batch = split_lims(lims)
    fn = _sharded_kl_solver(model, derivs_tiles, lims, cfg, r1, kt, mesh,
                            axis, reduce_stats, record_trace, interpret,
                            lims_batch is not None)
    args = (x0s, traj_prev, fx_model, cost0) + (
        (lims_batch,) if lims_batch is not None else ())
    return fn(*args)


@functools.lru_cache(maxsize=64)
def _sharded_kl_solver(model, derivs_tiles, lims, cfg, r1, kt, mesh, axis,
                       reduce_stats, record_trace, interpret,
                       has_lims_batch=False):
    """Build (and cache — jit caches by function identity, so a fresh
    closure per call would recompile every solve) the jitted shard_map'd
    KL-tier lane solver."""
    from ..solvers.batch_kl import _ilqgkl_batch_lanes_jit, BatchKLResult
    from ..solvers.batch_kl import BatchKLTrace

    def solve_shard(x0_shard, prev_shard, fx_shard, cost0_shard,
                    *maybe_lims):
        lims_b = maybe_lims[0] if has_lims_batch else None
        res = _ilqgkl_batch_lanes_jit(
            model, derivs_tiles, x0_shard, prev_shard,
            fx_shard, cost0_shard, lims=lims, lims_batch=lims_b, cfg=cfg,
            r1=r1, kt=kt, record_trace=record_trace,
            interpret=interpret)
        if not reduce_stats:
            return res
        stats = jnp.stack([
            jnp.sum(res.cost_total),
            jnp.sum(res.n_iters).astype(x0_shard.dtype),
            jnp.sum(res.satisfied).astype(x0_shard.dtype)])
        return res, jax.lax.psum(stats, axis)

    res_specs = BatchKLResult(
        x=P(axis), u=P(axis), policy=_gp_skel()._replace(
            K=P(axis), k=P(axis), sigma=P(axis), sigma_inv=P(axis)),
        cost=P(axis), cost_total=P(axis), eta=P(axis), divergence=P(axis),
        satisfied=P(axis), kl_violated=P(axis), n_iters=P(axis),
        pd_failed=P(axis),
        bracket=P(axis), delta=P(axis), adam=P(axis), done=P(axis),
        trace=(BatchKLTrace(*([P(axis)] * len(BatchKLTrace._fields)))
               if record_trace else None))
    out_specs = (res_specs, P()) if reduce_stats else res_specs
    gp_in = _gp_skel()._replace(K=P(axis), k=P(axis), sigma=P(axis),
                                sigma_inv=P(axis))
    in_specs = (P(axis), gp_in, P(axis), P(axis)) + (
        (P(axis),) if has_lims_batch else ())
    return jax.jit(jax.shard_map(
        solve_shard, mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs, check_vma=False))


def _result_structure():
    """Abstract pytree skeleton of ILQGResult for out_specs construction."""
    return ILQGResult(x=0, u=0, policy=type(
        "GP", (), {})() if False else _gp_skel(), Vx=0, Vxx=0, cost=0,
        trace=_trace_skel(), n_iters=0, n_accepted=0, reason=0, lam=0,
        g_norm=0, dlam=0)


def _gp_skel():
    from ..policy import GaussianPolicy
    return GaussianPolicy(K=0, k=0, sigma=0, sigma_inv=0)


def _trace_skel():
    from ..policy import Trace
    return Trace(*([0] * len(Trace._fields)))

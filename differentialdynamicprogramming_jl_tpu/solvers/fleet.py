"""Fleet scheduler: straggler-compacting batched solves.

Motivation: the lane driver's lock-step while_loop runs every kernel over
the FULL fleet until the slowest scenario exits, so a slow tail of
scenarios makes the whole fleet pay its iteration count. This module
is the runtime layer on top: solve in bounded chunks, compact the
unfinished scenarios into a smaller (tile-aligned) batch, and continue ONLY
them, using the lane driver's resume entry (pre-rolled trajectory + carried
λ/dλ/accepted counters), so the composition is semantically one
uninterrupted solve per scenario.

Scope — read before reaching for this: an f32 pathology that once made the
iteration tail long (`dcost < tol_fun` unreachable in f32) is fixed at the
source by `tol_fun_effective`, which shrank the spread this scheduler
feeds on. Each chunk costs one host round trip, so compaction pays only
when (solve wall time) ≫ (chunks × dispatch latency). Use lock-step
(`ilqg_batch_lanes`) by default and size `chunk_iters` near the fleet's
median; whether the scheduler wins on the GPU is not measured yet
(ROADMAP).

The reference has no analogue (single-problem library); this is the
fleet-throughput component the framework adds. Performance rules it obeys
(see CLAUDE.md):

- the chunk length is a TRACED scalar (`max_steps`), so every chunk — and a
  user's plain lock-step solve with the same cfg — shares one compiled
  program per batch size (a static per-chunk iter_cap cold-compiles the
  whole driver for minutes per value);
- compacted batches are padded to the lane tile (``pack.B_TILE``) on the
  host, so all
  straggler chunks share one executable (at most two programs total:
  cold-entry at B, resume-entry at the padded straggler size);
- trajectory-sized state (x, u, Vxx, policy, …) never leaves the device
  between chunks — gather/scatter run as XLA ops with the padded index set
  (duplicate pad indices re-solve the same scenario, so duplicate scatter
  writes are identical); only (B,)-sized vectors cross to the host.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .batch import BatchILQGResult, ilqg_batch_lanes
from .ilqg import ILQGConfig
from ..ops.pallas.pack import B_TILE

_BIG = ("x", "u", "Vx", "Vxx", "cost")
_POL = ("K", "k", "sigma", "sigma_inv")
_SMALL = ("cost_total", "n_iters", "n_accepted", "reason", "lam", "dlam",
          "g_norm")


@jax.jit
def _pack_small(res):
    """All (B,)-sized result fields as ONE f32 matrix — a single host fetch
    per chunk instead of seven (each fetch is a host round trip)."""
    return jnp.stack([jnp.asarray(getattr(res, f), jnp.float32)
                      for f in _SMALL])


def _stitch_traces(trace_np, sub_trace, idx, prior_iters, sub_iters, cap,
                   fields):
    """Splice a resumed chunk's per-scenario trace rows into the global
    record at each scenario's iteration offset — vectorized (the original
    per-scenario Python loop was O(B) host work per chunk, ugly at 64k).

    ``sub_trace``: (n_fields, kp, cap); rows ``idx`` (k ≤ kp real rows)
    land at columns ``prior+1 .. prior+sub_iters`` (clipped to cap-1)."""
    k = len(idx)
    prior = prior_iters.astype(np.int64)                      # (k,)
    t = np.minimum(sub_iters.astype(np.int64), cap - 1 - prior)
    cols = np.arange(cap)[None, :]                            # (1, cap)
    src = cols - prior[:, None]                               # (k, cap)
    sel = (src >= 1) & (src <= t[:, None])
    src_c = np.clip(src, 0, cap - 1)
    rows = np.arange(k)[:, None]
    for fi, f in enumerate(fields):
        cur = trace_np[f][idx]                                # (k, cap)
        moved = sub_trace[fi, :k][rows, src_c]                # (k, cap)
        trace_np[f][idx] = np.where(sel, moved, cur)


@functools.lru_cache(maxsize=32)
def _chunk_runner(model, packed_derivs, derivs_tiles, lims, cfg,
                  kt_backward, kt_forward, interpret, record_trace=False):
    """One fused jitted program per straggler chunk: gather the compacted
    scenarios from device-resident fleet state, continue their solve, and
    scatter the results back — a single dispatch + a single small fetch per
    chunk instead of ~17 device ops (each op costs a dispatch)."""
    from .batch import _ilqg_batch_lanes_jit

    @jax.jit
    def step(big, pol, lam_g, dlam_g, acc_g, params_g, lims_g, gidx, steps):
        sub = _ilqg_batch_lanes_jit(
            model, packed_derivs, big["x"][gidx], big["u"][gidx],
            lims=lims, lims_batch=lims_g, cfg=cfg,
            derivs_tiles=derivs_tiles,
            params=params_g, cost0=big["cost"][gidx],
            lam0=lam_g, dlam0=dlam_g, accepted0=acc_g,
            max_steps=steps,
            kt_backward=kt_backward, kt_forward=kt_forward,
            record_trace=record_trace,
            interpret=interpret)
        new_big = {f: big[f].at[gidx].set(getattr(sub, f)) for f in _BIG}
        new_pol = {f: pol[f].at[gidx].set(getattr(sub.policy, f))
                   for f in _POL}
        tr = (jnp.stack(list(sub.trace), 0).astype(jnp.float32)
              if record_trace else jnp.zeros((), jnp.float32))
        return new_big, new_pol, _pack_small(sub), tr

    return step


def ilqg_fleet(model,
               packed_derivs: Optional[Callable],
               x0s, u0s,
               lims: Optional[Tuple[Tuple[float, float], ...]] = None,
               cfg: ILQGConfig = ILQGConfig(),
               derivs_tiles: Optional[Callable] = None,
               params=None,
               chunk_iters: int = 16,
               chunk_growth: float = 8.0,
               max_chunks: int = 32,
               kt_backward: int = 1,
               kt_forward: int = 1,
               record_trace: bool = False,
               interpret: bool = False,
               verbose: bool = False) -> BatchILQGResult:
    """Solve B scenarios to the SAME termination criteria as
    :func:`~.batch.ilqg_batch_lanes`, but without paying straggler
    lock-step: after every ``chunk_iters`` loop iterations the still-running
    scenarios are compacted into the smallest tile-aligned batch and
    continued alone.

    Single-device scheduler (one device's fleet). For a multi-device /
    multi-host mesh use :func:`ilqg_fleet_sharded`, which runs exactly this
    per-shard compaction on every shard of the mesh (scenario solves are
    independent, so per-shard scheduling is exact; cross-device scenario
    migration would trade collective traffic for tail latency and is
    deliberately not done).

    Returns a batch-major :class:`BatchILQGResult`. With
    ``record_trace=True`` the per-chunk traces are STITCHED into one
    per-scenario (B, cap) :class:`~.batch.BatchTrace` — each resumed
    chunk's rows land at the scenario's global iteration offset, so the
    record reads exactly like the lock-step driver's (the reference's
    MVHistory across one uninterrupted solve); this costs one (kp, cap)
    trace fetch per chunk, so leave it off on the throughput path.
    ``n_iters`` is the per-scenario total across chunks. ``chunk_growth``: straggler chunks lengthen
    geometrically — overshooting a chunk budget is free (the while_loop
    early-exits once every lane is done), while every extra chunk costs a
    host round trip, so large growth wins. Tune ``chunk_iters`` to just
    past the fleet's median convergence iteration.

    ``lims`` may be static ``((lo, hi),)*m`` or per-scenario (B, m, 2)
    (gathered through the compaction like ``params``).
    """
    from .batch import split_lims
    B = u0s.shape[0]
    params_np = None if params is None else np.asarray(params)
    lims, lims_batch = split_lims(lims)
    lims_np = None if lims_batch is None else np.asarray(lims_batch)

    def run(x0s_, u0s_, cost0_, lam0_, dlam0_, acc0_, params_, steps):
        return ilqg_batch_lanes(
            model, packed_derivs, x0s_, u0s_,
            lims=lims if lims_batch is None else lims_batch,
            cfg=cfg,
            derivs_tiles=derivs_tiles, params=params_, cost0=cost0_,
            lam0=lam0_, dlam0=dlam0_, accepted0=acc0_,
            max_steps=jnp.int32(steps),
            kt_backward=kt_backward, kt_forward=kt_forward,
            record_trace=record_trace,
            interpret=interpret)

    # ---- chunk 1: full fleet, cold start
    res = run(x0s, u0s, None, None, None, None, params, chunk_iters)

    big = {f: getattr(res, f) for f in _BIG}          # stays on device
    pol = {f: getattr(res.policy, f) for f in _POL}   # stays on device
    small = dict(zip(_SMALL, np.array(_pack_small(res))))  # ONE fetch

    from .batch import BatchTrace
    cap = cfg.cap()
    if record_trace:
        # chunk 1 covers the whole fleet: copy its (B, cap) record; resumed
        # chunks stitch in below at each scenario's global iteration offset
        trace_np = {f: np.array(getattr(res.trace, f))
                    for f in BatchTrace._fields}

    steps = chunk_iters
    for chunk in range(1, max_chunks):
        unfinished = small["reason"] == 0
        n_left = int(unfinished.sum())
        if verbose:
            print(f"  fleet chunk {chunk}: {n_left}/{B} scenarios "
                  f"still running")
        if n_left == 0:
            break
        steps = int(round(steps * chunk_growth))
        idx = np.flatnonzero(unfinished)
        k = len(idx)
        kp = max(B_TILE, -(-k // B_TILE) * B_TILE)
        gidx_np = np.concatenate([idx, np.repeat(idx[:1], kp - k)])
        runner = _chunk_runner(model, packed_derivs, derivs_tiles, lims,
                               cfg, kt_backward, kt_forward, interpret,
                               record_trace)
        big, pol, sub_small, sub_trace = runner(
            big, pol,
            jnp.asarray(small["lam"][gidx_np]),
            jnp.asarray(small["dlam"][gidx_np]),
            jnp.asarray(small["n_accepted"][gidx_np], dtype=np.int32),
            None if params_np is None else jnp.asarray(params_np[gidx_np]),
            None if lims_np is None else jnp.asarray(lims_np[gidx_np]),
            jnp.asarray(gidx_np), jnp.int32(steps))
        prior_iters = small["n_iters"][idx].astype(np.int64)
        sub_small = np.array(sub_small)               # ONE fetch
        for f, v in zip(_SMALL, sub_small):
            if f == "n_iters":
                small[f][idx] += v[:k]
            else:
                small[f][idx] = v[:k]
        if record_trace:
            sub_trace = np.array(sub_trace)           # (9, kp, cap)
            sub_iters = sub_small[_SMALL.index("n_iters")][:k].astype(int)
            _stitch_traces(trace_np, sub_trace, idx, prior_iters,
                           sub_iters, cap, BatchTrace._fields)

    from ..policy import GaussianPolicy
    int_fields = ("n_iters", "n_accepted", "reason")
    return BatchILQGResult(
        policy=GaussianPolicy(**pol),
        **big,
        **{f: jnp.asarray(v, jnp.int32 if f in int_fields else jnp.float32)
           for f, v in small.items()},
        trace=(BatchTrace(**{f: jnp.asarray(v)
                             for f, v in trace_np.items()})
               if record_trace else None))


# ---------------------------------------------------------------------------
# mesh composition: one straggler-compacting scheduler per shard
# ---------------------------------------------------------------------------
#
# Scenario solves are independent, so per-shard scheduling is EXACT: each
# device compacts its own stragglers (no cross-device scenario migration —
# that would trade collective traffic for tail latency). SPMD constraints
# shape the design:
#   - every process must dispatch the same global programs, so the compacted
#     per-shard batch size kp is agreed fleet-wide (max over shards,
#     tile-aligned) — shards with fewer stragglers just carry more pad lanes;
#   - compaction indices are SHARD-LOCAL, built host-side by each process
#     from its local rows and assembled into a global (n_dev·kp,) array;
#   - a shard with zero stragglers still runs the chunk program on pad
#     lanes; its scatter is masked shard-wide (pads elsewhere duplicate a
#     real unfinished index, so their duplicate writes are identical —
#     never conflicting).


@functools.lru_cache(maxsize=8)
def _mesh_max_fn(mesh: Mesh, axis: str):
    """Replicated max of a (n_dev,)-sharded counts vector — the one tiny
    cross-host collective per chunk that agrees on kp / termination."""
    return jax.jit(lambda c: jnp.max(c),
                   in_shardings=NamedSharding(mesh, P(axis)),
                   out_shardings=NamedSharding(mesh, P()))


def _big_specs(axis):
    return {f: P(axis) for f in _BIG}


def _pol_specs(axis):
    return {f: P(axis) for f in _POL}


@functools.lru_cache(maxsize=32)
def _sharded_cold_runner(model, packed_derivs, derivs_tiles, lims, cfg,
                         kt_backward, kt_forward, interpret, mesh, axis,
                         has_params, has_lims_batch=False,
                         record_trace=False):
    """Chunk-1 program: the lock-step lane solve on every shard, with the
    chunk length as a TRACED replicated scalar (one compile per batch
    size, shared with the resume chunks' semantics)."""
    from .batch import _ilqg_batch_lanes_jit

    def shard_fn(x0s, u0s, *rest):
        rest = list(rest)
        params = rest.pop(0) if has_params else None
        lims_b = rest.pop(0) if has_lims_batch else None
        steps = rest[-1]
        res = _ilqg_batch_lanes_jit(
            model, packed_derivs, x0s, u0s, lims=lims, lims_batch=lims_b,
            cfg=cfg,
            derivs_tiles=derivs_tiles, params=params, max_steps=steps,
            kt_backward=kt_backward, kt_forward=kt_forward,
            record_trace=record_trace,
            interpret=interpret)
        big = {f: getattr(res, f) for f in _BIG}
        pol = {f: getattr(res.policy, f) for f in _POL}
        out = (big, pol, jnp.transpose(_pack_small(res)))   # (B_shard, 7)
        if record_trace:
            # batch-leading (B_shard, n_fields, cap) so the global array is
            # sharded on axis 0 like every other output
            out += (jnp.moveaxis(
                jnp.stack(list(res.trace), 0).astype(jnp.float32), 1, 0),)
        return out

    in_specs = ((P(axis), P(axis))
                + ((P(axis),) if has_params else ())
                + ((P(axis),) if has_lims_batch else ()) + (P(),))
    out_specs = (_big_specs(axis), _pol_specs(axis), P(axis))
    if record_trace:
        out_specs += (P(axis),)
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@functools.lru_cache(maxsize=32)
def _sharded_chunk_runner(model, packed_derivs, derivs_tiles, lims, cfg,
                          kt_backward, kt_forward, interpret, mesh, axis,
                          has_params, has_lims_batch=False,
                          record_trace=False):
    """Straggler-chunk program: per shard, gather the compacted scenarios
    from device-resident fleet state (shard-local indices), continue their
    solve via the resume entry, and scatter back — masked shard-wide when
    the shard had nothing left (its pad-lane results are discarded)."""
    from .batch import _ilqg_batch_lanes_jit

    def shard_fn(big, pol, lam_g, dlam_g, acc_g, *rest):
        rest = list(rest)
        params_g = rest.pop(0) if has_params else None
        lims_g = rest.pop(0) if has_lims_batch else None
        gidx, kcount, steps = rest
        sub = _ilqg_batch_lanes_jit(
            model, packed_derivs, big["x"][gidx], big["u"][gidx],
            lims=lims, lims_batch=lims_g, cfg=cfg,
            derivs_tiles=derivs_tiles,
            params=params_g, cost0=big["cost"][gidx],
            lam0=lam_g, dlam0=dlam_g, accepted0=acc_g, max_steps=steps,
            kt_backward=kt_backward, kt_forward=kt_forward,
            record_trace=record_trace,
            interpret=interpret)
        # pads duplicate a real unfinished index when the shard has
        # stragglers (duplicate writes identical); a zero-straggler shard
        # masks the whole scatter to a no-op re-write of current values
        any_left = kcount[0] > 0

        def scat(dst, new):
            cur = dst[gidx]
            upd = jnp.where(
                jnp.reshape(any_left, (1,) * new.ndim), new, cur)
            return dst.at[gidx].set(upd)

        new_big = {f: scat(big[f], getattr(sub, f)) for f in _BIG}
        new_pol = {f: scat(pol[f], getattr(sub.policy, f)) for f in _POL}
        out = (new_big, new_pol, jnp.transpose(_pack_small(sub)))
        if record_trace:
            out += (jnp.moveaxis(
                jnp.stack(list(sub.trace), 0).astype(jnp.float32), 1, 0),)
        return out

    in_specs = ((_big_specs(axis), _pol_specs(axis), P(axis), P(axis),
                 P(axis))
                + ((P(axis),) if has_params else ())
                + ((P(axis),) if has_lims_batch else ())
                + (P(axis), P(axis), P()))
    out_specs = (_big_specs(axis), _pol_specs(axis), P(axis))
    if record_trace:
        out_specs += (P(axis),)
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def ilqg_fleet_sharded(model,
                       packed_derivs: Optional[Callable],
                       x0s, u0s,
                       lims: Optional[Tuple[Tuple[float, float], ...]] = None,
                       cfg: ILQGConfig = ILQGConfig(),
                       derivs_tiles: Optional[Callable] = None,
                       params=None,
                       chunk_iters: int = 16,
                       chunk_growth: float = 8.0,
                       max_chunks: int = 32,
                       kt_backward: int = 1,
                       kt_forward: int = 1,
                       record_trace: bool = False,
                       interpret: bool = False,
                       verbose: bool = False,
                       mesh: Optional[Mesh] = None,
                       axis: str = "b") -> BatchILQGResult:
    """:func:`ilqg_fleet` composed with a device mesh: solve B scenarios
    sharded over ``mesh`` with per-shard straggler compaction, to the SAME
    termination criteria as the lock-step sharded solve.

    Works single-process (8 local devices) and multi-process
    (``jax.distributed``): ``x0s``/``u0s``/``params`` may be process-local
    numpy rows (assembled into global arrays here, ordered by process) or
    already-global jax Arrays sharded ``P(axis)``. Per-chunk host traffic is
    one (B_local,)-sized fetch per process plus ONE replicated scalar
    collective (the fleet-wide straggler max that agrees on the compacted
    batch size — SPMD requires every process to dispatch the same program).
    Returns a :class:`BatchILQGResult` of global arrays sharded ``P(axis)``.

    ``record_trace=True`` returns the same stitched per-scenario
    :class:`~.batch.BatchTrace` as :func:`ilqg_fleet` — each process
    stitches its LOCAL rows (one extra (B_local, cap)-sized fetch per
    chunk), then the fields are reassembled as ``P(axis)``-sharded global
    arrays, so the fleet debugging story is identical on 1 and N devices
    (reference MVHistory semantics, ``src/iLQG.jl:325-330``).
    """
    from ..parallel.distributed import distribute_batch, local_slice
    from ..parallel.mesh import make_mesh
    from .batch import split_lims
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_dev = mesh.devices.size
    nproc = jax.process_count()
    local_dev = len([d for d in mesh.devices.ravel()
                     if d.process_index == jax.process_index()])
    has_params = params is not None
    lims, lims_batch = split_lims(lims)
    has_lims = lims_batch is not None

    # global inputs (B = global fleet size); plain numpy rows are treated as
    # this process's local slice and assembled into global arrays
    if isinstance(x0s, np.ndarray):
        x0s = distribute_batch(x0s, mesh, axis)
    if isinstance(u0s, np.ndarray):
        u0s = distribute_batch(u0s, mesh, axis)
    B = u0s.shape[0]
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    B_shard = B // n_dev
    params_g = None
    params_local = None
    if has_params:
        if isinstance(params, jax.Array) and not isinstance(params,
                                                            np.ndarray):
            params_local = local_slice(params)
        else:
            params_local = np.asarray(params)
        params_g = distribute_batch(params_local, mesh, axis)
    lims_g = None
    lims_local = None
    if has_lims:
        if isinstance(lims_batch, jax.Array) and not isinstance(
                lims_batch, np.ndarray):
            lims_local = np.asarray(local_slice(lims_batch))
        else:
            lims_local = np.asarray(lims_batch)
        lims_g = distribute_batch(lims_local, mesh, axis)

    # ---- chunk 1: full fleet, cold start, lock-step on every shard
    cold = _sharded_cold_runner(model, packed_derivs, derivs_tiles, lims,
                                cfg, kt_backward, kt_forward, interpret,
                                mesh, axis, has_params, has_lims,
                                record_trace)
    args = (x0s, u0s) + ((params_g,) if has_params else ()) + (
        (lims_g,) if has_lims else ()) + (jnp.int32(chunk_iters),)
    from .batch import BatchTrace
    cap = cfg.cap()
    if record_trace:
        big, pol, small_g, tr_g = cold(*args)
        tr_local = np.array(local_slice(tr_g))      # (B_local, 9, cap)
        trace_np = {f: tr_local[:, fi].copy()
                    for fi, f in enumerate(BatchTrace._fields)}
    else:
        big, pol, small_g = cold(*args)
    small = np.array(local_slice(small_g))          # (B_local, 7) this proc
    small = {f: small[:, i].copy() for i, f in enumerate(_SMALL)}

    mesh_max = _mesh_max_fn(mesh, axis)
    steps = chunk_iters
    for chunk in range(1, max_chunks):
        unfinished = (small["reason"] == 0)         # local rows
        counts = unfinished.reshape(local_dev, B_shard).sum(axis=1)
        n_left_max = int(mesh_max(distribute_batch(
            counts.astype(np.int32), mesh, axis)))
        if verbose:
            print(f"  fleet chunk {chunk}: local {int(unfinished.sum())} "
                  f"running, fleet-wide shard max {n_left_max}")
        if n_left_max == 0:
            break
        steps = int(round(steps * chunk_growth))
        kp = max(B_TILE, -(-n_left_max // B_TILE) * B_TILE)

        # shard-local compacted index lists, padded to the agreed kp
        gidx_l = np.zeros((local_dev, kp), np.int32)
        kcounts = np.zeros((local_dev,), np.int32)
        for j in range(local_dev):
            idx = np.flatnonzero(unfinished[j * B_shard:(j + 1) * B_shard])
            kcounts[j] = len(idx)
            if len(idx):
                gidx_l[j] = np.concatenate(
                    [idx, np.repeat(idx[:1], kp - len(idx))])
        rows = (gidx_l + (np.arange(local_dev) * B_shard)[:, None]).ravel()
        lam_l = small["lam"][rows].astype(np.float32)
        dlam_l = small["dlam"][rows].astype(np.float32)
        acc_l = small["n_accepted"][rows].astype(np.int32)

        runner = _sharded_chunk_runner(model, packed_derivs, derivs_tiles,
                                       lims, cfg, kt_backward, kt_forward,
                                       interpret, mesh, axis, has_params,
                                       has_lims, record_trace)
        rargs = (big, pol,
                 distribute_batch(lam_l, mesh, axis),
                 distribute_batch(dlam_l, mesh, axis),
                 distribute_batch(acc_l, mesh, axis))
        if has_params:
            rargs += (distribute_batch(params_local[rows], mesh, axis),)
        if has_lims:
            rargs += (distribute_batch(lims_local[rows], mesh, axis),)
        rargs += (distribute_batch(gidx_l.ravel(), mesh, axis),
                  distribute_batch(kcounts, mesh, axis),
                  jnp.int32(steps))
        if record_trace:
            big, pol, sub_small_g, sub_tr_g = runner(*rargs)
            sub_tr = np.array(local_slice(sub_tr_g))  # (ld·kp, 9, cap)
        else:
            big, pol, sub_small_g = runner(*rargs)
        sub_small = np.array(local_slice(sub_small_g))  # (local_dev·kp, 7)
        prior_all = small["n_iters"].copy()
        for i, f in enumerate(_SMALL):
            for j in range(local_dev):
                k = int(kcounts[j])
                if k == 0:
                    continue
                r = rows[j * kp:j * kp + k]
                v = sub_small[j * kp:j * kp + k, i]
                if f == "n_iters":
                    small[f][r] += v
                else:
                    small[f][r] = v
        if record_trace:
            ni = _SMALL.index("n_iters")
            for j in range(local_dev):
                k = int(kcounts[j])
                if k == 0:
                    continue
                r = rows[j * kp:j * kp + k]
                _stitch_traces(
                    trace_np, np.moveaxis(sub_tr[j * kp:j * kp + k], 1, 0),
                    r, prior_all[r],
                    sub_small[j * kp:j * kp + k, ni].astype(int),
                    cap, BatchTrace._fields)

    from ..policy import GaussianPolicy
    int_fields = ("n_iters", "n_accepted", "reason")
    small_global = {
        f: distribute_batch(
            v.astype(np.int32 if f in int_fields else np.float32),
            mesh, axis)
        for f, v in small.items()}
    trace = (BatchTrace(**{f: distribute_batch(trace_np[f], mesh, axis)
                           for f in BatchTrace._fields})
             if record_trace else None)
    return BatchILQGResult(
        policy=GaussianPolicy(**pol), **big, **small_global, trace=trace)


# ---------------------------------------------------------------------------
# GPS/KL-tier fleet scheduler (reference iLQGkl at fleet scale,
# /root/reference/src/iLQGkl.jl:25-252)
# ---------------------------------------------------------------------------
#
# The KL lane driver's lock-step while_loop has the same straggler problem
# as the iLQG one: per-lane η-bracketing iteration counts vary, so the
# whole fleet pays the slowest lane's count. Same cure: bounded chunks +
# compaction + the driver's resume entry. The KL driver's resume state is
# the η-dual optimizer's internals — bracket, escalation increment and
# (per-step mode) the ADAM moments — which `BatchKLResult` now returns and
# `bracket0`/`delta0_in`/`adam0_in`/`it0` restore; since every lock-step
# lane advances together, all unfinished lanes share one global iteration
# count and `it0` is a scalar. Composition is bit-exact vs lock-step
# (every η update is elementwise per lane; tests/test_fleet_kl.py).
#
# Unlike the iLQG fleet, the KL driver's INPUTS (pre-rolled trajectory,
# previous policy, model linearizations, cost0) never change during the
# solve (derivatives are evaluated once, src/iLQGkl.jl:88) — chunks gather
# them from the original device-resident arrays instead of carrying
# evolving trajectory state.

_KLBIG = ("x", "u", "cost", "bracket", "delta", "adam")
_KLSMALL = ("cost_total", "eta", "divergence", "satisfied", "kl_violated",
            "n_iters", "pd_failed", "done")


@jax.jit
def _pack_kl_small(res):
    return jnp.stack([jnp.asarray(getattr(res, f), jnp.float32)
                      for f in _KLSMALL])


@functools.lru_cache(maxsize=32)
def _kl_chunk_runner(model, derivs_tiles, lims, cfg, r1, kt, interpret,
                     has_lims_batch):
    """One fused jitted program per KL straggler chunk: gather the compacted
    scenarios' (fixed) inputs + η-optimizer resume state, continue their
    solve, scatter results back (one dispatch + one small fetch)."""
    from .batch_kl import _ilqgkl_batch_lanes_jit

    per_step = bool(cfg.constrain_per_step)

    @jax.jit
    def step(big, pol, x0s, prev, fx, cost0, lims_g, gidx, it0, steps):
        gather = lambda a: a[gidx]
        sub = _ilqgkl_batch_lanes_jit(
            model, derivs_tiles, x0s[gidx],
            jax.tree_util.tree_map(gather, prev),
            fx[gidx], cost0[gidx],
            lims=lims, lims_batch=lims_g, cfg=cfg, r1=r1, kt=kt,
            bracket0=big["bracket"][gidx],
            delta0_in=big["delta"][gidx],
            adam0_in=big["adam"][gidx] if per_step else None,
            it0=it0, max_steps=steps, interpret=interpret)
        new_big = {f: big[f].at[gidx].set(getattr(sub, f)) for f in _KLBIG}
        new_pol = {f: pol[f].at[gidx].set(getattr(sub.policy, f))
                   for f in _POL}
        return new_big, new_pol, _pack_kl_small(sub)

    return step


def ilqgkl_fleet(model, derivs_tiles, x0s, traj_prev, fx_model, cost0,
                 lims=None, cfg=None, r1=None, kt: int = 1,
                 chunk_iters: int = 4,
                 chunk_growth: float = 4.0,
                 max_chunks: int = 32,
                 interpret: bool = False,
                 verbose: bool = False):
    """Solve B KL-constrained scenarios (``iLQGkl`` semantics,
    ``src/iLQGkl.jl:25-252``) to the SAME termination criteria as
    :func:`~.batch_kl.ilqgkl_batch_lanes`, but straggler-compacted: after
    every ``chunk_iters`` iterations the still-running lanes are compacted
    into the smallest tile-aligned batch and continued alone via the KL
    resume entry. Bit-exact vs lock-step per scenario.

    **Recommendation: use lock-step**
    :func:`~.batch_kl.ilqgkl_batch_lanes` **instead.** Compaction needs a
    wide per-lane iteration spread, and the KL tier's η search has none in
    either mode: the scalar-η dual bisection's depth is set by the bracket
    geometry and the RELATIVE tolerance (|KL−ε| < 0.1 ε), both fleet-wide
    constants, and the per-timestep-ADAM mode runs every lane to the
    iteration budget. This entry stays for parity of the runtime layer
    across tiers and as the resume-entry exerciser.

    Arguments mirror :func:`~.batch_kl.ilqgkl_batch_lanes` (``trace``
    unsupported). Single-device; :func:`ilqgkl_fleet_sharded` runs this
    per shard of a mesh.
    """
    from .batch import split_lims
    from .batch_kl import _ilqgkl_batch_lanes_jit, BatchKLResult
    from ..solvers.ilqgkl import ILQGKLConfig
    if cfg is None:
        cfg = ILQGKLConfig()
    B = x0s.shape[0]
    lims_s, lims_batch = split_lims(lims)
    lims_np = None if lims_batch is None else np.asarray(lims_batch)
    x0s = jnp.asarray(x0s)
    fx_model = jnp.asarray(fx_model)
    cost0 = jnp.asarray(cost0)

    res = _ilqgkl_batch_lanes_jit(
        model, derivs_tiles, x0s, traj_prev, fx_model, cost0,
        lims=lims_s, lims_batch=lims_batch, cfg=cfg, r1=r1, kt=kt,
        it0=jnp.zeros((), jnp.int32), max_steps=jnp.int32(chunk_iters),
        interpret=interpret)
    big = {f: getattr(res, f) for f in _KLBIG}        # stays on device
    pol = {f: getattr(res.policy, f) for f in _POL}
    small = dict(zip(_KLSMALL, np.array(_pack_kl_small(res))))  # ONE fetch

    steps_done = chunk_iters
    steps = chunk_iters
    for chunk in range(1, max_chunks):
        unfinished = small["done"] < 0.5
        n_left = int(unfinished.sum())
        if verbose:
            print(f"  kl-fleet chunk {chunk}: {n_left}/{B} running "
                  f"({steps_done}/{cfg.max_iter} iters)")
        if n_left == 0 or steps_done >= cfg.max_iter:
            break
        steps = int(round(steps * chunk_growth))
        idx = np.flatnonzero(unfinished)
        k = len(idx)
        kp = max(B_TILE, -(-k // B_TILE) * B_TILE)
        gidx_np = np.concatenate([idx, np.repeat(idx[:1], kp - k)])
        runner = _kl_chunk_runner(model, derivs_tiles, lims_s, cfg, r1, kt,
                                  interpret, lims_np is not None)
        big, pol, sub_small = runner(
            big, pol, x0s, traj_prev, fx_model, cost0,
            None if lims_np is None else jnp.asarray(lims_np[gidx_np]),
            jnp.asarray(gidx_np), jnp.int32(steps_done), jnp.int32(steps))
        sub_small = np.array(sub_small)               # ONE fetch
        for f, v in zip(_KLSMALL, sub_small):
            # n_iters is GLOBAL (the driver counts from it0), so every
            # field is a plain overwrite
            small[f][idx] = v[:k]
        steps_done += steps

    from ..policy import GaussianPolicy
    bool_fields = ("satisfied", "kl_violated", "pd_failed", "done")
    return BatchKLResult(
        policy=GaussianPolicy(**pol), **big,
        **{f: jnp.asarray(
            v.astype(bool) if f in bool_fields else
            v.astype(np.int32 if f == "n_iters" else np.float32))
           for f, v in small.items()},
        trace=None)


@functools.lru_cache(maxsize=32)
def _kl_sharded_cold_runner(model, derivs_tiles, lims, cfg, r1, kt,
                            interpret, mesh, axis, has_lims_batch):
    """KL chunk-1 program: the lock-step KL lane solve on every shard with
    a traced chunk bound."""
    from .batch_kl import _ilqgkl_batch_lanes_jit

    def shard_fn(x0s, prev, fx, cost0, *rest):
        rest = list(rest)
        lims_b = rest.pop(0) if has_lims_batch else None
        steps = rest[-1]
        res = _ilqgkl_batch_lanes_jit(
            model, derivs_tiles, x0s, prev, fx, cost0,
            lims=lims, lims_batch=lims_b, cfg=cfg, r1=r1, kt=kt,
            it0=jnp.zeros((), jnp.int32), max_steps=steps,
            interpret=interpret)
        big = {f: getattr(res, f) for f in _KLBIG}
        pol = {f: getattr(res.policy, f) for f in _POL}
        return big, pol, jnp.transpose(_pack_kl_small(res))

    from ..policy import GaussianPolicy
    gp_in = GaussianPolicy(K=P(axis), k=P(axis), sigma=P(axis),
                           sigma_inv=P(axis))
    in_specs = ((P(axis), gp_in, P(axis), P(axis))
                + ((P(axis),) if has_lims_batch else ()) + (P(),))
    out_specs = ({f: P(axis) for f in _KLBIG},
                 {f: P(axis) for f in _POL}, P(axis))
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


@functools.lru_cache(maxsize=32)
def _kl_sharded_chunk_runner(model, derivs_tiles, lims, cfg, r1, kt,
                             interpret, mesh, axis, has_lims_batch):
    """KL straggler-chunk program: per shard, gather the compacted
    scenarios' fixed inputs + η-optimizer resume state, continue, scatter
    back (masked when the shard had nothing left)."""
    from .batch_kl import _ilqgkl_batch_lanes_jit

    per_step = bool(cfg.constrain_per_step)

    def shard_fn(big, pol, x0s, prev, fx, cost0, *rest):
        rest = list(rest)
        lims_g = rest.pop(0) if has_lims_batch else None
        gidx, kcount, it0, steps = rest
        gather = lambda a: a[gidx]
        sub = _ilqgkl_batch_lanes_jit(
            model, derivs_tiles, x0s[gidx],
            jax.tree_util.tree_map(gather, prev),
            fx[gidx], cost0[gidx],
            lims=lims, lims_batch=lims_g, cfg=cfg, r1=r1, kt=kt,
            bracket0=big["bracket"][gidx],
            delta0_in=big["delta"][gidx],
            adam0_in=big["adam"][gidx] if per_step else None,
            it0=it0[0], max_steps=steps, interpret=interpret)
        any_left = kcount[0] > 0

        def scat(dst, new):
            cur = dst[gidx]
            upd = jnp.where(
                jnp.reshape(any_left, (1,) * new.ndim), new, cur)
            return dst.at[gidx].set(upd)

        new_big = {f: scat(big[f], getattr(sub, f)) for f in _KLBIG}
        new_pol = {f: scat(pol[f], getattr(sub.policy, f)) for f in _POL}
        return new_big, new_pol, jnp.transpose(_pack_kl_small(sub))

    from ..policy import GaussianPolicy
    gp_in = GaussianPolicy(K=P(axis), k=P(axis), sigma=P(axis),
                           sigma_inv=P(axis))
    in_specs = (({f: P(axis) for f in _KLBIG}, {f: P(axis) for f in _POL},
                 P(axis), gp_in, P(axis), P(axis))
                + ((P(axis),) if has_lims_batch else ())
                + (P(axis), P(axis), P(axis), P()))
    out_specs = ({f: P(axis) for f in _KLBIG},
                 {f: P(axis) for f in _POL}, P(axis))
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def ilqgkl_fleet_sharded(model, derivs_tiles, x0s, traj_prev, fx_model,
                         cost0, lims=None, cfg=None, r1=None, kt: int = 1,
                         chunk_iters: int = 4,
                         chunk_growth: float = 4.0,
                         max_chunks: int = 32,
                         interpret: bool = False,
                         verbose: bool = False,
                         mesh: Optional[Mesh] = None,
                         axis: str = "b"):
    """:func:`ilqgkl_fleet` composed with a device mesh: per-shard
    straggler compaction for the GPS/KL tier (reference ``iLQGkl`` over
    several devices). Same SPMD design as :func:`ilqg_fleet_sharded`:
    fleet-wide agreed compacted batch size (one replicated scalar collective per
    chunk), shard-local compaction indices, masked scatters on
    zero-straggler shards. ``x0s``/``traj_prev``/``fx_model``/``cost0``
    may be process-local numpy rows or global ``P(axis)``-sharded arrays.
    """
    from ..parallel.distributed import distribute_batch, local_slice
    from ..parallel.mesh import make_mesh
    from .batch import split_lims
    from .batch_kl import BatchKLResult
    from ..solvers.ilqgkl import ILQGKLConfig
    if cfg is None:
        cfg = ILQGKLConfig()
    if mesh is None:
        mesh = make_mesh(axis=axis)
    n_dev = mesh.devices.size
    local_dev = len([d for d in mesh.devices.ravel()
                     if d.process_index == jax.process_index()])
    lims_s, lims_batch = split_lims(lims)
    has_lims = lims_batch is not None

    if isinstance(x0s, np.ndarray):
        x0s = distribute_batch(x0s, mesh, axis)
    if isinstance(fx_model, np.ndarray):
        fx_model = distribute_batch(fx_model, mesh, axis)
    if isinstance(cost0, np.ndarray):
        cost0 = distribute_batch(cost0, mesh, axis)
    traj_prev = jax.tree_util.tree_map(
        lambda a: (distribute_batch(np.asarray(a), mesh, axis)
                   if isinstance(a, np.ndarray) else a), traj_prev)
    B = x0s.shape[0]
    assert B % n_dev == 0, f"batch {B} must divide over {n_dev} devices"
    B_shard = B // n_dev
    lims_g = None
    lims_local = None
    if has_lims:
        if isinstance(lims_batch, jax.Array) and not isinstance(
                lims_batch, np.ndarray):
            lims_local = np.asarray(local_slice(lims_batch))
        else:
            lims_local = np.asarray(lims_batch)
        lims_g = distribute_batch(lims_local, mesh, axis)

    cold = _kl_sharded_cold_runner(model, derivs_tiles, lims_s, cfg, r1,
                                   kt, interpret, mesh, axis, has_lims)
    args = (x0s, traj_prev, fx_model, cost0) + (
        (lims_g,) if has_lims else ()) + (jnp.int32(chunk_iters),)
    big, pol, small_g = cold(*args)
    small = np.array(local_slice(small_g))
    small = {f: small[:, i].copy() for i, f in enumerate(_KLSMALL)}

    mesh_max = _mesh_max_fn(mesh, axis)
    steps_done = chunk_iters
    steps = chunk_iters
    for chunk in range(1, max_chunks):
        unfinished = small["done"] < 0.5
        counts = unfinished.reshape(local_dev, B_shard).sum(axis=1)
        n_left_max = int(mesh_max(distribute_batch(
            counts.astype(np.int32), mesh, axis)))
        if verbose:
            print(f"  kl-fleet chunk {chunk}: local "
                  f"{int(unfinished.sum())} running, shard max "
                  f"{n_left_max} ({steps_done}/{cfg.max_iter} iters)")
        if n_left_max == 0 or steps_done >= cfg.max_iter:
            break
        steps = int(round(steps * chunk_growth))
        kp = max(B_TILE, -(-n_left_max // B_TILE) * B_TILE)

        gidx_l = np.zeros((local_dev, kp), np.int32)
        kcounts = np.zeros((local_dev,), np.int32)
        for j in range(local_dev):
            idx = np.flatnonzero(unfinished[j * B_shard:(j + 1) * B_shard])
            kcounts[j] = len(idx)
            if len(idx):
                gidx_l[j] = np.concatenate(
                    [idx, np.repeat(idx[:1], kp - len(idx))])
        rows = (gidx_l + (np.arange(local_dev) * B_shard)[:, None]).ravel()

        runner = _kl_sharded_chunk_runner(model, derivs_tiles, lims_s, cfg,
                                          r1, kt, interpret, mesh, axis,
                                          has_lims)
        rargs = (big, pol, x0s, traj_prev, fx_model, cost0)
        if has_lims:
            rargs += (distribute_batch(lims_local[rows], mesh, axis),)
        rargs += (distribute_batch(gidx_l.ravel(), mesh, axis),
                  distribute_batch(kcounts, mesh, axis),
                  distribute_batch(
                      np.full((local_dev,), steps_done, np.int32),
                      mesh, axis),
                  jnp.int32(steps))
        big, pol, sub_small_g = runner(*rargs)
        sub_small = np.array(local_slice(sub_small_g))
        for i, f in enumerate(_KLSMALL):
            for j in range(local_dev):
                k = int(kcounts[j])
                if k == 0:
                    continue
                r = rows[j * kp:j * kp + k]
                small[f][r] = sub_small[j * kp:j * kp + k, i]
        steps_done += steps

    from ..policy import GaussianPolicy
    bool_fields = ("satisfied", "kl_violated", "pd_failed", "done")
    small_global = {
        f: distribute_batch(
            v.astype(bool) if f in bool_fields else
            v.astype(np.int32 if f == "n_iters" else np.float32),
            mesh, axis)
        for f, v in small.items()}
    return BatchKLResult(
        policy=GaussianPolicy(**pol), **big, **small_global, trace=None)

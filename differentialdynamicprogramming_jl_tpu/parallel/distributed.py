"""Multi-host execution: `jax.distributed` plumbing + process-aware meshes.

The reference is single-process (SURVEY.md §2 "Distributed communication
backend: ABSENT"); this module is the scaling layer the build plan adds
(SURVEY.md §7 step 7, BASELINE.json north star: ≥80% solves/s efficiency
1 card → 1 host → N ≥ 2 hosts).

Design: scenario solves are embarrassingly parallel, so multi-host adds
NOTHING to the per-iteration hot path — each host's cards solve their
shard of the fleet locally, and the only cross-host traffic is the final
``psum`` of fleet convergence stats. Consequently the whole layer is
(a) `jax.distributed.initialize` bring-up, (b) a global 1-D mesh over every
card of every process, and (c) helpers to build global sharded fleet
arrays from per-process local data. The solvers themselves
(:func:`~.mesh.ilqg_sharded`, :func:`~.mesh.ilqg_batch_sharded`) are
mesh-agnostic: hand them the global mesh and global arrays and the same
jitted SPMD program runs on every process.

Typical multi-host program (one process per host, e.g. under SLURM)::

    from differentialdynamicprogramming_jl_tpu.parallel import distributed as D

    D.init_distributed("host0:1234", num_processes=2, process_id=rank)
    mesh = D.global_mesh()
    x0s = D.distribute_batch(local_x0s, mesh)   # (B_local, n) per process
    u0s = D.distribute_batch(local_u0s, mesh)
    res, stats = ilqg_batch_sharded(model, None, x0s, u0s, ..., mesh=mesh,
                                    reduce_stats=True)
    # `stats` is replicated: every process sees the fleet-wide psum result.

CPU simulation (the fake-multi-device trick, SURVEY.md §4) is first-class:
``tests/test_multihost.py`` spawns 2 localhost processes × 4 virtual CPU
devices each and runs both solver tiers over the resulting 8-device global
mesh with gloo cross-process collectives.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     cpu_collectives: str = "gloo") -> None:
    """Bring up the JAX distributed runtime for this process.

    Pass the coordinator explicitly (``"host:port"``, the address of
    process 0), the process count and this process's id: nothing in a
    plain GPU or CPU cluster tells JAX of them. One process per GPU needs
    its own visible device — ``local_device_ids=[i]`` or
    ``CUDA_VISIBLE_DEVICES`` — because a JAX process reserves most of every
    card it opens, so two processes on one card fail for want of memory.
    One process may also drive all of its host's cards.

    ``cpu_collectives`` selects the cross-process CPU collective backend
    ("gloo" default, "mpi" where available); it is applied when
    ``jax_platforms`` explicitly names cpu, OR when the process can only
    resolve to cpu anyway (no accelerator PJRT plugin registered — checked
    via the registration table, which is populated at import time, so this
    does NOT initialize XLA before ``jax.distributed.initialize``). XLA's
    default single-process CPU collectives silently hang across process
    boundaries, so a CPU-only cluster must get gloo even when the user relies
    on platform auto-detection. Processes with an accelerator plugin
    registered and ``jax_platforms`` unset are left untouched.
    """
    platforms = jax.config.jax_platforms or ""
    use_cpu_collectives = "cpu" in platforms.split(",")
    if not platforms:
        try:  # registered (not initialized) PJRT factories
            from jax._src import xla_bridge as _xb
            use_cpu_collectives = set(_xb._backend_factories) <= {
                "cpu", "interpreter"}
        except Exception:  # pragma: no cover - private API moved
            import warnings
            warnings.warn(
                "init_distributed: cannot tell whether this process is "
                "CPU-only; if it is, set jax.config.update('jax_platforms',"
                " 'cpu') first or cross-process CPU collectives will hang")
    if use_cpu_collectives:
        try:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        except Exception:  # pragma: no cover - older jax without the flag
            pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(axis: str = "b") -> Mesh:
    """1-D mesh over every device in the slice (all processes).

    Unlike :func:`~.mesh.make_mesh` (which this generalizes), the returned
    mesh spans non-addressable devices on other hosts; arrays laid out on it
    must be global arrays (see :func:`distribute_batch`).
    """
    return Mesh(np.array(jax.devices()), (axis,))


def distribute_batch(local: "np.ndarray | jax.Array", mesh: Mesh,
                     axis: str = "b") -> jax.Array:
    """Assemble a global fleet array from this process's shard.

    ``local``: the (B_local, ...) slice of the fleet owned by this process
    (processes are ordered by process index along the batch axis). Returns
    a global jax.Array of shape (B_local * process_count, ...) sharded
    ``P(axis)`` over ``mesh``. Single-process: equivalent to ``device_put``
    with the sharding.
    """
    local = np.asarray(local)
    sharding = NamedSharding(mesh, P(axis, *([None] * (local.ndim - 1))))
    global_shape = (local.shape[0] * jax.process_count(),) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local,
                                                  global_shape)


def replicate(value, mesh: Mesh) -> jax.Array:
    """Place a (small) array replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(jax.numpy.asarray(value), sharding)


def local_slice(global_arr: jax.Array) -> np.ndarray:
    """This process's rows of a batch-sharded global array, assembled from
    its addressable shards in device order (inverse of
    :func:`distribute_batch` for P(axis) layouts)."""
    shards = sorted(global_arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

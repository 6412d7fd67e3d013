"""Checkpoint / warm-start serialization.

The reference has no checkpointing; its moral equivalent is warm starting —
pre-rolled ``x0`` + ``cost`` kwargs (``src/iLQG.jl:85-87,193-197``) and
``traj_prev`` re-centering in the GPS loop (``src/demo_linear.jl:124-130``).
This framework makes that durable: any solver pytree (GaussianPolicy,
trajectories, ILQGResult, solver state) round-trips to a single ``.npz``
file, so MPC fleets can checkpoint/resume warm starts across processes and
hosts.
"""
from __future__ import annotations

import json
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..policy import GaussianPolicy


def save_pytree(path: str, tree: Any) -> None:
    """Serialize an arbitrary pytree of arrays to ``path`` (.npz).

    The treedef is stored as JSON alongside flat leaves, so any NamedTuple /
    dataclass pytree registered with JAX round-trips (structure is rebuilt
    with :func:`load_pytree` against a matching ``like`` tree, or returned
    as a flat list otherwise)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps({"n_leaves": len(leaves),
                    "treedef": str(treedef)}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Any = None):
    """Load a pytree saved by :func:`save_pytree`.

    ``like``: a pytree with the same structure whose treedef is used to
    unflatten (leaf values ignored). Without it, returns the flat leaf list.
    """
    data = np.load(path)
    meta = json.loads(bytes(data["__treedef__"]).decode())
    leaves = [jnp.asarray(data[f"leaf_{i}"])
              for i in range(meta["n_leaves"])]
    if like is None:
        return leaves
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_policy(path: str, policy: GaussianPolicy) -> None:
    """Save a (possibly batched) :class:`GaussianPolicy`."""
    np.savez(path, K=np.asarray(policy.K), k=np.asarray(policy.k),
             sigma=np.asarray(policy.sigma),
             sigma_inv=np.asarray(policy.sigma_inv))


def load_policy(path: str) -> GaussianPolicy:
    data = np.load(path)
    return GaussianPolicy(K=jnp.asarray(data["K"]),
                          k=jnp.asarray(data["k"]),
                          sigma=jnp.asarray(data["sigma"]),
                          sigma_inv=jnp.asarray(data["sigma_inv"]))


def save_warm_start(path: str, x: jax.Array, u: jax.Array,
                    cost: jax.Array) -> None:
    """Save a pre-rolled trajectory for warm starting (the reference's
    pre-rolled ``x0``+``cost`` convention, ``src/iLQG.jl:193-197``)."""
    np.savez(path, x=np.asarray(x), u=np.asarray(u), cost=np.asarray(cost))


def load_warm_start(path: str):
    data = np.load(path)
    return (jnp.asarray(data["x"]), jnp.asarray(data["u"]),
            jnp.asarray(data["cost"]))

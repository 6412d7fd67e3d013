"""Ahead-of-time (AOT) solver export — compile once, serve without tracing.

Production-serving story with no reference analogue: the reference is a
JIT-on-first-call Julia library (every process pays compilation and must
carry the full model-definition code, ``src/iLQG.jl:143``). The equivalent
here uses ``jax.export``: trace + lower a jitted solver ONCE on a build
machine, serialize the lowered program (StableHLO, plus the Triton kernel
payloads of the lane tier) to bytes, then deserialize in a serving process
and call it with zero Python tracing. The artifact pins the program — model
code, config constants, and kernel choices are baked in at build time, so a
serving host cannot silently diverge from what was validated.

Scope/caveats (inherent to ``jax.export``):
- Shapes and dtypes are fixed at export time (one artifact per (B, T)
  deployment shape — consistent with the fleet scheduler's fixed-tile
  discipline, ``solvers/fleet.py``).
- Static configuration (``ILQGConfig``, ``LanesModel``, derivative tiles,
  limits) is closed over at build time; runtime inputs are the traced
  arrays only (x0s, u0s, optional resume state).
- XLA-tier artifacts are forward-compatible across jax releases per the
  StableHLO compatibility window. A lane-tier artifact for a GPU embeds
  Triton IR in the ``__gpu$xla.gpu.triton`` custom call, whose format JAX
  does not promise to keep stable: :func:`export_solver` allows that call
  explicitly, which binds the artifact to the JAX and CUDA versions that
  built it.
- Serializing to bytes needs JAX's optional ``flatbuffers`` dependency;
  without it :func:`export_solver` still works, and its ``Exported`` can be
  called in-process (``jax.jit(exported.call)``).

Usage::

    solve = lambda x0s, u0s: ilqg_batch_lanes(model, None, x0s, u0s, ...)
    blob = serialize_solver(solve, x0s, u0s)          # build machine
    Path("solver.bin").write_bytes(blob)

    serve = deserialize_solver(Path("solver.bin").read_bytes())
    res = serve(x0s, u0s)                             # serving process
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
from jax import export as _jax_export

__all__ = [
    "register_serialization",
    "export_solver",
    "serialize_solver",
    "deserialize_solver",
    "save_solver",
    "load_solver",
]

_REGISTERED = False

# the custom call that carries a Pallas kernel compiled through Triton
TRITON_CALL = _jax_export.DisabledSafetyCheck.custom_call(
    "__gpu$xla.gpu.triton")


def register_serialization() -> None:
    """Register the package's public NamedTuple result types with
    ``jax.export`` so exported solvers return them natively (the serving
    side gets a real :class:`BatchILQGResult`, not a flat tuple).

    Idempotent — safe to call from every export/deserialize entry point.
    """
    global _REGISTERED
    if _REGISTERED:
        return
    from ..ops.boxqp import BoxQPResult, QPTrace
    from ..policy import Derivs, GaussianPolicy, Trace
    from ..solvers.batch import BatchILQGResult, BatchTrace
    from ..solvers.batch_kl import BatchKLResult, BatchKLTrace
    from ..solvers.ilqg import ILQGResult
    from ..solvers.ilqgkl import ILQGKLResult

    # jax's registry keeps nodetype -> (serialized_name, ...) — inspect it
    # directly so "this exact class already carries this exact name" (the
    # only benign duplicate: a previous call, incl. from a second live copy
    # of this package) is distinguished from GENUINE conflicts (our class
    # pre-registered under a foreign name, or our name taken by a foreign
    # class), which message sniffing cannot reliably separate. Private API
    # — fall back to registering and re-raising on any error if it moves.
    try:
        from jax._src.export._export import (
            serialization_registry as _ser_reg)
    except Exception:  # noqa: BLE001 — registry location is private API
        _ser_reg = None

    for cls in (GaussianPolicy, Derivs, Trace, ILQGResult, ILQGKLResult,
                BatchTrace, BatchILQGResult, BatchKLTrace, BatchKLResult,
                BoxQPResult, QPTrace):
        name = f"ddp.{cls.__module__}.{cls.__qualname__}"
        if _ser_reg is not None and cls in _ser_reg:
            prior = _ser_reg[cls][0]
            if prior == name:
                continue               # benign: already ours
            raise ValueError(
                f"{cls} is already registered for jax.export serialization "
                f"under `{prior}`; this package derives `{name}`. Exported "
                f"artifacts would deserialize under the foreign name — "
                f"remove the conflicting registration.")
        _jax_export.register_namedtuple_serialization(
            cls, serialized_name=name)
    _REGISTERED = True


def _abstractify(x):
    if isinstance(x, jax.ShapeDtypeStruct):
        return x
    if isinstance(x, jax.Array):
        return jax.ShapeDtypeStruct(x.shape, x.dtype)
    # host arrays/scalars: read shape/dtype WITHOUT a device transfer
    # (jnp.asarray would device-commit e.g. a full (B=4096, T=500) input
    # just to be thrown away)
    import numpy as np
    a = np.asarray(x)
    dtype = jax.dtypes.canonicalize_dtype(a.dtype)
    return jax.ShapeDtypeStruct(a.shape, dtype)


def export_solver(fn: Callable, *example_args,
                  platforms: Optional[Sequence[str]] = None
                  ) -> "_jax_export.Exported":
    """Trace + lower ``fn`` for the shapes/dtypes of ``example_args``.

    ``fn`` is any jittable solver entry (typically a closure over the
    static model/config, taking only array inputs). ``example_args`` may
    be concrete arrays or ``jax.ShapeDtypeStruct`` pytrees — only their
    shapes/dtypes matter. ``platforms`` defaults to the current backend;
    pass ``("cuda",)`` to cross-build a GPU artifact from a CPU host.

    The lane tier's Triton kernels are allowed through
    ``DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")``: their IR
    is not on ``jax.export``'s list of stable custom calls, so such an
    artifact is bound to the JAX and CUDA versions that built it.
    """
    register_serialization()
    specs = jax.tree_util.tree_map(_abstractify, example_args)
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    return _jax_export.export(
        jax.jit(fn), disabled_checks=[TRITON_CALL], **kwargs)(*specs)


def serialize_solver(fn: Callable, *example_args,
                     platforms: Optional[Sequence[str]] = None) -> bytes:
    """:func:`export_solver` + serialize to portable bytes."""
    return bytes(export_solver(fn, *example_args,
                               platforms=platforms).serialize())


def deserialize_solver(blob: bytes) -> Callable:
    """Rehydrate a serialized solver into a jitted callable.

    The returned callable validates input shapes/dtypes against the
    artifact and executes the pinned program — no retracing of the
    original Python (which need not even be importable on the serving
    host beyond this package's result types).
    """
    register_serialization()
    exported = _jax_export.deserialize(bytearray(blob))
    return jax.jit(exported.call)


def save_solver(path, fn: Callable, *example_args,
                platforms: Optional[Sequence[str]] = None) -> None:
    """Serialize ``fn`` and write the artifact to ``path``."""
    with open(path, "wb") as f:
        f.write(serialize_solver(fn, *example_args, platforms=platforms))


def load_solver(path) -> Callable:
    """Load an artifact written by :func:`save_solver`."""
    with open(path, "rb") as f:
        return deserialize_solver(f.read())

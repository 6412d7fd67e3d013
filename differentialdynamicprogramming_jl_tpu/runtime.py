"""Process-level choices that depend on where the program runs: which solver
tier a backend gets, and where the persistent compile cache lives."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import jax

# One fixed directory inside the checkout: the cache path is part of the
# cache's key, so a directory that moved would never hit.
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def solver_tier(interpret: bool = False) -> str:
    """The one dispatch point between the solver tiers.

    - ``"lanes"`` on a CUDA GPU: the compiled lane tier (Triton kernels);
    - on the CPU, ``"xla"`` (the portable vmapped tier), or ``"interpret"``
      — the lane tier through the Pallas interpreter — only when the caller
      passes ``interpret=True``;
    - any other backend is an error: no tier of this package targets it.
    """
    backend = jax.default_backend()
    if backend == "gpu":
        return "lanes"
    if backend == "cpu":
        return "interpret" if interpret else "xla"
    raise RuntimeError(
        f"no solver tier for backend {backend!r}: the lane tier needs a "
        f"CUDA GPU, the XLA tier runs on the CPU")


def compile_cache_dir() -> Optional[str]:
    """Where this process should keep JAX's persistent compile cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself, and no
    code sets another), else :data:`CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_DIR)


def enable_compile_cache() -> None:
    """Apply :func:`compile_cache_dir` to this process's JAX config."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)

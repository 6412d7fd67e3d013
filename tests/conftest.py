"""Test configuration: CPU backend with 8 virtual devices (the standard
fake-multi-device trick for sharding tests — SURVEY.md §4), f64 enabled for
numerical-parity oracles (the reference is Float64 throughout); dedicated f32
tests cast explicitly to exercise the float32 lane-tier dtype path. Tests
marked ``gpu`` take the ``gpu_device`` fixture and skip here; on a card
they run through ``python chip_smoke.py --phase gpu_tests``."""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compile cache (keyed by HLO hash): interpret-mode Pallas
# compiles dominate the suite's wall time and are identical across runs, so
# repeat suite runs load executables from disk instead of recompiling.
# Composes with the per-module clear_caches() below: memory stays bounded,
# but re-JITs after a clear hit the disk cache. Code changes change the HLO
# hash, so staleness is not a risk. Where the cache lives is the package's
# rule (runtime.compile_cache_dir).
from differentialdynamicprogramming_jl_tpu.runtime import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu_device():
    """The CUDA device for tests marked ``gpu``; decided here, never at
    import time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; this process runs on "
                    f"{jax.default_backend()}")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_after_module():
    """Drop compiled executables between test modules. A single pytest
    process accumulates hundreds of CPU executables (+ multi-GB RSS) across
    the suite, which has produced nondeterministic late-suite segfaults in
    XLA's CPU compiler; per-module clearing keeps the process bounded.
    Cross-module jit reuse is minimal (interpret-mode Pallas compiles
    dominate and are module-local), so the runtime cost is small."""
    yield
    jax.clear_caches()

"""The dispatch point between the solver tiers and the compile-cache rule
(runtime.py)."""
import jax
import pytest

from differentialdynamicprogramming_jl_tpu import runtime


@pytest.mark.parametrize("backend,interpret,tier", [
    ("gpu", False, "lanes"),
    ("gpu", True, "lanes"),
    ("cpu", False, "xla"),
    ("cpu", True, "interpret"),
])
def test_solver_tier(monkeypatch, backend, interpret, tier):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert runtime.solver_tier(interpret) == tier


def test_solver_tier_rejects_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no solver tier"):
        runtime.solver_tier()


def test_demo_fleet_takes_the_xla_tier_on_cpu(monkeypatch):
    """The demos ask the dispatch point: on the CPU without interpret=True
    they never reach a lane kernel."""
    from differentialdynamicprogramming_jl_tpu import demos
    from differentialdynamicprogramming_jl_tpu.solvers import batch

    def no_lanes(*a, **k):
        raise AssertionError("lane tier reached on the CPU")

    monkeypatch.setattr(batch, "ilqg_batch_lanes", no_lanes)
    res = demos.demo_fleet(B=2, T=8, max_iter=1)
    assert res.u.shape == (2, 8, 1)


def test_cache_dir_inside_checkout_when_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir()
    assert path == str(runtime.CACHE_DIR)
    pkg_root = runtime.CACHE_DIR.parent
    assert (pkg_root / "differentialdynamicprogramming_jl_tpu").is_dir()


def test_cache_dir_left_to_jax_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    runtime.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before

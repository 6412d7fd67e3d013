"""Verbosity-surface tests (utils/printing.py): the reference-format
iteration tables, exit messages and boxQP print path actually emit, with
the right shape of content (reference formats at src/iLQG.jl:288-303,
src/boxQP.jl:65-66,153-156,181-184, src/iLQGkl.jl:151-159)."""
import jax
import jax.numpy as jnp
import numpy as np

from differentialdynamicprogramming_jl_tpu import (
    ILQGConfig, boxqp, ilqg)
from differentialdynamicprogramming_jl_tpu.models.linear import (
    random_lti, make_lti_problem)


def _drain():
    jax.effects_barrier()


def test_ilqg_iteration_table_and_exit(capfd):
    spec = random_lti(jax.random.PRNGKey(0), n=4, m=2, T=40,
                      dtype=jnp.float64)
    prob = make_lti_problem(spec, 40)
    res = ilqg(prob, spec.x0, spec.u0,
               cfg=ILQGConfig(verbosity=2, max_iter=12, print_head=5))
    jax.block_until_ready(res.u)
    _drain()
    out = capfd.readouterr().out
    assert "begin iLQG" in out
    # periodic header + at least one data row
    assert out.count("iteration     cost") >= 1
    assert "log10(lam)" in out
    # exit message + final summary (reason 1 or 2 on this easy problem)
    assert ("SUCCESS" in out) or ("EXIT" in out)
    assert "end iLQG" in out
    assert "final cost" in out


def test_iteration_cap_exit_message(capfd):
    """reason 0 (while_loop trip cap hit before max_iter accepted
    iterations) must print an explicit exit line — the reference always
    prints one of its exit messages."""
    spec = random_lti(jax.random.PRNGKey(1), n=4, m=2, T=40,
                      dtype=jnp.float64)
    prob = make_lti_problem(spec, 40)
    res = ilqg(prob, spec.x0, spec.u0,
               cfg=ILQGConfig(verbosity=1, max_iter=50, iter_cap=3,
                              tol_fun=0.0, tol_grad=0.0))
    jax.block_until_ready(res.u)
    _drain()
    out = capfd.readouterr().out
    if int(res.reason) == 0:
        assert "iteration cap reached" in out
    else:  # problem converged inside 3 trips — still must print an exit
        assert ("SUCCESS" in out) or ("EXIT" in out)


def test_boxqp_verbose_prints(capfd):
    A = jax.random.normal(jax.random.PRNGKey(3), (4, 4), jnp.float64)
    H = A @ A.T + 0.5 * jnp.eye(4)
    g = jax.random.normal(jax.random.PRNGKey(4), (4,), jnp.float64)
    res = boxqp(H, g, -0.3 * jnp.ones(4), 0.3 * jnp.ones(4), jnp.zeros(4),
                verbose=2)
    jax.block_until_ready(res.x)
    _drain()
    out = capfd.readouterr().out
    assert "Starting box-QP, dimension 4" in out
    assert "iter" in out and "n_clamped" in out
    assert "RESULT:" in out
    # the printed result string matches the reference table for the code
    from differentialdynamicprogramming_jl_tpu.utils.printing import (
        _BOXQP_RESULTS)
    assert _BOXQP_RESULTS[int(res.result) + 1] in out


def test_silent_by_default(capfd):
    spec = random_lti(jax.random.PRNGKey(0), n=4, m=2, T=30,
                      dtype=jnp.float64)
    prob = make_lti_problem(spec, 30)
    res = ilqg(prob, spec.x0, spec.u0, cfg=ILQGConfig(max_iter=5))
    jax.block_until_ready(res.u)
    _drain()
    assert capfd.readouterr().out == ""

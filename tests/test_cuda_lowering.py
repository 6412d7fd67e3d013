"""Every lane-kernel variant lowers for CUDA from this CPU host.

``jax.jit(...).trace(...).lower(lowering_platforms=("cuda",))`` runs the
Pallas → Triton lowering, which is where an operation the Triton route does
not support, or a tensor that is not a power of two, is refused. Turning the
Triton IR into a cubin needs the card and happens there (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import pytest

from differentialdynamicprogramming_jl_tpu.models.pendcart import (
    pendcart_lanes, pendcart_lanes_param, pendcart_derivs_tiles_param,
    pendcart_derivs_tiles_so)
from differentialdynamicprogramming_jl_tpu.models.quadrotor import (
    quadrotor_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.autodiff_tiles import (
    autodiff_derivs_tiles)
from differentialdynamicprogramming_jl_tpu.ops.pallas.backward_kernel import (
    InLayout, backward_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.forward_kernel import (
    forward_lanes, linesearch_lanes)
from differentialdynamicprogramming_jl_tpu.ops.pallas.pack import lane_shape

B, T = 300, 37              # a ragged batch tile and an odd horizon
L = lane_shape(B)


def sd(*lead):
    return jax.ShapeDtypeStruct(tuple(lead) + L, jnp.float32)


def _lti_m3_model():
    from differentialdynamicprogramming_jl_tpu.models.linear import (
        random_lti, lti_lanes)
    spec = random_lti(jax.random.PRNGKey(0), n=4, m=3, T=T,
                      dtype=jnp.float32)
    return lti_lanes(spec)


def _backward(kind):
    """(function, abstract args) of one backward-kernel variant."""
    lims1 = ((-5.0, 5.0),)
    if kind == "m1_packed":
        return (lambda dp, lam: backward_lanes(
            dp, lam, n=4, m=1, reg_type=2, lims=lims1, k_t=4),
            (sd(T, InLayout(4, 1).DU), sd()))
    if kind == "m2_autodiff":
        tiles = autodiff_derivs_tiles(quadrotor_lanes())
        return (lambda tr, lam: backward_lanes(
            tr, lam, n=6, m=2, reg_type=2, lims=((0.0, 5.0),) * 2,
            derivs_tiles=tiles, emit="gains"),
            (sd(T, 9), sd()))
    if kind == "m3_masked_qp":
        tiles = autodiff_derivs_tiles(_lti_m3_model())
        return (lambda tr, lam: backward_lanes(
            tr, lam, n=4, m=3, reg_type=1, lims=((-1.0, 1.0),) * 3,
            derivs_tiles=tiles),
            (sd(T, 7), sd()))
    if kind == "gps":
        return (lambda dp, lam, prev, eta: backward_lanes(
            dp, lam, n=4, m=1, lims=lims1, prev=prev, eta=eta,
            emit="policy"),
            (sd(T, InLayout(4, 1).DU), sd(), sd(T, 1 + 4 + 1), sd(T, 1)))
    if kind == "params_lims":
        return (lambda tr, lam, par, lim: backward_lanes(
            tr, lam, n=4, m=1, reg_type=2,
            derivs_tiles=pendcart_derivs_tiles_param(), params=par,
            lims_lanes=lim),
            (sd(T, 6), sd(), sd(2), sd(2)))
    if kind == "second_order":
        return (lambda tr, lam: backward_lanes(
            tr, lam, n=4, m=1, reg_type=1,
            derivs_tiles=pendcart_derivs_tiles_so()),
            (sd(T, 6), sd()))
    raise ValueError(kind)


def _forward(kind):
    model = pendcart_lanes()
    if kind == "forward_traj_echo":
        return (lambda tr, g, x0, al: forward_lanes(
            tr, g, x0, al, model=model, lims=((-5.0, 5.0),), gk=0, gK=1,
            emit_traj=True, emit_echo=True, k_t=3),
            (sd(T, 5), sd(T, 5), sd(4), sd(1)))
    if kind == "forward_params_totals":
        return (lambda tr, g, x0, al, par, lim: forward_lanes(
            tr, g, x0, al, par, lim, model=pendcart_lanes_param(),
            gk=0, gK=1),
            (sd(T, 5), sd(T, 5), sd(4), sd(6), sd(2), sd(2)))
    if kind == "linesearch_alias":
        return (lambda tr, g, x0, sel: linesearch_lanes(
            tr, g, x0, sel, model=model, alphas=(1.0, 0.5, 0.25),
            reduce_ratio_min=0.0, lims=((-5.0, 5.0),), gk=0, gK=1,
            g_slots=5, in_place=True),
            (sd(T, 6), sd(T, 27), sd(4), sd(4)))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", [
    "m1_packed", "m2_autodiff", "m3_masked_qp", "gps", "params_lims",
    "second_order", "forward_traj_echo", "forward_params_totals",
    "linesearch_alias"])
def test_kernel_lowers_for_cuda(kind):
    fn, args = (_backward(kind) if not kind.startswith(("forward",
                                                        "linesearch"))
                else _forward(kind))
    lowered = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    if kind == "linesearch_alias":
        # the in-place trajectory update survives as an output alias
        assert "output_operand_aliases" in text

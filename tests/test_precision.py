"""Every matrix product of the f32 LM programs runs at HIGHEST precision.

On the GPU an f32 ``dot_general`` at default precision may run in TF32
(~1e-3 relative), which would put its rounding into the CG matvec and
the Hessian blocks. This traces the init and iteration programs of the
jitted solver for each linear solver and stored W precision and checks
every ``dot_general`` in the jaxpr, nested programs included.
"""

import functools

import jax
import jax.extend
import jax.numpy as jnp
import pytest

from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
from bundleadjustment_jl_tpu.solver import lm_jit

HIGHEST = jax.lax.Precision.HIGHEST


def _subjaxprs(value):
    if isinstance(value, jax.extend.core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jax.extend.core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from _dot_precisions(sub)


def _is_highest(precision):
    return (isinstance(precision, tuple)
            and all(p == HIGHEST for p in precision))


SOLVERS = {"pcg": {}, "dense": {"use_dense": True},
           "cgls": {"use_cgls": True}, "power": {"use_power": True}}
FACTO = {"f32": None, "bf16": jnp.bfloat16, "f16": jnp.float16}


@functools.cache
def _problem():
    p, _ = synthetic_bal(ncams=6, npnts=40, obs_per_pnt=3, seed=1,
                         dtype=jnp.float32)
    return p


@pytest.mark.parametrize("facto", sorted(FACTO))
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_every_dot_general_is_highest(solver, facto):
    problem = _problem()
    _, (cams, points, hp, static) = lm_jit._split_kw(
        problem, None, None, 5,
        dict(SOLVERS[solver], facto_dtype=FACTO[facto], linesearch=True))
    init = jax.make_jaxpr(functools.partial(lm_jit._lm_init_impl, **static))(
        problem, cams, points, hp)
    state = jax.eval_shape(functools.partial(lm_jit._lm_init, **static),
                           problem, cams, points, hp)
    run = jax.make_jaxpr(functools.partial(lm_jit._lm_run_impl, **static))(
        problem, state, hp)
    precisions = list(_dot_precisions(init.jaxpr))
    precisions += list(_dot_precisions(run.jaxpr))
    assert precisions, "no dot_general traced"
    bad = [p for p in precisions if not _is_highest(p)]
    assert not bad, f"{len(bad)} of {len(precisions)} products: {bad[:3]}"


def test_checker_sees_default_precision():
    """The check itself: a default-precision einsum is reported."""
    jaxpr = jax.make_jaxpr(lambda a, b: jnp.einsum("ij,jk->ik", a, b))(
        jnp.ones((3, 3), jnp.float32), jnp.ones((3, 3), jnp.float32))
    assert not all(_is_highest(p) for p in _dot_precisions(jaxpr.jaxpr))

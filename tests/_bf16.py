"""JAX's bf16 products on the CPU, shared by the tests that hold the port's
bf16 compute path against the JAX package's (``test_torch_bf16.py``,
``test_torch_maddpg_bf16.py``).

XLA's CPU backend has no bf16 x bf16 -> f32 dot, so these tests run JAX
under ``bf16_dots``: ``lax.dot_general`` (and ``jnp.einsum``, which binds it
at import) upcast a bf16 operand to float32 and multiply at
``Precision.HIGHEST``. A product of two bf16 values is exact in float32, so
this computes what a bf16 dot with float32 accumulation computes, up to the
order of the sum. ``mpe_tpu`` itself is not changed.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax._src.lax import lax as lax_internal


def patch_bf16_dots(monkeypatch):
    """JAX's bf16 products on the CPU: a dot_general with a bf16 operand
    multiplies the operands' float32 values at HIGHEST precision and returns
    its preferred (else its promoted) dtype."""
    orig = lax_internal.dot_general

    def dot_general(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                    **kw):
        types = (jnp.result_type(lhs), jnp.result_type(rhs))
        if jnp.bfloat16 not in types:
            return orig(lhs, rhs, dimension_numbers, precision=precision,
                        preferred_element_type=preferred_element_type, **kw)
        out = orig(jnp.asarray(lhs, jnp.float32), jnp.asarray(rhs, jnp.float32),
                   dimension_numbers, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32, **kw)
        return out.astype(preferred_element_type or jnp.result_type(*types))

    monkeypatch.setattr(lax_internal, "dot_general", dot_general)
    monkeypatch.setattr(jax.lax, "dot_general", dot_general)
    monkeypatch.setattr(jnp, "einsum", functools.partial(jnp.einsum, _dot_general=dot_general))


@pytest.fixture
def bf16_dots(monkeypatch):
    patch_bf16_dots(monkeypatch)

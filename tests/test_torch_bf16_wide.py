"""The plain bf16 updates (``plain_ppo_update`` / ``plain_mappo_update``
with ``compute_dtype=torch.bfloat16``, what K6-bf16 and K7-bf16 compute) at
hidden 128 and 256 against the JAX package's ``fused_ppo_update`` /
``fused_mappo_update(..., interpret=True, compute_dtype=bfloat16)`` on the
CPU, under ``tests/_bf16.py``'s ``bf16_dots`` (XLA's CPU backend has no bf16
dot; the patch multiplies the bf16 operands' float32 values at HIGHEST
precision, exact products summed in float32). The batches are
``tests/test_torch_bf16.py``'s, made with numpy from a seed at the width:
PPO on simple_spread and MAPPO on simple_speaker_listener at both widths,
and MAPPO on simple_world_comm (its 204-wide critic) at 128, each on the
epoch-0 batch and with both clips binding.

Tolerance, as at hidden 16 (``test_torch_bf16.py``, which says why): each
leaf within ``PLAIN_TOL`` = 1e-3 of its largest entry, the metrics within
1e-5 relative (at epoch 0 the pg mean is 0 up to rounding and is not
compared). At 256 the port's bf16 grads also lie at least 10x nearer JAX's
bf16 grads than JAX's float32 grads. No trainer iteration is compared at
these widths: float32 Adam turns the rounding of near-zero gradient entries
into steps of up to the learning rate (``tests/test_torch_wide_hidden.py``).
The CUDA kernels at these widths are held to the same plain versions by
``tests/test_torch_bf16_wide_host.py`` (built for the host) and
``chip_smoke.py`` (on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests._bf16 import bf16_dots  # noqa: F401 (the fixture)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_bf16 import (METRIC_RTOL, PLAIN_TOL, _batch, _jax_update, _leaf_errors,
                                   _port)

CASES = [pytest.param(kind, name, h, clipped, id=f"{kind}-{name}-{h}-{tag}")
         for kind, name, widths in (("ppo", "simple_spread", (128, 256)),
                                    ("mappo", "simple_speaker_listener", (128, 256)),
                                    ("mappo", "simple_world_comm", (128,)))
         for h in widths for clipped, tag in ((False, "epoch0"), (True, "clipped"))]


@pytest.mark.parametrize("kind, name, hidden, clipped", CASES)
def test_wide_plain_bf16_update_matches_jax_bf16_kernel(bf16_dots, kind, name, hidden, clipped):
    got, got_m = _port(kind, *_batch(kind, name, clipped, hidden))
    want, want_m = _jax_update(kind, name, clipped, jnp.bfloat16, hidden)
    for k, x in got.items():
        assert x.dtype == np.float32 and x.shape == want[k].shape, k
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= PLAIN_TOL, errs
    gated = [0, 1, 2] if clipped else [1, 2]     # epoch 0: the pg mean is 0 up to rounding
    np.testing.assert_allclose(np.take(got_m, gated), np.take(want_m, gated), rtol=METRIC_RTOL)


@pytest.mark.parametrize("kind, name", [("ppo", "simple_spread"),
                                        ("mappo", "simple_speaker_listener")])
def test_wide_bf16_grads_lie_nearer_jax_bf16_than_jax_f32(bf16_dots, kind, name):
    got, _ = _port(kind, *_batch(kind, name, True, 256))
    to_bf16 = max(_leaf_errors(got, _jax_update(kind, name, True, jnp.bfloat16, 256)[0]).values())
    to_f32 = max(_leaf_errors(got, _jax_update(kind, name, True, jnp.float32, 256)[0]).values())
    assert 10 * to_bf16 <= to_f32, (to_bf16, to_f32)

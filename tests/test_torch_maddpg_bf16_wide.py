"""The plain bf16 MADDPG update (``plain_maddpg_update(...,
compute_dtype=torch.bfloat16)``, what K9-bf16 computes) at hidden 128 and
256 against the JAX package's ``fused_maddpg_update(..., interpret=True,
compute_dtype=bfloat16)`` on the CPU, under ``tests/_bf16.py``'s
``bf16_dots`` (XLA's CPU backend has no bf16 dot; the patch multiplies the
bf16 operands' float32 values at HIGHEST precision, exact products summed in
float32), on simple_spread and simple_speaker_listener (a comm head, 15
candidates) at a batch of 256, four blocks of ``block_b=64`` on the JAX side.
At these widths JAX takes its one-agent-a-group branch (``_tile_groups``).

The inputs are made as ``tests/test_torch_maddpg_bf16.py`` makes them, with
numpy from a seed at the width: JAX's ``init_maddpg`` with the actors' head
scaled to O(1) logits, targets = params + 0.1 N(0, 1), replay rows with
one-hot actions.

Tolerances. Both sides round the same float32 values to bf16, but each takes
its float32 sums in its own order (XLA's dot against the plain version's
products in input order), and an activation next to a bf16 rounding boundary
then rounds a whole ulp (2^-8) apart. At 128 and 256 units there are many
more such activations per sample than at 16 (where the two agree to 2.5e-6),
and through the candidates' Q they reach the ill-conditioned expected-Q
gradient: the plain version against itself with its forward sums reversed
moves a leaf by up to 1.1e-3 of its largest entry at a batch of 64 (spread at
256), and JAX's order by up to 2.4e-3. Such moves add with random signs while
a leaf grows with the batch, so the batch is 256, where the largest measured
error is 7.8e-4 (spread at 256):
- the target actions equal JAX's;
- each leaf within ``PLAIN_TOL`` = 1e-3 of its largest entry;
- the metrics within ``WIDE_METRIC_RTOL`` = 1e-3 relative, the kernels' own
  gate (``chip_smoke.py::BF16_METRIC_RTOL``): the actor loss and the Q mean
  are means of terms of either sign, so one ulp's move in a candidate's Q is
  a larger part of them (measured 6.6e-5 on spread at 256; the critic loss
  1e-6);
- at 256 the port's bf16 grads lie at least 10x nearer JAX's bf16 grads than
  JAX's float32 grads.
No update chunk is compared at these widths: float32 Adam turns the rounding
of near-zero gradient entries into steps of up to the learning rate
(``tests/test_torch_maddpg_wide.py``). The CUDA kernels at these widths are
held to the same plain version by ``tests/test_torch_maddpg_bf16_wide_host.py``
(built for the host) and ``chip_smoke.py`` (on the card).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu.learner import maddpg as jm
from mpe_tpu.ops.fused_maddpg_update import fused_maddpg_update as j_update
from mpe_tpu.ops.fused_update import _dot as j_dot
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.ops import fused_maddpg_update as tu
from tests._bf16 import bf16_dots  # noqa: F401 (the fixture)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_maddpg_bf16 import (ENTC, GAMMA, MW, PLAIN_TOL,
                                          _leaf_errors, _leaves)

WIDTHS = (128, 256)
BATCH = 256
WIDE_METRIC_RTOL = 1e-3
NAMES = ("simple_spread", "simple_speaker_listener")
BF16 = torch.bfloat16


@functools.cache
def _case(name, hidden):
    """(agents, obs width, head width, params, targets, rows) as numpy at
    ``hidden``, as ``test_torch_maddpg_bf16._case`` makes them."""
    kscn = j_kernel_scenario(name)
    a, o = kscn.spec.n_agents, kscn.obs_w
    k = MW + (kscn.spec.dim_c if kscn.uses_comm else 0)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jm.init_maddpg(jax.random.PRNGKey(3), o, k, a, hidden=hidden))
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    rng = np.random.default_rng(4)
    targets = jax.tree.map(lambda x: (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32),
                           params)
    act = np.eye(MW)[rng.integers(0, MW, (BATCH, a))]
    if k > MW:
        act = np.concatenate([act, np.eye(k - MW)[rng.integers(0, k - MW, (BATCH, a))]], -1)
    rows = np.concatenate([rng.normal(size=(BATCH, a * o)), act.reshape(BATCH, -1),
                           rng.normal(size=(BATCH, a)) - 2.0,
                           rng.normal(size=(BATCH, a * o))], 1).astype(np.float32)
    return a, o, k, params, targets, rows


@functools.cache
def _jax_grads(name, hidden, compute_dtype):
    """JAX's kernel on ``_case(name, hidden)`` in interpret mode (once per
    module, under ``bf16_dots``) -> (leaves, metrics, target actions [B, A,
    heads])."""
    a, o, k, params, targets, rows = _case(name, hidden)
    fn = j_update(a, o, k, MW, hidden=hidden, batch=BATCH, gamma=GAMMA, ent_coef=ENTC,
                  block_b=64, interpret=True, compute_dtype=compute_dtype)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    grads, metrics = fn.from_rows(jp, jt, jnp.asarray(rows))
    # the kernel's target actions: the packed target actors on the s' columns
    ta = fn.pack_params(jt)["actor"]
    x = jnp.asarray(rows[:, a * (o + k + 1):].T)                          # [A*O, B]
    h = jnp.tanh(j_dot(ta["l1"]["w"], x, compute_dtype) + ta["l1"]["b"])
    h = jnp.tanh(j_dot(ta["l2"]["w"], h, compute_dtype) + ta["l2"]["b"])
    z = np.asarray(j_dot(ta["out"]["w"], h, compute_dtype) + ta["out"]["b"]).T.reshape(-1, a, k)
    idx = [z[..., :MW].argmax(-1)] + ([z[..., MW:].argmax(-1)] if k > MW else [])
    return _leaves(grads), [float(m) for m in metrics], np.stack(idx, -1)


def _port(name, hidden, compute_dtype=BF16):
    a, o, k, params, targets, rows = _case(name, hidden)
    tp, tt = (params_from_numpy(x, device="cpu") for x in (params, targets))
    grads_fn = tu.fused_maddpg_update(a, o, k, MW, hidden, BATCH, gamma=GAMMA, ent_coef=ENTC,
                                      device="cpu", compute_dtype=compute_dtype)
    grads, metrics = grads_fn.from_rows(tp, tt, torch.tensor(rows))
    obs2 = torch.tensor(rows[:, a * (o + k + 1):]).reshape(BATCH, a, o)
    idx = tu.target_indices(tu.target_logits(tt["actor"], obs2, compute_dtype), MW)
    return _leaves(params_to_numpy(grads)), [float(m) for m in metrics], idx.numpy()


@pytest.mark.parametrize("hidden", WIDTHS)
@pytest.mark.parametrize("name", NAMES)
def test_wide_plain_bf16_maddpg_update_matches_jax_bf16_kernel(bf16_dots, name, hidden):
    got, got_m, got_idx = _port(name, hidden)
    want, want_m, want_idx = _jax_grads(name, hidden, jnp.bfloat16)
    for key, x in got.items():
        assert x.shape == want[key].shape, key
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= PLAIN_TOL, errs
    np.testing.assert_allclose(got_m, want_m, rtol=WIDE_METRIC_RTOL)
    np.testing.assert_array_equal(got_idx, want_idx)


@pytest.mark.parametrize("name", NAMES)
def test_wide_bf16_maddpg_grads_lie_nearer_jax_bf16_than_jax_f32(bf16_dots, name):
    got, _, _ = _port(name, 256)
    to_bf16 = max(_leaf_errors(got, _jax_grads(name, 256, jnp.bfloat16)[0]).values())
    to_f32 = max(_leaf_errors(got, _jax_grads(name, 256, jnp.float32)[0]).values())
    assert 10 * to_bf16 <= to_f32, (to_bf16, to_f32)

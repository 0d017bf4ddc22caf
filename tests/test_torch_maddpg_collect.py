"""Plain K8 (the MADDPG collection) on the eight scenarios other than
simple_spread, comm heads included, against
``fused_maddpg_trajectory(interpret=True)`` of the JAX package on the CPU:
both output forms, eps 0 and 0.1, action one-hots (a silent agent's raw comm
sample included) equal, the rest within 1e-5 (``test_torch_maddpg.py`` holds
simple_spread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu.learner import maddpg as jm
from mpe_tpu.ops.fused_maddpg import fused_maddpg_trajectory as j_traj
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy
from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory as t_traj
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

OTHERS = ["simple", "simple_reference", "simple_speaker_listener", "simple_adversary",
          "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
MW = 5


def _dims(name):
    """(agents, obs width, comm logits) of the scenario's MADDPG nets."""
    kscn = kernel_scenario(name)
    return kscn.spec.n_agents, kscn.obs_w, kscn.n_comm


def _jax_actor(name, hidden=16, seed=0):
    a, ow, cw = _dims(name)
    params = jm.init_maddpg(jax.random.PRNGKey(seed), ow, MW + cw, a, hidden=hidden)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params["actor"])


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("name", OTHERS)
def test_plain_maddpg_trajectory_matches_jax_interpret(name, eps):
    kw = dict(n_envs=16, n_steps=8, horizon=3, eps_greedy=eps, block_envs=8, t_chunk=4)
    a, ow, cw = _dims(name)
    actor = _jax_actor(name)
    tactor = params_from_numpy(actor, device="cpu")
    kscn = j_kernel_scenario(name)
    aw = MW + cw
    act_cols = np.zeros(a * (2 * ow + aw + 1), bool)
    act_cols[a * ow:a * (ow + aw)] = True
    for rows in (False, True):
        want = j_traj(kscn, actor, interpret=True, emit_rows=rows, **kw)(
            5, jax.tree.map(jnp.asarray, actor), 1)
        got = t_traj(name, tactor, emit_rows=rows, device="cpu", **kw)(5, tactor, 1)
        if rows:
            g, w = got.numpy(), np.asarray(want)
            assert got.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g[..., act_cols], w[..., act_cols])
            np.testing.assert_allclose(g[..., ~act_cols], w[..., ~act_cols], rtol=0, atol=1e-5)
            continue
        for label, g, w in zip(("obs", "act", "rew", "obs2"), got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, label
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=0 if label == "act" else 1e-5, err_msg=label)
        act = got[1].numpy()                                  # [T, A, 5 + C, N]
        np.testing.assert_array_equal(act[:, :, :MW].sum(2), np.ones((8, a, 16)))
        if cw:                                                # every agent's raw comm is stored
            np.testing.assert_array_equal(act[:, :, MW:].sum(2), np.ones((8, a, 16)))

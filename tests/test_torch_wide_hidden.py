"""The port's MLP kernels at hidden widths 128 and 256 (their plain versions:
K4, K5, K6, K7) and the fused PPO and MAPPO trainers at 256, against the JAX
package on the CPU. The params come from JAX's ``init_ac`` / ``init_mappo``
/ ``init_policy`` at the width and cross with ``params_from_numpy``; the
batches are made with numpy from a seed and handed to both packages.

- K6 (``plain_ppo_update``) and K7 (``plain_mappo_update``) in float32
  against the JAX kernels in Pallas interpret mode: every leaf within 1e-4
  of its largest entry, the metrics within 1e-4 relative, each kernel at
  each width and on each of two batches (F32_CASES): simple_spread at
  epoch 0, and simple_speaker_listener (a comm head, a silent agent) with
  logp_old moved by ``clip_binding_inputs`` (the ratio clip binds for
  about half of the samples) and v_old moved past the value clip for every
  sample (where that clip does not bind the JAX kernel drops a value
  gradient that rounding puts on vc's branch, ROADMAP C, so the two are
  compared where it binds); in float64 against ``jax.grad`` of the
  trainer's loss at 1e-10 on simple_spread at epoch 0 and on
  simple_speaker_listener with both clips binding for about half of the
  samples (``clip_binding_inputs``);
- K5 and K4 (the plain trajectory and evaluation rollouts) against
  ``fused_policy_trajectory`` / ``fused_policy_rollout`` in interpret mode,
  on simple_spread at 128 and simple_speaker_listener at 256: moves, comm
  indices and episodes equal, the rest within 1e-5;
- two iterations of ``build_fused_ppo_step`` and ``build_fused_mappo_step``
  at hidden 256 (64 envs x 8 steps) against JAX's fused trainers on a
  one-device CPU mesh, from the same float64 params, the updates in float64
  on both sides (the collection stays float32): metrics and params at atol
  and rtol 1e-5. In float32 Adam's normalized step turns the rounding of
  near-zero gradient entries (the critic's saturated units at this width)
  into steps of up to the learning rate, one way or the other, so the
  float32 params of the two trainers part by more than 1e-5 on the critic's
  weights while their metrics still agree within it.

The CUDA kernels at these widths are held to the same plain versions by
``tests/test_torch_wide_host.py`` (built for the host) and ``chip_smoke.py``
(on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mpe_tpu.learner.fused_ppo as j_ppo
from mpe_tpu.ops.fused_update import fused_mappo_update as j_fused_mappo_update
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.learner import fused_ppo as t_ppo
from mpe_tpu_torch.ops import fused_update as t_update
from tests import test_torch_mappo as mappo_t
from tests import test_torch_update as ppo_t
from tests.test_torch_policy import F32_TOL, SMALL, _np, _params, j_kernel_scenario, j_policy, \
    t_policy

WIDE = (128, 256)
CLIP, VF, ENTC = ppo_t.CLIP, ppo_t.VF, ppo_t.ENTC
T, N = ppo_t.T, ppo_t.N
assert (T, N) == (mappo_t.T, mappo_t.N)
# simple_spread at epoch 0 (value_old = value); simple_speaker_listener with
# both clips binding
BATCHES = [("simple_spread", False), ("simple_speaker_listener", True)]
BATCH_IDS = ["spread-epoch0", "speaker_listener-clips_bind"]
# against the JAX kernels in interpret mode (seconds each): each kernel at
# each width, each kernel on both batches
F32_CASES = [pytest.param(kind, h, *BATCHES[i], id=f"{kind}-{h}-{BATCH_IDS[i]}")
             for kind, h, i in (("ppo", 128, 0), ("ppo", 256, 1), ("mappo", 128, 1),
                                ("mappo", 256, 0))]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain versions run many small ops, which
    several threads a process only slow down when the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bind_clips(batch, value_everywhere: bool):
    """The epoch-0 batch with logp_old and v_old moved by
    ``clip_binding_inputs`` (numpy in, numpy out, in the batch's dtype); with
    ``value_everywhere`` v_old instead moved by 0.3 |N(0, 1)| past the value
    clip (and its 1e-3 margin) for every sample, either side."""
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = batch
    lpo, vold, shares = t_update.clip_binding_inputs(
        torch.tensor(logp_old), torch.tensor(value_old), clip=CLIP,
        generator=torch.Generator().manual_seed(5))
    assert all(0.2 < s < 0.8 for s in shares), shares
    vold = vold.numpy()
    if value_everywhere:
        rng = np.random.default_rng(6)
        far = CLIP + 2e-3 + 0.3 * np.abs(rng.normal(size=value_old.shape))
        vold = (value_old + np.where(rng.random(value_old.shape) < 0.5, -far, far)).astype(
            value_old.dtype)
    return obs, mv_oh, cm_oh, lpo.numpy(), vold, adv_n, ret


def _case(kind: str, name: str, clips: bool, hidden: int, dtype):
    """(kernel scenario, params, batch) as numpy in ``dtype``: test_torch_update's
    PPO batch or test_torch_mappo's MAPPO batch at ``hidden``, the clips
    bound as ``_bind_clips`` binds them (float32: the value clip for every
    sample)."""
    if kind == "ppo":
        kscn, params, batch = ppo_t._batch(dtype, name=name, hidden=hidden)
    else:
        kscn, params, batch = mappo_t._batch(name=name, hidden=hidden)
        params = jax.tree.map(lambda x: x.astype(dtype), params)
        batch = tuple(None if x is None else x.astype(dtype) for x in batch)
    return kscn, params, _bind_clips(batch, dtype == np.float32) if clips else batch


def _port(kind: str, kscn, params, batch, dtype):
    if kind == "ppo":
        return ppo_t._port(kscn, params, batch, dtype)
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else torch.tensor(x)
                                                           for x in batch)
    update = t_update.fused_mappo_update(kscn.spec.name, N, T, params["a1"]["w"].shape[1],
                                         clip=CLIP, vf_coef=VF, ent_coef=ENTC, device="cpu",
                                         dtype=dtype)
    return update(params_from_numpy(params, device="cpu", dtype=dtype), obs, mv_oh, cm_oh,
                  logp_old, adv_n, ret, value_old)


def _jax_kernel_f32(kind: str, kscn, params, batch):
    if kind == "ppo":
        return ppo_t._jax_kernel(kscn, params, batch, jnp.float32)
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else jnp.asarray(x)
                                                           for x in batch)
    update = j_fused_mappo_update(kscn, n_envs=N, n_steps=T, hidden=params["a1"]["w"].shape[1],
                                  clip=CLIP, vf_coef=VF, ent_coef=ENTC, block_envs=64, t_chunk=4,
                                  interpret=True, compute_dtype=jnp.float32)
    return update(jax.tree.map(jnp.asarray, params), obs, mv_oh, cm_oh, logp_old, adv_n, ret,
                  value_old)


@pytest.mark.parametrize("kind, hidden, name, clips", F32_CASES)
def test_plain_update_f32_matches_jax_kernel_at_wide_width(kind, hidden, name, clips):
    kscn, params, batch = _case(kind, name, clips, hidden, np.float32)
    got, got_m = _port(kind, kscn, params, batch, torch.float32)
    want, want_m = _jax_kernel_f32(kind, kscn, params, batch)
    got_l, want_l = ppo_t._leaves(got), ppo_t._leaves(want)
    assert sorted(got_l) == sorted(want_l)
    assert got_l["l1.w" if kind == "ppo" else "a1.w"].shape[-1] == hidden
    for leaf, w in want_l.items():
        assert got_l[leaf].dtype == np.float32 and got_l[leaf].shape == w.shape, leaf
        np.testing.assert_allclose(got_l[leaf], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=leaf)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m], rtol=1e-4)


@pytest.mark.parametrize("name, clips", BATCHES, ids=BATCH_IDS)
@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("kind", ["ppo", "mappo"])
def test_plain_update_f64_matches_jax_grad_at_wide_width(kind, hidden, name, clips):
    kscn, params, batch = _case(kind, name, clips, hidden, np.float64)
    got, got_m = _port(kind, kscn, params, batch, torch.float64)
    module = ppo_t if kind == "ppo" else mappo_t
    module._assert_f64_equal(got, got_m, *module._jax_grad(kscn, params, batch))


@pytest.mark.parametrize("hidden, name", [(128, "simple_spread"),
                                          (256, "simple_speaker_listener")])
def test_plain_policy_kernels_match_jax_interpret_at_wide_width(hidden, name):
    """K5 (one block offset) and K4 (another) at ``hidden``: actions and
    episodes equal, obs, rewards, returns and positions within 1e-5."""
    kscn = j_kernel_scenario(name)
    tree, params = _params(hidden=hidden, seed=hidden, name=name)
    j_run = j_policy.fused_policy_trajectory(name, tree, t_chunk=4, interpret=True, **SMALL)
    t_run = t_policy.fused_policy_trajectory(name, params, t_chunk=4, device="cpu", **SMALL)
    want, got = j_run(11, tree, 3), t_run(11, params, 3)
    assert len(got) == len(want) == (5 if kscn.uses_comm else 4)
    n_int = 2 if kscn.uses_comm else 1
    for k, (x, y) in enumerate(zip(got, want)):
        if 1 <= k <= n_int:
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=f"output {k}")
        else:
            np.testing.assert_allclose(_np(x), _np(y), err_msg=f"output {k}", **F32_TOL)
    assert len(np.unique(_np(got[1]))) == 5                      # every move is drawn
    j_eval = j_policy.fused_policy_rollout(name, tree, interpret=True, **SMALL)
    t_eval = t_policy.fused_policy_rollout(name, params, device="cpu", **SMALL)
    want, (ret, pos, eps) = j_eval(4, tree, 1), t_eval(4, params, 1)
    np.testing.assert_array_equal(_np(eps), _np(want[2]))
    for k, a, b in zip(("ret", "pos"), (ret, pos), want[:2]):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=k, **F32_TOL)


@pytest.mark.parametrize("kind", ["ppo", "mappo"])
def test_fused_trainers_match_jax_two_iterations_at_hidden_256(kind):
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=256, block_envs=32, t_chunk=4)
    j_build = j_ppo.build_fused_ppo_step if kind == "ppo" else j_ppo.build_fused_mappo_step
    t_build = t_ppo.build_fused_ppo_step if kind == "ppo" else t_ppo.build_fused_mappo_step
    j_step = j_build("simple_spread", Mesh(np.array(jax.devices()[:1]), ("env",)),
                     interpret=True, compute_dtype=jnp.float64, **kw)
    t_step = t_build("simple_spread", device="cpu", dtype=torch.float64, **kw)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          j_step.init_params(jax.random.PRNGKey(0)))
    assert params["l1" if kind == "ppo" else "a1"]["w"].shape == (18, 256)
    j_state = j_step.init_state(jax.tree.map(jnp.asarray, params))
    t_state = t_step.init_state(params_from_numpy(params, device="cpu", dtype=torch.float64))
    for seed in (0, 1):
        j_state, j_m = j_step(j_state, seed)
        t_state, t_m = t_step(t_state, seed)
        assert sorted(t_m) == sorted(j_m)
        for key in j_m:
            np.testing.assert_allclose(float(t_m[key]), float(j_m[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"iteration {seed}: {key}")
        want = ppo_t._leaves(j_state[0])
        for leaf, x in ppo_t._leaves(params_to_numpy(t_state[0])).items():
            assert x.dtype == want[leaf].dtype == np.float64
            np.testing.assert_allclose(x, want[leaf], rtol=1e-5, atol=1e-5,
                                       err_msg=f"iteration {seed}: {leaf}")
    assert t_state[1].count == 2 * 4

"""The port's fused PPO trainer and its pieces against the JAX package on
the CPU.

- the clip + Adam optimizer against optax, 5 steps in float64, the clip
  active on some steps and not on others, with a fixed and an annealed
  learning rate: params and moments at 1e-12;
- ``_gae_minor`` in float64 at 1e-12; ``_factored_onehots`` and
  ``_factored_logp_ent`` in float64 at 1e-12, move-only and with a comm
  factor and silent agents (simple_speaker_listener, simple_world_comm);
- two iterations of ``build_fused_ppo_step(device="cpu")`` against the JAX
  ``build_fused_ppo_step`` on a one-device CPU mesh (kernels in Pallas
  interpret mode, float32) from the same initial params, on simple_spread
  and simple_reference (two speakers): metrics and params at atol and rtol
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import mpe_tpu.learner.fused_ppo as j_ppo
from mpe_tpu.learner.ppo import init_ac as j_init_ac
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.learner import fused_ppo as t_ppo
from mpe_tpu_torch.learner import optim
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario as t_kernel_scenario
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _leaves(tree):
    return {f"{k}.{q}": np.asarray(tree[k][q]) for k in sorted(tree) for q in sorted(tree[k])}


@pytest.mark.parametrize("anneal_steps", [None, 4])
def test_clip_adam_matches_optax_f64(anneal_steps):
    lr, max_norm = 3e-4, 0.5
    params = jax.tree.map(np.asarray, j_init_ac(jax.random.PRNGKey(0), 18, 5, hidden=8,
                                                dtype=jnp.float64))
    sched = optax.linear_schedule(lr, 0.0, anneal_steps) if anneal_steps else lr
    j_opt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(sched))
    t_opt = optim.clip_adam(optim.linear_schedule(lr, 0.0, anneal_steps) if anneal_steps else lr,
                            max_norm=max_norm)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu", dtype=torch.float64)
    j_state, t_state = j_opt.init(jp), t_opt.init(tp)
    rng = np.random.default_rng(5)
    norms = []
    for scale in (0.003, 2.0, 0.01, 7.0, 0.001):          # the clip on steps 2 and 4
        grads = jax.tree.map(lambda x: scale * rng.normal(size=x.shape), params)
        norms.append(float(optax.global_norm(grads)))
        updates, j_state = j_opt.update(jax.tree.map(jnp.asarray, grads), j_state, jp)
        jp = optax.apply_updates(jp, updates)
        t_updates, t_state = t_opt.update(params_from_numpy(grads, "cpu", torch.float64), t_state)
        tp = optim.apply_updates(tp, t_updates)
        want = _leaves(jp)
        for name, x in _leaves(params_to_numpy(tp)).items():
            assert x.dtype == np.float64
            np.testing.assert_allclose(x, want[name], rtol=1e-12, atol=1e-12, err_msg=name)
    assert min(norms) < max_norm < max(norms)
    adam = j_state[1][0]
    assert t_state.count == int(adam.count) == 5
    for mine, theirs in ((t_state.mu, adam.mu), (t_state.nu, adam.nu)):
        want = _leaves(theirs)
        for name, x in _leaves(params_to_numpy(mine)).items():
            np.testing.assert_allclose(x, want[name], rtol=1e-12, atol=1e-15, err_msg=name)


def test_gae_minor_matches_jax_f64():
    rng = np.random.default_rng(1)
    t, horizon = 12, 5
    values, rewards = rng.normal(size=(2, t, 3, 16))
    last_value = rng.normal(size=(3, 16))
    nonterm = [0.0 if (i + 1) % horizon == 0 else 1.0 for i in range(t)]
    j_adv, j_ret = j_ppo._gae_minor(jnp.asarray(values), jnp.asarray(rewards),
                                    jnp.asarray(nonterm), jnp.asarray(last_value), 0.95, 0.95)
    adv, ret = t_ppo._gae_minor(torch.tensor(values), torch.tensor(rewards), nonterm,
                                torch.tensor(last_value), 0.95, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(j_adv), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ret.numpy(), np.asarray(j_ret), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener",
                                  "simple_world_comm"])
def test_factored_logp_ent_matches_jax_f64(name):
    j_k, t_k = j_kernel_scenario(name), t_kernel_scenario(name)
    a, dim_c = j_k.spec.n_agents, j_k.spec.dim_c if j_k.uses_comm else 0
    rng = np.random.default_rng(2)
    logits = 3.0 * rng.normal(size=(4, a, 5 + dim_c, 16))
    act = rng.integers(0, 5, size=(4, a, 16)).astype(np.int32)
    cact = rng.integers(0, max(dim_c, 1), size=(4, a, 16)).astype(np.int32)
    j_mv, j_cm = j_ppo._factored_onehots(j_k, jnp.asarray(act), jnp.asarray(cact))
    t_mv, t_cm = t_ppo._factored_onehots(t_k, torch.tensor(act), torch.tensor(cact))
    np.testing.assert_array_equal(t_mv.numpy(), np.asarray(j_mv))
    assert (t_cm is None) == (j_cm is None) == (not dim_c)
    if dim_c:
        np.testing.assert_array_equal(t_cm.numpy(), np.asarray(j_cm))
    j_lp, j_ent = j_ppo._factored_logp_ent(
        j_k, jnp.asarray(logits), j_mv.astype(jnp.float64),
        None if j_cm is None else j_cm.astype(jnp.float64))
    lp, ent = t_ppo._factored_logp_ent(t_k, torch.tensor(logits), t_mv.double(),
                                       None if t_cm is None else t_cm.double())
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ent.numpy(), np.asarray(j_ent), rtol=1e-12, atol=1e-12)
    if dim_c:                 # a silent agent's comm factor is masked, a speaker's is not
        lp_move, _ = t_ppo._factored_logp_ent(t_kernel_scenario("simple_spread"),
                                              torch.tensor(logits[..., :5, :]), t_mv.double(),
                                              None)
        silent = j_k.spec.silent[:a]
        np.testing.assert_array_equal(lp.numpy()[:, silent], lp_move.numpy()[:, silent])
        assert (lp.numpy()[:, ~silent] < lp_move.numpy()[:, ~silent]).all()


@pytest.mark.parametrize("name", ["simple_spread", "simple_reference"])
def test_fused_ppo_step_matches_jax_two_iterations(name):
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=16, block_envs=32, t_chunk=4)
    j_step = j_ppo.build_fused_ppo_step(name, Mesh(np.array(jax.devices()[:1]), ("env",)),
                                        interpret=True, compute_dtype=jnp.float32, **kw)
    t_step = t_ppo.build_fused_ppo_step(name, device="cpu", **kw)
    params = jax.tree.map(np.asarray, j_step.init_params(jax.random.PRNGKey(0)))
    j_state = j_step.init_state(jax.tree.map(jnp.asarray, params))
    t_state = t_step.init_state(params_from_numpy(params, device="cpu"))
    assert t_step.n_transitions == 64 * 8
    for seed in (0, 1):
        j_state, j_m = j_step(j_state, seed)
        t_state, t_m = t_step(t_state, seed)
        assert sorted(t_m) == sorted(j_m)
        for key in j_m:
            np.testing.assert_allclose(float(t_m[key]), float(j_m[key]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"iteration {seed}: {key}")
        want = _leaves(j_state[0])
        for name, x in _leaves(params_to_numpy(t_state[0])).items():
            assert x.dtype == np.float32
            np.testing.assert_allclose(x, want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=f"iteration {seed}: {name}")
    assert t_state[1].count == 2 * 4                        # one Adam step per epoch


def test_fused_ppo_step_autograd_epochs_match_kernel_epochs():
    """``fused_update=False`` (autograd of the loss) and the K6 path give the
    same iteration on the same seed (float32 summation order apart)."""
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=16, block_envs=32, t_chunk=4, device="cpu")
    k_step = t_ppo.build_fused_ppo_step("simple_spread", **kw)
    a_step = t_ppo.build_fused_ppo_step("simple_spread", fused_update=False, **kw)
    params = k_step.init_params(torch.Generator().manual_seed(3))
    (k_params, _), k_m = k_step(k_step.init_state(params), 5)
    (a_params, _), a_m = a_step(a_step.init_state(params), 5)
    for key in k_m:
        np.testing.assert_allclose(float(k_m[key]), float(a_m[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want = _leaves(params_to_numpy(a_params))
    for name, x in _leaves(params_to_numpy(k_params)).items():
        np.testing.assert_allclose(x, want[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_ppo_step_float64_matches_float32():
    """``dtype=torch.float64`` keeps the params, prep and update in float64
    (the collection stays float32): one iteration from the same params and
    seed agrees with the float32 trainer to float32 rounding."""
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=16, block_envs=32, t_chunk=4, device="cpu")
    s32 = t_ppo.build_fused_ppo_step("simple_spread", **kw)
    s64 = t_ppo.build_fused_ppo_step("simple_spread", dtype=torch.float64, **kw)
    params = s32.init_params(torch.Generator().manual_seed(4))
    (p32, _), m32 = s32(s32.init_state(params), 9)
    (p64, _), m64 = s64(s64.init_state(optim.tree_map(torch.Tensor.double, params)), 9)
    for key in m32:
        assert m64[key].dtype == torch.float64 or key == "mean_reward", key
        np.testing.assert_allclose(float(m64[key]), float(m32[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want = _leaves(params_to_numpy(p32))
    for name, x in _leaves(params_to_numpy(p64)).items():
        assert x.dtype == np.float64, name
        np.testing.assert_allclose(x, want[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_ppo_step_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ppo.build_fused_ppo_step("simple_spread", 64, n_steps=8, t_chunk=4)

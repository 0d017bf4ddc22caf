"""The port's MAPPO epoch gradient (plain version of kernel K7) and fused
MAPPO trainer against the JAX package on the CPU.

- float64: ``plain_mappo_update`` against ``fused_mappo_update(...,
  interpret=True, compute_dtype=float64)`` and against ``jax.grad`` of the
  trainer's loss at 1e-10 (epoch 0, value_old = value); with value_old
  moved by 0.3 N(0, 1), so that the value clip binds for about half of the
  (t, env) samples, against ``jax.grad`` (the JAX kernel drops the value
  gradient where the clip does not bind and rounding puts vc's branch
  above, ROADMAP C);
- two iterations of ``build_fused_mappo_step(device="cpu")`` against the
  JAX ``build_fused_mappo_step`` on a one-device CPU mesh (kernels in
  Pallas interpret mode, float32) from the same params: metrics and params
  at atol and rtol 1e-5.

The batch is made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mpe_tpu.learner.fused_ppo as j_ppo
from mpe_tpu.learner.ppo import init_mappo as j_init_mappo
from mpe_tpu.ops.fused_update import fused_mappo_update as j_fused_mappo_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.learner import fused_ppo as t_ppo
from mpe_tpu_torch.learner.ppo import init_mappo
from mpe_tpu_torch.ops import fused_update as t_update

CLIP, VF, ENTC = 0.2, 0.5, 0.01
T, N, HIDDEN, A, OW = 4, 128, 16, 3, 18


def _leaves(tree):
    return {f"{k}.{q}": np.asarray(tree[k][q]) for k in sorted(tree) for q in sorted(tree[k])}


def _forward(params, obs, dt):
    """The JAX trainer's actor logits and central value (fused_ppo.py:423-432)."""
    h = j_ppo._torso_minor(params["a1"], params["a2"], obs, dt)
    logits = j_ppo._head_minor(params["pi"], h, dt)
    joint = obs.reshape(obs.shape[:-3] + (A * OW,) + obs.shape[-1:])
    g = j_ppo._torso_minor(params["c1"], params["c2"], joint, dt)
    return logits, j_ppo._head_minor(params["v"], g, dt)[..., 0, :]


def _xla_loss(kscn, params, batch, dt):
    """build_fused_mappo_step's loss_fn with the team advantage already
    normalized."""
    obs, mv_oh, logp_old, value_old, adv_n, ret = batch
    logits, value = _forward(params, obs, dt)
    logp, ent = j_ppo._factored_logp_ent(kscn, logits, mv_oh, None)
    ratio = jnp.exp(logp - logp_old)
    adv_b = adv_n[..., None, :]
    pg = -jnp.minimum(ratio * adv_b, jnp.clip(ratio, 1 - CLIP, 1 + CLIP) * adv_b).mean()
    v_clip = value_old + jnp.clip(value - value_old, -CLIP, CLIP)
    vloss = jnp.maximum(jnp.square(value - ret), jnp.square(v_clip - ret)).mean()
    return pg + VF * vloss - ENTC * ent.mean(), (pg, vloss, ent.mean())


def _batch(value_noise=0.0):
    """Params and an epoch-shaped float64 batch: obs ~ N(0, 1), random moves,
    logp_old from the same forward plus noise (ratios off 1, some clipped),
    value_old the central values plus ``value_noise`` normals, a normalized
    team advantage and random team returns [T, N]."""
    kscn = j_kernel_scenario("simple_spread")
    f64 = jnp.float64
    params = jax.tree.map(np.asarray, j_init_mappo(jax.random.PRNGKey(2), OW, 5, A,
                                                   hidden=HIDDEN, dtype=f64))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(T, A, OW, N))
    mv_oh = np.moveaxis(np.eye(5)[rng.integers(0, 5, size=(T, A, N))], -1, -2)
    logits, value = _forward(params, jnp.asarray(obs), f64)
    logp, _ = j_ppo._factored_logp_ent(kscn, logits, jnp.asarray(mv_oh), None)
    logp_old = np.asarray(logp) + 0.3 * rng.normal(size=(T, A, N))
    value_old = np.asarray(value) + value_noise * rng.normal(size=(T, N))
    adv = rng.normal(size=(T, N))
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    ret = rng.normal(size=(T, N))
    return kscn, params, (obs, mv_oh, logp_old, value_old, adv_n, ret)


def _port(params, batch):
    obs, mv_oh, logp_old, value_old, adv_n, ret = (torch.tensor(x) for x in batch)
    update = t_update.fused_mappo_update("simple_spread", N, T, HIDDEN, clip=CLIP, vf_coef=VF,
                                         ent_coef=ENTC, device="cpu", dtype=torch.float64)
    return update(params_from_numpy(params, device="cpu", dtype=torch.float64), obs, mv_oh,
                  None, logp_old, adv_n, ret, value_old)


def _jax_grad(kscn, params, batch):
    jbatch = tuple(map(jnp.asarray, batch))
    (_, metrics), grads = jax.value_and_grad(
        lambda p: _xla_loss(kscn, p, jbatch, jnp.float64), has_aux=True)(
            jax.tree.map(jnp.asarray, params))
    return grads, metrics


def _assert_f64_equal(got, got_m, want, want_m):
    got_l = _leaves(got)
    assert sorted(got_l) == sorted(_leaves(want))
    for name, w in _leaves(want).items():
        assert got_l[name].dtype == np.float64 and got_l[name].shape == w.shape, name
        np.testing.assert_allclose(got_l[name], w, rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m],
                               rtol=1e-10, atol=1e-12)


def test_plain_mappo_update_f64_matches_jax_kernel_and_jax_grad():
    kscn, params, batch = _batch()
    got, got_m = _port(params, batch)
    obs, mv_oh, logp_old, value_old, adv_n, ret = map(jnp.asarray, batch)
    j_update = j_fused_mappo_update(kscn, n_envs=N, n_steps=T, hidden=HIDDEN, clip=CLIP,
                                    vf_coef=VF, ent_coef=ENTC, block_envs=64, t_chunk=4,
                                    interpret=True, compute_dtype=jnp.float64)
    want_k = j_update(jax.tree.map(jnp.asarray, params), obs, mv_oh, None, logp_old, adv_n, ret,
                      value_old)
    _assert_f64_equal(got, got_m, *want_k)
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))


def test_plain_mappo_update_f64_with_value_clip_matches_jax_grad():
    kscn, params, batch = _batch(value_noise=0.3)
    value = np.asarray(_forward(params, jnp.asarray(batch[0]), jnp.float64)[1])
    share = float((np.abs(value - batch[3]) > CLIP).mean())
    assert 0.3 < share < 0.7, share
    got, got_m = _port(params, batch)
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))


def test_init_mappo_layout():
    params = init_mappo(torch.Generator().manual_seed(0), OW, 5, A, hidden=HIDDEN)
    want = jax.tree.map(np.shape, j_init_mappo(jax.random.PRNGKey(0), OW, 5, A, hidden=HIDDEN))
    assert {k: {q: tuple(x.shape) for q, x in v.items()} for k, v in params.items()} == want
    assert float(params["pi"]["w"].abs().max()) < 0.1 < float(params["c1"]["w"].abs().max())


def test_fused_mappo_step_matches_jax_two_iterations():
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=16, block_envs=32, t_chunk=4)
    j_step = j_ppo.build_fused_mappo_step("simple_spread",
                                          Mesh(np.array(jax.devices()[:1]), ("env",)),
                                          interpret=True, compute_dtype=jnp.float32, **kw)
    t_step = t_ppo.build_fused_mappo_step("simple_spread", device="cpu", **kw)
    params = jax.tree.map(np.asarray, j_step.init_params(jax.random.PRNGKey(0)))
    j_state = j_step.init_state(jax.tree.map(jnp.asarray, params))
    t_state = t_step.init_state(params_from_numpy(params, device="cpu"))
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
    assert t_state[1].count == 2 * 4


def test_fused_mappo_step_autograd_epochs_match_kernel_epochs():
    """``fused_update=False`` (autograd of ``step.loss_fn``) and the K7 path
    give the same iteration (float32 summation order apart)."""
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=16, block_envs=32, t_chunk=4, device="cpu")
    k_step = t_ppo.build_fused_mappo_step("simple_spread", **kw)
    a_step = t_ppo.build_fused_mappo_step("simple_spread", fused_update=False, **kw)
    params = k_step.init_params(torch.Generator().manual_seed(3))
    (k_params, _), k_m = k_step(k_step.init_state(params), 5)
    (a_params, _), a_m = a_step(a_step.init_state(params), 5)
    for key in k_m:
        np.testing.assert_allclose(float(k_m[key]), float(a_m[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    want = _leaves(params_to_numpy(a_params))
    for name, x in _leaves(params_to_numpy(k_params)).items():
        np.testing.assert_allclose(x, want[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_mappo_update_refuses_what_it_does_not_compute():
    _, params, batch = _batch()
    tp = params_from_numpy(params, device="cpu")
    obs, mv_oh, lpo, vold, adv, ret = (torch.tensor(x, dtype=torch.float32) for x in batch)
    update = t_update.fused_mappo_update("simple_spread", N, T, HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="cm_oh must be None"):
        update(tp, obs, mv_oh, mv_oh, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="a1.w has shape"):
        t_update.fused_mappo_update("simple_spread", N, T, 32, device="cpu")(
            tp, obs, mv_oh, None, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="CUDA"):
        t_update.mappo_update_cuda(tp, obs, mv_oh, lpo, adv, ret, vold, clip=CLIP, vf_coef=VF,
                                   ent_coef=ENTC)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_ppo.build_fused_mappo_step("simple_spread", 64, n_steps=8, t_chunk=4)

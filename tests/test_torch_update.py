"""The port's PPO epoch gradient (plain version of kernel K6) against the
JAX package on the CPU.

- float64: against ``fused_ppo_update(..., interpret=True,
  compute_dtype=float64)`` and against ``jax.grad`` of the same loss, at
  1e-10 (the analytic forms are exact; what is left is summation order),
  and with the value clip binding against ``jax.grad``;
- float32: against the JAX kernel in interpret mode at rtol 1e-5 with an
  absolute floor of 1e-5 of the largest leaf (sums over 1,536 samples in
  another order).

The batch is made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu.learner.fused_ppo import _factored_logp_ent, _head_minor, _torso_minor
from mpe_tpu.learner.ppo import init_ac
from mpe_tpu.ops.fused_update import fused_ppo_update as j_fused_ppo_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy
from mpe_tpu_torch.ops import fused_update as t_update

CLIP, VF, ENTC = 0.2, 0.5, 0.01
T, N, HIDDEN = 4, 128, 16


def _xla_loss(kscn, params, batch, dt):
    """The loss of mpe_tpu.learner.fused_ppo.build_fused_ppo_step with the
    advantage already normalized."""
    obs, mv_oh, logp_old, value_old, adv_n, ret = batch
    h = _torso_minor(params["l1"], params["l2"], obs, dt)
    logits, value = _head_minor(params["pi"], h, dt), _head_minor(params["v"], h, dt)[..., 0, :]
    logp, ent = _factored_logp_ent(kscn, logits, mv_oh, None)
    ratio = jnp.exp(logp - logp_old)
    pg = -jnp.minimum(ratio * adv_n, jnp.clip(ratio, 1 - CLIP, 1 + CLIP) * adv_n).mean()
    v_clip = value_old + jnp.clip(value - value_old, -CLIP, CLIP)
    vloss = jnp.maximum(jnp.square(value - ret), jnp.square(v_clip - ret)).mean()
    return pg + VF * vloss - ENTC * ent.mean(), (pg, vloss, ent.mean())


def _batch(dtype, value_noise=0.0):
    """Params and an epoch-shaped batch as numpy: obs ~ N(0, 1), random
    moves, logp_old from the same forward plus noise (so ratios differ from
    1 and some clip), value_old the values plus ``value_noise`` normals (0:
    epoch 0, where the value clip never binds; 0.3: it binds for about half
    the samples), normalized advantages, random returns."""
    kscn = j_kernel_scenario("simple_spread")
    jt = jnp.float64 if dtype == np.float64 else jnp.float32
    params = jax.tree.map(np.asarray, init_ac(jax.random.PRNGKey(2), 18, 5, hidden=HIDDEN,
                                              dtype=jt))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(T, 3, 18, N)).astype(dtype)
    act = rng.integers(0, 5, size=(T, 3, N))
    mv_oh = np.moveaxis(np.eye(5, dtype=dtype)[act], -1, -2)
    h = _torso_minor(params["l1"], params["l2"], jnp.asarray(obs), jt)
    logp, _ = _factored_logp_ent(kscn, _head_minor(params["pi"], h, jt), jnp.asarray(mv_oh), None)
    logp_old = (np.asarray(logp) + 0.3 * rng.normal(size=(T, 3, N))).astype(dtype)
    value = np.asarray(_head_minor(params["v"], h, jt))[..., 0, :]
    value_old = (value + value_noise * rng.normal(size=(T, 3, N))).astype(dtype)
    adv = rng.normal(size=(T, 3, N))
    adv_n = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(dtype)
    ret = rng.normal(size=(T, 3, N)).astype(dtype)
    return kscn, params, (obs, mv_oh, logp_old, value_old, adv_n, ret)


def _port(params, batch, dtype):
    tp = params_from_numpy(params, device="cpu", dtype=dtype)
    obs, mv_oh, logp_old, value_old, adv_n, ret = (torch.tensor(x) for x in batch)
    update = t_update.fused_ppo_update("simple_spread", N, T, HIDDEN, clip=CLIP, vf_coef=VF,
                                       ent_coef=ENTC, device="cpu", dtype=dtype)
    return update(tp, obs, mv_oh, None, logp_old, adv_n, ret, value_old)


def _jax_kernel(kscn, params, batch, compute_dtype):
    obs, mv_oh, logp_old, value_old, adv_n, ret = map(jnp.asarray, batch)
    update = j_fused_ppo_update(kscn, n_envs=N, n_steps=T, hidden=HIDDEN, clip=CLIP,
                                vf_coef=VF, ent_coef=ENTC, block_envs=64, t_chunk=4,
                                interpret=True, compute_dtype=compute_dtype)
    return update(jax.tree.map(jnp.asarray, params), obs, mv_oh, None, logp_old, adv_n, ret,
                  value_old)


def _leaves(tree):
    return {f"{k}.{q}": np.asarray(tree[k][q]) for k in sorted(tree) for q in sorted(tree[k])}


def _jax_grad(kscn, params, batch):
    jbatch = tuple(map(jnp.asarray, batch))
    (_, metrics), grads = jax.value_and_grad(
        lambda p: _xla_loss(kscn, p, jbatch, jnp.float64), has_aux=True)(
            jax.tree.map(jnp.asarray, params))
    return grads, metrics


def _assert_f64_equal(got, got_m, want, want_m):
    got_l = _leaves(got)
    for name, w in _leaves(want).items():
        assert got_l[name].dtype == np.float64 and got_l[name].shape == w.shape, name
        np.testing.assert_allclose(got_l[name], w, rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m],
                               rtol=1e-10, atol=1e-12)


def test_plain_update_f64_matches_jax_kernel_and_jax_grad():
    """Epoch 0 (value_old = value): the JAX kernel and jax.grad agree, and
    the port agrees with both."""
    kscn, params, batch = _batch(np.float64)
    got, got_m = _port(params, batch, torch.float64)
    _assert_f64_equal(got, got_m, *_jax_kernel(kscn, params, batch, jnp.float64))
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))
    # the batch exercises both branches of the ratio clip
    ratio = np.exp(np.asarray(_factored_logp_ent(
        kscn, _head_minor(params["pi"], _torso_minor(params["l1"], params["l2"],
                                                     jnp.asarray(batch[0]), jnp.float64),
                          jnp.float64), jnp.asarray(batch[1]), None)[0]) - batch[2])
    assert ((ratio < 1 - CLIP) | (ratio > 1 + CLIP)).any() and (abs(ratio - 1) < CLIP).any()


def test_plain_update_f64_with_value_clip_matches_jax_grad():
    """Later epochs (value_old off the values, the value clip binding for
    about half the samples): the port agrees with jax.grad of the loss. The
    JAX kernel is not the yardstick here: where the clip does not bind and
    vold + (v - vold) rounds above v's branch it drops the sample's value
    gradient (ROADMAP C); this batch has such a sample."""
    kscn, params, batch = _batch(np.float64, value_noise=0.3)
    got, got_m = _port(params, batch, torch.float64)
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))
    want_k, _ = _jax_kernel(kscn, params, batch, jnp.float64)
    assert np.abs(np.asarray(want_k["v"]["b"]) - got["v"]["b"].numpy()).max() > 1e-6


def test_plain_update_f32_matches_jax_kernel():
    kscn, params, batch = _batch(np.float32)
    got, got_m = _port(params, batch, torch.float32)
    want, want_m = _jax_kernel(kscn, params, batch, jnp.float32)
    want_l = _leaves(want)
    scale = max(np.abs(w).max() for w in want_l.values())
    for name, g in _leaves(got).items():
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, want_l[name], rtol=1e-5, atol=1e-5 * scale, err_msg=name)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m], rtol=1e-5)


def test_clip_binding_inputs_bind_both_clips_off_their_boundaries():
    gen = torch.Generator().manual_seed(0)
    lpo, v = torch.randn(2, T, 3, N, generator=gen)
    lpo_c, v_c, (r_share, v_share) = t_update.clip_binding_inputs(lpo, v, clip=CLIP,
                                                                  generator=gen)
    log_ratio, dv = lpo - lpo_c, v - v_c
    lo, hi = np.log(1 - CLIP), np.log(1 + CLIP)
    assert r_share == float(((log_ratio < lo) | (log_ratio > hi)).double().mean())
    assert v_share == float((dv.abs() > CLIP).double().mean())
    assert 0.3 < r_share < 0.7 and 0.3 < v_share < 0.7
    assert float(torch.minimum((log_ratio - lo).abs(), (log_ratio - hi).abs()).min()) > 9e-4
    assert float((dv.abs() - CLIP).abs().min()) > 9e-4


def test_update_builder_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="float32 or float64"):
        t_update.fused_ppo_update("simple_spread", N, T, HIDDEN, device="cpu",
                                  dtype=torch.float16)
    _, params, batch = _batch(np.float32)
    tp = params_from_numpy(params, device="cpu")
    obs, mv_oh, lpo, vold, adv, ret = (torch.tensor(x) for x in batch)
    update = t_update.fused_ppo_update("simple_spread", N, T, HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="cm_oh must be None"):
        update(tp, obs, mv_oh, mv_oh, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="obs has shape"):
        update(tp, obs[:, :2], mv_oh, None, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="CUDA"):
        t_update.ppo_update_cuda(tp, obs, mv_oh, lpo, adv, ret, vold, clip=CLIP, vf_coef=VF,
                                 ent_coef=ENTC)

"""The port's PPO epoch gradient (plain version of kernel K6) against the
JAX package on the CPU, move-only and with a comm head.

- float64: against ``fused_ppo_update(..., interpret=True,
  compute_dtype=float64)`` and against ``jax.grad`` of the same loss, at
  1e-10 (the analytic forms are exact; what is left is summation order), on
  simple_spread and on the comm and wide scenarios of
  ``tests/test_fused_update.py`` (simple_speaker_listener with its silent
  listener, simple_reference, simple_crypto, simple_tag, simple_world_comm
  with its silent agents); with the value clip binding against
  ``jax.grad``, on simple_spread and, with both clips moved by
  ``clip_binding_inputs``, on simple_reference;
- float32: against the JAX kernel in interpret mode at rtol 1e-5 with an
  absolute floor of 1e-5 of the largest leaf (sums over the batch in
  another order), on simple_spread and simple_reference.

The batch is made with numpy from a seed and handed to both packages.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu.learner.fused_ppo import _factored_logp_ent, _head_minor, _torso_minor
from mpe_tpu.learner.ppo import init_ac
from mpe_tpu.learner.ppo import init_mappo as j_init_mappo
from mpe_tpu.ops.fused_update import fused_ppo_update as j_fused_ppo_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy
from mpe_tpu_torch.ops import fused_update as t_update
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLIP, VF, ENTC = 0.2, 0.5, 0.01
T, N, HIDDEN = 4, 128, 16
COMM_NAMES = ["simple_speaker_listener", "simple_reference", "simple_crypto", "simple_tag",
              "simple_world_comm"]


def _xla_loss(kscn, params, batch, dt):
    """The loss of mpe_tpu.learner.fused_ppo.build_fused_ppo_step with the
    advantage already normalized."""
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = batch
    h = _torso_minor(params["l1"], params["l2"], obs, dt)
    logits, value = _head_minor(params["pi"], h, dt), _head_minor(params["v"], h, dt)[..., 0, :]
    logp, ent = _factored_logp_ent(kscn, logits, mv_oh, cm_oh)
    ratio = jnp.exp(logp - logp_old)
    pg = -jnp.minimum(ratio * adv_n, jnp.clip(ratio, 1 - CLIP, 1 + CLIP) * adv_n).mean()
    v_clip = value_old + jnp.clip(value - value_old, -CLIP, CLIP)
    vloss = jnp.maximum(jnp.square(value - ret), jnp.square(v_clip - ret)).mean()
    return pg + VF * vloss - ENTC * ent.mean(), (pg, vloss, ent.mean())


def _logp_value(kscn, params, obs, mv_oh, cm_oh, dt):
    """The JAX trainer's log-probs and values of a batch, jitted once (eager
    JAX compiles every op on its own)."""
    def forward(p, o, m, c):
        h = _torso_minor(p["l1"], p["l2"], o, dt)
        logp, _ = _factored_logp_ent(kscn, _head_minor(p["pi"], h, dt), m, c)
        return logp, _head_minor(p["v"], h, dt)[..., 0, :]

    asj = (lambda x: None if x is None else jnp.asarray(x))
    logp, value = jax.jit(forward)(jax.tree.map(jnp.asarray, params), asj(obs), asj(mv_oh),
                                   asj(cm_oh))
    return np.asarray(logp), np.asarray(value)


def _onehot(rng, k, dtype, shape):
    return np.moveaxis(np.eye(k, dtype=dtype)[rng.integers(0, k, size=shape)], -1, -2)


def _batch(dtype, value_noise=0.0, name="simple_spread", hidden=HIDDEN):
    """Params and an epoch-shaped batch as numpy: obs ~ N(0, 1), random
    moves (and utterances with a comm head, one-hot 0 for a silent agent as
    K5 emits them), logp_old from the same forward plus noise (so ratios
    differ from 1 and some clip), value_old the values plus ``value_noise``
    normals (0: epoch 0, where the value clip never binds; 0.3: it binds for
    about half the samples), normalized advantages, random returns."""
    kscn = j_kernel_scenario(name)
    a, ow = kscn.spec.n_agents, kscn.obs_w
    dim_c = kscn.spec.dim_c if kscn.uses_comm else 0
    jt = jnp.float64 if dtype == np.float64 else jnp.float32
    params = jax.tree.map(np.asarray, init_ac(jax.random.PRNGKey(2), ow, 5 + dim_c, hidden=hidden,
                                              dtype=jt))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(T, a, ow, N)).astype(dtype)
    mv_oh = _onehot(rng, 5, dtype, (T, a, N))
    cm_oh = None
    if dim_c:
        cm_oh = _onehot(rng, dim_c, dtype, (T, a, N))
        cm_oh[:, kscn.spec.silent[:a]] = np.eye(dim_c, dtype=dtype)[:, :1]
    logp, value = _logp_value(kscn, params, obs, mv_oh, cm_oh, jt)
    logp_old = (logp + 0.3 * rng.normal(size=(T, a, N))).astype(dtype)
    value_old = (value + value_noise * rng.normal(size=(T, a, N))).astype(dtype)
    adv = rng.normal(size=(T, a, N))
    adv_n = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(dtype)
    ret = rng.normal(size=(T, a, N)).astype(dtype)
    return kscn, params, (obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret)


def _port(kscn, params, batch, dtype):
    tp = params_from_numpy(params, device="cpu", dtype=dtype)
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else torch.tensor(x)
                                                           for x in batch)
    update = t_update.fused_ppo_update(kscn.spec.name, N, T, params["l1"]["w"].shape[1],
                                       clip=CLIP, vf_coef=VF, ent_coef=ENTC, device="cpu",
                                       dtype=dtype)
    return update(tp, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value_old)


def _jax_kernel(kscn, params, batch, compute_dtype):
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else jnp.asarray(x)
                                                           for x in batch)
    update = j_fused_ppo_update(kscn, n_envs=N, n_steps=T, hidden=params["l1"]["w"].shape[1],
                                clip=CLIP,
                                vf_coef=VF, ent_coef=ENTC, block_envs=64, t_chunk=4,
                                interpret=True, compute_dtype=compute_dtype)
    return update(jax.tree.map(jnp.asarray, params), obs, mv_oh, cm_oh, logp_old, adv_n, ret,
                  value_old)


def _leaves(tree):
    return {f"{k}.{q}": np.asarray(tree[k][q]) for k in sorted(tree) for q in sorted(tree[k])}


def _jax_grad(kscn, params, batch):
    jbatch = tuple(None if x is None else jnp.asarray(x) for x in batch)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: _xla_loss(kscn, p, b, jnp.float64), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jbatch)
    return grads, metrics


def _assert_f64_equal(got, got_m, want, want_m):
    got_l = _leaves(got)
    for name, w in _leaves(want).items():
        assert got_l[name].dtype == np.float64 and got_l[name].shape == w.shape, name
        np.testing.assert_allclose(got_l[name], w, rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m],
                               rtol=1e-10, atol=1e-12)


# hidden 16 on every head, and the other widths the kernels are compiled for
# (8, 32) on simple_spread and a comm head
WIDTH_CASES = ([pytest.param(name, HIDDEN, id=name) for name in ["simple_spread"] + COMM_NAMES]
               + [pytest.param(name, h, id=f"{name}-hidden{h}") for h in (8, 32)
                  for name in ("simple_spread", "simple_speaker_listener")])


@pytest.mark.parametrize("name, hidden", WIDTH_CASES)
def test_plain_update_f64_matches_jax_kernel_and_jax_grad(name, hidden):
    """Epoch 0 (value_old = value): the JAX kernel and jax.grad agree, and
    the port agrees with both, at ``hidden``."""
    kscn, params, batch = _batch(np.float64, name=name, hidden=hidden)
    got, got_m = _port(kscn, params, batch, torch.float64)
    _assert_f64_equal(got, got_m, *_jax_kernel(kscn, params, batch, jnp.float64))
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))
    # the batch exercises both branches of the ratio clip
    obs, mv_oh, cm_oh, logp_old = batch[:4]
    ratio = np.exp(_logp_value(kscn, params, obs, mv_oh, cm_oh, jnp.float64)[0] - logp_old)
    assert ((ratio < 1 - CLIP) | (ratio > 1 + CLIP)).any() and (abs(ratio - 1) < CLIP).any()


@pytest.mark.parametrize("name", ["simple_spread", "simple_reference"])
def test_plain_update_f64_with_value_clip_matches_jax_grad(name):
    """Later epochs (value_old off the values, the value clip binding for
    about half the samples): the port agrees with jax.grad of the loss. The
    JAX kernel is not the yardstick here: where the clip does not bind and
    vold + (v - vold) rounds above v's branch it drops the sample's value
    gradient (ROADMAP C); the simple_spread batch has such a sample. On
    simple_reference both clips are moved by ``clip_binding_inputs``, the
    batch on which the card holds K6."""
    if name == "simple_spread":
        kscn, params, batch = _batch(np.float64, value_noise=0.3)
    else:
        kscn, params, batch = _batch(np.float64, name=name)
        obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = batch
        lpo_c, v_c, shares = t_update.clip_binding_inputs(
            torch.tensor(logp_old), torch.tensor(value_old), clip=CLIP,
            generator=torch.Generator().manual_seed(3))
        assert all(0.3 < x < 0.7 for x in shares), shares
        batch = (obs, mv_oh, cm_oh, lpo_c.numpy(), v_c.numpy(), adv_n, ret)
    got, got_m = _port(kscn, params, batch, torch.float64)
    _assert_f64_equal(got, got_m, *_jax_grad(kscn, params, batch))
    if name == "simple_spread":
        want_k, _ = _jax_kernel(kscn, params, batch, jnp.float64)
        assert np.abs(np.asarray(want_k["v"]["b"]) - got["v"]["b"].numpy()).max() > 1e-6


@pytest.mark.parametrize("name", ["simple_spread", "simple_reference"])
def test_plain_update_f32_matches_jax_kernel(name):
    kscn, params, batch = _batch(np.float32, name=name)
    got, got_m = _port(kscn, params, batch, torch.float32)
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
    obs, mv_oh, _, lpo, vold, adv, ret = (None if x is None else torch.tensor(x) for x in batch)
    update = t_update.fused_ppo_update("simple_spread", N, T, HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="cm_oh must be None"):
        update(tp, obs, mv_oh, mv_oh, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="obs has shape"):
        update(tp, obs[:, :2], mv_oh, None, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="CUDA"):
        t_update.ppo_update_cuda(tp, obs, mv_oh, None, lpo, adv, ret, vold, clip=CLIP,
                                 vf_coef=VF, ent_coef=ENTC)
    # a comm scenario needs its comm one-hots, at their width
    _, params, batch = _batch(np.float32, name="simple_reference")
    tp = params_from_numpy(params, device="cpu")
    obs, mv_oh, cm_oh, lpo, vold, adv, ret = (torch.tensor(x) for x in batch)
    update = t_update.fused_ppo_update("simple_reference", N, T, HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="has a comm head"):
        update(tp, obs, mv_oh, None, lpo, adv, ret, vold)
    with pytest.raises(ValueError, match="has a comm head"):
        update(tp, obs, mv_oh, cm_oh[:, :, :4], lpo, adv, ret, vold)


def test_update_wrappers_refuse_uncompiled_widths_before_any_launch():
    """K6's and K7's wrappers and their bf16 twins' take the hidden width
    from the params and raise for a width their source is not compiled for
    (48), naming that source's widths, before they look at the device (so
    here, without a card); at 128 and 256, which every one of them takes,
    they get past the width and stop at the device."""
    wrappers = (t_update.ppo_update_cuda, t_update.mappo_update_cuda,
                t_update.ppo_update_bf16_cuda, t_update.mappo_update_bf16_cuda)
    before = [w.launches for w in wrappers]
    hp = dict(clip=CLIP, vf_coef=VF, ent_coef=ENTC)
    f32 = re.escape("(csrc/mpe_update.cu) are compiled for hidden widths "
                    "8, 16, 32, 64, 128, 256; got 48")
    kscn, _, batch = _batch(np.float32, hidden=48)
    obs, mv_oh, cm_oh, lpo, vold, adv, ret = [None if x is None else torch.tensor(x)
                                              for x in batch]
    for h in (48, 128, 256):
        tp = params_from_numpy(jax.tree.map(np.asarray, init_ac(
            jax.random.PRNGKey(2), kscn.obs_w, 5, hidden=h, dtype=jnp.float32)), device="cpu")
        team = params_from_numpy(jax.tree.map(np.asarray, j_init_mappo(
            jax.random.PRNGKey(0), kscn.obs_w, 5, kscn.spec.n_agents, hidden=h)), device="cpu")
        bf16 = re.escape(f"(csrc/mpe_update_bf16.cu) are compiled for hidden widths "
                         f"8, 16, 32, 64, 128, 256; got {h}")
        for ppo, mappo, named in ((t_update.ppo_update_cuda, t_update.mappo_update_cuda, f32),
                                  (t_update.ppo_update_bf16_cuda,
                                   t_update.mappo_update_bf16_cuda, bf16)):
            # every one takes 128 and 256: past the width, the CPU tensors are refused
            error, named = (NotImplementedError, named) if h == 48 else (ValueError, "CUDA")
            with pytest.raises(error, match=named):
                ppo(tp, obs, mv_oh, cm_oh, lpo, adv, ret, vold, **hp)
            with pytest.raises(error, match=named):
                mappo(team, obs, mv_oh, cm_oh, lpo, adv[:, 0], ret[:, 0], vold[:, 0], **hp)
    assert before == [w.launches for w in wrappers]


def test_build_targets_name_each_hidden_width():
    """``_build._target``: one library per (MLP source, hidden width of
    that source's table), each name distinct, the width-64 name the one a
    build without the width had (a hash of the source, the headers and the
    flags); the sources without an MLP and the widths a source is not
    compiled for (48 for every one, 128 and 256 for K9-bf16's source) are
    refused, naming that source's widths."""
    import hashlib

    from mpe_tpu_torch.ops import _build

    assert _build.HIDDEN_WIDTHS["mpe_policy.cu"] == _build.HIDDEN_WIDTHS["mpe_update.cu"] == (
        _build.HIDDEN_WIDTHS["mpe_maddpg.cu"]) == _build.HIDDEN_WIDTHS["mpe_update_bf16.cu"] == (
        _build.HIDDEN_WIDTHS["mpe_maddpg_bf16.cu"]) == (8, 16, 32, 64, 128, 256)
    for source in _build.HIDDEN_SOURCES:
        widths = _build.HIDDEN_WIDTHS[source]
        names = [_build._target(source, h).name for h in widths]
        assert len(set(names)) == len(widths)
        text = (_build.CSRC / source).read_bytes() + b"".join(
            (_build.CSRC / h).read_bytes() for h in _build.HEADERS)
        digest = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
        assert _build._target(source, 64).name == _build._target(source).name
        assert _build._target(source).name == f"lib{source[:-3]}_{digest}.so"
        assert _build._target(source, 8).name.startswith(f"lib{source[:-3]}_h8_")
        refused = [48] + [h for h in (128, 256) if h not in widths]
        assert refused == [48]
        for h in refused:
            with pytest.raises(NotImplementedError, match=re.escape(
                    f"(csrc/{source}) are compiled for hidden widths "
                    f"{', '.join(map(str, widths))}; got {h}")):
                _build._target(source, h)
    with pytest.raises(ValueError, match="no hidden width"):
        _build._target("mpe_trajectory.cu", 16)


def test_actor_heads_match_the_kernel_instantiations():
    """The update kernels compile the actor passes for each scenario's
    (obs width, comm logits) head (``csrc/mpe_update.cu::by_actor_head``):
    the wrappers' list of heads is that table, and each of the nine
    scenarios has its head there."""
    import re

    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    text = (_build.CSRC / "mpe_update.cu").read_text()
    compiled = {(int(ow), int(c)) for ow, c in re.findall(r"MPE_ACTOR_HEAD\((\d+), (\d+)\)", text)}
    assert compiled == set(t_update.actor_heads())
    names = ["simple", "simple_spread", "simple_adversary", "simple_push", *COMM_NAMES]
    assert {(kernel_scenario(n).obs_w, kernel_scenario(n).n_comm) for n in names} == compiled


def test_critic_widths_match_the_kernel_instantiations():
    """The MAPPO critic pass is compiled for each scenario's joint obs width
    (``csrc/mpe_update.cu::by_joint_width``): the wrappers' list of widths is
    that table, agents x obs width of the nine scenarios."""
    import re

    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    text = (_build.CSRC / "mpe_update.cu").read_text()
    compiled = {int(j) for j in re.findall(r"MPE_JOINT_WIDTH\((\d+)\)", text)}
    assert compiled == set(t_update.critic_widths())
    names = ["simple", "simple_spread", "simple_adversary", "simple_push", *COMM_NAMES]
    assert len(set(names)) == 9
    assert {kernel_scenario(n).spec.n_agents * kernel_scenario(n).obs_w for n in names} == compiled


def test_speak_mask_is_made_once_per_dtype_and_device():
    """The silent agents' mask of the comm factor is one shared table per
    (flags, dtype, device): the trainer's loss and the plain update read it
    in every call without a host-to-device copy."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario("simple_speaker_listener")
    assert kscn.speak == (True, False) and kscn.n_logits == 5 + 3
    assert kernel_scenario("simple_spread").speak is None
    x32, x64 = torch.zeros(2), torch.zeros(2, dtype=torch.float64)
    mask = t_update.speak_mask(kscn.speak, x32)
    assert mask is t_update.speak_mask(kscn.speak, x32)
    assert mask.shape == (2, 1, 1) and mask.flatten().tolist() == [1.0, 0.0]
    assert t_update.speak_mask(kscn.speak, x64).dtype == torch.float64
    assert t_update.speak_mask(None, x32) is None
    assert t_update.speak_bits(kscn.speak) == 1 and t_update.speak_bits(None) == 0

"""The bf16 compute path (``compute_dtype=torch.bfloat16``) of the port's
fused PPO and MAPPO updates and trainers against the JAX package's bf16
path on the CPU.

XLA's CPU backend has no bf16 x bf16 -> f32 dot, so every test here runs
JAX under ``bf16_dots`` (``tests/_bf16.py``): ``lax.dot_general`` (and
``jnp.einsum``, which binds it at import) upcast a bf16 operand to float32
and multiply at ``Precision.HIGHEST``. A product of two bf16 values is exact
in float32, so this computes what a bf16 dot with float32 accumulation
computes, up to the order of the sum. ``mpe_tpu`` itself is not changed.

- ``plain_ppo_update`` / ``plain_mappo_update`` with bf16 products against
  JAX's ``fused_ppo_update`` / ``fused_mappo_update(..., interpret=True,
  compute_dtype=bfloat16)``, on simple_spread and a comm scenario each
  (simple_reference, simple_speaker_listener), on an epoch-0 batch (logp_old
  and value_old from JAX's bf16 forward) and with both clips binding
  (``clip_binding_inputs``): each leaf within ``PLAIN_TOL`` of its largest
  entry, the metrics within 1e-5 relative. Both round the same float32
  values to bf16, but where two float32 sums ran in another order an
  operand rounds a whole bf16 ulp (2^-8 relative) the other way, and a
  leaf's largest entry is a sum with much cancellation: the largest leaf
  error measured over these eight cases was 4.0e-4 (PPO on simple_reference,
  clips binding; 3.8e-7 to 2.3e-4 on the others), so ``PLAIN_TOL`` is 1e-3
  (the float32 path's tests hold 1e-5; bf16 against float32 differs by
  6.9e-3 or more here);
- the bf16 path is really taken: the port's bf16 grads lie at least 10x
  closer to JAX's bf16 grads than to JAX's float32 grads (largest leaf
  error relative to its largest entry);
- one iteration of ``build_fused_ppo_step`` / ``build_fused_mappo_step``
  with ``compute_dtype=torch.bfloat16`` (K5's plain version, then the bf16
  prep forward and four epochs of the plain bf16 update), and of the PPO
  trainer with ``fused_update=False`` (autograd of the bf16-rounded loss,
  whose gradients round to bf16 where the forward cast, as JAX's transposed
  casts do), against JAX's from the same params and seed: metrics and
  params within ``TRAINER_TOL`` absolute and relative (measured: the params
  within 2.7e-6, the metrics within 1.9e-7 relative; JAX's float32
  iteration lies 3.8e-4 or more from the port's bf16 params); the resolved
  default is float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mpe_tpu.learner.fused_ppo as j_ppo
from mpe_tpu.learner.ppo import init_ac as j_init_ac
from mpe_tpu.learner.ppo import init_mappo as j_init_mappo
from mpe_tpu.ops.fused_update import fused_mappo_update as j_fused_mappo_update
from mpe_tpu.ops.fused_update import fused_ppo_update as j_fused_ppo_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.learner import fused_ppo as t_ppo
from mpe_tpu_torch.ops import fused_update as t_update
from tests._bf16 import bf16_dots  # noqa: F401 (the fixture)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLIP, VF, ENTC = 0.2, 0.5, 0.01
T, N, HIDDEN = 4, 128, 16
PLAIN_TOL, METRIC_RTOL = 1e-3, 1e-5
TRAINER_TOL = 1e-5
BF16 = torch.bfloat16


def _leaves(tree):
    return {f"{k}.{q}": np.asarray(tree[k][q]) for k in sorted(tree) for q in sorted(tree[k])}


def _onehot(rng, k, shape):
    return np.moveaxis(np.eye(k, dtype=np.float32)[rng.integers(0, k, size=shape)], -1, -2)


@functools.cache
def _batch(kind, name, clipped, hidden=HIDDEN):
    """float32 params and an epoch-shaped batch as numpy (made once per
    module, under ``bf16_dots``). logp_old and value_old are JAX's bf16
    forward of the params (epoch 0: every ratio is 1 up to rounding), or
    those moved by ``clip_binding_inputs`` so that both clips bind for about
    half of the samples. PPO's advantage, return and value are per agent
    [T, A, N], MAPPO's the team's [T, N]."""
    kscn, params, (obs, mv_oh, cm_oh, logp, value, adv_n, ret) = _epoch0(kind, name, hidden)
    if clipped:
        logp, value, _ = t_update.clip_binding_inputs(
            torch.tensor(logp), torch.tensor(value), clip=CLIP,
            generator=torch.Generator().manual_seed(11))
        logp, value = logp.numpy(), value.numpy()
    return kscn, params, (obs, mv_oh, cm_oh, logp, value, adv_n, ret)


@functools.cache
def _epoch0(kind, name, hidden=HIDDEN):
    kscn = j_kernel_scenario(name)
    a, ow = kscn.spec.n_agents, kscn.obs_w
    dim_c = kscn.spec.dim_c if kscn.uses_comm else 0
    key = jax.random.PRNGKey(2)
    params = jax.tree.map(np.asarray, (j_init_ac(key, ow, 5 + dim_c, hidden=hidden)
                                       if kind == "ppo" else
                                       j_init_mappo(key, ow, 5 + dim_c, a, hidden=hidden)))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(T, a, ow, N)).astype(np.float32)
    mv_oh = _onehot(rng, 5, (T, a, N))
    cm_oh = None
    if dim_c:
        cm_oh = _onehot(rng, dim_c, (T, a, N))
        cm_oh[:, kscn.spec.silent[:a]] = np.eye(dim_c, dtype=np.float32)[:, :1]

    def forward(p, o, m, c):
        bf = jnp.bfloat16
        if kind == "ppo":
            h = j_ppo._torso_minor(p["l1"], p["l2"], o, bf)
            logits, value = j_ppo._head_minor(p["pi"], h, bf), j_ppo._head_minor(p["v"], h, bf)
        else:
            logits = j_ppo._head_minor(p["pi"], j_ppo._torso_minor(p["a1"], p["a2"], o, bf), bf)
            joint = o.reshape(o.shape[:-3] + (a * ow,) + o.shape[-1:])
            value = j_ppo._head_minor(p["v"], j_ppo._torso_minor(p["c1"], p["c2"], joint, bf),
                                      bf)
        return j_ppo._factored_logp_ent(kscn, logits, m, c)[0], value[..., 0, :]

    asj = (lambda x: None if x is None else jnp.asarray(x))
    logp, value = (np.asarray(x) for x in jax.jit(forward)(
        jax.tree.map(jnp.asarray, params), asj(obs), asj(mv_oh), asj(cm_oh)))
    stream = (T, a, N) if kind == "ppo" else (T, N)
    adv = rng.normal(size=stream)
    adv_n = ((adv - adv.mean()) / (adv.std() + 1e-8)).astype(np.float32)
    ret = rng.normal(size=stream).astype(np.float32)
    return kscn, params, (obs, mv_oh, cm_oh, logp, value, adv_n, ret)


def _port(kind, kscn, params, batch, compute_dtype=BF16):
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else torch.tensor(x)
                                                           for x in batch)
    build = t_update.fused_ppo_update if kind == "ppo" else t_update.fused_mappo_update
    update = build(kscn.spec.name, N, T, _hidden(params), clip=CLIP, vf_coef=VF, ent_coef=ENTC,
                   device="cpu", compute_dtype=compute_dtype)
    grads, metrics = update(params_from_numpy(params, device="cpu"), obs, mv_oh, cm_oh,
                            logp_old, adv_n, ret, value_old)
    return _leaves(params_to_numpy(grads)), [float(x) for x in metrics]


@functools.cache
def _jax_update(kind, name, clipped, compute_dtype, hidden=HIDDEN):
    """JAX's kernel on ``_batch(kind, name, clipped, hidden)`` (once per module)."""
    return _jax(kind, *_batch(kind, name, clipped, hidden), compute_dtype)


def _hidden(params):
    """The params' hidden width (the first layer's outputs)."""
    return params["l1" if "l1" in params else "a1"]["w"].shape[1]


def _jax(kind, kscn, params, batch, compute_dtype):
    obs, mv_oh, cm_oh, logp_old, value_old, adv_n, ret = (None if x is None else jnp.asarray(x)
                                                           for x in batch)
    build = j_fused_ppo_update if kind == "ppo" else j_fused_mappo_update
    update = build(kscn, n_envs=N, n_steps=T, hidden=_hidden(params), clip=CLIP, vf_coef=VF,
                   ent_coef=ENTC, block_envs=64, t_chunk=4, interpret=True,
                   compute_dtype=compute_dtype)
    grads, metrics = update(jax.tree.map(jnp.asarray, params), obs, mv_oh, cm_oh, logp_old,
                            adv_n, ret, value_old)
    return _leaves(grads), [float(x) for x in metrics]


def _leaf_errors(got, want):
    """Each leaf's largest abs error over its largest entry."""
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want}


UPDATE_CASES = [pytest.param(kind, name, clipped, id=f"{kind}-{name}-{tag}")
                for kind, names in (("ppo", ("simple_spread", "simple_reference")),
                                    ("mappo", ("simple_spread", "simple_speaker_listener")))
                for name in names for clipped, tag in ((False, "epoch0"), (True, "clipped"))]


@pytest.mark.parametrize("kind, name, clipped", UPDATE_CASES)
def test_plain_bf16_update_matches_jax_bf16_kernel(bf16_dots, kind, name, clipped):
    got, got_m = _port(kind, *_batch(kind, name, clipped))
    want, want_m = _jax_update(kind, name, clipped, jnp.bfloat16)
    for k, x in got.items():
        assert x.dtype == np.float32 and x.shape == want[k].shape, k
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= PLAIN_TOL, errs
    gated = [0, 1, 2] if clipped else [1, 2]     # epoch 0: the pg mean is 0 up to rounding
    np.testing.assert_allclose(np.take(got_m, gated), np.take(want_m, gated), rtol=METRIC_RTOL)


@pytest.mark.parametrize("kind, name", [("ppo", "simple_spread"),
                                        ("mappo", "simple_speaker_listener")])
def test_bf16_grads_lie_nearer_jax_bf16_than_jax_f32(bf16_dots, kind, name):
    got, _ = _port(kind, *_batch(kind, name, True))
    to_bf16 = max(_leaf_errors(got, _jax_update(kind, name, True, jnp.bfloat16)[0]).values())
    to_f32 = max(_leaf_errors(got, _jax_update(kind, name, True, jnp.float32)[0]).values())
    assert 10 * to_bf16 <= to_f32, (to_bf16, to_f32)
    # and the port's own float32 path is not what ran
    f32, _ = _port(kind, *_batch(kind, name, True), compute_dtype=None)
    assert max(_leaf_errors(got, f32).values()) >= 10 * to_bf16


TRAINER_CASES = [pytest.param("ppo", "simple_spread", True, id="ppo-simple_spread"),
                 pytest.param("ppo", "simple_spread", False, id="ppo-simple_spread-autograd"),
                 pytest.param("mappo", "simple_speaker_listener", True,
                              id="mappo-simple_speaker_listener")]


@pytest.mark.parametrize("kind, name, fused_update", TRAINER_CASES)
def test_bf16_trainer_iteration_matches_jax(bf16_dots, kind, name, fused_update):
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=HIDDEN, block_envs=32, t_chunk=4,
              fused_update=fused_update)
    j_build = j_ppo.build_fused_ppo_step if kind == "ppo" else j_ppo.build_fused_mappo_step
    t_build = t_ppo.build_fused_ppo_step if kind == "ppo" else t_ppo.build_fused_mappo_step
    j_step = j_build(name, Mesh(np.array(jax.devices()[:1]), ("env",)), interpret=True,
                     compute_dtype=jnp.bfloat16, **kw)
    t_step = t_build(name, device="cpu", compute_dtype=BF16, **kw)
    params = jax.tree.map(np.asarray, j_step.init_params(jax.random.PRNGKey(0)))
    j_state, j_m = j_step(j_step.init_state(jax.tree.map(jnp.asarray, params)), 3)
    t_state, t_m = t_step(t_step.init_state(params_from_numpy(params, device="cpu")), 3)
    assert sorted(t_m) == sorted(j_m)
    for key in j_m:
        np.testing.assert_allclose(float(t_m[key]), float(j_m[key]), rtol=TRAINER_TOL,
                                   atol=TRAINER_TOL, err_msg=key)
    want = _leaves(j_state[0])
    for leaf, x in _leaves(params_to_numpy(t_state[0])).items():
        assert x.dtype == np.float32, leaf
        np.testing.assert_allclose(x, want[leaf], rtol=TRAINER_TOL, atol=TRAINER_TOL,
                                   err_msg=leaf)


def test_compute_dtype_resolves_to_the_params_dtype_and_refuses_others():
    kw = dict(n_envs=64, n_steps=8, horizon=4, hidden=HIDDEN, block_envs=32, t_chunk=4,
              device="cpu")
    assert t_update.compute_rounding(None) == (torch.float32, t_update._keep)
    assert t_update.compute_rounding(None, torch.float64) == (torch.float64, t_update._keep)
    assert t_update.compute_rounding(BF16, torch.float64) == (torch.float32, t_update._bf16)
    with pytest.raises(ValueError, match="compute_dtype"):
        t_ppo.build_fused_ppo_step("simple_spread", compute_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        t_update.fused_mappo_update("simple_spread", 64, 8, HIDDEN, device="cpu",
                                    compute_dtype=torch.float16)

"""The bf16 compute path (``compute_dtype=torch.bfloat16``) of the port's
MADDPG update against the JAX package's ``compute_dtype=bfloat16`` on the
CPU, at hidden 16 and a batch of 64 (``block_b=64`` on the JAX side), the
JAX products computed under ``bf16_dots`` (``tests/_bf16.py``); and the
generic learners with bf16 params (``init_policy(..., dtype=bfloat16)``).

- ``plain_maddpg_update(..., compute_dtype=torch.bfloat16)`` against JAX's
  ``fused_maddpg_update(..., interpret=True, compute_dtype=bfloat16)`` on
  simple_spread and simple_speaker_listener (a comm head): every leaf within
  ``PLAIN_TOL`` of its largest entry, the metrics within ``METRIC_RTOL``,
  the target actions equal to JAX's (its ``_dot`` through the packed
  target actors, the first argmax per head). Both round the same float32
  values to bf16, but an operand whose float32 sum the two took in another
  order can round a whole bf16 ulp (2^-8) apart, which at this batch can move
  a leaf by parts in a thousand of its largest entry (the host-built
  kernel's tests saw 2.35e-3 at 40 rows): measured here 1.7e-7 and 2.5e-6,
  the metrics within 3.8e-7 relative; the float32 path's tests hold 1e-9 in
  float64;
- the bf16 path is really taken: the port's bf16 grads lie at least 10x
  nearer JAX's bf16 grads than JAX's float32 grads (measured 1.05e-2 and
  3.5e-2 from the float32 ones);
- three updates of ``build_fused_update_chunk(..., compute_dtype=
  torch.bfloat16)`` against JAX's ``build_fused_update_chunk(...,
  interpret=True, compute_dtype=bfloat16)`` with JAX's replay indices
  injected: params and targets within ``CHUNK_TOL`` (measured 6.9e-7 at
  most), the last metrics within ``METRIC_RTOL`` (2.6e-6);
- ``compute_dtype`` resolves to float32 by default (and for None) and
  refuses other dtypes;
- bf16 params in the generic learners (``learner/pg.py``: the products in
  the params' dtype): ``policy_logits`` and the gradient of
  ``reinforce_loss`` on given obs, actions and rewards against JAX's
  ``policy_logits`` and ``jax.grad`` of the same loss, within ``PG_TOL``
  (2e-2, a few bf16 ulps) of the largest entry; the bias gradients, which
  JAX on the CPU sums in bf16, against the float32 sum (the test's
  docstring).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner import maddpg as jm
from mpe_tpu.learner import pg as j_pg
from mpe_tpu.ops.fused_maddpg_update import fused_maddpg_update as j_update
from mpe_tpu.ops.fused_update import _dot as j_dot
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.envs.functional import MpeEnv as TEnv
from mpe_tpu_torch.learner import maddpg as tm
from mpe_tpu_torch.learner import pg as t_pg
from mpe_tpu_torch.ops import fused_maddpg_update as tu
from tests._bf16 import bf16_dots  # noqa: F401 (the fixture)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

HIDDEN, BATCH, MW = 16, 64, 5
GAMMA, ENTC = 0.95, 0.01
PLAIN_TOL, METRIC_RTOL = 1e-3, 1e-5
CHUNK_TOL = 1e-5
PG_TOL = 2e-2
BF16 = torch.bfloat16
NAMES = ("simple_spread", "simple_speaker_listener")


def _leaves(tree):
    return {f"{n}.{q}.{w}": np.asarray(tree[n][q][w], np.float32)
            for n in sorted(tree) for q in sorted(tree[n]) for w in sorted(tree[n][q])}


def _leaf_errors(got, want):
    """Each leaf's largest abs error over its largest entry."""
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want}


@functools.cache
def _case(name):
    """(agents, obs width, head width, params, targets, rows) as numpy: JAX's
    init_maddpg at HIDDEN with the actors' head scaled to O(1) logits,
    targets = params + 0.1 N(0, 1), BATCH replay rows with one-hot actions."""
    kscn = j_kernel_scenario(name)
    a, o = kscn.spec.n_agents, kscn.obs_w
    k = MW + (kscn.spec.dim_c if kscn.uses_comm else 0)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jm.init_maddpg(jax.random.PRNGKey(3), o, k, a, hidden=HIDDEN))
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
def _jax_grads(name, compute_dtype):
    """JAX's kernel on ``_case(name)`` in interpret mode (once per module,
    under ``bf16_dots``) -> (leaves, metrics, target actions [B, A, heads])."""
    a, o, k, params, targets, rows = _case(name)
    fn = j_update(a, o, k, MW, hidden=HIDDEN, batch=BATCH, gamma=GAMMA, ent_coef=ENTC,
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


def _port(name, compute_dtype=BF16):
    a, o, k, params, targets, rows = _case(name)
    tp, tt = (params_from_numpy(x, device="cpu") for x in (params, targets))
    grads_fn = tu.fused_maddpg_update(a, o, k, MW, HIDDEN, BATCH, gamma=GAMMA, ent_coef=ENTC,
                                      device="cpu", compute_dtype=compute_dtype)
    grads, metrics = grads_fn.from_rows(tp, tt, torch.tensor(rows))
    obs2 = torch.tensor(rows[:, a * (o + k + 1):]).reshape(BATCH, a, o)
    idx = tu.target_indices(tu.target_logits(tt["actor"], obs2, compute_dtype), MW)
    return _leaves(params_to_numpy(grads)), [float(m) for m in metrics], idx.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_plain_bf16_maddpg_update_matches_jax_bf16_kernel(bf16_dots, name):
    got, got_m, got_idx = _port(name)
    want, want_m, want_idx = _jax_grads(name, jnp.bfloat16)
    for key, x in got.items():
        assert x.shape == want[key].shape, key
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= PLAIN_TOL, errs
    np.testing.assert_allclose(got_m, want_m, rtol=METRIC_RTOL)
    np.testing.assert_array_equal(got_idx, want_idx)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_maddpg_grads_lie_nearer_jax_bf16_than_jax_f32(bf16_dots, name):
    got, _, _ = _port(name)
    to_bf16 = max(_leaf_errors(got, _jax_grads(name, jnp.bfloat16)[0]).values())
    to_f32 = max(_leaf_errors(got, _jax_grads(name, jnp.float32)[0]).values())
    assert 10 * to_bf16 <= to_f32, (to_bf16, to_f32)
    # and the port's own float32 path is not what ran
    f32, _, _ = _port(name, compute_dtype=torch.float32)
    assert max(_leaf_errors(got, f32).values()) >= 10 * to_bf16


def test_bf16_update_chunk_matches_jax_with_injected_indices(bf16_dots):
    n_updates, cap = 3, 256
    a, o, k = 3, 18, MW
    j_env = JEnv(j_scenarios.load("simple_spread"), max_steps=25, auto_reset=True)
    t_env = TEnv(t_scenarios.load("simple_spread"), max_steps=25, auto_reset=True, device="cpu")
    _, _, _, params, targets, _ = _case("simple_spread")
    rng = np.random.default_rng(5)
    obs, obs2 = rng.normal(size=(2, cap, a, o)).astype(np.float32)
    data = (obs, np.eye(k, dtype=np.float32)[rng.integers(0, k, (cap, a))],
            rng.normal(size=(cap, a)).astype(np.float32), obs2)
    jb = jm.Buffer.pack(*map(jnp.asarray, data), ptr=jnp.int32(0), size=jnp.int32(cap))
    tb = tm.Buffer.pack(*(torch.tensor(x) for x in data), ptr=0, size=cap)
    key = jax.random.PRNGKey(21)
    gates = np.asarray([False, True, True])
    j_chunk = jm.build_fused_update_chunk(j_env, n_updates, batch=BATCH, tau_polyak=0.03,
                                          hidden=HIDDEN, block_b=64, interpret=True,
                                          grad_engine="kernel", compute_dtype=jnp.bfloat16)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    jp, jt, _, jmet = j_chunk(jp, jt, j_chunk.init_opt(jp), jb, key, jnp.asarray(gates))
    keys = jax.vmap(lambda u: jax.random.fold_in(key, u))(jnp.arange(n_updates, dtype=jnp.uint32))
    idx = np.asarray(jax.vmap(lambda kk: jax.random.randint(kk, (BATCH,), 0, cap))(keys))
    tp, tt = (params_from_numpy(x, device="cpu") for x in (params, targets))
    chunk = tm.build_fused_update_chunk(t_env, n_updates, batch=BATCH, tau_polyak=0.03,
                                        hidden=HIDDEN, device="cpu", compute_dtype=BF16)
    p, t, opt, met = chunk(tp, tt, chunk.init_opt(tp), tb, 0, gates, indices=idx)
    assert opt["actor"].count == 2 and opt["critic"].count == n_updates
    for got, want in ((p, jp), (t, jt)):
        got, want = _leaves(params_to_numpy(got)), _leaves(want)
        for leaf, x in got.items():
            np.testing.assert_allclose(x, want[leaf], rtol=CHUNK_TOL, atol=CHUNK_TOL, err_msg=leaf)
    for m in ("critic_loss", "actor_loss", "q"):
        np.testing.assert_allclose(float(met[m]), float(jmet[m]), rtol=METRIC_RTOL, err_msg=m)
    # the same chunk in float32 moves the params elsewhere: the bf16 path ran
    f32 = tm.build_fused_update_chunk(t_env, n_updates, batch=BATCH, tau_polyak=0.03,
                                      hidden=HIDDEN, device="cpu")
    p32 = f32(tp, tt, f32.init_opt(tp), tb, 0, gates, indices=idx)[0]
    assert max(np.abs(x - y).max() for x, y in zip(_leaves(params_to_numpy(p32)).values(),
                                                   _leaves(params_to_numpy(p)).values())) > 0


def test_maddpg_compute_dtype_resolves_to_float32_and_refuses_others():
    assert tu.maddpg_rounding(torch.float32) == (torch.float32, tu._keep)
    assert tu.maddpg_rounding(None, torch.float64) == (torch.float64, tu._keep)
    assert tu.maddpg_rounding(torch.float32, torch.float64) == (torch.float64, tu._keep)
    assert tu.maddpg_rounding(BF16, torch.float64)[0] == torch.float32
    assert tu._k9_source(torch.float32) == tu._k9_source(None) == "mpe_maddpg.cu"
    assert tu._k9_source(BF16) == "mpe_maddpg_bf16.cu"
    env = TEnv(t_scenarios.load("simple_spread"), max_steps=25, auto_reset=True, device="cpu")
    for bad in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="compute_dtype"):
            tu.fused_maddpg_update(3, 18, 5, MW, HIDDEN, BATCH, device="cpu", compute_dtype=bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            tm.build_fused_update_chunk(env, 2, batch=BATCH, hidden=HIDDEN, device="cpu",
                                        compute_dtype=bad)
    # the default is JAX's: float32, and equal to None's
    a, o, k, params, targets, rows = _case("simple_spread")
    tp, tt = (params_from_numpy(x, device="cpu") for x in (params, targets))
    default = tu.fused_maddpg_update(a, o, k, MW, HIDDEN, BATCH, device="cpu")
    none = tu.fused_maddpg_update(a, o, k, MW, HIDDEN, BATCH, device="cpu", compute_dtype=None)
    g1, g2 = (_leaves(params_to_numpy(f.from_rows(tp, tt, torch.tensor(rows))[0]))
              for f in (default, none))
    assert all(np.array_equal(g1[key], g2[key]) for key in g1)


def test_pg_bf16_params_logits_and_reinforce_grad_match_jax():
    """``init_policy(..., dtype=bfloat16)`` params (JAX's draw, read out) in
    ``policy_logits`` and the gradient of the REINFORCE loss on given obs,
    moves, utterances and team rewards (the draws differ between the
    frameworks, so they are injected), against JAX's: the logits within
    ``PG_TOL`` of their largest (measured equal), the loss within 1e-3
    relative (measured 1.4e-7), each weight gradient within ``PG_TOL`` of its
    largest entry (measured 0 to 8.4e-3: each framework rounds every bf16 op
    of the backward pass after its own float32 sums). The bias
    gradients are sums of the backward signal over the 288 (step, env,
    agent) rows: JAX on the CPU sums them in bf16, 1.3e-2 to 3.5e-2 of the
    largest entry from the float32 sum of the same bf16 cotangents, while the
    port sums in float32 (2.6e-3 to 1.2e-2 from it); so each bias gradient is
    held to that float32 reference within ``PG_TOL``, and the port's lies no
    farther from it than JAX's."""
    n_steps, n_envs, gamma = 6, 16, 0.95
    env = TEnv(t_scenarios.load("simple_spread"), device="cpu")
    a, o, dim_c = env.n_agents, 18, env.spec.dim_c
    k = MW + dim_c
    params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                          j_pg.init_policy(jax.random.PRNGKey(7), o, k, hidden=HIDDEN,
                                           dtype=jnp.bfloat16))
    rng = np.random.default_rng(8)
    obs = rng.normal(size=(n_steps, n_envs, a, o)).astype(np.float32)
    moves = rng.integers(0, MW, (n_steps, n_envs, a))
    comms = rng.integers(0, dim_c, (n_steps, n_envs, a))
    team_rew = rng.normal(size=(n_steps, n_envs)).astype(np.float32)

    def j_loss(p):
        logits = j_pg.policy_logits(p, jnp.asarray(obs))                   # [T, B, A, K]
        logp = 0.0
        for lg, idx in ((logits[..., :MW], moves), (logits[..., MW:], comms)):
            logp = logp + jnp.take_along_axis(jax.nn.log_softmax(lg), jnp.asarray(idx)[..., None],
                                              -1)[..., 0].sum(-1)         # [T, B]

        def disc(carry, r):
            g = r + gamma * carry
            return g, g
        _, ret = jax.lax.scan(disc, jnp.zeros(n_envs), jnp.asarray(team_rew), reverse=True)
        return -jnp.mean(logp * jax.lax.stop_gradient(ret))

    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    want_logits = np.asarray(j_pg.policy_logits(jp, jnp.asarray(obs)))
    want = jax.grad(j_loss)(jp)
    f32 = jax.grad(j_loss)(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params))
    tp = params_from_numpy(params, device="cpu", dtype=BF16)
    got_logits = t_pg.policy_logits(tp, torch.tensor(obs))
    assert got_logits.dtype == torch.float32 and want_logits.dtype == np.float32
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0,
                               atol=PG_TOL * np.abs(want_logits).max())
    leaves = {q: {w: x.detach().requires_grad_(True) for w, x in layer.items()}
              for q, layer in tp.items()}
    loss = t_pg.reinforce_loss(env, leaves, torch.tensor(obs), torch.tensor(moves),
                               torch.tensor(comms), torch.tensor(team_rew), gamma)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss(jp)), rtol=1e-3)
    for q, layer in leaves.items():
        for w, x in layer.items():
            assert x.grad.dtype == BF16, f"{q}.{w}"
            g = x.grad.float().numpy()
            jg, ref = (np.asarray(t[q][w].astype(jnp.float32)) for t in (want, f32))
            if w == "w":
                np.testing.assert_allclose(g, jg, rtol=0, atol=PG_TOL * np.abs(jg).max(),
                                           err_msg=f"{q}.{w}")
            else:
                scale = np.abs(ref).max()
                np.testing.assert_allclose(g, ref, rtol=0, atol=PG_TOL * scale,
                                           err_msg=f"{q}.{w}")
                assert np.abs(g - ref).max() <= np.abs(jg - ref).max(), f"{q}.{w}"

"""The port's MADDPG pieces at the hidden widths 128 and 256 (K8 and K9 are
compiled for them, ``_build.HIDDEN_WIDTHS["mpe_maddpg.cu"]``) against the JAX
package on the CPU, each at a small size:

- plain K8 against ``fused_maddpg_trajectory(interpret=True)`` on
  simple_spread and simple_speaker_listener (a comm head), both output forms:
  actions equal, values within 1e-5;
- plain K9 in float64 against the JAX kernel in interpret mode at 128 and
  against JAX's ``maddpg_xla_grads`` (``jax.grad`` of the losses, its float32
  casts made float64) at 256, each leaf within 1e-9 of the largest entry;
- two calls of the fused update chunk at 256 against JAX's with JAX's replay
  indices injected, in float64 (in float32 Adam turns a near-zero gradient's
  rounding into a whole step), params within 1e-9;
- K9's wrappers refuse the widths their source is not compiled for before any
  launch (K9 48; K9-bf16 48, 128 and 256), naming that source's widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.envs.functional import MpeEnv as JEnv
from mpe_tpu.learner import maddpg as jm
from mpe_tpu.ops.fused_maddpg import fused_maddpg_trajectory as j_traj
from mpe_tpu.ops.fused_maddpg_update import fused_maddpg_update as j_update
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import params_from_numpy, params_to_numpy
from mpe_tpu_torch.envs.functional import MpeEnv as TEnv
from mpe_tpu_torch.learner import maddpg as tm
from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory as t_traj
from mpe_tpu_torch.ops.fused_maddpg_update import fused_maddpg_update as t_update
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (128, 256)
NAMES = ("simple_spread", "simple_speaker_listener")
MW = 5


def _dims(name):
    """(agents, obs width, comm logits) of the scenario's MADDPG nets."""
    kscn = kernel_scenario(name)
    return kscn.spec.n_agents, kscn.obs_w, kscn.n_comm


def _jax_params(name, hidden, seed=0, dtype=np.float32):
    a, ow, cw = _dims(name)
    return jax.tree.map(lambda x: np.asarray(x, dtype),
                        jm.init_maddpg(jax.random.PRNGKey(seed), ow, MW + cw, a, hidden=hidden))


def _flat(tree, prefix=""):
    """Nested dicts -> {path: numpy array}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_trees(got, want, scale_tol):
    """Every leaf of ``got`` within ``scale_tol`` of the largest entry of
    ``want``'s leaf (and at least of 1)."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=scale_tol * max(float(np.abs(w).max()), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_plain_maddpg_trajectory_at_wide_width_matches_jax_interpret(hidden, name):
    """Plain K8 of actors of width ``hidden`` (the head's logits scaled to
    O(1), so that the actor, not the Gumbel noise alone, picks the actions)
    against the JAX kernel in interpret mode, eps 0.1, both forms."""
    kw = dict(n_envs=16, n_steps=8, horizon=4, eps_greedy=0.1, block_envs=8, t_chunk=4)
    a, _, cw = _dims(name)
    actor = _jax_params(name, hidden)["actor"]
    actor["out"]["w"] = actor["out"]["w"] * 30.0
    tactor = params_from_numpy(actor, device="cpu")
    kscn = j_kernel_scenario(name)
    for rows in (False, True):
        want = j_traj(kscn, actor, interpret=True, emit_rows=rows, **kw)(
            5, jax.tree.map(jnp.asarray, actor), 1)
        got = t_traj(name, tactor, emit_rows=rows, device="cpu", **kw)(5, tactor, 1)
        got, want = ((got,), (want,)) if rows else (got, want)
        for label, g, w in zip(("obs", "act", "rew", "obs2"), got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, label
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=0 if label == "act" else 1e-5,
                                       err_msg=f"{label} (rows={rows})")
        if not rows:
            act = got[1].numpy()
            np.testing.assert_array_equal(act[:, :, :MW].sum(2), np.ones((8, a, 16)))
            assert len(np.unique(act[:, :, :MW].argmax(2))) == MW      # the actions vary
            if cw:
                np.testing.assert_array_equal(act[:, :, MW:].sum(2), np.ones((8, a, 16)))


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` meaning float64: JAX's MADDPG losses cast
    the logits and Q to float32, which would narrow a float64 reference."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _batch(name, batch, seed):
    """Random replay data (obs, act one-hots [move | comm], rew, obs2), float64."""
    a, ow, cw = _dims(name)
    rng = np.random.default_rng(seed)
    obs, obs2 = rng.normal(size=(2, batch, a, ow))
    act = np.eye(MW)[rng.integers(0, MW, (batch, a))]
    if cw:
        act = np.concatenate([act, np.eye(cw)[rng.integers(0, cw, (batch, a))]], -1)
    return obs, act, rng.normal(size=(batch, a)), obs2


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_plain_maddpg_update_f64_at_wide_width_matches_jax(hidden, name, monkeypatch):
    """Plain K9 in float64 at ``hidden`` on 64 samples, targets = params +
    0.1 N(0, 1): at 128 against the JAX kernel in interpret mode, at 256
    against JAX's ``maddpg_xla_grads`` (``jax.grad`` of the same losses, its
    float32 casts made float64); the rows path equal to the tensor path."""
    a, ow, cw = _dims(name)
    k, batch = MW + cw, 64
    params = _jax_params(name, hidden, seed=1, dtype=np.float64)
    rng = np.random.default_rng(9)
    targets = jax.tree.map(lambda x: x + 0.1 * rng.normal(size=x.shape), params)
    data = _batch(name, batch, 7)
    jp, jt = (jax.tree.map(jnp.asarray, x) for x in (params, targets))
    if hidden == 128:
        want, want_m = j_update(a, ow, k, MW, hidden=hidden, batch=batch, block_b=64,
                                interpret=True, compute_dtype=jnp.float64)(
            jp, jt, *map(jnp.asarray, data))
    else:
        monkeypatch.setattr(jm, "jnp", _Float64Jnp())
        want, want_m = jm.maddpg_xla_grads(jp, jt, *map(jnp.asarray, data), mw=MW, cw=cw,
                                           gamma=0.95, ent_coef=0.01)
    tp, tt = (params_from_numpy(x, device="cpu", dtype=torch.float64) for x in (params, targets))
    tdata = tuple(torch.tensor(x) for x in data)
    grads_fn = t_update(a, ow, k, MW, hidden, batch, device="cpu", dtype=torch.float64)
    got, got_m = grads_fn(tp, tt, *tdata)
    scale = max(float(np.abs(w).max()) for w in _flat(want).values())
    for leaf, g in _flat(got).items():
        assert g.dtype == np.float64, leaf
        np.testing.assert_allclose(g, _flat(want)[leaf], rtol=1e-9, atol=1e-9 * max(scale, 1.0),
                                   err_msg=leaf)
    np.testing.assert_allclose([float(x) for x in got_m], [float(x) for x in want_m], rtol=1e-9,
                               atol=1e-12)
    rows = torch.cat([tdata[0].reshape(batch, -1), tdata[1].reshape(batch, -1), tdata[2],
                      tdata[3].reshape(batch, -1)], 1)
    again, _ = grads_fn.from_rows(tp, tt, rows)
    for leaf, g in _flat(again).items():
        np.testing.assert_array_equal(g, _flat(got)[leaf], err_msg=leaf)


def test_update_chunk_at_256_matches_jax_over_two_chunks():
    """Two calls of ``build_fused_update_chunk`` (2 updates each, batch 32)
    at hidden 256 on simple_speaker_listener, float64, with JAX's replay
    indices injected, against JAX's chunk (the kernel engine in interpret
    mode): params, targets and metrics within 1e-9, Adam's counts equal."""
    name, hidden, n_updates, batch, cap = "simple_speaker_listener", 256, 2, 32, 256
    j_env = JEnv(j_scenarios.load(name), max_steps=25, auto_reset=True)
    t_env = TEnv(t_scenarios.load(name), max_steps=25, auto_reset=True, device="cpu")
    params = _jax_params(name, hidden, seed=3, dtype=np.float64)
    data = tuple(x.astype(np.float32) for x in _batch(name, cap, 5))
    jb = jm.Buffer.pack(*map(jnp.asarray, data), ptr=jnp.int32(0), size=jnp.int32(cap))
    tb = tm.Buffer.pack(*(torch.tensor(x) for x in data), ptr=0, size=cap)
    kw = dict(batch=batch, tau_polyak=0.03, hidden=hidden)
    j_chunk = jm.build_fused_update_chunk(j_env, n_updates, block_b=32, interpret=True,
                                          grad_engine="kernel", compute_dtype=jnp.float64, **kw)
    t_chunk = tm.build_fused_update_chunk(t_env, n_updates, device="cpu", dtype=torch.float64,
                                          **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jt, jo = jp, j_chunk.init_opt(jp)
    tp = params_from_numpy(params, device="cpu", dtype=torch.float64)
    tt, to = tp, t_chunk.init_opt(tp)
    for call, gates in enumerate(([True, False], [True, True])):
        key = jax.random.PRNGKey(21 + call)
        jp, jt, jo, jmet = j_chunk(jp, jt, jo, jb, key, jnp.asarray(gates))
        keys = jax.vmap(lambda u: jax.random.fold_in(key, u))(
            jnp.arange(n_updates, dtype=jnp.uint32))
        idx = np.asarray(jax.vmap(lambda q: jax.random.randint(q, (batch,), 0, cap))(keys))
        tp, tt, to, met = t_chunk(tp, tt, to, tb, 0, np.asarray(gates), indices=idx)
        _assert_trees(params_to_numpy(tp), jp, 1e-9)
        _assert_trees(params_to_numpy(tt), jt, 1e-9)
        for metric in ("critic_loss", "actor_loss", "q"):
            np.testing.assert_allclose(float(met[metric]), float(jmet[metric]), rtol=1e-9,
                                       err_msg=metric)
    assert to["actor"].count == 3 and to["critic"].count == 2 * n_updates


@pytest.mark.parametrize("compute_dtype, hidden", [(torch.float32, 48), (torch.bfloat16, 48),
                                                   (torch.bfloat16, 128), (torch.bfloat16, 256),
                                                   (torch.float32, 128), (torch.float32, 256)])
def test_maddpg_update_wrappers_refuse_uncompiled_widths_before_any_launch(compute_dtype, hidden):
    """K9's wrappers (``maddpg_update_cuda``, ``MaddpgUpdateLauncher``) raise for
    a width their source is not compiled for, naming that source's widths,
    before they look at the device (so here, without a card): K9 and K9-bf16
    at 48; K9 and K9-bf16 at 128 and 256 get past the width to the device
    check."""
    import re

    from mpe_tpu_torch.ops import fused_maddpg_update as fmu

    params = tm.init_maddpg(torch.Generator().manual_seed(0), 18, 5, 3, hidden=hidden)
    rows = torch.zeros((64, 3 * (2 * 18 + 5 + 1)))
    before = (fmu.maddpg_update_cuda.launches, fmu.maddpg_update_bf16_cuda.launches)
    f32 = compute_dtype == torch.float32
    if hidden in (128, 256):
        error, match = ValueError, "needs"
    else:
        source = "mpe_maddpg.cu" if f32 else "mpe_maddpg_bf16.cu"
        widths = "8, 16, 32, 64, 128, 256"
        error, match = NotImplementedError, re.escape(
            f"(csrc/{source}) are compiled for hidden widths {widths}; got {hidden}")
    with pytest.raises(error, match=match):
        fmu.maddpg_update_cuda(params, params, rows, mw=MW, gamma=0.95, ent_coef=0.01,
                               compute_dtype=compute_dtype)
    with pytest.raises(error, match=match):
        fmu.MaddpgUpdateLauncher(3, 18, 5, MW, hidden, 64, "cpu", gamma=0.95, ent_coef=0.01,
                                 compute_dtype=compute_dtype)
    assert before == (fmu.maddpg_update_cuda.launches, fmu.maddpg_update_bf16_cuda.launches)

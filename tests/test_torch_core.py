"""The port's spec, action decode and physics against the JAX package.

Same numpy-made inputs through ``mpe_tpu`` and ``mpe_tpu_torch`` on the
CPU, float64, atol 1e-12. Noise normals are drawn in JAX exactly as
``mpe_tpu/core/physics.py`` draws them and injected into the port. Also
the port's guards: no JAX import anywhere in it, no quiet CPU fallback,
and no fused kernel for specs that need ``mxu_physics``.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu.core import actions as j_actions
from mpe_tpu.core import physics as j_physics
from mpe_tpu.core import state as j_state
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.convert import spec_fields, state_from_numpy, state_to_numpy
from mpe_tpu_torch.core import actions as t_actions
from mpe_tpu_torch.core import physics as t_physics
from mpe_tpu_torch.core import state as t_state
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 8


def _random_spec_kwargs(seed: int) -> dict:
    """make_spec arguments covering the table features: colliding
    landmarks, finite max speed, non-unit masses, silent and non-silent
    agents, per-agent accel, noise."""
    rng = np.random.default_rng(seed)
    a, l = int(rng.integers(1, 5)), int(rng.integers(0, 4))
    return dict(
        name=f"fuzz{seed}", n_agents=a, n_landmarks=l,
        agent_movable=[bool(x) for x in rng.random(a) < 0.85],
        agent_silent=[bool(x) for x in rng.random(a) < 0.5],
        agent_size=[float(x) for x in rng.uniform(0.03, 0.3, a)],
        agent_accel=[None if rng.random() < 0.3 else float(rng.uniform(1, 5)) for _ in range(a)],
        agent_max_speed=[None if rng.random() < 0.4 else float(rng.uniform(0.3, 1.5))
                         for _ in range(a)],
        agent_u_noise=float(rng.uniform(0.1, 0.5)) if seed % 2 else None,
        agent_c_noise=float(rng.uniform(0.1, 0.5)) if seed % 3 == 0 else None,
        landmark_collide=[bool(x) for x in rng.random(l) < 0.5],
        landmark_size=[float(x) for x in rng.uniform(0.03, 0.3, l)],
        mass=[float(x) for x in rng.uniform(0.5, 2.0, a + l)],
        dim_c=int(rng.integers(0, 4)),
        force_discrete_action=bool(seed % 2 == 0),
    )


def _both_specs(kwargs):
    return j_state.make_spec(**kwargs), t_state.make_spec(**kwargs)


def _assert_specs_equal(j_spec, t_spec):
    jf, tf = spec_fields(j_spec), spec_fields(t_spec)
    assert jf.keys() == tf.keys()
    for k in jf:
        if isinstance(jf[k], np.ndarray):
            assert jf[k].dtype == tf[k].dtype and not tf[k].flags.writeable, k
            np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
        else:
            assert jf[k] == tf[k], k


@pytest.mark.parametrize("seed", ["simple_spread", 0, 1, 2, 3, 4, 5])
def test_make_spec_matches_jax(seed):
    if seed == "simple_spread":
        from mpe_tpu import scenarios as j_scenarios

        _assert_specs_equal(j_scenarios.load("simple_spread").spec,
                            t_scenarios.load("simple_spread").spec)
    else:
        _assert_specs_equal(*_both_specs(_random_spec_kwargs(seed)))


@pytest.mark.parametrize("mode", list(t_actions.ActionMode))
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_actions_matches_jax(mode, seed):
    kwargs = _random_spec_kwargs(seed)
    j_spec, t_spec = _both_specs(kwargs)
    rng = np.random.default_rng(10 + seed)
    w = t_actions.action_width(t_spec, mode)
    assert w == j_actions.action_width(j_spec, j_actions.ActionMode(mode.value))
    if mode is t_actions.ActionMode.DISCRETE_INDEX:
        acts = np.stack([rng.integers(0, 5, (B, t_spec.n_agents)),
                         rng.integers(0, max(t_spec.dim_c, 1) + 1, (B, t_spec.n_agents))], -1)
    else:
        acts = rng.normal(size=(B, t_spec.n_agents, w))
    j_decode = jax.vmap(lambda x: j_actions.decode_actions(
        j_spec, x, j_actions.ActionMode(mode.value), jnp.float64))
    ju, jc = j_decode(jnp.asarray(acts))
    tu, tc = t_actions.decode_actions(t_spec, torch.as_tensor(acts), mode, torch.float64)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)


def _random_state(spec, rng):
    e, a, p = spec.n_entities, spec.n_agents, spec.dim_p
    pos = rng.uniform(-1, 1, (B, e, p))
    pos[:, :, :] *= rng.uniform(0.05, 1.0, (B, 1, 1))        # crowd some envs into contact
    if e > 1:
        pos[0, 1] = pos[0, 0]                                 # an exact overlap
    vel = rng.uniform(-1, 1, (B, e, p)) * spec.movable[None, :, None]
    comm = rng.uniform(0, 1, (B, a, spec.dim_c))
    goal = np.zeros((B, spec.n_goals), np.int32)
    t = rng.integers(0, 5, B).astype(np.int32)
    return pos, vel, comm, goal, t


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_step_world_matches_jax(seed):
    kwargs = _random_spec_kwargs(seed)
    j_spec, t_spec = _both_specs(kwargs)
    rng = np.random.default_rng(100 + seed)
    leaves = _random_state(t_spec, rng)
    u = rng.normal(size=(B, t_spec.n_agents, t_spec.dim_p))
    c = rng.normal(size=(B, t_spec.n_agents, t_spec.dim_c))
    keys = jax.random.split(jax.random.PRNGKey(seed), B)

    j_state_in = j_state.WorldState(*(jnp.asarray(x) for x in leaves))
    j_out = jax.vmap(lambda s, uu, cc, k: j_physics.step_world(j_spec, s, uu, cc, k))(
        j_state_in, jnp.asarray(u), jnp.asarray(c), keys)

    # the normals physics.py draws: split(key) -> (ku, kc), one normal each
    def normals(k):
        ku, kc = jax.random.split(k)
        return (jax.random.normal(ku, u.shape[1:], jnp.float64),
                jax.random.normal(kc, c.shape[1:], jnp.float64))

    n_u, n_c = jax.vmap(normals)(keys)
    t_in = state_from_numpy(*leaves, device="cpu")
    t_out = t_physics.step_world(t_spec, t_in, torch.as_tensor(u), torch.as_tensor(c),
                                 normals=(torch.tensor(np.asarray(n_u)),
                                          torch.tensor(np.asarray(n_c))))
    for name, jx, tx in zip(("pos", "vel", "comm", "goal", "t"),
                            (j_out.pos, j_out.vel, j_out.comm, j_out.goal, j_out.t),
                            state_to_numpy(t_out)):
        np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=1e-12, err_msg=name)
    assert np.isfinite(state_to_numpy(t_out)[0]).all()


def test_collision_forces_exact_overlap_is_zero_and_finite():
    spec = t_scenarios.load("simple_spread").spec
    pos = torch.zeros((2, spec.n_entities, 2), dtype=torch.float64)
    f = t_physics.collision_forces(spec, pos)
    assert torch.isfinite(f).all() and (f == 0).all()


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_imports_no_jax():
    files = sorted((REPO / "mpe_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "mpe_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from mpe_tpu_torch import (MpeEnv, entry, fused_det_rollout, fused_spread_rollout,
                               interactive_cli, make_env, registry)
    from mpe_tpu_torch.envs import MultiAgentEnv, VecMultiAgentEnv, aec_env, parallel_env
    from mpe_tpu_torch.learner import (build_approx_runner, build_ensemble_runner, build_es_step,
                                       build_fused_maddpg_runner, build_maddpg, build_mappo_step,
                                       build_ppo_step, build_train_step, init_policy)
    from mpe_tpu_torch.examples import rollout
    from mpe_tpu_torch.learner.eval import greedy_state_rollout
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
    from mpe_tpu_torch.render.video import record_gif

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scn = t_scenarios.load("simple_spread")
    kscn = kernel_scenario("simple")
    policy = init_policy(torch.Generator().manual_seed(0), kscn.obs_w, 5, hidden=16)
    for call in (lambda: MpeEnv(scn, device=None),
                 lambda: fused_spread_rollout(scn.spec, 256, 4, device=None),
                 lambda: fused_det_rollout("simple_spread", 256, 4, device=None),
                 lambda: entry(),
                 lambda: make_env("simple_spread"),
                 lambda: registry.make("simple_spread-v0"),
                 lambda: MultiAgentEnv(scn),
                 lambda: VecMultiAgentEnv(MpeEnv(scn, device=None), 4),
                 lambda: parallel_env("simple_tag"),
                 lambda: aec_env("simple_tag"),
                 lambda: build_train_step(MpeEnv(scn, device=None), 4),
                 lambda: build_ppo_step(MpeEnv(scn, device=None), 4),
                 lambda: build_mappo_step(MpeEnv(scn, device=None), 4),
                 lambda: build_es_step(kscn, policy, 64, 20, 10, 8, 0.1, 0.1, device=None),
                 lambda: greedy_state_rollout(scn, None),
                 lambda: build_maddpg(MpeEnv(scn, max_steps=25, auto_reset=True, device=None),
                                      capacity=64),
                 lambda: build_fused_maddpg_runner("simple_spread", local_critic=True),
                 lambda: build_ensemble_runner("simple_tag", 3),
                 lambda: build_approx_runner("simple_spread"),
                 lambda: interactive_cli.main(["--steps", "1", "--headless"]),
                 lambda: record_gif("simple", str(tmp_path / "x.gif"), n_steps=2),
                 lambda: rollout.main(["--n-envs", "8", "--n-steps", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_scenario_rejects_mxu_noise_and_scripted_specs():
    from mpe_tpu_torch.ops._build import kernel_params
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
    from mpe_tpu_torch.scenarios._base import Scenario

    def scenario(spec, scripted=False):
        hooks = {"scripted_action": (lambda self, s: None)} if scripted else {}
        cls = type("S", (Scenario,), hooks)
        scn = cls()
        scn.spec = spec
        return scn

    # four agents of simple_spread have 6 collide pairs: the blocks take the
    # pair physics, and the CUDA kernels, compiled for 3 agents, refuse it
    crowded = t_state.make_spec("simple_spread", 4, 4, agent_size=0.15, dim_c=2,
                                collaborative=True)
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        kernel_params(kernel_scenario(scenario(crowded)))
    noisy = t_state.make_spec("simple_spread", 3, 3, agent_u_noise=0.1, dim_c=2)
    with pytest.raises(NotImplementedError, match="u_noise"):
        kernel_scenario(scenario(noisy))
    plain = t_scenarios.load("simple_spread").spec
    with pytest.raises(NotImplementedError, match="scripted_action"):
        kernel_scenario(scenario(plain, scripted=True))
    with pytest.raises(KeyError, match="simple_spread"):
        kernel_scenario("simple_nonexistent")
    assert type(kernel_scenario("simple_spread")).__name__ == "KernelSpread"
    assert type(kernel_scenario("simple_tag")).__name__ == "KernelTag"

"""The port's env-minor step math, hashes and fused rollouts against the
JAX package on the CPU.

- step blocks: float64, atol 1e-12;
- the two hashes (``_hash_uniform``, ``hash_uniform_2d``): bit for bit;
- the plain fused and deterministic rollouts against the JAX kernels run
  in Pallas interpret mode: float32, atol and rtol 1e-5 (CPU libm and
  XLA's exp/log1p/rsqrt differ by ulps).

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions there.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe_tpu import scenarios as j_scenarios
from mpe_tpu.core.state import make_spec as j_make_spec
from mpe_tpu.envs.functional import MpeEnv as JMpeEnv
from mpe_tpu_torch import scenarios as t_scenarios
from mpe_tpu_torch.core.state import make_spec as t_make_spec

j_batched = importlib.import_module("mpe_tpu.ops.batched")
j_fused = importlib.import_module("mpe_tpu.ops.fused_rollout")
j_parity = importlib.import_module("mpe_tpu.ops.fused_parity")
j_kscn = importlib.import_module("mpe_tpu.ops.kernel_scenarios")
t_batched = importlib.import_module("mpe_tpu_torch.ops.batched")
t_fused = importlib.import_module("mpe_tpu_torch.ops.fused_rollout")
t_parity = importlib.import_module("mpe_tpu_torch.ops.fused_parity")
t_kscn = importlib.import_module("mpe_tpu_torch.ops.kernel_scenarios")

N = 16
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture()
def block():
    """Env-minor simple_spread states (crowded, so pairs collide) and
    one-hot-ish moves, float64."""
    env = JMpeEnv(j_scenarios.load("simple_spread"), dtype=jnp.float64)
    states, _ = jax.vmap(env.reset, out_axes=-1)(jax.random.split(jax.random.PRNGKey(0), N))
    pos = np.asarray(states.pos) * np.where(np.arange(N) < N // 2, 0.15, 1.0)
    vel = np.random.default_rng(1).uniform(-0.5, 0.5, pos.shape)
    vel[3:] = 0.0                                          # landmarks do not move
    moves = np.random.default_rng(2).uniform(size=(3, 5, N))
    return j_scenarios.load("simple_spread").spec, t_scenarios.load("simple_spread").spec, \
        pos, vel, moves


def test_batched_spread_step_matches_jax(block):
    j_spec, t_spec, pos, vel, moves = block
    j_out = j_batched.batched_spread_step(j_spec, jnp.asarray(pos), jnp.asarray(vel),
                                          jnp.asarray(moves))
    t_out = t_batched.batched_spread_step(t_spec, *(torch.as_tensor(x) for x in (pos, vel, moves)))
    for name, a, b in zip(("pos", "vel", "reward", "obs"), t_out, j_out):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12, err_msg=name)


def test_spread_step_block_matches_jax(block):
    j_spec, t_spec, pos, vel, moves = block
    j_out = j_fused.spread_step_block(j_spec, jnp.asarray(pos[:3]), jnp.asarray(vel[:3]),
                                      jnp.asarray(pos[3:]), jnp.asarray(moves))
    t_out = t_fused.spread_step_block(t_spec, torch.as_tensor(pos[:3]), torch.as_tensor(vel[:3]),
                                      torch.as_tensor(pos[3:]), torch.as_tensor(moves))
    for name, a, b in zip(("apos", "avel", "reward", "obs"), t_out, j_out):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12, err_msg=name)


_PHYSICS_SPECS = {
    "spread": dict(name="simple_spread", n_agents=3, n_landmarks=3, agent_size=0.15,
                   dim_c=2, collaborative=True),
    # colliding landmark obstacle, finite max speed, masses, per-agent accel
    "mixed": dict(name="mixed", n_agents=2, n_landmarks=2, agent_size=[0.2, 0.1],
                  agent_accel=[3.0, None], agent_max_speed=[0.4, None],
                  agent_movable=[True, False], landmark_collide=[True, False],
                  landmark_size=0.3, mass=[1.5, 1.0, 2.0, 1.0]),
}


@pytest.mark.parametrize("which", sorted(_PHYSICS_SPECS))
def test_generic_physics_block_matches_jax(which):
    kwargs = _PHYSICS_SPECS[which]
    j_spec, t_spec = j_make_spec(**kwargs), t_make_spec(**kwargs)
    rng = np.random.default_rng(3)
    e, a = t_spec.n_entities, t_spec.n_agents
    pos = rng.uniform(-0.3, 0.3, (e, 2, N))
    pos[1, :, 0] = pos[0, :, 0]                             # an exact overlap
    vel = rng.uniform(-1, 1, (e, 2, N)) * t_spec.movable[:, None, None]
    moves = rng.uniform(size=(a, 5, N))
    j_out = j_kscn.generic_physics_block(j_spec, jnp.asarray(pos), jnp.asarray(vel),
                                         jnp.asarray(moves))
    t_out = t_kscn.generic_physics_block(t_spec, *(torch.as_tensor(x) for x in (pos, vel, moves)))
    for name, x, y in zip(("pos", "vel"), t_out, j_out):
        np.testing.assert_allclose(_np(x), _np(y), rtol=0, atol=1e-12, err_msg=name)
        assert np.isfinite(_np(x)).all()


@pytest.mark.parametrize("salt", [0, 1, 3, -7, 2**31 - 1, -2**31, 123456789])
@pytest.mark.parametrize("shape", [(3, 5, 16), (2, 2, 128), (1, 64)])
def test_hash_uniform_bit_exact(salt, shape):
    j = np.asarray(j_fused._hash_uniform(jnp.int32(salt), shape))
    t = t_fused._hash_uniform(salt, shape).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.float32 and (t >= 0).all() and (t < 1).all()


@pytest.mark.parametrize("salt", [0, 3, -1640531527, 2**31 - 1, 131071 * 9 + 17])
@pytest.mark.parametrize("shape", [(5, 32), (8, 256)])
def test_hash_uniform_2d_bit_exact(salt, shape):
    j = np.asarray(j_parity.hash_uniform_2d(jnp.int32(np.int32(salt)), shape))
    np.testing.assert_array_equal(t_parity.hash_uniform_2d(salt, shape).numpy(), j)


def test_det_moves_bit_exact():
    spec = t_scenarios.load("simple_spread").spec
    for step in (0, 5, 40000):
        j = np.asarray(j_parity.det_moves(j_scenarios.load("simple_spread").spec,
                                          jnp.int32(step), 64))
        np.testing.assert_array_equal(t_parity.det_moves(spec, step, 64).numpy(), j)


@pytest.mark.parametrize("block_offset", [0, 1])
def test_plain_fused_spread_rollout_matches_jax_interpret(block_offset):
    j_spec = j_scenarios.load("simple_spread").spec
    t_spec = t_scenarios.load("simple_spread").spec
    j_run = j_fused.fused_spread_rollout(j_spec, n_envs=256, n_steps=12, horizon=5,
                                         block_envs=128, interpret=True)
    t_run = t_fused.fused_spread_rollout(t_spec, n_envs=256, n_steps=12, horizon=5,
                                         block_envs=128, device="cpu")
    assert (t_run.n_blocks, t_run.block_envs) == (2, 128)
    for name, a, b in zip(("pos", "vel", "rew_sum", "obs_checksum"),
                          t_run(3, block_offset), j_run(3, block_offset)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32_TOL)


def test_plain_fused_rollout_horizon_none_never_resets():
    spec = t_scenarios.load("simple_spread").spec
    pos, vel, _, _ = t_fused.fused_spread_rollout(spec, 64, 6, horizon=None, block_envs=32,
                                                  device="cpu")(0)
    pos0 = t_fused.make_uniform(0, 0, 2, 32)((3, 2), 0, 1) * 2.0 - 1.0
    torch.testing.assert_close(pos[3:], pos0)               # landmarks never resampled
    assert (vel[:3] != 0).any()


DET_NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
             "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
# simple_spread's cases keep their ids
DET_CASES = ([pytest.param("simple_spread", n, id=str(n)) for n in (6, 0)]
             + [pytest.param(name, 6, id=f"6-{name}") for name in DET_NAMES[1:]])


@pytest.mark.parametrize("name, n_steps", DET_CASES)
def test_plain_det_rollout_blocked_matches_jax_interpret(name, n_steps):
    inputs = j_parity.make_det_inputs(name, n_envs=64, seed=11)
    j_out = j_parity.fused_det_rollout(name, 64, n_steps=n_steps, block_envs=32,
                                       interpret=True)(*inputs)
    t_inputs = [torch.tensor(np.asarray(x)) for x in inputs]
    plain = t_parity.plain_det_rollout_blocked(name, n_steps, 32)(*t_inputs)
    wrapped = t_parity.fused_det_rollout(name, 64, n_steps, block_envs=32,
                                         device="cpu")(*t_inputs)
    for label, a, w, b in zip(("pos", "vel", "rew_sum", "rew", "obs"), plain, wrapped, j_out):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=label, **F32_TOL)
        torch.testing.assert_close(w, a, rtol=0, atol=0)
    assert (_np(plain[0]) != _np(t_inputs[0])).any() == (n_steps > 0 and name != "simple_crypto")


def test_make_det_inputs_shapes_and_ranges():
    pos0, vel0, comm0, goal0 = t_parity.make_det_inputs("simple_spread", 128, seed=3,
                                                        device="cpu")
    kscn = t_kscn.kernel_scenario("simple_spread")
    j_shapes = j_parity.det_input_shapes(j_kscn.kernel_scenario("simple_spread"), 128)
    assert t_parity.det_input_shapes(kscn, 128) == j_shapes
    assert [tuple(x.shape) for x in (pos0, vel0, comm0, goal0)] == list(j_shapes)
    assert (pos0.abs() <= 1).all() and (vel0[3:] == 0).all() and (vel0.abs() <= 0.5).all()
    assert goal0.dtype == torch.int32 and comm0.dtype == torch.float32


@pytest.mark.parametrize("n_envs,requested", [(4096, 1024), (256, 1024), (96, 64), (7, 4)])
def test_pick_block_envs_matches_jax(n_envs, requested):
    assert t_fused.pick_block_envs(n_envs, requested) == j_fused.pick_block_envs(n_envs, requested)


def test_cuda_wrappers_refuse_cpu_tensors():
    kscn = t_kscn.kernel_scenario("simple_spread")
    inputs = t_parity.make_det_inputs("simple_spread", 64, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_parity.det_rollout_cuda(kscn, 4, 32, *inputs)
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.rollout_cuda(kscn, 64, 4, 10, 32, 0, device="cpu")


def test_spread_params_takes_simple_spread():
    from mpe_tpu_torch.ops._build import spread_params

    spec = t_scenarios.load("simple_spread").spec
    params = spread_params(t_kscn.KernelSpread(spec))
    assert params.dt == np.float32(spec.dt) and params.keep_vel == np.float32(1 - spec.damping)
    assert list(params.dmin) == [np.float32(0.3)] * 9


@pytest.mark.parametrize("change", ["max_speed", "initial_mass", "collide"])
def test_spread_params_refuses_what_the_kernels_do_not_compute(change):
    """The kernels assume unit masses, no speed limit and colliding agents;
    a spec without them must not reach a kernel that would compute other
    arithmetic than its plain version."""
    from mpe_tpu_torch.ops._build import spread_params

    spec = t_scenarios.load("simple_spread").spec
    value = getattr(spec, change).copy()
    value[0] = {"max_speed": 1.0, "initial_mass": 2.0, "collide": False}[change]
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        spread_params(t_kscn.KernelSpread(dataclasses.replace(spec, **{change: value})))

"""The port's fused trajectory (K3's plain version) and the fused rollout
(K2's) on simple, simple_reference and simple_speaker_listener, against the
JAX kernels run in Pallas interpret mode on the CPU.

Tolerances: actions are raw hash draws, so they are equal bit for bit;
obs, rewards, positions and velocities agree within float32 rtol and atol
1e-5 (CPU libm and XLA's exp/log1p/rsqrt differ by ulps), as in
``tests/test_torch_fused.py``. The CUDA kernels run only on a card:
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold them against these
plain versions there.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from mpe_tpu_torch import scenarios as t_scenarios

j_traj = importlib.import_module("mpe_tpu.ops.fused_trajectory")
j_fused = importlib.import_module("mpe_tpu.ops.fused_rollout")
t_traj = importlib.import_module("mpe_tpu_torch.ops.fused_trajectory")
t_fused = importlib.import_module("mpe_tpu_torch.ops.fused_rollout")
t_kscn = importlib.import_module("mpe_tpu_torch.ops.kernel_scenarios")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
FOUR = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener"]
NEW = FOUR[1:]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("block_offset", [0, 1])
@pytest.mark.parametrize("name", FOUR)
def test_plain_trajectory_matches_jax_interpret(name, block_offset):
    kw = dict(n_envs=256, n_steps=8, horizon=5, block_envs=128, t_chunk=4)
    j_out = j_traj.fused_trajectory(name, interpret=True, **kw)(3, block_offset)
    t_run = t_traj.fused_trajectory(name, device="cpu", **kw)
    assert (t_run.n_blocks, t_run.block_envs) == (2, 128)
    t_out = t_run(3, block_offset)
    for label, a, b in zip(("obs", "act", "rew", "pos", "vel"), t_out, j_out):
        assert a.dtype == torch.float32 and a.shape == b.shape, label
        if label == "act":
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=label)
        else:
            np.testing.assert_allclose(_np(a), _np(b), err_msg=label, **F32_TOL)
    obs, act, _, _, vel = t_out
    if name == "simple_speaker_listener":
        assert (act[:, 1, 5:] == 0).all() and (act[:, 0, 5:] != 0).any()     # the listener is silent
        assert (vel[0] == 0).all() and (obs[:, 0, 3:] == 0).all()            # the speaker never moves
    assert (vel[t_scenarios.load(name).spec.n_agents:] == 0).all()           # landmarks never move


def test_fused_spread_trajectory_is_the_spread_instance():
    spec = t_scenarios.load("simple_spread").spec
    kw = dict(n_envs=64, n_steps=4, horizon=3, block_envs=32, t_chunk=2, device="cpu")
    for a, b in zip(t_traj.fused_spread_trajectory(spec, **kw)(1),
                    t_traj.fused_trajectory("simple_spread", **kw)(1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("horizon", [5, None])
@pytest.mark.parametrize("name", NEW)
def test_plain_rollout_matches_jax_interpret(name, horizon):
    kw = dict(n_envs=256, n_steps=12, horizon=horizon, block_envs=128)
    j_out = j_fused.fused_rollout(name, interpret=True, **kw)(3, 1)
    t_out = t_fused.fused_rollout(name, device="cpu", **kw)(3, 1)
    for label, a, b in zip(("pos", "vel", "rew_sum", "obs_checksum"), t_out, j_out):
        assert a.dtype == torch.float32 and a.shape == b.shape, label
        np.testing.assert_allclose(_np(a), _np(b), err_msg=label, **F32_TOL)


def test_fused_trajectory_refuses_bad_sizes():
    with pytest.raises(ValueError, match="horizon"):
        t_traj.fused_trajectory("simple", 64, 8, horizon=None, block_envs=32, device="cpu")
    with pytest.raises(ValueError, match="multiple of t_chunk"):
        t_traj.fused_trajectory("simple", 64, 10, horizon=5, block_envs=32, t_chunk=4,
                                device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_traj.trajectory_cuda(t_kscn.kernel_scenario("simple"), 64, 8, 5, 32, 4, 0,
                               device="cpu")


@pytest.mark.parametrize("wrapper, name", [("spread_rollout_cuda", "simple_reference"),
                                           ("scenario_rollout_cuda", "simple_spread")])
def test_rollout_wrappers_take_only_their_own_kernel_scenarios(wrapper, name):
    """K2's two wrappers each count the launches of one kernel, so neither
    runs the other's scenarios; ``rollout_cuda`` picks between them."""
    with pytest.raises(ValueError, match="does not run on"):
        getattr(t_fused, wrapper)(t_kscn.kernel_scenario(name), 64, 4, 10, 32, 0,
                                  device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.rollout_cuda(t_kscn.kernel_scenario(name), 64, 4, 10, 32, 0, device="cpu")


@pytest.mark.parametrize("change", ["max_speed", "initial_mass", "collide"])
def test_scenario_params_refuses_what_the_kernels_do_not_compute(change):
    """The block kernels assume unit masses, no speed limit and no collide
    pair; a spec without them must not reach a kernel that would compute
    other arithmetic than its plain version."""
    from mpe_tpu_torch.ops._build import scenario_params

    spec = t_scenarios.load("simple_reference").spec
    value = getattr(spec, change).copy()
    if change == "collide":
        value[:2] = True                                    # the two agents collide
    else:
        value[0] = {"max_speed": 1.0, "initial_mass": 2.0}[change]
    kscn = t_kscn.KernelReference(dataclasses.replace(spec, **{change: value}))
    with pytest.raises(NotImplementedError, match="as published only"):
        scenario_params(kscn)


@pytest.mark.parametrize("name", NEW)
def test_scenario_params_takes_the_published_scenarios(name):
    from mpe_tpu_torch.ops._build import SCENARIO_IDS, kernel_params

    kscn = t_kscn.kernel_scenario(name)
    scenario, params = kernel_params(kscn)
    spec = kscn.spec
    assert scenario == SCENARIO_IDS[type(kscn).__name__]
    assert params.dt == np.float32(spec.dt) and params.keep_vel == np.float32(1 - spec.damping)
    assert list(params.movable) == spec.movable[:spec.n_agents].astype(int).tolist()
    assert list(params.silent) == spec.silent.astype(int).tolist()

"""The port's fused trajectory (K3's plain version) on the nine scenarios and
the fused rollout (K2's) on the eight other than simple_spread, against the
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
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

j_traj = importlib.import_module("mpe_tpu.ops.fused_trajectory")
j_fused = importlib.import_module("mpe_tpu.ops.fused_rollout")
t_traj = importlib.import_module("mpe_tpu_torch.ops.fused_trajectory")
t_fused = importlib.import_module("mpe_tpu_torch.ops.fused_rollout")
t_kscn = importlib.import_module("mpe_tpu_torch.ops.kernel_scenarios")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
ALL = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
       "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
NEW = ALL[1:]
PAIR_LIMITED = ("simple_tag", "simple_world_comm")     # the pair physics, speed limits


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("block_offset", [0, 1])
@pytest.mark.parametrize("name", ALL)
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
    spec = t_scenarios.load(name).spec
    if name == "simple_speaker_listener":
        assert (act[:, 1, 5:] == 0).all() and (act[:, 0, 5:] != 0).any()     # the listener is silent
        assert (vel[0] == 0).all() and (obs[:, 0, 3:] == 0).all()            # the speaker never moves
    if name == "simple_world_comm":
        assert (act[:, 1:, 5:] == 0).all() and (act[:, 0, 5:] != 0).all()    # only the leader speaks
    assert (vel[~torch.from_numpy(spec.movable.copy())] == 0).all()          # immovable entities stay


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
        tol = F32_TOL
        if label == "obs_checksum" and name in PAIR_LIMITED:
            # the checksum adds A x OW obs entries per step (tag 64, world_comm
            # 204), each within ulps of JAX's, and they cancel: it is held
            # within 1e-5 of the largest checksum
            tol = dict(rtol=0, atol=1e-5 * float(np.abs(_np(b)).max()))
        np.testing.assert_allclose(_np(a), _np(b), err_msg=label, **tol)


def test_fused_trajectory_refuses_bad_sizes():
    with pytest.raises(ValueError, match="horizon"):
        t_traj.fused_trajectory("simple", 64, 8, horizon=None, block_envs=32, device="cpu")
    with pytest.raises(ValueError, match="multiple of t_chunk"):
        t_traj.fused_trajectory("simple", 64, 10, horizon=5, block_envs=32, t_chunk=4,
                                device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_traj.trajectory_cuda(t_kscn.kernel_scenario("simple"), 64, 8, 5, 32, 4, 0,
                               device="cpu")


def test_fused_trajectory_makes_the_kernel_constants_once_per_builder(monkeypatch):
    """On a CUDA device the builder fills K3's constant struct
    (``_build.kernel_params``) once and hands the same one to every launch:
    the launch and the device are stood in for, so this runs without a
    card."""
    from mpe_tpu_torch.ops import _build

    made, launched = [], []

    def kernel_params(kscn):
        made.append(kscn.spec.name)
        return _build.SCENARIO_IDS[type(kscn).__name__], object()

    monkeypatch.setattr(_build, "kernel_params", kernel_params)
    monkeypatch.setattr(t_traj, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(t_traj, "trajectory_cuda",
                        lambda *args, consts=None, **kw: launched.append(consts))
    run = t_traj.fused_trajectory("simple_world_comm", 64, 8, horizon=5, block_envs=32)
    for seed in range(3):
        run(seed)
    assert made == ["simple_world_comm"]
    assert len(launched) == 3 and all(c is launched[0] for c in launched)
    assert launched[0][0] == _build.SCENARIO_IDS["KernelWorldComm"]


def test_trajectory_cuda_refuses_bad_groups_before_any_launch():
    """A group outside ``GROUPS`` raises before the library is touched."""
    kscn = t_kscn.kernel_scenario("simple_spread")
    before = t_traj.trajectory_cuda.launches
    for group in (0, 3, 16):
        with pytest.raises(ValueError, match="threads per env lane"):
            t_traj.trajectory_cuda(kscn, 64, 8, 5, 32, 4, 0, device=torch.device("cuda"),
                                   group=group)
    assert t_traj.trajectory_cuda.launches == before


@pytest.mark.parametrize("case", ["cpu_device", "uninstantiated_spec"])
def test_rollout_cuda_refuses_what_no_kernel_runs(case):
    """K2 is one kernel template with one C entry: ``rollout_cuda`` launches it
    for every instantiated scenario on a CUDA device and refuses anything
    else before it launches."""
    if case == "cpu_device":
        kscn, err, match = t_kscn.kernel_scenario("simple_tag"), ValueError, "CUDA"
    else:
        spec = t_scenarios.load("simple_tag").spec
        flat = t_kscn.KernelTag(dataclasses.replace(spec, collide=spec.collide & spec.movable))
        kscn, err, match = flat, NotImplementedError, "as published only"
    with pytest.raises(err, match=match):
        t_fused.rollout_cuda(kscn, 64, 4, 10, 32, 0, device="cpu")


@pytest.mark.parametrize("change", ["collide_pairs", "movable_landmark", "dim_p"])
def test_scenario_params_refuses_what_the_kernels_do_not_compute(change):
    """Each instantiation computes its scenario's compiled collide pairs, fixed
    landmarks and two dimensions; another spec must not reach a kernel that
    would compute other arithmetic than its plain version."""
    from mpe_tpu_torch.ops._build import scenario_params

    spec = t_scenarios.load("simple_world_comm").spec
    a = spec.n_agents
    if change == "collide_pairs":
        collide = spec.collide.copy()
        collide[a + 1] = True                               # food 0 becomes an obstacle
        spec = dataclasses.replace(spec, collide=collide)
    elif change == "movable_landmark":
        movable = spec.movable.copy()
        movable[a] = True                                   # the obstacle moves
        spec = dataclasses.replace(spec, movable=movable)
    else:
        spec = dataclasses.replace(spec, dim_p=3)
    with pytest.raises(NotImplementedError, match="as published only"):
        scenario_params(t_kscn.KernelWorldComm(spec))


@pytest.mark.parametrize("name", NEW)
def test_scenario_params_takes_the_published_scenarios(name):
    from mpe_tpu_torch.ops._build import SCENARIO_IDS, kernel_params

    kscn = t_kscn.kernel_scenario(name)
    scenario, params = kernel_params(kscn)
    spec = kscn.spec
    a = spec.n_agents
    assert scenario == SCENARIO_IDS[type(kscn).__name__]
    assert params.dt == np.float32(spec.dt) and params.keep_vel == np.float32(1 - spec.damping)
    assert list(params.movable) == spec.movable[:a].astype(int).tolist()
    assert list(params.silent) == spec.silent.astype(int).tolist()
    pairs = t_kscn.collide_pairs(spec)
    assert list(params.dmin)[:len(pairs)] == [np.float32(spec.size[i] + spec.size[j])
                                              for i, j in pairs]
    ms = spec.max_speed[:a].astype(np.float32)
    assert list(params.max_speed2) == (ms * ms).tolist()         # squared in float32
    assert list(params.inv_mass_dt) == (spec.dt / spec.initial_mass[:a]).astype(np.float32).tolist()

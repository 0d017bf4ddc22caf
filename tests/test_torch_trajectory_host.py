"""K3 (``csrc/mpe_trajectory.cu::trajectory_kernel<S, G>``) compiled for the
host (``tests/_csrc_host.py``), with an env lane split over G = 2, 4 and 8
threads, held to one thread per lane bit for bit on all nine scenarios: the
obs, actions, rewards and final state do not depend on G (the group
functions of ``scenario_blocks.cuh`` bring every draw and force back in the
per-lane order). ``test_torch_csrc_host.py`` holds the rule's G to the plain
version. 60 envs in two RNG blocks (two CTAs of 32 lanes, the second ragged),
24 steps in chunks of 4 with resets at horizon 10, at block offsets 0 and 1.
"""

import ctypes

import pytest
import torch

from mpe_tpu_torch.ops import _build
from mpe_tpu_torch.ops.fused_trajectory import GROUPS, TRAJ_GROUP, TRAJ_WIDE_ENVS, traj_group
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
         "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
N_ENVS, BLOCK_ENVS, N_STEPS, T_CHUNK, HORIZON = 60, 30, 24, 4, 10
LABELS = ("obs", "act", "rew", "pos", "vel")


@pytest.fixture(scope="module")
def lib():
    return build_host_libs(("mpe_trajectory.cu",))["mpe_trajectory.cu"]


def _outputs(kscn, fill=float("nan")):
    spec = kscn.spec
    shapes = ((N_STEPS, spec.n_agents, kscn.obs_w, N_ENVS),
              (N_STEPS, spec.n_agents, kscn.n_logits, N_ENVS),
              (N_STEPS, kscn.reward_rows, N_ENVS)) + ((spec.n_entities, 2, N_ENVS),) * 2
    return [torch.full(s, fill) for s in shapes]


def _host_traj(lib, kscn, block_offset, group):
    """K3 (``mpe_trajectory``) at ``group`` threads per lane, seed 5 -> (rc,
    [obs, act, rew, pos, vel])."""
    scenario, params = _build.kernel_params(kscn)
    got = _outputs(kscn)
    rc = lib.mpe_trajectory(scenario, ctypes.byref(params), *(x.data_ptr() for x in got), N_ENVS,
                            BLOCK_ENVS, N_STEPS // T_CHUNK, T_CHUNK, HORIZON, 5, block_offset,
                            group, None)
    return rc, got


_ONE = {}                              # (scenario, block offset) -> K3 at G = 1


def _one_thread_per_lane(lib, name, block_offset):
    if (name, block_offset) not in _ONE:
        rc, out = _host_traj(lib, kernel_scenario(name), block_offset, 1)
        assert rc == 0
        _ONE[name, block_offset] = out
    return _ONE[name, block_offset]


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_host_built_grouped_trajectory_equals_one_thread_per_lane(lib, name, group):
    """Every output of K3 at ``group`` threads per lane equals K3 at one
    thread per lane bit for bit, at block offsets 0 and 1; every element is
    written."""
    kscn = kernel_scenario(name)
    for block_offset in (0, 1):
        one = _one_thread_per_lane(lib, name, block_offset)
        rc, split = _host_traj(lib, kscn, block_offset, group)
        assert rc == 0
        for label, a, b in zip(LABELS, split, one):
            assert not a.isnan().any(), f"{label}: an element was not written"
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"{label} at block offset {block_offset}, G {group}")


def test_host_built_trajectory_entry_refuses_bad_groups(lib):
    """The C entry returns an error and writes nothing for a group outside
    1, 2, 4, 8 (0, 3, 16)."""
    kscn = kernel_scenario("simple_spread")
    for group in (0, 3, 16):
        rc, got = _host_traj(lib, kscn, 0, group)
        assert rc != 0, group
        assert all(x.isnan().all() for x in got)


def test_traj_group_rule():
    """``traj_group``: the swept G of each scenario below ``TRAJ_WIDE_ENVS``
    envs, one thread per lane from there up; every value one the kernel
    takes."""
    swept = {"simple_spread": 4, "simple": 1, "simple_reference": 2,
             "simple_speaker_listener": 1, "simple_adversary": 1, "simple_push": 1,
             "simple_crypto": 1, "simple_tag": 4, "simple_world_comm": 4}
    assert TRAJ_GROUP == swept
    for name in NAMES:
        kscn = kernel_scenario(name)
        assert traj_group(kscn, 4096) == swept[name]
        assert traj_group(kscn, TRAJ_WIDE_ENVS) == 1
        assert traj_group(kscn, 65_536) == 1
        assert TRAJ_GROUP[name] in GROUPS

"""The lane-tile kernels K4, K5 (``csrc/mpe_policy.cu``) and K8
(``csrc/mpe_maddpg.cu``) compiled for the host (``tests/_csrc_host.py``) at
several tile sizes, ragged grids among them: each held to its plain version
with actions equal (values within float32 tolerances, the host's libm), and
every tile size equal to the others bit for bit. The kernels run a CTA of 128
threads whatever the tile, so each case stays small: 60 envs in two RNG
blocks, a dozen steps with resets.
"""

import ctypes

import pytest
import torch

from mpe_tpu_torch.learner import init_policy
from mpe_tpu_torch.learner.maddpg import init_maddpg
from mpe_tpu_torch.ops import _build, fused_maddpg
from mpe_tpu_torch.ops.fused_policy import (_kernel_weights, _pack_weights, plain_policy_rollout,
                                            plain_policy_trajectory)
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
         "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
N_ENVS, BLOCK_ENVS = 60, 30            # not a multiple of 8, 16 or 32: ragged last tiles
F32_TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = ("act", "cact", "episodes")


@pytest.fixture(scope="module")
def host_libs():
    return build_host_libs(("mpe_policy.cu", "mpe_maddpg.cu"))


def _hold(label, runs, ref):
    """Every tile's outputs against the plain version's (the labels in EXACT
    exactly) and against the first tile's bit for bit."""
    tiles = list(runs)
    for k, want in zip(label, ref):
        for tile in tiles:
            tol = dict(rtol=0, atol=0) if k in EXACT else F32_TOL
            torch.testing.assert_close(runs[tile][k], want, msg=f"{k} at tile {tile}", **tol)
            torch.testing.assert_close(runs[tile][k], runs[tiles[0]][k], rtol=0, atol=0,
                                       msg=f"{k} at tile {tile} against tile {tiles[0]}")


def _policy_weights(kscn, seed, hidden=64):
    return _kernel_weights(init_policy(torch.Generator().manual_seed(seed), kscn.obs_w,
                                       kscn.n_logits, hidden))


@pytest.mark.parametrize("name", NAMES)
def test_host_built_policy_traj_kernel_at_two_tiles(host_libs, name):
    """K5 over 12 steps in chunks of 4, horizon 5, block offset 1, at tiles 2
    and 16 (the last tile of 16 holds 12 lanes)."""
    _check_policy_traj(host_libs["mpe_policy.cu"], kernel_scenario(name), (2, 16))


def _check_policy_traj(lib, kscn, tiles, hidden=64):
    """K5 of a library built at ``hidden`` at each of ``tiles``, held as
    above."""
    scenario, params = _build.kernel_params(kscn)
    weights = _policy_weights(kscn, 2, hidden)
    wbuf = _pack_weights(weights)                      # held until the calls return
    a, n, n_steps, t_chunk = kscn.spec.n_agents, N_ENVS, 12, 4
    label = ("obs", "act", "cact", "rew", "last_obs") if kscn.uses_comm else (
        "obs", "act", "rew", "last_obs")
    runs = {}
    for tile in tiles:
        out = {"obs": torch.empty((n_steps, a, kscn.obs_w, n)),
               "act": torch.empty((n_steps, a, n), dtype=torch.int32),
               "cact": torch.empty((n_steps, a, n), dtype=torch.int32),
               "rew": torch.empty((n_steps, kscn.reward_rows, n)),
               "last_obs": torch.empty((a, kscn.obs_w, n))}
        rc = lib.mpe_policy_traj(
            scenario, ctypes.byref(params), wbuf.data_ptr(), out["obs"].data_ptr(),
            out["act"].data_ptr(), out["cact"].data_ptr() if kscn.uses_comm else None,
            out["rew"].data_ptr(), out["last_obs"].data_ptr(), n, BLOCK_ENVS,
            n_steps // t_chunk, t_chunk, 5, 3, 1, tile, None)
        assert rc == 0
        runs[tile] = out
    ref = plain_policy_trajectory(kscn, weights, n, n_steps, 5, BLOCK_ENVS, t_chunk, 3, 1, "cpu")
    _hold(label, runs, ref)


@pytest.mark.parametrize("name", NAMES)
def test_host_built_policy_rollout_kernel_at_two_tiles(host_libs, name):
    """K4 over 14 steps, horizon 6, block offset 1, at tiles 4 and 32 (the
    last tile of 32 holds 28 lanes): returns, final positions, episodes."""
    _check_policy_rollout(host_libs["mpe_policy.cu"], kernel_scenario(name), (4, 32))


def _check_policy_rollout(lib, kscn, tiles, hidden=64):
    """K4 of a library built at ``hidden`` at each of ``tiles``, held as
    above."""
    scenario, params = _build.kernel_params(kscn)
    weights = _policy_weights(kscn, 3, hidden)
    wbuf = _pack_weights(weights)
    n = N_ENVS
    runs = {}
    for tile in tiles:
        out = {"ret": torch.empty((kscn.reward_rows, n)),
               "pos": torch.empty((kscn.spec.n_entities, 2, n)), "episodes": torch.empty((1, n))}
        rc = lib.mpe_policy_rollout(
            scenario, ctypes.byref(params), wbuf.data_ptr(), *(x.data_ptr() for x in out.values()),
            n, BLOCK_ENVS, 14, 6, 8, 1, tile, None)
        assert rc == 0
        runs[tile] = out
    ref = plain_policy_rollout(kscn, weights, n, 14, 6, BLOCK_ENVS, 8, 1, "cpu")
    _hold(("ret", "pos", "episodes"), runs, ref)


@pytest.mark.parametrize("name", NAMES)
def test_host_built_maddpg_traj_kernel_at_two_tiles(host_libs, name):
    """K8 over 10 steps in chunks of 5, horizon 5, eps 0.1, block offset 1,
    at tiles 1 and 8 (the last tile of 8 holds 4 lanes), both output forms;
    the rows form equal to the tensor form's rows bit for bit."""
    _check_maddpg_traj(host_libs["mpe_maddpg.cu"], kernel_scenario(name), (1, 8))


def _check_maddpg_traj(lib, kscn, tiles, hidden=64):
    """K8 of a library built at ``hidden`` at each of ``tiles``, held as
    above."""
    scenario, params = _build.kernel_params(kscn)
    a, ow, aw, n = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits, N_ENVS
    n_steps, t_chunk, eps = 10, 5, 0.1
    actor = init_maddpg(torch.Generator().manual_seed(4), ow, aw, a, hidden)["actor"]
    actor["out"]["w"] = actor["out"]["w"] * 100.0      # O(1) logits
    weights = fused_maddpg._kernel_weights(actor)
    wbuf = fused_maddpg._pack_weights(weights)
    runs = {}
    for tile in tiles:
        out = {"obs": torch.empty((n_steps, a, ow, n)), "act": torch.empty((n_steps, a, aw, n)),
               "rew": torch.empty((n_steps, kscn.reward_rows, n)),
               "obs2": torch.empty((n_steps, a, ow, n)),
               "rows": torch.empty((n_steps, n, a * (2 * ow + aw + 1)))}
        for ptrs in ([out[k].data_ptr() for k in ("obs", "act", "rew", "obs2")] + [None],
                     [None] * 4 + [out["rows"].data_ptr()]):
            rc = lib.mpe_maddpg_traj(scenario, ctypes.byref(params), wbuf.data_ptr(), *ptrs, n,
                                     BLOCK_ENVS, n_steps // t_chunk, t_chunk, 5, eps, 3, 1, tile,
                                     None)
            assert rc == 0
        runs[tile] = out
    args = (n, n_steps, 5, BLOCK_ENVS, t_chunk, eps, 3, 1)
    ref = fused_maddpg.plain_maddpg_trajectory(kscn, weights, *args, device="cpu")
    _hold(("obs", "act", "rew", "obs2"), runs, ref)
    for tile, out in runs.items():
        rows = torch.stack([fused_maddpg._rows(kscn, *(out[k][t] for k in ("obs", "act", "rew",
                                                                           "obs2")))
                            for t in range(n_steps)])
        torch.testing.assert_close(out["rows"], rows, rtol=0, atol=0, msg=f"rows at tile {tile}")
    assert len(torch.unique(runs[tiles[0]]["act"][:, :, :5].argmax(2))) == 5  # the actions vary


def test_host_built_tile_kernels_refuse_bad_tiles(host_libs):
    """The C entries return an error, and launch nothing, for a tile of 0
    lanes or above 32, and K8 for a tile whose shared memory does not fit
    (simple_world_comm's six actors beside 16 lanes' rows)."""
    kscn = kernel_scenario("simple_world_comm")
    scenario, params = _build.kernel_params(kscn)
    wbuf = torch.zeros(fused_maddpg._pack_weights(
        fused_maddpg._kernel_weights(init_maddpg(torch.Generator().manual_seed(0), kscn.obs_w,
                                                 kscn.n_logits, 6)["actor"])).numel())
    out = torch.full((4096,), -7.0)
    lib_p, lib_m = host_libs["mpe_policy.cu"], host_libs["mpe_maddpg.cu"]
    for tile in (0, 33):
        assert lib_p.mpe_policy_rollout(scenario, ctypes.byref(params), wbuf.data_ptr(),
                                        *[out.data_ptr()] * 3, 8, 8, 2, 5, 0, 0, tile, None) != 0
    for tile in (0, 16):
        assert lib_m.mpe_maddpg_traj(scenario, ctypes.byref(params), wbuf.data_ptr(),
                                     *[None] * 4, out.data_ptr(), 8, 8, 1, 2, 5, 0.1, 0, 0, tile,
                                     None) != 0
    assert bool((out == -7.0).all())


def test_host_built_ctas_per_sm_entries(host_libs):
    """``mpe_policy_ctas_per_sm`` and ``mpe_maddpg_traj_ctas_per_sm``, which
    the tile rule reads: 0 for a tile the kernels do not take (0, 33, and
    K8's 16 on simple_world_comm), else the occupancy query's answer (1 on
    the host, which runs one block at a time)."""
    lib_p, lib_m = host_libs["mpe_policy.cu"], host_libs["mpe_maddpg.cu"]
    for name in ("simple_spread", "simple_world_comm"):
        scenario = _build.SCENARIO_IDS[type(kernel_scenario(name)).__name__]
        for kernel in (0, 1):
            assert [lib_p.mpe_policy_ctas_per_sm(scenario, kernel, t) for t in (0, 1, 32, 33)] \
                == [0, 1, 1, 0]
        want = [0, 1, 1, 0 if name == "simple_world_comm" else 1]
        assert [lib_m.mpe_maddpg_traj_ctas_per_sm(scenario, t) for t in (0, 1, 8, 16)] == want

"""The port's policy-in-the-loop rollouts (plain versions of kernels K4 and
K5) against the JAX package on the CPU, on all nine scenarios.

- ``make_uniform`` with the chunk salt: bit for bit against the JAX
  kernels' interpret-mode stream, drawn inside a Pallas interpret call;
- ``_argmax_onehot``: equal to JAX's on tie cases;
- the plain trajectory and evaluation rollouts against
  ``fused_policy_trajectory`` / ``fused_policy_rollout`` in Pallas interpret
  mode, from the same weights (an init_policy MLP of the scenario's obs
  width and 5 + dim_c outputs): moves, comm indices and episode counts
  equal, float32 values at atol and rtol 1e-5 (XLA's dot sums in its own
  order and CPU libm differs from XLA's tanh/log by ulps);
- the committed fused-MAPPO actor of simple_speaker_listener
  (``checkpoints/mappo_speaker_listener_fused.npz``) evaluated by both.

The CUDA kernels run only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mpe_tpu.learner import init_policy as j_init_policy
from mpe_tpu.ops.kernel_scenarios import kernel_scenario as j_kernel_scenario
from mpe_tpu_torch.convert import params_from_numpy, read_checkpoint_params

j_fused = importlib.import_module("mpe_tpu.ops.fused_rollout")
j_policy = importlib.import_module("mpe_tpu.ops.fused_policy")
t_fused = importlib.import_module("mpe_tpu_torch.ops.fused_rollout")
t_policy = importlib.import_module("mpe_tpu_torch.ops.fused_policy")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(n_envs=128, n_steps=16, horizon=6, block_envs=64)
NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
         "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
CKPT = "checkpoints/mappo_speaker_listener_fused.npz"


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _params(hidden=16, seed=0, name="simple_spread"):
    """JAX init_policy params of the scenario's widths (obs width -> 5 +
    dim_c) as numpy, and the same weights in the port."""
    kscn = j_kernel_scenario(name)
    k = 5 + (kscn.spec.dim_c if kscn.uses_comm else 0)
    tree = jax.tree.map(np.asarray, j_init_policy(jax.random.PRNGKey(seed), kscn.obs_w, k,
                                                  hidden=hidden))
    return tree, params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("seed,block_offset", [(3, 0), (-5, 2), (2**31 - 1, 1)])
def test_make_uniform_chunk_salt_bit_exact(seed, block_offset):
    """Draws of JAX's ``make_uniform(seed_ref, True, program_id(1))`` on a
    (block, chunk) grid, against the port's stream with the chunk as extra
    salt."""
    n, n_blocks, n_chunks, step, call = 32, 2, 3, 5, 7

    def kernel(seed_ref, out_ref):
        uniform, _ = j_fused.make_uniform(seed_ref, True, pl.program_id(1))
        out_ref[0] = uniform((5, 3 * n), step, call)

    call_ = pl.pallas_call(
        kernel, grid=(n_blocks, n_chunks),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, 5, 3 * n), lambda i, j: (j, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_chunks, 5, 3 * n * n_blocks), jnp.float32),
        interpret=True)
    want = np.asarray(call_(jnp.asarray([seed, block_offset], jnp.int32)))
    for chunk in range(n_chunks):
        u = t_fused.make_uniform(seed, block_offset, n_blocks, n, chunk)((5, 3), step, call)
        # the port lays lanes of all blocks last: [5, 3, blocks * n]; JAX [5, blocks * (3n)]
        got = u.reshape(5, 3, n_blocks, n).permute(0, 2, 1, 3).reshape(5, -1)
        np.testing.assert_array_equal(got.numpy(), want[chunk])


def test_make_uniform_without_extra_salt_is_unchanged():
    u0 = t_fused.make_uniform(9, 1, 2, 16)((3, 2), 4, 2)
    u1 = t_fused.make_uniform(9, 1, 2, 16, 0)((3, 2), 4, 2)
    torch.testing.assert_close(u0, u1, rtol=0, atol=0)


@pytest.mark.parametrize("z", [
    [[1.0, 2.0, 0.5], [1.0, 2.0, 0.5], [0.0, 2.0, 0.4]],       # ties in the first rows
    [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],       # all tied: row 0
    [[-1.0, 3.0, 7.0], [2.0, 3.0, 1.0], [2.0, -3.0, 7.0]],     # tie between rows 1 and 2
])
def test_argmax_onehot_first_max_tie_break(z):
    z = np.asarray(z, np.float32)
    want = np.asarray(j_policy._argmax_onehot(jnp.asarray(z)))
    got = t_policy._argmax_onehot(torch.tensor(z)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(0) == 1).all()


# hidden 16 on all nine, and the other widths the kernels are compiled for
# (8, 32) on simple_spread and a comm head
WIDTH_CASES = ([pytest.param(name, 16, id=name) for name in NAMES]
               + [pytest.param(name, h, id=f"{name}-hidden{h}") for h in (8, 32)
                  for name in ("simple_spread", "simple_speaker_listener")])


@pytest.mark.parametrize("scenario, hidden", WIDTH_CASES)
def test_plain_policy_trajectory_matches_jax_interpret(scenario, hidden):
    tree, params = _params(hidden=hidden, name=scenario)
    kscn = j_kernel_scenario(scenario)
    a, ow = kscn.spec.n_agents, kscn.obs_w
    j_run = j_policy.fused_policy_trajectory(scenario, tree, t_chunk=4, interpret=True, **SMALL)
    t_run = t_policy.fused_policy_trajectory(scenario, params, t_chunk=4, device="cpu", **SMALL)
    assert t_run.has_comm == j_run.has_comm == kscn.uses_comm
    for block_offset in (0, 3):
        want = j_run(11, tree, block_offset)
        got = t_run(11, params, block_offset)
        assert len(got) == len(want) == (5 if kscn.uses_comm else 4)
        obs, act, *cact, rew, last_obs = got
        assert obs.shape == (16, a, ow, 128) and act.dtype == torch.int32
        for k, x, y in zip(("act", "cact"), [act] + cact, [want[1]] + list(want[2:-2])):
            assert x.dtype == torch.int32, k
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=k)
        for k, x, y in zip(("obs", "rew", "last_obs"), (obs, rew, last_obs),
                           (want[0], want[-2], want[-1])):
            assert x.dtype == torch.float32 and tuple(x.shape) == y.shape, k
            np.testing.assert_allclose(_np(x), _np(y), err_msg=k, **F32_TOL)
    if cact:                   # the speakers' utterances vary; silent agents' are 0
        speak = ~kscn.spec.silent[:a]
        assert len(np.unique(_np(cact[0])[:, speak])) == kscn.spec.dim_c
        assert (_np(cact[0])[:, ~speak] == 0).all()
    if scenario == "simple_spread":
        # horizon 6 over 16 steps: the obs after each reset has zero velocity
        assert np.abs(_np(obs)[6, :, 0:2]).max() == 0.0 and np.abs(_np(obs)[5, :, 0:2]).max() > 0


@pytest.mark.parametrize("scenario, hidden", WIDTH_CASES)
def test_plain_policy_rollout_matches_jax_interpret(scenario, hidden):
    tree, params = _params(hidden=hidden, seed=1, name=scenario)
    j_run = j_policy.fused_policy_rollout(scenario, tree, interpret=True, **SMALL)
    t_run = t_policy.fused_policy_rollout(scenario, params, device="cpu", **SMALL)
    for block_offset in (0, 1):
        want = j_run(4, tree, block_offset)
        ret, pos, eps = t_run(4, params, block_offset)
        np.testing.assert_array_equal(_np(eps), _np(want[2]))
        assert float(eps[0, 0]) == 16 // 6
        assert ret.shape == (j_kernel_scenario(scenario).reward_rows, 128)
        for name, a, b in zip(("ret", "pos"), (ret, pos), want[:2]):
            np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32_TOL)


def test_committed_speaker_listener_actor_matches_jax():
    """The fused-MAPPO actor of the README's comm result (a1, a2, pi of
    checkpoints/mappo_speaker_listener_fused.npz, 11-64-64-8), evaluated by
    the plain K4 and by JAX's in interpret mode: returns and positions."""
    tree = read_checkpoint_params(CKPT)
    actor = {"l1": tree["a1"], "l2": tree["a2"], "out": tree["pi"]}
    kw = dict(n_envs=64, n_steps=50, horizon=25, block_envs=32)
    want = j_policy.fused_policy_rollout("simple_speaker_listener", actor, interpret=True,
                                         **kw)(2, actor)
    t_actor = params_from_numpy(actor, device="cpu")
    ret, pos, eps = t_policy.fused_policy_rollout("simple_speaker_listener", t_actor, device="cpu",
                                                  **kw)(2, t_actor)
    np.testing.assert_array_equal(_np(eps), _np(want[2]))
    for name, a, b in zip(("ret", "pos"), (ret, pos), want[:2]):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **F32_TOL)


def test_policy_trajectory_samples_from_a_hard_biased_head():
    """A head biased hard toward action 2 emits only action 2 (MLP ->
    Gumbel-max -> index, end to end), as in the JAX package's test."""
    tree, _ = _params(hidden=32)
    tree = jax.tree.map(np.zeros_like, tree)
    tree["out"]["b"] = np.asarray([-30.0, -30.0, 30.0, -30.0, -30.0], np.float32)
    params = params_from_numpy(tree, device="cpu")
    run = t_policy.fused_policy_trajectory("simple_spread", params, n_envs=64, n_steps=8,
                                           horizon=100, block_envs=64, t_chunk=4, device="cpu")
    _, act, _, _ = run(0, params)
    assert (act == 2).all()


def test_policy_builders_refuse_what_they_do_not_compute():
    tree, params = _params()
    with pytest.raises(ValueError, match="multiple of t_chunk"):
        t_policy.fused_policy_trajectory("simple_spread", params, 64, 10, t_chunk=4,
                                         device="cpu")
    bad = params_from_numpy({**tree, "out": {"w": np.zeros((16, 7), np.float32),
                                            "b": np.zeros(7, np.float32)}}, device="cpu")
    with pytest.raises(ValueError, match="needs 18 -> 5"):
        t_policy.fused_policy_rollout("simple_spread", bad, 64, 10, device="cpu")
    # a comm scenario needs its comm logits: simple_reference takes 21 -> 15
    with pytest.raises(ValueError, match="needs 21 -> 15"):
        t_policy.fused_policy_trajectory("simple_reference", _params(name="simple_spread")[1], 64,
                                         8, t_chunk=4, device="cpu")
    # the kernels take the hidden widths they are compiled for, and the
    # scenario's widths
    weights = t_policy._kernel_weights(_params(hidden=48)[1])
    with pytest.raises(NotImplementedError, match=re.escape(
            "(csrc/mpe_policy.cu) are compiled for hidden widths 8, 16, 32, 64, 128, 256; "
            "got 48")):
        t_policy._kernel_args(t_policy._resolve("simple_spread"), weights, 64, 8, 4, 64,
                              torch.device("cuda"))
    wide = t_policy._kernel_weights(_params(hidden=64, name="simple_reference")[1])
    with pytest.raises(ValueError, match="takes an 18-64-64-5 MLP"):
        t_policy._kernel_args(t_policy._resolve("simple_spread"), wide, 64, 8, 4, 64,
                              torch.device("cuda"))


def test_policy_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    _, params = _params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_policy.fused_policy_trajectory("simple_spread", params, 64, 8, t_chunk=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_policy.fused_policy_rollout("simple_spread", params, 64, 8)


@pytest.mark.parametrize("change", ["max_speed", "initial_mass", "collide"])
def test_policy_kernel_wrappers_refuse_other_specs(change):
    """The policy kernels compute simple_spread's physics only; another spec
    is refused before any launch (the check runs without a card)."""
    import dataclasses

    from mpe_tpu_torch.ops.kernel_scenarios import KernelSpread

    spec = t_policy._resolve("simple_spread").spec
    value = getattr(spec, change).copy()
    value[0] = {"max_speed": 1.0, "initial_mass": 2.0, "collide": False}[change]
    kscn = KernelSpread(dataclasses.replace(spec, **{change: value}))
    params = params_from_numpy(jax.tree.map(np.asarray, j_init_policy(jax.random.PRNGKey(0), 18,
                                                                      5)), device="cpu")
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        t_policy._kernel_args(kscn, t_policy._kernel_weights(params), 64, 8, 4, 64,
                              torch.device("cuda"))


def test_pick_tile_rule():
    """The tile rule of K4, K5 and K8 (``fused_policy.pick_tile``) on given
    occupancies: the smallest tile whose grid runs in one wave and whose rows
    fill a warp's items, else the largest tile that fits."""
    from mpe_tpu_torch.ops.fused_maddpg import MADDPG_TILES

    tiles = t_policy.POLICY_TILES
    # three agents at 4096 envs, 5 CTAs per SM: 512 CTAs of 8 lanes run at once
    assert t_policy.pick_tile(tiles, 3, 4096, lambda t: 5, 132) == 8
    # six agents whose CTAs of 8 lanes fit 3 to an SM, of 16 lanes 2
    occ = {1: 4, 2: 4, 4: 3, 8: 3, 16: 2, 32: 1}
    assert t_policy.pick_tile(tiles, 6, 4096, occ.get, 132) == 16
    # one agent: a tile's rows fill a warp's items from 8 lanes on
    assert t_policy.pick_tile(tiles, 1, 64, lambda t: 8, 132) == 8
    # nowhere one wave: the largest tile; a tile that does not fit is skipped
    assert t_policy.pick_tile(tiles, 3, 10 ** 6, lambda t: 1, 132) == 32
    assert t_policy.pick_tile(MADDPG_TILES, 6, 10 ** 6, {1: 1, 2: 1, 4: 1, 8: 0}.get, 132) == 4
    # narrower MLPs have fewer items per row: at hidden 16 three agents need
    # 32 rows (tile 16) to fill a warp's items, at hidden 8 64 rows (tile 32)
    assert t_policy.pick_tile(tiles, 3, 4096, lambda t: 5, 132, hidden=32) == 8
    assert t_policy.pick_tile(tiles, 3, 4096, lambda t: 5, 132, hidden=16) == 16
    assert t_policy.pick_tile(tiles, 3, 4096, lambda t: 5, 132, hidden=8) == 32


def test_policy_kernel_wrappers_refuse_uncompiled_widths_before_any_launch():
    """K4's, K5's and K8's wrappers take the hidden width from the weights
    and raise for a width their source is not compiled for (48; K8 also at
    128, which K4 and K5 take), naming that source's widths, before they look
    at the device (so here, without a card)."""
    from mpe_tpu_torch.learner.maddpg import init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg

    kscn = t_policy._resolve("simple_spread")
    weights = t_policy._kernel_weights(_params(hidden=48)[1])
    before = (t_policy.policy_traj_cuda.launches, t_policy.policy_rollout_cuda.launches,
              fused_maddpg.maddpg_traj_cuda.launches)
    named = re.escape("(csrc/mpe_policy.cu) are compiled for hidden widths "
                      "8, 16, 32, 64, 128, 256; got 48")
    with pytest.raises(NotImplementedError, match=named):
        t_policy.policy_traj_cuda(kscn, weights, 64, 8, 4, 64, 4, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=named):
        t_policy.policy_rollout_cuda(kscn, weights, 64, 8, 4, 64, 0, device="cpu")
    for h in (48, 128):
        actor = init_maddpg(torch.Generator().manual_seed(0), 18, 5, 3, hidden=h)["actor"]
        with pytest.raises(NotImplementedError, match=re.escape(
                f"(csrc/mpe_maddpg.cu) are compiled for hidden widths 8, 16, 32, 64; got {h}")):
            fused_maddpg.maddpg_traj_cuda(kscn, fused_maddpg._kernel_weights(actor), 64, 10, 5,
                                          64, 5, 0.1, 0, device="cpu")
    assert before == (t_policy.policy_traj_cuda.launches, t_policy.policy_rollout_cuda.launches,
                      fused_maddpg.maddpg_traj_cuda.launches)


def test_tile_kernel_wrappers_refuse_bad_tiles_before_any_launch():
    """A tile size outside ``POLICY_TILES`` or ``MADDPG_TILES`` raises before
    the device is looked at (so here, without a card)."""
    from mpe_tpu_torch.ops import fused_maddpg

    kscn = t_policy._resolve("simple_spread")
    weights = t_policy._kernel_weights(_params(hidden=64)[1])
    before = (t_policy.policy_traj_cuda.launches, t_policy.policy_rollout_cuda.launches,
              fused_maddpg.maddpg_traj_cuda.launches)
    for tile in (0, 3, 64):
        with pytest.raises(ValueError, match=f"tile={tile}"):
            t_policy.policy_traj_cuda(kscn, weights, 64, 8, 4, 64, 4, 0, device="cpu", tile=tile)
        with pytest.raises(ValueError, match=f"tile={tile}"):
            t_policy.policy_rollout_cuda(kscn, weights, 64, 8, 4, 64, 0, device="cpu", tile=tile)
    with pytest.raises(ValueError, match="tile=16"):
        fused_maddpg.maddpg_traj_cuda(kscn, None, 64, 10, 5, 64, 5, 0.1, 0, device="cpu",
                                      tile=16)
    assert before == (t_policy.policy_traj_cuda.launches, t_policy.policy_rollout_cuda.launches,
                      fused_maddpg.maddpg_traj_cuda.launches)


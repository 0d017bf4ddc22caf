"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.
They import neither JAX nor ``mpe_tpu``, so on a machine without JAX run
them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels are built with ``-fmad=false`` and round each
multiply and add as PyTorch's elementwise ops do, so positions,
velocities and rewards agree exactly; the obs checksum is summed in
another order (atol 1e-3 over 20 steps). The policy kernels K4/K5 sum each
layer in the plain version's order: moves, comm indices and episode counts
equal, values within 1e-5, on all nine scenarios. The update kernel K6 sums
the batch in its own order: each gradient leaf within 1e-4 of the largest
entry of the leaf, the metrics within 1e-4 relative, on a batch where both
clips bind too; so does the MAPPO update kernel K7 (both also with comm
heads, and K7 with simple_world_comm's 204-wide critic). The MADDPG collection kernel K8 takes the plain
version's actions exactly (values within 1e-5) in both output forms; the
MADDPG update kernel K9 takes the plain version's target actions and its
gradient leaves lie within 1e-4 of each leaf's largest entry. The trajectory
kernel K3 emits the plain version's actions exactly (raw hash draws) and its
obs, rewards, positions and velocities within 1e-5, on all nine scenarios;
K2 on the eight others is held as on simple_spread (simple_tag and
simple_world_comm through the pair physics), and K2 with an env lane split
over 2, 4 or 8 threads equals K2 with one bit for bit, and so does K1 on all
nine scenarios. The MADDPG update
chunk on its packed state holds the tree chunk with the plain K9 within
1e-4 of each leaf's largest entry.
"""

import dataclasses

import pytest
import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.learner import init_policy
from mpe_tpu_torch.learner.fused_ppo import build_fused_mappo_step, build_fused_ppo_step
from mpe_tpu_torch.ops import (fused_parity, fused_policy, fused_rollout, fused_trajectory,
                               fused_update)
from mpe_tpu_torch.ops.kernel_scenarios import KernelSpread, kernel_scenario


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block_offset", [0, 1])
def test_spread_rollout_kernel_matches_plain(card, block_offset):
    spec = scenarios.load("simple_spread").spec
    run = fused_rollout.fused_spread_rollout(spec, 2048, 20, horizon=10, block_envs=1024)
    before = fused_rollout.rollout_cuda.launches_by["simple_spread"]
    got = run(5, block_offset)
    assert fused_rollout.rollout_cuda.launches_by["simple_spread"] == before + 1
    for name, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got, run.plain(5, block_offset)):
        assert a.is_cuda and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 if name == "obs_sum" else 0,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [20, 0])
def test_spread_det_rollout_kernel_matches_plain(card, n_steps):
    inputs = fused_parity.make_det_inputs("simple_spread", 2048)
    before = fused_parity.det_rollout_cuda.launches_by["simple_spread"]
    got = fused_parity.fused_det_rollout("simple_spread", 2048, n_steps, block_envs=1024)(*inputs)
    assert fused_parity.det_rollout_cuda.launches_by["simple_spread"] == before + 1
    ref = fused_parity.plain_det_rollout_blocked("simple_spread", n_steps, 1024)(*inputs)
    for name, a, b in zip(("pos", "vel", "rew_sum", "rew", "obs"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(card):
    kscn = kernel_scenario("simple_spread")
    pos0, vel0, comm0, goal0 = fused_parity.make_det_inputs("simple_spread", 256)
    with pytest.raises(ValueError, match="contiguous"):
        fused_parity.det_rollout_cuda(kscn, 4, 128, pos0.double(), vel0, comm0, goal0)
    with pytest.raises(ValueError, match="shape"):
        fused_parity.det_rollout_cuda(kscn, 4, 128, pos0[..., :128], vel0, comm0, goal0)
    with pytest.raises(ValueError, match="multiple"):
        fused_rollout.rollout_cuda(kscn, 256, 4, 10, 100, 0, device=card)


OTHER_EIGHT = ["simple", "simple_reference", "simple_speaker_listener", "simple_adversary",
               "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", OTHER_EIGHT)
def test_scenario_rollout_kernel_matches_plain(card, name):
    run = fused_rollout.fused_rollout(name, 2048, 20, horizon=10, block_envs=1024)
    for block_offset in (0, 1):
        before = fused_rollout.rollout_cuda.launches_by[name]
        got = run(5, block_offset)
        assert fused_rollout.rollout_cuda.launches_by[name] == before + 1
        for label, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got,
                               run.plain(5, block_offset)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3 if label == "obs_sum" else 0,
                                       msg=f"{label} (block offset {block_offset})")


@pytest.mark.cuda
@pytest.mark.parametrize("name", OTHER_EIGHT)
def test_det_rollout_kernel_matches_plain(card, name):
    """K1 on the other eight scenarios over 20 steps: values within 1e-5."""
    inputs = fused_parity.make_det_inputs(name, 2048, seed=3)
    before = fused_parity.det_rollout_cuda.launches_by[name]
    got = fused_parity.fused_det_rollout(name, 2048, 20, block_envs=1024)(*inputs)
    assert fused_parity.det_rollout_cuda.launches_by[name] == before + 1
    ref = fused_parity.plain_det_rollout_blocked(name, 20, 1024)(*inputs)
    for label, a, b in zip(("pos", "vel", "rew_sum", "rew", "obs"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_trajectory_kernel_matches_plain(card, name):
    run = fused_trajectory.fused_trajectory(name, 512, 24, horizon=10, block_envs=256,
                                            t_chunk=4)
    for block_offset in (0, 1):
        before = fused_trajectory.trajectory_cuda.launches
        got = run(3, block_offset)
        assert fused_trajectory.trajectory_cuda.launches == before + 1
        ref = run.plain(3, block_offset)
        for label, a, b in zip(("obs", "act", "rew", "pos", "vel"), got, ref):
            assert a.is_cuda and a.shape == b.shape, label
            torch.testing.assert_close(a, b, rtol=0, atol=0 if label == "act" else 1e-5,
                                       msg=f"{label} (block offset {block_offset})")


@pytest.mark.cuda
def test_trajectory_wrappers_refuse_bad_inputs(card):
    kscn = kernel_scenario("simple_reference")
    with pytest.raises(ValueError, match="CUDA"):
        fused_trajectory.trajectory_cuda(kscn, 64, 8, 5, 32, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="multiple of t_chunk"):
        fused_trajectory.trajectory_cuda(kscn, 64, 6, 5, 32, 4, 0, device=card)
    spec = kscn.spec
    limited = type(kscn)(dataclasses.replace(spec, max_speed=spec.max_speed.clip(max=1.0)))
    with pytest.raises(NotImplementedError, match="as published only"):
        fused_trajectory.trajectory_cuda(limited, 64, 8, 5, 32, 4, 0, device=card)
    with pytest.raises(NotImplementedError, match="as published only"):
        fused_rollout.rollout_cuda(limited, 64, 8, 5, 32, 0, device=card)


def _policy(card, name="simple_spread"):
    kscn = kernel_scenario(name)
    params = init_policy(torch.Generator().manual_seed(0), kscn.obs_w, kscn.n_logits)
    return {k: {q: x.to(card) for q, x in layer.items()} for k, layer in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
@pytest.mark.parametrize("block_offset", [0, 1])
def test_policy_traj_kernel_matches_plain(card, block_offset, name):
    params = _policy(card, name)
    run = fused_policy.fused_policy_trajectory(name, params, 2048, 16, horizon=6,
                                               block_envs=1024, t_chunk=4, device=card)
    before = fused_policy.policy_traj_cuda.launches
    got = run(3, params, block_offset)
    assert fused_policy.policy_traj_cuda.launches == before + 1
    ref = run.plain(3, params, block_offset)
    labels = ("obs", "act", "cact", "rew", "last_obs") if run.has_comm else ("obs", "act", "rew",
                                                                            "last_obs")
    for label, a, b in zip(labels, got, ref):
        exact = label in ("act", "cact")
        torch.testing.assert_close(a, b, rtol=0, atol=0 if exact else 1e-5, msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_policy_rollout_kernel_matches_plain(card, name):
    params = _policy(card, name)
    run = fused_policy.fused_policy_rollout(name, params, 2048, 20, horizon=6,
                                            block_envs=1024, device=card)
    before = fused_policy.policy_rollout_cuda.launches
    ret, pos, eps = run(8, params, 1)
    assert fused_policy.policy_rollout_cuda.launches == before + 1
    ref = run.plain(8, params, 1)
    torch.testing.assert_close(eps, ref[2], rtol=0, atol=0, msg="episodes")
    torch.testing.assert_close(ret, ref[0], rtol=0, atol=1e-5, msg="ret")
    torch.testing.assert_close(pos, ref[1], rtol=0, atol=1e-5, msg="pos")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread", "simple_reference", "simple_world_comm"])
def test_ppo_update_kernel_matches_plain(card, name):
    """On the trainer's epoch-0 batch and on the same batch with both clips
    binding for about half of the samples."""
    step = build_fused_ppo_step(name, 1024, n_steps=16, horizon=8, block_envs=1024, device=card)
    params = step.init_params(torch.Generator().manual_seed(1))
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    lpo_c, v_c, shares = fused_update.clip_binding_inputs(
        logp_old, value, clip=0.2, generator=torch.Generator(card).manual_seed(3))
    assert all(0.2 < s < 0.8 for s in shares), shares
    # at epoch 0 the ratio is 1 and the advantages normalized, so the pg mean
    # is 0 up to rounding: it is held where the clips bind
    for lpo, v_old, first_metric in ((logp_old, value, 1), (lpo_c, v_c, 0)):
        before = fused_update.ppo_update_cuda.launches
        got, got_m = step.update(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        assert fused_update.ppo_update_cuda.launches == before + 1
        ref, ref_m = step.update.plain(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        for k in ref:
            for q in ref[k]:
                scale = float(ref[k][q].abs().max())
                torch.testing.assert_close(got[k][q], ref[k][q], rtol=0, atol=1e-4 * scale,
                                           msg=f"{k}.{q}")
        for a, b in zip(got_m[first_metric:], ref_m[first_metric:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_update_kernels_refuse_other_actor_heads(card):
    """The actor passes are compiled for the nine scenarios' (obs width,
    comm logits) heads: another head is refused before a launch."""
    step = build_fused_ppo_step("simple_spread", 1024, n_steps=16, horizon=8, block_envs=1024,
                                device=card)
    params = step.init_params(torch.Generator().manual_seed(1))
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    narrow = {k: dict(v) for k, v in params.items()}
    narrow["l1"]["w"] = params["l1"]["w"][:17].contiguous()
    before = fused_update.ppo_update_cuda.launches
    with pytest.raises(NotImplementedError, match="actor heads"):
        fused_update.ppo_update_cuda(narrow, obs[:, :, :17].contiguous(), mv_oh, None, logp_old,
                                     adv_n, ret, value, clip=0.2, vf_coef=0.5, ent_coef=0.01)
    assert fused_update.ppo_update_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["max_speed", "initial_mass"])
def test_policy_kernels_refuse_other_specs(card, change):
    spec = scenarios.load("simple_spread").spec
    value = getattr(spec, change).copy()
    value[0] = {"max_speed": 1.0, "initial_mass": 2.0}[change]
    kscn = KernelSpread(dataclasses.replace(spec, **{change: value}))
    weights = fused_policy._kernel_weights(_policy(card))
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        fused_policy.policy_traj_cuda(kscn, weights, 64, 8, 4, 64, 4, 0, device=card)
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        fused_policy.policy_rollout_cuda(kscn, weights, 64, 8, 4, 64, 0, device=card)


def _leaf_close(got, ref, rel: float, name: str):
    """Every leaf of a nested gradient tree within ``rel`` of its largest entry."""
    if isinstance(ref, dict):
        for key in ref:
            _leaf_close(got[key], ref[key], rel, f"{name}.{key}")
        return
    torch.testing.assert_close(got, ref, rtol=0, atol=rel * float(ref.abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener",
                                  "simple_world_comm"])
def test_mappo_update_kernel_matches_plain(card, name):
    """K7 on the MAPPO trainer's epoch-0 batch and on the same batch with
    both clips binding for about half of the samples (team value streams)."""
    step = build_fused_mappo_step(name, 1024, n_steps=16, horizon=8, block_envs=1024,
                                  device=card)
    params = step.init_params(torch.Generator().manual_seed(1))
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    assert value.shape == (16, 1024) and adv_n.shape == (16, 1024)
    lpo_c, v_c, shares = fused_update.clip_binding_inputs(
        logp_old, value, clip=0.2, generator=torch.Generator(card).manual_seed(3))
    assert all(0.2 < s < 0.8 for s in shares), shares
    for lpo, v_old, first_metric in ((logp_old, value, 1), (lpo_c, v_c, 0)):
        before = fused_update.mappo_update_cuda.launches
        got, got_m = step.update(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        assert fused_update.mappo_update_cuda.launches == before + 1
        ref, ref_m = step.update.plain(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        _leaf_close(got, ref, 1e-4, "grads")
        for a, b in zip(got_m[first_metric:], ref_m[first_metric:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


def _maddpg_params(card, name, seed=0):
    from mpe_tpu_torch.learner.maddpg import init_maddpg

    kscn = kernel_scenario(name)
    params = init_maddpg(torch.Generator().manual_seed(seed), kscn.obs_w, kscn.n_logits,
                         kscn.spec.n_agents)
    return {n: {q: {w: x.to(card) for w, x in layer.items()} for q, layer in net.items()}
            for n, net in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [0.1, 0.0])
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_maddpg_traj_kernel_matches_plain(card, name, eps):
    from mpe_tpu_torch.ops import fused_maddpg

    actor = _maddpg_params(card, name)["actor"]
    for rows in (False, True):
        run = fused_maddpg.fused_maddpg_trajectory(name, actor, 2048, 20, horizon=10,
                                                   eps_greedy=eps, block_envs=1024, t_chunk=5,
                                                   emit_rows=rows, device=card)
        before = fused_maddpg.maddpg_traj_cuda.launches_by[name]
        got = run(4, actor, 1)
        assert fused_maddpg.maddpg_traj_cuda.launches_by[name] == before + 1
        ref = run.plain(4, actor, 1)
        got, ref = ((got,), (ref,)) if rows else (got, ref)
        for label, a, b in zip(("obs", "act", "rew", "obs2"), got, ref):
            atol = 0 if label == "act" else 1e-5
            torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f"{label} (rows={rows})")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_maddpg_update_kernel_matches_plain(card, name):
    from mpe_tpu_torch.ops import fused_maddpg, fused_maddpg_update

    kscn = kernel_scenario(name)
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    params = _maddpg_params(card, name, 1)
    gen = torch.Generator(card).manual_seed(2)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device=card)
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    rows = fused_maddpg.fused_maddpg_trajectory(name, params["actor"], 1024, 10,
                                                horizon=5, block_envs=1024, t_chunk=5,
                                                emit_rows=True, device=card)(0, params["actor"])
    rows = rows.reshape(-1, rows.shape[-1])[torch.randperm(10240, generator=gen, device=card)[:512]]
    grads_fn = fused_maddpg_update.fused_maddpg_update(a, o, k, 5, 64, 512, device=card)
    act2 = torch.empty((a, 2 if k > 5 else 1, 512), dtype=torch.int32, device=card)
    before = fused_maddpg_update.maddpg_update_cuda.launches_by[name]
    got, got_m = fused_maddpg_update.maddpg_update_cuda(params, targets, rows.contiguous(), mw=5,
                                                        gamma=0.95, ent_coef=0.01,
                                                        target_actions=act2)
    assert fused_maddpg_update.maddpg_update_cuda.launches_by[name] == before + 1
    ref, ref_m = grads_fn.plain.from_rows(params, targets, rows)
    obs2 = rows[:, a * (o + k + 1):].reshape(512, a, o)
    want_act2 = fused_maddpg_update.target_indices(
        fused_maddpg_update.target_logits(targets["actor"], obs2), 5)
    assert torch.equal(act2.long(), want_act2.permute(1, 2, 0))
    _leaf_close(got, ref, 1e-4, "grads")
    for a_, b_ in zip(got_m, ref_m):
        torch.testing.assert_close(a_, b_, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_maddpg_runner_runs_every_scenario(card, name):
    """Two chunks of the runner on the card, through K8 and K9 of the
    scenario: finite losses and rewards, the ring's rows of its width."""
    from mpe_tpu_torch.learner import fused_loop
    from mpe_tpu_torch.ops import fused_maddpg, fused_maddpg_update

    kscn = kernel_scenario(name)
    a, ow, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    run = fused_loop.build_fused_maddpg_runner(name, n_envs=64, horizon=5, batch=64)
    before = (fused_maddpg.maddpg_traj_cuda.launches_by[name],
              fused_maddpg_update.maddpg_update_cuda.launches_by[name])
    params, info = run(10, seed=1, actor_start=0)
    assert fused_maddpg.maddpg_traj_cuda.launches_by[name] == before[0] + 40 + 2
    assert fused_maddpg_update.maddpg_update_cuda.launches_by[name] == before[1] + 10
    assert info["buffer"].data.shape[1] == a * (2 * ow + k + 1)
    assert bool(torch.isfinite(info["critic_loss"]).all())
    assert bool(torch.isfinite(info["mean_reward"]).all())



@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_grouped_rollout_kernel_equals_one_thread_per_lane(card, name, group):
    """K2 with an env lane split over ``group`` threads equals K2 with one
    thread per lane bit for bit (1000 envs: the last warp runs padding lanes
    at groups 2 and 4)."""
    kscn = kernel_scenario(name)
    one = fused_rollout.rollout_cuda(kscn, 1000, 30, 10, 500, 3, 1, card, group=1)
    split = fused_rollout.rollout_cuda(kscn, 1000, 30, 10, 500, 3, 1, card, group=group)
    for label, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), split, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_grouped_det_rollout_kernel_equals_one_thread_per_lane(card, name, group):
    """K1 with an env lane split over ``group`` threads equals K1 with one
    thread per lane bit for bit (pos, vel, rew_sum, rew_last, obs_last; 1000
    envs: the last warp runs padding lanes at groups 2 and 4)."""
    kscn = kernel_scenario(name)
    inputs = fused_parity.make_det_inputs(name, 1000, seed=2)
    one = fused_parity.det_rollout_cuda(kscn, 30, 500, *inputs, group=1)
    split = fused_parity.det_rollout_cuda(kscn, 30, 500, *inputs, group=group)
    for label, x, y in zip(("pos", "vel", "rew_sum", "rew_last", "obs_last"), split, one):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
def test_packed_update_chunk_matches_tree_chunk(card, name):
    """Five updates of the runner's chunk on its packed state (K9's launcher,
    flat Adam and Polyak) against the tree chunk with the plain K9: params
    within 1e-4 of each leaf's largest entry, the Adam counts equal."""
    from mpe_tpu_torch.learner import fused_loop

    run = fused_loop.build_fused_maddpg_runner(name, n_envs=64, horizon=5, batch=64)
    params, info = run(10, seed=1, actor_start=0)
    state = (params, info["targets"], info["opt_states"])
    gates = fused_loop.actor_gates(2, 5, 0)
    got = run.update_chunk(*state, info["buffer"], 3, gates)
    ref = run.update_chunk.plain(*state, info["buffer"], 3, gates)
    for tree_g, tree_r in zip(got[:2], ref[:2]):
        _leaf_close(tree_g, tree_r, 1e-4, "params")
    assert all(got[2][n].count == ref[2][n].count for n in ("actor", "critic"))

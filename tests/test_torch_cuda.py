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
equal, values within 1e-5, on all nine scenarios, and every tile size (env
lanes per CTA) gives the same bits. The update kernel K6 sums
the batch in its own order: each gradient leaf within 1e-4 of the largest
entry of the leaf, the metrics within 1e-4 relative, on a batch where both
clips bind too; so does the MAPPO update kernel K7 (both also with comm
heads, and K7 with simple_world_comm's 204-wide critic). K6-bf16 and K7-bf16
(``compute_dtype=torch.bfloat16``, hidden 16-256) hold their plain bf16
versions within 1e-3 of each leaf's largest entry: a bf16 operand that two
right float32 sums put on either side of a rounding boundary rounds a whole
ulp apart.
K9-bf16 holds its plain bf16 version the same way, its target actions
equal wherever a head's two best logits lie clear of
``target_logit_tolerance``. The MADDPG collection kernel K8 takes the plain
version's actions exactly (values within 1e-5) in both output forms, at
every tile size bit for bit; the
MADDPG update kernel K9 takes the plain version's target actions and its
gradient leaves lie within 1e-4 of each leaf's largest entry. The trajectory
kernel K3 emits the plain version's actions exactly (raw hash draws) and its
obs, rewards, positions and velocities within 1e-5, on all nine scenarios,
and with an env lane split over 2, 4 or 8 threads equals itself with one bit
for bit;
K2 on the eight others is held as on simple_spread (simple_tag and
simple_world_comm through the pair physics), and K2 with an env lane split
over 2, 4 or 8 threads equals K2 with one bit for bit, and so does K1 on all
nine scenarios. The MADDPG update
chunk on its packed state holds the tree chunk with the plain K9 within
1e-4 of each leaf's largest entry. One ES generation launches K4 once per
member, and its member scores equal the plain version's within 1e-5; the
env API (``make_env``, ``VecMultiAgentEnv``, the PettingZoo adapter) runs on
the card with samples drawn there.
"""

import dataclasses
import math

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
@pytest.mark.parametrize("kind, name, hidden", [("ppo", "simple_spread", 64),
                                                ("ppo", "simple_reference", 16),
                                                ("mappo", "simple_spread", 64),
                                                ("mappo", "simple_speaker_listener", 32),
                                                ("ppo", "simple_spread", 128),
                                                ("ppo", "simple_world_comm", 256),
                                                ("mappo", "simple_speaker_listener", 128),
                                                ("mappo", "simple_world_comm", 256)])
def test_bf16_update_kernels_match_plain_bf16(card, kind, name, hidden):
    """K6-bf16 and K7-bf16 through a trainer with ``compute_dtype=
    torch.bfloat16``: one epoch gradient on the epoch-0 batch and on it with
    both clips binding launches the bf16 kernel (not the float32 one), each
    leaf within 1e-3 of the largest entry of the plain bf16 version's (bf16
    operands that two right sums round a whole ulp apart); at 128 and 256
    the wide kernel (``ppo_update_bf16_wide_kernel``)."""
    build = build_fused_ppo_step if kind == "ppo" else build_fused_mappo_step
    bf16 = getattr(fused_update, f"{kind}_update_bf16_cuda")
    f32 = getattr(fused_update, f"{kind}_update_cuda")
    step = build(name, 1024, n_steps=16, horizon=8, block_envs=1024, hidden=hidden,
                 compute_dtype=torch.bfloat16, device=card)
    params = step.init_params(torch.Generator().manual_seed(1))
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    lpo_c, v_c, _ = fused_update.clip_binding_inputs(
        logp_old, value, clip=0.2, generator=torch.Generator(card).manual_seed(3))
    for lpo, v_old in ((logp_old, value), (lpo_c, v_c)):
        before = (bf16.launches, f32.launches)
        got, _ = step.update(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        assert (bf16.launches, f32.launches) == (before[0] + 1, before[1])
        ref, _ = step.update.plain(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        _leaf_close(got, ref, 1e-3, f"bf16 grads, {kind} on {name} at hidden {hidden}")


def _equal(got, want, labels, what):
    for label, a, b in zip(labels, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{label} ({what})")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_policy_kernels_equal_at_every_tile(card, name):
    """K5 and K4 at every tile of ``POLICY_TILES`` on 1000 envs (the last tile
    of 16 and 32 ragged): tile 1 against the plain version (actions and
    episodes exactly, values within 1e-5), every other tile equal to tile 1
    bit for bit."""
    kscn = kernel_scenario(name)
    weights = fused_policy._kernel_weights(_policy(card, name), card)
    traj = (kscn, weights, 1000, 16, 6, 500, 4, 3, 1, card)
    roll = (kscn, weights, 1000, 20, 6, 500, 8, 1, card)
    labels5 = ("obs", "act", "cact", "rew", "last_obs") if kscn.uses_comm else (
        "obs", "act", "rew", "last_obs")
    one5 = fused_policy.policy_traj_cuda(*traj, tile=1)
    one4 = fused_policy.policy_rollout_cuda(*roll, tile=1)
    for label, a, b in zip(labels5, one5, fused_policy.plain_policy_trajectory(*traj)):
        exact = label in ("act", "cact")
        torch.testing.assert_close(a, b, rtol=0, atol=0 if exact else 1e-5, msg=label)
    for label, a, b in zip(("ret", "pos", "episodes"), one4,
                           fused_policy.plain_policy_rollout(*roll)):
        torch.testing.assert_close(a, b, rtol=0, atol=0 if label == "episodes" else 1e-5,
                                   msg=label)
    for tile in fused_policy.POLICY_TILES[1:]:
        _equal(fused_policy.policy_traj_cuda(*traj, tile=tile), one5, labels5, f"K5, tile {tile}")
        _equal(fused_policy.policy_rollout_cuda(*roll, tile=tile), one4, ("ret", "pos", "eps"),
               f"K4, tile {tile}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_maddpg_traj_kernel_equal_at_every_tile(card, name):
    """K8 at every tile of ``MADDPG_TILES`` on 1000 envs, eps 0.5 (the eps
    one-hot taken for about half of the draws), both forms: tile 1 against
    the plain version (actions exactly, values within 1e-5), every other tile
    equal to tile 1 bit for bit."""
    from mpe_tpu_torch.ops import fused_maddpg

    kscn = kernel_scenario(name)
    actor = _maddpg_params(card, name, seed=2)["actor"]
    actor["out"]["w"] = actor["out"]["w"] * 100.0
    weights = fused_maddpg._kernel_weights(actor, card)
    for rows in (False, True):
        args = (kscn, weights, 1000, 20, 10, 500, 5, 0.5, 4, 1, rows, card)
        one = fused_maddpg.maddpg_traj_cuda(*args, tile=1)
        ref = fused_maddpg.plain_maddpg_trajectory(*args[:-1], device=card)
        one, ref = ((one,), (ref,)) if rows else (one, ref)
        labels = ("rows",) if rows else ("obs", "act", "rew", "obs2")
        for label, a, b in zip(labels, one, ref):
            atol = 0 if label == "act" else 1e-5
            torch.testing.assert_close(a, b, rtol=0, atol=atol, msg=f"{label} (rows={rows})")
        for tile in fused_maddpg.MADDPG_TILES[1:]:
            got = fused_maddpg.maddpg_traj_cuda(*args, tile=tile)
            _equal((got,) if rows else got, one, labels, f"K8, tile {tile}, rows={rows}")


@pytest.mark.cuda
def test_tile_kernels_refuse_bad_tiles(card):
    """A tile size outside ``POLICY_TILES`` (K4, K5) or ``MADDPG_TILES`` (K8)
    is refused before any launch."""
    from mpe_tpu_torch.ops import fused_maddpg

    kscn = kernel_scenario("simple_world_comm")
    weights = fused_policy._kernel_weights(_policy(card, "simple_world_comm"), card)
    mweights = fused_maddpg._kernel_weights(_maddpg_params(card, "simple_world_comm")["actor"],
                                            card)
    before = (fused_policy.policy_traj_cuda.launches, fused_policy.policy_rollout_cuda.launches,
              fused_maddpg.maddpg_traj_cuda.launches)
    for tile in (0, 3, 64):
        with pytest.raises(ValueError, match=f"tile={tile}"):
            fused_policy.policy_traj_cuda(kscn, weights, 64, 8, 4, 64, 4, 0, device=card,
                                          tile=tile)
        with pytest.raises(ValueError, match=f"tile={tile}"):
            fused_policy.policy_rollout_cuda(kscn, weights, 64, 8, 4, 64, 0, device=card,
                                             tile=tile)
    for tile in (0, 16):                 # 16: world_comm's six actors and 16 lanes' rows
        with pytest.raises(ValueError, match=f"tile={tile}"):
            fused_maddpg.maddpg_traj_cuda(kscn, mweights, 64, 10, 5, 64, 5, 0.1, 0, device=card,
                                          tile=tile)
    assert before == (fused_policy.policy_traj_cuda.launches,
                      fused_policy.policy_rollout_cuda.launches,
                      fused_maddpg.maddpg_traj_cuda.launches)


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


def _reversed_sums(w, b, x):
    """``fused_maddpg_update._seq_dense_agents`` with each sum over the inputs
    taken from the last product to the first: the same function in another
    right order (``tests/test_torch_maddpg_bf16_wide_host.py`` has its twin)."""
    n = w.shape[1]
    acc = x[..., n - 1:n] * w[:, n - 1]
    for q in range(n - 2, -1, -1):
        acc = acc + x[..., q:q + 1] * w[:, q]
    return acc + b


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
@pytest.mark.parametrize("hidden", [64, 16, 128, 256])
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_maddpg_bf16_update_kernel_matches_plain_bf16(card, monkeypatch, name, hidden):
    """K9-bf16 (``compute_dtype=torch.bfloat16``) on 1024 rows K8 collected,
    params of O(1) logits and targets = params + 0.1 N(0, 1): the target
    actions equal the plain bf16 version's wherever a head's two best logits
    lie further apart than ``target_logit_tolerance``; with the kernel's
    target actions fed to the plain bf16 version, each gradient leaf within
    1e-3 of its largest entry and the metrics within 1e-3 relative (a bf16
    activation that two right float32 sums put on either side of a rounding
    boundary rounds a whole ulp apart); at 128 and 256 a leaf within 1e-3 or
    within the plain version's own distance to itself with its forward sums
    reversed, where that is larger (the rule and its measurements:
    ``tests/test_torch_maddpg_bf16_wide_host.py``); K9-bf16 counted, K9 not."""
    from mpe_tpu_torch.learner.maddpg import init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg, fused_maddpg_update as fmu

    kscn = kernel_scenario(name)
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    params = {n: {q: {w: x.to(card) for w, x in layer.items()} for q, layer in net.items()}
              for n, net in init_maddpg(torch.Generator().manual_seed(1), o, k, a,
                                        hidden=hidden).items()}
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    gen = torch.Generator(card).manual_seed(2)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device=card)
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    rows = fused_maddpg.fused_maddpg_trajectory(name, params["actor"], 1024, 10, horizon=5,
                                                block_envs=1024, t_chunk=5, emit_rows=True,
                                                device=card)(0, params["actor"])
    rows = rows.reshape(-1, rows.shape[-1])[torch.randperm(10240, generator=gen,
                                                           device=card)[:1024]].contiguous()
    act2 = torch.empty((a, 2 if k > 5 else 1, 1024), dtype=torch.int32, device=card)
    before = (fmu.maddpg_update_bf16_cuda.launches_by[name], fmu.maddpg_update_cuda.launches)
    got, got_m = fmu.maddpg_update_cuda(params, targets, rows, mw=5, gamma=0.95, ent_coef=0.01,
                                        target_actions=act2, compute_dtype=torch.bfloat16)
    assert fmu.maddpg_update_bf16_cuda.launches_by[name] == before[0] + 1
    assert fmu.maddpg_update_cuda.launches == before[1]
    obs2 = rows[:, a * (o + k + 1):].reshape(1024, a, o)
    logits = fmu.target_logits(targets["actor"], obs2, torch.bfloat16)
    want = fmu.target_indices(logits, 5).permute(1, 2, 0)
    heads = [(0, 5)] + ([(5, k)] if k > 5 else [])
    gaps = torch.stack([logits[..., lo:hi].topk(2, -1).values.diff(dim=-1)[..., 0].neg()
                        for lo, hi in heads], -1).permute(1, 2, 0)
    clear = gaps > fmu.target_logit_tolerance(targets["actor"])[:, None, None]
    assert torch.equal(act2.long()[clear], want[clear])
    hp = dict(mw=5, gamma=0.95, ent_coef=0.01, compute_dtype=torch.bfloat16,
              target_actions=act2)
    ref, ref_m = fmu.plain_maddpg_update(params, targets, rows, **hp)
    if hidden <= 64:
        _leaf_close(got, ref, 1e-3, "grads")
    else:
        with monkeypatch.context() as m:
            m.setattr(fmu, "_seq_dense_agents", _reversed_sums)
            other, _ = fmu.plain_maddpg_update(params, targets, rows, **hp)
        for n in ref:
            for q in ref[n]:
                for w in ref[n][q]:
                    want = ref[n][q][w]
                    atol = max(1e-3 * float(want.abs().max()),
                               float((other[n][q][w] - want).abs().max()))
                    torch.testing.assert_close(got[n][q][w], want, rtol=0, atol=atol,
                                               msg=f"grads.{n}.{q}.{w}")
    for a_, b_ in zip(got_m, ref_m):
        torch.testing.assert_close(a_, b_, rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 128])
@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
def test_bf16_update_chunk_launches_k9_bf16(card, name, hidden):
    """``build_fused_update_chunk(..., compute_dtype=torch.bfloat16)`` on a
    runner's ring: five updates launch K9-bf16 five times and K9 never, the
    params finite and moved; at hidden 64 and 128."""
    from mpe_tpu_torch.learner import fused_loop
    from mpe_tpu_torch.learner.maddpg import build_fused_update_chunk
    from mpe_tpu_torch.ops import fused_maddpg_update as fmu

    run = fused_loop.build_fused_maddpg_runner(name, n_envs=64, horizon=5, batch=64,
                                               hidden=hidden)
    params, info = run(10, seed=1, actor_start=0)
    chunk = build_fused_update_chunk(run.env, 5, batch=64, hidden=hidden,
                                     compute_dtype=torch.bfloat16)
    before = (fmu.maddpg_update_bf16_cuda.launches_by[name], fmu.maddpg_update_cuda.launches)
    got = chunk(params, info["targets"], chunk.init_opt(params), info["buffer"], 3,
                fused_loop.actor_gates(2, 5, 0))
    assert fmu.maddpg_update_bf16_cuda.launches_by[name] == before[0] + 5
    assert fmu.maddpg_update_cuda.launches == before[1]
    for net in got[0].values():
        for layer in net.values():
            assert all(bool(torch.isfinite(x).all()) for x in layer.values())
    assert not torch.equal(got[0]["critic"]["l1"]["w"], params["critic"]["l1"]["w"])


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


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", ["simple_spread"] + OTHER_EIGHT)
def test_grouped_trajectory_kernel_equals_one_thread_per_lane(card, name, group):
    """K3 with an env lane split over ``group`` threads equals K3 with one
    thread per lane bit for bit (1000 envs: the last CTA is ragged; 24 steps
    in chunks of 4 with resets)."""
    kscn = kernel_scenario(name)
    args = (kscn, 1000, 24, 10, 500, 4, 3, 1, card)
    one = fused_trajectory.trajectory_cuda(*args, group=1)
    split = fused_trajectory.trajectory_cuda(*args, group=group)
    for label, a, b in zip(("obs", "act", "rew", "pos", "vel"), split, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [8, 16, 32, 128, 256])
def test_mlp_kernels_at_hidden_width_match_plain(card, hidden):
    """K5 (actions equal, values within 1e-5) and K6 and K7 (each leaf within
    1e-4 of its largest entry) of the libraries built at ``hidden``, through
    the trainers of that width on simple_speaker_listener (a comm head); the
    kernels launched, not the plain versions."""
    for build, wrapper in ((build_fused_ppo_step, fused_update.ppo_update_cuda),
                           (build_fused_mappo_step, fused_update.mappo_update_cuda)):
        step = build("simple_speaker_listener", 1024, n_steps=16, horizon=8, block_envs=1024,
                     hidden=hidden, device=card)
        params = step.init_params(torch.Generator().manual_seed(hidden))
        before = (fused_policy.policy_traj_cuda.launches, wrapper.launches)
        obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
        got, _ = step.update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        assert (fused_policy.policy_traj_cuda.launches, wrapper.launches) == (before[0] + 1,
                                                                                before[1] + 1)
        ref, _ = step.update.plain(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        _leaf_close(got, ref, 1e-4, f"grads at hidden {hidden}")
    actor = {"l1": params["a1"], "l2": params["a2"], "out": params["pi"]}
    run = fused_policy.fused_policy_trajectory("simple_speaker_listener", actor, 1024, 16,
                                               horizon=8, block_envs=1024, t_chunk=8, device=card)
    got, ref = run(4, actor), run.plain(4, actor)
    for label, a, b in zip(("obs", "act", "cact", "rew", "last_obs"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0 if "act" in label else 1e-5, msg=label)


@pytest.mark.cuda
def test_wide_mappo_kernel_on_the_widest_critic_where_clips_bind(card):
    """K7 at hidden 256 on simple_world_comm, whose 204-wide joint critic is
    the widest (the wide kernel reads its w1 rows from device memory): one
    launch, both passes, on the trainer's epoch-0 batch and on the same batch
    with both clips binding for about half of the samples; the counter + 1
    each time, each leaf within 1e-4 of its largest entry of the plain
    version, the metrics within 1e-4 relative."""
    step = build_fused_mappo_step("simple_world_comm", 1024, n_steps=16, horizon=8,
                                  block_envs=1024, hidden=256, device=card)
    params = step.init_params(torch.Generator().manual_seed(7))
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    lpo_c, v_c, shares = fused_update.clip_binding_inputs(
        logp_old, value, clip=0.2, generator=torch.Generator(card).manual_seed(3))
    assert all(0.2 < s < 0.8 for s in shares), shares
    for lpo, v_old, first_metric in ((logp_old, value, 1), (lpo_c, v_c, 0)):
        before = fused_update.mappo_update_cuda.launches
        got, got_m = step.update(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        assert fused_update.mappo_update_cuda.launches == before + 1
        ref, ref_m = step.update.plain(params, obs, mv_oh, cm_oh, lpo, adv_n, ret, v_old)
        _leaf_close(got, ref, 1e-4, "grads at hidden 256")
        for a, b in zip(got_m[first_metric:], ref_m[first_metric:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("name", ["simple_spread", "simple_world_comm"])
def test_maddpg_kernels_at_wide_width_match_plain(card, name, hidden):
    """K8 and K9 of the library built at ``hidden`` (the actors read from
    device memory; K9's five wide kernels): K8 at two tiles, actions equal to
    the plain version's and the tiles bit for bit; K9 on 512 of its rows,
    target actions equal, each leaf within 1e-4 of its largest entry; both
    kernels counted; then K9 as the trainer launches it on the same rows, one
    launch counted, each of its five kernels counted once by the library, and
    the candidates' Q it leaves in its scratch within 1e-6 of the largest |Q|
    of the plain version's."""
    from mpe_tpu_torch.learner.maddpg import init_maddpg
    from mpe_tpu_torch.ops import _build, fused_maddpg, fused_maddpg_update as fmu

    kscn = kernel_scenario(name)
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    params = {n: {q: {w: x.to(card) for w, x in layer.items()} for q, layer in net.items()}
              for n, net in init_maddpg(torch.Generator().manual_seed(hidden), o, k, a,
                                        hidden=hidden).items()}
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    run = fused_maddpg.fused_maddpg_trajectory(name, params["actor"], 1024, 10, horizon=5,
                                               block_envs=1024, t_chunk=5, device=card)
    before = fused_maddpg.maddpg_traj_cuda.launches_by[name]
    got = run(0, params["actor"])
    assert fused_maddpg.maddpg_traj_cuda.launches_by[name] == before + 1
    ref = run.plain(0, params["actor"])
    for label, x, y in zip(("obs", "act", "rew", "obs2"), got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0 if label == "act" else 1e-5, msg=label)
    weights = fused_maddpg._kernel_weights(params["actor"], card)
    for tile in (1, 2):
        other = fused_maddpg.maddpg_traj_cuda(kscn, weights, 1024, 10, 5, 1024, 5, 0.1, 0,
                                              device=card, tile=tile)
        for label, x, y in zip(("obs", "act", "rew", "obs2"), other, got):
            assert torch.equal(x, y), f"{label} at tile {tile}"
    gen = torch.Generator(card).manual_seed(2)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device=card)
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    rows = fused_maddpg.fused_maddpg_trajectory(name, params["actor"], 1024, 10, horizon=5,
                                                block_envs=1024, t_chunk=5, emit_rows=True,
                                                device=card)(0, params["actor"])
    rows = rows.reshape(-1, rows.shape[-1])[torch.randperm(10240, generator=gen,
                                                           device=card)[:512]].contiguous()
    act2 = torch.empty((a, 2 if k > 5 else 1, 512), dtype=torch.int32, device=card)
    before = fmu.maddpg_update_cuda.launches_by[name]
    got, got_m = fmu.maddpg_update_cuda(params, targets, rows, mw=5, gamma=0.95, ent_coef=0.01,
                                        target_actions=act2)
    assert fmu.maddpg_update_cuda.launches_by[name] == before + 1
    ref, ref_m = fmu.fused_maddpg_update(a, o, k, 5, hidden, 512, device=card).plain.from_rows(
        params, targets, rows)
    want = fmu.target_indices(fmu.target_logits(targets["actor"],
                                                rows[:, a * (o + k + 1):].reshape(512, a, o)), 5)
    assert torch.equal(act2.long(), want.permute(1, 2, 0))
    _leaf_close(got, ref, 1e-4, "grads")
    for x, y in zip(got_m, ref_m):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=0)
    k9 = fmu.MaddpgUpdateLauncher(a, o, k, 5, hidden, 512, card, gamma=0.95, ent_coef=0.01)
    weights = k9.layout.pack(params, targets).to(card)
    grads = torch.empty(k9.layout.off_ta, device=card)
    metrics = torch.empty(3, device=card)
    before = fmu.maddpg_update_cuda.launches_by[name]
    lib = _build.library("mpe_maddpg.cu", hidden)
    lib.mpe_maddpg_update_launched(-1)
    k9.launch(weights, rows, grads, metrics)
    assert fmu.maddpg_update_cuda.launches_by[name] == before + 1
    assert [lib.mpe_maddpg_update_launched(j) for j in range(5)] == [1] * 5
    want_q = fmu.plain_candidate_q(params, rows, mw=5)           # the scratch's last block
    got_q = k9.partials[k9.partials.numel() - want_q.numel():].view(want_q.shape)
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-6 * float(want_q.abs().max()))


@pytest.mark.cuda
def test_mlp_kernels_refuse_uncompiled_widths(card):
    """A hidden width a kernel's source is not compiled for raises before
    any launch, on the card too, naming that source's widths: no wrapper
    falls back to the plain version. 48 for K5 and K8. K9-bf16 takes 128:
    ``build_fused_update(compute_dtype=torch.bfloat16)`` launches it once,
    and neither K9 nor the plain version. K6-bf16 takes 128: the bf16
    trainer's update launches it once, and neither K6 nor the plain
    version."""
    import re

    from mpe_tpu_torch.learner import fused_loop
    from mpe_tpu_torch.learner.maddpg import build_fused_update, init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg, fused_maddpg_update as fmu

    step = build_fused_ppo_step("simple_spread", 1024, n_steps=16, horizon=8, block_envs=1024,
                                hidden=48, device=card)
    params = step.init_params(torch.Generator().manual_seed(0))
    run = fused_loop.build_fused_maddpg_runner("simple_spread", n_envs=64, horizon=5, batch=64,
                                               hidden=128)
    mparams, info = run(10, seed=1, actor_start=0)
    counters = (fused_policy.policy_traj_cuda, fused_update.ppo_update_cuda,
                fused_update.ppo_update_bf16_cuda, fused_maddpg.maddpg_traj_cuda,
                fmu.maddpg_update_cuda, fmu.maddpg_update_bf16_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(NotImplementedError, match=re.escape(
            "(csrc/mpe_policy.cu) are compiled for hidden widths 8, 16, 32, 64, 128, 256; "
            "got 48")):
        step.collect(params, 2)
    actor = init_maddpg(torch.Generator().manual_seed(0), 18, 5, 3, hidden=48)["actor"]
    with pytest.raises(NotImplementedError, match=re.escape(
            "(csrc/mpe_maddpg.cu) are compiled for hidden widths 8, 16, 32, 64, 128, 256; "
            "got 48")):
        fused_maddpg.maddpg_traj_cuda(kernel_scenario("simple_spread"),
                                      fused_maddpg._kernel_weights(actor, card), 1024, 10, 5,
                                      1024, 5, 0.1, 0, device=card)
    update = build_fused_update(run.env, batch=64, hidden=128, device=card,
                                compute_dtype=torch.bfloat16)
    new_params = update(mparams, info["targets"], update.init_opt(mparams), info["buffer"], 3)[0]
    assert all(bool(torch.isfinite(x).all()) for net in new_params.values()
               for layer in net.values() for x in layer.values())
    before[5] += 1                                       # K9-bf16 takes 128
    wide = build_fused_ppo_step("simple_spread", 1024, n_steps=16, horizon=8, block_envs=1024,
                                hidden=128, device=card, compute_dtype=torch.bfloat16)
    wparams = wide.init_params(torch.Generator().manual_seed(0))
    batch = wide.collect(wparams, 2)
    before[0] += 1                                       # K5 takes 128
    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = batch
    grads, _ = wide.update(wparams, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
    assert grads["l1"]["w"].is_cuda and grads["l1"]["w"].shape == (18, 128)
    before[2] += 1                                       # K6-bf16 takes 128
    assert before == [c.launches for c in counters]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 64, 256])
def test_es_generation_launches_k4_per_member_and_matches_plain(card, hidden):
    """One ES generation is ``pop`` launches of K4, whose member scores
    equal the plain version's on the same perturbed weights (1e-5)."""
    from mpe_tpu_torch.learner import build_es_step

    kscn = kernel_scenario("simple")
    params = init_policy(torch.Generator(device=card).manual_seed(0), kscn.obs_w, 5,
                         hidden=hidden)
    step = build_es_step(kscn, params, 1024, 50, 25, pop=6, sigma=0.1, lr=0.1, device=card)
    before = fused_policy.policy_rollout_cuda.launches_by["simple"]
    new, mean = step(params, 0)
    assert fused_policy.policy_rollout_cuda.launches_by["simple"] == before + 6
    assert new["l1"]["w"].is_cuda and torch.isfinite(mean)
    got, ref = step.scores(params, 0), step.plain.scores(params, 0)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    assert float(got.mean()) == float(mean)


@pytest.mark.cuda
def test_env_api_on_the_card(card):
    """make_env, VecMultiAgentEnv and the PettingZoo adapter on the card:
    samples drawn on the card are taken as actions, and the batched env's
    env 7 steps as the single env does from its state."""
    from mpe_tpu_torch import make_env
    from mpe_tpu_torch.envs import MpeEnv, VecMultiAgentEnv, parallel_env

    env = make_env("simple_spread", benchmark=True, seed=42)
    assert env.env.device.type == "cuda"
    obs_n = env.reset()
    gen = torch.Generator(device=card).manual_seed(0)
    obs_n, rew_n, _, info_n = env.step([torch.nn.functional.one_hot(s.sample(gen).long(), s.n)
                                        for s in env.action_space])
    assert obs_n[0].shape == (18,) and rew_n[0] == rew_n[1] == rew_n[2]
    assert set(info_n["n"][0]) == {"rew", "collisions", "min_dists", "occupied_landmarks"}

    mpe = MpeEnv(scenarios.load("simple_spread"))
    vec = VecMultiAgentEnv(mpe, 64, seed=1)
    vec.reset()
    states0 = vec.states
    acts = torch.rand((64, 3, 7), generator=gen, device=card)
    obs, rew, done, _ = vec.step(acts)
    _, obs7, rew7, done7, _ = mpe.step(states0.map(lambda x: x[7:8]), acts[7:8])
    torch.testing.assert_close(obs[7:8], obs7, rtol=0, atol=0)
    torch.testing.assert_close(rew[7:8], rew7, rtol=0, atol=0)

    par = parallel_env("simple_tag", max_cycles=3)
    par.reset(seed=0)
    while par.agents:
        _, rewards, _, trunc, _ = par.step({a: par.action_space(a).sample(gen)
                                            for a in par.agents})
    assert all(trunc.values()) and all(math.isfinite(r) for r in rewards.values())

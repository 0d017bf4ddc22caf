"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.
They import neither JAX nor ``mpe_tpu``, so on a machine without JAX run
them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels are built with ``-fmad=false`` and round each
multiply and add as PyTorch's elementwise ops do, so positions,
velocities and rewards agree exactly; the obs checksum is summed in
another order (atol 1e-3 over 20 steps). The policy kernels K4/K5 sum each
layer in the plain version's order: actions and episode counts equal,
values within 1e-5. The update kernel K6 sums the batch in its own order:
each gradient leaf within 1e-4 of the largest entry of the leaf, the
metrics within 1e-4 relative, on a batch where both clips bind too.
"""

import dataclasses

import pytest
import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.learner import init_policy
from mpe_tpu_torch.learner.fused_ppo import build_fused_ppo_step
from mpe_tpu_torch.ops import fused_parity, fused_policy, fused_rollout, fused_update
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
    before = fused_rollout.spread_rollout_cuda.launches
    got = run(5, block_offset)
    assert fused_rollout.spread_rollout_cuda.launches == before + 1
    for name, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got, run.plain(5, block_offset)):
        assert a.is_cuda and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 if name == "obs_sum" else 0,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps", [20, 0])
def test_spread_det_rollout_kernel_matches_plain(card, n_steps):
    inputs = fused_parity.make_det_inputs("simple_spread", 2048)
    before = fused_parity.spread_det_rollout_cuda.launches
    got = fused_parity.fused_det_rollout("simple_spread", 2048, n_steps, block_envs=1024)(*inputs)
    assert fused_parity.spread_det_rollout_cuda.launches == before + 1
    ref = fused_parity.plain_det_rollout_blocked("simple_spread", n_steps, 1024)(*inputs)
    for name, a, b in zip(("pos", "vel", "rew_sum", "rew", "obs"), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(card):
    kscn = kernel_scenario("simple_spread")
    pos0, vel0, comm0, goal0 = fused_parity.make_det_inputs("simple_spread", 256)
    with pytest.raises(ValueError, match="contiguous"):
        fused_parity.spread_det_rollout_cuda(kscn, 4, 128, pos0.double(), vel0, comm0, goal0)
    with pytest.raises(ValueError, match="shape"):
        fused_parity.spread_det_rollout_cuda(kscn, 4, 128, pos0[..., :128], vel0, comm0, goal0)
    with pytest.raises(ValueError, match="multiple"):
        fused_rollout.spread_rollout_cuda(kscn, 256, 4, 10, 100, 0, device=card)


def _policy(card):
    params = init_policy(torch.Generator().manual_seed(0), 18, 5)
    return {k: {q: x.to(card) for q, x in layer.items()} for k, layer in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("block_offset", [0, 1])
def test_policy_traj_kernel_matches_plain(card, block_offset):
    params = _policy(card)
    run = fused_policy.fused_policy_trajectory("simple_spread", params, 2048, 16, horizon=6,
                                               block_envs=1024, t_chunk=4, device=card)
    before = fused_policy.spread_policy_traj_cuda.launches
    got = run(3, params, block_offset)
    assert fused_policy.spread_policy_traj_cuda.launches == before + 1
    ref = run.plain(3, params, block_offset)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0, msg="act")
    for name, a, b in zip(("obs", "rew", "last_obs"), (got[0], got[2], got[3]),
                          (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


@pytest.mark.cuda
def test_policy_rollout_kernel_matches_plain(card):
    params = _policy(card)
    run = fused_policy.fused_policy_rollout("simple_spread", params, 2048, 20, horizon=6,
                                            block_envs=1024, device=card)
    before = fused_policy.spread_policy_rollout_cuda.launches
    ret, pos, eps = run(8, params, 1)
    assert fused_policy.spread_policy_rollout_cuda.launches == before + 1
    ref = run.plain(8, params, 1)
    torch.testing.assert_close(eps, ref[2], rtol=0, atol=0, msg="episodes")
    torch.testing.assert_close(ret, ref[0], rtol=0, atol=1e-5, msg="ret")
    torch.testing.assert_close(pos, ref[1], rtol=0, atol=1e-5, msg="pos")


@pytest.mark.cuda
def test_ppo_update_kernel_matches_plain(card):
    """On the trainer's epoch-0 batch and on the same batch with both clips
    binding for about half of the samples."""
    step = build_fused_ppo_step("simple_spread", 1024, n_steps=16, horizon=8, block_envs=1024,
                                device=card)
    params = step.init_params(torch.Generator().manual_seed(1))
    obs, mv_oh, logp_old, value, adv_n, ret = step.collect(params, 2)
    lpo_c, v_c, shares = fused_update.clip_binding_inputs(
        logp_old, value, clip=0.2, generator=torch.Generator(card).manual_seed(3))
    assert all(0.2 < s < 0.8 for s in shares), shares
    # at epoch 0 the ratio is 1 and the advantages normalized, so the pg mean
    # is 0 up to rounding: it is held where the clips bind
    for lpo, v_old, first_metric in ((logp_old, value, 1), (lpo_c, v_c, 0)):
        before = fused_update.ppo_update_cuda.launches
        got, got_m = step.update(params, obs, mv_oh, None, lpo, adv_n, ret, v_old)
        assert fused_update.ppo_update_cuda.launches == before + 1
        ref, ref_m = step.update.plain(params, obs, mv_oh, None, lpo, adv_n, ret, v_old)
        for k in ref:
            for q in ref[k]:
                scale = float(ref[k][q].abs().max())
                torch.testing.assert_close(got[k][q], ref[k][q], rtol=0, atol=1e-4 * scale,
                                           msg=f"{k}.{q}")
        for a, b in zip(got_m[first_metric:], ref_m[first_metric:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["max_speed", "initial_mass"])
def test_policy_kernels_refuse_other_specs(card, change):
    spec = scenarios.load("simple_spread").spec
    value = getattr(spec, change).copy()
    value[0] = {"max_speed": 1.0, "initial_mass": 2.0}[change]
    kscn = KernelSpread(dataclasses.replace(spec, **{change: value}))
    weights = fused_policy._kernel_weights(_policy(card))
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        fused_policy.spread_policy_traj_cuda(kscn, weights, 64, 8, 4, 64, 4, 0, device=card)
    with pytest.raises(NotImplementedError, match="simple_spread's physics only"):
        fused_policy.spread_policy_rollout_cuda(kscn, weights, 64, 8, 4, 64, 0, device=card)

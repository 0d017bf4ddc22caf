"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; without a card they skip.
They import neither JAX nor ``mpe_tpu``, so on a machine without JAX run
them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels are built with ``-fmad=false`` and round each
multiply and add as PyTorch's elementwise ops do, so positions,
velocities and rewards agree exactly; the obs checksum is summed in
another order (atol 1e-3 over 20 steps).
"""

import pytest
import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.ops import fused_parity, fused_rollout
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernels K1/K2 have no CPU mode)")
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

"""K6-bf16 and K7-bf16 at hidden 128 and 256 (``csrc/mpe_update_bf16.cu``:
``update_round_bf16_kernel``, then ``ppo_update_bf16_wide_kernel``, whose
products stream the fragment-packed bf16 weights of ``csrc/bf16_wide.cuh``)
compiled for the host (``tests/_csrc_host.py``: ``__nv_bfloat16`` rounds to
nearest even as the card does, ``host_mma_m16n8k16_bf16`` runs the
m16n8k16 bf16 ``mma.sync``, cp.async copies at once), held to the plain
versions with ``compute_dtype=torch.bfloat16`` over 3 CTAs: PPO on
simple_spread, MAPPO on simple_speaker_listener (a silent listener) and on
simple_world_comm (a comm head and the 204-wide critic, the largest
instantiation), each on a batch of 40 envs (ragged tiles that cross batch
rows, staged element by element) and on 64 envs whose logp_old and v_old
make both clips bind (``clip_binding_inputs`` on the bf16 forward's own
log-probs and values, so that no sample lies within its margin of a clip
boundary in the arithmetic under test).

Tolerance: every gradient leaf within 1e-3 of its largest entry, as at
hidden 8-64 (``tests/test_torch_bf16_host.py``), the metric means within
1e-3 relative. The kernel and the plain version round the same float32
values to bf16, but their float32 activations differ in the last bit (the
host's ``tanhf`` against PyTorch's tanh, and the sums' order), and an
activation next to a rounding boundary then rounds a whole bf16 ulp (2^-8)
the other way; one such operand moves a leaf whose largest entry is a
cancelling sum by about 1e-4 of it, and one sample's log-ratio by up to
1e-3 at 256 (logits up to 38 here), which moves the policy-gradient mean,
a sum that cancels too, by more than the 1e-4 the float32 kernels hold.
Measured on these batches: the largest leaf error 8.1e-4 (PPO on
simple_spread at 256, clips binding), 2.1e-4 or less elsewhere at 256 and
1.3e-4 or less at 128; the same kernel test at hidden 64 on other batches
of this construction measures the same kind of error (up to 9.4e-4).

The shared memory of every wide instantiation (the nine scenarios' actor
heads for K6's and K7's actor passes, their nine joint widths for K7's
critic) fits a CTA's 227 KB, and the wide passes report their bf16 scratch
and a grid of their own, which ``ops/fused_update.py`` sizes the partials
and the launch by; hidden 64 reports neither.
"""

import pytest
import torch

from mpe_tpu_torch.ops import fused_update
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import HOST_SMS, MAX_SMEM_FLOATS, build_host_libs_at
from tests.test_torch_csrc_host import _check_host_update
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDE = (128, 256)
SOURCE = "mpe_update_bf16.cu"
TOL = 1e-3
CASES = [("ppo", "simple_spread"), ("mappo", "simple_speaker_listener"),
         ("mappo", "simple_world_comm")]


@pytest.fixture(scope="module")
def host_libs():
    """The bf16 source at widths 128, 256 and 64, built at once."""
    return build_host_libs_at([(SOURCE, h) for h in WIDE + (64,)])


@pytest.mark.parametrize("clip_binding", [False, True], ids=["ragged", "clips_bind"])
@pytest.mark.parametrize("kind, name", CASES)
@pytest.mark.parametrize("hidden", WIDE)
def test_host_built_wide_bf16_update_kernels_match_plain_bf16(host_libs, hidden, kind, name,
                                                              clip_binding):
    _check_host_update(host_libs[SOURCE, hidden], kernel_scenario(name), kind, 2,
                       64 if clip_binding else 40, clip_binding, hidden,
                       compute_dtype=torch.bfloat16, tol=TOL, metric_rtol=TOL,
                       clip_forward=torch.bfloat16)


@pytest.mark.parametrize("hidden", WIDE)
def test_every_wide_bf16_instantiation_fits_a_cta(host_libs, hidden):
    """Each wide pass's shared memory fits a CTA's 227 KB; its bf16 scratch
    holds w1, w2 and w2^T (two bytes a weight, w1's inputs padded to 16);
    its grid is the (stand-in) card's SMs times the CTAs an SM holds."""
    lib = host_libs[SOURCE, hidden]
    passes = [(ow, kc, p) for ow, kc in sorted(fused_update.actor_heads()) for p in (0, 1)]
    passes += [(j, 0, 2) for j in sorted(fused_update.critic_widths())]
    assert len(passes) == 27
    for ow, kc, p in passes:
        smem = lib.mpe_update_smem(ow, kc, p)
        assert 0 < smem <= 4 * MAX_SMEM_FLOATS, (hidden, ow, kc, p, smem)
        inp = (ow + 15) // 16 * 16
        assert lib.mpe_update_scratch(ow, kc, p) == (hidden * inp + 2 * hidden * hidden) // 2
        assert lib.mpe_update_grid(ow, kc, p) == HOST_SMS
    assert lib.mpe_update_smem(17, 0, 0) == lib.mpe_update_scratch(17, 0, 0) == -1
    assert lib.mpe_update_grid(54, 0, 3) == -1


def test_wrappers_size_the_wide_launch_from_the_library(host_libs):
    """``_grid`` and ``_partials`` of the wrappers: at 256 the library's own
    grid and the partials followed by the bf16 scratch (the larger pass of
    K7 sets the length), at 64 two CTAs an SM and the partials alone."""
    wide, narrow = host_libs[SOURCE, 256], host_libs[SOURCE, 64]
    passes = [(18, 0, 1), (54, 0, 2)]
    assert fused_update._grid(wide, passes, "cpu") == HOST_SMS
    sizes = [fused_update._numel(fused_update._packed(18, 5, 256)),
             fused_update._numel(fused_update._packed(54, 1, 256))]
    buf = fused_update._partials(wide, 3, passes, sizes, "cpu")
    assert buf.numel() == max(-(-3 * ng // 4) * 4 + wide.mpe_update_scratch(*p)
                              for p, ng in zip(passes, sizes))
    assert [narrow.mpe_update_grid(*p) for p in passes] == [0, 0]
    assert [narrow.mpe_update_scratch(*p) for p in passes] == [0, 0]
    assert fused_update._partials(narrow, 3, passes, [10, 7], "cpu").numel() == 32

"""K6-bf16 and K7-bf16 (``csrc/mpe_update_bf16.cu``) compiled for the host
(``tests/_csrc_host.py``: its ``__nv_bfloat16`` rounds to nearest even as
the card does, and ``host_mma_m16n8k16_bf16`` runs the m16n8k16 bf16
``mma.sync`` over the warp's fragments as the PTX ISA lays them out), at
hidden 64 and 16, held to the plain versions with
``compute_dtype=torch.bfloat16`` over 3 CTAs: PPO on simple_spread and
simple_reference (16 outputs, the mma's whole row block), MAPPO on
simple_spread and simple_speaker_listener (a silent listener, a joint obs
of 22), each on a batch of 40 envs (ragged tiles that cross batch rows,
staged element by element) and on 64 envs whose logp_old and v_old make
both clips bind.

Tolerance: every gradient leaf within 1e-3 of its largest entry, the metric
means within 1e-4 relative. The kernel and the plain version round the same
float32 activations to bf16, but each sums its products in its own order
(the emulated mma in double, the plain einsum in float32), so an activation
that lies next to a rounding boundary rounds a whole bf16 ulp (2^-8) the
other way in one of them; the largest leaf error measured on these batches
and on simple_world_comm's 204-wide critic was 4.5e-4 (the float32 kernels
hold 1e-4, and a wrong fragment layout is off by O(1)).
"""

import pytest
import torch

from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs_at
from tests.test_torch_csrc_host import _check_host_update
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (64, 16)
SOURCE = "mpe_update_bf16.cu"
TOL = 1e-3
CASES = [("ppo", "simple_spread"), ("ppo", "simple_reference"), ("mappo", "simple_spread"),
         ("mappo", "simple_speaker_listener")]


@pytest.fixture(scope="module")
def host_libs():
    """The bf16 source at widths 64 and 16, built at once."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS])


@pytest.fixture
def one_thread():
    """The plain version's many small CPU ops on one intra-op thread (the
    host kernel runs its 256 threads beside them)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("clip_binding", [False, True], ids=["epoch0", "clips_bind"])
@pytest.mark.parametrize("kind, name", CASES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_bf16_update_kernels_match_plain_bf16(host_libs, one_thread, hidden, kind,
                                                         name, clip_binding):
    _check_host_update(host_libs[SOURCE, hidden], kernel_scenario(name), kind, 2,
                       64 if clip_binding else 40, clip_binding, hidden,
                       compute_dtype=torch.bfloat16, tol=TOL)

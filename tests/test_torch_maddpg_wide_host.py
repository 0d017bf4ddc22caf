"""K8 and K9 compiled for the host (``tests/_csrc_host.py``) at the hidden
widths 128 and 256 (``-DMPE_HIDDEN``, one library per width, as
``ops/_build.py`` builds ``mpe_maddpg.cu`` for the card), each held to its
plain version:

- K8 (the actors read from device memory, ``ACTORS_SMEM``) at tiles 1 and 8,
  both output forms, on simple_spread and simple_speaker_listener: action
  one-hots equal, the rest within float32 tolerances, the tiles bit for bit;
- K9 (its wide kernels: the nets streamed in slices, a persistent grid whose
  CTAs add each tile's weight gradients into their partial) on 80 random
  replay rows, three tiles of 32 with a ragged last one, over one CTA an
  agent (simple_spread, simple_world_comm: the widest joint, 258) or two
  (simple_speaker_listener: a comm head, 15 candidates), so that a CTA adds
  tiles into its partial and the reduce sums two partials; the target actions
  equal, the leaves within 1e-4 of their largest entry, the padding 0;
- every wide instantiation's dynamic shared memory within a CTA's 227 KB: K9's
  three kernels on the nine scenarios (``mpe_maddpg_update_smem``), K8 at every
  tile it takes (``mpe_maddpg_traj_ctas_per_sm``).

The width 8-64 instantiations are held by ``test_torch_csrc_host.py``,
``test_torch_policy_host.py`` and ``test_torch_hidden_host.py``.
"""

import pytest

from mpe_tpu_torch.ops import _build
from mpe_tpu_torch.ops.fused_maddpg import MADDPG_TILES
from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario
from tests._csrc_host import HOST_SMS, MAX_SMEM_FLOATS, build_host_libs_at
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_csrc_host import _check_host_maddpg_update
from tests.test_torch_policy_host import _check_maddpg_traj

WIDTHS = (128, 256)
SOURCE = "mpe_maddpg.cu"


@pytest.fixture(scope="module")
def host_libs():
    """``mpe_maddpg.cu`` at widths 128 and 256: two libraries, built at once."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS])


@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_traj_kernel_at_wide_width(host_libs, hidden, name):
    """K8 at tiles 1 and 8, both output forms, of the library built at
    ``hidden``: the action one-hots equal, the rows form equal to the tensor
    form's rows, the tiles bit for bit."""
    _check_maddpg_traj(host_libs[SOURCE, hidden], kernel_scenario(name), (1, 8), hidden)


@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener",
                                  "simple_world_comm"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_update_kernel_at_wide_width(host_libs, hidden, name):
    """K9 of the library built at ``hidden`` on 80 rows: three tiles of 32 on
    ``HOST_SMS // agents`` CTAs an agent (at least one); target actions equal,
    the leaves within 1e-4 of their largest entry, the padding 0."""
    lib, kscn = host_libs[SOURCE, hidden], kernel_scenario(name)
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    assert lib.mpe_maddpg_update_layout(scenario, 6) == max(1, HOST_SMS // kscn.spec.n_agents)
    _check_host_maddpg_update(lib, kscn, 80, hidden)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_wide_maddpg_instantiations_fit_shared_memory(host_libs, hidden):
    """K9's target-action, TD and gradient kernels ask for at most a CTA's
    dynamic shared memory on each of the nine scenarios, and K8 takes every
    tile of ``MADDPG_TILES`` there (its C entry reports 0 CTAs for a tile
    whose shared memory does not fit)."""
    lib = host_libs[SOURCE, hidden]
    limit = 4 * MAX_SMEM_FLOATS
    for name in _KERNEL_SCENARIOS:
        scenario = _build.SCENARIO_IDS[type(kernel_scenario(name)).__name__]
        sizes = [lib.mpe_maddpg_update_smem(scenario, which) for which in range(3)]
        assert all(0 < s <= limit for s in sizes), (name, sizes)
        assert [lib.mpe_maddpg_traj_ctas_per_sm(scenario, t) for t in MADDPG_TILES] == \
            [1] * len(MADDPG_TILES), name
    assert lib.mpe_maddpg_update_smem(0, 3) == -1

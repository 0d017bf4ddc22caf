"""K8 and K9 compiled for the host (``tests/_csrc_host.py``) at the hidden
widths 128 and 256 (``-DMPE_HIDDEN``, one library per width, as
``ops/_build.py`` builds ``mpe_maddpg.cu`` for the card), each held to its
plain version:

- K8 (the actors read from device memory, ``ACTORS_SMEM``) at tiles 1 and 8,
  both output forms, on simple_spread and simple_speaker_listener: action
  one-hots equal, the rest within float32 tolerances, the tiles bit for bit;
- K9 (its five wide kernels: the nets' transposed copies; the critic's
  forward beside the target actions; the TD targets beside the candidates'
  column tiles; the critic's backward beside the actor; the reduce; every
  product through the bulk-copy ring, whose mbarriers and copies the
  stand-in emulates) on 80 random replay rows, three tiles of 32 with a
  ragged last one: a partial a tile where the tiles fit ``2 HOST_SMS //
  agents`` backward CTA pairs an agent (simple_speaker_listener: a comm
  head, 15 candidates), else that many pairs (at least one) adding their
  tiles into their partials (simple_spread: two partials, the first of two
  tiles; simple_world_comm, the widest joint, 258, and 20 candidates: three
  tiles into one), the reduce summing an agent's partials in order, the
  candidates' columns ending in a ragged tile; again on 100 rows (a ragged
  tile of 4) on a stand-in card of 7 SMs (a partial a tile on simple_spread
  and simple_speaker_listener, two partials on simple_world_comm); each of
  the five kernels counted once by the library; the target actions equal, the leaves within
  1e-4 of their largest entry, the padding 0, and the candidates' Q that the
  launch leaves in its scratch within 1e-6 of the largest |Q| of the plain
  version's (``plain_candidate_q``);
- every wide instantiation's dynamic shared memory within a CTA's 227 KB: K9's
  three kernels that take it on the nine scenarios (``mpe_maddpg_update_smem``),
  K8 at every tile it takes (``mpe_maddpg_traj_ctas_per_sm``).

The width 8-64 instantiations are held by ``test_torch_csrc_host.py``,
``test_torch_policy_host.py`` and ``test_torch_hidden_host.py``.
"""

import pytest
import torch

from mpe_tpu_torch.ops import _build, fused_maddpg_update
from mpe_tpu_torch.ops.fused_maddpg import MADDPG_TILES
from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario
from tests._csrc_host import HOST_SMS, MAX_SMEM_FLOATS, build_host_libs_at
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_csrc_host import _check_host_maddpg_update
from tests.test_torch_policy_host import _check_maddpg_traj

WIDTHS = (128, 256)
SOURCE = "mpe_maddpg.cu"
OTHER_SMS = 7                   # a second stand-in card: other grids
NAMES = ["simple_spread", "simple_speaker_listener", "simple_world_comm"]


@pytest.fixture(scope="module")
def host_libs():
    """``mpe_maddpg.cu`` at widths 128 and 256: two libraries, built at once."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS])


@pytest.fixture(scope="module")
def other_libs():
    """The same on a stand-in card of OTHER_SMS SMs."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS], sms=OTHER_SMS)


def _check_candidates(lib, kscn, hidden: int, batch: int, sms: int):
    """K9 on ``batch`` rows (``_check_host_maddpg_update``), then its
    candidates' Q, read from the scratch after the partials that
    ``partials_floats`` sizes, against the plain version's within 1e-6 of
    the largest |Q|; prints the largest difference."""
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    a, k = kscn.spec.n_agents, kscn.n_logits
    ncand = 5 * max(k - 5, 1)
    parts = lib.mpe_maddpg_update_layout(scenario, 6)
    assert parts == max(1, 2 * sms // a)
    assert lib.mpe_maddpg_update_layout(scenario, 7) == a * (3 * hidden + 1 + ncand)
    j, ow = a * (kscn.obs_w + k), kscn.obs_w
    copies = a * 2 * (ow * hidden + j * hidden + 2 * hidden * hidden)
    assert lib.mpe_maddpg_update_layout(scenario, 8) == copies
    ng = lib.mpe_maddpg_update_layout(scenario, 3)
    head = -(-a * min(-(-batch // 32), parts) * ng // 4) * 4 + copies
    assert fused_maddpg_update.partials_floats(lib, scenario, a, batch) == \
        head + a * (3 * hidden + 1 + ncand) * batch
    params, rows, partials = _check_host_maddpg_update(lib, kscn, batch, hidden)
    got = partials[head + a * (3 * hidden + 1) * batch:].view(a, ncand, batch)
    want = fused_maddpg_update.plain_candidate_q(params, rows, mw=5)
    diff = float((got - want).abs().max())
    print(f"{kscn.spec.name} at hidden {hidden}, batch {batch}: the candidates' Q within "
          f"{diff:.3e} of the plain version's (largest |Q| {float(want.abs().max()):.3f})")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_traj_kernel_at_wide_width(host_libs, hidden, name):
    """K8 at tiles 1 and 8, both output forms, of the library built at
    ``hidden``: the action one-hots equal, the rows form equal to the tensor
    form's rows, the tiles bit for bit."""
    _check_maddpg_traj(host_libs[SOURCE, hidden], kernel_scenario(name), (1, 8), hidden)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_update_kernel_at_wide_width(host_libs, hidden, name):
    """K9 of the library built at ``hidden`` on 80 rows: three tiles of 32,
    a partial a tile on up to ``2 HOST_SMS // agents`` backward CTAs an agent;
    target actions equal, the leaves within 1e-4 of their largest entry, the
    padding 0, the candidates' Q within 1e-6 of the plain version's."""
    _check_candidates(host_libs[SOURCE, hidden], kernel_scenario(name), hidden, 80, HOST_SMS)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_update_on_another_grid(other_libs, hidden, name):
    """The same on 100 rows (four tiles, the last of 4 samples) on a stand-in
    card of OTHER_SMS SMs: up to ``2 OTHER_SMS // agents`` backward CTAs an
    agent (4, 7, 2)."""
    _check_candidates(other_libs[SOURCE, hidden], kernel_scenario(name), hidden, 100, OTHER_SMS)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_wide_maddpg_instantiations_fit_shared_memory(host_libs, hidden):
    """K9's wide forward, TD-and-candidates and backward kernels ask for at
    most a CTA's dynamic shared memory on each of the nine scenarios, and K8 takes every
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

"""K4-K9 compiled for the host (``tests/_csrc_host.py``) at the hidden widths
8 and 16 (``-DMPE_HIDDEN``, one library per source and width, as
``ops/_build.py`` builds them for the card; width 64 is held by
``test_torch_csrc_host.py`` and ``test_torch_policy_host.py``, 32 on the
card by ``chip_smoke.py``), each held to its plain version at the
tolerances of those files, on simple_spread and on simple_speaker_listener
(a comm head): K4, K5 and K8 at two tiles with actions equal and each tile
equal to the other bit for bit; K6 and K7 with every gradient leaf within
1e-4 of its largest entry, also on a batch where both clips bind; K9 with
its target actions equal and its leaves within 1e-4.
"""

import pytest

from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs_at
from tests.test_torch_csrc_host import _check_host_maddpg_update, _check_host_update
from tests.test_torch_policy_host import (_check_maddpg_traj, _check_policy_rollout,
                                          _check_policy_traj)
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (8, 16)
NAMES = ["simple_spread", "simple_speaker_listener"]
SOURCES = ("mpe_policy.cu", "mpe_update.cu", "mpe_maddpg.cu")


@pytest.fixture(scope="module")
def host_libs():
    """The three MLP sources at widths 8 and 16: six libraries, built at
    once."""
    return build_host_libs_at([(source, h) for h in WIDTHS for source in SOURCES])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_policy_kernels_at_hidden_width(host_libs, hidden, name):
    """K5 at tiles 2 and 16 and K4 at tiles 4 and 32 (ragged last tiles) of
    the library built at ``hidden``: actions and episodes equal to the plain
    version's, the rest within float32 tolerances, the tiles bit for bit."""
    kscn = kernel_scenario(name)
    lib = host_libs["mpe_policy.cu", hidden]
    _check_policy_traj(lib, kscn, (2, 16), hidden)
    _check_policy_rollout(lib, kscn, (4, 32), hidden)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_traj_kernel_at_hidden_width(host_libs, hidden, name):
    """K8 at tiles 1 and 8, both output forms, of the library built at
    ``hidden``: the action one-hots equal, the rows form equal to the tensor
    form's rows, the tiles bit for bit."""
    _check_maddpg_traj(host_libs["mpe_maddpg.cu", hidden], kernel_scenario(name), (1, 8), hidden)


@pytest.mark.parametrize("clip_binding", [False, True], ids=["epoch0", "clips_bind"])
@pytest.mark.parametrize("kind", ["ppo", "mappo"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_update_kernels_at_hidden_width(host_libs, hidden, name, kind, clip_binding):
    """K6 (``ppo``) and K7 (``mappo``) of the library built at ``hidden``
    over 3 CTAs: on 96 envs (ragged tiles, staged element by element) and
    on 128 envs whose logp_old and v_old make both clips bind; every
    gradient leaf within 1e-4 of its largest entry."""
    _check_host_update(host_libs["mpe_update.cu", hidden], kernel_scenario(name), kind, 2,
                       128 if clip_binding else 96, clip_binding, hidden)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_update_kernel_at_hidden_width(host_libs, hidden, name):
    """K9 of the library built at ``hidden`` on two and a half of its tiles
    (1024 / hidden samples each): target actions equal, the leaves within
    1e-4 of their largest entry, the padding 0."""
    _check_host_maddpg_update(host_libs["mpe_maddpg.cu", hidden], kernel_scenario(name),
                              5 * 1024 // (2 * hidden), hidden)

"""K4-K7 compiled for the host (``tests/_csrc_host.py``) at the hidden widths
128 and 256 (``-DMPE_HIDDEN``, one library per source and width, as
``ops/_build.py`` builds them for the card), each held to its plain version:

- K5 and K4 (``mpe_policy.cu``; at these widths the MLP reads the actor's
  weights from device memory, ``W_SMEM``) at two tiles each, on
  simple_spread and simple_speaker_listener: actions and episodes equal to
  the plain version's, the rest within float32 tolerances, the two tiles
  equal bit for bit;
- K6 and K7 (``mpe_update.cu``: ``ppo_update_wide_kernel``, thread-block
  clusters whose CTAs own blocks of units, the products 3xTF32) over 3
  clusters, on simple_spread (96 envs: ragged tiles staged
  element by element) and on simple_speaker_listener (128 envs, staged in
  16-byte pieces) where both clips bind: every gradient leaf within 1e-4 of
  its largest entry;
- every instantiation's dynamic shared memory within a CTA's 227 KB: K6 and
  K7 on the nine actor heads and critic widths (``mpe_update_smem``), K4 and
  K5 at the tiles each scenario takes (``mpe_policy_ctas_per_sm``).

The width 8-64 instantiations are held by ``test_torch_csrc_host.py``,
``test_torch_policy_host.py`` and ``test_torch_hidden_host.py``.
"""

import pytest

from mpe_tpu_torch.ops import _build
from mpe_tpu_torch.ops.fused_policy import POLICY_TILES
from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario
from tests._csrc_host import MAX_SMEM_FLOATS, build_host_libs_at
from tests.test_torch_csrc_host import _check_host_update
from tests.test_torch_policy_host import _check_policy_rollout, _check_policy_traj
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (128, 256)
NAMES = ["simple_spread", "simple_speaker_listener"]
SOURCES = ("mpe_policy.cu", "mpe_update.cu")


@pytest.fixture(scope="module")
def host_libs():
    """The two sources at widths 128 and 256: four libraries, built at once."""
    return build_host_libs_at([(source, h) for h in WIDTHS for source in SOURCES])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_policy_kernels_at_wide_width(host_libs, hidden, name):
    """K5 at tiles 2 and 16 and K4 at tiles 4 and 32 (ragged last tiles) of
    the library built at ``hidden``: actions and episodes equal to the plain
    version's, the rest within float32 tolerances, the tiles bit for bit."""
    kscn = kernel_scenario(name)
    lib = host_libs["mpe_policy.cu", hidden]
    _check_policy_traj(lib, kscn, (2, 16), hidden)
    _check_policy_rollout(lib, kscn, (4, 32), hidden)


@pytest.mark.parametrize("kind", ["ppo", "mappo"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_update_kernels_at_wide_width(host_libs, hidden, name, kind):
    """K6 (``ppo``) and K7 (``mappo``) of the library built at ``hidden``
    over 3 clusters on one step of the batch (5 or 6 tiles: two tiles a
    cluster for some): simple_spread at epoch 0 on 96 envs, simple_speaker_listener on
    128 envs whose logp_old and v_old make both clips bind; every gradient
    leaf within 1e-4 of its largest entry."""
    clip_binding = name == "simple_speaker_listener"
    _check_host_update(host_libs["mpe_update.cu", hidden], kernel_scenario(name), kind, 1,
                       128 if clip_binding else 96, clip_binding, hidden)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_wide_instantiations_fit_shared_memory(host_libs, hidden):
    """Every K6 and K7 pass (the nine actor heads, K6's and K7's, and the
    nine critic widths) asks for at most a CTA's dynamic shared memory; K4
    and K5 take tile 1 on every scenario, and a tile they take needs no
    more than that either (the C entries report 0 CTAs for a tile that does
    not fit)."""
    lib = host_libs["mpe_update.cu", hidden]
    limit = 4 * MAX_SMEM_FLOATS
    for name in _KERNEL_SCENARIOS:
        kscn = kernel_scenario(name)
        a, ow, kc = kscn.spec.n_agents, kscn.obs_w, kscn.n_comm
        sizes = [lib.mpe_update_smem(ow, kc, 0), lib.mpe_update_smem(ow, kc, 1),
                 lib.mpe_update_smem(a * ow, 0, 2)]
        assert all(0 < s <= limit for s in sizes), (name, sizes)
        policy = host_libs["mpe_policy.cu", hidden]
        for kernel in (0, 1):
            fits = [t for t in POLICY_TILES
                    if policy.mpe_policy_ctas_per_sm(_build.SCENARIO_IDS[type(kscn).__name__],
                                                     kernel, t) > 0]
            assert fits[0] == 1 and fits == list(POLICY_TILES[:len(fits)]), (name, fits)
    assert lib.mpe_update_smem(7, 0, 0) == lib.mpe_update_smem(55, 0, 2) == -1

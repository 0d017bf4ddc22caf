"""K9-bf16 (``csrc/mpe_maddpg_bf16.cu``) compiled for the host
(``tests/_csrc_host.py``) at the hidden widths 128 and 256 (``-DMPE_HIDDEN``,
one library per width, as ``ops/_build.py`` builds the source for the card),
held to the plain bf16 version (``plain_maddpg_update(...,
compute_dtype=torch.bfloat16)``):

- its wide kernels (the nets rounded once a call into a fragment-packed bf16
  scratch after the partials, the target actions, the TD targets, the
  gradient on a persistent grid whose CTAs add each tile into their partial,
  the reduce) on 264 random replay rows, four tiles of 64 samples and a
  ragged one of 8, on a stand-in card of ``SMS`` = 12 SMs: 4 CTAs an agent on
  simple_spread (CTA 0 adds tiles 0 and 4 into its partial), 5 of the 6 on
  simple_speaker_listener (a comm head, 15 candidates), 2 on
  simple_world_comm (6 agents, the widest joint, 258, 20 candidates; at 128);
  params of O(1) logits and targets = params + 0.1 N(0, 1), as
  ``tests/test_torch_maddpg_bf16_host.py`` makes them;
- target actions equal to the plain version's first argmax wherever a head's
  two best logits lie further apart than ``target_logit_tolerance``; the
  metrics within 1e-3 relative and each leaf's padding 0, as the width 16
  and 64 host test holds them (it says why);
- each leaf within 1e-3 of its largest entry (that test's tolerance), or
  within the plain version's own sum-order noise on the leaf where that is
  larger: the distance between the plain version and the same plain version
  with every forward sum taken in the reverse order (``_reversed_sums``),
  which is as right. A bf16 activation next to a rounding boundary rounds an
  ulp apart in either order, and at 128 and 256 units with 15 or 20
  candidates such flips reach the ill-conditioned expected-Q gradient of the
  actor: measured before the gate was set, the kernel's largest errors were
  4.0e-4 (spread at 256), 8.4e-4 (world_comm at 128; the plain version's
  own noise there 1.0e-3) and 1.09e-3 (actor.l1.w on speaker_listener at
  256, where the plain version's own noise is 1.63e-3); the critic's leaves
  stay below 1e-4;
- the layout constants (``PackedLayout``'s; tiles of 64; no bf16 rows, 6-10;
  11 the grid's CTAs an agent) and ``partials_floats`` (the partials of that
  grid, then the scratch);
- every wide instantiation's dynamic shared memory within a CTA's 227 KB:
  the target, TD and gradient kernels on the nine scenarios
  (``mpe_maddpg_update_smem``).

The widths 8-64 are held by ``test_torch_maddpg_bf16_host.py`` and
``test_torch_bf16_frag_host.py``.
"""

import pytest
import torch

from mpe_tpu_torch.ops import _build, fused_maddpg_update
from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario
from tests._csrc_host import MAX_SMEM_FLOATS, build_host_libs_at
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_maddpg_bf16_host import BATCH, METRIC_RTOL, MW, TOL, _inputs

WIDTHS = (128, 256)
SOURCE = "mpe_maddpg_bf16.cu"
SMS = 12
TILE = 64
CASES = [("simple_spread", 128), ("simple_spread", 256), ("simple_speaker_listener", 128),
         ("simple_speaker_listener", 256), ("simple_world_comm", 128)]


@pytest.fixture(scope="module")
def host_libs():
    """The K9-bf16 source at widths 128 and 256, built at once for a card of
    SMS SMs."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS], sms=SMS)


def _reversed_sums(w, b, x):
    """``fused_maddpg_update._seq_dense_agents`` with each sum over the inputs
    taken from the last product to the first: the same function in another
    right order."""
    n = w.shape[1]
    acc = x[..., n - 1:n] * w[:, n - 1]
    for q in range(n - 2, -1, -1):
        acc = acc + x[..., q:q + 1] * w[:, q]
    return acc + b


@pytest.mark.parametrize("name, hidden", CASES)
def test_host_built_wide_maddpg_bf16_kernel_matches_plain_bf16(host_libs, monkeypatch, name,
                                                               hidden):
    lib = host_libs[SOURCE, hidden]
    kscn = kernel_scenario(name)
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    nh, b = 2 if k > MW else 1, BATCH
    params, targets, rows = _inputs(kscn, hidden, b)
    lay = fused_maddpg_update.PackedLayout(a, o, k, hidden)
    consts = [lib.mpe_maddpg_update_layout(scenario, q) for q in range(12)]
    assert consts[:5] == [lay.nwp, lay.ncp, lay.n_weights, lay.nw + lay.nc + 3, TILE]
    assert consts[6:11] == [-1] * 5 and consts[11] == SMS // a
    tiles, parts = -(-b // TILE), min(-(-b // TILE), SMS // a)
    assert tiles >= 2 and parts >= 2
    floats = -(-(a * parts * consts[3]) // 4) * 4 + consts[5]
    assert fused_maddpg_update.partials_floats(lib, scenario, a, b) == floats
    wbuf = lay.pack(params, targets)
    act2 = torch.empty((a, nh, b), dtype=torch.int32)
    y = torch.empty((a, b))
    partials = torch.full((floats,), 7.0)
    grads, metrics = torch.empty(lay.off_ta), torch.empty(3)
    assert lib.mpe_maddpg_update(scenario, wbuf.data_ptr(), rows.data_ptr(), act2.data_ptr(),
                                 y.data_ptr(), partials.data_ptr(), grads.data_ptr(),
                                 metrics.data_ptr(), b, 0.95, 0.01, 1.0 / (a * b), None) == 0

    # target actions: equal wherever the two best logits of a head lie apart
    obs2 = rows[:, a * (o + k + 1):].reshape(b, a, o)
    logits = fused_maddpg_update.target_logits(targets["actor"], obs2, torch.bfloat16)
    want = fused_maddpg_update.target_indices(logits, MW).permute(1, 2, 0)     # [A, heads, B]
    bound = fused_maddpg_update.target_logit_tolerance(targets["actor"])          # [A]
    heads = [(0, MW)] + ([(MW, k)] if k > MW else [])
    gaps = torch.stack([logits[..., lo:hi].topk(2, -1).values.diff(dim=-1)[..., 0].neg()
                        for lo, hi in heads], -1).permute(1, 2, 0)                # [A, heads, B]
    clear = gaps > bound[:, None, None]
    assert clear.double().mean() > 0.8, "too few heads to hold"
    assert torch.equal(act2.long()[clear], want[clear])

    hp = dict(mw=MW, gamma=0.95, ent_coef=0.01, compute_dtype=torch.bfloat16,
              target_actions=act2)
    ref, ref_m = fused_maddpg_update.plain_maddpg_update(params, targets, rows, **hp)
    with monkeypatch.context() as m:
        m.setattr(fused_maddpg_update, "_seq_dense_agents", _reversed_sums)
        other, _ = fused_maddpg_update.plain_maddpg_update(params, targets, rows, **hp)
    actor, critic = lay.nets(grads)
    assert not actor[:, lay.nw:].any() and not critic[:, lay.nc:].any()
    got = {"actor": fused_maddpg_update._net_grads(actor, o, k, hidden),
           "critic": fused_maddpg_update._net_grads(critic, lay.j, 1, hidden)}
    for n in ref:
        for q in ref[n]:
            for w in ref[n][q]:
                want = ref[n][q][w]
                noise = float((other[n][q][w] - want).abs().max())
                atol = max(TOL * float(want.abs().max()), noise)
                torch.testing.assert_close(got[n][q][w], want, rtol=0, atol=atol,
                                           msg=lambda m, n=n, q=q, w=w: f"{n}.{q}.{w}: {m}")
    torch.testing.assert_close(metrics, torch.stack(ref_m), rtol=METRIC_RTOL, atol=0)


@pytest.mark.parametrize("hidden", WIDTHS)
def test_wide_maddpg_bf16_instantiations_fit_shared_memory(host_libs, hidden):
    lib = host_libs[SOURCE, hidden]
    for name in _KERNEL_SCENARIOS:
        kscn = kernel_scenario(name)
        scenario = _build.SCENARIO_IDS[type(kscn).__name__]
        sizes = [lib.mpe_maddpg_update_smem(scenario, which) for which in range(3)]
        assert all(0 < x <= 4 * MAX_SMEM_FLOATS for x in sizes), (name, hidden, sizes)
    assert lib.mpe_maddpg_update_smem(0, 3) == -1

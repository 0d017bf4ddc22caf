"""K9-bf16 (``csrc/mpe_maddpg_bf16.cu``) compiled for the host
(``tests/_csrc_host.py``: its ``__nv_bfloat16`` rounds to nearest even as
the card does, and ``host_mma_m16n8k16_bf16`` runs the m16n8k16 bf16
``mma.sync`` over the warp's fragments as the PTX ISA lays them out), at
hidden 64 and 16, held to the plain version with
``compute_dtype=torch.bfloat16`` on simple_spread, simple_speaker_listener
(a comm head, 15 candidates) and simple_world_comm (the widest joint, 258),
each on 40 random replay rows (a full tile of 32 samples and a ragged one),
params of O(1) logits and targets = params + 0.1 N(0, 1).

Tolerances are relative to a leaf's largest entry, a sum over the batch;
one bf16 operand that two right implementations round an ulp apart (below)
moves one term of it by 2^-8 of itself, so the batch has to hold enough
samples for that sum: on 40 rows (the float32 host test's) one such flip
moved a leaf by 2.35e-3 of its largest entry (simple_world_comm, hidden 64),
so the batch is 264 rows (sixteen full tiles of 16 samples and a ragged one
of 8).

- The layout constants equal ``PackedLayout``'s, the tile 16 samples.
- Target actions: equal to the plain version's first argmax per head
  wherever the head's two best logits lie further apart than
  ``target_logit_tolerance`` (two one-ulp flips of a bf16 activation);
  the heads below it are counted, not gated.
- The gradient, with the kernel's own target actions fed to the plain
  version (its ``target_actions``): every leaf within 1e-3 of its largest
  entry, its padding 0, the metrics within 1e-3 relative. The kernel and the
  plain version round the same float32 activations, but each sums its
  products in its own order (the emulated mma in double, the plain version
  in float32), so an activation next to a rounding boundary rounds a whole
  bf16 ulp apart; the largest errors measured on these six cases were 2.6e-4
  of a leaf's largest entry and 3.0e-4 of a metric (K6-bf16's host tests:
  4.5e-4; the same cases against the plain float32 version: 6.2e-3 to
  2.2e-2).

Torch runs on one intra-op thread: the plain K9 is thousands of small CPU
ops, and the host kernel's threads run beside them.
"""

import pytest
import torch

from mpe_tpu_torch.learner.maddpg import init_maddpg
from mpe_tpu_torch.ops import _build, fused_maddpg_update
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs_at
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (64, 16)
SOURCE = "mpe_maddpg_bf16.cu"
NAMES = ("simple_spread", "simple_speaker_listener", "simple_world_comm")
BATCH, TOL, METRIC_RTOL = 264, 1e-3, 1e-3
MW = 5


@pytest.fixture(scope="module")
def host_libs():
    """The K9-bf16 source at widths 64 and 16, built at once."""
    return build_host_libs_at([(SOURCE, h) for h in WIDTHS])


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(kscn, hidden: int, batch: int, seed: int = 1):
    """init_maddpg params (the actors' head scaled to O(1) logits), targets
    = params + 0.1 N(0, 1), and random replay rows with one-hot actions."""
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    params = init_maddpg(torch.Generator().manual_seed(seed), o, k, a, hidden=hidden)
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    gen = torch.Generator().manual_seed(seed + 1)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen) for w, x in layer.items()}
                   for q, layer in net.items()} for n, net in params.items()}
    act = torch.nn.functional.one_hot(torch.randint(0, MW, (batch, a), generator=gen), MW).float()
    if k > MW:
        act = torch.cat([act, torch.nn.functional.one_hot(
            torch.randint(0, k - MW, (batch, a), generator=gen), k - MW).float()], -1)
    rows = torch.cat([torch.randn((batch, a * o), generator=gen), act.reshape(batch, -1),
                      torch.randn((batch, a), generator=gen) - 2.0,
                      torch.randn((batch, a * o), generator=gen)], 1).contiguous()
    return params, targets, rows


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_host_built_maddpg_bf16_kernel_matches_plain_bf16(host_libs, one_thread, hidden, name):
    lib = host_libs[SOURCE, hidden]
    kscn = kernel_scenario(name)
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    a, o, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    nh, b = 2 if k > MW else 1, BATCH
    params, targets, rows = _inputs(kscn, hidden, b)
    lay = fused_maddpg_update.PackedLayout(a, o, k, hidden)
    nwp, ncp, n_weights, ng, ts = (lib.mpe_maddpg_update_layout(scenario, q) for q in range(5))
    assert (nwp, ncp, n_weights, ng, ts) == (lay.nwp, lay.ncp, lay.n_weights,
                                             lay.nw + lay.nc + 3, 16)
    wbuf = lay.pack(params, targets)
    act2 = torch.empty((a, nh, b), dtype=torch.int32)
    y = torch.empty((a, b))
    partials = torch.empty(fused_maddpg_update.partials_floats(lib, scenario, a, b))
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

    ref, ref_m = fused_maddpg_update.plain_maddpg_update(
        params, targets, rows, mw=MW, gamma=0.95, ent_coef=0.01, compute_dtype=torch.bfloat16,
        target_actions=act2)
    actor, critic = lay.nets(grads)
    assert not actor[:, lay.nw:].any() and not critic[:, lay.nc:].any()
    got = {"actor": fused_maddpg_update._net_grads(actor, o, k, hidden),
           "critic": fused_maddpg_update._net_grads(critic, lay.j, 1, hidden)}
    for n in ref:
        for q in ref[n]:
            for w in ref[n][q]:
                torch.testing.assert_close(got[n][q][w], ref[n][q][w], rtol=0,
                                           atol=TOL * float(ref[n][q][w].abs().max()),
                                           msg=lambda m, n=n, q=q, w=w: f"{n}.{q}.{w}: {m}")
    torch.testing.assert_close(metrics, torch.stack(ref_m), rtol=METRIC_RTOL, atol=0)

"""The MADDPG update chunk on its packed state (K9's weight buffer and Adam
moments in its layout, ``learner.maddpg.PackedState``) against the same
chunk in tree form (``update_chunk.plain``), on the CPU, where both take the
plain K9 gradient: params, targets, both Adam states and the metrics equal
bit for bit in float32 and float64, with per-agent actor gates; and
``pack_state``/``unpack_state`` round-trip exactly.
"""

import numpy as np
import pytest
import torch

from mpe_tpu_torch import scenarios
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import maddpg as tm
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

HIDDEN, BATCH, CAP, N_UPDATES = 16, 32, 256, 5
# per-agent gates: a step of all, none, one agent and two agents, and a scalar gate
GATES = np.array([[1, 1, 1], [0, 0, 0], [1, 0, 0], [0, 1, 1], [1, 1, 1]], dtype=bool)


def _setup(name: str, dtype, local_critic: bool = False):
    env = MpeEnv(scenarios.load(name), max_steps=25, auto_reset=True, device="cpu")
    _, obs_dim, aw, _, _ = tm._dims(env)
    a = env.n_agents
    chunk = tm.build_fused_update_chunk(env, N_UPDATES, batch=BATCH, tau_polyak=0.03,
                                        actor_lr=1e-3, critic_lr=2e-3, hidden=HIDDEN,
                                        device="cpu", dtype=dtype,
                                        grad_engine="autograd" if local_critic else "kernel",
                                        local_critic=local_critic)
    params = tm.init_maddpg(torch.Generator().manual_seed(1), obs_dim, aw, a, hidden=HIDDEN,
                            dtype=dtype, local_critic=local_critic)
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0     # O(1) logits
    gen = torch.Generator().manual_seed(2)
    targets = tm._tree3(lambda x: x + 0.1 * torch.randn(x.shape, generator=gen, dtype=dtype),
                        params)
    rng = np.random.default_rng(3)
    moves = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (CAP, a))]
    act = moves if aw == 5 else np.concatenate(
        [moves, np.eye(aw - 5, dtype=np.float32)[rng.integers(0, aw - 5, (CAP, a))]], -1)
    data = (rng.normal(size=(CAP, a, obs_dim)).astype(np.float32), act,
            (rng.normal(size=(CAP, a)) - 2.0).astype(np.float32),
            rng.normal(size=(CAP, a, obs_dim)).astype(np.float32))
    buffer = tm.Buffer.pack(*(torch.from_numpy(x) for x in data), ptr=0, size=CAP)
    return env, chunk, params, targets, buffer


def _equal_trees(got, want, label):
    for n in want:
        for q in want[n]:
            for w in want[n][q]:
                torch.testing.assert_close(got[n][q][w], want[n][q][w], rtol=0, atol=0,
                                           msg=f"{label}.{n}.{q}.{w}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
def test_packed_chunk_equals_tree_chunk(name, dtype):
    """Two chunks of five updates with per-agent gates (two agents of
    simple_speaker_listener take the first two columns): the packed chunk
    equals the tree chunk bit for bit."""
    _check_packed_chunk(name, dtype, local_critic=False)


@pytest.mark.parametrize("name", ["simple_spread", "simple_speaker_listener"])
def test_local_critic_packed_chunk_equals_tree_chunk(name):
    """The same on independent-DDPG critics (``[obs_i | act_i]`` inputs,
    the autograd engine): the layout takes the critics' input width."""
    _check_packed_chunk(name, torch.float32, local_critic=True)


def _check_packed_chunk(name, dtype, local_critic):
    env, chunk, params, targets, buffer = _setup(name, dtype, local_critic)
    if local_critic:
        assert chunk.layout.j == chunk.layout.o + chunk.layout.k
    gates = GATES[:, :env.n_agents]
    state_p = state_t = (params, targets, chunk.init_opt(params))
    for key in (4, 5):
        *state_p, m_p = chunk(*state_p, buffer, key, gates)
        *state_t, m_t = chunk.plain(*state_t, buffer, key, gates)
        _equal_trees(state_p[0], state_t[0], "params")
        _equal_trees(state_p[1], state_t[1], "targets")
        for net in ("actor", "critic"):
            p_opt, t_opt = state_p[2][net], state_t[2][net]
            assert (p_opt.count, p_opt.schedule_count) == (t_opt.count, t_opt.schedule_count)
            _equal_trees({"m": p_opt.mu, "v": p_opt.nu}, {"m": t_opt.mu, "v": t_opt.nu}, net)
        for k in m_t:
            assert m_p[k].dtype == dtype and float(m_p[k]) == float(m_t[k]), k
    assert state_p[2]["actor"].count == 2 * 4 and state_p[2]["critic"].count == 2 * N_UPDATES


def test_pack_unpack_round_trip():
    """``unpack_state(pack_state(s))`` returns ``s`` exactly, as new tensors
    (the chunk updates the packed buffer in place); ``actor_of`` is the
    actors; the buffer's padding is zero."""
    _check_round_trip(local_critic=False)


def test_local_critic_pack_unpack_round_trip():
    """The same on independent-DDPG critics."""
    _check_round_trip(local_critic=True)


def _check_round_trip(local_critic):
    _, chunk, params, targets, _ = _setup("simple_world_comm", torch.float32, local_critic)
    gen = torch.Generator().manual_seed(4)
    opt = chunk.init_opt(params)
    opt = {n: st._replace(count=3, mu=tm.tree_map(lambda x: torch.randn(x.shape, generator=gen),
                                                  st.mu),
                          nu=tm.tree_map(lambda x: torch.rand(x.shape, generator=gen), st.nu))
           for n, st in opt.items()}
    state = chunk.pack_state(params, targets, opt)
    lay = chunk.layout
    assert state.weights.shape == (lay.n_weights,)
    for net, block in zip(("actor", "critic"), lay.nets(state.weights[:lay.off_ta])):
        n = lay.nw if net == "actor" else lay.nc
        assert not block[:, n:].any(), net
    p, t, o = chunk.unpack_state(state)
    _equal_trees(p, params, "params")
    _equal_trees(t, targets, "targets")
    _equal_trees({"actor": chunk.actor_of(state)}, {"actor": params["actor"]}, "actor_of")
    for net in ("actor", "critic"):
        assert o[net].count == 3
        _equal_trees({"m": o[net].mu, "v": o[net].nu}, {"m": opt[net].mu, "v": opt[net].nu}, net)
    state.weights.zero_()
    assert p["actor"]["l1"]["w"].any() and t["critic"]["out"]["b"].any()

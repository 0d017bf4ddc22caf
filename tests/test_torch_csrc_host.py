"""The CUDA sources of K1-K9 (``csrc/mpe_kernels.cu``, ``csrc/mpe_trajectory.cu``,
``csrc/mpe_policy.cu``, ``csrc/mpe_update.cu``, ``csrc/mpe_maddpg.cu``)
compiled for the host by a C++ compiler and held against their plain
versions on the CPU, for every scenario instantiation.

The host build (``tests/_csrc_host.py``) runs a launch's blocks one after
another, each block's threads as cooperative fibers that meet at its
barriers, so a CTA's phases run in order as on the card. This checks the device functions' indexing, order of operations and RNG
streams without a card. The arithmetic is the host's (its libm and an exact
reciprocal square root), not the card's: trajectories' actions (raw hash
draws), the policy and MADDPG kernels' sampled actions and K9's target
actions are held equal, the rest within float32 tolerances, the update
kernels' gradients within 1e-4 of each leaf's largest entry as on the card; on the card
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernels there.
Without a C++ compiler the tests skip.
"""

import ctypes
import dataclasses

import pytest
import torch

from mpe_tpu_torch.learner.maddpg import init_maddpg
from mpe_tpu_torch.learner.ppo import init_ac, init_mappo
from mpe_tpu_torch.ops import _build, fused_maddpg, fused_maddpg_update, fused_update
from mpe_tpu_torch.ops.fused_parity import det_group, make_det_inputs, plain_det_rollout_blocked
from mpe_tpu_torch.ops.fused_policy import (_kernel_weights, _pack_weights, plain_policy_rollout,
                                            plain_policy_trajectory)
from mpe_tpu_torch.ops.fused_rollout import plain_rollout, rollout_group
from mpe_tpu_torch.ops.fused_trajectory import plain_trajectory, traj_group
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
from tests._csrc_host import build_host_libs
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
         "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
N_ENVS, BLOCK_ENVS, HORIZON = 256, 128, 10
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# the policy kernels' plain versions run hidden 64: at 64 envs each [A, 64, N]
# op stays below PyTorch's parallel grain, which keeps them quick on a loaded host
POLICY_ENVS, POLICY_BLOCK_ENVS = 64, 32


@pytest.fixture(scope="module")
def host_libs():
    return build_host_libs()


def _close(got, ref, label):
    for k, a, b in zip(label, got, ref):
        tol = dict(rtol=0, atol=0) if k == "act" else F32_TOL
        torch.testing.assert_close(a, b, msg=k, **tol)


# generic_physics divides each agent's force by its own mass (dt / mass
# rounded once), as generic_physics_block does: two cases with other masses
ROLLOUT_CASES = ([pytest.param(name, None, id=name) for name in NAMES]
                 + [pytest.param(name, [2.5, 0.75], id=f"{name}-masses")
                    for name in ("simple_reference", "simple_push")])


def _host_rollout(lib, kscn, n_envs, block_envs, n_steps, group):
    """K2 (``mpe_scenario_rollout``) with ``group`` threads per env lane, seed
    7, block offset 1 -> (pos, vel, rew_sum, obs_sum)."""
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    shapes = ((spec.n_entities, 2, n_envs),) * 2 + ((kscn.reward_rows, n_envs), (1, n_envs))
    got = [torch.empty(s) for s in shapes]
    rc = lib.mpe_scenario_rollout(scenario, ctypes.byref(params), *(x.data_ptr() for x in got),
                                  n_envs, block_envs, n_steps, HORIZON, 7, 1, group, None)
    assert rc == 0
    return got


@pytest.mark.parametrize("name, masses", ROLLOUT_CASES)
def test_host_built_rollout_kernel_matches_plain(host_libs, name, masses):
    """K2 (``mpe_scenario_rollout``) over 30 steps with resets, two RNG blocks
    at block offset 1, with the group ``rollout_group`` picks at this size;
    the obs checksum within 1e-5 of its largest."""
    kscn = kernel_scenario(name)
    spec = kscn.spec
    if masses is not None:
        mass = spec.initial_mass.copy()
        mass[:spec.n_agents] = masses
        spec = dataclasses.replace(spec, initial_mass=mass)
        kscn = type(kscn)(spec)
    group = rollout_group(kscn, N_ENVS)
    assert group == {"simple_spread": 4, "simple_tag": 8, "simple_world_comm": 8}.get(name, 1)
    got = _host_rollout(host_libs["mpe_kernels.cu"], kscn, N_ENVS, BLOCK_ENVS, 30, group)
    ref = plain_rollout(kscn, N_ENVS, 30, HORIZON, BLOCK_ENVS, 7, 1, "cpu")
    _close(got[:3], ref[:3], ("pos", "vel", "rew_sum"))
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5 * float(ref[3].abs().max()),
                               msg="obs_sum")


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_host_built_grouped_rollout_equals_one_thread_per_lane(host_libs, name, group):
    """K2 with an env lane split over ``group`` threads equals K2 with one
    thread per lane bit for bit (pos, vel, rew_sum and the obs checksum):
    each agent's moves and comm, each pair's force and each agent's obs sum
    move to a rank and come back in the per-lane order. 60 envs in two RNG
    blocks (at groups 1, 2 and 4 the last warp runs padding lanes), 25 steps
    with resets."""
    kscn = kernel_scenario(name)
    lib = host_libs["mpe_kernels.cu"]
    one = _host_rollout(lib, kscn, 60, 30, 25, 1)
    split = _host_rollout(lib, kscn, 60, 30, 25, group)
    for label, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), split, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=label)


@pytest.mark.parametrize("name", NAMES)
def test_host_built_trajectory_kernel_matches_plain(host_libs, name):
    """K3 (``mpe_trajectory``) over 24 steps in chunks of 4 with resets, two
    RNG blocks at block offset 1, at ``traj_group``'s threads per lane."""
    kscn = kernel_scenario(name)
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    a, n_steps, t_chunk = spec.n_agents, 24, 4
    shapes = ((n_steps, a, kscn.obs_w, N_ENVS), (n_steps, a, kscn.n_logits, N_ENVS),
              (n_steps, kscn.reward_rows, N_ENVS)) + ((spec.n_entities, 2, N_ENVS),) * 2
    got = [torch.empty(s) for s in shapes]
    rc = host_libs["mpe_trajectory.cu"].mpe_trajectory(
        scenario, ctypes.byref(params), *(x.data_ptr() for x in got), N_ENVS, BLOCK_ENVS,
        n_steps // t_chunk, t_chunk, HORIZON, 3, 1, traj_group(kscn, N_ENVS), None)
    assert rc == 0
    ref = plain_trajectory(kscn, N_ENVS, n_steps, HORIZON, BLOCK_ENVS, t_chunk, 3, 1, "cpu")
    _close(got, ref, ("obs", "act", "rew", "pos", "vel"))


def _policy_weights(kscn, seed=0):
    """An init_policy actor of the scenario's widths (He-scaled head, so the
    logits are O(1) and the actions follow the MLP), hidden 64, in the
    kernels' layout."""
    from mpe_tpu_torch.learner import init_policy

    return _kernel_weights(init_policy(torch.Generator().manual_seed(seed), kscn.obs_w,
                                       kscn.n_logits))


@pytest.mark.parametrize("name", NAMES)
def test_host_built_policy_traj_kernel_matches_plain(host_libs, name):
    """K5 (``mpe_policy_traj``) over 24 steps in chunks of 4 with resets, two
    RNG blocks at block offset 1: moves and comm indices equal."""
    kscn = kernel_scenario(name)
    scenario, params = _build.kernel_params(kscn)
    weights = _policy_weights(kscn)
    wbuf = _pack_weights(weights)                      # held until the call returns
    a, n, n_steps, t_chunk = kscn.spec.n_agents, POLICY_ENVS, 24, 4
    obs, last_obs = torch.empty((n_steps, a, kscn.obs_w, n)), torch.empty((a, kscn.obs_w, n))
    act = torch.empty((n_steps, a, n), dtype=torch.int32)
    cact = torch.empty_like(act) if kscn.uses_comm else None
    rew = torch.empty((n_steps, kscn.reward_rows, n))
    rc = host_libs["mpe_policy.cu"].mpe_policy_traj(
        scenario, ctypes.byref(params), wbuf.data_ptr(), obs.data_ptr(), act.data_ptr(),
        None if cact is None else cact.data_ptr(), rew.data_ptr(), last_obs.data_ptr(), n,
        POLICY_BLOCK_ENVS, n_steps // t_chunk, t_chunk, HORIZON, 3, 1, 8, None)
    assert rc == 0
    ref = plain_policy_trajectory(kscn, weights, n, n_steps, HORIZON, POLICY_BLOCK_ENVS, t_chunk,
                                  3, 1, "cpu")
    got = (obs, act, rew, last_obs) if cact is None else (obs, act, cact, rew, last_obs)
    labels = ("obs", "act", "rew", "last_obs") if cact is None else ("obs", "act", "cact", "rew",
                                                                    "last_obs")
    for k, x, y in zip(labels, got, ref):
        tol = dict(rtol=0, atol=0) if k in ("act", "cact") else F32_TOL
        torch.testing.assert_close(x, y, msg=k, **tol)
    if cact is not None:                    # the speakers' utterances vary
        assert len(torch.unique(cact)) == kscn.spec.dim_c


@pytest.mark.parametrize("name", NAMES)
def test_host_built_policy_rollout_kernel_matches_plain(host_libs, name):
    """K4 (``mpe_policy_rollout``) over 30 steps with resets, two RNG blocks
    at block offset 1: every reward row's return, final positions, episodes."""
    kscn = kernel_scenario(name)
    scenario, params = _build.kernel_params(kscn)
    weights = _policy_weights(kscn, 1)
    wbuf = _pack_weights(weights)                      # held until the call returns
    n = POLICY_ENVS
    got = (torch.empty((kscn.reward_rows, n)), torch.empty((kscn.spec.n_entities, 2, n)),
           torch.empty((1, n)))
    rc = host_libs["mpe_policy.cu"].mpe_policy_rollout(
        scenario, ctypes.byref(params), wbuf.data_ptr(), *(x.data_ptr() for x in got), n,
        POLICY_BLOCK_ENVS, 30, HORIZON, 8, 1, 8, None)
    assert rc == 0
    ref = plain_policy_rollout(kscn, weights, n, 30, HORIZON, POLICY_BLOCK_ENVS, 8, 1, "cpu")
    _close(got, ref, ("ret", "pos", "episodes"))


# K6 and K7 on a random epoch batch of every scenario's head and critic width:
# no comm, 3, 4 and 10 comm logits (a silent agent on simple_speaker_listener and
# simple_world_comm), the nine joint widths of the critic (4 to 204, the last
# in tiles of 64); the value clip binds
UPDATE_NAMES = NAMES
# ... and on a batch where both clips bind for about half of the samples
CLIP_NAMES = ["simple_spread", "simple_speaker_listener", "simple_reference",
              "simple_world_comm"]


def _epoch_batch(kscn, t: int, n: int, team: bool, seed: int = 0):
    """A random float32 epoch batch: obs ~ N(0, 1), one-hot moves and
    utterances, log-probs ~ N(-1.5, 0.3^2), old values ~ N(0, 0.3^2),
    normalized advantages, returns ~ N(-2, 1) (MPE's rewards are negative;
    returns centred on the values would make the value-bias gradient a sum
    that cancels to its float32 rounding); the team streams [T, N] for
    MAPPO."""
    spec = kscn.spec
    a, dim_c = spec.n_agents, kscn.n_comm
    gen = torch.Generator().manual_seed(seed)

    def onehot(k):
        idx = torch.randint(0, k, (t, a, n), generator=gen)
        return torch.nn.functional.one_hot(idx, k).movedim(-1, -2).float().contiguous()

    stream = (t, n) if team else (t, a, n)
    adv = torch.randn(stream, generator=gen)
    return (torch.randn((t, a, kscn.obs_w, n), generator=gen), onehot(5),
            onehot(dim_c) if dim_c else None, (-1.5 + 0.3 * torch.randn((t, a, n), generator=gen)),
            (adv - adv.mean()) / adv.std(correction=0), torch.randn(stream, generator=gen) - 2.0,
            0.3 * torch.randn(stream, generator=gen))


def _host_update(lib, fn, *args):
    """Call one of the update entries with float32 CPU tensors (None stays a
    null pointer)."""
    ptrs = [None if x is None else x.data_ptr() if torch.is_tensor(x) else x for x in args]
    assert getattr(lib, fn)(*ptrs) == 0


def _update_params(kscn, team: bool, hidden: int = 64):
    """init_ac (PPO) or init_mappo params of the scenario's widths, the
    policy head scaled to O(1) logits."""
    a, ow = kscn.spec.n_agents, kscn.obs_w
    init = init_mappo if team else init_ac
    params = init(torch.Generator().manual_seed(1), ow, 5 + kscn.n_comm, *((a,) if team else ()),
                  hidden=hidden)
    params["pi"]["w"] = params["pi"]["w"] * 100.0
    return params


def _logp_value(params, obs, mv_oh, cm_oh, speak, team: bool, compute_dtype=None):
    """The params' own log-prob of the batch's actions [T, A, N] and value
    ([T, A, N] for PPO, the critic's [T, N] on the joint obs for MAPPO), in
    the update's arithmetic (``compute_dtype=torch.bfloat16``: each product's
    operands rounded to bf16, as the update's forward rounds them)."""
    rnd = fused_update.compute_rounding(compute_dtype)[1]

    def mlp(w1, b1, w2, b2, w3, b3, x):
        h1 = torch.tanh(torch.einsum("ho,...on->...hn", rnd(w1), rnd(x)) + b1[:, None])
        h2 = torch.tanh(torch.einsum("gh,...hn->...gn", rnd(w2), rnd(h1)) + b2[:, None])
        return torch.einsum("kg,...gn->...kn", rnd(w3), rnd(h2)) + b3[:, None]

    if team:
        z = mlp(*fused_update._mlp_weights(params, ("a1", "a2", "pi"), torch.float32), obs)
        t, a, ow, n = obs.shape
        value = mlp(*fused_update._mlp_weights(params, ("c1", "c2", "v"), torch.float32),
                    obs.reshape(t, a * ow, n))[:, 0]
    else:
        z = mlp(*fused_update._update_weights(params, torch.float32), obs)
        value, z = z[..., -1, :], z[..., :-1, :]
    logp = (torch.log_softmax(z[..., :5, :], -2) * mv_oh).sum(-2)
    if cm_oh is not None:
        flags = torch.tensor([float(x) for x in speak])[:, None]
        logp = logp + (torch.log_softmax(z[..., 5:, :], -2) * cm_oh).sum(-2) * flags
    return logp.contiguous(), value.contiguous()


def _check_host_update(lib, kscn, kind: str, t: int, n: int, clip_binding: bool,
                       hidden: int = 64, compute_dtype=None, tol: float = 1e-4,
                       metric_rtol: float = 1e-4, clip_forward=None):
    """K6 (``mpe_ppo_update``) or K7 (``mpe_mappo_update``) of a library
    built at ``hidden`` over 3 CTAs on a random [t, A, *, n] epoch batch
    (``clip_binding``: its logp_old and v_old moved off the params' own by
    ``clip_binding_inputs`` from the params' own, in the arithmetic of
    ``clip_forward``, a compute dtype of ``_logp_value``) against the plain
    version with
    ``compute_dtype``: every gradient leaf within ``tol`` of its largest
    entry, the metric means within ``metric_rtol`` relative -> the largest
    leaf error over its largest entry."""
    spec = kscn.spec
    a, ow = spec.n_agents, kscn.obs_w
    dim_c = kscn.n_comm
    team = kind == "mappo"
    params = _update_params(kscn, team, hidden)
    obs, mv_oh, cm_oh, lpo, adv, ret, vold = _epoch_batch(kscn, t, n, team)
    speak = kscn.speak
    hp = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01)
    if clip_binding:
        logp, value = _logp_value(params, obs, mv_oh, cm_oh, speak, team, clip_forward)
        lpo, vold, shares = fused_update.clip_binding_inputs(
            logp, value, clip=hp["clip"], generator=torch.Generator().manual_seed(11))
        assert all(0.2 < x < 0.8 for x in shares), shares
    plain = fused_update.plain_mappo_update if team else fused_update.plain_ppo_update
    ref, ref_m = plain(params, obs, mv_oh, cm_oh, lpo, adv, ret, vold, speak=speak,
                       compute_dtype=compute_dtype, **hp)
    mask = fused_update.speak_bits(speak)
    n_parts = 3
    inv_b = 1.0 / (t * a * n)
    consts = (1.0 - hp["clip"], 1.0 + hp["clip"], hp["clip"])
    if team:
        aw = fused_update._mlp_weights(params, ("a1", "a2", "pi"), torch.float32)
        cw = fused_update._mlp_weights(params, ("c1", "c2", "v"), torch.float32)
        actor = fused_update._packed(ow, 5 + dim_c, hidden)
        critic = fused_update._packed(a * ow, 1, hidden)
        n_act, n_crit = fused_update._numel(actor), fused_update._numel(critic)
        assert (lib.mpe_update_packed_size(ow, 5 + dim_c), lib.mpe_update_packed_size(a * ow, 1)
                ) == (n_act, n_crit)
        out = torch.empty(n_act + n_crit)
        inv_bv = 1.0 / (t * n)
        _host_update(lib, "mpe_mappo_update", ow, dim_c, torch.cat([w.reshape(-1) for w in aw]),
                     torch.cat([w.reshape(-1) for w in cw]), obs, mv_oh, cm_oh, lpo, adv, ret,
                     vold, fused_update._partials(lib, n_parts, [(ow, dim_c, 1), (a * ow, 0, 2)],
                                                  [n_act, n_crit], "cpu"),
                     out, t, a, n, mask, n_parts,
                     *consts, hp["vf_coef"] * 2.0 * inv_bv, hp["ent_coef"] * inv_b, inv_b, inv_bv,
                     None)
        *ga, ms_a = fused_update._unpack(out[:n_act], actor)
        *gc, ms_c = fused_update._unpack(out[n_act:], critic)
        got = fused_update._layer_grads(("a1", "a2", "pi"), *ga)
        got.update(fused_update._layer_grads(("c1", "c2", "v"), *gc))
        got_m = (ms_a[0], ms_c[1], ms_a[2])
    else:
        layout = fused_update._packed(ow, 5 + dim_c + 1, hidden)
        assert lib.mpe_update_packed_size(ow, 5 + dim_c + 1) == fused_update._numel(layout)
        out = torch.empty(fused_update._numel(layout))
        weights = fused_update._update_weights(params, torch.float32)
        _host_update(lib, "mpe_ppo_update", ow, dim_c, torch.cat([w.reshape(-1) for w in weights]),
                     obs, mv_oh, cm_oh, lpo, adv, ret, vold,
                     fused_update._partials(lib, n_parts, [(ow, dim_c, 0)], [out.numel()], "cpu"),
                     out, t * a, n, a, mask, n_parts, *consts,
                     hp["vf_coef"] * 2.0 * inv_b, hp["ent_coef"] * inv_b, inv_b, None)
        *g, ms = fused_update._unpack(out, layout)
        got, got_m = fused_update._grads_tree(*g), (ms[0], ms[1], ms[2])
    for k in ref:
        for q in ref[k]:
            torch.testing.assert_close(got[k][q], ref[k][q], rtol=0,
                                       atol=tol * float(ref[k][q].abs().max()), msg=lambda m, k=k, q=q: f"{k}.{q}: {m}")
    torch.testing.assert_close(torch.stack(got_m), torch.stack(ref_m), rtol=metric_rtol, atol=0)
    return max(float((got[k][q] - ref[k][q]).abs().max() / ref[k][q].abs().max())
               for k in ref for q in ref[k])


@pytest.mark.parametrize("name", UPDATE_NAMES)
@pytest.mark.parametrize("kind", ["ppo", "mappo"])
def test_host_built_update_kernels_match_plain(host_libs, name, kind):
    """K6 (``mpe_ppo_update``) and K7 (``mpe_mappo_update``) over 3 CTAs on a
    batch of 96 envs (not a multiple of the tile: every tile is staged element
    by element, the last one ragged): every gradient leaf within 1e-4 of its
    largest entry, the metric means within 1e-4 relative."""
    _check_host_update(host_libs["mpe_update.cu"], kernel_scenario(name), kind, 2, 96, False)


@pytest.mark.parametrize("name", CLIP_NAMES)
@pytest.mark.parametrize("kind", ["ppo", "mappo"])
def test_host_built_update_kernels_match_plain_where_clips_bind(host_libs, name, kind):
    """K6 and K7 on a batch of 128 envs (whole tiles, staged in 16-byte
    pieces) whose logp_old and v_old make both clips bind for about half of
    the samples (``clip_binding_inputs``), held as above."""
    _check_host_update(host_libs["mpe_update.cu"], kernel_scenario(name), kind, 2, 128, True)


def _host_det(lib, kscn, inputs, n_envs, block_envs, n_steps, group):
    """K1 (``mpe_det_rollout``) with ``group`` threads per env lane ->
    (pos, vel, rew_sum, rew_last, obs_last)."""
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    shapes = ((spec.n_entities, 2, n_envs),) * 2 + ((kscn.reward_rows, n_envs),) * 2 + (
        (spec.n_agents, kscn.obs_w, n_envs),)
    got = [torch.empty(s) for s in shapes]
    rc = lib.mpe_det_rollout(scenario, ctypes.byref(params),
                             *(x.data_ptr() for x in (*inputs, *got)), n_envs, block_envs,
                             n_steps, group, None)
    assert rc == 0
    return got


@pytest.mark.parametrize("name", NAMES)
def test_host_built_det_rollout_kernel_matches_plain(host_libs, name):
    """K1 (``mpe_det_rollout``) over 20 steps from make_det_inputs, two RNG
    blocks drawing the same moves, with the group ``det_group`` picks at this
    size."""
    kscn = kernel_scenario(name)
    inputs = make_det_inputs(name, N_ENVS, seed=5, device="cpu")
    got = _host_det(host_libs["mpe_kernels.cu"], kscn, inputs, N_ENVS, BLOCK_ENVS, 20,
                    det_group(kscn, N_ENVS))
    ref = plain_det_rollout_blocked(name, 20, BLOCK_ENVS)(*inputs)
    _close(got, ref, ("pos", "vel", "rew_sum", "rew", "obs"))


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("name", ["simple_spread", "simple_tag", "simple_world_comm"])
def test_host_built_grouped_det_rollout_equals_one_thread_per_lane(host_libs, name, group):
    """K1 with an env lane split over ``group`` threads equals K1 with one
    thread per lane bit for bit (pos, vel, rew_sum, rew_last, obs_last) on the
    three scenarios with collide pairs: each agent's moves (hash_uniform_2d's
    stream) and each pair's force move to a rank and come back in the
    per-lane order. 60 envs in two RNG blocks (at groups 2 and 4 the last warp
    runs padding lanes), 20 steps."""
    kscn = kernel_scenario(name)
    lib = host_libs["mpe_kernels.cu"]
    inputs = make_det_inputs(name, 60, seed=4, device="cpu")
    one = _host_det(lib, kscn, inputs, 60, 30, 20, 1)
    split = _host_det(lib, kscn, inputs, 60, 30, 20, group)
    for label, a, b in zip(("pos", "vel", "rew_sum", "rew_last", "obs_last"), split, one):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=label)


def _maddpg_params(kscn, seed=0, hidden: int = 64):
    """init_maddpg actors and critics of the scenario's widths, hidden 64
    unless given, the actors' head scaled to O(1) logits."""
    params = init_maddpg(torch.Generator().manual_seed(seed), kscn.obs_w, kscn.n_logits,
                         kscn.spec.n_agents, hidden=hidden)
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    return params


@pytest.mark.parametrize("name", NAMES)
def test_host_built_maddpg_traj_kernel_matches_plain(host_libs, name):
    """K8 (``mpe_maddpg_traj``) over 12 steps in chunks of 4 with resets,
    eps 0.1, two RNG blocks at block offset 1, both output forms: the action
    one-hots equal, the rest within float32 tolerances."""
    kscn = kernel_scenario(name)
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    a, ow, aw, n = spec.n_agents, kscn.obs_w, kscn.n_logits, POLICY_ENVS
    n_steps, t_chunk, eps = 12, 4, 0.1
    weights = fused_maddpg._kernel_weights(_maddpg_params(kscn)["actor"])
    wbuf = fused_maddpg._pack_weights(weights)
    tens = [torch.empty(s) for s in ((n_steps, a, ow, n), (n_steps, a, aw, n),
                                     (n_steps, kscn.reward_rows, n), (n_steps, a, ow, n))]
    rows = torch.empty((n_steps, n, a * (2 * ow + aw + 1)))
    lib = host_libs["mpe_maddpg.cu"]
    for ptrs in ([x.data_ptr() for x in tens] + [None], [None] * 4 + [rows.data_ptr()]):
        rc = lib.mpe_maddpg_traj(scenario, ctypes.byref(params), wbuf.data_ptr(), *ptrs, n,
                                 POLICY_BLOCK_ENVS, n_steps // t_chunk, t_chunk, 5, eps, 3, 1, 8,
                                 None)
        assert rc == 0
    args = (n, n_steps, 5, POLICY_BLOCK_ENVS, t_chunk, eps, 3, 1)
    ref = fused_maddpg.plain_maddpg_trajectory(kscn, weights, *args, device="cpu")
    _close(tens, ref, ("obs", "act", "rew", "obs2"))
    ref_rows = fused_maddpg.plain_maddpg_trajectory(kscn, weights, *args, emit_rows=True,
                                                    device="cpu")
    cols = torch.zeros(rows.shape[-1], dtype=torch.bool)
    cols[a * ow:a * (ow + aw)] = True
    torch.testing.assert_close(rows[..., cols], ref_rows[..., cols], rtol=0, atol=0)
    torch.testing.assert_close(rows[..., ~cols], ref_rows[..., ~cols], **F32_TOL)
    moves = tens[1][:, :, :5].argmax(2)
    assert len(torch.unique(moves)) == 5            # the actions vary


@pytest.mark.parametrize("name", NAMES)
def test_host_built_maddpg_update_kernel_matches_plain(host_libs, name):
    """K9 (``mpe_maddpg_update``: the target actions from shared memory, the
    TD targets, the register-tiled gradient, the reduce) on 40 random replay
    rows (two full tiles of 16 and a ragged one), weights packed by
    ``PackedLayout``: target actions per head equal, every gradient leaf of
    the flat gradient within 1e-4 of its largest entry, its padding 0, the
    metrics within 1e-4 relative."""
    _check_host_maddpg_update(host_libs["mpe_maddpg.cu"], kernel_scenario(name), 40)


def _check_host_maddpg_update(lib, kscn, batch: int, hidden: int = 64):
    """K9 of a library built at ``hidden`` on ``batch`` random replay rows
    (tiles of ``1024 / hidden`` samples; from hidden 128 of 32, on the
    backward kernel's CTA pairs), held as above, each of its kernels (four
    at 8-64, five from 128) counted once by the library -> (params, rows,
    partials: the scratch the launch left)."""
    scenario = _build.SCENARIO_IDS[type(kscn).__name__]
    a, o, k, mw = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits, 5
    cw, nh = k - mw, 2 if k > mw else 1
    params = _maddpg_params(kscn, 1, hidden)
    gen = torch.Generator().manual_seed(2)
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen) for w, x in layer.items()}
                   for q, layer in net.items()} for n, net in params.items()}
    idx = torch.randint(0, mw, (batch, a), generator=gen)
    act = torch.nn.functional.one_hot(idx, mw).float()
    if cw:
        act = torch.cat([act, torch.nn.functional.one_hot(
            torch.randint(0, cw, (batch, a), generator=gen), cw).float()], -1)
    rows = torch.cat([torch.randn((batch, a * o), generator=gen), act.reshape(batch, -1),
                      torch.randn((batch, a), generator=gen) - 2.0,
                      torch.randn((batch, a * o), generator=gen)], 1).contiguous()
    lay = fused_maddpg_update.PackedLayout(a, o, k, hidden)
    nwp, ncp, n_weights, ng, ts = (lib.mpe_maddpg_update_layout(scenario, q) for q in range(5))
    assert (nwp, ncp, n_weights, ng, ts) == (lay.nwp, lay.ncp, lay.n_weights,
                                             lay.nw + lay.nc + 3,
                                             1024 // hidden if hidden <= 64 else 32)
    wbuf = lay.pack(params, targets)
    act2 = torch.empty((a, nh, batch), dtype=torch.int32)
    y = torch.empty((a, batch))
    partials = torch.empty(fused_maddpg_update.partials_floats(lib, scenario, a, batch))
    grads, metrics = torch.empty(lay.off_ta), torch.empty(3)
    assert lib.mpe_maddpg_update_launched(-1) == 0
    _host_update(lib, "mpe_maddpg_update", scenario, wbuf, rows, act2, y, partials, grads, metrics,
                 batch, 0.95, 0.01, 1.0 / (a * batch), None)
    assert [lib.mpe_maddpg_update_launched(j) for j in range(5)] == \
        [1, 1, 1, 1, 1 if hidden > 64 else 0]
    ref, ref_m = fused_maddpg_update.plain_maddpg_update(params, targets, rows, mw=mw, gamma=0.95,
                                                         ent_coef=0.01)
    obs2 = rows[:, a * (o + k + 1):].reshape(batch, a, o)
    want_act2 = fused_maddpg_update.target_indices(
        fused_maddpg_update.target_logits(targets["actor"], obs2), mw)
    torch.testing.assert_close(act2.long(), want_act2.permute(1, 2, 0), rtol=0, atol=0)
    actor, critic = lay.nets(grads)
    assert not actor[:, lay.nw:].any() and not critic[:, lay.nc:].any()
    got = {"actor": fused_maddpg_update._net_grads(actor, o, k, hidden),
           "critic": fused_maddpg_update._net_grads(critic, lay.j, 1, hidden)}
    for n in ref:
        for q in ref[n]:
            for w in ref[n][q]:
                torch.testing.assert_close(got[n][q][w], ref[n][q][w], rtol=0,
                                           atol=1e-4 * float(ref[n][q][w].abs().max()),
                                           msg=lambda m, n=n, q=q, w=w: f"{n}.{q}.{w}: {m}")
    torch.testing.assert_close(metrics, torch.stack(ref_m), rtol=1e-4, atol=0)
    return params, rows, partials

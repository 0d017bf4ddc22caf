"""Policy-in-the-loop fused rollouts: kernels K4 and K5 and their plain
PyTorch versions (counterpart of ``mpe_tpu/ops/fused_policy.py``), for the
nine kernel scenarios.

The shared 2-hidden-layer tanh MLP (``learner.pg.init_policy`` layout, or
the actor of ``init_ac``) runs on every agent's observation; a move is
sampled by Gumbel-max over its 5 move logits and, where the scenario has a
comm head (``5 + dim_c`` outputs), an utterance by Gumbel-max over the
``dim_c`` comm logits, zeroed for a silent agent. The env steps with the
utterances and resets each lane at the horizon:

- ``fused_policy_trajectory`` (K5, ``policy_traj_kernel<S>``) streams the
  on-policy batch: the obs each agent acted on ``[T, A, OW, N]``, the move
  indices ``[T, A, N]`` int32, the comm indices ``[T, A, N]`` int32 (comm
  scenarios only; 0 for a silent agent), the rewards ``[T, R, N]`` and the
  bootstrap obs ``[A, OW, N]``;
- ``fused_policy_rollout`` (K4, ``policy_rollout_kernel<S>``) evaluates a
  policy: per-lane returns of every reward row ``[R, N]``, final positions
  ``[E, P, N]`` and completed episodes ``[1, N]``.

On a CUDA device the builders launch the kernels in ``csrc/mpe_policy.cu``
(one body over ``csrc/scenario_blocks.cuh``, one C entry each; a CTA of 128
threads owns a tile of env lanes, ``policy_tile`` picks how many, and runs
the MLP of the tile's (agent, lane) rows as CTA-wide products); on the CPU
they run the plain versions. The RNG is the JAX kernels' interpret-mode
hash stream (``fused_rollout.make_uniform``): moves on call id 7, comm on
id 9; K5 salts it with the time-chunk index, so ``t_chunk`` is part of its
definition. Each layer of the plain MLP sums over its inputs in order and
then adds the bias (``_seq_dense``), the order the kernels use: Gumbel-max
turns a one-ulp change in a logit into another action, so the kernel and its
plain version are held to equal actions on the card. The kernels take the
hidden width from the weights: one library per width of
``_build.HIDDEN_WIDTHS`` (8, 16, 32, 64), built at its first use; another
width raises ``NotImplementedError`` before any launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops._build import DEFAULT_HIDDEN, check_hidden
from mpe_tpu_torch.ops.fused_rollout import (_MASK, make_lane_reset, make_uniform,
                                             pick_block_envs)

POLICY_TILES = (1, 2, 4, 8, 16, 32)  # env lanes per CTA (a tile) that K4 and K5 take
WARP = 32


def pick_tile(tiles, n_agents: int, n_envs: int, ctas_per_sm, sms: int,
              hidden: int = DEFAULT_HIDDEN) -> int:
    """The tile rule of K4, K5 and K8: the smallest of ``tiles`` whose CTAs
    all run at once (``ceil(n_envs / tile) <= sms * ctas_per_sm(tile)``, the
    CTAs one SM holds as the card reports them) and whose (agent, lane) rows
    give every item of a layer's product a thread of a full warp (an item is
    4 rows x 4 units: ``rows / 4 * hidden / 4 >= 32``, rows ``n_agents *
    tile`` rounded up to 4; at hidden 64 ``n_agents * tile >= 8``); the
    largest tile where none runs in one wave. Smaller tiles put more CTAs on
    an SM, so one tile's world step runs beside another's products (PERF.md
    §6)."""
    for tile in tiles:
        rows = n_agents * (-(-tile // 4) * 4)
        ctas = ctas_per_sm(tile)
        if rows * hidden >= 16 * WARP and ctas > 0 and -(-n_envs // tile) <= sms * ctas:
            return tile
    return max(t for t in tiles if ctas_per_sm(t) > 0)


@functools.cache
def _ctas_per_sm(source: str, hidden: int, entry: str, args: tuple, device_index: int) -> int:
    from mpe_tpu_torch.ops import _build

    with torch.cuda.device(device_index):
        n = getattr(_build.library(source, hidden), entry)(*args)
    if n < 0:
        raise RuntimeError(f"{entry}{args} failed: {_build.error_string(-n)}")
    return n


def tile_rule(tiles, kscn, n_envs: int, device, source: str, hidden: int, entry: str,
              *args) -> int:
    """``pick_tile`` on the CUDA ``device`` (``None``: the current one) with
    the CTAs per SM that the C entry ``entry(*args, tile)`` of ``source``
    built at ``hidden`` reports (cached per device)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return pick_tile(tiles, kscn.spec.n_agents, n_envs,
                     lambda t: _ctas_per_sm(source, hidden, entry, (*args, t), index), sms,
                     hidden)


def policy_tile(kscn, n_envs: int, kernel: str = "rollout", device=None,
                hidden: int = DEFAULT_HIDDEN) -> int:
    """K4's (``kernel="rollout"``) or K5's (``"traj"``) env lanes per CTA on
    the CUDA ``device`` (``None``: the current one) for an actor of hidden
    width ``hidden``, by ``pick_tile``. Every tile gives the same bits."""
    from mpe_tpu_torch.ops import _build

    return tile_rule(POLICY_TILES, kscn, n_envs, device, "mpe_policy.cu", hidden,
                     "mpe_policy_ctas_per_sm", _build.SCENARIO_IDS[type(kscn).__name__],
                     {"traj": 0, "rollout": 1}[kernel])


def _argmax_onehot(z, dim: int = 0):
    """Scores -> first-max one-hot along ``dim`` (the ``jnp.argmax``
    tie-break: every row ``>=`` the max, then only the first is kept)."""
    onehot = (z >= z.amax(dim, keepdim=True)).to(z.dtype)
    taken = torch.zeros_like(onehot.select(dim, 0))
    rows = []
    for r in range(z.shape[dim]):
        row = onehot.select(dim, r) * (1.0 - taken)
        taken = torch.clamp_max(taken + row, 1.0)
        rows.append(row)
    return torch.stack(rows, dim)


def _gumbel_onehot(logits, u, dim: int = 0):
    """Logits + U[0, 1) of the same shape -> one-hot categorical sample
    along ``dim``: argmax of ``logits - log(-log(u + 1e-12) + 1e-12)``."""
    return _argmax_onehot(logits - torch.log(-torch.log(u + 1e-12) + 1e-12), dim)


def _seq_dense(w, b, x):
    """``w [out, in] @ x [..., in, N] + b [out, 1]``, summed over ``in`` in
    order from the first product, then the bias: the kernels' order."""
    acc = w[:, 0:1] * x[..., 0:1, :]
    for k in range(1, w.shape[1]):
        acc = acc + w[:, k:k + 1] * x[..., k:k + 1, :]
    return acc + b


def _policy_sample(kscn, weights, obs, uniform, step: int):
    """obs [A, OW, N] -> (move one-hots [A, 5, N], comm one-hots [A, C, N]
    or None): MLP, then Gumbel-max with ``uniform((5, A*nb), step, 7)`` of the
    JAX kernel, whose element (row r, agent i, lane l) has hash index
    ``r*A*nb + i*nb + l``, and with a comm head over the comm logits with
    ``uniform((C, A*nb), step, 9)``, silent agents' rows zeroed."""
    w1, b1, w2, b2, w3, b3 = weights
    spec = kscn.spec
    a, mw, dim_c = spec.n_agents, kscn.n_moves, kscn.n_comm
    h = torch.tanh(_seq_dense(w1, b1, obs))
    h = torch.tanh(_seq_dense(w2, b2, h))
    logits = _seq_dense(w3, b3, h)                                   # [A, 5 + C, N]
    u = uniform((mw, a), step, 7).transpose(0, 1)                    # [A, 5, N]
    move = _gumbel_onehot(logits[:, :mw], u, dim=1)
    if not dim_c:
        return move, None
    uc = uniform((dim_c, a), step, 9).transpose(0, 1)                # [A, C, N]
    comm = _gumbel_onehot(logits[:, mw:], uc, dim=1)
    return move, torch.stack([comm[i] if speaks else torch.zeros_like(comm[i])
                              for i, speaks in enumerate(kscn.speak)])


def _onehot_index(onehot):
    """[A, K, N] one-hots -> [A, N] int32 indices (weighted row sum, exact
    for 0/1 values)."""
    idx = onehot[:, 1]
    for r in range(2, onehot.shape[1]):
        idx = idx + onehot[:, r] * float(r)
    return idx.to(torch.int32)


def _kernel_weights(params, device=None):
    """init_policy-layout params -> the kernels' weights: w [out, in] and
    b [out, 1], float32 (views where the params are float32 already:
    ``_pack_weights`` transposes w back, so a launch copies each weight
    once)."""
    def f32(x):
        return x.detach().to(device=device, dtype=torch.float32)

    return tuple(t for q in ("l1", "l2", "out")
                 for t in (f32(params[q]["w"]).T, f32(params[q]["b"])[:, None]))


def _pack_weights(weights) -> torch.Tensor:
    """The kernels' weight buffer (``csrc/policy_mlp.cuh::TileActor``): w1,
    w2 and w3 transposed ([in, out], the units of an input contiguous), each
    followed by its bias, padded with zeros to a multiple of 4 floats."""
    w1, b1, w2, b2, w3, b3 = weights
    flat = [w1.T.reshape(-1), b1.reshape(-1), w2.T.reshape(-1), b2.reshape(-1),
            w3.T.reshape(-1), b3.reshape(-1)]
    pad = -sum(x.numel() for x in flat) % 4
    return torch.cat(flat + ([w1.new_zeros(pad)] if pad else []))


def _resolve(scenario):
    from mpe_tpu_torch.core.state import ScenarioSpec
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, KernelSpread, kernel_scenario

    if isinstance(scenario, KernelScenario):
        return scenario
    if isinstance(scenario, ScenarioSpec):
        return KernelSpread(scenario)
    return kernel_scenario(scenario)


def _check_widths(kscn, params):
    w_in, w_out = params["l1"]["w"].shape[0], params["out"]["w"].shape[1]
    if (w_in, w_out) != (kscn.obs_w, kscn.n_logits):
        raise ValueError(f"policy maps {w_in} -> {w_out}; {kscn.spec.name!r} needs "
                         f"{kscn.obs_w} -> {kscn.n_logits}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def plain_policy_trajectory(kscn, weights, n_envs: int, n_steps: int, horizon: int,
                            block_envs: int, t_chunk: int, seed: int, block_offset: int = 0,
                            device=None):
    """The JAX ``_policy_traj_kernel`` over all RNG blocks at once -> (obs
    [T, A, OW, N], act [T, A, N] int32, [cact [T, A, N] int32 with a comm
    head,] rew [T, R, N], last_obs [A, OW, N]). Every lane starts at t = 0
    and resets on the shared horizon, so one step counter serves all lanes."""
    spec = kscn.spec
    a, n_blocks = spec.n_agents, n_envs // block_envs
    f32 = torch.float32
    obs_out = torch.empty((n_steps, a, kscn.obs_w, n_envs), dtype=f32, device=device)
    act_out = torch.empty((n_steps, a, n_envs), dtype=torch.int32, device=device)
    cact_out = torch.empty_like(act_out) if kscn.uses_comm else None
    rew_out = torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=f32, device=device)
    t = 0
    for chunk in range(n_steps // t_chunk):
        uniform = make_uniform(seed, block_offset, n_blocks, block_envs, chunk, device=device)
        init, fresh = make_lane_reset(kscn, uniform)
        if chunk == 0:
            pos, vel, obs, goal, _ = init()
        for step in range(t_chunk):
            ts = chunk * t_chunk + step
            move, comm = _policy_sample(kscn, weights, obs, uniform, step)
            pos, vel = kscn.physics(pos, vel, move)
            rew, obs_next = kscn.reward_obs(pos, vel, comm, goal)
            obs_out[ts], act_out[ts], rew_out[ts] = obs, _onehot_index(move), rew
            if comm is not None:
                cact_out[ts] = _onehot_index(comm)
            t += 1
            if t >= horizon:
                pos, obs, goal = fresh(step, vel)
                vel, t = torch.zeros_like(vel), 0
            else:
                obs = obs_next
    if cact_out is None:
        return obs_out, act_out, rew_out, obs
    return obs_out, act_out, cact_out, rew_out, obs


def plain_policy_rollout(kscn, weights, n_envs: int, n_steps: int, horizon: int,
                         block_envs: int, seed: int, block_offset: int = 0, device=None):
    """The JAX ``_policy_rollout_kernel`` over all RNG blocks at once ->
    (ret [R, N], pos [E, P, N], episodes [1, N]), float32."""
    uniform = make_uniform(seed, block_offset, n_envs // block_envs, block_envs, device=device)
    init, fresh = make_lane_reset(kscn, uniform)
    pos, vel, obs, goal, _ = init()
    ret = torch.zeros((kscn.reward_rows, n_envs), dtype=torch.float32, device=device)
    eps = torch.zeros((1, n_envs), dtype=torch.float32, device=device)
    t = 0
    for step in range(n_steps):
        move, comm = _policy_sample(kscn, weights, obs, uniform, step)
        pos, vel = kscn.physics(pos, vel, move)
        rew, obs = kscn.reward_obs(pos, vel, comm, goal)
        ret = ret + rew
        t += 1
        if t >= horizon:
            eps = eps + 1.0
            pos, obs, goal = fresh(step, vel)
            vel, t = torch.zeros_like(vel), 0
    return ret, pos, eps


# ---------------------------------------------------------------------------
# kernels K5 and K4
# ---------------------------------------------------------------------------

def _kernel_args(kscn, weights, n_envs, n_steps, horizon, block_envs, device, tile=None,
                 kernel="rollout"):
    """Checks shared by both wrappers -> (scenario id, constants, weight
    buffer, tile, hidden width). Raises before any launch on what the kernels
    do not compute (a hidden width outside ``HIDDEN_WIDTHS`` first); ``tile``
    None takes ``policy_tile`` of ``kernel``."""
    from mpe_tpu_torch.ops import _build

    shapes = [tuple(w.shape) for w in weights]
    hidden = check_hidden(shapes[0][0], "the policy kernels")
    if tile is not None and tile not in POLICY_TILES:
        raise ValueError(f"tile={tile}: the policy kernels take {POLICY_TILES} env lanes per CTA")
    if device.type != "cuda":
        raise ValueError(f"the policy kernels need a CUDA device, got {device}")
    if n_envs <= 0 or n_envs % block_envs:
        raise ValueError(f"n_envs={n_envs} must be a positive multiple of block_envs={block_envs}")
    if n_steps < 0 or horizon < 1:
        raise ValueError(f"need n_steps >= 0 and horizon >= 1, got {n_steps}, {horizon}")
    ow, k = kscn.obs_w, kscn.n_logits
    want = [(hidden, ow), (hidden, 1), (hidden, hidden), (hidden, 1), (k, hidden), (k, 1)]
    if shapes != want:
        raise ValueError(f"{kscn.spec.name!r} takes an {ow}-{hidden}-{hidden}-{k} MLP; got "
                         f"weight shapes {shapes}")
    scenario, params = _build.kernel_params(kscn)
    if tile is None:
        tile = policy_tile(kscn, n_envs, kernel, device, hidden)
    return scenario, params, _pack_weights([w.to(device=device, dtype=torch.float32)
                                            for w in weights]), tile, hidden


def policy_traj_cuda(kscn, weights, n_envs: int, n_steps: int, horizon: int, block_envs: int,
                     t_chunk: int, seed: int, block_offset: int = 0, device=None,
                     tile: int | None = None):
    """Launch kernel K5 (``policy_traj_kernel<S>``) on ``device`` with
    ``tile`` env lanes per CTA (``None`` takes ``policy_tile``): the outputs
    of ``plain_policy_trajectory``, the same for every tile. Counts launches
    in ``.launches`` and, by scenario name, in ``.launches_by``."""
    from mpe_tpu_torch.ops import _build

    device = torch.device(device)
    if t_chunk < 1 or n_steps % t_chunk:
        raise ValueError(f"n_steps={n_steps} must be a multiple of t_chunk={t_chunk}")
    scenario, params, wbuf, tile, hidden = _kernel_args(kscn, weights, n_envs, n_steps, horizon,
                                                        block_envs, device, tile, "traj")
    a, ow = kscn.spec.n_agents, kscn.obs_w
    obs = torch.empty((n_steps, a, ow, n_envs), dtype=torch.float32, device=device)
    act = torch.empty((n_steps, a, n_envs), dtype=torch.int32, device=device)
    cact = torch.empty_like(act) if kscn.uses_comm else None
    rew = torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=torch.float32, device=device)
    last_obs = torch.empty((a, ow, n_envs), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library("mpe_policy.cu", hidden).mpe_policy_traj(
            scenario, ctypes.byref(params), wbuf.data_ptr(), obs.data_ptr(), act.data_ptr(),
            None if cact is None else cact.data_ptr(), rew.data_ptr(), last_obs.data_ptr(),
            n_envs, block_envs, n_steps // t_chunk, t_chunk, horizon, int(seed) & _MASK,
            int(block_offset) & _MASK, tile, stream)
    if rc != 0:
        raise RuntimeError(f"policy_traj_kernel launch failed: {_build.error_string(rc)}")
    policy_traj_cuda.launches += 1
    policy_traj_cuda.launches_by[kscn.spec.name] += 1
    if cact is None:
        return obs, act, rew, last_obs
    return obs, act, cact, rew, last_obs


policy_traj_cuda.launches = 0
policy_traj_cuda.launches_by = collections.Counter()


def policy_rollout_cuda(kscn, weights, n_envs: int, n_steps: int, horizon: int, block_envs: int,
                        seed: int, block_offset: int = 0, device=None, tile: int | None = None):
    """Launch kernel K4 (``policy_rollout_kernel<S>``) on ``device`` with
    ``tile`` env lanes per CTA (``None`` takes ``policy_tile``): the outputs
    of ``plain_policy_rollout``, the same for every tile. Counts launches in
    ``.launches`` and, by scenario name, in ``.launches_by``."""
    from mpe_tpu_torch.ops import _build

    device = torch.device(device)
    scenario, params, wbuf, tile, hidden = _kernel_args(kscn, weights, n_envs, n_steps, horizon,
                                                        block_envs, device, tile)
    spec = kscn.spec
    ret = torch.empty((kscn.reward_rows, n_envs), dtype=torch.float32, device=device)
    pos = torch.empty((spec.n_entities, spec.dim_p, n_envs), dtype=torch.float32, device=device)
    eps = torch.empty((1, n_envs), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library("mpe_policy.cu", hidden).mpe_policy_rollout(
            scenario, ctypes.byref(params), wbuf.data_ptr(), ret.data_ptr(), pos.data_ptr(),
            eps.data_ptr(), n_envs, block_envs, n_steps, horizon, int(seed) & _MASK,
            int(block_offset) & _MASK, tile, stream)
    if rc != 0:
        raise RuntimeError(f"policy_rollout_kernel launch failed: {_build.error_string(rc)}")
    policy_rollout_cuda.launches += 1
    policy_rollout_cuda.launches_by[spec.name] += 1
    return ret, pos, eps


policy_rollout_cuda.launches = 0
policy_rollout_cuda.launches_by = collections.Counter()


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def fused_policy_trajectory(scenario, params, n_envs: int, n_steps: int, horizon: int = 100,
                            block_envs: int = 1024, t_chunk: int = 8, device=None):
    """Build ``run(seed, params, block_offset=0) -> (obs [T, A, OW, N], act
    [T, A, N] int32, [cact [T, A, N] int32 if the scenario has a comm head,]
    rew [T, R, N], last_obs [A, OW, N])``: the on-policy batch, collected by
    kernel K5 on CUDA and by ``plain_policy_trajectory`` on the CPU;
    ``run.plain`` is the plain version on the same device, ``run.has_comm``
    whether ``cact`` is there. ``obs[t]`` is the obs the policy acted on at
    step t; done flags are ``(t + 1) % horizon == 0`` for every lane.
    ``params`` (init_policy layout) fixes the widths; pass the current params
    at each call."""
    kscn = _resolve(scenario)
    _check_widths(kscn, params)
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    if t_chunk < 1 or n_steps % t_chunk:
        raise ValueError(f"n_steps={n_steps} must be a multiple of t_chunk={t_chunk}")
    args = (n_envs, n_steps, horizon, block_envs, t_chunk)

    def plain(seed, params, block_offset=0):
        return plain_policy_trajectory(kscn, _kernel_weights(params, device), *args, seed,
                                       block_offset, device)

    def run(seed, params, block_offset=0):
        if device.type == "cuda":
            return policy_traj_cuda(kscn, _kernel_weights(params, device), *args, seed,
                                    block_offset, device)
        return plain(seed, params, block_offset)

    run.plain = plain
    run.has_comm = bool(kscn.uses_comm)
    return run


def fused_policy_rollout(scenario_or_spec, params, n_envs: int, n_steps: int,
                         horizon: int = 100, block_envs: int = 1024, device=None):
    """Build ``run(seed, params, block_offset=0) -> (returns [R, N], pos
    [E, P, N], episodes [1, N])``: a policy evaluation, by kernel K4 on CUDA
    and by ``plain_policy_rollout`` on the CPU; ``run.plain`` is the plain
    version on the same device."""
    kscn = _resolve(scenario_or_spec)
    _check_widths(kscn, params)
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    args = (n_envs, n_steps, horizon, block_envs)

    def plain(seed, params, block_offset=0):
        return plain_policy_rollout(kscn, _kernel_weights(params, device), *args, seed,
                                    block_offset, device)

    def run(seed, params, block_offset=0):
        if device.type == "cuda":
            return policy_rollout_cuda(kscn, _kernel_weights(params, device), *args, seed,
                                       block_offset, device)
        return plain(seed, params, block_offset)

    run.plain = plain
    return run

"""Fused MADDPG replay collection: kernel K8 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_maddpg.py``), on the nine scenarios.

Every agent has its own actor (``learner.maddpg.init_maddpg``'s ``actor``,
each leaf stacked on a leading agent axis), with a head of 5 move logits and,
where the scenario speaks, ``dim_c`` comm logits (``KernelScenario.n_logits``,
``learner.maddpg.maddpg_act_dim``). Per step, each agent's MLP runs on its
obs, and each head draws by Gumbel-max over its logits and, with probability
``eps_greedy``, takes a uniform one-hot instead; the env steps with the
silent agents' comm zeroed (the decoder's semantics) and lanes reset at the
horizon. The stored transition is (obs, action one-hots ``[move | comm]``
with the RAW comm sample, a silent agent's included, reward, the TRUE next
obs before any reset), so TD targets bootstrap through the time limit. The
obs an agent acts on reads the utterances of the step before (zero at the
start and after a reset).

- tensor form: ``(obs [T, A, OW, N], act [T, A, 5 + C, N] one-hot float32,
  rew [T, R, N], obs2 [T, A, OW, N])``;
- rows form (``emit_rows=True``): the finished replay rows ``[T, N, W]``,
  ``W = A*(2*OW + 5 + C + 1)``, row ``[obs | act | rew per agent | obs2]``
  flattened agent-major (``learner.maddpg.Buffer``'s layout), a shared
  reward broadcast to every agent.

On a CUDA device the builder launches ``maddpg_traj_kernel<S>``
(``csrc/mpe_maddpg.cu``, one instantiation per scenario struct of
``csrc/scenario_blocks.cuh``; a CTA of 128 threads owns a tile of env lanes,
``maddpg_tile`` picks how many, runs the agents' actors on the tile's
(agent, lane) rows as CTA-wide products and writes the rows form as
contiguous rows; the actors sit in its shared memory up to hidden 64 and are
read from device memory at 128 and 256); on the CPU it runs
``plain_maddpg_trajectory``.
The RNG is the JAX kernels' interpret-mode hash stream with the time-chunk
salt, as in K5: agent i draws on call ids ``28 + 6i`` (the move head's
Gumbel draw of ``uniform((5, n))``), ``29 + 6i`` (the eps one-hot's Gumbel
draw) and ``30 + 6i`` (the eps coin ``uniform((1, n)) < eps``), and its comm
head on ``31 + 6i`` to ``33 + 6i`` likewise, so the kernel, its plain
version and JAX interpret mode draw the same bits. Each layer of the plain
MLP sums in the kernel's order (``_seq_dense_agents``), so the two take the
same actions on the card.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops._build import DEFAULT_HIDDEN, check_hidden
from mpe_tpu_torch.ops.fused_policy import _gumbel_onehot, _resolve, tile_rule
from mpe_tpu_torch.ops.fused_rollout import _MASK, make_lane_reset, make_uniform, pick_block_envs

MADDPG_TILES = (1, 2, 4, 8)          # env lanes per CTA that K8 takes (8: world_comm's 209 KB)


def maddpg_tile(kscn, n_envs: int, device=None, hidden: int = DEFAULT_HIDDEN) -> int:
    """K8's env lanes per CTA on the CUDA ``device`` (``None``: the current
    one) for actors of hidden width ``hidden``, by ``fused_policy.pick_tile``.
    Every tile gives the same bits."""
    from mpe_tpu_torch.ops import _build

    return tile_rule(MADDPG_TILES, kscn, n_envs, device, "mpe_maddpg.cu", hidden,
                     "mpe_maddpg_traj_ctas_per_sm", _build.SCENARIO_IDS[type(kscn).__name__])


def _kernel_weights(actor_params, device=None):
    """Stacked actor params (leaves [A, in, out] and [A, out]) -> per-agent
    kernel layout: w [A, out, in] and b [A, out, 1], float32 (views where
    the params are float32 already; ``_pack_weights`` copies once)."""
    def f32(x):
        return x.detach().to(device=device, dtype=torch.float32)

    return tuple(t for q in ("l1", "l2", "out")
                 for t in (f32(actor_params[q]["w"]).transpose(1, 2),
                           f32(actor_params[q]["b"])[..., None]))


def _pack_weights(weights) -> torch.Tensor:
    """K8's weight buffer: each agent's actor in the policy kernels' layout
    (``fused_policy._pack_weights``: w1, w2, w3 transposed, each followed by
    its bias, padded to a multiple of 4 floats), one after another."""
    w1, b1, w2, b2, w3, b3 = weights
    a = w1.shape[0]
    flat = [x.reshape(a, -1) for x in (w1.transpose(1, 2), b1, w2.transpose(1, 2), b2,
                                        w3.transpose(1, 2), b3)]
    pad = -sum(x.shape[1] for x in flat) % 4
    return torch.cat(flat + ([w1.new_zeros((a, pad))] if pad else []), 1).reshape(-1)


def _seq_dense_agents(w, b, x):
    """Per-agent ``w [A, out, in] @ x [A, in, N] + b [A, out, 1]``, summed
    over ``in`` in order from the first product, then the bias: the
    kernels' order (``fused_policy._seq_dense`` for every agent at once)."""
    acc = w[..., 0:1] * x[:, 0:1, :]
    for k in range(1, w.shape[-1]):
        acc = acc + w[..., k:k + 1] * x[:, k:k + 1, :]
    return acc + b


def _peragent_sample(kscn, weights, obs, uniform, step: int, eps_greedy: float):
    """obs [A, OW, N] -> (raw action one-hots [A, 5 + C, N], the dynamics'
    comm [A, C, N] or None): per-agent MLPs, then per head a Gumbel-max draw
    (move: call id ``28 + 6i``, comm: ``31 + 6i``) eps-mixed with a uniform
    one-hot (the next two ids); the dynamics' comm has silent agents'
    rows zeroed."""
    w1, b1, w2, b2, w3, b3 = weights
    mw, dim_c = kscn.n_moves, kscn.n_comm
    h = torch.tanh(_seq_dense_agents(w1, b1, obs))
    h = torch.tanh(_seq_dense_agents(w2, b2, h))
    logits = _seq_dense_agents(w3, b3, h)                               # [A, 5 + C, N]

    def head(z, width: int, call: int):
        samp = _gumbel_onehot(z, uniform((width,), step, call))
        if eps_greedy > 0.0:
            rand = _gumbel_onehot(torch.zeros_like(z), uniform((width,), step, call + 1))
            take = (uniform((1,), step, call + 2) < eps_greedy).to(z.dtype)
            samp = take * rand + (1.0 - take) * samp
        return samp

    rows, comm_rows = [], []
    for i in range(kscn.spec.n_agents):
        base = 28 + 6 * i
        move = head(logits[i, :mw], mw, base)
        if not dim_c:
            rows.append(move)
            continue
        comm = head(logits[i, mw:], dim_c, base + 3)
        rows.append(torch.cat([move, comm]))
        comm_rows.append(comm if kscn.speak[i] else torch.zeros_like(comm))
    return torch.stack(rows), (torch.stack(comm_rows) if dim_c else None)


def _rows(kscn, obs, act, rew, obs2):
    """One step's (obs [A, OW, N], act [A, 5 + C, N], rew [R, N], obs2) ->
    replay rows [N, W]."""
    a, n = kscn.spec.n_agents, obs.shape[-1]
    rew_a = rew.expand(a, n) if rew.shape[0] == 1 else rew
    return torch.cat([obs.reshape(-1, n), act.reshape(-1, n), rew_a, obs2.reshape(-1, n)]).T


def plain_maddpg_trajectory(kscn, weights, n_envs: int, n_steps: int, horizon: int,
                            block_envs: int, t_chunk: int, eps_greedy: float, seed: int,
                            block_offset: int = 0, emit_rows: bool = False, device=None):
    """The JAX ``_maddpg_traj_kernel`` over all RNG blocks at once, float32
    (see the module docstring for both output forms). Every lane starts at
    t = 0 and resets on the shared horizon."""
    spec = kscn.spec
    a, n_blocks = spec.n_agents, n_envs // block_envs
    mw, aw = kscn.n_moves, kscn.n_logits
    f32 = torch.float32
    if emit_rows:
        rows_out = torch.empty((n_steps, n_envs, a * (2 * kscn.obs_w + aw + 1)), dtype=f32,
                               device=device)
    else:
        obs_out = torch.empty((n_steps, a, kscn.obs_w, n_envs), dtype=f32, device=device)
        act_out = torch.empty((n_steps, a, aw, n_envs), dtype=f32, device=device)
        rew_out = torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=f32, device=device)
        obs2_out = torch.empty_like(obs_out)
    t = 0
    for chunk in range(n_steps // t_chunk):
        uniform = make_uniform(seed, block_offset, n_blocks, block_envs, chunk, device=device)
        init, fresh = make_lane_reset(kscn, uniform)
        if chunk == 0:
            pos, vel, obs, goal, _ = init()
        for step in range(t_chunk):
            ts = chunk * t_chunk + step
            act, comm = _peragent_sample(kscn, weights, obs, uniform, step, eps_greedy)
            pos, vel = kscn.physics(pos, vel, act[:, :mw])
            rew, obs_next = kscn.reward_obs(pos, vel, comm, goal)
            if emit_rows:
                rows_out[ts] = _rows(kscn, obs, act, rew, obs_next)
            else:
                obs_out[ts], act_out[ts], rew_out[ts], obs2_out[ts] = obs, act, rew, obs_next
            t += 1
            if t >= horizon:
                pos, obs, goal = fresh(step, vel)
                vel, t = torch.zeros_like(vel), 0
            else:
                obs = obs_next
    return rows_out if emit_rows else (obs_out, act_out, rew_out, obs2_out)


def maddpg_traj_cuda(kscn, weights, n_envs: int, n_steps: int, horizon: int, block_envs: int,
                     t_chunk: int, eps_greedy: float, seed: int, block_offset: int = 0,
                     emit_rows: bool = False, device=None, tile: int | None = None):
    """Launch kernel K8 (``maddpg_traj_kernel<S>``) on ``device`` with
    ``tile`` env lanes per CTA (``None`` takes ``maddpg_tile``): the outputs
    of ``plain_maddpg_trajectory``, the same for every tile. Counts launches
    in ``.launches`` and, by scenario name, in ``.launches_by``."""
    from mpe_tpu_torch.ops import _build

    if tile is not None and tile not in MADDPG_TILES:
        raise ValueError(f"tile={tile}: the MADDPG collection kernel takes {MADDPG_TILES} env "
                         "lanes per CTA")
    hidden = check_hidden(weights[0].shape[-2], "the MADDPG collection kernels",
                          "mpe_maddpg.cu")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the MADDPG collection kernel needs a CUDA device, got {device}")
    if n_envs <= 0 or n_envs % block_envs:
        raise ValueError(f"n_envs={n_envs} must be a positive multiple of block_envs={block_envs}")
    if n_steps < 0 or horizon < 1 or t_chunk < 1 or n_steps % t_chunk:
        raise ValueError(f"need n_steps >= 0 a multiple of t_chunk >= 1 and horizon >= 1, got "
                         f"{n_steps}, {t_chunk}, {horizon}")
    spec = kscn.spec
    a, ow, aw = spec.n_agents, kscn.obs_w, kscn.n_logits
    shapes = [tuple(w.shape) for w in weights]
    want = [(a, hidden, ow), (a, hidden, 1), (a, hidden, hidden), (a, hidden, 1),
            (a, aw, hidden), (a, aw, 1)]
    if shapes != want:
        raise NotImplementedError(f"the MADDPG collection kernel is built for {a} agents' "
                                  f"{ow}-{hidden}-{hidden}-{aw} actors on {spec.name!r}; got "
                                  f"weight shapes {shapes}")
    scenario, params = _build.kernel_params(kscn)
    if tile is None:
        tile = maddpg_tile(kscn, n_envs, device, hidden)
    wbuf = _pack_weights([w.to(device=device, dtype=torch.float32) for w in weights])
    f32 = torch.float32
    if emit_rows:
        outs = (torch.empty((n_steps, n_envs, a * (2 * ow + aw + 1)), dtype=f32, device=device),)
        ptrs = (None, None, None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty((n_steps, a, ow, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, a, aw, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, kscn.reward_rows, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, a, ow, n_envs), dtype=f32, device=device))
        ptrs = tuple(x.data_ptr() for x in outs) + (None,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library("mpe_maddpg.cu", hidden).mpe_maddpg_traj(
            scenario, ctypes.byref(params), wbuf.data_ptr(), *ptrs, n_envs, block_envs,
            n_steps // t_chunk, t_chunk, horizon, float(eps_greedy), int(seed) & _MASK,
            int(block_offset) & _MASK, tile, stream)
    if rc != 0:
        raise RuntimeError(f"maddpg_traj_kernel launch failed: {_build.error_string(rc)}")
    maddpg_traj_cuda.launches += 1
    maddpg_traj_cuda.launches_by[spec.name] += 1
    return outs[0] if emit_rows else outs


maddpg_traj_cuda.launches = 0
maddpg_traj_cuda.launches_by = collections.Counter()


def fused_maddpg_trajectory(scenario, actor_params, n_envs: int, n_steps: int,
                            horizon: int = 25, eps_greedy: float = 0.1, block_envs: int = 1024,
                            t_chunk: int = 8, emit_rows: bool = False, device=None):
    """Build ``run(seed, actor_params, block_offset=0)``: a chunk of MADDPG
    replay transitions in the tensor or the rows form (module docstring), by
    kernel K8 on CUDA and by ``plain_maddpg_trajectory`` on the CPU;
    ``run.plain`` is the plain version on the same device. ``actor_params``
    fixes the widths (its output width must be ``5 + C``,
    ``learner.maddpg.maddpg_act_dim``); pass the current actor at each call.
    Lanes start at t = 0 and reset every ``horizon`` steps."""
    kscn = _resolve(scenario)
    aw = kscn.n_logits
    got = tuple(actor_params["out"]["b"].shape)
    if got[-1] != aw or actor_params["l1"]["w"].shape[-2] != kscn.obs_w:
        raise ValueError(f"actor maps {actor_params['l1']['w'].shape[-2]} -> {got[-1]}; "
                         f"{kscn.spec.name!r} needs {kscn.obs_w} -> {aw}")
    device = resolve_device(device)
    block_envs = pick_block_envs(n_envs, block_envs)
    if t_chunk < 1 or n_steps % t_chunk:
        raise ValueError(f"n_steps={n_steps} must be a multiple of t_chunk={t_chunk}")
    args = (n_envs, n_steps, horizon, block_envs, t_chunk, float(eps_greedy))

    def plain(seed, actor_params, block_offset=0):
        return plain_maddpg_trajectory(kscn, _kernel_weights(actor_params, device), *args, seed,
                                       block_offset, emit_rows, device)

    def run(seed, actor_params, block_offset=0):
        if device.type == "cuda":
            return maddpg_traj_cuda(kscn, _kernel_weights(actor_params, device), *args, seed,
                                    block_offset, emit_rows, device)
        return plain(seed, actor_params, block_offset)

    run.plain = plain
    run.n_blocks = n_envs // block_envs
    run.block_envs = block_envs
    run.t_chunk = t_chunk
    run.act_width = aw
    return run



def sharded_fused_maddpg_trajectory(scenario, actor_params, n_envs: int, n_steps: int, mesh=None,
                                    horizon: int = 25, eps_greedy: float = 0.1,
                                    block_envs: int = 1024, t_chunk: int = 8,
                                    emit_rows: bool = False, device=None):
    """MADDPG collection over the ranks of ``mesh`` (by default this
    process's, ``parallel.env_mesh``), the actor weights the same on every
    rank: ``run(seed, actor_params)`` returns this rank's ``n_envs / size``
    lanes. Rank r runs kernel K8 with block offset ``r * local_n_blocks``, so
    the ranks' outputs gathered on the env axis equal the single-device
    ``fused_maddpg_trajectory`` of ``n_envs`` (``mesh.shard_envs`` checks
    that the block size agrees). No collective. ``run.plain`` is the plain
    version."""
    from mpe_tpu_torch.parallel.mesh import env_mesh

    mesh = mesh if mesh is not None else env_mesh(device)
    local, block, offset = mesh.shard_envs(n_envs, block_envs)
    local_run = fused_maddpg_trajectory(scenario, actor_params, local, n_steps, horizon=horizon,
                                        eps_greedy=eps_greedy, block_envs=block, t_chunk=t_chunk,
                                        emit_rows=emit_rows,
                                        device=mesh.device if device is None else device)

    def run(seed, actor_params):
        return local_run(seed, actor_params, offset)

    run.plain = lambda seed, actor_params: local_run.plain(seed, actor_params, offset)
    run.block_envs = block
    run.act_width = local_run.act_width
    return run

"""Fused MADDPG replay collection: kernel K8 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_maddpg.py``).

Every agent has its own actor (``learner.maddpg.init_maddpg``'s ``actor``,
each leaf stacked on a leading agent axis). Per step, each agent's MLP runs
on its obs, a move is drawn by Gumbel-max over its logits and, with
probability ``eps_greedy``, replaced by a uniform one-hot; the env steps and
lanes reset at the horizon. The stored transition is (obs, action one-hots,
reward, the TRUE next obs before any reset), so TD targets bootstrap through
the time limit.

- tensor form: ``(obs [T, A, OW, N], act [T, A, 5, N] one-hot float32, rew
  [T, R, N], obs2 [T, A, OW, N])``;
- rows form (``emit_rows=True``): the finished replay rows ``[T, N, W]``,
  ``W = A*(2*OW + 5 + 1)``, row ``[obs | act | rew per agent | obs2]``
  flattened agent-major (``learner.maddpg.Buffer``'s layout), the shared
  reward broadcast to every agent.

On a CUDA device the builder launches ``spread_maddpg_traj_kernel``
(``csrc/mpe_maddpg.cu``); on the CPU it runs ``plain_maddpg_trajectory``.
The RNG is the JAX kernels' interpret-mode hash stream with the time-chunk
salt, as in K5: agent i draws on call ids ``28 + 6i`` (the Gumbel draw of
``uniform((5, n))``), ``29 + 6i`` (the eps one-hot's Gumbel draw) and
``30 + 6i`` (the eps coin ``uniform((1, n)) < eps``), so the kernel, its
plain version and JAX interpret mode draw the same bits. Each layer of the
plain MLP sums in the kernel's order (``_seq_dense_agents``), so the
two take the same actions on the card. Only move-only scenarios are ported:
the comm head waits for ROADMAP B3.
"""

from __future__ import annotations

import ctypes

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops.fused_policy import HIDDEN, MOVES, OBS_W, _gumbel_onehot, _resolve
from mpe_tpu_torch.ops.fused_rollout import _MASK, make_lane_reset, make_uniform, pick_block_envs


def _kernel_weights(actor_params, device=None):
    """Stacked actor params (leaves [A, in, out] and [A, out]) -> per-agent
    kernel layout: w [A, out, in] and b [A, out, 1], float32."""
    def f32(x):
        return x.detach().to(device=device, dtype=torch.float32)

    return tuple(t for q in ("l1", "l2", "out")
                 for t in (f32(actor_params[q]["w"]).transpose(1, 2).contiguous(),
                           f32(actor_params[q]["b"])[..., None]))


def _seq_dense_agents(w, b, x):
    """Per-agent ``w [A, out, in] @ x [A, in, N] + b [A, out, 1]``, summed
    over ``in`` in order from the first product, then the bias: the
    kernels' order (``fused_policy._seq_dense`` for every agent at once)."""
    acc = w[..., 0:1] * x[:, 0:1, :]
    for k in range(1, w.shape[-1]):
        acc = acc + w[..., k:k + 1] * x[:, k:k + 1, :]
    return acc + b


def _peragent_sample(kscn, weights, obs, uniform, step: int, eps_greedy: float):
    """obs [A, OW, N] -> action one-hots [A, 5, N]: per-agent MLPs, Gumbel-max
    over the move logits on call id ``28 + 6i``, eps-mixed with a uniform
    one-hot (ids ``29 + 6i`` and ``30 + 6i``)."""
    w1, b1, w2, b2, w3, b3 = weights
    mw = 2 * kscn.spec.dim_p + 1
    h = torch.tanh(_seq_dense_agents(w1, b1, obs))
    h = torch.tanh(_seq_dense_agents(w2, b2, h))
    logits = _seq_dense_agents(w3, b3, h)[:, :mw]                       # [A, 5, N]
    rows = []
    for i in range(kscn.spec.n_agents):
        base = 28 + 6 * i
        samp = _gumbel_onehot(logits[i], uniform((mw,), step, base))
        if eps_greedy > 0.0:
            rand = _gumbel_onehot(torch.zeros_like(logits[i]), uniform((mw,), step, base + 1))
            take = (uniform((1,), step, base + 2) < eps_greedy).to(logits.dtype)
            samp = take * rand + (1.0 - take) * samp
        rows.append(samp)
    return torch.stack(rows)


def _rows(kscn, obs, act, rew, obs2):
    """One step's (obs [A, OW, N], act [A, 5, N], rew [R, N], obs2) -> replay
    rows [N, W]."""
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
    mw = 2 * spec.dim_p + 1
    f32 = torch.float32
    if emit_rows:
        rows_out = torch.empty((n_steps, n_envs, a * (2 * kscn.obs_w + mw + 1)), dtype=f32,
                               device=device)
    else:
        obs_out = torch.empty((n_steps, a, kscn.obs_w, n_envs), dtype=f32, device=device)
        act_out = torch.empty((n_steps, a, mw, n_envs), dtype=f32, device=device)
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
            act = _peragent_sample(kscn, weights, obs, uniform, step, eps_greedy)
            pos, vel = kscn.physics(pos, vel, act)
            rew, obs_next = kscn.reward_obs(pos, vel, None, goal)
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
                     emit_rows: bool = False, device=None):
    """Launch kernel K8 (``spread_maddpg_traj_kernel``) on ``device``: the
    outputs of ``plain_maddpg_trajectory``. Counts launches in
    ``.launches``."""
    from mpe_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the MADDPG collection kernel needs a CUDA device, got {device}")
    if n_envs <= 0 or n_envs % block_envs:
        raise ValueError(f"n_envs={n_envs} must be a positive multiple of block_envs={block_envs}")
    if n_steps < 0 or horizon < 1 or t_chunk < 1 or n_steps % t_chunk:
        raise ValueError(f"need n_steps >= 0 a multiple of t_chunk >= 1 and horizon >= 1, got "
                         f"{n_steps}, {t_chunk}, {horizon}")
    a = kscn.spec.n_agents
    shapes = [tuple(w.shape) for w in weights]
    want = [(a, HIDDEN, OBS_W), (a, HIDDEN, 1), (a, HIDDEN, HIDDEN), (a, HIDDEN, 1),
            (a, MOVES, HIDDEN), (a, MOVES, 1)]
    if shapes != want:
        raise NotImplementedError(f"the MADDPG collection kernel is built for {a} agents' "
                                  f"{OBS_W}-{HIDDEN}-{HIDDEN}-{MOVES} actors; got weight shapes "
                                  f"{shapes}")
    params = _build.spread_params(kscn)
    wbuf = torch.cat([torch.cat([w[i].reshape(-1) for w in weights]) for i in range(a)])
    wbuf = wbuf.to(device=device, dtype=torch.float32).contiguous()
    ow, f32 = kscn.obs_w, torch.float32
    if emit_rows:
        outs = (torch.empty((n_steps, n_envs, a * (2 * ow + MOVES + 1)), dtype=f32,
                            device=device),)
        ptrs = (None, None, None, None, outs[0].data_ptr())
    else:
        outs = (torch.empty((n_steps, a, ow, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, a, MOVES, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, 1, n_envs), dtype=f32, device=device),
                torch.empty((n_steps, a, ow, n_envs), dtype=f32, device=device))
        ptrs = tuple(x.data_ptr() for x in outs) + (None,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.library("mpe_maddpg.cu").mpe_spread_maddpg_traj_a3l3(
            ctypes.byref(params), wbuf.data_ptr(), *ptrs, n_envs, block_envs,
            n_steps // t_chunk, t_chunk, horizon, float(eps_greedy), int(seed) & _MASK,
            int(block_offset) & _MASK, stream)
    if rc != 0:
        raise RuntimeError(f"spread_maddpg_traj_kernel launch failed: {_build.error_string(rc)}")
    maddpg_traj_cuda.launches += 1
    return outs[0] if emit_rows else outs


maddpg_traj_cuda.launches = 0


def fused_maddpg_trajectory(scenario, actor_params, n_envs: int, n_steps: int,
                            horizon: int = 25, eps_greedy: float = 0.1, block_envs: int = 1024,
                            t_chunk: int = 8, emit_rows: bool = False, device=None):
    """Build ``run(seed, actor_params, block_offset=0)``: a chunk of MADDPG
    replay transitions in the tensor or the rows form (module docstring), by
    kernel K8 on CUDA and by ``plain_maddpg_trajectory`` on the CPU;
    ``run.plain`` is the plain version on the same device. ``actor_params``
    fixes the widths (its output width must be 5 on simple_spread); pass the
    current actor at each call. Lanes start at t = 0 and reset every
    ``horizon`` steps."""
    kscn = _resolve(scenario)
    mw = 2 * kscn.spec.dim_p + 1
    got = tuple(actor_params["out"]["b"].shape)
    if got[-1] != mw or actor_params["l1"]["w"].shape[-2] != kscn.obs_w:
        raise ValueError(f"actor maps {actor_params['l1']['w'].shape[-2]} -> {got[-1]}; "
                         f"{kscn.spec.name!r} needs {kscn.obs_w} -> {mw}")
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
    run.act_width = mw
    return run


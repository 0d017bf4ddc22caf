"""The fused MADDPG training loop on one device (counterpart of
``mpe_tpu/learner/fused_loop.py``).

``build_fused_maddpg_runner`` builds the collection (kernel K8) and the
chunked update (kernel K9, Adam, Polyak) once and returns ``run(updates,
seed, ...)``. One chunk collects ``n_envs * horizon`` transitions into the
replay ring and then runs ``horizon`` updates, so the loop keeps one update
per ``n_envs`` transitions, with the actors gated to every second update
after ``actor_start`` updates of critic warm-up.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner.fused_ppo import _mark
from mpe_tpu_torch.learner.maddpg import (_dims, _tree3, build_fused_collect,
                                          build_fused_update_chunk, init_buffer, init_maddpg,
                                          maddpg_act_dim)


def chunk_key(seed: int, chunk: int) -> int:
    """The sampling generator's seed for chunk ``chunk`` of a run seeded
    with ``seed`` (JAX folds the chunk into ``PRNGKey(seed + 7)``)."""
    return (((int(seed) + 7) & 0xFFFFFFFF) << 32) | (int(chunk) & 0xFFFFFFFF)


def actor_gates(chunk: int, horizon: int, actor_start: int, actor_period=None) -> np.ndarray:
    """The actor gates of the ``horizon`` updates of chunk ``chunk``:
    ``(chunk*horizon + k >= actor_start) & (k % 2 == 0)`` -> [horizon]; with
    ``actor_period`` (one int per agent), agent j steps only on every
    ``period[j]``-th gated slot, counted from update 0 as
    ``chunk*ceil(horizon/2) + k//2`` -> [horizon, A]."""
    k = np.arange(horizon)
    gates = (chunk * horizon + k >= actor_start) & (k % 2 == 0)
    if actor_period is None:
        return gates
    astep = chunk * ((horizon + 1) // 2) + k // 2
    per = np.asarray(actor_period, dtype=np.int64)
    return gates[:, None] & (astep[:, None] % per[None, :] == 0)


def build_fused_maddpg_runner(scenario: str, n_envs: int = 64, horizon: int = 25,
                              batch: int = 1024, tau: float = 0.01, lr: float = 1e-3,
                              ent_coef: float = 0.01, eps: float = 0.1, block: int = 40,
                              actor_period=None, local_critic: bool = False, device=None):
    """Build the fused MADDPG machinery for ``scenario`` once -> ``run(
    updates, seed=0, init_params=None, actor_start=1000,
    collect_seed0=10_000, progress=None, events=None) -> (params, info)``.

    ``run`` draws the params from ``torch.Generator().manual_seed(seed)``
    (or starts from ``init_params``, an ``init_maddpg`` tree), fills the
    ring of ``n_envs * 1600`` rows with collections on seeds ``0 ..
    200 // horizon - 1``, then runs ``updates // horizon`` chunks: chunk i
    collects on seed ``collect_seed0 + i`` and updates with the sampling key
    ``chunk_key(seed, i)`` and the gates ``actor_gates(i, ...)``. Everything
    a chunk draws derives from ``(seed, i)``, so a shorter run is a prefix of
    a longer one. ``progress(done_chunks, n_chunks, mean_reward,
    critic_loss)`` is called every ``block`` chunks and at the end (it reads
    the device); ``events``, a list, receives a CUDA event before the first
    chunk ("start") and after each chunk's "collect" and "update" phase.
    ``info`` holds the recipe, the per-chunk ``mean_reward`` and
    ``critic_loss`` (tensors on the device), and the final ``targets``,
    ``opt_states`` and ``buffer``.

    ``local_critic=True`` (independent DDPG) is not ported yet (ROADMAP A10)."""
    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv

    if local_critic:
        raise NotImplementedError("local_critic=True (independent DDPG critics) is not ported; "
                                  "the port runs the centralized critic (ROADMAP A10)")
    device = resolve_device(device)
    scn = scenarios.load(scenario)
    env = MpeEnv(scn, max_steps=horizon, auto_reset=True, device=device)
    a = env.n_agents
    if actor_period is not None:
        actor_period = tuple(int(p) for p in actor_period)
        if len(actor_period) != a or min(actor_period) < 1:
            raise ValueError(f"actor_period needs one entry >= 1 per agent ({a}), got "
                             f"{actor_period}")
    _, obs_dim, _, _, _ = _dims(env)
    aw = maddpg_act_dim(env)
    capacity = n_envs * 1600
    collect = build_fused_collect(env, n_envs, horizon, eps_greedy=eps,
                                  block_envs=min(1024, n_envs), device=device)
    update_chunk = build_fused_update_chunk(env, horizon, batch=batch, tau_polyak=tau,
                                            actor_lr=lr, critic_lr=lr, ent_coef=ent_coef,
                                            device=device)

    def run(updates: int, seed: int = 0, init_params=None, actor_start: int = 1000,
            collect_seed0: int = 10_000, progress=None, events=None):
        n_chunks = max(1, updates // horizon)
        if init_params is None:
            init_params = init_maddpg(torch.Generator().manual_seed(int(seed)), obs_dim, aw, a)
        params = _tree3(lambda x: torch.as_tensor(x, dtype=torch.float32).to(device),
                        init_params)
        targets = _tree3(torch.clone, params)
        buffer = init_buffer(capacity, a, obs_dim, aw, device=device)
        opt_states = update_chunk.init_opt(params)
        for i in range(max(1, 200 // horizon)):           # warm-up: ~200 env-steps of replay
            buffer, _ = collect(params["actor"], buffer, i)

        pstate = update_chunk.pack_state(params, targets, opt_states)
        mean_rewards, critic_losses = [], []
        _mark(events, "start")
        for i in range(n_chunks):
            buffer, mr = collect(update_chunk.actor_of(pstate), buffer, collect_seed0 + i)
            _mark(events, "collect")
            pstate, m = update_chunk.packed_step(pstate, buffer, chunk_key(seed, i),
                                                 actor_gates(i, horizon, actor_start,
                                                             actor_period))
            _mark(events, "update")
            mean_rewards.append(mr)
            critic_losses.append(m["critic_loss"])
            if progress is not None and ((i + 1) % block == 0 or i + 1 == n_chunks):
                progress(i + 1, n_chunks, float(mr), float(m["critic_loss"]))
        params, targets, opt_states = update_chunk.unpack_state(pstate)
        info = {"scenario": scenario, "updates": n_chunks * horizon, "n_envs": n_envs,
                "batch": batch, "tau": tau, "lr": lr, "seed": seed,
                "actor_period": None if actor_period is None else list(actor_period),
                "mean_reward": torch.stack(mean_rewards), "critic_loss": torch.stack(critic_losses),
                "targets": targets, "opt_states": opt_states, "buffer": buffer}
        return params, info

    run.env = env
    run.scenario = scn
    run.collect = collect
    run.update_chunk = update_chunk
    run.capacity = capacity
    run.transitions_per_chunk = n_envs * horizon
    return run


def run_fused_maddpg(scenario: str, updates: int = 24_000, n_envs: int = 64, horizon: int = 25,
                     batch: int = 1024, tau: float = 0.01, lr: float = 1e-3,
                     ent_coef: float = 0.01, eps: float = 0.1, actor_start: int = 1000,
                     block: int = 40, seed: int = 0, progress=None, actor_period=None,
                     init_params=None, device=None):
    """Train MADDPG on ``scenario`` with the fused loop: a one-shot wrapper
    over ``build_fused_maddpg_runner`` -> ``(params, info)``."""
    run = build_fused_maddpg_runner(scenario, n_envs=n_envs, horizon=horizon, batch=batch, tau=tau,
                                    lr=lr, ent_coef=ent_coef, eps=eps, block=block,
                                    actor_period=actor_period, device=device)
    return run(updates, seed=seed, init_params=init_params, actor_start=actor_start,
               progress=progress)

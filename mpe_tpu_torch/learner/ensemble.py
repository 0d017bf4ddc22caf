"""MADDPG policy ensembles (Lowe et al. 2017 §4.3), counterpart of
``mpe_tpu/learner/ensemble.py``.

Each agent i holds K sub-policies; every episode each agent samples one sub
uniformly and acts with it, and each (agent, sub) pair trains only on the
transitions its sub generated: the paper's per-sub replay buffers D_i^(k),
realized as the shared replay ring plus a per-chunk sub-assignment ring
(episodes are collected in whole-horizon chunks, so one [A] vector of sub
indices per chunk is the per-episode assignment) and masked per-(i, k)
losses at update time. Each (i, k) has its own centralized critic Q_i^k,
trained on its sub's transitions under the mixture of the other agents'
ensembles. TD targets use the target actor of the sub that generated each
transition. K = 1 is vanilla MADDPG.

The same machinery is the exploitability probe (``tools/ensemble_exploit.py``
in the JAX package): ``train_mask`` freezes a trained team's actors (its subs
are still sampled per episode) while a fresh best-response opponent trains
against the frozen mixture.

As in JAX, one ``k_vec`` is drawn per chunk and shared by every env of the
chunk (ROADMAP C records it as a property of the reference). The port draws
it on the host, so the sub-sliced actors that kernel K8 collects with need
no read from the device. The updates are autograd of the JAX op-chain's
losses (``ensemble_xla_grads``): no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner.maddpg import (_apply_maddpg_update, _candidate_table, _joint,
                                          _tree3, _value_and_grad, init_maddpg)
from mpe_tpu_torch.learner.optim import adam, tree_map
from mpe_tpu_torch.ops.fused_maddpg_update import head_onehots, target_indices


def init_ensemble(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
                  k_ens: int, hidden: int = 64, dtype=torch.float32) -> dict:
    """Stacked ensemble params: every leaf has leading [A, K] axes. Sub k of
    every agent is agent i of the k-th of K ``init_maddpg`` draws, made one
    after another from ``generator`` (JAX folds k into its key instead), so
    K = 1 is ``init_maddpg`` from the same generator."""
    per_k = [init_maddpg(generator, obs_dim, act_dim, n_agents, hidden=hidden, dtype=dtype)
             for _ in range(k_ens)]
    return _tree3(lambda *xs: torch.stack(xs, dim=1), *per_k)


def sub_slice(params, k_vec):
    """One sub per agent: leaves [A, K, ...] -> [A, ...], agent i's
    ``k_vec[i]`` (the per-episode actor stack kernel K8 collects with), as
    new contiguous tensors. ``k_vec`` holds host integers; a tensor is read
    to the host."""
    ks = [int(k) for k in (k_vec.tolist() if isinstance(k_vec, torch.Tensor) else k_vec)]
    return tree_map(lambda x: torch.stack([x[i, k] for i, k in enumerate(ks)]), params)


def _all_subs(net_params, x_per_agent):
    """Every (agent, sub) net on its agent's rows: leaves [A, K, ...], x [B,
    A, O] -> [A, K, B, out]."""
    h = torch.tanh(torch.einsum("bai,akih->akbh", x_per_agent, net_params["l1"]["w"])
                   + net_params["l1"]["b"][:, :, None])
    h = torch.tanh(torch.einsum("akbi,akih->akbh", h, net_params["l2"]["w"])
                   + net_params["l2"]["b"][:, :, None])
    return (torch.einsum("akbi,akio->akbo", h, net_params["out"]["w"])
            + net_params["out"]["b"][:, :, None])


def _critics(critic_params, joint):
    """Every (agent, sub) critic on one joint input: leaves [A, K, ...],
    joint [..., J] -> Q [A, K, ...]."""
    h = torch.tanh(torch.einsum("...j,akjh->ak...h", joint, critic_params["l1"]["w"])
                   + _lead(critic_params["l1"]["b"], joint.dim() - 1))
    h = torch.tanh(torch.einsum("ak...i,akih->ak...h", h, critic_params["l2"]["w"])
                   + _lead(critic_params["l2"]["b"], joint.dim() - 1))
    return (torch.einsum("ak...i,akio->ak...o", h, critic_params["out"]["w"])
            + _lead(critic_params["out"]["b"], joint.dim() - 1))[..., 0]


def _lead(bias, n: int):
    """A bias [A, K, out] broadcast over ``n`` axes between K and out."""
    return bias.reshape(bias.shape[:2] + (1,) * n + bias.shape[2:])


def ensemble_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, k_b, *, mw: int, cw: int,
                       gamma: float, ent_coef: float):
    """The ensemble MADDPG gradient on a sampled batch by autograd (JAX's
    ``ensemble_xla_grads``): ``maddpg_xla_grads`` with (a) a sub axis K on
    every net, (b) TD target actions from the target actor of the sub that
    generated each transition (``k_b [B, A]``, integers), (c) per-(i, k)
    masked losses, each normalized by its sub's count of samples and summed
    over the subs. Returns ``(grads, (critic_loss, actor_loss, q_mean))``;
    K = 1 is ``maddpg_xla_grads``."""
    batch, a, aw = act_b.shape
    k_ens = params["actor"]["l1"]["w"].shape[1]
    dtype = obs_b.dtype
    k_b = torch.as_tensor(k_b, device=obs_b.device)
    # mask[i, k, b]: transition b was generated by sub k of agent i
    mask = (k_b.T[:, None, :] == torch.arange(k_ens, device=obs_b.device)[None, :, None]
            ).to(dtype)                                                  # [A, K, B]
    count = mask.sum(-1).clamp(min=1.0)                                  # [A, K]

    with torch.no_grad():
        tgt_logits = torch.einsum("akbw,akb->baw", _all_subs(targets["actor"], obs2_b), mask)
        act2 = head_onehots(target_indices(tgt_logits, mw), mw, aw, dtype)
        q_next = torch.einsum("akb,akb->ab", _critics(targets["critic"], _joint(obs2_b, act2)),
                              mask)
        y = rew_b.T + gamma * q_next                                     # [A, B]

    def critic_loss(cp):
        q = _critics(cp, _joint(obs_b, act_b))                           # [A, K, B]
        per_sub = ((q - y[:, None, :]).square() * mask).sum(-1) / count  # [A, K]
        return per_sub.sum(-1).mean(), torch.einsum("akb,akb->ab", q, mask).mean()

    (closs, qmean), cgrads = _value_and_grad(critic_loss, params["critic"])

    cand = _candidate_table(mw, cw, aw, dtype, obs_b.device)
    n_cand = cand.shape[0]
    obs_flat = obs_b.reshape(1, batch, -1).expand(n_cand, batch, -1)

    def actor_loss(ap):
        logits = _all_subs(ap, obs_b)                                    # [A, K, B, aw]
        probs_m = torch.softmax(logits[..., :mw], dim=-1)
        probs_c = torch.softmax(logits[..., mw:], dim=-1) if cw else None
        total = 0.0
        for i in range(a):
            # the joint rows with agent i's action replaced by each
            # candidate: shared by i's subs
            mixed = act_b.expand((n_cand,) + act_b.shape).clone()        # [C, B, A, aw]
            mixed[:, :, i, :] = cand[:, None, :]
            joint = torch.cat([obs_flat, mixed.reshape(n_cand, batch, -1)], dim=-1)
            cp_i = tree_map(lambda x: x[i:i + 1].detach(), params["critic"])
            q_all = _critics(cp_i, joint)[0]                             # [K, C, B]
            w = probs_m[i]                                               # [K, B, mw]
            if cw:
                w = (w[..., :, None] * probs_c[i][..., None, :]).reshape(k_ens, batch, n_cand)
            exp_q = (w * q_all.transpose(1, 2)).sum(-1)                  # [K, B]
            ent = -(probs_m[i] * torch.log(probs_m[i] + 1e-10)).sum(-1)
            if cw:
                ent = ent - (probs_c[i] * torch.log(probs_c[i] + 1e-10)).sum(-1)
            total = total - (((exp_q + ent_coef * ent) * mask[i]).sum(-1) / count[i]).sum()
        return total / a

    aloss, agrads = _value_and_grad(actor_loss, params["actor"])
    return {"actor": agrads, "critic": cgrads}, (closs, aloss, qmean)


def draw_k_vec(k_active, seed: int, chunk: int) -> np.ndarray:
    """The subs of one chunk: ``k_vec[i]`` uniform in ``[0, k_active[i])``,
    drawn on the host from ``(seed, chunk)`` (JAX draws it on the device
    from its key)."""
    return np.random.default_rng((int(seed), int(chunk))).integers(0, k_active)


def build_ensemble_runner(scenario: str, k_ens: int, n_envs: int = 64, horizon: int = 25,
                          batch: int = 1024, gamma: float = 0.95, tau: float = 0.01,
                          lr: float = 1e-3, ent_coef: float = 0.01, eps: float = 0.1,
                          block: int = 40, train_mask=None, k_active=None, hidden: int = 64,
                          device=None):
    """Ensemble MADDPG with fused collection, built once -> ``run(updates,
    seed=0, init_params=None, actor_start=1000, progress=None, events=None)
    -> (params, info)``, ``params`` an ``init_ensemble`` tree ([A, K]
    leading axes).

    Per chunk (one horizon-long episode in every env): ``k_vec =
    draw_k_vec(k_active, seed + 7, i)``; kernel K8 collects the chunk on
    seed ``10_000 + i`` with the selected subs (``sub_slice``); ``k_vec``
    goes into the chunk's slot of ``k_ring``; then ``horizon`` masked
    ensemble updates, batch rows from ``sample_rows`` on the key
    ``chunk_key(seed, i)``, each row's subs ``k_ring[(idx // rows_per_chunk)
    % cap_chunks]``, actor gates ``actor_gates(i, ...) & train_mask``. The
    warm-up fills the ring with ``200 // horizon`` chunks on seeds 0, 1, ...
    and subs ``draw_k_vec(k_active, seed + 13, i)``.

    ``train_mask`` (bool [A], default all) gates which agents' actors update
    (freezing a trained team for a best-response probe); ``k_active`` (int
    [A], default all ``k_ens``) limits each agent's sampled subs. The ring
    holds ``n_envs * 1600`` rows, whole chunks only: ``horizon`` must divide
    1600. ``progress`` and ``events`` as in ``build_fused_maddpg_runner``."""
    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.learner.fused_loop import actor_gates, chunk_key
    from mpe_tpu_torch.learner.fused_ppo import _mark
    from mpe_tpu_torch.learner.maddpg import (_dims, build_fused_collect, init_buffer,
                                              sample_rows)

    device = resolve_device(device)
    scn = scenarios.load(scenario)
    env = MpeEnv(scn, max_steps=horizon, auto_reset=True, device=device)
    a = env.n_agents
    _, obs_dim, aw, mw, cw = _dims(env)
    train_mask = np.ones(a, bool) if train_mask is None else np.asarray(train_mask, bool)
    k_active = np.full(a, k_ens) if k_active is None else np.asarray(k_active, np.int64)
    if train_mask.shape != (a,) or k_active.shape != (a,):
        raise ValueError(f"train_mask and k_active need one entry per agent ({a})")
    if not ((k_active >= 1) & (k_active <= k_ens)).all():
        raise ValueError(f"k_active entries must lie in [1, {k_ens}], got {k_active}")
    rows_per_chunk = n_envs * horizon
    capacity = n_envs * 1600
    # each ring row's subs are looked up by its chunk slot: a chunk that
    # wrapped mid-ring would take another episode's subs
    if capacity % rows_per_chunk:
        raise ValueError(f"horizon ({horizon}) must divide 1600 so that the replay ring holds "
                         "whole chunks (the per-sub attribution is chunk-aligned)")
    cap_chunks = capacity // rows_per_chunk
    collect = build_fused_collect(env, n_envs, horizon, eps_greedy=eps,
                                  block_envs=min(1024, n_envs), device=device)
    actor_opt, critic_opt = adam(lr), adam(lr)

    def insert(params, buffer, k_ring, k_vec, seed):
        slot = (buffer.ptr // rows_per_chunk) % cap_chunks
        buffer, mr = collect(sub_slice(params["actor"], k_vec), buffer, seed)
        k_ring[slot] = torch.as_tensor(k_vec, dtype=torch.int64).to(device)
        return buffer, mr

    def run(updates: int, seed: int = 0, init_params=None, actor_start: int = 1000,
            progress=None, events=None):
        n_chunks = max(1, updates // horizon)
        if init_params is None:
            init_params = init_ensemble(torch.Generator().manual_seed(int(seed)), obs_dim, aw, a,
                                        k_ens, hidden=hidden)
        params = _tree3(lambda x: torch.as_tensor(x, dtype=torch.float32).to(device),
                        init_params)
        targets = _tree3(torch.clone, params)
        opt_states = {"actor": actor_opt.init(params["actor"]),
                      "critic": critic_opt.init(params["critic"])}
        buffer = init_buffer(capacity, a, obs_dim, aw, device=device)
        k_ring = torch.zeros((cap_chunks, a), dtype=torch.int64, device=device)
        for i in range(max(1, 200 // horizon)):           # warm-up: ~200 env-steps of replay
            buffer, _ = insert(params, buffer, k_ring, draw_k_vec(k_active, seed + 13, i), i)

        mean_rewards, critic_losses = [], []
        _mark(events, "start")
        for i in range(n_chunks):
            buffer, mr = insert(params, buffer, k_ring, draw_k_vec(k_active, seed + 7, i),
                                10_000 + i)
            _mark(events, "collect")
            rows, idx = sample_rows(buffer, chunk_key(seed, i), horizon, batch)
            k_rows = k_ring[(idx // rows_per_chunk) % cap_chunks]        # [horizon, B, A]
            gates = actor_gates(i, horizon, actor_start)
            for u in range(horizon):
                grads, (closs, _, _) = ensemble_xla_grads(
                    params, targets, *buffer._split(rows[u]), k_rows[u], mw=mw, cw=cw,
                    gamma=gamma, ent_coef=ent_coef)
                params, targets, opt_states = _apply_maddpg_update(
                    params, targets, opt_states, grads, gates[u] & train_mask,
                    actor_opt=actor_opt, critic_opt=critic_opt, tau_polyak=tau)
            _mark(events, "update")
            mean_rewards.append(mr)
            critic_losses.append(closs)
            if progress is not None and ((i + 1) % block == 0 or i + 1 == n_chunks):
                progress(i + 1, n_chunks, float(mr), float(closs))
        info = {"scenario": scenario, "updates": n_chunks * horizon, "k_ens": k_ens,
                "n_envs": n_envs, "batch": batch, "tau": tau, "lr": lr, "seed": seed,
                "mean_reward": torch.stack(mean_rewards), "critic_loss": torch.stack(critic_losses),
                "targets": targets, "opt_states": opt_states, "buffer": buffer, "k_ring": k_ring}
        return params, info

    run.env = env
    run.scenario = scn
    run.collect = collect
    run.capacity = capacity
    run.transitions_per_chunk = rows_per_chunk
    run.k_active = k_active
    return run

"""MADDPG with learned approximations of the other agents' policies (Lowe
et al. 2017 §4.2, eq. 6-7), counterpart of ``mpe_tpu/learner/approx_others.py``:
centralized training without access to the other agents' true policies.

Vanilla MADDPG's TD target forms the next joint action from every agent's
true target actor. Here each agent i keeps an approximation mu_hat_i^j of
every other agent j's policy, fit online by maximum likelihood on the (o_j,
a_j) pairs of the replay ring (eq. 6, with an entropy term), and bootstraps
its critic through their target copies (eq. 7): agent i's next joint action
is its own target actor in slot i and mu_hat'_i^j(o_j) in every other slot.
Execution stays decentralized, as in vanilla MADDPG.

With the approximations copied from the true actors (``approx_from_actors``)
the TD targets, and so the actor and critic gradients, are vanilla
``maddpg_xla_grads``'s. The updates are autograd of the JAX op-chain's
losses (``approx_xla_grads``): no kernel; collection is kernel K8 with the
true actors.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner._nets import dense_init
from mpe_tpu_torch.learner.maddpg import (_apply_maddpg_update, _joint, _tree3, _value_and_grad,
                                          actor_logits, critic_q, expected_q_actor_loss,
                                          init_maddpg)
from mpe_tpu_torch.learner.optim import adam, apply_updates, tree_map
from mpe_tpu_torch.ops.fused_maddpg_update import _split_rows, head_onehots, target_indices


def init_approx(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
                hidden: int = 64, dtype=torch.float32) -> dict:
    """Approximation nets, leaves [A_observer, A_modeled, ...]: row i holds
    agent i's models of every agent j's policy (the (i, i) slot exists and
    is never used). Observer by observer, modeled agent by modeled agent,
    the draws are l1, l2, out (scale 0.01), all from ``generator``."""
    rows = []
    for _ in range(n_agents):
        nets = [{"l1": dense_init(generator, obs_dim, hidden, dtype),
                 "l2": dense_init(generator, hidden, hidden, dtype),
                 "out": dense_init(generator, hidden, act_dim, dtype, scale=0.01)}
                for _ in range(n_agents)]
        rows.append(tree_map(lambda *xs: torch.stack(xs), *nets))
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def approx_from_actors(actor_params, n_agents: int) -> dict:
    """Approximation nets copied from the true actors: slot (i, j) = actor j
    (under which §4.2 reduces to vanilla MADDPG)."""
    return tree_map(lambda x: x[None].expand((n_agents,) + x.shape).clone(), actor_params)


def _heads_one_hot(logits, mw: int, cw: int):
    """First-argmax one-hot per head: [..., aw] logits -> [..., aw]."""
    return head_onehots(target_indices(logits, mw), mw, mw + cw, logits.dtype)


def _observer_logits(approx_params, obs_b):
    """Observer i's model of agent j on o_j: leaves [A, A, ...], obs [B, A,
    O] -> logits [A_i, A_j, B, aw]."""
    h = torch.tanh(torch.einsum("bjo,ijoh->ijbh", obs_b, approx_params["l1"]["w"])
                   + approx_params["l1"]["b"][:, :, None])
    h = torch.tanh(torch.einsum("ijbo,ijoh->ijbh", h, approx_params["l2"]["w"])
                   + approx_params["l2"]["b"][:, :, None])
    return (torch.einsum("ijbh,ijhk->ijbk", h, approx_params["out"]["w"])
            + approx_params["out"]["b"][:, :, None])


def approx_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, *, mw: int, cw: int,
                     gamma: float, ent_coef: float, approx_ent: float = 1e-3):
    """The §4.2 MADDPG gradient on a sampled batch by autograd (JAX's
    ``approx_xla_grads``); ``params`` and ``targets`` carry an ``"approx"``
    tree. Against ``maddpg_xla_grads``:

    - the TD target per observer: agent i's next joint action takes its own
      target actor in slot i and its target approximations elsewhere;
    - a maximum-likelihood loss of the approximations: each head's cross
      entropy of mu_hat_i^j(o_j) against the logged a_j, minus
      ``approx_ent`` times its entropy, over the off-diagonal (i, j), on
      the current obs.

    The actor loss is vanilla's (``expected_q_actor_loss``). Returns
    ``(grads, (critic_loss, actor_loss, approx_loss))``, ``grads`` keyed
    ``actor``, ``critic`` and ``approx``."""
    batch, a, aw = act_b.shape

    def approx_loss(pp):
        logits = _observer_logits(pp, obs_b)                           # [A_i, A_j, B, aw]
        lp_m = torch.log_softmax(logits[..., :mw], dim=-1)
        ce = -torch.einsum("ijbk,bjk->ijb", lp_m, act_b[..., :mw])
        ent = -(torch.exp(lp_m) * lp_m).sum(-1)
        if cw:
            lp_c = torch.log_softmax(logits[..., mw:], dim=-1)
            ce = ce - torch.einsum("ijbk,bjk->ijb", lp_c, act_b[..., mw:])
            ent = ent - (torch.exp(lp_c) * lp_c).sum(-1)
        off_diag = 1.0 - torch.eye(a, dtype=obs_b.dtype, device=obs_b.device)[:, :, None]
        return ((ce - approx_ent * ent) * off_diag).sum() / (a * max(a - 1, 1) * batch)

    ploss, pgrads = _value_and_grad(approx_loss, params["approx"])

    with torch.no_grad():
        appr = _observer_logits(targets["approx"], obs2_b).transpose(1, 2)  # [A_i, B, A_j, aw]
        own = actor_logits(targets["actor"], obs2_b)                        # [B, A, aw]
        idx = torch.arange(a, device=obs_b.device)
        appr[idx, :, idx] = own.transpose(0, 1)                             # slot i: own actor
        act2 = _heads_one_hot(appr, mw, cw)
        joint2 = torch.cat([obs2_b.reshape(1, batch, -1).expand(a, batch, -1),
                            act2.reshape(a, batch, -1)], dim=-1)            # [A, B, W]
        c = targets["critic"]
        h = torch.tanh(torch.einsum("abj,ajh->abh", joint2, c["l1"]["w"]) + c["l1"]["b"][:, None])
        h = torch.tanh(torch.einsum("abh,ahg->abg", h, c["l2"]["w"]) + c["l2"]["b"][:, None])
        q_next = (torch.einsum("abg,ago->abo", h, c["out"]["w"]) + c["out"]["b"][:, None])[..., 0]
        y = rew_b.T + gamma * q_next                                        # [A, B]

    def critic_loss(cp):
        q = critic_q(cp, _joint(obs_b, act_b))
        return (q - y).square().mean(), q.mean()

    (closs, _), cgrads = _value_and_grad(critic_loss, params["critic"])
    aloss, agrads = _value_and_grad(
        lambda ap: expected_q_actor_loss(ap, params["critic"], obs_b, act_b, mw=mw, cw=cw,
                                         ent_coef=ent_coef), params["actor"])
    return {"actor": agrads, "critic": cgrads, "approx": pgrads}, (closs, aloss, ploss)


def build_approx_runner(scenario: str, n_envs: int = 64, horizon: int = 25, batch: int = 1024,
                        gamma: float = 0.95, tau: float = 0.01, lr: float = 1e-3,
                        approx_lr: float = 1e-3, ent_coef: float = 0.01, eps: float = 0.1,
                        block: int = 40, hidden: int = 64, device=None):
    """§4.2 MADDPG with fused collection, built once -> ``run(updates,
    seed=0, init_params=None, actor_start=1000, progress=None, events=None)
    -> (params, info)``, ``params = {actor, critic, approx}``: ``init_maddpg``
    from ``seed`` and ``init_approx`` from ``seed + 31``, as in JAX.

    Kernel K8 collects with the true actors (chunk i on seed ``10_000 + i``,
    a warm-up of ``200 // horizon`` chunks on seeds 0, 1, ...); then
    ``horizon`` updates on ``sample_rows`` batches from the key
    ``chunk_key(seed, i)``, actor gates ``actor_gates(i, ...)``: the actor
    and critic step as in every MADDPG update (``_apply_maddpg_update``),
    the approximations by an ungated Adam at ``approx_lr`` and their own
    Polyak step. Needs two agents at least: §4.2 models the other agents.
    ``progress`` and ``events`` as in ``build_fused_maddpg_runner``."""
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
    if a < 2:
        raise ValueError(f"{scenario} has {a} agent(s): §4.2 models the OTHER agents' policies, "
                         "and with no other agent the approximation loss is vacuous")
    _, obs_dim, aw, mw, cw = _dims(env)
    capacity = n_envs * 1600
    collect = build_fused_collect(env, n_envs, horizon, eps_greedy=eps,
                                  block_envs=min(1024, n_envs), device=device)
    opts = {"actor": adam(lr), "critic": adam(lr), "approx": adam(approx_lr)}

    def update(params, targets, opt_states, rows_u, gate):
        grads, (closs, _, _) = approx_xla_grads(params, targets,
                                                *_split_rows(rows_u, a, obs_dim, aw), mw=mw,
                                                cw=cw, gamma=gamma, ent_coef=ent_coef)
        nets = ("actor", "critic")
        ac_p, ac_t, ac_o = _apply_maddpg_update(
            {k: params[k] for k in nets}, {k: targets[k] for k in nets},
            {k: opt_states[k] for k in nets}, {k: grads[k] for k in nets}, gate,
            actor_opt=opts["actor"], critic_opt=opts["critic"], tau_polyak=tau)
        pupd, p_opt = opts["approx"].update(grads["approx"], opt_states["approx"])
        approx = apply_updates(params["approx"], pupd)
        targets = {**ac_t, "approx": tree_map(lambda t, p: (1 - tau) * t + tau * p,
                                              targets["approx"], approx)}
        return {**ac_p, "approx": approx}, targets, {**ac_o, "approx": p_opt}, closs

    def run(updates: int, seed: int = 0, init_params=None, actor_start: int = 1000,
            progress=None, events=None):
        n_chunks = max(1, updates // horizon)
        if init_params is None:
            init_params = init_maddpg(torch.Generator().manual_seed(int(seed)), obs_dim, aw, a,
                                      hidden=hidden)
            init_params["approx"] = init_approx(torch.Generator().manual_seed(int(seed) + 31),
                                                obs_dim, aw, a, hidden=hidden)
        params = _tree3(lambda x: torch.as_tensor(x, dtype=torch.float32).to(device),
                        init_params)
        targets = _tree3(torch.clone, params)
        opt_states = {k: opts[k].init(params[k]) for k in ("actor", "critic", "approx")}
        buffer = init_buffer(capacity, a, obs_dim, aw, device=device)
        for i in range(max(1, 200 // horizon)):           # warm-up: ~200 env-steps of replay
            buffer, _ = collect(params["actor"], buffer, i)

        mean_rewards, critic_losses = [], []
        _mark(events, "start")
        for i in range(n_chunks):
            buffer, mr = collect(params["actor"], buffer, 10_000 + i)
            _mark(events, "collect")
            rows, _ = sample_rows(buffer, chunk_key(seed, i), horizon, batch)
            gates = actor_gates(i, horizon, actor_start)
            for u in range(horizon):
                params, targets, opt_states, closs = update(params, targets, opt_states, rows[u],
                                                            gates[u])
            _mark(events, "update")
            mean_rewards.append(mr)
            critic_losses.append(closs)
            if progress is not None and ((i + 1) % block == 0 or i + 1 == n_chunks):
                progress(i + 1, n_chunks, float(mr), float(closs))
        info = {"scenario": scenario, "updates": n_chunks * horizon, "n_envs": n_envs,
                "batch": batch, "tau": tau, "lr": lr, "approx_lr": approx_lr, "seed": seed,
                "mean_reward": torch.stack(mean_rewards), "critic_loss": torch.stack(critic_losses),
                "targets": targets, "opt_states": opt_states, "buffer": buffer}
        return params, info

    run.env = env
    run.scenario = scn
    run.collect = collect
    run.capacity = capacity
    run.transitions_per_chunk = n_envs * horizon
    return run

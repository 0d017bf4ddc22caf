"""PPO and MAPPO learners on the generic engine (counterpart of
``mpe_tpu/learner/ppo.py``): actor-critic MLPs, GAE, the clipped surrogate
objective, on the env's device.

  - rollout: a loop over the batched ``MpeEnv`` step with the policy
    sampled on the device, storing (obs, action, logp, value, reward,
    done), without gradient;
  - GAE advantages by a reverse loop over time;
  - update: ``ppo_epochs`` passes of the clipped objective + value loss +
    entropy bonus over the full batch, each one step of ``optim.clip_adam``
    on autograd's gradient.

Parameter-shared across agents: every agent's transitions train the same
network (the standard MPE baseline setup). The JAX builders take a mesh and
``pmean`` the gradient over it; the port's take ``mesh=None`` (a
``parallel.EnvMesh``): each rank rolls out its share of the envs with its
own generator (``mesh.rank_key``), and each epoch's gradient and the metrics
are means over the ranks. The fused trainers are ``learner.fused_ppo``;
these are the generic-engine learners. Logits and values are float32 at the
least (``_nets.at_least_f32``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import optim
from mpe_tpu_torch.learner._nets import at_least_f32, dense_init
from mpe_tpu_torch.learner.pg import categorical, index_logp


def init_ac(generator: torch.Generator, obs_dim: int, act_dim: int, hidden: int = 64,
            dtype=torch.float32) -> dict:
    """Actor-critic MLP: shared torso ``l1, l2``, policy head ``pi`` (scale
    0.01) and value head ``v``."""
    return {
        "l1": dense_init(generator, obs_dim, hidden, dtype),
        "l2": dense_init(generator, hidden, hidden, dtype),
        "pi": dense_init(generator, hidden, act_dim, dtype, scale=0.01),
        "v": dense_init(generator, hidden, 1, dtype),
    }


def _torso(params, obs, first="l1", second="l2"):
    x = obs.to(params[first]["w"].dtype)
    x = torch.tanh(x @ params[first]["w"] + params[first]["b"])
    return torch.tanh(x @ params[second]["w"] + params[second]["b"])


def policy_value(params, obs):
    """obs [..., O] -> (move logits [..., K], value [...])."""
    h = _torso(params, obs)
    logits = at_least_f32(h @ params["pi"]["w"] + params["pi"]["b"])
    value = at_least_f32((h @ params["v"]["w"] + params["v"]["b"])[..., 0])
    return logits, value


class Transition(NamedTuple):
    obs: torch.Tensor      # [T, B, A, O]
    act: torch.Tensor      # [T, B, A] int move index
    logp: torch.Tensor     # [T, B, A]
    value: torch.Tensor    # [T, B, A] (MAPPO: [T, B])
    reward: torch.Tensor   # [T, B, A] (MAPPO: the team's [T, B])
    done: torch.Tensor     # [T, B, A] bool (MAPPO: [T, B])


# ---- shared scaffolding between the PPO and MAPPO builders ----------------

def _make_opt(lr, anneal_iters, ppo_epochs) -> optim.Optimizer:
    """Global-norm clip + Adam; linear LR decay over
    anneal_iters*ppo_epochs updates counters the late-training drift
    typical of small-batch PPO."""
    sched = optim.linear_schedule(lr, 0.0, anneal_iters * ppo_epochs) if anneal_iters else lr
    return optim.clip_adam(sched, max_norm=0.5)


def _sample_move(logits, generator, mw, pad_c, dtype):
    """Categorical move draw from [..., A, mw] logits -> (padded action rows
    [..., A, mw+pad_c], idx [..., A], logp [..., A]). The head must be
    move-only: a wider head (e.g. the pg.py act_dim=env.action_width
    convention) would let idx land past the move range."""
    assert logits.shape[-1] == mw, (
        f"pi head width {logits.shape[-1]} != move width {mw}; build params with act_dim=5")
    idx = categorical(logits, generator)
    logp = index_logp(logits, idx)
    onehot = torch.nn.functional.one_hot(idx, mw).to(dtype)
    acts = torch.nn.functional.pad(onehot, (0, pad_c))
    return acts, idx, logp


def _gae_scan(values, rewards, dones, last_value, gamma, lam):
    """Reverse GAE over leading-time tensors -> (advantages, returns)."""
    advs = torch.empty_like(values)
    next_val, next_adv = last_value, torch.zeros_like(last_value)
    for t in range(values.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * next_val * nonterm - values[t]
        next_adv = delta + gamma * lam * nonterm * next_adv
        next_val = values[t]
        advs[t] = next_adv
    return advs, advs + values


def _clipped_objective(logits, act, logp_old, value, value_old, adv_b, ret, clip):
    """Shared clipped-surrogate pieces: (pg, vloss, ent). ``adv_b`` is
    already normalized and broadcast to ``logp``'s shape. The PPO-style
    clipped value loss limits how far the critic moves from its
    rollout-time predictions per iteration (same range as the policy clip,
    per the common PPO2 implementation)."""
    logp = index_logp(logits, act)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(ratio * adv_b, torch.clamp(ratio, 1 - clip, 1 + clip) * adv_b).mean()
    v_clip = value_old + torch.clamp(value - value_old, -clip, clip)
    vloss = torch.maximum((value - ret).square(), (v_clip - ret).square()).mean()
    log_probs = torch.log_softmax(logits, -1)
    ent = -(torch.softmax(logits, -1) * log_probs).sum(-1).mean()
    return pg, vloss, ent


def _normalized(adv):
    """JAX's ``(adv - mean) / (std + 1e-8)``, with the population std."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def _epoch_metrics_step(loss_fn, batch, opt, ppo_epochs, mean_rew, mesh=None):
    """-> epochs(params, opt_state) running ``ppo_epochs`` update epochs
    and returning the standard metrics dict (the last epoch's losses); with
    ``mesh`` each epoch's gradient and the metrics are means over the ranks."""
    def epochs(params, opt_state):
        for _ in range(ppo_epochs):
            leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss, (pg, vloss, ent) = loss_fn(leaves, batch)
            grads = list(torch.autograd.grad(loss, optim.tree_leaves(leaves)))
            if mesh is not None:
                grads = mesh.mean_(grads)
            updates, opt_state = opt.update(optim.tree_unflatten(leaves, grads), opt_state)
            params = optim.apply_updates(optim.tree_map(torch.Tensor.detach, leaves), updates)
        values = [loss.detach(), pg.detach(), vloss.detach(), ent.detach(), mean_rew]
        if mesh is not None:
            values = mesh.mean_(values)
        metrics = dict(zip(("loss", "pg_loss", "v_loss", "entropy", "mean_reward"), values))
        return (params, opt_state), metrics

    return epochs


def _finish(rollout, loss_fn, update, opt, mesh):
    """The common outer shell of both builders: ``step(state, generator)``
    (the rollout with the rank's generator, then the update) and the
    attributes a caller or a test reaches (``init_state``, and the rollout,
    loss and update on a given batch)."""
    def step(state, generator):
        if mesh is not None:
            generator = mesh.rank_key(generator)
        return update(state, *rollout(state[0], generator))

    step.init_state = lambda params: (params, opt.init(params))
    step.rollout, step.loss_fn, step.update, step.opt = rollout, loss_fn, update, opt
    return step


def _check_env(env: MpeEnv):
    if env.action_mode is not ActionMode.DISCRETE:
        raise ValueError(f"PPO samples one-hot moves: the env needs ActionMode.DISCRETE, "
                         f"got {env.action_mode}")


def build_ppo_step(
    env: MpeEnv,
    n_envs: int,
    n_steps: int = 64,
    lr: float = 3e-4,
    gamma: float = 0.95,
    lam: float = 0.95,
    clip: float = 0.2,
    vf_coef: float = 0.5,
    ent_coef: float = 0.01,
    ppo_epochs: int = 4,
    anneal_iters: int | None = None,
    mesh=None,
):
    """PPO iteration on ``env.device``:
    ``ppo_step(train_state, generator) -> (train_state, metrics dict)``
    where ``train_state = (params, opt_state)`` (build it with
    ``ppo_step.init_state(params)``). Metrics: ``loss``, ``pg_loss``,
    ``v_loss`` and ``entropy`` of the last epoch, and ``mean_reward``.

    Move-only policies (the comm slice stays zero); every agent's
    transitions train the shared network. Adam optimizer — the value and
    policy gradients differ by ~100x in scale through the shared torso,
    which plain SGD cannot balance. ``ppo_step.rollout(params, generator)
    -> (Transition, last_value)`` and ``ppo_step.update(train_state, traj,
    last_value)`` are its two halves; ``ppo_step.loss_fn(params, batch)``
    is the loss of one epoch. With ``mesh`` the rank rolls out its ``n_envs
    / size`` envs with ``mesh.rank_key(generator)`` and the update averages
    each epoch's gradient and the metrics over the ranks.
    """
    _check_env(env)
    opt = _make_opt(lr, anneal_iters, ppo_epochs)
    n_local = n_envs if mesh is None else mesh.local_envs(n_envs)
    mw = 2 * env.spec.dim_p + 1
    pad_c = env.action_width - mw

    def rollout(params, generator):
        """-> Transition with leaves [T, n_local, A, ...], last value [n_local, A]."""
        with torch.no_grad():
            states, obs = env.reset(n_local, generator)
            steps = []
            for _ in range(n_steps):
                logits, value = policy_value(params, obs)
                acts, idx, logp = _sample_move(logits, generator, mw, pad_c, env.dtype)
                states, obs2, rew, done, _ = env.step(states, acts, generator)
                steps.append(Transition(obs, idx, logp, value, rew, done))
                obs = obs2
            _, last_value = policy_value(params, obs)
        return Transition(*map(torch.stack, zip(*steps))), last_value

    def loss_fn(params, batch):
        obs, act, logp_old, value_old, adv, ret = batch
        logits, value = policy_value(params, obs)
        pg, vloss, ent = _clipped_objective(logits, act, logp_old, value, value_old,
                                            _normalized(adv), ret, clip)
        return pg + vf_coef * vloss - ent_coef * ent, (pg, vloss, ent)

    def update(state, traj: Transition, last_value):
        adv, ret = _gae_scan(traj.value, traj.reward, traj.done, last_value, gamma, lam)
        batch = (traj.obs, traj.act, traj.logp, traj.value, adv, ret)
        epochs = _epoch_metrics_step(loss_fn, batch, opt, ppo_epochs, traj.reward.mean(), mesh)
        return epochs(*state)

    return _finish(rollout, loss_fn, update, opt, mesh)


# ---------------------------------------------------------------------------
# MAPPO: centralized critic over the joint observation (CTDE — the
# standard cooperative-MPE recipe; actors stay decentralized)
# ---------------------------------------------------------------------------

def init_mappo(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
               hidden: int = 64, dtype=torch.float32) -> dict:
    """Decentralized actor ``a1, a2, pi`` (per-agent obs, shared params; pi
    at scale 0.01) and centralized critic ``c1, c2, v`` on the joint obs of
    all agents, drawn in that order from ``generator``."""
    return {
        "a1": dense_init(generator, obs_dim, hidden, dtype),
        "a2": dense_init(generator, hidden, hidden, dtype),
        "pi": dense_init(generator, hidden, act_dim, dtype, scale=0.01),
        "c1": dense_init(generator, obs_dim * n_agents, hidden, dtype),
        "c2": dense_init(generator, hidden, hidden, dtype),
        "v": dense_init(generator, hidden, 1, dtype),
    }


def actor_logits(params, obs):
    """obs [..., O] -> move logits [..., K]."""
    h = _torso(params, obs, "a1", "a2")
    return at_least_f32(h @ params["pi"]["w"] + params["pi"]["b"])


def central_value(params, obs):
    """obs [..., A, O] -> V of the joint state [...]."""
    joint = obs.reshape(*obs.shape[:-2], -1)
    h = _torso(params, joint, "c1", "c2")
    return at_least_f32((h @ params["v"]["w"] + params["v"]["b"])[..., 0])


def build_mappo_step(
    env: MpeEnv,
    n_envs: int,
    n_steps: int = 64,
    lr: float = 3e-4,
    gamma: float = 0.95,
    lam: float = 0.95,
    clip: float = 0.2,
    vf_coef: float = 0.5,
    ent_coef: float = 0.01,
    ppo_epochs: int = 4,
    anneal_iters: int | None = None,
    mesh=None,
):
    """MAPPO iteration (same train_state contract, attributes and ``mesh``
    as ``build_ppo_step``). Intended for collaborative scenarios (the shared
    team reward is the critic's target)."""
    _check_env(env)
    opt = _make_opt(lr, anneal_iters, ppo_epochs)
    n_local = n_envs if mesh is None else mesh.local_envs(n_envs)
    mw = 2 * env.spec.dim_p + 1
    pad_c = env.action_width - mw

    def rollout(params, generator):
        """-> Transition (value, team reward and team done [T, n_local]),
        last value [n_local]."""
        with torch.no_grad():
            states, obs = env.reset(n_local, generator)
            steps = []
            for _ in range(n_steps):
                acts, idx, logp = _sample_move(actor_logits(params, obs), generator, mw, pad_c,
                                               env.dtype)
                value = central_value(params, obs)
                states, obs2, rew, done, _ = env.step(states, acts, generator)
                # team reward: mean over agents (identical per agent in
                # collaborative scenarios)
                steps.append(Transition(obs, idx, logp, value, rew.mean(-1), done.all(-1)))
                obs = obs2
            last_value = central_value(params, obs)
        return Transition(*map(torch.stack, zip(*steps))), last_value

    def loss_fn(params, batch):
        obs, act, logp_old, value_old, adv, ret = batch
        logits = actor_logits(params, obs)                 # [..., A, K]
        value = central_value(params, obs)                 # [...]
        adv_b = _normalized(adv)[..., None]                # same adv per agent
        pg, vloss, ent = _clipped_objective(logits, act, logp_old, value, value_old, adv_b,
                                            ret, clip)
        return pg + vf_coef * vloss - ent_coef * ent, (pg, vloss, ent)

    def update(state, traj: Transition, last_value):
        adv, ret = _gae_scan(traj.value, traj.reward, traj.done, last_value, gamma, lam)
        batch = (traj.obs, traj.act, traj.logp, traj.value, adv, ret)
        epochs = _epoch_metrics_step(loss_fn, batch, opt, ppo_epochs, traj.reward.mean(), mesh)
        return epochs(*state)

    return _finish(rollout, loss_fn, update, opt, mesh)

"""REINFORCE learner (counterpart of ``mpe_tpu/learner/pg.py``): a
parameter-shared MLP policy and its training step on the batched
generic engine (``MpeEnv``).

The JAX package's step rolls each env out under ``vmap`` inside
``shard_map`` and ``pmean``-reduces the gradient over the env mesh. The
port's rollout runs batched over the envs on the env's device with no
gradient; the loss then takes the log-probs of the actions taken from one
batched forward, with autograd. With ``mesh=`` (a ``parallel.EnvMesh``) each
rank rolls out its share of the envs with its own generator
(``mesh.rank_key``) and the gradient and loss are means over the ranks.

The JAX functions cast logits to float32; the port casts to float32 at the
least (``torch.promote_types``), which is the same for float32 and
narrower params and keeps float64 params in float64.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch.core.actions import ActionMode
from mpe_tpu_torch.envs.functional import MpeEnv
from mpe_tpu_torch.learner import optim
from mpe_tpu_torch.learner._nets import at_least_f32, dense_init


def init_policy(generator: torch.Generator, obs_dim: int, act_dim: int, hidden: int = 64,
                dtype=torch.float32) -> dict:
    """Two-hidden-layer MLP shared across agents: ``{l1, l2, out}``."""
    return {
        "l1": dense_init(generator, obs_dim, hidden, dtype),
        "l2": dense_init(generator, hidden, hidden, dtype),
        "out": dense_init(generator, hidden, act_dim, dtype),
    }


def policy_logits(params, obs: torch.Tensor) -> torch.Tensor:
    """obs [..., O] -> logits [..., act_dim]."""
    x = obs.to(params["l1"]["w"].dtype)
    x = torch.tanh(x @ params["l1"]["w"] + params["l1"]["b"])
    x = torch.tanh(x @ params["l2"]["w"] + params["l2"]["b"])
    return at_least_f32(x @ params["out"]["w"] + params["out"]["b"])


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Indices ``[...]`` drawn from ``softmax(logits [..., K])`` by
    Gumbel-max, as ``jax.random.categorical`` draws (with another stream)."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device).clamp_min(tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _split_logits(env: MpeEnv, logits: torch.Tensor):
    move_w = 2 * env.spec.dim_p + 1
    return logits[..., :move_w], logits[..., move_w:]


def index_logp(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[idx] per row: [..., K], [...] -> [...]."""
    return torch.log_softmax(logits, -1).gather(-1, idx[..., None].long())[..., 0]


def action_logp(env: MpeEnv, logits: torch.Tensor, move_idx: torch.Tensor,
                comm_idx: torch.Tensor | None) -> torch.Tensor:
    """The joint log-prob of the moves (and utterances) taken: logits
    [..., A, W], indices [..., A] -> summed over agents [...]."""
    mlog, clog = _split_logits(env, logits)
    logp = index_logp(mlog, move_idx).sum(-1)
    if env.spec.dim_c:
        logp = logp + index_logp(clog, comm_idx).sum(-1)
    return logp


def _sample_indices(env: MpeEnv, logits: torch.Tensor, generator: torch.Generator):
    """(actions [..., A, W] one-hot rows of ``env.dtype``, move indices, comm
    indices or None)."""
    mlog, clog = _split_logits(env, logits)
    mi = categorical(mlog, generator)
    actions = torch.nn.functional.one_hot(mi, mlog.shape[-1]).to(env.dtype)
    ci = None
    if env.spec.dim_c:
        ci = categorical(clog, generator)
        comm = torch.nn.functional.one_hot(ci, clog.shape[-1]).to(env.dtype)
        actions = torch.cat([actions, comm], dim=-1)
    return actions, mi, ci


def sample_actions(env: MpeEnv, params, obs: torch.Tensor, generator: torch.Generator):
    """Sample canonical one-hot actions: obs [..., A, O] -> (actions
    [..., A, W], logp [...]), the log-prob summed over agents."""
    assert env.action_mode is ActionMode.DISCRETE
    logits = policy_logits(params, obs)
    actions, mi, ci = _sample_indices(env, logits, generator)
    return actions, action_logp(env, logits, mi, ci)


def _returns_to_go(team_rew: torch.Tensor, gamma: float) -> torch.Tensor:
    """Reverse discounted cumulative return over the leading time axis."""
    out = torch.empty_like(team_rew)
    g = torch.zeros_like(team_rew[0])
    for t in range(team_rew.shape[0] - 1, -1, -1):
        g = team_rew[t] + gamma * g
        out[t] = g
    return out


def _rollout(env: MpeEnv, params, generator: torch.Generator, n_envs: int, n_steps: int):
    """One batched episode of ``n_steps`` without gradient -> (obs [T, B, A,
    O], move indices [T, B, A], comm indices or None, team reward [T, B])."""
    with torch.no_grad():
        state, obs = env.reset(n_envs, generator)
        seen, moves, comms, rews = [], [], [], []
        for _ in range(n_steps):
            actions, mi, ci = _sample_indices(env, policy_logits(params, obs), generator)
            seen.append(obs)
            moves.append(mi)
            comms.append(ci)
            state, obs, rew, _, _ = env.step(state, actions, generator)
            rews.append(rew.sum(-1))
    comm = torch.stack(comms) if env.spec.dim_c else None
    return torch.stack(seen), torch.stack(moves), comm, torch.stack(rews)


def reinforce_loss(env: MpeEnv, params, obs, move_idx, comm_idx, team_rew,
                   gamma: float = 0.95) -> torch.Tensor:
    """``-mean(logp * returns)`` over steps and envs of an episode: the
    log-probs of the actions taken carry the gradient, the discounted
    returns-to-go none (JAX's ``stop_gradient``)."""
    logp = action_logp(env, policy_logits(params, obs), move_idx, comm_idx)     # [T, B]
    returns = _returns_to_go(team_rew, gamma).detach()
    return -(logp * returns).mean()


def _episode_loss(env: MpeEnv, params, generator: torch.Generator, n_envs: int,
                  n_steps: int, gamma: float = 0.95) -> torch.Tensor:
    """REINFORCE loss of ``n_envs`` on-device episodes, the mean of JAX's
    per-env loss."""
    return reinforce_loss(env, params, *_rollout(env, params, generator, n_envs, n_steps),
                          gamma)


def build_train_step(env: MpeEnv, n_envs: int, n_steps: int = 25, lr: float = 1e-3,
                     mesh=None):
    """REINFORCE step: ``train_step(params, generator) -> (params, loss)``,
    one SGD step of autograd's gradient of ``n_envs`` episodes of
    ``n_steps`` on ``env.device``. With ``mesh`` the rank runs its ``n_envs /
    size`` episodes with ``mesh.rank_key(generator)``, and the gradient (one
    ``all_reduce`` of its leaves concatenated) and the loss are means over
    the ranks, so every rank takes the same step."""
    assert env.action_mode is ActionMode.DISCRETE
    n_local = n_envs if mesh is None else mesh.local_envs(n_envs)

    def train_step(params, generator: torch.Generator):
        if mesh is not None:
            generator = mesh.rank_key(generator)
        leaves = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = _episode_loss(env, leaves, generator, n_local, n_steps)
        grads = list(torch.autograd.grad(loss, optim.tree_leaves(leaves)))
        loss = loss.detach()
        if mesh is not None:
            *grads, loss = mesh.mean_(grads + [loss])
        grads = optim.tree_unflatten(leaves, grads)
        new = optim.tree_map(lambda x, g: (x - lr * g.to(x.dtype)).detach(), leaves, grads)
        return new, loss

    return train_step

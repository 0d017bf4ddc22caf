"""MADDPG with a centralized critic on the fused engine, one device
(counterpart of ``mpe_tpu/learner/maddpg.py``).

Per-agent actors ``mu_i(o_i)`` -> move logits (and comm logits where the
scenario speaks, ``maddpg_act_dim``) and per-agent critics ``Q_i(o_1..A,
a_1..A)`` (Lowe et al. 2017), every leaf stacked on a leading agent axis
``[A, ...]``. Replay lives on the device in one 2-D row table
(``Buffer``: row = ``[obs | act | rew | obs2]``), filled by kernel K8
(``build_fused_collect``) and read by ``build_fused_update_chunk``, whose
gradient is kernel K9 (``grad_engine="kernel"``) or autograd of the same
losses (``grad_engine="autograd"``, ``maddpg_xla_grads``). Episodes end only
by time limit, so TD targets bootstrap through the horizon on the stored
true pre-reset next obs.

Ported: the centralized critic on the nine scenarios, comm heads included
(the factored move x comm policy); ``local_critic`` (independent DDPG: each
critic sees only its own ``[obs_i | act_i]``, on the autograd engine); the
per-step learner ``build_maddpg`` with ``gumbel_softmax_st`` on the generic
engine. The ensemble and approximate-policy variants are
``learner/ensemble.py`` and ``learner/approx_others.py``.
``build_fused_maddpg_dp`` is the data-parallel loop over the ranks of a
``parallel.EnvMesh``: local replay shards, K9's flat gradient averaged by one
``all_reduce`` per update, Adam and Polyak alike on every rank.

The ring is updated in place (``build_fused_collect`` writes the chunk into
``buffer.data``; the returned ``Buffer`` shares it): at 1,638,400 rows of
126 floats (simple_spread; 468 on simple_world_comm) a functional copy per
insert would move 826 MB (3.07 GB). ``ptr`` and
``size`` are host integers: they advance by a fixed count per insert, so
nothing waits for the device to know them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner._nets import dense_init
from mpe_tpu_torch.learner.optim import AdamState, adam, apply_updates, tree_map
from mpe_tpu_torch.ops.fused_maddpg_update import _split_rows, head_onehots, target_indices


def _tree3(fn, *trees):
    """``fn`` over the leaves of ``{"actor" | "critic": {layer: {w, b}}}``."""
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}


def init_maddpg(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
                hidden: int = 64, dtype=torch.float32, local_critic: bool = False) -> dict:
    """Stacked per-agent actors and critics: every leaf has a leading [A]
    axis. Agent by agent, the draws are actor l1, l2, out (scale 0.01), then
    critic l1, l2, out, all from ``generator``. The critic's l1 takes the
    joint ``A*(obs_dim+act_dim)`` input (centralized), or with
    ``local_critic=True`` only the agent's own ``obs_dim+act_dim``
    (independent DDPG, the MADDPG paper's decentralized baseline)."""
    cin = obs_dim + act_dim if local_critic else n_agents * (obs_dim + act_dim)
    per_agent = []
    for _ in range(n_agents):
        per_agent.append({
            "actor": {"l1": dense_init(generator, obs_dim, hidden, dtype),
                      "l2": dense_init(generator, hidden, hidden, dtype),
                      "out": dense_init(generator, hidden, act_dim, dtype, scale=0.01)},
            "critic": {"l1": dense_init(generator, cin, hidden, dtype),
                       "l2": dense_init(generator, hidden, hidden, dtype),
                       "out": dense_init(generator, hidden, 1, dtype)},
        })
    return _tree3(lambda *xs: torch.stack(xs), *per_agent)


def _mlp(params, x):
    x = torch.tanh(x @ params["l1"]["w"] + params["l1"]["b"])
    x = torch.tanh(x @ params["l2"]["w"] + params["l2"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def actor_logits_i(actor_params, obs):
    """One agent's actor: obs [..., O] -> logits [..., K]."""
    return _mlp(actor_params, obs)


def critic_q_i(critic_params, joint):
    """One agent's critic: joint [..., A*(O+K)] -> Q [...]."""
    return _mlp(critic_params, joint)[..., 0]


def actor_logits(actor_params, obs):
    """Every agent's actor on its own obs: [..., A, O] -> logits [..., A, K]."""
    x = torch.tanh(torch.einsum("...ai,aio->...ao", obs, actor_params["l1"]["w"])
                   + actor_params["l1"]["b"])
    x = torch.tanh(torch.einsum("...ai,aio->...ao", x, actor_params["l2"]["w"])
                   + actor_params["l2"]["b"])
    return torch.einsum("...ai,aio->...ao", x, actor_params["out"]["w"]) + actor_params["out"]["b"]


def critic_q(critic_params, joint):
    """Every agent's critic on one joint input: [B, J] -> Q [A, B]."""
    x = torch.tanh(torch.einsum("bj,ajh->abh", joint, critic_params["l1"]["w"])
                   + critic_params["l1"]["b"][:, None])
    x = torch.tanh(torch.einsum("abh,ahg->abg", x, critic_params["l2"]["w"])
                   + critic_params["l2"]["b"][:, None])
    return (torch.einsum("abg,ago->abo", x, critic_params["out"]["w"])
            + critic_params["out"]["b"][:, None])[..., 0]


def critic_q_own(critic_params, own):
    """Every agent's local critic on its own input: [B, A, O+K] -> Q [A, B]."""
    x = torch.tanh(torch.einsum("bai,aih->abh", own, critic_params["l1"]["w"])
                   + critic_params["l1"]["b"][:, None])
    x = torch.tanh(torch.einsum("abh,ahg->abg", x, critic_params["l2"]["w"])
                   + critic_params["l2"]["b"][:, None])
    return (torch.einsum("abg,ago->abo", x, critic_params["out"]["w"])
            + critic_params["out"]["b"][:, None])[..., 0]


def maddpg_act_dim(env) -> int:
    """Actor output width for ``env``: the 5-wide move head, plus a
    dim_c-wide comm head when any agent speaks."""
    mw = 2 * env.spec.dim_p + 1
    cw = 0 if all(env.spec.silent) else env.spec.dim_c
    return mw + cw


def gumbel_softmax_st(logits, generator: torch.Generator | None = None, tau: float = 1.0,
                      uniform=None):
    """Straight-through Gumbel-softmax: the one-hot of ``argmax(softmax((z +
    g) / tau))`` forward, the soft sample's gradient backward, ``g = -log(-
    log u)`` for ``u`` uniform in ``[1e-10, 1)`` drawn from ``generator`` (or
    the given ``uniform``, the shape of ``logits``)."""
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                             device=logits.device)
        uniform = uniform * (1.0 - 1e-10) + 1e-10
    soft = torch.softmax((logits - torch.log(-torch.log(uniform))) / tau, dim=-1)
    hard = torch.nn.functional.one_hot(soft.argmax(-1), logits.shape[-1]).to(soft.dtype)
    return hard + soft - soft.detach()


@dataclasses.dataclass(frozen=True)
class Buffer:
    """On-device replay ring: ONE 2-D row table ``data [cap, W]``, row
    ``[obs | act | rew | obs2]`` flattened agent-major, ``W = A*(2*O + K +
    1)``. ``ptr`` (next row to write) and ``size`` (rows filled) are host
    integers. The ``obs/act/rew/obs2`` properties are per-field views; hot
    paths gather ``data`` rows first and split them (``_split``)."""
    data: torch.Tensor
    ptr: int
    size: int
    n_agents: int = 0
    obs_dim: int = 0
    act_dim: int = 0

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def _check_meta(self):
        if not (self.n_agents > 0 and self.obs_dim > 0 and self.act_dim > 0):
            raise ValueError("Buffer built without its meta (n_agents/obs_dim/act_dim): "
                             "construct it with init_buffer() or Buffer.pack()")

    def _split(self, rows):
        """[R, W] rows -> (obs [R, A, O], act [R, A, K], rew [R, A], obs2 [R, A, O])."""
        self._check_meta()
        return _split_rows(rows, self.n_agents, self.obs_dim, self.act_dim)

    @property
    def obs(self):
        self._check_meta()
        a, o = self.n_agents, self.obs_dim
        return self.data[:, :a * o].reshape(-1, a, o)

    @property
    def act(self):
        self._check_meta()
        a, o, k = self.n_agents, self.obs_dim, self.act_dim
        return self.data[:, a * o:a * (o + k)].reshape(-1, a, k)

    @property
    def rew(self):
        self._check_meta()
        a, o, k = self.n_agents, self.obs_dim, self.act_dim
        return self.data[:, a * (o + k):a * (o + k + 1)]

    @property
    def obs2(self):
        self._check_meta()
        a, o, k = self.n_agents, self.obs_dim, self.act_dim
        return self.data[:, a * (o + k + 1):].reshape(-1, a, o)

    @classmethod
    def pack(cls, obs, act, rew, obs2, ptr: int, size: int):
        """A Buffer from per-field [cap, A, X] / [cap, A] tensors."""
        cap, a, o = obs.shape
        data = torch.cat([obs.reshape(cap, -1), act.reshape(cap, -1), rew,
                          obs2.reshape(cap, -1)], dim=1).to(torch.float32).contiguous()
        return cls(data=data, ptr=int(ptr), size=int(size), n_agents=a, obs_dim=o,
                   act_dim=act.shape[-1])


def init_buffer(capacity: int, n_agents: int, obs_dim: int, act_dim: int, device=None) -> Buffer:
    w = n_agents * (2 * obs_dim + act_dim + 1)
    return Buffer(data=torch.zeros((capacity, w), dtype=torch.float32,
                                   device=resolve_device(device)),
                  ptr=0, size=0, n_agents=n_agents, obs_dim=obs_dim, act_dim=act_dim)


def _gate_agents(gate, n_agents: int) -> list[bool]:
    """A scalar gate or one per agent -> [A] host booleans."""
    g = np.asarray(gate.cpu() if isinstance(gate, torch.Tensor) else gate, dtype=bool)
    if g.ndim == 0:
        return [bool(g)] * n_agents
    if g.shape != (n_agents,):
        raise ValueError(f"gate must be a scalar or have shape ({n_agents},), got {g.shape}")
    return [bool(x) for x in g]


def _select_agents(keep_new: list[bool], new, old):
    """Leaf [A, ...]: agent i's slice from ``new`` where ``keep_new[i]``,
    else from ``old`` (the values of ``jnp.where`` over the agent axis)."""
    if all(keep_new):
        return new
    return torch.cat([(new if k else old)[i:i + 1] for i, k in enumerate(keep_new)])


def _apply_maddpg_update(params, targets, opt_states, grads, gate, *, actor_opt, critic_opt,
                         tau_polyak: float):
    """The tail of every MADDPG update: Adam on both nets, actor gating,
    Polyak averaging of the targets (``t <- (1 - tau) t + tau p``).

    ``gate`` is a scalar (every actor steps or none) or one entry per agent
    (each agent's actor and its Adam ``mu``/``nu`` step only where its gate
    is set); the actors' shared Adam ``count`` advances iff any agent steps,
    so a uniform vector equals the scalar. The gates are host values: the
    selection is slicing, not a select on the device."""
    cupd, copt = critic_opt.update(grads["critic"], opt_states["critic"])
    new_critic = apply_updates(params["critic"], cupd)
    a = params["actor"]["l1"]["w"].shape[0]
    keep = _gate_agents(gate, a)
    if any(keep):
        aupd, aopt = actor_opt.update(grads["actor"], opt_states["actor"])
        new_actor = apply_updates(params["actor"], aupd)
        old = opt_states["actor"]

        def sel(n, o):
            return _select_agents(keep, n, o)

        new_actor = tree_map(sel, new_actor, params["actor"])
        aopt = aopt._replace(mu=tree_map(sel, aopt.mu, old.mu), nu=tree_map(sel, aopt.nu, old.nu))
    else:
        new_actor, aopt = params["actor"], opt_states["actor"]
    params = {"actor": new_actor, "critic": new_critic}
    targets = _tree3(lambda t, p: (1 - tau_polyak) * t + tau_polyak * p, targets, params)
    return params, targets, {"actor": aopt, "critic": copt}


def build_maddpg(env, n_envs: int = 32, capacity: int = 50_000, batch: int = 256,
                 gamma: float = 0.95, tau_polyak: float = 0.05, gumbel_tau: float = 1.0,
                 eps_greedy: float = 0.1, actor_lr: float = 1e-3, critic_lr: float = 1e-3,
                 ent_coef: float = 0.01):
    """The per-step MADDPG learner on the generic engine, on ``env.device``
    (no kernel) -> ``(reset_fn, collect_fn, update_fn, init_opt)``:

    - ``reset_fn(generator) -> (env_states, obs)``;
    - ``collect_fn(params, env_states, obs, buffer, generator) ->
      (env_states, obs, buffer, mean_reward)``: one step of every env with
      exploratory actions (per head, a straight-through Gumbel one-hot, or
      with probability ``eps_greedy`` a uniform one-hot; the comm head drawn
      on its own where the scenario speaks), stepped on a twin of ``env``
      without auto-reset so that the stored ``obs2`` is the true pre-reset
      next obs; the rows ``[obs | act | rew | obs2]`` go into the ring at
      ``ptr`` (in place), then the lanes whose episode is done are reset;
    - ``update_fn(params, targets, opt_states, buffer, generator_or_seed,
      do_actor=True, indices=None) -> (params, targets, opt_states,
      metrics)``: ``maddpg_xla_grads`` on ``batch`` rows drawn from the ring
      (``indices [batch]`` replaces the draw), then ``_apply_maddpg_update``
      with the actor gate ``do_actor``;
    - ``init_opt(params)``: both Adam states.

    ``env`` must step discrete one-hots with a horizon and auto-reset, as in
    JAX. ``capacity % n_envs == 0`` is required (each step writes ``n_envs``
    rows): the JAX defaults, 32 envs and a capacity of 50,000, fail it, and
    are kept as JAX's."""
    from mpe_tpu_torch.core.actions import ActionMode
    from mpe_tpu_torch.envs.functional import MpeEnv

    if env.action_mode is not ActionMode.DISCRETE or not env.auto_reset:
        raise ValueError("build_maddpg needs an env of ActionMode.DISCRETE with max_steps and "
                         "auto_reset=True")
    if capacity % n_envs:
        raise ValueError(f"capacity ({capacity}) must be a multiple of n_envs ({n_envs})")
    env_plain = MpeEnv(env.scenario, action_mode=env.action_mode, max_steps=env.max_steps,
                       auto_reset=False, dtype=env.dtype, device=env.device)
    a = env.n_agents
    mw = 2 * env.spec.dim_p + 1
    aw = maddpg_act_dim(env)
    cw = aw - mw
    pad_c = env.action_width - aw
    actor_opt, critic_opt = adam(actor_lr), adam(critic_lr)

    def init_opt(params):
        return {"actor": actor_opt.init(params["actor"]),
                "critic": critic_opt.init(params["critic"])}

    def head(logits, generator, width):
        sampled = gumbel_softmax_st(logits, generator, gumbel_tau)
        rand = torch.nn.functional.one_hot(
            torch.randint(0, width, logits.shape[:-1], generator=generator,
                          device=logits.device), width).to(sampled.dtype)
        take_rand = torch.rand(logits.shape[:-1] + (1,), generator=generator,
                               dtype=sampled.dtype, device=logits.device) < eps_greedy
        return torch.where(take_rand, rand, sampled)

    def act(params, obs, generator):
        """obs [n, A, O] -> exploratory one-hots [n, A, aw]."""
        logits = actor_logits(params["actor"], obs)
        parts = [head(logits[..., :mw], generator, mw)]
        if cw:
            parts.append(head(logits[..., mw:], generator, cw))
        return torch.cat(parts, dim=-1)

    def reset_fn(generator):
        return env.reset(n_envs, generator)

    def collect_fn(params, env_states, obs, buffer: Buffer, generator):
        with torch.no_grad():
            moves = act(params, obs, generator)
            acts = torch.cat([moves, moves.new_zeros((n_envs, a, pad_c))], dim=-1).to(env.dtype)
            states2, obs2, rew, done, _ = env_plain.step(env_states, acts, generator)
            f32 = torch.float32                    # the ring is float32 whatever the env's dtype
            rows = torch.cat([obs.to(f32).reshape(n_envs, -1), moves.to(f32).reshape(n_envs, -1),
                              rew.to(f32), obs2.to(f32).reshape(n_envs, -1)], dim=1)
            # JAX's dynamic_update_slice clamps a start past cap - n_envs
            start = min(buffer.ptr, buffer.data.shape[0] - n_envs)
            buffer.data[start:start + n_envs] = rows
            buffer = buffer._replace(ptr=(buffer.ptr + n_envs) % capacity,
                                     size=min(buffer.size + n_envs, capacity))
            fresh, fresh_obs = env.reset(n_envs, generator)
            ep_done = done.all(-1)

            def select(new, old):
                return torch.where(ep_done.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

            return fresh.map(select, states2), select(fresh_obs, obs2), buffer, rew.mean()

    def update_fn(params, targets, opt_states, buffer: Buffer, generator_or_seed,
                  do_actor=True, indices=None):
        if indices is not None:
            indices = (indices if isinstance(indices, torch.Tensor)
                       else np.asarray(indices)).reshape(1, -1)
        rows = sample_rows(buffer, generator_or_seed, 1, batch, indices)[0][0]
        grads, (closs, aloss, qmean) = maddpg_xla_grads(
            params, targets, *buffer._split(rows.to(params["actor"]["l1"]["w"].dtype)), mw=mw,
            cw=cw, gamma=gamma, ent_coef=ent_coef)
        params, targets, opt_states = _apply_maddpg_update(
            params, targets, opt_states, grads, do_actor, actor_opt=actor_opt,
            critic_opt=critic_opt, tau_polyak=tau_polyak)
        return params, targets, opt_states, {"critic_loss": closs, "actor_loss": aloss,
                                             "q": qmean}

    return reset_fn, collect_fn, update_fn, init_opt


def _joint(obs_b, act_b):
    """[B, A, O], [B, A, K] -> [B, A*(O+K)]."""
    return torch.cat([obs_b.reshape(obs_b.shape[0], -1), act_b.reshape(act_b.shape[0], -1)],
                     dim=-1)


def _candidate_table(mw: int, cw: int, aw: int, dtype=torch.float32, device=None):
    """Every joint (move[, comm]) one-hot an agent can emit: [C, aw], C = mw
    (* cw on comm scenarios), candidate ``k * max(cw, 1) + j``."""
    cand = torch.zeros((mw * max(cw, 1), aw), dtype=dtype, device=device)
    for k in range(mw):
        for j in range(max(cw, 1)):
            cand[k * max(cw, 1) + j, k] = 1.0
            if cw:
                cand[k * max(cw, 1) + j, mw + j] = 1.0
    return cand


def _target_actions(target_actor, obs2_b, mw: int, cw: int):
    """Target actors' first-argmax one-hots per head: [B, A, O] -> [B, A, K]."""
    logits = actor_logits(target_actor, obs2_b)
    return head_onehots(target_indices(logits, mw), mw, mw + cw, obs2_b.dtype)


def expected_q_actor_loss(actor_params, critic_params, obs_b, act_b, *, mw: int, cw: int,
                          ent_coef: float, local_critic: bool = False):
    """The exact expected-Q actor objective (the loss kernel K9
    differentiates): each agent maximizes the expectation of its critic
    (held fixed) over its own discrete action set under its softmax policy,
    with the other agents' buffer actions fixed, plus the entropy bonus
    ``-sum p log(p + 1e-10)``; averaged over the batch and the agents.
    ``local_critic`` scores each candidate on the agent's own ``[obs_i |
    cand]`` (independent DDPG)."""
    batch, a, aw = act_b.shape
    cand = _candidate_table(mw, cw, aw, act_b.dtype, act_b.device)
    n_cand = cand.shape[0]
    logits = actor_logits(actor_params, obs_b)
    probs_m = torch.softmax(logits[..., :mw], dim=-1)               # [B, A, mw]
    probs_c = torch.softmax(logits[..., mw:], dim=-1) if cw else None
    obs_flat = obs_b.reshape(1, batch, -1).expand(n_cand, batch, -1)
    total = 0.0
    for i in range(a):
        cp = tree_map(lambda x: x[i].detach(), critic_params)
        if local_critic:
            joint = torch.cat([obs_b[:, i].expand(n_cand, batch, -1),
                               cand[:, None, :].expand(n_cand, batch, aw)], dim=-1)
        else:
            mixed = act_b.expand((n_cand,) + act_b.shape).clone()    # [C, B, A, aw]
            mixed[:, :, i, :] = cand[:, None, :]
            joint = torch.cat([obs_flat, mixed.reshape(n_cand, batch, -1)], dim=-1)
        q_all = critic_q_i(cp, joint)                               # [C, B]
        w = probs_m[:, i]
        if cw:
            w = (w[..., :, None] * probs_c[:, i][..., None, :]).reshape(batch, n_cand)
        exp_q = (w * q_all.T.detach()).sum(-1)
        ent = -(probs_m[:, i] * torch.log(probs_m[:, i] + 1e-10)).sum(-1)
        if cw:
            ent = ent - (probs_c[:, i] * torch.log(probs_c[:, i] + 1e-10)).sum(-1)
        total = total - (exp_q + ent_coef * ent).mean()
    return total / a


def _value_and_grad(loss_fn, tree):
    """``jax.value_and_grad`` over a ``{layer: {w, b}}`` tree: ``loss_fn(
    tree)`` -> (loss or (loss, aux), the gradient tree), detached."""
    with torch.enable_grad():
        leaves = tree_map(lambda x: x.detach().requires_grad_(True), tree)
        out = loss_fn(leaves)
        loss = out[0] if isinstance(out, tuple) else out
        g = iter(torch.autograd.grad(loss, [leaves[k][w] for k in leaves for w in leaves[k]]))
    grads = tree_map(lambda _: next(g), leaves)
    if isinstance(out, tuple):
        return tuple(x.detach() for x in out), grads
    return out.detach(), grads


def maddpg_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, *, mw: int, cw: int,
                     gamma: float, ent_coef: float, local_critic: bool = False):
    """The MADDPG gradient on a sampled batch by autograd (the port's
    counterpart of the JAX package's ``maddpg_xla_grads``, its ``"xla"``
    engine: ``jax.grad`` of the same losses): first-argmax target actions
    -> TD targets ``y = r + gamma Q'`` -> the critic's mean of ``(Q - y)^2``
    over [A, B] -> the exact expected-Q actor objective. Returns ``(grads,
    (critic_loss, actor_loss, q_mean))``; also kernel K9's library
    yardstick.

    ``local_critic=True`` is independent DDPG: each critic sees only its
    own ``[obs_i | act_i]`` (``[B, A, O+K]``), for the TD target and the
    loss alike. With one agent the two are the same function."""
    def q_of(critic_params, obs, act):
        if local_critic:
            return critic_q_own(critic_params, torch.cat([obs, act], dim=-1))
        return critic_q(critic_params, _joint(obs, act))

    with torch.no_grad():
        y = rew_b.T + gamma * q_of(targets["critic"], obs2_b,
                                   _target_actions(targets["actor"], obs2_b, mw, cw))  # [A, B]

    def critic_loss(cp):
        q = q_of(cp, obs_b, act_b)
        return (q - y).square().mean(), q.mean()

    (closs, qmean), cgrads = _value_and_grad(critic_loss, params["critic"])
    aloss, agrads = _value_and_grad(
        lambda ap: expected_q_actor_loss(ap, params["critic"], obs_b, act_b, mw=mw, cw=cw,
                                         ent_coef=ent_coef, local_critic=local_critic),
        params["actor"])
    return {"actor": agrads, "critic": cgrads}, (closs, aloss, qmean)


def _dims(env):
    """(kernel scenario, obs width, act width, move width, comm width)."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(env.scenario)
    aw = maddpg_act_dim(env)
    mw = 2 * env.spec.dim_p + 1
    return kscn, kscn.obs_w, aw, mw, aw - mw


def _make_grads_fn(env, grad_engine: str, *, batch: int, gamma: float, ent_coef: float,
                   hidden: int, device, dtype, local_critic: bool = False,
                   compute_dtype=torch.float32):
    """``grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b)`` with
    ``grads_fn.from_rows(params, targets, rows_b)``: ``"kernel"`` is kernel
    K9, or K9-bf16 with ``compute_dtype=torch.bfloat16``
    (``ops/fused_maddpg_update``; its plain version on the CPU),
    ``"autograd"`` is ``maddpg_xla_grads``, which ignores ``compute_dtype``
    as JAX's ``"xla"`` engine does. ``local_critic`` (independent DDPG) takes
    the autograd engine only: K9 is a centralized-critic kernel."""
    from mpe_tpu_torch.ops.fused_maddpg_update import fused_maddpg_update, maddpg_rounding

    maddpg_rounding(compute_dtype)
    _, obs_dim, aw, mw, cw = _dims(env)
    if local_critic and grad_engine == "kernel":
        raise ValueError("independent-DDPG critics (local_critic=True) need "
                         "grad_engine='autograd': the MADDPG update kernel K9 is centralized-"
                         "critic only")
    if grad_engine == "kernel":
        return fused_maddpg_update(env.n_agents, obs_dim, aw, mw, hidden=hidden, batch=batch,
                                   gamma=gamma, ent_coef=ent_coef, device=device, dtype=dtype,
                                   compute_dtype=compute_dtype)
    if grad_engine != "autograd":
        raise ValueError(f"grad_engine must be 'kernel' or 'autograd', got {grad_engine!r}")
    def grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b):
        return maddpg_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, mw=mw, cw=cw,
                                gamma=gamma, ent_coef=ent_coef, local_critic=local_critic)

    grads_fn.from_rows = lambda params, targets, rows_b: grads_fn(
        params, targets, *_split_rows(rows_b, env.n_agents, obs_dim, aw))
    return grads_fn


class PackedState(NamedTuple):
    """The update chunk's state in K9's layout (``ops.fused_maddpg_update.
    PackedLayout``): ``weights`` holds params and targets, one flat buffer
    that the chunk updates in place; each Adam state's ``mu`` and ``nu`` are
    one-leaf trees ``{"flat": {"x": [A, stride]}}`` of the same layout."""
    weights: torch.Tensor
    actor_opt: AdamState
    critic_opt: AdamState


def _flat(x):
    return {"flat": {"x": x}}


def sample_rows(buffer: Buffer, key, n_updates: int, batch: int, indices=None):
    """``n_updates`` replay batches gathered in one read -> (rows ``[n_updates,
    batch, W]``, their indices): ``torch.randint`` rows in ``[0, max(size,
    1))`` from ``key``, a generator on the ring's device or an int that
    seeds one (JAX draws them by threefry from its key, which the port
    cannot reproduce), or the given ``indices [n_updates, batch]`` (the
    tests inject JAX's)."""
    dev = buffer.data.device
    if indices is None:
        gen = (key if isinstance(key, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(key)))
        indices = torch.randint(0, max(buffer.size, 1), (n_updates, batch), generator=gen,
                                device=dev)
    elif not isinstance(indices, torch.Tensor):
        indices = torch.tensor(np.asarray(indices), dtype=torch.int64)
    indices = indices.to(dev)
    if tuple(indices.shape) != (n_updates, batch):
        raise ValueError(f"indices has shape {tuple(indices.shape)}, expected "
                         f"{(n_updates, batch)}")
    return buffer.data[indices.reshape(-1)].reshape(n_updates, batch, -1), indices


def build_fused_update_chunk(env, n_updates: int, batch: int = 256, gamma: float = 0.95,
                             tau_polyak: float = 0.05, actor_lr: float = 1e-3,
                             critic_lr: float = 1e-3, ent_coef: float = 0.01, hidden: int = 64,
                             grad_engine: str = "kernel", device=None, dtype=torch.float32,
                             local_critic: bool = False, mesh=None, compute_dtype=torch.float32):
    """``n_updates`` sequential updates per call, their replay batches
    gathered in one read: ``update_chunk(params, targets, opt_states,
    buffer, key, gates, indices=None) -> (params, targets, opt_states,
    metrics)``.

    The batches are ``sample_rows``: ``torch.randint`` rows from a generator
    seeded with the int ``key``, or the given ``indices [n_updates, batch]``.
    ``gates`` is ``[n_updates]`` (each update's actor gate) or ``[n_updates,
    A]`` (per agent), host booleans. ``metrics`` holds the last update's
    ``critic_loss``, ``actor_loss`` and ``q``.

    As JAX's chunk steps Adam in its packed space, this one packs params,
    targets and both Adam states once (``pack_state``) into K9's weight
    buffer and moments of its layout (``PackedState``), runs every update
    there, and unpacks once at the end (``unpack_state``): kernel K9 reads
    the buffer and writes the gradient into one flat buffer, Adam
    (``optim.adam``'s arithmetic on the flat moments, the shared ``count``,
    per-agent actor gating as a row select) and Polyak update the buffer in
    place, elementwise, so the chunk equals the tree form element for
    element (the padding keeps a zero gradient and stays 0).
    ``packed_step(state, buffer, key, gates, indices=None) -> (state,
    metrics)`` is the chunk on a packed state, ``actor_of(state)`` its
    actors as a tree; ``update_chunk.plain`` is the chunk in tree form with
    kernel K9's plain version.

    ``compute_dtype=torch.bfloat16`` is JAX's ``compute_dtype=bfloat16`` of
    the kernel engine: on CUDA kernel K9-bf16 in place of K9 (every product
    on the tensor cores in bf16, float32 sums; at every hidden width K9
    takes, 8-256, the wide kernels at 128 and 256), on the CPU the plain
    version's bf16 path; the params, the Adam moments and the Polyak targets
    stay in ``dtype``. The default float32 (or None) is K9. The
    ``"autograd"`` engine ignores it, as JAX's ``"xla"`` engine does.

    ``local_critic=True`` (independent DDPG; ``grad_engine="autograd"``
    only, as in JAX) packs critics of the own ``obs+act`` input: the layout
    takes the critic's input width, and K9 is never launched on it.

    With ``mesh`` (a ``parallel.EnvMesh``) every update's gradient is the
    mean over the ranks of their own batches' (the packed flat gradient in
    one ``all_reduce``, as JAX's ``pmean``), so Adam and Polyak step alike
    on every rank."""
    from mpe_tpu_torch.ops.fused_maddpg_update import (MaddpgUpdateLauncher, PackedLayout,
                                                       _net_buffer)

    device = resolve_device(device)
    actor_opt, critic_opt = adam(actor_lr), adam(critic_lr)
    grads_fn = _make_grads_fn(env, grad_engine, batch=batch, gamma=gamma, ent_coef=ent_coef,
                              hidden=hidden, device=device, dtype=dtype,
                              local_critic=local_critic, compute_dtype=compute_dtype)
    _, obs_dim, aw, mw, _ = _dims(env)
    a = env.n_agents
    layout = PackedLayout(a, obs_dim, aw, hidden,
                          critic_in=obs_dim + aw if local_critic else None)
    launcher = {}                                  # K9, built at the first packed update

    def chunk_rows(buffer, key, gates, indices):
        """-> (rows [n_updates, batch, W], gates as a bool array)."""
        gates = np.asarray(gates.cpu() if isinstance(gates, torch.Tensor) else gates, dtype=bool)
        if gates.shape[:1] != (n_updates,):
            raise ValueError(f"gates has shape {gates.shape}, expected ({n_updates},) or "
                             f"({n_updates}, A)")
        return sample_rows(buffer, key, n_updates, batch, indices)[0], gates

    def chunk_with(grads):
        def update_chunk(params, targets, opt_states, buffer: Buffer, key, gates, indices=None):
            rows, gates = chunk_rows(buffer, key, gates, indices)
            metrics = None
            for u in range(n_updates):
                g, (closs, aloss, qmean) = grads.from_rows(params, targets, rows[u].to(dtype))
                if mesh is not None:
                    mesh.mean_([x for net in g.values() for layer in net.values()
                                for x in layer.values()])
                params, targets, opt_states = _apply_maddpg_update(
                    params, targets, opt_states, g, gates[u], actor_opt=actor_opt,
                    critic_opt=critic_opt, tau_polyak=tau_polyak)
                metrics = {"critic_loss": closs, "actor_loss": aloss, "q": qmean}
            return params, targets, opt_states, metrics

        return update_chunk

    def pack_state(params, targets, opt_states) -> PackedState:
        def moments(st, stride):
            return st._replace(mu=_flat(_net_buffer(st.mu, stride, dtype).to(device)),
                               nu=_flat(_net_buffer(st.nu, stride, dtype).to(device)))

        return PackedState(layout.pack(params, targets, dtype).to(device),
                           moments(opt_states["actor"], layout.nwp),
                           moments(opt_states["critic"], layout.ncp))

    def unpack_state(state: PackedState):
        def moments(st, net):
            return st._replace(mu=layout.tree(st.mu["flat"]["x"], net),
                               nu=layout.tree(st.nu["flat"]["x"], net))

        return (layout.unpack_nets(state.weights[:layout.off_ta]),
                layout.unpack_nets(state.weights[layout.off_ta:]),
                {"actor": moments(state.actor_opt, "actor"),
                 "critic": moments(state.critic_opt, "critic")})

    def k9_launcher():
        """K9 (K9-bf16) and its gradient buffer on CUDA with the engine
        "kernel" (built once), else None: the tree gradient of the unpacked
        nets, packed."""
        if device.type != "cuda" or grad_engine != "kernel" or dtype != torch.float32:
            return None
        if not launcher:
            launcher["k9"] = MaddpgUpdateLauncher(a, obs_dim, aw, mw, hidden, batch, device,
                                                  gamma=gamma, ent_coef=ent_coef,
                                                  compute_dtype=compute_dtype)
            launcher["grads"] = torch.empty(layout.off_ta, dtype=torch.float32, device=device)
        return launcher["k9"]

    def packed_grads(k9, weights, rows_u):
        if k9 is not None:
            metrics = torch.empty(3, dtype=torch.float32, device=device)
            k9.launch(weights, rows_u, launcher["grads"], metrics)
            return launcher["grads"], (metrics[0], metrics[1], metrics[2])
        g, m = grads_fn.from_rows(layout.unpack_nets(weights[:layout.off_ta]),
                                  layout.unpack_nets(weights[layout.off_ta:]), rows_u)
        return layout.pack_nets(g, dtype), m

    def packed_step(state: PackedState, buffer: Buffer, key, gates, indices=None):
        rows, gates = chunk_rows(buffer, key, gates, indices)
        rows = rows.to(dtype)
        w = state.weights
        live, tgt = w[:layout.off_ta], w[layout.off_ta:]
        actor, critic = layout.nets(live)
        k9 = k9_launcher()
        if k9 is not None:                                      # once per chunk
            k9.check(w, rows[0], launcher["grads"])
        sa, sc = state.actor_opt, state.critic_opt
        metrics = None
        for u in range(n_updates):
            g, (closs, aloss, qmean) = packed_grads(k9, w, rows[u])
            if mesh is not None:
                mesh.mean_([g])
            g_actor, g_critic = layout.nets(g)
            cupd, sc = critic_opt.update(_flat(g_critic), sc)
            critic.add_(cupd["flat"]["x"])                     # apply_updates: p + u
            keep = _gate_agents(gates[u], a)
            if any(keep):
                aupd, new = actor_opt.update(_flat(g_actor), sa)
                step = aupd["flat"]["x"]
                if all(keep):
                    actor.add_(step)
                else:                                           # gated agents keep their rows
                    rows_on = torch.tensor(keep, device=w.device)[:, None]
                    actor.copy_(torch.where(rows_on, actor + step, actor))
                    sel = lambda n_, o_: _flat(torch.where(rows_on, n_["flat"]["x"],
                                                           o_["flat"]["x"]))
                    new = new._replace(mu=sel(new.mu, sa.mu), nu=sel(new.nu, sa.nu))
                sa = new
            tgt.mul_(1 - tau_polyak).add_(live * tau_polyak)   # (1 - tau) t + tau p
            metrics = {"critic_loss": closs, "actor_loss": aloss, "q": qmean}
        return PackedState(w, sa, sc), metrics

    def update_chunk(params, targets, opt_states, buffer: Buffer, key, gates, indices=None):
        state, metrics = packed_step(pack_state(params, targets, opt_states), buffer, key, gates,
                                     indices)
        return (*unpack_state(state), metrics)

    update_chunk.plain = chunk_with(getattr(grads_fn, "plain", grads_fn))
    update_chunk.pack_state = pack_state
    update_chunk.unpack_state = unpack_state
    update_chunk.actor_of = lambda state: layout.unpack_nets(
        state.weights[:layout.off_ta])["actor"]
    update_chunk.packed_step = packed_step
    update_chunk.layout = layout
    update_chunk.n_updates = n_updates
    update_chunk.grads_fn = grads_fn
    update_chunk.init_opt = lambda params: {"actor": actor_opt.init(params["actor"]),
                                            "critic": critic_opt.init(params["critic"])}
    return update_chunk


def build_fused_maddpg_dp(env, n_envs: int, mesh=None, horizon: int | None = None,
                          updates_per_chunk: int | None = None, cap_chunks: int = 10,
                          batch: int = 1024, gamma: float = 0.95, tau_polyak: float = 0.05,
                          eps_greedy: float = 0.1, actor_lr: float = 1e-3,
                          critic_lr: float = 1e-3, ent_coef: float = 0.01, hidden: int = 64,
                          block_envs: int = 1024, t_chunk: int | None = None,
                          grad_engine: str = "kernel", device=None):
    """Data-parallel fused MADDPG over the ranks of ``mesh`` (by default
    this process's, ``parallel.env_mesh``): per rank, kernel K8 fills a
    LOCAL replay shard (rank r draws the global RNG blocks of its
    ``n_envs / size`` lanes, so the collection is the single-device one's
    share, lane for lane), then each update reads a local batch, computes
    kernel K9's gradient and averages it over the ranks (one ``all_reduce``
    of the packed flat gradient): the effective batch is ``size * batch``,
    and Adam and Polyak step alike on every rank, so params and targets stay
    the same bit for bit. Only the gradient crosses ranks.

    -> ``step(state, seed, gates=None, indices=None) -> (state, metrics)``
    with ``state = (params, targets, opt_states, local_buffer)`` (params from
    ``init_maddpg``, the ring from ``step.init_buffer()``: ``cap_chunks``
    chunks of this rank's rows). One call collects one chunk (``n_envs *
    horizon`` transitions over all ranks, kernel seed ``seed``) and runs
    ``updates_per_chunk`` updates (default ``horizon``) on batches that
    ``sample_rows`` draws from ``mesh.rank_key(seed)``, or on the rank's
    ``indices [updates_per_chunk, batch]`` (the tests inject JAX's draw);
    ``gates`` are the updates' scalar actor gates (default all on). Metrics:
    ``mean_reward`` of the chunk and the last update's ``critic_loss``, means
    over the ranks. ``seed`` must differ between calls: the collection and
    the draws both derive from it. ``step.collect(actor_params, buffer,
    seed) -> (buffer, mean_reward)`` and ``step.update_chunk`` are its
    halves, on this rank."""
    from mpe_tpu_torch.core.actions import ActionMode
    from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory
    from mpe_tpu_torch.parallel.mesh import env_mesh

    if env.action_mode is not ActionMode.DISCRETE:
        raise ValueError("fused MADDPG collection needs ActionMode.DISCRETE")
    horizon = horizon or env.max_steps
    if not horizon:
        raise ValueError("the env needs max_steps (the episode horizon)")
    updates_per_chunk = updates_per_chunk or horizon
    mesh = mesh if mesh is not None else env_mesh(device)
    device = mesh.device if device is None else resolve_device(device)
    local, block, offset = mesh.shard_envs(n_envs, block_envs)
    if t_chunk is None:
        t_chunk = collect_t_chunk(horizon)
    kscn, obs_dim, aw, _, _ = _dims(env)
    a = env.n_agents
    rows_per_chunk = horizon * local
    cap_local = cap_chunks * rows_per_chunk
    tmpl = init_maddpg(torch.Generator().manual_seed(0), obs_dim, aw, a, hidden=1)["actor"]
    traj = fused_maddpg_trajectory(kscn, tmpl, local, horizon, horizon=horizon,
                                   eps_greedy=eps_greedy, block_envs=block, t_chunk=t_chunk,
                                   emit_rows=True, device=device)
    chunk = build_fused_update_chunk(env, updates_per_chunk, batch=batch, gamma=gamma,
                                     tau_polyak=tau_polyak, actor_lr=actor_lr,
                                     critic_lr=critic_lr, ent_coef=ent_coef, hidden=hidden,
                                     grad_engine=grad_engine, device=device, mesh=mesh)
    r0 = a * (obs_dim + aw)

    def collect(actor_params, buffer: Buffer, seed):
        """Insert this rank's chunk of rows at ``ptr`` (a whole number of
        chunks fits the ring, so the insert never wraps)."""
        rows = traj(seed, actor_params, offset).reshape(rows_per_chunk, -1)
        buffer.data[buffer.ptr:buffer.ptr + rows_per_chunk] = rows
        buffer = buffer._replace(ptr=(buffer.ptr + rows_per_chunk) % cap_local,
                                 size=min(buffer.size + rows_per_chunk, cap_local))
        return buffer, rows[:, r0:r0 + a].mean()

    def step(state, seed, gates=None, indices=None):
        params, targets, opt_states, buffer = state
        if buffer.data.shape[0] != cap_local:
            raise ValueError(f"the ring holds {buffer.data.shape[0]} rows, this rank's shard "
                             f"{cap_local}: build it with step.init_buffer()")
        gates = np.ones(updates_per_chunk, bool) if gates is None else np.asarray(gates, bool)
        if gates.ndim != 1:
            raise ValueError("the DP trainer takes scalar per-update gates; per-agent [U, A] "
                             "gates are build_fused_update_chunk's")
        buffer, mean_reward = collect(params["actor"], buffer, seed)
        packed, m = chunk.packed_step(chunk.pack_state(params, targets, opt_states), buffer,
                                      mesh.rank_key(int(seed)), gates, indices)
        params, targets, opt_states = chunk.unpack_state(packed)
        mean_reward, critic_loss = mesh.mean_([mean_reward, m["critic_loss"]])
        return ((params, targets, opt_states, buffer),
                {"mean_reward": mean_reward, "critic_loss": critic_loss})

    step.collect = collect
    step.update_chunk = chunk
    step.init_buffer = lambda: init_buffer(cap_local, a, obs_dim, aw, device=device)
    step.init_opt = chunk.init_opt
    step.updates_per_chunk = updates_per_chunk
    step.transitions_per_chunk = n_envs * horizon
    return step


def build_fused_update(env, batch: int = 256, gamma: float = 0.95, tau_polyak: float = 0.05,
                       actor_lr: float = 1e-3, critic_lr: float = 1e-3, ent_coef: float = 0.01,
                       hidden: int = 64, device=None, dtype=torch.float32,
                       compute_dtype=torch.float32):
    """One update per call: ``update_fn(params, targets, opt_states, buffer,
    key, do_actor=True, indices=None) -> (params, targets, opt_states,
    metrics)``, a chunk of one (``build_fused_update_chunk``, K9-bf16 with
    ``compute_dtype=torch.bfloat16``)."""
    chunk = build_fused_update_chunk(env, 1, batch=batch, gamma=gamma, tau_polyak=tau_polyak,
                                     actor_lr=actor_lr, critic_lr=critic_lr, ent_coef=ent_coef,
                                     hidden=hidden, device=device, dtype=dtype,
                                     compute_dtype=compute_dtype)

    def update_fn(params, targets, opt_states, buffer, key, do_actor=True, indices=None):
        idx = None if indices is None else indices.reshape(1, -1)     # numpy or a tensor
        return chunk(params, targets, opt_states, buffer, key, [do_actor], idx)

    update_fn.init_opt = chunk.init_opt
    return update_fn


def collect_t_chunk(n_steps: int) -> int:
    """The collection's steps per chunk when the caller names none: the
    largest of 8, 5, 4, 2, 1 that divides ``n_steps``."""
    return next(c for c in (8, 5, 4, 2, 1) if n_steps % c == 0)


def build_fused_collect(env, n_envs: int, n_steps: int, eps_greedy: float = 0.1,
                        block_envs: int = 1024, t_chunk: int | None = None, device=None):
    """Fused replay collection: ``collect_chunk(actor_params, buffer, seed)
    -> (buffer, mean_reward)`` inserts ``n_steps * n_envs`` rows collected
    by kernel K8 (``ops/fused_maddpg.fused_maddpg_trajectory`` in its rows
    form; the plain version on the CPU): per-agent Gumbel-max actions
    eps-mixed with uniform one-hots, per-agent rewards and the true pre-reset
    next obs. The chunk goes in as one contiguous copy when it fits before
    the ring's end, else row by row modulo the capacity (a misaligned
    ``ptr``); ``ptr`` and ``size`` advance as in JAX. Episodes restart each
    chunk, so ``n_steps`` is a multiple of the env horizon."""
    from mpe_tpu_torch.core.actions import ActionMode
    from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory

    if env.action_mode is not ActionMode.DISCRETE:
        raise ValueError("fused MADDPG collection needs ActionMode.DISCRETE")
    horizon = env.max_steps
    if not horizon or n_steps % horizon:
        raise ValueError(f"n_steps ({n_steps}) must be a multiple of the env horizon ({horizon}) "
                         "so every stored episode is complete")
    kscn, obs_dim, aw, _, _ = _dims(env)
    if t_chunk is None:
        t_chunk = collect_t_chunk(n_steps)
    device = resolve_device(device)
    a = env.n_agents
    tmpl = init_maddpg(torch.Generator().manual_seed(0), obs_dim, aw, a, hidden=1)["actor"]
    traj = fused_maddpg_trajectory(kscn, tmpl, n_envs, n_steps, horizon=horizon,
                                   eps_greedy=eps_greedy, block_envs=block_envs, t_chunk=t_chunk,
                                   emit_rows=True, device=device)
    rows_per_chunk = n_steps * n_envs

    def collect_chunk(actor_params, buffer: Buffer, seed):
        rows = traj(seed, actor_params).reshape(rows_per_chunk, -1)
        cap = buffer.data.shape[0]
        if rows_per_chunk > cap:
            raise ValueError(f"a chunk of {rows_per_chunk} rows does not fit a ring of {cap}")
        r0 = a * (obs_dim + aw)
        mean_reward = rows[:, r0:r0 + a].mean()
        if buffer.ptr + rows_per_chunk <= cap:
            buffer.data[buffer.ptr:buffer.ptr + rows_per_chunk] = rows
        else:
            head = cap - buffer.ptr
            buffer.data[buffer.ptr:] = rows[:head]
            buffer.data[:rows_per_chunk - head] = rows[head:]
        buffer = buffer._replace(ptr=(buffer.ptr + rows_per_chunk) % cap,
                                 size=min(buffer.size + rows_per_chunk, cap))
        return buffer, mean_reward

    collect_chunk.rows_per_chunk = rows_per_chunk
    collect_chunk.traj = traj
    return collect_chunk

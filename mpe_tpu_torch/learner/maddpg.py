"""MADDPG with a centralized critic on the fused engine, one device
(counterpart of ``mpe_tpu/learner/maddpg.py``).

Per-agent actors ``mu_i(o_i)`` -> move logits and per-agent critics
``Q_i(o_1..A, a_1..A)`` (Lowe et al. 2017), every leaf stacked on a leading
agent axis ``[A, ...]``. Replay lives on the device in one 2-D row table
(``Buffer``: row = ``[obs | act | rew | obs2]``), filled by kernel K8
(``build_fused_collect``) and read by ``build_fused_update_chunk``, whose
gradient is kernel K9 (``grad_engine="kernel"``) or autograd of the same
losses (``grad_engine="autograd"``, ``maddpg_xla_grads``). Episodes end only
by time limit, so TD targets bootstrap through the horizon on the stored
true pre-reset next obs.

Ported: the centralized critic on simple_spread (move-only heads). Waiting:
``local_critic`` (independent DDPG), the per-step XLA learner
``build_maddpg`` with ``gumbel_softmax_st``, ``build_fused_maddpg_dp``, the
ensemble and approximate-policy variants, and the comm heads (ROADMAP
A10, B3).

The ring is updated in place (``build_fused_collect`` writes the chunk into
``buffer.data``; the returned ``Buffer`` shares it): at 1,638,400 rows of
126 floats a functional copy per insert would move 826 MB. ``ptr`` and
``size`` are host integers: they advance by a fixed count per insert, so
nothing waits for the device to know them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner._nets import dense_init
from mpe_tpu_torch.learner.optim import adam, apply_updates, tree_map
from mpe_tpu_torch.ops.fused_maddpg_update import _split_rows


def _tree3(fn, *trees):
    """``fn`` over the leaves of ``{"actor" | "critic": {layer: {w, b}}}``."""
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}


def init_maddpg(generator: torch.Generator, obs_dim: int, act_dim: int, n_agents: int,
                hidden: int = 64, dtype=torch.float32) -> dict:
    """Stacked per-agent actors and centralized critics: every leaf has a
    leading [A] axis. Agent by agent, the draws are actor l1, l2, out (scale
    0.01), then critic l1 (on the joint ``A*(obs_dim+act_dim)`` input), l2,
    out, all from ``generator``."""
    cin = n_agents * (obs_dim + act_dim)
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


def maddpg_act_dim(env) -> int:
    """Actor output width for ``env``: the 5-wide move head, plus a
    dim_c-wide comm head when any agent speaks."""
    mw = 2 * env.spec.dim_p + 1
    cw = 0 if all(env.spec.silent) else env.spec.dim_c
    return mw + cw


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
    onehot = torch.nn.functional.one_hot(logits[..., :mw].argmax(-1), mw).to(obs2_b.dtype)
    if cw:
        onehot = torch.cat([onehot, torch.nn.functional.one_hot(
            logits[..., mw:].argmax(-1), cw).to(obs2_b.dtype)], dim=-1)
    return onehot


def expected_q_actor_loss(actor_params, critic_params, obs_b, act_b, *, mw: int, cw: int,
                          ent_coef: float):
    """The exact expected-Q actor objective (the loss kernel K9
    differentiates): each agent maximizes the expectation of its critic
    (held fixed) over its own discrete action set under its softmax policy,
    with the other agents' buffer actions fixed, plus the entropy bonus
    ``-sum p log(p + 1e-10)``; averaged over the batch and the agents."""
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
        mixed = act_b.expand((n_cand,) + act_b.shape).clone()        # [C, B, A, aw]
        mixed[:, :, i, :] = cand[:, None, :]
        q_all = critic_q_i(cp, torch.cat([obs_flat, mixed.reshape(n_cand, batch, -1)], dim=-1))
        w = probs_m[:, i]
        if cw:
            w = (w[..., :, None] * probs_c[:, i][..., None, :]).reshape(batch, n_cand)
        exp_q = (w * q_all.T.detach()).sum(-1)
        ent = -(probs_m[:, i] * torch.log(probs_m[:, i] + 1e-10)).sum(-1)
        if cw:
            ent = ent - (probs_c[:, i] * torch.log(probs_c[:, i] + 1e-10)).sum(-1)
        total = total - (exp_q + ent_coef * ent).mean()
    return total / a


def maddpg_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, *, mw: int, cw: int,
                     gamma: float, ent_coef: float):
    """The MADDPG gradient on a sampled batch by autograd (the port's
    counterpart of the JAX package's ``maddpg_xla_grads``, its ``"xla"``
    engine: ``jax.grad`` of the same losses): first-argmax target actions
    -> TD targets ``y = r + gamma Q'`` -> the critic's mean of ``(Q - y)^2``
    over [A, B] -> the exact expected-Q actor objective. Returns ``(grads,
    (critic_loss, actor_loss, q_mean))``; also kernel K9's library
    yardstick."""
    with torch.no_grad():
        joint2 = _joint(obs2_b, _target_actions(targets["actor"], obs2_b, mw, cw))
        y = rew_b.T + gamma * critic_q(targets["critic"], joint2)   # [A, B]
    with torch.enable_grad():
        cp = tree_map(lambda x: x.detach().requires_grad_(True), params["critic"])
        q = critic_q(cp, _joint(obs_b, act_b))
        closs = (q - y).square().mean()
        cleaves = [cp[k][w] for k in cp for w in cp[k]]
        cg = iter(torch.autograd.grad(closs, cleaves))
        ap = tree_map(lambda x: x.detach().requires_grad_(True), params["actor"])
        aloss = expected_q_actor_loss(ap, params["critic"], obs_b, act_b, mw=mw, cw=cw,
                                      ent_coef=ent_coef)
        ag = iter(torch.autograd.grad(aloss, [ap[k][w] for k in ap for w in ap[k]]))
    grads = {"actor": tree_map(lambda _: next(ag), ap), "critic": tree_map(lambda _: next(cg), cp)}
    return grads, (closs.detach(), aloss.detach(), q.detach().mean())


def _dims(env):
    """(kernel scenario, obs width, act width, move width, comm width)."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(env.scenario)
    aw = maddpg_act_dim(env)
    mw = 2 * env.spec.dim_p + 1
    return kscn, kscn.obs_w, aw, mw, aw - mw


def _make_grads_fn(env, grad_engine: str, *, batch: int, gamma: float, ent_coef: float,
                   hidden: int, device, dtype):
    """``grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b)`` with
    ``grads_fn.from_rows(params, targets, rows_b)``: ``"kernel"`` is kernel
    K9 (``ops/fused_maddpg_update``; its plain version on the CPU),
    ``"autograd"`` is ``maddpg_xla_grads``."""
    from mpe_tpu_torch.ops.fused_maddpg_update import fused_maddpg_update

    _, obs_dim, aw, mw, cw = _dims(env)
    if grad_engine == "kernel":
        return fused_maddpg_update(env.n_agents, obs_dim, aw, mw, hidden=hidden, batch=batch,
                                   gamma=gamma, ent_coef=ent_coef, device=device, dtype=dtype)
    if grad_engine != "autograd":
        raise ValueError(f"grad_engine must be 'kernel' or 'autograd', got {grad_engine!r}")
    def grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b):
        return maddpg_xla_grads(params, targets, obs_b, act_b, rew_b, obs2_b, mw=mw, cw=cw,
                                gamma=gamma, ent_coef=ent_coef)

    grads_fn.from_rows = lambda params, targets, rows_b: grads_fn(
        params, targets, *_split_rows(rows_b, env.n_agents, obs_dim, aw))
    return grads_fn


def build_fused_update_chunk(env, n_updates: int, batch: int = 256, gamma: float = 0.95,
                             tau_polyak: float = 0.05, actor_lr: float = 1e-3,
                             critic_lr: float = 1e-3, ent_coef: float = 0.01, hidden: int = 64,
                             grad_engine: str = "kernel", device=None, dtype=torch.float32):
    """``n_updates`` sequential updates per call, their replay batches
    gathered in one read: ``update_chunk(params, targets, opt_states,
    buffer, key, gates, indices=None) -> (params, targets, opt_states,
    metrics)``.

    The batches are ``torch.randint`` rows in ``[0, max(size, 1))`` from a
    generator on the device seeded with the int ``key`` (JAX draws them by
    threefry from its key, which the port cannot reproduce); ``indices``
    ``[n_updates, batch]`` replaces the draw (the tests inject JAX's).
    ``gates`` is ``[n_updates]`` (each update's actor gate) or ``[n_updates,
    A]`` (per agent), host booleans. ``metrics`` holds the last update's
    ``critic_loss``, ``actor_loss`` and ``q``. The JAX package's packed
    block-diagonal state is a layout of the TPU's matrix unit: here
    ``pack_state`` and ``unpack_state`` are identities, ``actor_of`` takes
    the actor, and ``packed_step(state, buffer, key, gates)`` is the same
    chunk on a ``(params, targets, opt_states)`` state. ``update_chunk.plain``
    is the same chunk with kernel K9's plain version."""
    device = resolve_device(device)
    actor_opt, critic_opt = adam(actor_lr), adam(critic_lr)
    grads_fn = _make_grads_fn(env, grad_engine, batch=batch, gamma=gamma, ent_coef=ent_coef,
                              hidden=hidden, device=device, dtype=dtype)

    def chunk_with(grads):
        def update_chunk(params, targets, opt_states, buffer: Buffer, key, gates, indices=None):
            gates = np.asarray(gates.cpu() if isinstance(gates, torch.Tensor) else gates,
                               dtype=bool)
            if gates.shape[:1] != (n_updates,):
                raise ValueError(f"gates has shape {gates.shape}, expected ({n_updates},) or "
                                 f"({n_updates}, A)")
            dev = buffer.data.device
            if indices is None:
                gen = torch.Generator(device=dev).manual_seed(int(key))
                indices = torch.randint(0, max(buffer.size, 1), (n_updates, batch), generator=gen,
                                        device=dev)
            elif not isinstance(indices, torch.Tensor):
                indices = torch.tensor(np.asarray(indices), dtype=torch.int64)
            indices = indices.to(dev)
            if tuple(indices.shape) != (n_updates, batch):
                raise ValueError(f"indices has shape {tuple(indices.shape)}, expected "
                                 f"{(n_updates, batch)}")
            rows = buffer.data[indices.reshape(-1)].reshape(n_updates, batch, -1)
            metrics = None
            for u in range(n_updates):
                g, (closs, aloss, qmean) = grads.from_rows(params, targets, rows[u].to(dtype))
                params, targets, opt_states = _apply_maddpg_update(
                    params, targets, opt_states, g, gates[u], actor_opt=actor_opt,
                    critic_opt=critic_opt, tau_polyak=tau_polyak)
                metrics = {"critic_loss": closs, "actor_loss": aloss, "q": qmean}
            return params, targets, opt_states, metrics

        return update_chunk

    update_chunk = chunk_with(grads_fn)
    update_chunk.plain = chunk_with(grads_fn.plain) if hasattr(grads_fn, "plain") else update_chunk

    def packed_step(pstate, buffer, key, gates, indices=None):
        p, t, o, metrics = update_chunk(*pstate, buffer, key, gates, indices)
        return (p, t, o), metrics

    update_chunk.pack_state = lambda params, targets, opt_states: (params, targets, opt_states)
    update_chunk.unpack_state = lambda pstate: pstate
    update_chunk.actor_of = lambda pstate: pstate[0]["actor"]
    update_chunk.packed_step = packed_step
    update_chunk.n_updates = n_updates
    update_chunk.grads_fn = grads_fn
    update_chunk.init_opt = lambda params: {"actor": actor_opt.init(params["actor"]),
                                            "critic": critic_opt.init(params["critic"])}
    return update_chunk


def build_fused_update(env, batch: int = 256, gamma: float = 0.95, tau_polyak: float = 0.05,
                       actor_lr: float = 1e-3, critic_lr: float = 1e-3, ent_coef: float = 0.01,
                       hidden: int = 64, device=None, dtype=torch.float32):
    """One update per call: ``update_fn(params, targets, opt_states, buffer,
    key, do_actor=True, indices=None) -> (params, targets, opt_states,
    metrics)``, a chunk of one (``build_fused_update_chunk``)."""
    chunk = build_fused_update_chunk(env, 1, batch=batch, gamma=gamma, tau_polyak=tau_polyak,
                                     actor_lr=actor_lr, critic_lr=critic_lr, ent_coef=ent_coef,
                                     hidden=hidden, device=device, dtype=dtype)

    def update_fn(params, targets, opt_states, buffer, key, do_actor=True, indices=None):
        idx = None if indices is None else indices.reshape(1, -1)     # numpy or a tensor
        return chunk(params, targets, opt_states, buffer, key, [do_actor], idx)

    update_fn.init_opt = chunk.init_opt
    return update_fn


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
        t_chunk = next(c for c in (8, 5, 4, 2, 1) if n_steps % c == 0)
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

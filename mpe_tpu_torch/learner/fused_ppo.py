"""PPO and MAPPO on the fused engine, one device (counterpart of
``mpe_tpu/learner/fused_ppo.py``).

One iteration of ``build_fused_ppo_step`` (``build_fused_mappo_step`` is the
same with a centralized critic on the joint obs, GAE over the team reward
[T, N], and kernel K7 in place of K6):

1. collection: kernel K5 (``ops/fused_policy.fused_policy_trajectory``)
   runs the actor inside the env loop and emits the on-policy batch
   env-minor: obs the policy acted on ``[T, A, OW, N]``, move indices
   ``[T, A, N]``, comm indices ``[T, A, N]`` where the scenario speaks,
   rewards ``[T, R, N]`` and the bootstrap obs;
2. prep: the move and comm one-hots, then one batched forward of the
   actor-critic over the batch recomputes the rollout-time log-probs and
   values (a matmul, as the JAX package leaves it to an XLA einsum), then
   GAE runs as a reverse loop over T; done flags are the deterministic
   ``(t + 1) % horizon == 0``;
3. ``ppo_epochs`` epochs, each the gradient of kernel K6
   (``ops/fused_update.fused_ppo_update``; with ``fused_update=False``,
   autograd of the same loss) followed by the clip + Adam step of
   ``learner/optim.py``.

The policy is a factored categorical (move x comm): the surrogate treats
the two heads as independent, with a silent agent's comm factor masked out
(its utterance is forced to zero, so no gradient flows through it).

``compute_dtype`` is the matrix products' dtype, as in the JAX builders.
``None`` (the default) resolves to float32 on the card and on the CPU, as
JAX resolves it everywhere but on a TPU, where it picks bf16 for the matrix
unit. TF32 stays off on this path, so in float32 the prep forward and K6's
forward agree to float32 rounding and the epoch-0 ratio is 1 within 1e-5.
``compute_dtype=torch.bfloat16`` is JAX's TPU default: the prep forward
rounds both operands of each product to bf16 and sums in float32, as JAX's
einsum with ``preferred_element_type``, the epochs run kernel K6-bf16
(K7-bf16) or, with ``fused_update=False``, autograd of the same rounded
loss; params, logits, the surrogate and the gradients stay float32. K5's
collection has no compute dtype (nor has JAX's ``fused_policy_trajectory``).

Data-parallel (``mesh=``, a ``parallel.EnvMesh``): each rank collects its
``n_envs / size`` envs by K5 with block offset ``rank * local_n_blocks`` (so
the ranks' batches are the single-device batch's halves, lane for lane),
normalizes its own advantages, and each epoch's K6 (K7) gradient is averaged
over the ranks by one ``all_reduce`` of its leaves concatenated, as JAX's
``pmean``; the clip and Adam then run alike on every rank, so the params stay
the same bit for bit. The metrics are averaged the same way.
"""

from __future__ import annotations

import contextlib

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.learner.optim import (apply_updates, clip_adam, linear_schedule, tree_leaves,
                                         tree_map)
from mpe_tpu_torch.learner.ppo import init_ac, init_mappo
from mpe_tpu_torch.ops.fused_policy import _resolve, fused_policy_trajectory
from mpe_tpu_torch.ops.fused_update import (compute_rounding, fused_mappo_update,
                                            fused_ppo_update, speak_mask)


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the trainer's matmuls (restored on exit)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _torso_minor(l1, l2, obs, rnd):
    """Env-minor MLP torso: obs [..., OW, N] -> h [..., H, N]; ``rnd`` rounds
    each product's operands (``compute_rounding``)."""
    h = torch.tanh(torch.einsum("...on,oh->...hn", rnd(obs), rnd(l1["w"])) + l1["b"][:, None])
    return torch.tanh(torch.einsum("...hn,hg->...gn", rnd(h), rnd(l2["w"])) + l2["b"][:, None])


def _head_minor(head, h, rnd):
    """h [..., H, N] -> [..., K, N]."""
    return torch.einsum("...gn,gk->...kn", rnd(h), rnd(head["w"])) + head["b"][:, None]


def _factored_onehots(kscn, act, cact, dtype=torch.float32):
    """Index tensors [..., A, N] -> (move one-hots [..., A, 5, N], comm
    one-hots [..., A, C, N] or None without a comm head), contiguous, in
    ``dtype``."""
    mw, dim_c = kscn.n_moves, kscn.n_comm

    def onehot(idx, k):
        return torch.nn.functional.one_hot(idx.long(), k).movedim(-1, -2).to(dtype).contiguous()

    return onehot(act, mw), onehot(cact, dim_c) if dim_c else None


def _factored_logp_ent(kscn, logits, mv_oh, cm_oh):
    """Logits [..., A, 5 + C, N] and the one-hot actions -> (logp, entropy)
    [..., A, N] of the factored categorical, the comm factor masked for
    silent agents."""
    mw, dim_c = kscn.n_moves, kscn.n_comm

    def one(lg, oh):
        ls = torch.log_softmax(lg, dim=-2)
        return (ls * oh).sum(-2), -(torch.softmax(lg, dim=-2) * ls).sum(-2)

    lp, ent = one(logits[..., :mw, :], mv_oh)
    if dim_c:
        clp, cent = one(logits[..., mw:, :], cm_oh)
        speak = speak_mask(kscn.speak, logits)[..., 0]       # [A, 1]
        lp = lp + clp * speak
        ent = ent + cent * speak
    return lp, ent


def _gae_minor(values, rewards, nonterm_t, last_value, gamma: float, lam: float):
    """Reverse-loop GAE over env-minor [T, ..., N] tensors; ``nonterm_t`` is
    the [T] list of per-step non-terminal flags (0.0 or 1.0) -> (adv, ret)."""
    advs = torch.empty_like(values)
    next_val, next_adv = last_value, torch.zeros_like(last_value)
    for t in reversed(range(values.shape[0])):
        nt = nonterm_t[t]
        delta = rewards[t] + gamma * next_val * nt - values[t]
        next_adv = delta + gamma * lam * nt * next_adv
        advs[t] = next_adv
        next_val = values[t]
    return advs, advs + values


def _agent_rewards(kscn, rew):
    """[T, R, N] reward rows -> per-agent [T, A, N] (a shared reward row is
    broadcast to every agent)."""
    if kscn.reward_rows == 1:
        return rew.expand(rew.shape[0], kscn.spec.n_agents, rew.shape[2])
    return rew


def _mark(events, name: str):
    """Record a CUDA event named ``name`` into ``events`` (phase timing)."""
    if events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))


def _shard(n_envs: int, block_envs: int, mesh, device):
    """(local envs, block size, block offset, device) of a trainer: the whole
    batch at offset 0 without a mesh, else the rank's share
    (``EnvMesh.shard_envs``) on the mesh's device unless one is named."""
    if mesh is None:
        return n_envs, block_envs, 0, resolve_device(device)
    return (*mesh.shard_envs(n_envs, block_envs),
            mesh.device if device is None else resolve_device(device))


def _fused_trainer(kscn, opt, traj, actor, prep, loss_fn, kernel_update, *, ppo_epochs: int,
                   vf_coef: float, ent_coef: float, fused_update: bool, init_params,
                   n_transitions: int, mesh=None, block_offset: int = 0):
    """The trainer scaffold around the fused engine: kernel rollout ->
    ``prep`` -> ``ppo_epochs`` epochs of the K6 gradient (or autograd of
    ``loss_fn``) and the optimizer step.

    ``step(state, seed, events=None) -> (state, metrics)``; pass a list as
    ``events`` to get a CUDA event after each phase ("collect", "prep",
    then "update" and "optimizer" per epoch), recorded on the current
    stream. ``step.collect(params, seed)`` returns the epoch inputs
    ``(obs, mv_oh, cm_oh, logp_old, value, adv_n, ret)`` (``cm_oh`` None
    without a comm head), ``step.update`` is the epoch gradient (K6's
    builder) and ``step.loss_fn(params, (obs, mv_oh, cm_oh, logp_old, value,
    adv, ret)) -> (loss, (pg, vloss, ent))`` the loss it differentiates, ``step.opt``
    the optimizer. With ``mesh`` the batch is the rank's (``block_offset``),
    each epoch's gradient and the metrics are means over the ranks."""

    def collect(params, seed, events=None):
        outs = traj(int(seed), actor(params), block_offset)
        if kscn.uses_comm:
            obs, act, cact, rew, last_obs = outs
        else:
            (obs, act, rew, last_obs), cact = outs, None
        _mark(events, "collect")
        obs, mv_oh, cm_oh, logp_old, value, adv, ret = prep(params, obs, act, cact, rew, last_obs)
        # population std, as jnp.std: adv is constant across epochs
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        return (obs, mv_oh, cm_oh, logp_old, value, adv_n, ret), (adv, rew)

    def step(state, seed, events=None):
        params, opt_state = state
        with _full_f32_matmul(), torch.no_grad():
            _mark(events, "start")
            batch, (adv, rew) = collect(params, seed, events)
            obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = batch
            _mark(events, "prep")
            for _ in range(ppo_epochs):
                if fused_update:
                    grads, (pg, vl, ent) = kernel_update(params, obs, mv_oh, cm_oh, logp_old,
                                                         adv_n, ret, value)
                    loss = pg + vf_coef * vl - ent_coef * ent
                else:
                    with torch.enable_grad():
                        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
                        loss, (pg, vl, ent) = loss_fn(leaves, (obs, mv_oh, cm_oh, logp_old, value,
                                                               adv, ret))
                        flat = [leaves[k][q] for k in leaves for q in leaves[k]]
                        g = iter(torch.autograd.grad(loss, flat))
                        grads = tree_map(lambda _: next(g), leaves)
                    loss, pg, vl, ent = (x.detach() for x in (loss, pg, vl, ent))
                if mesh is not None:
                    mesh.mean_(tree_leaves(grads))
                _mark(events, "update")
                updates, opt_state = opt.update(grads, opt_state)
                params = apply_updates(params, updates)
                _mark(events, "optimizer")
            values = [loss, pg, vl, ent, _agent_rewards(kscn, rew).mean()]
            if mesh is not None:
                values = mesh.mean_(values)
            metrics = dict(zip(("loss", "pg_loss", "v_loss", "entropy", "mean_reward"), values))
        return (params, opt_state), metrics

    def collect_batch(params, seed):
        with _full_f32_matmul(), torch.no_grad():
            return collect(params, seed)[0]

    step.collect = collect_batch
    step.update = kernel_update
    step.loss_fn = loss_fn
    step.opt = opt
    step.init_params = init_params
    step.init_state = lambda params: (params, opt.init(params))
    step.n_transitions = n_transitions
    return step


def build_fused_ppo_step(scenario, n_envs: int, n_steps: int = 64, horizon: int = 100,
                         hidden: int = 64, lr: float = 3e-4, gamma: float = 0.95,
                         lam: float = 0.95, clip: float = 0.2, vf_coef: float = 0.5,
                         ent_coef: float = 0.01, ppo_epochs: int = 4,
                         anneal_iters: int | None = None, block_envs: int = 1024,
                         t_chunk: int = 8, fused_update: bool = True, device=None,
                         dtype=torch.float32, mesh=None, compute_dtype=None):
    """PPO iteration on the fused engine: ``step(state, seed) -> (state,
    metrics)`` with ``state = (params, opt_state)`` (params in
    ``learner.ppo.init_ac`` layout: ``step.init_params(generator)``,
    ``step.init_state(params)``) and metrics ``loss``, ``pg_loss``,
    ``v_loss``, ``entropy`` (of the last epoch) and ``mean_reward``.

    The actor (torso + pi head) runs inside kernel K5; the value head reads
    the same torso outside it. ``anneal_iters`` decays the learning rate
    linearly to 0 over ``anneal_iters * ppo_epochs`` optimizer steps (the
    schedule counts epochs). ``dtype`` is that of the params and the
    update; the collection runs in float32, and on CUDA the update kernels
    take float32 params. ``compute_dtype`` is the products' dtype (the
    module docstring): None or float32 (K6), or ``torch.bfloat16`` (the prep
    forward and the loss rounded to bf16 operands, K6-bf16).
    ``step.plain`` is the same trainer with the plain versions of K5 and K6
    on the same device (for holding the kernels against them).

    With ``mesh`` (a ``parallel.EnvMesh``) the step is data-parallel: the
    rank collects its share of the ``n_envs`` envs (the same lanes as in the
    single-device run) and each epoch's gradient and the metrics are means
    over the ranks, so every rank holds the same params. The device is the
    mesh's unless ``device`` names one."""
    kscn = _resolve(scenario)
    local, block_envs, offset, device = _shard(n_envs, block_envs, mesh, device)
    _, rnd = compute_rounding(compute_dtype, dtype)      # None: the params' dtype
    n_logits = kscn.n_logits
    sched = linear_schedule(lr, 0.0, anneal_iters * ppo_epochs) if anneal_iters else lr
    opt = clip_adam(sched, max_norm=0.5)

    def init_params(generator):
        params = init_ac(generator, kscn.obs_w, n_logits, hidden=hidden, dtype=dtype)
        return tree_map(lambda x: x.to(device), params)

    def actor(p):
        return {"l1": p["l1"], "l2": p["l2"], "out": p["pi"]}

    tmpl = init_ac(torch.Generator().manual_seed(0), kscn.obs_w, n_logits, hidden=hidden)
    traj = fused_policy_trajectory(kscn, actor(tmpl), local, n_steps, horizon=horizon,
                                   block_envs=block_envs, t_chunk=t_chunk, device=device)
    kernel_update = fused_ppo_update(kscn, local, n_steps, hidden, clip=clip, vf_coef=vf_coef,
                                     ent_coef=ent_coef, device=device, dtype=dtype,
                                     compute_dtype=compute_dtype) if fused_update else None
    nonterm_t = [0.0 if (t + 1) % horizon == 0 else 1.0 for t in range(n_steps)]

    def forward(params, obs):
        """obs [..., A, OW, N] -> (logits [..., A, K, N], value [..., A, N])."""
        h = _torso_minor(params["l1"], params["l2"], obs.to(dtype), rnd)
        return _head_minor(params["pi"], h, rnd), _head_minor(params["v"], h, rnd)[..., 0, :]

    def loss_fn(params, batch):
        obs, mv_oh, cm_oh, logp_old, value_old, adv, ret = batch
        logits, value = forward(params, obs)
        logp, ent = _factored_logp_ent(kscn, logits, mv_oh, cm_oh)
        ratio = torch.exp(logp - logp_old)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - clip, 1 + clip) * adv_n).mean()
        v_clip = value_old + torch.clamp(value - value_old, -clip, clip)
        vloss = torch.maximum((value - ret).square(), (v_clip - ret).square()).mean()
        return pg + vf_coef * vloss - ent_coef * ent.mean(), (pg, vloss, ent.mean())

    def prep(params, obs, act, cact, rew, last_obs):
        """Per-agent values from the shared torso; GAE over per-agent rewards."""
        mv_oh, cm_oh = _factored_onehots(kscn, act, cact, dtype)
        logits, value = forward(params, obs)
        value = value.contiguous()
        logp_old, _ = _factored_logp_ent(kscn, logits, mv_oh, cm_oh)
        _, last_value = forward(params, last_obs)
        adv, ret = _gae_minor(value, _agent_rewards(kscn, rew).to(dtype), nonterm_t, last_value,
                              gamma, lam)
        return obs.to(dtype), mv_oh, cm_oh, logp_old, value, adv, ret

    def trainer(traj, kernel_update):
        return _fused_trainer(kscn, opt, traj, actor, prep, loss_fn, kernel_update,
                              ppo_epochs=ppo_epochs, vf_coef=vf_coef, ent_coef=ent_coef,
                              fused_update=fused_update, init_params=init_params,
                              n_transitions=n_envs * n_steps, mesh=mesh, block_offset=offset)

    step = trainer(traj, kernel_update)
    step.plain = trainer(traj.plain, kernel_update.plain if fused_update else None)
    return step


def build_fused_mappo_step(scenario, n_envs: int, n_steps: int = 64, horizon: int = 100,
                           hidden: int = 64, lr: float = 3e-4, gamma: float = 0.95,
                           lam: float = 0.95, clip: float = 0.2, vf_coef: float = 0.5,
                           ent_coef: float = 0.01, ppo_epochs: int = 4,
                           anneal_iters: int | None = None, block_envs: int = 1024,
                           t_chunk: int = 8, fused_update: bool = True, device=None,
                           dtype=torch.float32, mesh=None, compute_dtype=None):
    """MAPPO iteration on the fused engine (the contract of
    ``build_fused_ppo_step``; params in ``learner.ppo.init_mappo`` layout).
    The decentralized actor (``a1, a2, pi``) runs inside kernel K5; the
    centralized critic (``c1, c2, v``) reads the joint obs ``[.., A*OW, N]``
    outside it. The value, its targets and the advantage are team streams
    ``[T, N]``: GAE over the mean reward across agents. Each epoch's gradient
    is kernel K7 (``ops/fused_update.fused_mappo_update``; with
    ``fused_update=False``, autograd of ``step.loss_fn``). ``step.plain`` is
    the same trainer with the plain versions of K5 and K7. ``mesh`` makes it
    data-parallel and ``compute_dtype=torch.bfloat16`` runs K7-bf16, as in
    ``build_fused_ppo_step``."""
    kscn = _resolve(scenario)
    local, block_envs, offset, device = _shard(n_envs, block_envs, mesh, device)
    _, rnd = compute_rounding(compute_dtype, dtype)      # None: the params' dtype
    a, ow = kscn.spec.n_agents, kscn.obs_w
    n_logits = kscn.n_logits
    sched = linear_schedule(lr, 0.0, anneal_iters * ppo_epochs) if anneal_iters else lr
    opt = clip_adam(sched, max_norm=0.5)

    def init_params(generator):
        params = init_mappo(generator, ow, n_logits, a, hidden=hidden, dtype=dtype)
        return tree_map(lambda x: x.to(device), params)

    def actor(p):
        return {"l1": p["a1"], "l2": p["a2"], "out": p["pi"]}

    tmpl = init_mappo(torch.Generator().manual_seed(0), ow, n_logits, a, hidden=hidden)
    traj = fused_policy_trajectory(kscn, actor(tmpl), local, n_steps, horizon=horizon,
                                   block_envs=block_envs, t_chunk=t_chunk, device=device)
    kernel_update = fused_mappo_update(kscn, local, n_steps, hidden, clip=clip,
                                       vf_coef=vf_coef, ent_coef=ent_coef, device=device,
                                       dtype=dtype, compute_dtype=compute_dtype
                                       ) if fused_update else None
    nonterm_t = [0.0 if (t + 1) % horizon == 0 else 1.0 for t in range(n_steps)]

    def actor_logits(params, obs):
        """obs [..., A, OW, N] -> logits [..., A, K, N]."""
        h = _torso_minor(params["a1"], params["a2"], obs.to(dtype), rnd)
        return _head_minor(params["pi"], h, rnd)

    def central_value(params, obs):
        """obs [..., A, OW, N] -> joint-state value [..., N]."""
        joint = obs.to(dtype).reshape(obs.shape[:-3] + (a * ow,) + obs.shape[-1:])
        h = _torso_minor(params["c1"], params["c2"], joint, rnd)
        return _head_minor(params["v"], h, rnd)[..., 0, :]

    def loss_fn(params, batch):
        obs, mv_oh, cm_oh, logp_old, value_old, adv, ret = batch
        logp, ent = _factored_logp_ent(kscn, actor_logits(params, obs), mv_oh, cm_oh)
        value = central_value(params, obs)
        ratio = torch.exp(logp - logp_old)
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        adv_b = adv_n[..., None, :]                     # the team advantage of every agent
        pg = -torch.minimum(ratio * adv_b, torch.clamp(ratio, 1 - clip, 1 + clip) * adv_b).mean()
        v_clip = value_old + torch.clamp(value - value_old, -clip, clip)
        vloss = torch.maximum((value - ret).square(), (v_clip - ret).square()).mean()
        return pg + vf_coef * vloss - ent_coef * ent.mean(), (pg, vloss, ent.mean())

    def prep(params, obs, act, cact, rew, last_obs):
        """Centralized value on the joint obs [T, N]; GAE over the team
        reward (the mean across agents)."""
        mv_oh, cm_oh = _factored_onehots(kscn, act, cact, dtype)
        logp_old, _ = _factored_logp_ent(kscn, actor_logits(params, obs), mv_oh, cm_oh)
        value = central_value(params, obs).contiguous()
        last_value = central_value(params, last_obs)
        team_rew = _agent_rewards(kscn, rew).to(dtype).mean(-2)
        adv, ret = _gae_minor(value, team_rew, nonterm_t, last_value, gamma, lam)
        return obs.to(dtype), mv_oh, cm_oh, logp_old, value, adv, ret

    def trainer(traj, kernel_update):
        return _fused_trainer(kscn, opt, traj, actor, prep, loss_fn, kernel_update,
                              ppo_epochs=ppo_epochs, vf_coef=vf_coef, ent_coef=ent_coef,
                              fused_update=fused_update, init_params=init_params,
                              n_transitions=n_envs * n_steps, mesh=mesh, block_offset=offset)

    step = trainer(traj, kernel_update)
    step.plain = trainer(traj.plain, kernel_update.plain if fused_update else None)
    return step

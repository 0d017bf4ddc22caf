"""Fused MADDPG gradient: kernel K9 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_maddpg_update.py``).

``fused_maddpg_update`` builds ``grads_fn(params, targets, obs_b, act_b,
rew_b, obs2_b) -> (grads, (critic_loss, actor_loss, q_mean))`` and
``grads_fn.from_rows(params, targets, rows_b)`` for the stacked per-agent
trees of ``learner.maddpg.init_maddpg`` (centralized critics), on a batch
of replay rows ``[B, W]`` (``learner.maddpg.Buffer``'s layout ``[obs | act
| rew | obs2]``). The gradient is the hand-derived one of the JAX kernel,
pinned to autograd of the same losses (``learner.maddpg.maddpg_xla_grads``)
by the tests:

1. target actions: each agent's target actor on s', first-argmax one-hot;
2. TD targets ``y = r + gamma Q'(s', a')`` (bootstrapping through the
   horizon: episodes only truncate);
3. the critics' gradient of ``mean_{A,B} (Q(s, a) - y)^2``;
4. the actors' gradient of the exact expected-Q objective: at the logits
   ``dE/dz = p (qbar - E)``, where ``qbar[c]`` is the critic's value with
   the agent's own action replaced by candidate c, built from the critic's
   layer-1 pre-activation minus the agent's own-action columns plus the
   candidate's column;
5. the adjoint of the entropy bonus ``-sum p log(p + 1e-10)``, the
   ``p / (p + eps)`` term included (``s = log(p + eps) + p / (p + eps)``).

The TPU kernel's packed block-diagonal weights (``_tile_groups``,
``pack_params``, the grad masks, ``_cpad``) are a layout of the TPU's matrix
unit and have no counterpart: the port keeps the params' own layout. On a
CUDA device ``from_rows`` launches ``maddpg_target_actions_kernel``,
``maddpg_update_kernel`` and ``maddpg_reduce_kernel`` (``csrc/mpe_maddpg.cu``,
float32, 3 agents, hidden 64); on the CPU it runs ``plain_maddpg_update`` in
``dtype``. The target actors sum each layer in the kernel's order, so the
kernel and its plain version take the same target actions on the card. Only
move-only heads are ported (the comm head waits for ROADMAP B3).
"""

from __future__ import annotations

import torch

from mpe_tpu_torch._device import resolve_device

AGENTS, OBS_W, MOVES, HIDDEN = 3, 18, 5, 64     # the widths the CUDA kernel is built for


def _seq_dense_agents(w, b, x):
    """``x [B, A, in]`` through per-agent ``w [A, in, out]``, ``b [A, out]``
    -> ``[B, A, out]``, summed over ``in`` in order from the first product,
    then the bias (the order of the kernels' actor MLP)."""
    acc = x[..., 0:1] * w[:, 0]
    for q in range(1, w.shape[1]):
        acc = acc + x[..., q:q + 1] * w[:, q]
    return acc + b


def target_logits(target_actor, obs2_b):
    """The target actors' logits on s' [B, A, O] -> [B, A, K], in the order
    of ``maddpg_target_actions_kernel``."""
    h = torch.tanh(_seq_dense_agents(target_actor["l1"]["w"], target_actor["l1"]["b"], obs2_b))
    h = torch.tanh(_seq_dense_agents(target_actor["l2"]["w"], target_actor["l2"]["b"], h))
    return _seq_dense_agents(target_actor["out"]["w"], target_actor["out"]["b"], h)


def _split_rows(rows, a: int, o: int, k: int):
    """[B, W] rows -> (obs [B, A, O], act [B, A, K], rew [B, A], obs2 [B, A, O])."""
    b = rows.shape[0]
    ao, ak = a * o, a * k
    return (rows[:, :ao].reshape(b, a, o), rows[:, ao:ao + ak].reshape(b, a, k),
            rows[:, ao + ak:ao + ak + a], rows[:, ao + ak + a:].reshape(b, a, o))


def _critic_layers(c, joint):
    """Every agent's critic on the shared joint [B, J], each layer summed in
    the kernel's order -> (pre [B, A, H], h1, h2, q [B, A])."""
    x = joint[:, None, :].expand(-1, c["l1"]["w"].shape[0], -1)
    pre = _seq_dense_agents(c["l1"]["w"], c["l1"]["b"], x)
    h1 = torch.tanh(pre)
    h2, q = _critic_tail(c, h1)
    return pre, h1, h2, q


def _critic_tail(c, h1):
    """Layers 2 and 3 of every agent's critic: h1 [B, A, H] -> (h2, q [B, A])."""
    h2 = torch.tanh(_seq_dense_agents(c["l2"]["w"], c["l2"]["b"], h1))
    return h2, _seq_dense_agents(c["out"]["w"], c["out"]["b"], h2)[..., 0]


def _seq_sum(terms):
    """Terms [..., C] summed over C in order from the first."""
    acc = terms[..., 0]
    for m in range(1, terms.shape[-1]):
        acc = acc + terms[..., m]
    return acc


def plain_maddpg_update(params, targets, rows_b, *, gamma: float, ent_coef: float,
                        dtype=torch.float32):
    """The JAX ``_maddpg_update_kernel`` on the whole batch at once, in
    ``dtype`` -> (grads in init_maddpg layout, (critic_loss, actor_loss,
    q_mean)).

    The forward passes and the sums over candidates sum in the CUDA kernel's
    order. The expected-Q gradient ``p (qbar - E)`` is ill-conditioned in
    float32 once the critic is trained: Q near -70 while ``qbar - E`` is
    near 1e-3, so another summation order alone moves the actor's gradient
    by parts in a thousand (PERF.md); in this order the two agree to the
    rounding of the weight-gradient sums."""
    p = {n: {q: {w: x.detach().to(dtype) for w, x in layer.items()} for q, layer in net.items()}
         for n, net in params.items()}
    t = {n: {q: {w: x.detach().to(dtype) for w, x in layer.items()} for q, layer in net.items()}
         for n, net in targets.items()}
    a, o, h = p["actor"]["l1"]["w"].shape
    k = p["actor"]["out"]["w"].shape[-1]
    rows = rows_b.to(dtype)
    batch = rows.shape[0]
    obs, act, rew, obs2 = _split_rows(rows, a, o, k)
    joint = rows[:, :a * (o + k)]
    inv = 1.0 / float(a * batch)

    # 1-2. target actions and TD targets
    act2 = torch.nn.functional.one_hot(target_logits(t["actor"], obs2).argmax(-1), k).to(dtype)
    joint2 = torch.cat([obs2.reshape(batch, -1), act2.reshape(batch, -1)], dim=-1)
    y = rew + gamma * _critic_layers(t["critic"], joint2)[3]                 # [B, A]

    # 3. critics: forward, TD gradient, backward
    c = p["critic"]
    pre, h1, h2, q = _critic_layers(c, joint)
    d = q - y
    g3 = (2.0 * inv) * d                                                     # [B, A]
    gh2 = g3[..., None] * c["out"]["w"][..., 0] * (1.0 - h2.square())
    gh1 = torch.einsum("bag,ahg->bah", gh2, c["l2"]["w"]) * (1.0 - h1.square())
    critic = {"l1": {"w": torch.einsum("bah,bj->ajh", gh1, joint), "b": gh1.sum(0)},
              "l2": {"w": torch.einsum("bah,bag->ahg", h1, gh2), "b": gh2.sum(0)},
              "out": {"w": torch.einsum("bag,ba->ag", h2, g3)[..., None], "b": g3.sum(0)[:, None]}}

    # 4. candidate Q: layer-1 reuse without each agent's own-action columns
    w_act = torch.stack([c["l1"]["w"][i, a * o + i * k:a * o + (i + 1) * k] for i in range(a)])
    base = pre - _seq_sum(act[..., None, :] * w_act.transpose(1, 2))        # [B, A, H]
    qbar = torch.stack([_critic_tail(c, torch.tanh(base + w_act[:, m]))[1] for m in range(k)],
                       dim=-1)                                              # [B, A, K]

    # actors: forward, expected-Q and entropy gradient at the logits, backward
    ac = p["actor"]
    ha1 = torch.tanh(_seq_dense_agents(ac["l1"]["w"], ac["l1"]["b"], obs))
    ha2 = torch.tanh(_seq_dense_agents(ac["l2"]["w"], ac["l2"]["b"], ha1))
    z = _seq_dense_agents(ac["out"]["w"], ac["out"]["b"], ha2)              # [B, A, K]
    e = torch.exp(z - z.amax(-1, keepdim=True))
    pz = e / _seq_sum(e)[..., None]
    lse = torch.log(pz + 1e-10)
    s = lse + pz / (pz + 1e-10)
    ent = -_seq_sum(pz * lse)
    exp_q = _seq_sum(pz * qbar)                                             # [B, A]
    gz = (-(pz * (qbar - exp_q[..., None]))
          + (ent_coef * pz) * (s - _seq_sum(pz * s)[..., None])) * inv
    gha2 = torch.einsum("bak,ahk->bah", gz, ac["out"]["w"]) * (1.0 - ha2.square())
    gha1 = torch.einsum("bag,ahg->bah", gha2, ac["l2"]["w"]) * (1.0 - ha1.square())
    actor = {"l1": {"w": torch.einsum("bah,bao->aoh", gha1, obs), "b": gha1.sum(0)},
             "l2": {"w": torch.einsum("bah,bag->ahg", ha1, gha2), "b": gha2.sum(0)},
             "out": {"w": torch.einsum("bah,bak->ahk", ha2, gz), "b": gz.sum(0)}}
    metrics = ((d * d).sum() * inv, -(exp_q + ent_coef * ent).sum() * inv, q.sum() * inv)
    return {"actor": actor, "critic": critic}, metrics


def _net_buffer(net, stride: int):
    """Stacked net params -> [A, stride] kernel blocks: w1 [out, in], b1, w2,
    b2, w3, b3 per agent, zero-padded to ``stride``."""
    a = net["l1"]["w"].shape[0]
    parts = [x for q in ("l1", "l2", "out")
             for x in (net[q]["w"].detach().transpose(1, 2).reshape(a, -1), net[q]["b"].detach())]
    n = sum(x.shape[1] for x in parts)
    parts.append(parts[0].new_zeros((a, stride - n)))
    return torch.cat(parts, dim=1).to(torch.float32)


def _net_grads(buf, n_in: int, n_out: int):
    """[A, n] kernel-layout gradient blocks -> {l1, l2, out: {w [A, in, out], b}}."""
    a = buf.shape[0]
    sizes = [HIDDEN * n_in, HIDDEN, HIDDEN * HIDDEN, HIDDEN, n_out * HIDDEN, n_out]
    w1, b1, w2, b2, w3, b3 = torch.split(buf, sizes, dim=1)
    return {"l1": {"w": w1.reshape(a, HIDDEN, n_in).transpose(1, 2), "b": b1},
            "l2": {"w": w2.reshape(a, HIDDEN, HIDDEN).transpose(1, 2), "b": b2},
            "out": {"w": w3.reshape(a, n_out, HIDDEN).transpose(1, 2), "b": b3}}


def maddpg_update_cuda(params, targets, rows_b, *, gamma: float, ent_coef: float,
                       target_actions=None):
    """Launch kernel K9 on the rows' CUDA device: the outputs of
    ``plain_maddpg_update`` in float32. ``target_actions``, an int32 ``[A,
    B]`` tensor on the device, receives the target actions the kernel took.
    Counts launches in ``.launches``."""
    from mpe_tpu_torch.ops import _build

    device = rows_b.device
    if device.type != "cuda":
        raise ValueError(f"maddpg_update_cuda needs CUDA tensors, got {device}")
    a, o, k, h = AGENTS, OBS_W, MOVES, HIDDEN
    j = a * (o + k)
    batch = rows_b.shape[0]
    width = a * (2 * o + k + 1)
    if rows_b.dtype != torch.float32 or not rows_b.is_contiguous() or rows_b.dim() != 2:
        raise ValueError(f"rows_b must be a contiguous 2-D float32 tensor on {device}")
    if rows_b.shape[1] != width or batch < 1:
        raise ValueError(f"rows_b has shape {tuple(rows_b.shape)}, expected (B, {width})")
    want = {"actor": {"l1": (a, o, h), "l2": (a, h, h), "out": (a, h, k)},
            "critic": {"l1": (a, j, h), "l2": (a, h, h), "out": (a, h, 1)}}
    for tree in (params, targets):
        got = {n: {q: tuple(tree[n][q]["w"].shape) for q in want[n]} for n in want}
        if got != want:
            raise NotImplementedError(f"the MADDPG update kernel is built for {a} agents' "
                                      f"{o}-{h}-{h}-{k} actors and {j}-{h}-{h}-1 critics; got "
                                      f"weight shapes {got}")
    lib = _build.library("mpe_maddpg.cu")
    nwp, ncp, n_weights, ng, ts = (lib.mpe_maddpg_update_layout(q) for q in range(5))
    nw, nc = h * o + h + h * h + h + k * h + k, h * j + h + h * h + h + h + 1
    if ng != nw + nc + 3:
        raise RuntimeError("csrc/mpe_maddpg.cu and ops/fused_maddpg_update.py disagree on the "
                           "layout")
    wbuf = torch.cat([_net_buffer(params["actor"], nwp).reshape(-1),
                      _net_buffer(params["critic"], ncp).reshape(-1),
                      _net_buffer(targets["actor"], nwp).reshape(-1),
                      _net_buffer(targets["critic"], ncp).reshape(-1)]).to(device).contiguous()
    if wbuf.numel() != n_weights:
        raise RuntimeError(f"weight buffer of {wbuf.numel()} floats, the kernel reads {n_weights}")
    if target_actions is None:
        target_actions = torch.empty((a, batch), dtype=torch.int32, device=device)
    elif (target_actions.dtype != torch.int32 or tuple(target_actions.shape) != (a, batch)
          or target_actions.device != device or not target_actions.is_contiguous()):
        raise ValueError(f"target_actions must be a contiguous int32 ({a}, {batch}) tensor "
                         f"on {device}")
    n_tiles = -(-batch // ts)
    partials = torch.empty(a * n_tiles * ng, dtype=torch.float32, device=device)
    out = torch.empty((a, ng), dtype=torch.float32, device=device)
    inv = 1.0 / float(a * batch)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mpe_maddpg_update_a3h64(wbuf.data_ptr(), rows_b.data_ptr(),
                                         target_actions.data_ptr(), partials.data_ptr(),
                                         out.data_ptr(), batch, float(gamma), float(ent_coef),
                                         inv, stream)
    if rc != 0:
        raise RuntimeError(f"maddpg_update_kernel launch failed: {_build.error_string(rc)}")
    maddpg_update_cuda.launches += 1
    grads = {"actor": _net_grads(out[:, :nw], o, k), "critic": _net_grads(out[:, nw:nw + nc], j, 1)}
    sums = out[:, nw + nc:].sum(0)
    return grads, (sums[0] * inv, -sums[2] * inv, sums[1] * inv)


maddpg_update_cuda.launches = 0


def fused_maddpg_update(n_agents: int, obs_dim: int, act_dim: int, mw: int, hidden: int,
                        batch: int, gamma: float = 0.95, ent_coef: float = 0.01, device=None,
                        dtype=torch.float32):
    """Build ``grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b) ->
    (grads, (critic_loss, actor_loss, q_mean))`` with ``grads_fn.from_rows(
    params, targets, rows_b)``: kernel K9 on CUDA (float32 only), the plain
    version in ``dtype`` on the CPU; ``grads_fn.plain`` is the plain version
    (with its own ``from_rows``). The JAX builder's ``block_b`` and
    ``cand_group`` (its tiling) have no counterpart."""
    if act_dim != mw:
        raise NotImplementedError(f"act_dim {act_dim} has a comm head of {act_dim - mw}; the "
                                  "MADDPG update is ported for move-only heads (ROADMAP B3)")
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the MADDPG update kernel computes in float32; use dtype=torch.float32 "
                         "on CUDA")
    width = n_agents * (2 * obs_dim + act_dim + 1)
    hp = dict(gamma=gamma, ent_coef=ent_coef)

    def check(params, rows_b):
        got = tuple(params["actor"]["l1"]["w"].shape)
        if got != (n_agents, obs_dim, hidden):
            raise ValueError(f"actor l1 weight shape {got} != {(n_agents, obs_dim, hidden)}")
        if tuple(rows_b.shape) != (batch, width):
            raise ValueError(f"rows_b has shape {tuple(rows_b.shape)}, expected {(batch, width)}")

    def to_rows(obs_b, act_b, rew_b, obs2_b):
        b = obs_b.shape[0]
        return torch.cat([obs_b.reshape(b, -1), act_b.reshape(b, -1), rew_b,
                          obs2_b.reshape(b, -1)], dim=1).contiguous()

    def plain_rows(params, targets, rows_b):
        check(params, rows_b)
        return plain_maddpg_update(params, targets, rows_b, dtype=dtype, **hp)

    def from_rows(params, targets, rows_b):
        if device.type == "cuda":
            check(params, rows_b)
            return maddpg_update_cuda(params, targets, rows_b.to(torch.float32).contiguous(), **hp)
        return plain_rows(params, targets, rows_b)

    def grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b):
        return from_rows(params, targets, to_rows(obs_b, act_b, rew_b, obs2_b))

    def plain(params, targets, obs_b, act_b, rew_b, obs2_b):
        return plain_rows(params, targets, to_rows(obs_b, act_b, rew_b, obs2_b))

    plain.from_rows = plain_rows
    grads_fn.from_rows = from_rows
    grads_fn.plain = plain
    return grads_fn

"""Fused MADDPG gradient: kernel K9 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_maddpg_update.py``), on the nine
scenarios, comm heads included.

``fused_maddpg_update`` builds ``grads_fn(params, targets, obs_b, act_b,
rew_b, obs2_b) -> (grads, (critic_loss, actor_loss, q_mean))`` and
``grads_fn.from_rows(params, targets, rows_b)`` for the stacked per-agent
trees of ``learner.maddpg.init_maddpg`` (centralized critics), on a batch
of replay rows ``[B, W]`` (``learner.maddpg.Buffer``'s layout ``[obs | act
| rew | obs2]``). An actor's head is ``mw`` move logits, then ``cw`` comm
logits where the scenario speaks (``cw = 0`` otherwise). The gradient is the
hand-derived one of the JAX kernel, pinned to autograd of the same losses
(``learner.maddpg.maddpg_xla_grads``) by the tests:

1. target actions: each agent's target actor on s', a first-argmax one-hot
   per head;
2. TD targets ``y = r + gamma Q'(s', a')`` (bootstrapping through the
   horizon: episodes only truncate);
3. the critics' gradient of ``mean_{A,B} (Q(s, a) - y)^2``;
4. the actors' gradient of the exact expected-Q objective under the
   factored policy ``pm x pc``: every candidate ``m * cw + j`` of the full
   (move x comm) grid has its critic value ``q`` with the agent's own action
   replaced by (move m, comm j), built from the critic's layer-1
   pre-activation minus the agent's own-action columns plus the candidate's
   column sum ``w[:, m] + w[:, mw + j]``; then ``qbar_m[m] = sum_j pc[j]
   q[m, j]``, ``qbar_c[j] = sum_m pm[m] q[m, j]``, ``E = sum_m pm qbar_m``,
   and at the logits ``dE/dz = p (qbar - E)`` per head;
5. the adjoint of the entropy bonus ``-sum p log(p + 1e-10)`` of both heads,
   the ``p / (p + eps)`` term included (``s = log(p + eps) + p / (p +
   eps)``).

The TPU kernel's packed block-diagonal weights (``_tile_groups``,
``pack_params``, the grad masks, ``_cpad``) and its lane-concatenated
candidate groups are layouts of the TPU's matrix unit and have no
counterpart: the port keeps each net's own layout, flattened agent-major
into one buffer (``PackedLayout``). On a CUDA device ``from_rows`` launches
``maddpg_target_actions_kernel``, ``maddpg_td_kernel``,
``maddpg_update_kernel`` and ``maddpg_reduce_kernel`` (``csrc/mpe_maddpg.cu``,
float32, built at the params' hidden width: 8, 16, 32, 64, 128 or 256,
``_build.HIDDEN_WIDTHS["mpe_maddpg.cu"]``; at 128 and 256 five wide kernels:
``maddpg_transpose_wide_kernel`` (the nets' weights as [in][out] rows),
``maddpg_forward_wide_kernel`` (the critic's forward beside the target
actions), ``maddpg_td_cand_wide_kernel`` (the TD targets beside the
candidates' Q, a pass of its own over (agent, candidate, sample) columns,
left last in the scratch as ``plain_candidate_q`` lays it out),
``maddpg_backward_wide_kernel`` (the critic's backward beside the actor) and
the reduce; ``partials_floats`` sizes the partials and the scratch; the
library counts each kernel where it launches it, ``mpe_maddpg_update_launched``),
instantiated for the scenario whose widths the
params have; on the CPU it runs ``plain_maddpg_update`` in ``dtype``. The
trainer's chunk (``learner.maddpg.build_fused_update_chunk``) keeps its
state in that buffer and launches K9 through ``MaddpgUpdateLauncher``. The target actors sum each layer in the kernel's order, so the
kernel and its plain version take the same target actions on the card.

``compute_dtype=torch.bfloat16`` is the JAX kernel's ``cd = bfloat16``
(``maddpg_rounding``): every product rounds both operands to bf16 and sums
in float32, the rest stays float32 (``plain_maddpg_update``). On a CUDA
device it launches K9-bf16 (``csrc/mpe_maddpg_bf16.cu``: K9's four stages
and layout with the products on the tensor cores by ``mma.sync``, built at
the params' hidden width, 8-256, ``_build.HIDDEN_WIDTHS["mpe_maddpg_bf16.cu"]``;
at 128 and 256 the wide kernels ``maddpg_round_bf16_wide_kernel``,
``maddpg_target_bf16_wide_kernel``, ``maddpg_td_bf16_wide_kernel`` and
``maddpg_grad_bf16_wide_kernel``, the last on a persistent grid of at most
layout constant 11 CTAs an agent that ``partials_floats`` sizes; counted in
``maddpg_update_bf16_cuda.launches``), on the same float32 weight buffer;
no width falls back to K9 or to the plain version.
The two paths round an activation whose float32 sum they took in another
order a whole bf16 ulp apart now and then, so a target action may differ
where a head's two best logits lie within ``target_logit_tolerance``.
"""

from __future__ import annotations

import collections
import functools

import torch

from mpe_tpu_torch._device import resolve_device
from mpe_tpu_torch.ops._build import DEFAULT_HIDDEN, check_hidden
from mpe_tpu_torch.ops.fused_update import _keep, compute_rounding


def _seq_dense_agents(w, b, x):
    """``x [B, A, in]`` through per-agent ``w [A, in, out]``, ``b [A, out]``
    -> ``[B, A, out]``, summed over ``in`` in order from the first product,
    then the bias (the order of the kernels' actor MLP)."""
    acc = x[..., 0:1] * w[:, 0]
    for q in range(1, w.shape[1]):
        acc = acc + x[..., q:q + 1] * w[:, q]
    return acc + b


def target_logits(target_actor, obs2_b, compute_dtype=None):
    """The target actors' logits on s' [B, A, O] -> [B, A, K], in the order
    of ``maddpg_target_actions_kernel``; with ``compute_dtype=torch.bfloat16``
    each product's operands rounded to bf16 (``maddpg_rounding``)."""
    rnd = maddpg_rounding(compute_dtype)[1]
    ta = target_actor
    h = torch.tanh(_seq_dense_agents(rnd(ta["l1"]["w"]), ta["l1"]["b"], rnd(obs2_b)))
    h = torch.tanh(_seq_dense_agents(rnd(ta["l2"]["w"]), ta["l2"]["b"], rnd(h)))
    return _seq_dense_agents(rnd(ta["out"]["w"]), ta["out"]["b"], rnd(h))


def target_indices(logits, mw: int):
    """First-argmax per head of logits [..., K]: [..., 1] (move) or [..., 2]
    (move, comm) where K > mw."""
    idx = [logits[..., :mw].argmax(-1)]
    if logits.shape[-1] > mw:
        idx.append(logits[..., mw:].argmax(-1))
    return torch.stack(idx, dim=-1)


def target_logit_tolerance(target_actor, flips: int = 2):
    """How far two right implementations of the bf16 path may put one target
    logit apart, per agent ``[A]``: both round the same float32 values to
    bf16, but a float32 sum that the two take in another order (the mma's
    against an einsum's) differs in its last bits, and where it lies next to a
    bf16 rounding boundary the rounded activation differs by one ulp, at most
    2^-8 for a tanh output. One such flip of an h2 unit moves logit c by at
    most ``|w3[c, g]| 2^-8``, one of an h1 unit by about ``sum_g |w3[c, g]|
    |w2[g, h]| 2^-8`` (through layer 2, tanh' <= 1). The tolerance allows
    ``flips`` flips of the larger kind per sample, on both logits of a pair
    (a factor 2), plus the float32 rounding of the logit's own sum of H
    products (``2 H 2^-24 sum_g |w3[c, g]|``): a head whose best and second
    logits lie further apart takes the same action in both."""
    w2 = target_actor["l2"]["w"].detach().abs().float()             # [A, H(in), H(out)]
    w3 = target_actor["out"]["w"].detach().abs().float()            # [A, H, K]
    one = torch.maximum(w3.amax(1), torch.einsum("agc,ahg->ahc", w3, w2).amax(1))  # [A, K]
    h = w3.shape[1]
    per_logit = 2.0 * flips * 2.0 ** -8 * one + 2.0 * h * 2.0 ** -24 * w3.sum(1)
    return per_logit.amax(-1)


def head_onehots(idx, mw: int, k: int, dtype):
    """Per-head indices [..., heads] -> [move | comm] one-hots [..., K]."""
    parts = [torch.nn.functional.one_hot(idx[..., 0], mw)]
    if k > mw:
        parts.append(torch.nn.functional.one_hot(idx[..., 1], k - mw))
    return torch.cat(parts, dim=-1).to(dtype)


def _split_rows(rows, a: int, o: int, k: int):
    """[B, W] rows -> (obs [B, A, O], act [B, A, K], rew [B, A], obs2 [B, A, O])."""
    b = rows.shape[0]
    ao, ak = a * o, a * k
    return (rows[:, :ao].reshape(b, a, o), rows[:, ao:ao + ak].reshape(b, a, k),
            rows[:, ao + ak:ao + ak + a], rows[:, ao + ak + a:].reshape(b, a, o))


def _critic_layers(c, joint, rnd=_keep):
    """Every agent's critic on the shared joint [B, J], each layer summed in
    the kernel's order -> (pre [B, A, H], h1, h2, q [B, A])."""
    x = rnd(joint)[:, None, :].expand(-1, c["l1"]["w"].shape[0], -1)
    pre = _seq_dense_agents(rnd(c["l1"]["w"]), c["l1"]["b"], x)
    h1 = torch.tanh(pre)
    h2, q = _critic_tail(c, h1, rnd)
    return pre, h1, h2, q


def _critic_tail(c, h1, rnd=_keep):
    """Layers 2 and 3 of every agent's critic: h1 [B, A, H] -> (h2, q [B, A])."""
    h2 = torch.tanh(_seq_dense_agents(rnd(c["l2"]["w"]), c["l2"]["b"], rnd(h1)))
    return h2, _seq_dense_agents(rnd(c["out"]["w"]), c["out"]["b"], rnd(h2))[..., 0]


def _seq_sum(terms):
    """Terms [..., C] summed over C in order from the first."""
    acc = terms[..., 0]
    for m in range(1, terms.shape[-1]):
        acc = acc + terms[..., m]
    return acc


def _softmax_eps(z):
    """``_softmax_eps`` of one head, logits [..., K] -> (p, s, entropy), each
    sum over K in index order: ``s = log(p + 1e-10) + p / (p + 1e-10)``,
    entropy ``-sum p log(p + 1e-10)``."""
    e = torch.exp(z - z.amax(-1, keepdim=True))
    p = e / _seq_sum(e)[..., None]
    lse = torch.log(p + 1e-10)
    return p, lse + p / (p + 1e-10), -_seq_sum(p * lse)


def _head_grad(p, s, qbar, exp_q, ent_coef: float, inv: float):
    """The logit gradient of one head: ``(-(p (qbar - E)) + ent_coef p (s -
    sum p s)) / (A B)``."""
    return (-(p * (qbar - exp_q[..., None]))
            + (ent_coef * p) * (s - _seq_sum(p * s)[..., None])) * inv


def _candidate_q(c, pre, act, mw: int, rnd=_keep):
    """Every candidate's Q on the (move x comm) grid -> [B, A, mw cx]: the
    critic's layer-1 pre-activation ``pre [B, A, H]`` without each agent's
    own-action columns (a product with ``act [B, A, K]``), plus the
    candidate's column sum (float32, as JAX's dcand), through layers 2-3."""
    a, k = act.shape[1], act.shape[-1]
    ao = c["l1"]["w"].shape[1] - a * k
    cw = k - mw
    w_act = torch.stack([c["l1"]["w"][i, ao + i * k:ao + (i + 1) * k] for i in range(a)])
    base = pre - _seq_sum(rnd(act)[..., None, :] * rnd(w_act).transpose(1, 2))  # [B, A, H]
    dcand = [w_act[:, m] + w_act[:, mw + j] if cw else w_act[:, m]
             for m in range(mw) for j in range(max(cw, 1))]                 # [A, H] each
    return torch.stack([_critic_tail(c, torch.tanh(base + dc), rnd)[1] for dc in dcand], dim=-1)


def plain_candidate_q(params, rows_b, *, mw: int):
    """The Q of every agent's candidates on replay rows ``[B, W]``, as the
    plain version computes them (float32) -> ``[A, mw cx, B]``, the layout of
    the wide K9's candidates' Q at the end of its scratch."""
    c = {q: {w: x.detach().float() for w, x in layer.items()} for q, layer in
         params["critic"].items()}
    a, o, _ = params["actor"]["l1"]["w"].shape
    k = params["actor"]["out"]["w"].shape[-1]
    rows = rows_b.float()
    act = _split_rows(rows, a, o, k)[1]
    pre = _critic_layers(c, rows[:, :a * (o + k)])[0]
    return _candidate_q(c, pre, act, mw).permute(1, 2, 0)


def plain_maddpg_update(params, targets, rows_b, *, mw: int, gamma: float, ent_coef: float,
                        dtype=torch.float32, compute_dtype=None, target_actions=None):
    """The JAX ``_maddpg_update_kernel`` on the whole batch at once, in
    ``dtype`` -> (grads in init_maddpg layout, (critic_loss, actor_loss,
    q_mean)); ``mw`` move logits, the rest of the head is comm.

    ``compute_dtype=torch.bfloat16`` is the JAX kernel's ``cd = bfloat16``:
    every product (the four forward MLPs, the critic's and the actors'
    backward and weight gradients, the candidates' layers 2-3) rounds both
    operands to bf16 (``maddpg_rounding``), the s' rows and the
    joints among them, and sums in float32; the tanh, ``1 - h^2``, the
    softmaxes, argmaxes, bias and metric sums stay float32, and the update
    computes and returns float32. The candidates' base subtracts the
    bf16-rounded own-action columns (a product) and adds the float32
    candidate columns (JAX's ``dcand``, an einsum outside the kernel), so at
    bf16 the candidate of the action taken does not give back the
    pre-activation. ``target_actions``, int ``[A, heads, B]`` as the kernels
    write them, replaces the target actors' first argmax (to hold a kernel's
    gradient on the actions it took).

    The forward passes and the sums over candidates and heads sum in the
    CUDA kernel's order. The expected-Q gradient ``p (qbar - E)`` is
    ill-conditioned in float32 once the critic is trained: Q near -70 while
    ``qbar - E`` is near 1e-3, so another summation order alone moves the
    actor's gradient by parts in a thousand (PERF.md); in this order the two
    agree to the rounding of the weight-gradient sums."""
    dtype, rnd = maddpg_rounding(compute_dtype, dtype)
    p = {n: {q: {w: x.detach().to(dtype) for w, x in layer.items()} for q, layer in net.items()}
         for n, net in params.items()}
    t = {n: {q: {w: x.detach().to(dtype) for w, x in layer.items()} for q, layer in net.items()}
         for n, net in targets.items()}
    a, o, h = p["actor"]["l1"]["w"].shape
    k = p["actor"]["out"]["w"].shape[-1]
    cw = k - mw
    rows = rows_b.to(dtype)
    batch = rows.shape[0]
    obs, act, rew, obs2 = _split_rows(rows, a, o, k)
    joint = rows[:, :a * (o + k)]
    inv = 1.0 / float(a * batch)

    # 1-2. target actions (first argmax per head) and TD targets
    if target_actions is None:
        idx = target_indices(target_logits(t["actor"], obs2, compute_dtype), mw)
    else:
        idx = target_actions.to(rows.device).long().permute(2, 0, 1)       # [B, A, heads]
    act2 = head_onehots(idx, mw, k, dtype)
    joint2 = torch.cat([obs2.reshape(batch, -1), act2.reshape(batch, -1)], dim=-1)
    y = rew + gamma * _critic_layers(t["critic"], joint2, rnd)[3]            # [B, A]

    # 3. critics: forward, TD gradient, backward
    c = p["critic"]
    pre, h1, h2, q = _critic_layers(c, joint, rnd)
    d = q - y
    g3 = (2.0 * inv) * d                                                     # [B, A]
    gh2 = rnd(g3)[..., None] * rnd(c["out"]["w"][..., 0]) * (1.0 - h2.square())
    gh1 = torch.einsum("bag,ahg->bah", rnd(gh2), rnd(c["l2"]["w"])) * (1.0 - h1.square())
    critic = {"l1": {"w": torch.einsum("bah,bj->ajh", rnd(gh1), rnd(joint)), "b": gh1.sum(0)},
              "l2": {"w": torch.einsum("bah,bag->ahg", rnd(h1), rnd(gh2)), "b": gh2.sum(0)},
              "out": {"w": torch.einsum("bag,ba->ag", rnd(h2), rnd(g3))[..., None],
                      "b": g3.sum(0)[:, None]}}

    # 4. candidate Q on the (move x comm) grid
    qc = _candidate_q(c, pre, act, mw, rnd)                                  # [B, A, mw cx]

    # actors: forward, expected-Q and entropy gradient at the logits, backward
    ac = p["actor"]
    ha1 = torch.tanh(_seq_dense_agents(rnd(ac["l1"]["w"]), ac["l1"]["b"], rnd(obs)))
    ha2 = torch.tanh(_seq_dense_agents(rnd(ac["l2"]["w"]), ac["l2"]["b"], rnd(ha1)))
    z = _seq_dense_agents(rnd(ac["out"]["w"]), ac["out"]["b"], rnd(ha2))    # [B, A, K]
    pm, sm, ent = _softmax_eps(z[..., :mw])
    if cw:
        pc, sc, ent_c = _softmax_eps(z[..., mw:])
        qg = qc.reshape(batch, a, mw, cw)
        qbar_m = _seq_sum(pc[..., None, :] * qg)                             # over comm j
        qbar_c = _seq_sum((pm[..., :, None] * qg).transpose(-1, -2))         # over move m
        ent = ent + ent_c
    else:
        qbar_m = qc
    exp_q = _seq_sum(pm * qbar_m)                                           # [B, A]
    gz = _head_grad(pm, sm, qbar_m, exp_q, ent_coef, inv)
    if cw:
        gz = torch.cat([gz, _head_grad(pc, sc, qbar_c, exp_q, ent_coef, inv)], dim=-1)
    gha2 = torch.einsum("bak,ahk->bah", rnd(gz), rnd(ac["out"]["w"])) * (1.0 - ha2.square())
    gha1 = torch.einsum("bag,ahg->bah", rnd(gha2), rnd(ac["l2"]["w"])) * (1.0 - ha1.square())
    actor = {"l1": {"w": torch.einsum("bah,bao->aoh", rnd(gha1), rnd(obs)), "b": gha1.sum(0)},
             "l2": {"w": torch.einsum("bah,bag->ahg", rnd(ha1), rnd(gha2)), "b": gha2.sum(0)},
             "out": {"w": torch.einsum("bah,bak->ahk", rnd(ha2), rnd(gz)), "b": gz.sum(0)}}
    metrics = ((d * d).sum() * inv, -(exp_q + ent_coef * ent).sum() * inv, q.sum() * inv)
    return {"actor": actor, "critic": critic}, metrics


def maddpg_rounding(compute_dtype, dtype=torch.float32):
    """``compute_dtype`` of the MADDPG update -> (the dtype it computes and
    returns in, the rounding of a product's operands): float32 (JAX's
    default) or None computes in ``dtype``; ``torch.bfloat16`` is the bf16
    path in float32 (``fused_update.compute_rounding``); any other dtype
    raises."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return dtype, _keep
    return compute_rounding(compute_dtype, dtype)


def _net_buffer(net, stride: int, dtype=torch.float32):
    """Stacked net params -> [A, stride] kernel blocks: w1 [out, in], b1, w2,
    b2, w3, b3 per agent, zero-padded to ``stride``, in ``dtype``."""
    a = net["l1"]["w"].shape[0]
    parts = [x for q in ("l1", "l2", "out")
             for x in (net[q]["w"].detach().transpose(1, 2).reshape(a, -1), net[q]["b"].detach())]
    n = sum(x.shape[1] for x in parts)
    parts.append(parts[0].new_zeros((a, stride - n)))
    return torch.cat(parts, dim=1).to(dtype)


def _net_grads(buf, n_in: int, n_out: int, hidden: int = DEFAULT_HIDDEN):
    """[A, >= n] kernel-layout blocks -> {l1, l2, out: {w [A, in, out], b}}
    (views of ``buf``)."""
    a = buf.shape[0]
    sizes = [hidden * n_in, hidden, hidden * hidden, hidden, n_out * hidden, n_out]
    w1, b1, w2, b2, w3, b3 = torch.split(buf[:, :sum(sizes)], sizes, dim=1)
    return {"l1": {"w": w1.reshape(a, hidden, n_in).transpose(1, 2), "b": b1},
            "l2": {"w": w2.reshape(a, hidden, hidden).transpose(1, 2), "b": b2},
            "out": {"w": w3.reshape(a, n_out, hidden).transpose(1, 2), "b": b3}}


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


class PackedLayout:
    """K9's weight buffer (``MaddpgDims`` in ``csrc/mpe_maddpg.cu``): the
    actors ``[A, NWP]``, the critics ``[A, NCP]``, then the target actors
    and target critics, agent-major, each net in the kernel layout (w1 [out,
    in], b1, w2, b2, w3, b3) zero-padded to a 16-byte stride. The live nets
    (``[:off_ta]``) are also the layout of K9's gradient and of the packed
    Adam moments, so that Adam and Polyak run on whole flat buffers.
    ``critic_in`` is the critics' input width: the joint ``A*(O+K)`` by
    default (K9's), ``O+K`` for independent-DDPG critics, which the update
    chunk packs the same way and never hands to K9."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int, hidden: int = DEFAULT_HIDDEN,
                 critic_in: int | None = None):
        a, h = n_agents, hidden
        self.a, self.o, self.k, self.hidden = a, obs_dim, act_dim, h
        self.j = a * (obs_dim + act_dim) if critic_in is None else critic_in
        self.nw = h * obs_dim + h + h * h + h + act_dim * h + act_dim
        self.nc = h * self.j + h + h * h + h + h + 1
        self.nwp, self.ncp = _round4(self.nw), _round4(self.nc)
        self.off_c = a * self.nwp
        self.off_ta = self.off_c + a * self.ncp
        self.n_weights = 2 * self.off_ta

    def nets(self, flat):
        """A flat live block [off_ta] (params, gradient or moments) ->
        (actors [A, NWP], critics [A, NCP]), views."""
        return (flat[:self.off_c].view(self.a, self.nwp),
                flat[self.off_c:self.off_ta].view(self.a, self.ncp))

    def pack_nets(self, tree, dtype):
        """``{"actor", "critic"}`` trees -> a new flat live block [off_ta]."""
        return torch.cat([_net_buffer(tree["actor"], self.nwp, dtype).reshape(-1),
                          _net_buffer(tree["critic"], self.ncp, dtype).reshape(-1)])

    def tree(self, block, net: str):
        """An ``[A, stride]`` block of the actors or the critics -> its
        ``{l1, l2, out: {w, b}}`` tree of new contiguous tensors."""
        n_in, n_out = (self.o, self.k) if net == "actor" else (self.j, 1)
        return {q: {w: x.contiguous().clone() for w, x in layer.items()}
                for q, layer in _net_grads(block, n_in, n_out, self.hidden).items()}

    def unpack_nets(self, flat):
        """A flat live block -> ``{"actor", "critic"}`` trees of new
        contiguous tensors."""
        actor, critic = self.nets(flat)
        return {"actor": self.tree(actor, "actor"), "critic": self.tree(critic, "critic")}

    def pack(self, params, targets, dtype=torch.float32):
        """params and targets -> K9's weight buffer [n_weights]."""
        return torch.cat([self.pack_nets(params, dtype), self.pack_nets(targets, dtype)])


@functools.cache
def kernel_scenario_of(n_agents: int, obs_dim: int, cw: int):
    """The scenario whose K9 instantiation has these widths (agents, obs
    rows, comm logits), or None."""
    from mpe_tpu_torch.ops._build import SCENARIO_IDS
    from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario

    for name in _KERNEL_SCENARIOS:
        kscn = kernel_scenario(name)
        if (type(kscn).__name__ in SCENARIO_IDS
                and (kscn.spec.n_agents, kscn.obs_w, kscn.n_comm) == (n_agents, obs_dim, cw)):
            return kscn
    return None


def _k9_source(compute_dtype) -> str:
    """The source of K9 (float32) or K9-bf16 for ``compute_dtype``."""
    if maddpg_rounding(compute_dtype)[1] is _keep:
        return "mpe_maddpg.cu"
    return "mpe_maddpg_bf16.cu"


@functools.cache
def _update_layout(scenario: int, hidden: int = DEFAULT_HIDDEN, source: str = "mpe_maddpg.cu"):
    """K9's (or K9-bf16's) layout constants for a scenario id at a hidden
    width: (actor stride, critic stride, weights, gradient per agent, samples
    per tile)."""
    from mpe_tpu_torch.ops import _build

    lib = _build.library(source, hidden)
    return tuple(lib.mpe_maddpg_update_layout(scenario, q) for q in range(5))


def partials_floats(lib, scenario: int, n_agents: int, batch: int) -> int:
    """The floats of K9's (or K9-bf16's) ``partials`` buffer at ``batch``:
    the partial gradients, one per tile (at hidden 128 and 256 one per CTA
    pair of K9's backward kernel, at most layout constant 6 of K9's library
    an agent; K9-bf16's at most its layout constant 11) and after them (16-byte aligned) K9-bf16's
    bf16 scratch of the rounded nets (layout constant 5) or, at K9's hidden
    128 and 256, w2's transposed copies (layout constant 8) and the
    candidates' base pre-activation and Q (layout constant 7 floats a
    sample)."""
    ng, ts, scratch = (lib.mpe_maddpg_update_layout(scenario, q) for q in (3, 4, 5))
    tiles = -(-batch // ts)
    parts = lib.mpe_maddpg_update_layout(scenario, 6 if scratch < 0 else 11)
    floats = n_agents * (tiles if parts < 0 else min(tiles, parts)) * ng
    if scratch < 0 and lib.mpe_maddpg_update_layout(scenario, 7) > 0:
        scratch = (lib.mpe_maddpg_update_layout(scenario, 8)
                   + lib.mpe_maddpg_update_layout(scenario, 7) * batch)
    return floats if scratch < 0 else -(-floats // 4) * 4 + scratch


class MaddpgUpdateLauncher:
    """Kernel K9 (or, with ``compute_dtype=torch.bfloat16``, K9-bf16) on one
    device for one scenario's widths and one batch size, its arguments
    checked once: ``launch(weights, rows_b, grads, metrics,
    target_actions=None)`` takes the weight buffer (``PackedLayout``, float32
    for both kernels), replay rows ``[B, W]`` and writes the gradient
    ``[off_ta]`` (the live nets' layout, the padding 0) and ``metrics [3]``
    (critic loss, actor loss, Q mean), all float32 on the device, with
    nothing checked or computed per call. Counts launches in
    ``maddpg_update_cuda.launches`` and ``.launches_by`` (K9-bf16:
    ``maddpg_update_bf16_cuda``'s)."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int, mw: int, hidden: int,
                 batch: int, device, *, gamma: float, ent_coef: float,
                 compute_dtype=torch.float32):
        from mpe_tpu_torch.ops import _build

        self.source = _k9_source(compute_dtype)
        check_hidden(hidden, "the MADDPG update kernels", self.source)
        self.counter = (maddpg_update_cuda if self.source == "mpe_maddpg.cu"
                        else maddpg_update_bf16_cuda)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"the MADDPG update kernel needs a CUDA device, got {device}")
        if device.index is None:                   # as tensors made on it report it
            device = torch.device("cuda", torch.cuda.current_device())
        kscn = kernel_scenario_of(n_agents, obs_dim, act_dim - mw)
        if kscn is None or act_dim < mw or batch < 1:
            raise NotImplementedError(
                f"no MADDPG update kernel for {n_agents} agents' {obs_dim}-{hidden}-{hidden}-"
                f"{act_dim} actors with {mw} moves at batch {batch}: the kernel is built for the "
                f"nine scenarios' widths")
        self.layout = PackedLayout(n_agents, obs_dim, act_dim, hidden)
        self.scenario = _build.SCENARIO_IDS[type(kscn).__name__]
        self.name = kscn.spec.name
        self.hidden = hidden
        lay = self.layout
        nwp, ncp, n_weights, ng, _ = _update_layout(self.scenario, hidden, self.source)
        if (nwp, ncp, n_weights, ng) != (lay.nwp, lay.ncp, lay.n_weights, lay.nw + lay.nc + 3):
            raise RuntimeError(f"csrc/{self.source} and ops/fused_maddpg_update.py disagree on "
                               "K9's layout")
        self.device, self.batch = device, batch
        self.nh = 2 if act_dim > mw else 1
        self.width = n_agents * (2 * obs_dim + act_dim + 1)
        f32 = dict(dtype=torch.float32, device=device)
        self.act2 = torch.empty((n_agents, self.nh, batch), dtype=torch.int32, device=device)
        self.y = torch.empty((n_agents, batch), **f32)
        self.partials = torch.empty(
            partials_floats(_build.library(self.source, hidden), self.scenario, n_agents, batch),
            **f32)
        self.consts = (float(gamma), float(ent_coef), 1.0 / float(n_agents * batch))
        self.fn = _build.library(self.source, hidden).mpe_maddpg_update

    def check(self, weights, rows, grads=None, metrics=None):
        """Raise unless the buffers are what ``launch`` takes."""
        want = ((weights, (self.layout.n_weights,)), (rows, (self.batch, self.width)),
                (grads, (self.layout.off_ta,)), (metrics, (3,)))
        for x, shape in want:
            if x is None:
                continue
            if (x.dtype != torch.float32 or x.device != self.device or not x.is_contiguous()
                    or tuple(x.shape) != shape):
                raise ValueError(f"K9 takes contiguous float32 {shape} buffers on "
                                 f"{self.device}; got {x.dtype} {tuple(x.shape)} on {x.device}")
        if weights.data_ptr() % 16:                # the wide kernels' bulk copies
            raise ValueError("K9 takes a 16-byte aligned weight buffer")

    def launch(self, weights, rows, grads, metrics, target_actions=None):
        act2 = self.act2 if target_actions is None else target_actions
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = self.fn(self.scenario, weights.data_ptr(), rows.data_ptr(), act2.data_ptr(),
                         self.y.data_ptr(), self.partials.data_ptr(), grads.data_ptr(),
                         metrics.data_ptr(), self.batch, *self.consts, stream)
        if rc != 0:
            from mpe_tpu_torch.ops import _build

            raise RuntimeError(f"the K9 launch of csrc/{self.source} failed: "
                               f"{_build.error_string(rc)}")
        self.counter.launches += 1
        self.counter.launches_by[self.name] += 1


def maddpg_update_cuda(params, targets, rows_b, *, mw: int, gamma: float, ent_coef: float,
                       target_actions=None, compute_dtype=torch.float32):
    """Launch kernel K9 (``compute_dtype`` float32 or None) or K9-bf16
    (``torch.bfloat16``) on the rows' CUDA device: the outputs of
    ``plain_maddpg_update(..., compute_dtype=compute_dtype)`` in float32,
    from trees (packed here, each call; the trainer's chunk keeps its state
    packed and calls ``MaddpgUpdateLauncher`` itself). ``target_actions``, an
    int32 ``[A, heads, B]`` tensor on the device (heads 2 with a comm head,
    else 1), receives the target actions the kernel took. Counts K9's
    launches in ``.launches`` and, by scenario name, in ``.launches_by``;
    K9-bf16's in ``maddpg_update_bf16_cuda``'s."""
    device = rows_b.device
    a, o, h = params["actor"]["l1"]["w"].shape
    check_hidden(h, "the MADDPG update kernels", _k9_source(compute_dtype))
    if device.type != "cuda":
        raise ValueError(f"maddpg_update_cuda needs CUDA tensors, got {device}")
    k = params["actor"]["out"]["w"].shape[-1]
    if rows_b.dim() != 2:
        raise ValueError(f"rows_b must be a contiguous 2-D float32 tensor on {device}")
    launcher = MaddpgUpdateLauncher(a, o, k, mw, h, rows_b.shape[0], device, gamma=gamma,
                                    ent_coef=ent_coef, compute_dtype=compute_dtype)
    lay = launcher.layout
    want = {"actor": {"l1": (a, o, h), "l2": (a, h, h), "out": (a, h, k)},
            "critic": {"l1": (a, lay.j, h), "l2": (a, h, h), "out": (a, h, 1)}}
    for tree in (params, targets):
        got = {n: {q: tuple(tree[n][q]["w"].shape) for q in want[n]} for n in want}
        if got != want:
            raise ValueError(f"the MADDPG update kernel takes {a} agents' {o}-{h}-{h}-{k} "
                             f"actors and {lay.j}-{h}-{h}-1 critics; got weight shapes {got}")
    weights = lay.pack(params, targets).to(device)
    grads = torch.empty(lay.off_ta, dtype=torch.float32, device=device)
    metrics = torch.empty(3, dtype=torch.float32, device=device)
    if target_actions is not None and (
            target_actions.dtype != torch.int32 or not target_actions.is_contiguous()
            or tuple(target_actions.shape) != (a, launcher.nh, rows_b.shape[0])
            or target_actions.device != device):
        raise ValueError(f"target_actions must be a contiguous int32 ({a}, {launcher.nh}, "
                         f"{rows_b.shape[0]}) tensor on {device}")
    launcher.check(weights, rows_b, grads, metrics)
    launcher.launch(weights, rows_b, grads, metrics, target_actions)
    actor, critic = lay.nets(grads)
    grads = {"actor": _net_grads(actor, o, k, h), "critic": _net_grads(critic, lay.j, 1, h)}
    return grads, (metrics[0], metrics[1], metrics[2])


maddpg_update_cuda.launches = 0
maddpg_update_cuda.launches_by = collections.Counter()


def maddpg_update_bf16_cuda(params, targets, rows_b, *, mw: int, gamma: float, ent_coef: float,
                            target_actions=None):
    """Launch kernel K9-bf16 (``csrc/mpe_maddpg_bf16.cu``: K9's four stages
    with every product on the tensor cores in bf16, float32 sums):
    ``maddpg_update_cuda(..., compute_dtype=torch.bfloat16)``. Counts
    launches in ``.launches`` and, by scenario name, in ``.launches_by``."""
    return maddpg_update_cuda(params, targets, rows_b, mw=mw, gamma=gamma, ent_coef=ent_coef,
                              target_actions=target_actions, compute_dtype=torch.bfloat16)


maddpg_update_bf16_cuda.launches = 0
maddpg_update_bf16_cuda.launches_by = collections.Counter()


def fused_maddpg_update(n_agents: int, obs_dim: int, act_dim: int, mw: int, hidden: int,
                        batch: int, gamma: float = 0.95, ent_coef: float = 0.01, device=None,
                        dtype=torch.float32, compute_dtype=torch.float32):
    """Build ``grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b) ->
    (grads, (critic_loss, actor_loss, q_mean))`` with ``grads_fn.from_rows(
    params, targets, rows_b)``: on CUDA kernel K9 (float32 params;
    ``compute_dtype`` float32, JAX's default, or None) or K9-bf16
    (``compute_dtype=torch.bfloat16``), on the CPU the plain version in
    ``dtype`` (bf16 products with float32 sums where ``compute_dtype`` is
    bfloat16; ``maddpg_rounding``); ``grads_fn.plain`` is the plain version
    (with its own ``from_rows``). ``act_dim - mw`` is the comm head's width
    (0 without one). The JAX builder's ``block_b`` and ``cand_group`` (its
    tiling) have no counterpart."""
    if act_dim < mw:
        raise ValueError(f"act_dim {act_dim} is narrower than the {mw} move logits")
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    maddpg_rounding(compute_dtype, dtype)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the MADDPG update kernels take float32 params; use dtype=torch.float32 "
                         "on CUDA (and compute_dtype=torch.bfloat16 for K9-bf16)")
    width = n_agents * (2 * obs_dim + act_dim + 1)
    hp = dict(mw=mw, gamma=gamma, ent_coef=ent_coef)

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
        return plain_maddpg_update(params, targets, rows_b, dtype=dtype,
                                   compute_dtype=compute_dtype, **hp)

    def from_rows(params, targets, rows_b):
        if device.type == "cuda":
            check(params, rows_b)
            return maddpg_update_cuda(params, targets, rows_b.to(torch.float32).contiguous(),
                                      compute_dtype=compute_dtype, **hp)
        return plain_rows(params, targets, rows_b)

    def grads_fn(params, targets, obs_b, act_b, rew_b, obs2_b):
        return from_rows(params, targets, to_rows(obs_b, act_b, rew_b, obs2_b))

    def plain(params, targets, obs_b, act_b, rew_b, obs2_b):
        return plain_rows(params, targets, to_rows(obs_b, act_b, rew_b, obs2_b))

    plain.from_rows = plain_rows
    grads_fn.from_rows = from_rows
    grads_fn.plain = plain
    return grads_fn

"""Fused PPO and MAPPO epoch gradients: kernels K6 and K7 and their plain
PyTorch versions (counterpart of ``mpe_tpu/ops/fused_update.py``), for the
nine kernel scenarios, comm heads included.

``fused_ppo_update`` builds ``update(params, obs, mv_oh, cm_oh, logp_old,
adv_n, ret, v_old) -> (grads, (pg, vloss, ent))`` for the shared-torso
actor-critic of ``learner.ppo.init_ac``; ``fused_mappo_update`` the same
for ``learner.ppo.init_mappo`` (decentralized actor, centralized critic on
the joint obs), whose ``adv_n``, ``ret`` and ``v_old`` are the team streams
``[T, N]``. The policy is a factored categorical: a softmax over the 5 move
logits and, where the scenario speaks, one over the ``dim_c`` comm logits
(``cm_oh`` the comm one-hots ``[T, A, C, N]``, None without a comm head),
whose log-prob and entropy count only for agents that are not silent. The
gradient is the hand-derived one of the JAX kernels, pinned to autodiff of
the same loss by the tests:

  d pg / d logits   = -(adv * ratio) * [r*adv <= clip(r)*adv] * (oh - p) / B
  d (-ent_coef H)   =  ent_coef * p * (ls + H) / B   (per factor, its own H)
  d vf vloss / d v  =  vf_coef * 2 (v - ret) * [(v-ret)^2 >= (vc-ret)^2] / B_v

the comm factor's rows multiplied by the agent's speak flag, with B = T * A
* N, and B_v = B for PPO and T * N for MAPPO's critic; the value indicator
also holds wherever the clip does not bind (see ``_value_clip_grad``).
``grads`` comes back in the params' layout, the metrics are means, and
``adv_n`` is already normalized. Tensors are env-minor as
``fused_policy_trajectory`` emits them.

On a CUDA device ``update`` launches ``ppo_update_kernel`` (K6: one pass;
K7: an actor pass and a critic pass; ``ppo_update_wide_kernel`` at hidden
128 and 256) and ``update_reduce_kernel`` (``csrc/mpe_update.cu``, float32,
compiled for the nine scenarios' actor heads and critic joint widths, one
library per hidden width of ``_build.HIDDEN_WIDTHS["mpe_update.cu"]``: 8,
16, 32, 64, 128, 256, the width taken from the params; another raises
``NotImplementedError`` before any launch); on the CPU it runs the plain
version in ``dtype`` (float32 or float64).

``compute_dtype=torch.bfloat16`` is the JAX builders' ``compute_dtype``
(their default on a TPU): every matrix product (the forward, the backward
through both layers and the weight gradients, JAX's ``_dot`` / ``_dot_nt``)
rounds both operands to bfloat16, round to nearest even, and sums their
exact products in float32; the tanh derivatives, the bias sums, the
softmaxes and the head stay float32 on float32 activations, and the grads
and metrics come back in float32 whatever ``dtype`` is. On a CUDA device it
launches ``ppo_update_bf16_kernel`` (K6-bf16, K7-bf16:
``csrc/mpe_update_bf16.cu``, the products on the tensor cores by
``mma.sync``; at hidden 128 and 256 ``update_round_bf16_kernel``, which
rounds the weights into a bf16 scratch after the partials, then
``ppo_update_bf16_wide_kernel``, which streams them, on a grid of all the
CTAs the card holds at once; one library per width of
``_build.HIDDEN_WIDTHS["mpe_update_bf16.cu"]``: 8, 16, 32, 64, 128, 256); on
the CPU the plain version rounds as above. On the card no width falls back
to the float32 kernels or to the plain version.
"""

from __future__ import annotations

import functools
import math

import torch

from mpe_tpu_torch._device import device_table, resolve_device
from mpe_tpu_torch.ops._build import DEFAULT_HIDDEN, check_hidden
# the update kernels' persistent grid: two CTAs per SM, the most that fit
# (csrc/mpe_update.cu; an instantiation that fits one runs the grid in two
# waves); the wide bf16 kernel asks the card instead (``_grid``)
CTAS_PER_SM = 2


def _packed(n_in: int, n_out: int, hidden: int = DEFAULT_HIDDEN) -> tuple:
    """The kernels' packed gradient of an n_in-H-H-n_out MLP (H = hidden):
    w1 [H, n_in], b1, w2 [H, H], b2, w3 [n_out, H], b3 [n_out], then 3 metric
    means."""
    h = hidden
    return ((h, n_in), (h,), (h, h), (h,), (n_out, h), (n_out,), (3,))



def _numel(layout) -> int:
    return sum(int(torch.Size(s).numel()) for s in layout)


def _unpack(buf, layout):
    """A packed buffer -> its pieces, shaped by ``layout``."""
    parts = torch.split(buf, [int(torch.Size(s).numel()) for s in layout])
    return [p.view(s) for p, s in zip(parts, layout)]


def _softmax_rows(z, dim: int = -2):
    """Softmax over ``dim``: (p, logp, entropy with ``dim`` kept as 1)."""
    m = z.amax(dim, keepdim=True)
    e = torch.exp(z - m)
    s = e.sum(dim, keepdim=True)
    ls = (z - m) - torch.log(s)
    p = e / s
    ent = -(p * ls).sum(dim, keepdim=True)
    return p, ls, ent


def _policy_logit_grad(z, mvoh, cmoh, lpo, adv, speak, *, clip, ent_coef, inv_b):
    """Clipped-surrogate + entropy gradient at the policy logits ``z``
    [..., 5 + C, N] of the factored move x comm categorical (``cmoh`` and
    ``speak``, the per-agent speak flags broadcast over [..., 1, N], None
    without a comm head) -> (g [..., 5 + C, N], ent, s1, s2 [..., 1, N]);
    s1, s2 are the surrogate terms of the metric sums."""
    mw = mvoh.shape[-2]
    p, ls, ent_m = _softmax_rows(z[..., :mw, :])
    lp = (ls * mvoh).sum(-2, keepdim=True)
    ent = ent_m
    if cmoh is not None:
        pc, lsc, ent_c = _softmax_rows(z[..., mw:, :])
        lp = lp + (lsc * cmoh).sum(-2, keepdim=True) * speak
        ent = ent_m + ent_c * speak
    ratio = torch.exp(lp - lpo)
    rc = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    s1 = ratio * adv
    s2 = rc * adv
    unclipped = (s1 <= s2).to(z.dtype)
    cpg = -(adv * ratio) * unclipped * inv_b
    g = cpg * (mvoh - p) + (ent_coef * inv_b) * p * (ls + ent_m)
    if cmoh is not None:
        gc = (cpg * (cmoh - pc) + (ent_coef * inv_b) * pc * (lsc + ent_c)) * speak
        g = torch.cat([g, gc], dim=-2)
    return g, ent, s1, s2


def speak_mask(speak, like):
    """Per-agent speak flags (``KernelScenario.speak``, or None) -> [A, 1, 1]
    of 1.0 and 0.0 in ``like``'s dtype and on its device, made once per
    (flags, dtype, device) and shared (never write to it), or None."""
    if speak is None:
        return None
    return device_table([[[float(s)]] for s in speak], like.dtype, like.device)


def speak_bits(speak) -> int:
    """Per-agent speak flags (or None) -> the kernels' bit mask: bit i set
    where agent i speaks."""
    return sum(1 << i for i, s in enumerate(speak or ()) if s)


@functools.cache
def actor_heads() -> frozenset:
    """The (obs width, comm logits) actor heads of the nine scenarios: the
    heads the update kernels are compiled for (``csrc/mpe_update.cu::
    by_actor_head``)."""
    from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario

    return frozenset((k.obs_w, k.n_comm) for k in map(kernel_scenario, _KERNEL_SCENARIOS))


@functools.cache
def critic_widths() -> frozenset:
    """The MAPPO critic's joint obs widths (agents x obs width) of the nine
    scenarios: the widths the critic pass is compiled for
    (``csrc/mpe_update.cu::by_joint_width``)."""
    from mpe_tpu_torch.ops.kernel_scenarios import _KERNEL_SCENARIOS, kernel_scenario

    return frozenset(k.spec.n_agents * k.obs_w for k in map(kernel_scenario, _KERNEL_SCENARIOS))


def _value_clip_grad(v, vold, ret, *, clip, vf_coef, inv):
    """Gradient of the clipped value loss at the value output -> (gv,
    per-element loss for the metric sum).

    Where the clip does not bind, ``vc = vold + (v - vold)`` equals ``v``
    only up to rounding (exactly when v and vold lie within a factor of 2),
    and the max's gradient runs through either branch as 2 (v - ret). The
    JAX kernel's indicator ``(v-ret)^2 >= (vc-ret)^2`` alone drops the
    gradient when rounding puts vc's branch above (ROADMAP C); the port
    keeps it, as ``jax.grad`` of the loss does."""
    vc = vold + torch.clamp(v - vold, -clip, clip)
    dv_live = (((v - ret).square() >= (vc - ret).square())
               | ((v - vold).abs() <= clip)).to(v.dtype)
    gv = (vf_coef * 2.0 * inv) * (v - ret) * dv_live
    return gv, torch.maximum((v - ret).square(), (vc - ret).square())


def _keep(x):
    return x


def _bf16(x):
    """A product's operand rounded to bfloat16 (round to nearest even), in
    its own dtype again: the product of two such values is exact in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def compute_rounding(compute_dtype, dtype=torch.float32):
    """``compute_dtype`` of the update (None or ``dtype``: the products in
    ``dtype``; ``torch.bfloat16``: the bf16 path) -> (the dtype the update
    computes and returns in, the rounding of a product's operands). The bf16
    path accumulates in float32 whatever ``dtype`` is, as JAX's
    ``_acc_dtype``."""
    if compute_dtype is None or compute_dtype == dtype:
        return dtype, _keep
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be None, {dtype} or torch.bfloat16, "
                         f"got {compute_dtype}")
    return torch.float32, _bf16


def _mlp_backprop(x, h1, h2, g3, w2, w3, rnd):
    """Backprop ``g3`` [..., KO, N] through the two tanh layers and sum the
    six weight/bias gradients over the batch -> (dw1 [H, OW], db1 [H],
    dw2, db2, dw3 [KO, H], db3 [KO]). ``rnd`` rounds each product's
    operands (``compute_rounding``); the tanh derivatives and the bias sums
    take the unrounded activations."""
    gh2 = torch.einsum("kg,...kn->...gn", rnd(w3), rnd(g3)) * (1.0 - h2.square())
    gh1 = torch.einsum("gh,...gn->...hn", rnd(w2), rnd(gh2)) * (1.0 - h1.square())

    def outer(g, a):                       # sum over batch and lanes of g a^T
        return torch.einsum("...in,...jn->ij", rnd(g), rnd(a))

    def total(g):
        return g.sum(-1).reshape(-1, g.shape[-2]).sum(0)

    return outer(gh1, x), total(gh1), outer(gh2, h1), total(gh2), outer(g3, h2), total(g3)


def _metric_sums(s1, s2, vl_terms, ent):
    """(pg, vloss, entropy) sums over the batch, shape [3]."""
    return torch.stack([(-torch.minimum(s1, s2)).sum(), vl_terms.sum(), ent.sum()])


def _update_weights(params, dtype, device=None):
    """init_ac params -> (w1 [H, OW], b1, w2 [H, H], b2, w3 [K+1, H] = pi
    rows then v, b3), in ``dtype``."""
    def cast(x):
        return x.detach().to(device=device, dtype=dtype)

    w1, b1 = cast(params["l1"]["w"]).T, cast(params["l1"]["b"])
    w2, b2 = cast(params["l2"]["w"]).T, cast(params["l2"]["b"])
    w3 = torch.cat([cast(params["pi"]["w"]).T, cast(params["v"]["w"]).T])
    b3 = torch.cat([cast(params["pi"]["b"]), cast(params["v"]["b"])])
    return w1, b1, w2, b2, w3, b3


def _mlp_weights(params, names, dtype, device=None):
    """Three dense layers ``names`` of params -> (w1, b1, w2, b2, w3, b3),
    each w as [out, in], in ``dtype``."""
    out = []
    for q in names:
        out += [params[q]["w"].detach().to(device=device, dtype=dtype).T,
                params[q]["b"].detach().to(device=device, dtype=dtype)]
    return tuple(out)


def _layer_grads(names, dw1, db1, dw2, db2, dw3, db3):
    """Kernel-layout gradients of three layers -> {name: {w [in, out], b}}."""
    return {n: {"w": dw.T, "b": db} for n, dw, db in zip(names, (dw1, dw2, dw3), (db1, db2, db3))}


def _grads_tree(dw1, db1, dw2, db2, dw3, db3):
    """Kernel-layout gradients -> the init_ac layout (w as [in, out])."""
    return {"l1": {"w": dw1.T, "b": db1}, "l2": {"w": dw2.T, "b": db2},
            "pi": {"w": dw3[:-1].T, "b": db3[:-1]}, "v": {"w": dw3[-1:].T, "b": db3[-1:]}}


def plain_ppo_update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak=None,
                     clip: float, vf_coef: float, ent_coef: float, dtype=torch.float32,
                     compute_dtype=None):
    """The JAX ``_update_kernel`` over the whole batch at once, in ``dtype``
    (float32 with ``compute_dtype=torch.bfloat16``, whose products round
    their operands to bf16: ``compute_rounding``) -> (grads in init_ac
    layout, (pg, vloss, ent) means). ``speak``: each agent's speak flag where
    the scenario has a comm head (``cm_oh``)."""
    dtype, rnd = compute_rounding(compute_dtype, dtype)
    w1, b1, w2, b2, w3, b3 = _update_weights(params, dtype, obs.device)
    x = obs.to(dtype)
    t, a, _, n = x.shape
    inv_b = 1.0 / float(t * a * n)
    h1 = torch.tanh(torch.einsum("ho,...on->...hn", rnd(w1), rnd(x)) + b1[:, None])
    h2 = torch.tanh(torch.einsum("gh,...hn->...gn", rnd(w2), rnd(h1)) + b2[:, None])
    z = torch.einsum("kg,...gn->...kn", rnd(w3), rnd(h2)) + b3[:, None]    # [T, A, K+1, N]
    gp, ent, s1, s2 = _policy_logit_grad(
        z[..., :-1, :], mv_oh.to(dtype), None if cm_oh is None else cm_oh.to(dtype),
        logp_old.to(dtype)[..., None, :], adv_n.to(dtype)[..., None, :], speak_mask(speak, x),
        clip=clip, ent_coef=ent_coef, inv_b=inv_b)
    gv, vl_terms = _value_clip_grad(z[..., -1:, :], v_old.to(dtype)[..., None, :],
                                    ret.to(dtype)[..., None, :], clip=clip, vf_coef=vf_coef,
                                    inv=inv_b)
    g3 = torch.cat([gp, gv], dim=-2)
    grads = _grads_tree(*_mlp_backprop(x, h1, h2, g3, w2, w3, rnd))
    pg, vl, en = _metric_sums(s1, s2, vl_terms, ent) * inv_b
    return grads, (pg, vl, en)


def plain_mappo_update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak=None,
                       clip: float, vf_coef: float, ent_coef: float, dtype=torch.float32,
                       compute_dtype=None):
    """The JAX ``_mappo_update_kernel`` over the whole batch at once, in
    ``dtype`` (or bf16 products, as ``plain_ppo_update``): the actor on every
    (t, agent, env) sample with the team advantage ``adv_n`` [T, N] broadcast
    to the agents, the critic on the joint obs [T, A*OW, N] of every (t, env)
    -> (grads in init_mappo layout, (pg, vloss, ent) means; vloss over [T,
    N])."""
    dtype, rnd = compute_rounding(compute_dtype, dtype)
    x = obs.to(dtype)
    t, a, ow, n = x.shape
    inv_b, inv_bv = 1.0 / float(t * a * n), 1.0 / float(t * n)

    def forward(w1, b1, w2, b2, w3, b3, xin):
        h1 = torch.tanh(torch.einsum("ho,...on->...hn", rnd(w1), rnd(xin)) + b1[:, None])
        h2 = torch.tanh(torch.einsum("gh,...hn->...gn", rnd(w2), rnd(h1)) + b2[:, None])
        return h1, h2, torch.einsum("kg,...gn->...kn", rnd(w3), rnd(h2)) + b3[:, None]

    aw = _mlp_weights(params, ("a1", "a2", "pi"), dtype, obs.device)
    h1, h2, z = forward(*aw, x)                                   # z [T, A, 5 + C, N]
    gp, ent, s1, s2 = _policy_logit_grad(
        z, mv_oh.to(dtype), None if cm_oh is None else cm_oh.to(dtype),
        logp_old.to(dtype)[..., None, :], adv_n.to(dtype)[:, None, None, :],
        speak_mask(speak, x), clip=clip, ent_coef=ent_coef, inv_b=inv_b)
    grads = _layer_grads(("a1", "a2", "pi"), *_mlp_backprop(x, h1, h2, gp, aw[2], aw[4], rnd))

    xj = x.reshape(t, a * ow, n)                                  # joint obs
    cw = _mlp_weights(params, ("c1", "c2", "v"), dtype, obs.device)
    g1, g2, v = forward(*cw, xj)                                  # v [T, 1, N]
    gv, vl_terms = _value_clip_grad(v, v_old.to(dtype)[:, None, :], ret.to(dtype)[:, None, :],
                                    clip=clip, vf_coef=vf_coef, inv=inv_bv)
    grads.update(_layer_grads(("c1", "c2", "v"),
                              *_mlp_backprop(xj, g1, g2, gv, cw[2], cw[4], rnd)))
    pg, vl, en = _metric_sums(s1, s2, vl_terms, ent)
    return grads, (pg * inv_b, vl * inv_bv, en * inv_b)


def clip_binding_inputs(logp_old, v_old, *, clip: float, generator, scale: float = 0.3,
                        margin: float = 1e-3):
    """``logp_old`` and ``v_old`` of an epoch-0 batch (those of the current
    params) moved by ``scale`` N(0, 1) noise from ``generator``, so that both
    clips of the loss bind for about half of the samples: the batch on which
    the update kernel is held against its plain version. No sample is left
    within ``margin`` of a clip boundary (in log-ratio and in value change),
    where a rounding difference between two forwards would flip the
    indicator: one sample's term there is the gradient's own discontinuity,
    not an error of either. -> (logp_old, v_old, (share of ratios outside
    [1 - clip, 1 + clip], share of value changes outside [-clip, clip]))."""
    def noise(like, bounds):
        x = scale * torch.randn(like.shape, generator=generator, device=like.device,
                                dtype=like.dtype)
        near = torch.zeros_like(x, dtype=torch.bool)
        for b in bounds:
            near |= (x - b).abs() < margin
        return torch.where(near, x + 2 * margin, x)

    lo, hi = math.log(1.0 - clip), math.log(1.0 + clip)
    n_lp = noise(logp_old, (-hi, -lo))            # log-ratio -n_lp
    n_v = noise(v_old, (-clip, clip))             # value change -n_v
    shares = (float(((n_lp < -hi) | (n_lp > -lo)).double().mean()),
              float((n_v.abs() > clip).double().mean()))
    return (logp_old + n_lp).contiguous(), (v_old + n_v).contiguous(), shares


def _check_batch(device, **batch):
    """Each ``name=(tensor, shape)``: a contiguous float32 tensor on
    ``device`` of that shape, or ValueError."""
    for name, (x, shape) in batch.items():
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")


def _kernel_inputs(obs, mv_oh, cm_oh, speak):
    """Shape checks shared by both wrappers -> (T, A, OW, N, comm width,
    speak bit mask). Raises before a launch on an actor head the kernels are
    not compiled for."""
    device = obs.device
    if device.type != "cuda":
        raise ValueError(f"the update kernels need CUDA tensors, got {device}")
    t, a, ow, n = obs.shape
    kc = 0 if cm_oh is None else cm_oh.shape[2]
    if (speak is None) != (cm_oh is None) or (speak is not None and len(speak) != a):
        raise ValueError(f"speak must give each of the {a} agents' flags exactly where cm_oh is "
                         f"given; got {speak}")
    _check_batch(device, obs=(obs, (t, a, ow, n)), mv_oh=(mv_oh, (t, a, 5, n)))
    if cm_oh is not None:
        _check_batch(device, cm_oh=(cm_oh, (t, a, kc, n)))
    if (ow, kc) not in actor_heads():
        raise NotImplementedError(f"the update kernels are compiled for the actor heads (obs "
                                  f"width, comm logits) {sorted(actor_heads())}; got {(ow, kc)}")
    return t, a, ow, n, kc, speak_bits(speak)


def _hidden_of(params, l1: str, source: str) -> int:
    """The hidden width of the params' first layer (``l1.w`` [in, H]), if the
    update kernels of ``source`` are compiled for it (else
    ``NotImplementedError`` naming that source's widths)."""
    return check_hidden(params[l1]["w"].shape[-1], "the update kernels", source)


def _grid(lib, passes, device) -> int:
    """The CTAs of a launch's persistent grid over its ``passes`` ((in, kc,
    pass) of ``mpe_update_grid``): where the library sets its own grid (the
    bf16 kernel at hidden 128 and 256: all the CTAs the card holds at once),
    the fewest over the passes, else ``CTAS_PER_SM`` an SM."""
    own = [lib.mpe_update_grid(*p) for p in passes] if hasattr(lib, "mpe_update_grid") else [0]
    if min(own) < 0:
        raise RuntimeError(f"the update kernels' grid query failed for the passes {passes}")
    if max(own) > 0:
        return min(own)
    return CTAS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def _partials(lib, n_parts: int, passes, sizes, device):
    """The launch's scratch: each pass's ``n_parts`` packed partials (its
    packed length of ``sizes``) and, where the library keeps them there (the
    bf16 kernel at hidden 128 and 256, ``mpe_update_scratch``), its bf16
    weights after them, from a multiple of 4 floats."""
    floats = []
    for p, ng in zip(passes, sizes):
        extra = lib.mpe_update_scratch(*p) if hasattr(lib, "mpe_update_scratch") else 0
        if extra < 0:
            raise RuntimeError(f"the update kernels' scratch query failed for the pass {p}")
        floats.append(-(-n_parts * ng // 4) * 4 + extra)
    return torch.empty(max(floats), dtype=torch.float32, device=device)


def _check_weights(weights, want, what: str):
    shapes = [tuple(x.shape) for x in weights]
    if shapes != want:
        raise ValueError(f"the {what} weight shapes {shapes} do not match the batch: {want}")


def _ppo_launch(source, params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak,
                clip: float, vf_coef: float, ent_coef: float):
    """One K6 launch of the library of ``source`` (``mpe_update.cu`` or
    ``mpe_update_bf16.cu``: the same C entries and packed layout)."""
    from mpe_tpu_torch.ops import _build

    hidden = _hidden_of(params, "l1", source)
    t, a, ow, n, kc, mask = _kernel_inputs(obs, mv_oh, cm_oh, speak)
    device = obs.device
    _check_batch(device, logp_old=(logp_old, (t, a, n)), adv_n=(adv_n, (t, a, n)),
                 ret=(ret, (t, a, n)), v_old=(v_old, (t, a, n)))
    weights = _update_weights(params, torch.float32, device)
    layout = _packed(ow, 5 + kc + 1, hidden)
    _check_weights(weights, list(layout[:-1]), "actor-critic")
    lib = _build.library(source, hidden)
    n_packed = _numel(layout)
    if lib.mpe_update_packed_size(ow, 5 + kc + 1) != n_packed:
        raise RuntimeError(f"csrc/{source} and ops/fused_update.py disagree on the layout")
    wbuf = torch.cat([w.reshape(-1) for w in weights]).contiguous()
    passes = [(ow, kc, 0)]
    n_parts = _grid(lib, passes, device)
    partials = _partials(lib, n_parts, passes, [n_packed], device)
    out = torch.empty(n_packed, dtype=torch.float32, device=device)
    inv_b = 1.0 / float(t * a * n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mpe_ppo_update(
            ow, kc, wbuf.data_ptr(), obs.data_ptr(), mv_oh.data_ptr(),
            None if cm_oh is None else cm_oh.data_ptr(), logp_old.data_ptr(), adv_n.data_ptr(),
            ret.data_ptr(), v_old.data_ptr(), partials.data_ptr(), out.data_ptr(), t * a, n, a,
            mask, n_parts, 1.0 - clip, 1.0 + clip, clip, vf_coef * 2.0 * inv_b, ent_coef * inv_b,
            inv_b, stream)
    if rc != 0:
        raise RuntimeError(f"the K6 launch of csrc/{source} failed: {_build.error_string(rc)}")
    dw1, db1, dw2, db2, dw3, db3, ms = _unpack(out, layout)
    return _grads_tree(dw1, db1, dw2, db2, dw3, db3), (ms[0], ms[1], ms[2])


def ppo_update_cuda(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak=None,
                    clip: float, vf_coef: float, ent_coef: float):
    """Launch kernel K6 (``ppo_update_kernel`` over a persistent grid of two
    256-thread CTAs per SM, then ``update_reduce_kernel``) on the inputs' CUDA device:
    the outputs of ``plain_ppo_update`` in float32. Counts launches in
    ``.launches``."""
    out = _ppo_launch("mpe_update.cu", params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old,
                      speak=speak, clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    ppo_update_cuda.launches += 1
    return out


ppo_update_cuda.launches = 0


def ppo_update_bf16_cuda(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *,
                         speak=None, clip: float, vf_coef: float, ent_coef: float):
    """Launch kernel K6-bf16 (``ppo_update_bf16_kernel``: K6's grid and
    tiles, its products on the tensor cores in bf16 with float32 sums, then
    ``update_reduce_kernel``; at hidden 128 and 256 the weights' rounding,
    then ``ppo_update_bf16_wide_kernel``) on the inputs' CUDA device: the
    outputs of ``plain_ppo_update(..., compute_dtype=torch.bfloat16)`` in
    float32. Another width raises before any launch. Counts launches in
    ``.launches``."""
    out = _ppo_launch("mpe_update_bf16.cu", params, obs, mv_oh, cm_oh, logp_old, adv_n, ret,
                      v_old, speak=speak, clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    ppo_update_bf16_cuda.launches += 1
    return out


ppo_update_bf16_cuda.launches = 0


def _mappo_launch(source, params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak,
                  clip: float, vf_coef: float, ent_coef: float):
    """One K7 launch of the library of ``source`` (as ``_ppo_launch``)."""
    from mpe_tpu_torch.ops import _build

    hidden = _hidden_of(params, "a1", source)
    t, a, ow, n, kc, mask = _kernel_inputs(obs, mv_oh, cm_oh, speak)
    if a * ow not in critic_widths():
        raise NotImplementedError(f"the critic pass is compiled for the joint widths "
                                  f"{sorted(critic_widths())}; got {a} x {ow}")
    device = obs.device
    _check_batch(device, logp_old=(logp_old, (t, a, n)), adv_n=(adv_n, (t, n)),
                 ret=(ret, (t, n)), v_old=(v_old, (t, n)))
    aw = _mlp_weights(params, ("a1", "a2", "pi"), torch.float32, device)
    cw = _mlp_weights(params, ("c1", "c2", "v"), torch.float32, device)
    actor, critic = _packed(ow, 5 + kc, hidden), _packed(a * ow, 1, hidden)
    _check_weights(aw, list(actor[:-1]), "actor")
    _check_weights(cw, list(critic[:-1]), "critic")
    lib = _build.library(source, hidden)
    n_act, n_crit = _numel(actor), _numel(critic)
    if (lib.mpe_update_packed_size(ow, 5 + kc), lib.mpe_update_packed_size(a * ow, 1)) != (
            n_act, n_crit):
        raise RuntimeError(f"csrc/{source} and ops/fused_update.py disagree on the layout")
    abuf = torch.cat([w.reshape(-1) for w in aw]).contiguous()
    cbuf = torch.cat([w.reshape(-1) for w in cw]).contiguous()
    passes = [(ow, kc, 1), (a * ow, 0, 2)]
    n_parts = _grid(lib, passes, device)
    partials = _partials(lib, n_parts, passes, [n_act, n_crit], device)
    out = torch.empty(n_act + n_crit, dtype=torch.float32, device=device)
    inv_b, inv_bv = 1.0 / float(t * a * n), 1.0 / float(t * n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mpe_mappo_update(
            ow, kc, abuf.data_ptr(), cbuf.data_ptr(), obs.data_ptr(), mv_oh.data_ptr(),
            None if cm_oh is None else cm_oh.data_ptr(), logp_old.data_ptr(), adv_n.data_ptr(),
            ret.data_ptr(), v_old.data_ptr(), partials.data_ptr(), out.data_ptr(), t, a, n, mask,
            n_parts, 1.0 - clip, 1.0 + clip, clip, vf_coef * 2.0 * inv_bv, ent_coef * inv_b,
            inv_b, inv_bv, stream)
    if rc != 0:
        raise RuntimeError(f"the K7 launch of csrc/{source} failed: {_build.error_string(rc)}")
    *ga, ms_a = _unpack(out[:n_act], actor)
    *gc, ms_c = _unpack(out[n_act:], critic)
    grads = _layer_grads(("a1", "a2", "pi"), *ga)
    grads.update(_layer_grads(("c1", "c2", "v"), *gc))
    return grads, (ms_a[0], ms_c[1], ms_a[2])


def mappo_update_cuda(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *, speak=None,
                      clip: float, vf_coef: float, ent_coef: float):
    """Launch kernel K7 (``ppo_update_kernel``'s actor pass over the
    (t, agent, env) samples and critic pass over the (t, env) samples on the
    joint obs, each a persistent grid of two CTAs per SM followed by
    ``update_reduce_kernel``) on the inputs' CUDA device: the outputs of
    ``plain_mappo_update`` in float32. Counts launches in ``.launches``."""
    out = _mappo_launch("mpe_update.cu", params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old,
                        speak=speak, clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    mappo_update_cuda.launches += 1
    return out


mappo_update_cuda.launches = 0


def mappo_update_bf16_cuda(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, *,
                           speak=None, clip: float, vf_coef: float, ent_coef: float):
    """Launch kernel K7-bf16 (``ppo_update_bf16_kernel``'s actor and critic
    passes, as K7's, on the tensor cores; at hidden 128 and 256
    ``ppo_update_bf16_wide_kernel``'s, each after the weights' rounding) on
    the inputs' CUDA device: the outputs of ``plain_mappo_update(...,
    compute_dtype=torch.bfloat16)`` in float32. Counts launches in
    ``.launches``."""
    out = _mappo_launch("mpe_update_bf16.cu", params, obs, mv_oh, cm_oh, logp_old, adv_n, ret,
                        v_old, speak=speak, clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    mappo_update_bf16_cuda.launches += 1
    return out


mappo_update_bf16_cuda.launches = 0


def _update_builder(kscn, n_envs, n_steps, hidden, hp, device, dtype, compute_dtype, l1,
                    plain_fn, cuda_fns):
    """The shared builder of ``fused_ppo_update`` and ``fused_mappo_update``;
    ``cuda_fns``: the float32 and the bf16 kernel's wrapper."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, kernel_scenario

    kscn = kscn if isinstance(kscn, KernelScenario) else kernel_scenario(kscn)
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    compute_rounding(compute_dtype, dtype)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the update kernels take float32 params; use dtype=torch.float32 on "
                         "CUDA (and compute_dtype=torch.bfloat16 for the bf16 kernels)")
    cuda_fn = cuda_fns[compute_dtype == torch.bfloat16]
    spec = kscn.spec
    a, ow, dim_c = spec.n_agents, kscn.obs_w, kscn.n_comm
    hp = dict(hp, speak=kscn.speak)

    def check(params, obs, cm_oh):
        if params[l1]["w"].shape != (ow, hidden):
            raise ValueError(f"{l1}.w has shape {tuple(params[l1]['w'].shape)}, expected "
                             f"{(ow, hidden)}")
        if tuple(obs.shape) != (n_steps, a, ow, n_envs):
            raise ValueError(f"obs has shape {tuple(obs.shape)}, expected "
                             f"{(n_steps, a, ow, n_envs)}")
        if not dim_c and cm_oh is not None:
            raise ValueError(f"cm_oh must be None: {spec.name!r} has no comm head")
        if dim_c and (cm_oh is None or tuple(cm_oh.shape) != (n_steps, a, dim_c, n_envs)):
            raise ValueError(f"{spec.name!r} has a comm head: cm_oh must have shape "
                             f"{(n_steps, a, dim_c, n_envs)}, got "
                             f"{None if cm_oh is None else tuple(cm_oh.shape)}")

    def plain(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old):
        check(params, obs, cm_oh)
        return plain_fn(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, dtype=dtype,
                        compute_dtype=compute_dtype, **hp)

    def update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old):
        if device.type == "cuda":
            check(params, obs, cm_oh)
            return cuda_fn(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old, **hp)
        return plain(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old)

    update.plain = plain
    return update


def fused_ppo_update(kscn, n_envs: int, n_steps: int, hidden: int, clip: float = 0.2,
                     vf_coef: float = 0.5, ent_coef: float = 0.01, device=None,
                     dtype=torch.float32, compute_dtype=None):
    """Build ``update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old)
    -> (grads, (pg, vloss, ent))``: on CUDA kernel K6 (float32 params;
    ``compute_dtype`` None or float32) or K6-bf16 (``compute_dtype=
    torch.bfloat16``), each at hidden 8, 16, 32, 64, 128 or 256, on the CPU
    the plain version in ``dtype`` (bf16
    products with float32 sums where ``compute_dtype`` is bfloat16);
    ``update.plain`` is the plain version. ``cm_oh`` is the comm one-hots
    where the scenario speaks, else None. The JAX builder's ``block_envs``
    and ``t_chunk`` (its tiling) have no counterpart: the CUDA kernel tiles
    the batch itself."""
    hp = dict(clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    return _update_builder(kscn, n_envs, n_steps, hidden, hp, device, dtype, compute_dtype, "l1",
                           plain_ppo_update, (ppo_update_cuda, ppo_update_bf16_cuda))


def fused_mappo_update(kscn, n_envs: int, n_steps: int, hidden: int, clip: float = 0.2,
                       vf_coef: float = 0.5, ent_coef: float = 0.01, device=None,
                       dtype=torch.float32, compute_dtype=None):
    """Build ``update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old)
    -> (grads, (pg, vloss, ent))`` for ``learner.ppo.init_mappo`` params, with
    ``adv_n``, ``ret`` and ``v_old`` the team streams [T, N]: on CUDA kernel
    K7 or, with ``compute_dtype=torch.bfloat16``, K7-bf16, on the CPU the
    plain version, as ``fused_ppo_update``; ``update.plain`` is the plain
    version."""
    hp = dict(clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    return _update_builder(kscn, n_envs, n_steps, hidden, hp, device, dtype, compute_dtype, "a1",
                           plain_mappo_update, (mappo_update_cuda, mappo_update_bf16_cuda))

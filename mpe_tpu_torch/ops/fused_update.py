"""Fused PPO epoch gradient: kernel K6 and its plain PyTorch version
(counterpart of ``mpe_tpu/ops/fused_update.py``).

``fused_ppo_update`` builds ``update(params, obs, mv_oh, cm_oh, logp_old,
adv_n, ret, v_old) -> (grads, (pg, vloss, ent))`` for the shared-torso
actor-critic of ``learner.ppo.init_ac``. The gradient is the hand-derived
one of the JAX kernel, pinned to autodiff of the same loss by the tests:

  d pg / d logits   = -(adv * ratio) * [r*adv <= clip(r)*adv] * (oh - p) / B
  d (-ent_coef H)   =  ent_coef * p * (ls + H) / B
  d vf vloss / d v  =  vf_coef * 2 (v - ret) * [(v-ret)^2 >= (vc-ret)^2] / B

with B = T * A * N; the value indicator also holds wherever the clip does
not bind (see ``_value_clip_grad``). ``grads`` comes back in the ``init_ac`` layout, the
metrics are means over the batch, and ``adv_n`` is already normalized.
Tensors are env-minor as ``fused_policy_trajectory`` emits them.

On a CUDA device ``update`` launches ``ppo_update_kernel`` and
``ppo_update_reduce_kernel`` (``csrc/mpe_update.cu``, float32, hidden 64);
on the CPU it runs ``plain_ppo_update`` in ``dtype`` (float32 or float64).
Only move-only scenarios are ported: the comm factor of the JAX kernel
waits for the comm scenarios (ROADMAP B3), and ``cm_oh`` must be None.
"""

from __future__ import annotations

import math

import torch

from mpe_tpu_torch._device import resolve_device

HIDDEN, OBS_W, MOVES = 64, 18, 5      # the widths the CUDA kernel is built for
# the kernel's packed gradient: w1 [H,OW], b1, w2 [H,H], b2, w3 [6,H], b3 [6], 3 metric means
_PACKED = ((HIDDEN, OBS_W), (HIDDEN,), (HIDDEN, HIDDEN), (HIDDEN,), (MOVES + 1, HIDDEN),
           (MOVES + 1,), (3,))


def _softmax_rows(z, dim: int = -2):
    """Softmax over ``dim``: (p, logp, entropy with ``dim`` kept as 1)."""
    m = z.amax(dim, keepdim=True)
    e = torch.exp(z - m)
    s = e.sum(dim, keepdim=True)
    ls = (z - m) - torch.log(s)
    p = e / s
    ent = -(p * ls).sum(dim, keepdim=True)
    return p, ls, ent


def _policy_logit_grad(z, mvoh, lpo, adv, *, clip, ent_coef, inv_b):
    """Clipped-surrogate + entropy gradient at the move logits ``z``
    [..., K, N] -> (g [..., K, N], ent, s1, s2 [..., 1, N]); s1, s2 are the
    surrogate terms of the metric sums."""
    p, ls, ent = _softmax_rows(z)
    lp = (ls * mvoh).sum(-2, keepdim=True)
    ratio = torch.exp(lp - lpo)
    rc = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    s1 = ratio * adv
    s2 = rc * adv
    unclipped = (s1 <= s2).to(z.dtype)
    cpg = -(adv * ratio) * unclipped * inv_b
    g = cpg * (mvoh - p) + (ent_coef * inv_b) * p * (ls + ent)
    return g, ent, s1, s2


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


def _mlp_backprop(x, h1, h2, g3, w2, w3):
    """Backprop ``g3`` [..., KO, N] through the two tanh layers and sum the
    six weight/bias gradients over the batch -> (dw1 [H, OW], db1 [H],
    dw2, db2, dw3 [KO, H], db3 [KO])."""
    gh2 = torch.einsum("kg,...kn->...gn", w3, g3) * (1.0 - h2.square())
    gh1 = torch.einsum("gh,...gn->...hn", w2, gh2) * (1.0 - h1.square())

    def outer(g, a):                       # sum over batch and lanes of g a^T
        return torch.einsum("...in,...jn->ij", g, a)

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


def _grads_tree(dw1, db1, dw2, db2, dw3, db3):
    """Kernel-layout gradients -> the init_ac layout (w as [in, out])."""
    return {"l1": {"w": dw1.T, "b": db1}, "l2": {"w": dw2.T, "b": db2},
            "pi": {"w": dw3[:-1].T, "b": db3[:-1]}, "v": {"w": dw3[-1:].T, "b": db3[-1:]}}


def plain_ppo_update(params, obs, mv_oh, logp_old, adv_n, ret, v_old, *, clip: float,
                     vf_coef: float, ent_coef: float, dtype=torch.float32):
    """The JAX ``_update_kernel`` over the whole batch at once, in
    ``dtype`` -> (grads in init_ac layout, (pg, vloss, ent) means)."""
    w1, b1, w2, b2, w3, b3 = _update_weights(params, dtype, obs.device)
    x = obs.to(dtype)
    t, a, _, n = x.shape
    inv_b = 1.0 / float(t * a * n)
    h1 = torch.tanh(torch.einsum("ho,...on->...hn", w1, x) + b1[:, None])
    h2 = torch.tanh(torch.einsum("gh,...hn->...gn", w2, h1) + b2[:, None])
    z = torch.einsum("kg,...gn->...kn", w3, h2) + b3[:, None]          # [T, A, K+1, N]
    gp, ent, s1, s2 = _policy_logit_grad(
        z[..., :-1, :], mv_oh.to(dtype), logp_old.to(dtype)[..., None, :],
        adv_n.to(dtype)[..., None, :], clip=clip, ent_coef=ent_coef, inv_b=inv_b)
    gv, vl_terms = _value_clip_grad(z[..., -1:, :], v_old.to(dtype)[..., None, :],
                                    ret.to(dtype)[..., None, :], clip=clip, vf_coef=vf_coef,
                                    inv=inv_b)
    g3 = torch.cat([gp, gv], dim=-2)
    grads = _grads_tree(*_mlp_backprop(x, h1, h2, g3, w2, w3))
    pg, vl, en = _metric_sums(s1, s2, vl_terms, ent) * inv_b
    return grads, (pg, vl, en)


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


def ppo_update_cuda(params, obs, mv_oh, logp_old, adv_n, ret, v_old, *, clip: float,
                    vf_coef: float, ent_coef: float):
    """Launch kernel K6 (``ppo_update_kernel`` over a persistent grid of one
    CTA per SM, then ``ppo_update_reduce_kernel``) on the inputs' CUDA
    device: the outputs of ``plain_ppo_update`` in float32. Counts launches
    in ``.launches``."""
    from mpe_tpu_torch.ops import _build

    device = obs.device
    if device.type != "cuda":
        raise ValueError(f"ppo_update_cuda needs CUDA tensors, got {device}")
    t, a, ow, n = obs.shape
    batch = {"obs": (obs, (t, a, ow, n)), "mv_oh": (mv_oh, (t, a, MOVES, n)),
             "logp_old": (logp_old, (t, a, n)), "adv_n": (adv_n, (t, a, n)),
             "ret": (ret, (t, a, n)), "v_old": (v_old, (t, a, n))}
    for name, (x, shape) in batch.items():
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    weights = _update_weights(params, torch.float32, device)
    if tuple(weights[0].shape) != (HIDDEN, OBS_W) or tuple(weights[4].shape) != (MOVES + 1, HIDDEN):
        raise NotImplementedError(f"the update kernel is built for an {OBS_W}-{HIDDEN}-{HIDDEN}-"
                                  f"({MOVES}+1) actor-critic; got w1 {tuple(weights[0].shape)}, "
                                  f"w3 {tuple(weights[4].shape)}")
    lib = _build.library("mpe_update.cu")
    n_packed = sum(int(torch.Size(s).numel()) for s in _PACKED)
    if lib.mpe_ppo_update_packed_size() != n_packed:
        raise RuntimeError("csrc/mpe_update.cu and ops/fused_update.py disagree on the layout")
    wbuf = torch.cat([w.reshape(-1) for w in weights]).contiguous()
    n_parts = torch.cuda.get_device_properties(device).multi_processor_count
    partials = torch.empty((n_parts, n_packed), dtype=torch.float32, device=device)
    out = torch.empty(n_packed, dtype=torch.float32, device=device)
    inv_b = 1.0 / float(t * a * n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mpe_ppo_update_h64(
            wbuf.data_ptr(), obs.data_ptr(), mv_oh.data_ptr(), logp_old.data_ptr(),
            adv_n.data_ptr(), ret.data_ptr(), v_old.data_ptr(), partials.data_ptr(),
            out.data_ptr(), t * a, n, n_parts, 1.0 - clip, 1.0 + clip, clip,
            vf_coef * 2.0 * inv_b, ent_coef * inv_b, inv_b, stream)
    if rc != 0:
        raise RuntimeError(f"ppo_update_kernel launch failed: {_build.error_string(rc)}")
    ppo_update_cuda.launches += 1
    parts = torch.split(out, [int(torch.Size(s).numel()) for s in _PACKED])
    dw1, db1, dw2, db2, dw3, db3, ms = (p.view(s) for p, s in zip(parts, _PACKED))
    return _grads_tree(dw1, db1, dw2, db2, dw3, db3), (ms[0], ms[1], ms[2])


ppo_update_cuda.launches = 0


def fused_ppo_update(kscn, n_envs: int, n_steps: int, hidden: int, clip: float = 0.2,
                     vf_coef: float = 0.5, ent_coef: float = 0.01, device=None,
                     dtype=torch.float32):
    """Build ``update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old)
    -> (grads, (pg, vloss, ent))``: kernel K6 on CUDA (float32 only), the
    plain version in ``dtype`` on the CPU; ``update.plain`` is the plain
    version. The JAX builder's ``block_envs`` and ``t_chunk`` (its tiling)
    have no counterpart: the CUDA kernel tiles the batch itself."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelScenario, kernel_scenario

    kscn = kscn if isinstance(kscn, KernelScenario) else kernel_scenario(kscn)
    if kscn.uses_comm:
        raise NotImplementedError(f"{kscn.spec.name!r} has a comm head; the update kernel is "
                                  "ported for move-only scenarios (ROADMAP B3)")
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the update kernel computes in float32; use dtype=torch.float32 on CUDA")
    hp = dict(clip=clip, vf_coef=vf_coef, ent_coef=ent_coef)
    a, ow = kscn.spec.n_agents, kscn.obs_w

    def check(params, obs, cm_oh):
        if params["l1"]["w"].shape != (ow, hidden):
            raise ValueError(f"l1.w has shape {tuple(params['l1']['w'].shape)}, expected "
                             f"{(ow, hidden)}")
        if cm_oh is not None:
            raise ValueError("cm_oh must be None: the scenario has no comm head")
        if tuple(obs.shape) != (n_steps, a, ow, n_envs):
            raise ValueError(f"obs has shape {tuple(obs.shape)}, expected "
                             f"{(n_steps, a, ow, n_envs)}")

    def plain(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old):
        check(params, obs, cm_oh)
        return plain_ppo_update(params, obs, mv_oh, logp_old, adv_n, ret, v_old, dtype=dtype,
                                **hp)

    def update(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old):
        if device.type == "cuda":
            check(params, obs, cm_oh)
            return ppo_update_cuda(params, obs, mv_oh, logp_old, adv_n, ret, v_old, **hp)
        return plain(params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, v_old)

    update.plain = plain
    return update

"""Env-minor batched step math in plain PyTorch (counterpart of
``mpe_tpu/ops/batched.py``).

Same semantics as ``core.physics.step_world`` plus the simple_spread
callbacks (reference core.py:117-196, simple_spread.py:72-100), on blocks
with the env axis last (``pos [E, P, N]``).
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.physics import logaddexp0
from mpe_tpu_torch.core.state import ScenarioSpec


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def batched_physics_step(spec: ScenarioSpec, pos, vel, u):
    """One collision + integration step: pos/vel ``[E, P, N]``, u
    ``[A, P, N]`` decoded forces -> (pos, vel). Damping before force,
    speed clamp, position after velocity (core.py:117-169)."""
    dt = spec.dt
    a, e = spec.n_agents, spec.n_entities
    dev = pos.device

    force = torch.cat([u * _t(spec.movable[:a], pos)[:, None, None],
                       torch.zeros((e - a,) + tuple(u.shape[1:]), dtype=pos.dtype, device=dev)])

    delta = pos[:, None] - pos[None, :]                          # [E, E, P, N]
    dist2 = delta.square().sum(2)                                # [E, E, N]
    pair = torch.tensor(spec.collide[:, None] & spec.collide[None, :] & ~np.eye(e, dtype=bool),
                        device=dev)
    one = torch.ones((), dtype=pos.dtype, device=dev)
    dist = torch.where(dist2 > 0, dist2, one).sqrt()
    dmin = _t(spec.size[:, None] + spec.size[None, :], pos)
    k = _t(spec.contact_margin, pos)
    x = -(dist - dmin[..., None]) / k
    pen = logaddexp0(x) * k
    coeff = torch.where(pair[..., None] & (dist2 > 0), spec.contact_force * pen / dist,
                        torch.zeros((), dtype=pos.dtype, device=dev))
    force = force + (delta * coeff[:, :, None, :]).sum(1)

    mass = _t(spec.initial_mass, pos)[:, None, None]
    vel_new = vel * (1 - spec.damping) + force / mass * dt
    if np.isfinite(spec.max_speed).any():
        speed = vel_new.square().sum(1, keepdim=True).sqrt()
        vmax = _t(spec.max_speed, pos)[:, None, None]
        vel_new = torch.where(speed > vmax, vel_new / torch.where(speed > 0, speed, one) * vmax,
                              vel_new)
    movable = torch.tensor(spec.movable, device=dev)[:, None, None]
    vel_new = torch.where(movable, vel_new, vel)
    pos_new = torch.where(movable, pos + vel_new * dt, pos)
    return pos_new, vel_new


def decode_onehot_block(spec: ScenarioSpec, move, dtype):
    """DISCRETE decode: move ``[A, 5, N]`` -> u ``[A, P, N]`` scaled by
    accel (environment.py:174-181)."""
    like = move.to(dtype)
    u = like[:, 1::2] - like[:, 2::2]
    sens = _t(spec.accel, like)[:, None, None]
    mov = _t(spec.movable[: spec.n_agents], like)[:, None, None]
    return u * sens * mov


def spread_reward_obs(spec: ScenarioSpec, pos, vel):
    """simple_spread shared reward and observations: pos/vel ``[E, P, N]``
    -> (reward ``[A, N]`` after the collaborative broadcast, obs
    ``[A, 18, N]``), self-collision quirk included."""
    a = spec.n_agents
    ap, lp, av = pos[:a], pos[a:], vel[:a]
    n = pos.shape[-1]

    d = (ap[:, None] - lp[None, :]).square().sum(2).sqrt()       # [A, L, N]
    base = -d.amin(0).sum(0)                                     # [N]
    ad2 = (ap[:, None] - ap[None, :]).square().sum(2)            # [A, A, N]
    thresh = _t((spec.size[:a, None] + spec.size[None, :a]) ** 2, pos)[..., None]
    coll = (ad2 < thresh).to(pos.dtype)
    per_agent = base[None, :] - coll.sum(1)                      # [A, N]
    shared = per_agent.sum(0, keepdim=True)
    reward = shared.expand(a, n)

    lrel = lp[None, :] - ap[:, None]                             # [A, L, P, N]
    others = torch.stack([
        torch.stack([ap[j] - ap[i] for j in range(a) if j != i]).reshape(-1, n)
        for i in range(a)])                                      # [A, 2(A-1), N]
    comm = torch.zeros((a, (a - 1) * spec.dim_c, n), dtype=pos.dtype, device=pos.device)
    obs = torch.cat([av, ap, lrel.reshape(a, -1, n), others, comm], dim=1)
    return reward, obs


def batched_spread_step(spec: ScenarioSpec, pos, vel, move):
    """Full env-minor simple_spread step: one-hot moves ``[A, 5, N]`` in,
    (pos, vel, reward ``[A, N]``, obs ``[A, 18, N]``) out."""
    u = decode_onehot_block(spec, move, pos.dtype)
    pos, vel = batched_physics_step(spec, pos, vel, u)
    reward, obs = spread_reward_obs(spec, pos, vel)
    return pos, vel, reward, obs

"""Kernel-scenario blocks of the fused rollouts, as plain env-minor PyTorch
(counterpart of ``mpe_tpu/ops/kernel_scenarios.py``).

These are the plain versions of what the CUDA kernels in
``csrc/mpe_kernels.cu`` compute per env lane: the per-entity scalars of
the spec are read as Python floats, the tiny entity loops are unrolled,
and every row is ``[P, N]`` or ``[1, N]`` with the env axis last.

Only simple_spread is ported (``KernelSpread``). Specs with at least
``MIN_MXU_PAIRS`` collide pairs take ``mpe_tpu/ops/mxu_physics.py`` in the JAX
package; that block is ROADMAP B4 and raises here.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.physics import logaddexp0
from mpe_tpu_torch.core.state import ScenarioSpec
from mpe_tpu_torch.ops.fused_rollout import spread_reward_obs_block


def collide_pairs(spec: ScenarioSpec) -> list[tuple[int, int]]:
    """(i, j) entity pairs that exert contact forces: both collide, at
    least one movable (core.py:151-169)."""
    return [(i, j)
            for i in range(spec.n_entities) for j in range(i + 1, spec.n_entities)
            if spec.collide[i] and spec.collide[j] and (spec.movable[i] or spec.movable[j])]


def decode_move_block(spec: ScenarioSpec, move):
    """[A, 5, N] one-hots -> scaled force [A, P, N] (environment.py:174-181)."""
    a = spec.n_agents
    u = torch.stack([move[:, 2 * k + 1] - move[:, 2 * k + 2] for k in range(spec.dim_p)], dim=1)
    accel = [float(x) for x in spec.accel]
    mov = [bool(m) for m in spec.movable[:a]]
    if len(set(accel)) == 1 and all(mov):
        return u * accel[0]
    return torch.stack([u[i] * (accel[i] if mov[i] else 0.0) for i in range(a)])


def generic_physics_block(spec: ScenarioSpec, pos, vel, move):
    """One core.py:117-169 step for any spec: pos/vel [E, P, N], move
    [A, 5, N] -> (pos, vel). Collide pairs unrolled; the distance is
    ``d2 * rsqrt(max(d2, tiny))``, so an exact overlap gives a zero force;
    ``logaddexp(0, x)`` is written as ``max(x, 0) + log1p(exp(-|x|))``."""
    a, e = spec.n_agents, spec.n_entities
    tiny = torch.finfo(pos.dtype).tiny
    k = float(spec.contact_margin)
    # a tensor divisor: PyTorch divides by a Python scalar on CUDA as a
    # multiply by its reciprocal, which rounds differently from x / k
    k_div = torch.tensor(k, dtype=pos.dtype, device=pos.device)
    cf = float(spec.contact_force)
    damping = float(spec.damping)
    dt = float(spec.dt)

    u = decode_move_block(spec, move)
    rows = [u[i] if spec.movable[i] else None for i in range(a)] + [None] * (e - a)
    for i, j in collide_pairs(spec):
        delta = pos[i] - pos[j]                                  # [P, N]
        d2 = delta.square().sum(0, keepdim=True)
        inv = torch.rsqrt(d2.clamp_min(tiny))
        dist = d2 * inv
        x = -(dist - float(spec.size[i] + spec.size[j])) / k_div
        pen = logaddexp0(x) * k
        f = (cf * pen) * inv * delta
        if spec.movable[i]:
            rows[i] = f if rows[i] is None else rows[i] + f
        if spec.movable[j]:
            rows[j] = -f if rows[j] is None else rows[j] - f

    new_pos, new_vel = [], []
    for i in range(e):
        if not spec.movable[i]:
            new_pos.append(pos[i])
            new_vel.append(vel[i])
            continue
        v = vel[i] * (1.0 - damping)
        if rows[i] is not None:
            v = v + rows[i] * (dt / float(spec.initial_mass[i]))
        ms = float(spec.max_speed[i])
        if np.isfinite(ms):
            s2 = v.square().sum(0, keepdim=True)
            inv_s = torch.rsqrt(s2.clamp_min(tiny))
            v = torch.where(s2 > ms * ms, v * (ms * inv_s), v)
        new_vel.append(v)
        new_pos.append(pos[i] + v * dt)
    return torch.stack(new_pos), torch.stack(new_vel)


class KernelScenario:
    """Blocks consumed by the fused rollouts. ``reward_obs`` returns
    (reward rows [R, N] -- R=1 for shared-reward scenarios -- and obs
    [A, obs_w, N])."""

    spec: ScenarioSpec
    obs_w: int
    reward_rows: int
    goal_choices: tuple = ()
    uses_comm: bool = False
    MIN_MXU_PAIRS = 4

    def reset_ranges(self) -> tuple[float, float]:
        """(agent_range, landmark_range) for uniform position sampling."""
        return 1.0, 1.0

    def physics(self, pos, vel, move):
        if len(collide_pairs(self.spec)) >= self.MIN_MXU_PAIRS:
            raise NotImplementedError(_MXU_MSG.format(name=self.spec.name))
        return generic_physics_block(self.spec, pos, vel, move)

    def reward_obs(self, pos, vel, comm=None, goal=None):
        raise NotImplementedError


class KernelSpread(KernelScenario):
    """simple_spread (see ``fused_rollout.spread_reward_obs_block``)."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 18
        self.reward_rows = 1

    def reward_obs(self, pos, vel, comm=None, goal=None):
        a = self.spec.n_agents
        return spread_reward_obs_block(self.spec, pos[:a], vel[:a], pos[a:])


_KERNEL_SCENARIOS = {"simple_spread": KernelSpread}

_MXU_MSG = ("spec {name!r} has at least 4 collide pairs, where the JAX kernels take "
            "ops/mxu_physics.py::mxu_physics_block; that block is not ported yet "
            "(ROADMAP B4, mxu_physics)")


def kernel_scenario(name_or_scenario) -> KernelScenario:
    """Kernel blocks for a scenario (by name or scenario instance), with the
    JAX package's rejections: action/comm noise and the scripted-agent hook
    are not implemented by the fused kernels (use ``MpeEnv``). A spec with
    ``MIN_MXU_PAIRS`` or more collide pairs raises ``NotImplementedError``
    until ``mxu_physics`` is ported."""
    from mpe_tpu_torch import scenarios as registry
    from mpe_tpu_torch.scenarios._base import Scenario

    scn = registry.load(name_or_scenario) if isinstance(name_or_scenario, str) else name_or_scenario
    name = scn.spec.name
    if name not in _KERNEL_SCENARIOS:
        raise KeyError(f"no fused kernel for {name!r}; available: {sorted(_KERNEL_SCENARIOS)} "
                       "(MpeEnv and build_rollout run every ported scenario)")
    if np.any(scn.spec.u_noise) or np.any(scn.spec.c_noise):
        raise NotImplementedError(
            f"scenario {name!r} sets u_noise/c_noise, which the fused kernels do not "
            "implement; use MpeEnv / build_rollout")
    if type(scn).scripted_action is not Scenario.scripted_action:
        raise NotImplementedError(
            f"scenario {name!r} overrides scripted_action, which the fused kernels do "
            "not implement; use MpeEnv / build_rollout")
    if len(collide_pairs(scn.spec)) >= KernelScenario.MIN_MXU_PAIRS:
        raise NotImplementedError(_MXU_MSG.format(name=name))
    return _KERNEL_SCENARIOS[name](scn.spec)

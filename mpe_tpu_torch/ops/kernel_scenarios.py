"""Kernel-scenario blocks of the fused rollouts, as plain env-minor PyTorch
(counterpart of ``mpe_tpu/ops/kernel_scenarios.py``).

These are the plain versions of what the CUDA kernels compute per env lane
(``csrc/spread_common.cuh`` and ``csrc/scenario_blocks.cuh``): the per-entity scalars of
the spec are read as Python floats, the tiny entity loops are unrolled,
and every row is ``[P, N]`` or ``[1, N]`` with the env axis last.

Ported: simple_spread (``KernelSpread``), simple (``KernelSimple``),
simple_reference (``KernelReference``) and simple_speaker_listener
(``KernelSpeakerListener``); the goal and comm helpers select by an unrolled
compare, as the CUDA kernels do. Specs with at least ``MIN_MXU_PAIRS``
collide pairs take ``mpe_tpu/ops/mxu_physics.py`` in the JAX package; that
block is ROADMAP B4 and raises here.
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


class KernelSimple(KernelScenario):
    """simple: reward -dist^2 to the landmark; obs [vel, landmark_rel]
    (reference simple.py:41-50)."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 4
        self.reward_rows = 1

    def reward_obs(self, pos, vel, comm=None, goal=None):
        rel = pos[1] - pos[0]                                    # [P, N]
        rew = -rel.square().sum(0, keepdim=True)
        return rew, torch.cat([vel[0], rel], dim=0)[None]         # [1, 4, N]


class KernelSpread(KernelScenario):
    """simple_spread (see ``fused_rollout.spread_reward_obs_block``)."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 18
        self.reward_rows = 1

    def reward_obs(self, pos, vel, comm=None, goal=None):
        a = self.spec.n_agents
        return spread_reward_obs_block(self.spec, pos[:a], vel[:a], pos[a:])


# ---------------------------------------------------------------------------
# goal / comm helpers
# ---------------------------------------------------------------------------

def select_by_goal(goal_row, values):
    """``values[goal]`` per lane: goal_row [1, N] int, values[j] [.., N]
    (an unrolled select, as the kernels pick a landmark)."""
    out = values[0]
    for j in range(1, len(values)):
        out = torch.where(goal_row == j, values[j], out)
    return out


def color_rows_by_goal(goal_row, colors, n, dtype):
    """[3, N] RGB rows of ``colors[goal]`` per lane."""
    return torch.cat([select_by_goal(goal_row, [torch.full((1, n), c[ch], dtype=dtype,
                                                           device=goal_row.device)
                                                for c in colors])
                      for ch in range(3)])


class KernelReference(KernelScenario):
    """simple_reference (collaborative; reference simple_reference.py:55-80).
    Returns the post-broadcast shared reward [1, N]."""

    LMK_COLORS = ((0.75, 0.25, 0.25), (0.25, 0.75, 0.25), (0.25, 0.25, 0.75))

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 21
        self.reward_rows = 1
        self.goal_choices = (3, 3)
        self.uses_comm = True

    def reward_obs(self, pos, vel, comm=None, goal=None):
        n = pos.shape[-1]
        lpos = [pos[2], pos[3], pos[4]]
        shared = pos.new_zeros((1, n))
        for i, other in ((0, 1), (1, 0)):
            gpos = select_by_goal(goal[i:i + 1], lpos)
            shared = shared - (pos[other] - gpos).square().sum(0, keepdim=True)
        rows = []
        for i, other in ((0, 1), (1, 0)):
            color = color_rows_by_goal(goal[i:i + 1], self.LMK_COLORS, n, pos.dtype)
            rows.append(torch.cat([vel[i]] + [pos[j] - pos[i] for j in (2, 3, 4)]
                                  + [color, comm[other]]))
        return shared, torch.stack(rows)


class KernelSpeakerListener(KernelScenario):
    """simple_speaker_listener (collaborative; reference :63-92): the shared
    reward is -2 d^2, the sum over its 2 agents."""

    LMK_COLORS = ((0.65, 0.15, 0.15), (0.15, 0.65, 0.15), (0.15, 0.15, 0.65))

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 11
        self.reward_rows = 1
        self.goal_choices = (3,)
        self.uses_comm = True

    def reward_obs(self, pos, vel, comm=None, goal=None):
        n = pos.shape[-1]
        g = goal[0:1]
        gpos = select_by_goal(g, [pos[2], pos[3], pos[4]])
        shared = -2.0 * (pos[1] - gpos).square().sum(0, keepdim=True)
        color = color_rows_by_goal(g, self.LMK_COLORS, n, pos.dtype)
        speaker = torch.cat([color, pos.new_zeros((8, n))])      # padded 3 -> 11
        listener = torch.cat([vel[1], pos[2] - pos[1], pos[3] - pos[1], pos[4] - pos[1], comm[0]])
        return shared, torch.stack([speaker, listener])


_KERNEL_SCENARIOS = {
    "simple": KernelSimple,
    "simple_reference": KernelReference,
    "simple_speaker_listener": KernelSpeakerListener,
    "simple_spread": KernelSpread,
}

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

"""Kernel-scenario blocks of the fused rollouts, as plain env-minor PyTorch
(counterpart of ``mpe_tpu/ops/kernel_scenarios.py``).

These are the plain versions of what the CUDA kernels compute per env lane
(``csrc/spread_common.cuh`` and ``csrc/scenario_blocks.cuh``): the per-entity scalars of
the spec are read as Python floats, the tiny entity loops are unrolled,
and every row is ``[P, N]`` or ``[1, N]`` with the env axis last.

All nine scenarios: simple_spread (``KernelSpread``), simple, simple_reference,
simple_speaker_listener, simple_adversary, simple_push, simple_crypto,
simple_tag and simple_world_comm. The goal and comm helpers select by an
unrolled compare, as the CUDA kernels do. A sum of more than two terms is
written out in the order the kernels add them. Specs with at least
``MIN_MXU_PAIRS`` collide pairs (tag's 14, world_comm's 21) take the pair
physics of ``ops/mxu_physics.py``, the others ``generic_physics_block``.
World_comm's matmul obs assembly (``KernelWorldComm._obs_mxu`` in the JAX
package) lost to the row-wise form on the TPU and is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from mpe_tpu_torch.core.physics import logaddexp0
from mpe_tpu_torch.core.state import ScenarioSpec
from mpe_tpu_torch.ops.fused_rollout import spread_reward_obs_block
from mpe_tpu_torch.ops.mxu_physics import MIN_MXU_PAIRS, collide_pairs, mxu_physics_block
from mpe_tpu_torch.scenarios._base import bound_penalty


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
    MIN_MXU_PAIRS = MIN_MXU_PAIRS

    @property
    def n_moves(self) -> int:
        """Move logits of an agent's policy: no-op and +/- per axis."""
        return 2 * self.spec.dim_p + 1

    @property
    def n_comm(self) -> int:
        """Comm logits of an agent's policy: dim_c where the scenario
        speaks, else 0."""
        return self.spec.dim_c if self.uses_comm else 0

    @property
    def n_logits(self) -> int:
        """The policy head's width: moves, then comm."""
        return self.n_moves + self.n_comm

    @property
    def speak(self) -> tuple[bool, ...] | None:
        """Each agent's speak flag (not silent) where the scenario has a comm
        head, else None: a silent agent's comm factor is masked out."""
        if not self.n_comm:
            return None
        return tuple(not bool(s) for s in self.spec.silent[:self.spec.n_agents])

    def reset_ranges(self) -> tuple[float, float]:
        """(agent_range, landmark_range) for uniform position sampling."""
        return 1.0, 1.0

    def physics(self, pos, vel, move):
        """``mxu_physics_block`` at ``MIN_MXU_PAIRS`` collide pairs or more,
        ``generic_physics_block`` below (the JAX package's dispatch)."""
        return mxu_physics_block(self.spec, pos, vel, move)

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


def const_rows(vals, n, dtype, device=None):
    """[len(vals), N] of per-row scalar constants."""
    return torch.cat([torch.full((1, n), float(v), dtype=dtype, device=device) for v in vals])


def onehot_rows(goal_row, width, dtype):
    """[width, N] one-hot of a [1, N] int index (unrolled)."""
    return torch.cat([(goal_row == j).to(dtype) for j in range(width)])


def _sq_dist(pos, i, j):
    """[1, N] squared distance of entities i and j."""
    return (pos[i] - pos[j]).square().sum(0, keepdim=True)


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


class KernelAdversary(KernelScenario):
    """simple_adversary (shaped rewards; reference simple_adversary.py:82-139).
    Goal: 1 of 2 landmarks. As the JAX block, the adversary's reward squares
    the square root of its squared distance."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 10
        self.reward_rows = 3
        self.goal_choices = (2,)

    def reward_obs(self, pos, vel, comm=None, goal=None):
        n = pos.shape[-1]
        gpos = select_by_goal(goal[0:1], [pos[3], pos[4]])             # [P, N]
        d = [(pos[i] - gpos).square().sum(0, keepdim=True).sqrt() for i in range(3)]
        adv_r = -d[0].square()
        good_r = -torch.minimum(d[1], d[2]) + d[0]
        rows = []
        for i in range(3):
            parts = [] if i == 0 else [gpos - pos[i]]                  # goal rel
            parts += [pos[j] - pos[i] for j in (3, 4)]                 # landmark rel
            parts += [pos[j] - pos[i] for j in range(3) if j != i]     # other rel
            if i == 0:
                parts.append(pos.new_zeros((2, n)))                    # padded 8 -> 10
            rows.append(torch.cat(parts))
        return torch.cat([adv_r, good_r, good_r]), torch.stack(rows)


class KernelPush(KernelScenario):
    """simple_push (reference simple_push.py:62-96): landmark colors, and the
    good agent's own color raised on channel goal+1."""

    PUSH_LANDMARK_COLORS = (0.1, 0.9, 0.1, 0.1, 0.1, 0.9)

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 19
        self.reward_rows = 2
        self.goal_choices = (2,)

    def reward_obs(self, pos, vel, comm=None, goal=None):
        dtype, n = pos.dtype, pos.shape[-1]
        g = goal[0:1]
        gpos = select_by_goal(g, [pos[2], pos[3]])
        d0 = (pos[0] - gpos).square().sum(0, keepdim=True).sqrt()
        d1 = (pos[1] - gpos).square().sum(0, keepdim=True).sqrt()
        quarter = torch.full((1, n), 0.25, dtype=dtype, device=pos.device)
        own = [quarter, quarter + 0.5 * (g == 0).to(dtype), quarter + 0.5 * (g == 1).to(dtype)]
        adv = torch.cat([vel[0], pos[2] - pos[0], pos[3] - pos[0], pos[1] - pos[0],
                         pos.new_zeros((11, n))])
        good = torch.cat([vel[1], gpos - pos[1]] + own
                         + [pos[2] - pos[1], pos[3] - pos[1],
                            const_rows(self.PUSH_LANDMARK_COLORS, n, dtype, pos.device),
                            pos[0] - pos[1]])
        return torch.cat([d1 - d0, -d1]), torch.stack([adv, good])


class KernelCrypto(KernelScenario):
    """simple_crypto (comm only; reference simple_crypto.py:97-169): goal and
    key as one-hots of width dim_c, an all-zero utterance scores 0."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 8
        self.reward_rows = 3
        self.goal_choices = (2, 2)
        self.uses_comm = True

    def reward_obs(self, pos, vel, comm=None, goal=None):
        dtype, dc = pos.dtype, self.spec.dim_c
        goal_color = onehot_rows(goal[0:1], dc, dtype)                 # [dim_c, N]
        key_color = onehot_rows(goal[1:2], dc, dtype)
        eve_c, bob_c, alice_c = comm[0], comm[1], comm[2]

        def guarded(c):
            nz = torch.zeros_like(c[0:1])
            for r in range(dc):
                nz = torch.maximum(nz, (c[r:r + 1] != 0).to(dtype))
            sq = (c - goal_color).square()
            err = sq[0:1]
            for r in range(1, dc):
                err = err + sq[r:r + 1]
            return nz * err

        good = -guarded(bob_c) + guarded(eve_c)
        eve = -guarded(eve_c)
        pad = pos.new_zeros((dc, pos.shape[-1]))
        rows = [torch.cat([alice_c, pad]),                             # eve
                torch.cat([key_color, alice_c]),                       # bob
                torch.cat([goal_color, key_color])]                    # alice
        return torch.cat([eve, good, good]), torch.stack(rows)


class KernelTag(KernelScenario):
    """simple_tag: 3 predators and 1 prey, colliding obstacle landmarks, the
    bound penalty (reference simple_tag.py:89-147). Obs [vel(2), pos(2),
    landmark rel(4), others rel(6), the prey's velocity or 0 for the prey]."""

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 16
        self.reward_rows = spec.n_agents

    def reset_ranges(self):
        return 1.0, 0.9                                                # simple_tag.py:47-52

    def reward_obs(self, pos, vel, comm=None, goal=None):
        spec = self.spec
        a, l = spec.n_agents, spec.n_landmarks
        n = pos.shape[-1]
        prey = a - 1
        hits = pos.new_zeros((1, n))                                   # after the step
        for i in range(prey):
            thresh2 = float(spec.size[i] + spec.size[prey]) ** 2
            hits = hits + (_sq_dist(pos, i, prey) < thresh2).to(pos.dtype)
        adv_r = 10.0 * hits
        bound = pos.new_zeros((1, n))
        for d in range(spec.dim_p):
            bound = bound + bound_penalty(pos[prey, d:d + 1].abs())
        prey_r = -10.0 * hits - bound
        rows = []
        for i in range(a):
            parts = [vel[i], pos[i]] + [pos[a + j] - pos[i] for j in range(l)]
            parts += [pos[j] - pos[i] for j in range(a) if j != i]
            parts.append(vel[prey] if i != prey else pos.new_zeros((2, n)))   # padded to 16
            rows.append(torch.cat(parts))
        return torch.cat([adv_r, adv_r, adv_r, prey_r]), torch.stack(rows)


class KernelWorldComm(KernelScenario):
    """simple_world_comm (reference simple_world_comm.py:155-287): the leader's
    broadcast comm, forest visibility, food, the obstacle. Landmarks:
    [obstacle, food0, food1, forest0, forest1]. Thresholds compare squared
    distances; a min-distance term takes one sqrt after the min of squares.
    The obs is the JAX block's row-wise assembly (``_obs_rowwise``)."""

    N_ADV, N_GOOD = 4, 2
    FOOD = (1, 2)
    FORESTS = (3, 4)

    def __init__(self, spec: ScenarioSpec):
        self.spec = spec
        self.obs_w = 34
        self.reward_rows = 6
        self.uses_comm = True

    def reset_ranges(self):
        return 1.0, 0.9

    def reward_obs(self, pos, vel, comm=None, goal=None):
        spec = self.spec
        a = spec.n_agents
        dtype = pos.dtype
        n = pos.shape[-1]
        na, ng = self.N_ADV, self.N_GOOD

        def thresh2(i, j):
            return float(spec.size[i] + spec.size[j]) ** 2

        d2_ga = {(g, v): _sq_dist(pos, na + g, v) for g in range(ng) for v in range(na)}
        hit_ga = {k: d < thresh2(na + k[0], k[1]) for k, d in d2_ga.items()}
        pair_hits = pos.new_zeros((1, n))
        for h in hit_ga.values():
            pair_hits = pair_hits + h.to(dtype)

        # adversaries: -0.1 * min over good of the distance + 5 * pair_hits
        adv_rows = []
        for v in range(na):
            dmin2 = d2_ga[(0, v)]
            for g in range(1, ng):
                dmin2 = torch.minimum(dmin2, d2_ga[(g, v)])
            adv_rows.append(-0.1 * dmin2.sqrt() + 5.0 * pair_hits)

        # good: -5 per adversary hit, -2 * bound, +2 per food touched, and the
        # reference's positive 0.05 * min food distance (simple_world_comm.py:181)
        good_rows = []
        for g in range(ng):
            i = na + g
            hits = pos.new_zeros((1, n))
            for v in range(na):
                hits = hits + hit_ga[(g, v)].to(dtype)
            bound = pos.new_zeros((1, n))
            for d in range(spec.dim_p):
                bound = bound + bound_penalty(pos[i, d:d + 1].abs())
            food_touch = pos.new_zeros((1, n))
            food_dmin2 = None
            for f in self.FOOD:
                df2 = _sq_dist(pos, i, a + f)
                food_touch = food_touch + (df2 < thresh2(i, a + f)).to(dtype)
                food_dmin2 = df2 if food_dmin2 is None else torch.minimum(food_dmin2, df2)
            good_rows.append(-5.0 * hits - 2.0 * bound + 2.0 * food_touch
                             + 0.05 * food_dmin2.sqrt())

        # forest membership and visibility (simple_world_comm.py:231-261)
        in_f = {(i, fi): _sq_dist(pos, i, a + f) < thresh2(i, a + f)
                for i in range(a) for fi, f in enumerate(self.FORESTS)}
        outside = {i: ~(in_f[(i, 0)] | in_f[(i, 1)]) for i in range(a)}

        def visible(i, j):
            if spec.leader[i]:
                return None                                            # always visible
            same = (in_f[(i, 0)] & in_f[(j, 0)]) | (in_f[(i, 1)] & in_f[(j, 1)])
            return same | (outside[i] & outside[j])

        zero = torch.zeros((), dtype=dtype, device=pos.device)
        rows = []
        for i in range(a):
            parts = [vel[i], pos[i]] + [pos[a + f] - pos[i] for f in range(spec.n_landmarks)]
            ovel = []
            for j in range(a):
                if j == i:
                    continue
                mask = visible(i, j)
                rel, vj = pos[j] - pos[i], vel[j]
                if mask is not None:
                    rel, vj = torch.where(mask, rel, zero), torch.where(mask, vj, zero)
                parts.append(rel)
                if not spec.adversary[j]:
                    ovel.append(vj)
            forest_pm = torch.cat([torch.where(in_f[(i, fi)], 1.0, -1.0).to(dtype)
                                   for fi in range(2)])
            if spec.adversary[i]:
                parts += ovel + [forest_pm, comm[0]]                   # the leader's comm
            else:
                parts += [forest_pm] + ovel + [pos.new_zeros((6, n))]  # 28 padded to 34
            rows.append(torch.cat(parts))
        return torch.cat(adv_rows + good_rows), torch.stack(rows)


_KERNEL_SCENARIOS = {
    "simple": KernelSimple,
    "simple_adversary": KernelAdversary,
    "simple_crypto": KernelCrypto,
    "simple_push": KernelPush,
    "simple_reference": KernelReference,
    "simple_speaker_listener": KernelSpeakerListener,
    "simple_spread": KernelSpread,
    "simple_tag": KernelTag,
    "simple_world_comm": KernelWorldComm,
}


def kernel_scenario(name_or_scenario) -> KernelScenario:
    """Kernel blocks for a scenario (by name or scenario instance), with the
    JAX package's rejections: action/comm noise and the scripted-agent hook
    are not implemented by the fused kernels (use ``MpeEnv``). What the CUDA
    instantiations compute is checked at launch (``ops/_build.py``)."""
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
    return _KERNEL_SCENARIOS[name](scn.spec)

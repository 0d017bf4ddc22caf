"""Scenario contract + shared batched building blocks (PyTorch counterpart
of ``mpe_tpu/scenarios/_base.py``).

A scenario is a static ``ScenarioSpec`` plus functions of a batched
``WorldState`` (leading env axis):

    reset(n_envs, generator, dtype, device) -> WorldState
    reward(state)         -> [B, A]
    observation(state)    -> [B, A, max(obs_dims)] (rows zero-padded)
    benchmark_data(state) -> dict of [B, ...] tensors
    done(state)           -> bool [B, A]
    entity_colors(state)  -> [B, E, 3]

Every helper takes any number of leading batch axes.
"""

from __future__ import annotations

import torch

from mpe_tpu_torch._device import device_table
from mpe_tpu_torch.core.state import ScenarioSpec, WorldState


class Scenario:
    """Base scenario: subclasses set ``self.spec`` and override hooks."""

    spec: ScenarioSpec
    obs_dims: tuple[int, ...]
    #: ``benchmark_data`` keys that hold one entry per agent (the reference
    #: computes benchmark_data per agent): their agent axis is the one after
    #: the env axis (``[B, A, ...]``, e.g. simple_crypto's ``comm`` is
    #: ``[B, A, C]``); every other key is one value per env
    per_agent_info: frozenset[str] = frozenset()

    def reset(self, n_envs: int, generator: torch.Generator,
              dtype=torch.float32, device=None) -> WorldState:
        raise NotImplementedError

    def reward(self, state: WorldState) -> torch.Tensor:
        raise NotImplementedError

    def observation(self, state: WorldState) -> torch.Tensor:
        raise NotImplementedError

    def benchmark_data(self, state: WorldState):
        return None

    def scripted_action(self, state: WorldState):
        """Scripted-agent hook (the reference's ``action_callback``,
        core.py:79 and 117-120): ``None`` or ``(mask bool[A], u [B, A, P],
        c [B, A, C])``; masked agents take these actions instead of the
        policy's."""
        return None

    def done(self, state: WorldState) -> torch.Tensor:
        return torch.zeros(state.t.shape + (self.spec.n_agents,),
                           dtype=torch.bool, device=state.device)

    def entity_colors(self, state: WorldState) -> torch.Tensor:
        """[..., E, 3] render colors (the reference stores them on entities)."""
        return const([[0.5, 0.5, 0.5]] * self.spec.n_entities, state).expand(
            state.t.shape + (self.spec.n_entities, 3))

    @property
    def obs_width(self) -> int:
        return max(self.obs_dims)


def uniform_reset(
    spec: ScenarioSpec,
    n_envs: int,
    generator: torch.Generator,
    dtype=torch.float32,
    device=None,
    *,
    agent_range: float = 1.0,
    landmark_range: float = 1.0,
    n_goal_choices: int | tuple[int, ...] = (),
) -> WorldState:
    """Agents uniform in [-agent_range, agent_range]^P, landmarks in
    [-landmark_range, landmark_range]^P, zero velocity and comm, uniform
    goal indices (e.g. simple_spread.py:39-45)."""
    a, l, p = spec.n_agents, spec.n_landmarks, spec.dim_p
    kw = dict(generator=generator, dtype=dtype, device=device)
    apos = (torch.rand((n_envs, a, p), **kw) * 2 - 1) * agent_range
    lpos = (torch.rand((n_envs, l, p), **kw) * 2 - 1) * landmark_range
    if isinstance(n_goal_choices, int):
        n_goal_choices = (n_goal_choices,)
    goals = [torch.randint(0, n, (n_envs,), generator=generator, device=device,
                           dtype=torch.int32) for n in n_goal_choices]
    goal = (torch.stack(goals, dim=-1) if goals
            else torch.zeros((n_envs, 0), dtype=torch.int32, device=device))
    if goal.shape[-1] != spec.n_goals:
        raise ValueError(f"{len(goals)} goal choices for a spec with {spec.n_goals} goals")
    return WorldState(
        pos=torch.cat([apos, lpos], dim=-2),
        vel=torch.zeros((n_envs, spec.n_entities, p), dtype=dtype, device=device),
        comm=torch.zeros((n_envs, a, spec.dim_c), dtype=dtype, device=device),
        goal=goal,
        t=torch.zeros((n_envs,), dtype=torch.int32, device=device),
    )


def agent_pos(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    return state.pos[..., : spec.n_agents, :]


def landmark_pos(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    return state.pos[..., spec.n_agents:, :]


def landmark_rel(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    """[..., A, L, P] landmark positions in each agent's frame."""
    return landmark_pos(spec, state)[..., None, :, :] - agent_pos(spec, state)[..., :, None, :]


def other_rel(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    """[..., A, A-1, P] other agents' positions in each agent's frame, in
    world order excluding self (simple_spread.py:96-99)."""
    ap = agent_pos(spec, state)
    idx = device_table(spec.others_idx, torch.int64, ap.device)
    return ap[..., idx, :] - ap[..., :, None, :]


def other_comm(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    """[..., A, A-1, C] other agents' utterances."""
    idx = device_table(spec.others_idx, torch.int64, state.comm.device)
    return state.comm[..., idx, :]


def pairwise_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, M] Euclidean distances between row sets."""
    d = x[..., :, None, :] - y[..., None, :, :]
    return d.square().sum(-1).sqrt()


def agent_landmark_dist(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    """[..., A, L] agent-to-landmark distances."""
    return pairwise_dist(agent_pos(spec, state), landmark_pos(spec, state))


def collisions(spec: ScenarioSpec, state: WorldState) -> torch.Tensor:
    """[..., A, A] bool ``is_collision`` between every agent pair, **the
    diagonal included** (the reference's self-collision quirk,
    simple_spread.py:66-70 and :78-81)."""
    ap = agent_pos(spec, state)
    a = spec.n_agents
    smin = device_table(spec.size[:a, None] + spec.size[None, :a], ap.dtype, ap.device)
    return pairwise_dist(ap, ap) < smin


def bound_penalty(x: torch.Tensor) -> torch.Tensor:
    """Screen-exit penalty of simple_tag.py:103-108: 0 below 0.9, linear
    (x-0.9)*10 to 1.0, then min(exp(2x-2), 10)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x < 0.9, zero,
                       torch.where(x < 1.0, (x - 0.9) * 10.0,
                                   torch.clamp_max(torch.exp(2 * x - 2), 10.0)))


def pad_stack(rows: list[torch.Tensor], width: int) -> torch.Tensor:
    """Stack per-agent obs rows ``[..., w_i]`` into ``[..., A, width]``,
    zero-padding each on the right (heterogeneous obs dims, e.g. speaker 3
    vs listener 11)."""
    return torch.stack([torch.nn.functional.pad(r, (0, width - r.shape[-1])) for r in rows],
                       dim=-2)


def const(v, like: WorldState | torch.Tensor) -> torch.Tensor:
    """A constant table in the dtype and on the device of ``like``, made
    once and shared (``device_table``): never write to it in place."""
    return device_table(v, like.dtype, like.device)


def take_row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx`` of ``table`` per env: table ``[..., L, W]`` (leading axes
    broadcast against idx's), idx ``[...]`` int -> ``[..., W]``. The JAX
    package contracts a one-hot instead of gathering, which is faster on the
    TPU; the values are the same."""
    idx = idx.long()
    table = table.expand(idx.shape + table.shape[-2:])
    index = idx[..., None, None].expand(idx.shape + (1, table.shape[-1]))
    return torch.gather(table, -2, index).squeeze(-2)

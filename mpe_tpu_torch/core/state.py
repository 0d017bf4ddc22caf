"""Struct-of-arrays world state + static per-scenario entity table.

PyTorch counterpart of ``mpe_tpu/core/state.py`` (reference
multiagent/core.py:4-99):

  - ``WorldState`` -- a dataclass of tensors over a unified entity axis
    (agents first, then landmarks) with a leading env axis: ``pos`` is
    ``[B, E, P]``, ``t`` is ``[B]``. The env-minor layout of the fused
    engine (``[E, P, B]``) is produced at the rollout boundary.
  - ``ScenarioSpec`` -- the static entity table as read-only numpy arrays
    (no flax): masks and physical constants that the reference stores as
    per-object attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass
class WorldState:
    """Dynamic world state of a batch of envs.

    Attributes:
      pos:  [B, E, P] float -- entity positions (reference ``state.p_pos``).
      vel:  [B, E, P] float -- entity velocities (``state.p_vel``).
      comm: [B, A, C] float -- agent utterances (``state.c``).
      goal: [B, G] int32 -- goal landmark indices (G == 0 without goals).
      t:    [B] int32 -- step counter (horizon / auto-reset).
    """

    pos: torch.Tensor
    vel: torch.Tensor
    comm: torch.Tensor
    goal: torch.Tensor
    t: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **changes) -> "WorldState":
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable, *others: "WorldState") -> "WorldState":
        """Apply ``fn`` leaf by leaf (``jax.tree.map`` over the fields)."""
        return WorldState(**{
            f.name: fn(getattr(self, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Static per-scenario entity table + physics constants (reference
    core.py:27-99). Every array is read-only numpy over the entity axis
    (E = agents then landmarks) or the agent axis (A)."""

    name: str
    n_agents: int
    n_landmarks: int

    movable: np.ndarray       # bool[E]
    collide: np.ndarray       # bool[E]
    size: np.ndarray          # f64[E]
    initial_mass: np.ndarray  # f64[E]
    max_speed: np.ndarray     # f64[E], inf = no clamp

    silent: np.ndarray        # bool[A]
    adversary: np.ndarray     # bool[A]
    leader: np.ndarray        # bool[A]
    accel: np.ndarray         # f64[A] action sensitivity (5.0 when unset)
    u_range: np.ndarray       # f64[A]
    u_noise: np.ndarray       # f64[A] (0.0 when unset)
    c_noise: np.ndarray       # f64[A] (0.0 when unset)

    dim_p: int = 2
    dim_c: int = 0
    dim_color: int = 3
    dt: float = 0.1
    damping: float = 0.25
    contact_force: float = 1e2
    contact_margin: float = 1e-3
    collaborative: bool = False
    force_discrete_action: bool = False
    n_goals: int = 0

    def __post_init__(self):
        a, e = self.n_agents, self.n_entities
        if not (self.movable.shape == (e,) and self.collide.shape == (e,)
                and self.size.shape == (e,) and self.max_speed.shape == (e,)
                and self.silent.shape == (a,) and self.accel.shape == (a,)):
            raise ValueError(f"inconsistent table shapes in spec {self.name!r}")

    @property
    def n_entities(self) -> int:
        return self.n_agents + self.n_landmarks

    @property
    def others_idx(self) -> np.ndarray:
        """[A, A-1] -- for each agent, the other agents in world order."""
        a = self.n_agents
        return np.array(
            [[j for j in range(a) if j != i] for i in range(a)], dtype=np.int64
        ).reshape(a, max(a - 1, 0))


def make_spec(
    name: str,
    n_agents: int,
    n_landmarks: int,
    *,
    agent_movable: Any = True,
    agent_collide: Any = True,
    agent_silent: Any = True,
    agent_size: Any = 0.05,
    agent_accel: Any = None,
    agent_max_speed: Any = None,
    agent_u_range: Any = 1.0,
    agent_u_noise: Any = None,
    agent_c_noise: Any = None,
    adversary: Any = False,
    leader: Any = False,
    landmark_collide: Any = False,
    landmark_size: Any = 0.05,
    mass: Any = 1.0,
    **world_kwargs,
) -> ScenarioSpec:
    """Build a ScenarioSpec from per-group scalars or per-entity sequences.

    Scalars broadcast; ``None`` for accel/max_speed/noise maps to the
    reference's "unset" semantics (sensitivity 5.0, no clamp, no noise).
    """

    def bcast(v, n, none_to, dtype=np.float64):
        if v is None:
            v = none_to
        out = np.broadcast_to(np.asarray(v, dtype=dtype), (n,)).copy()
        if dtype == np.float64 and none_to is not None:
            out[np.isnan(out)] = none_to
        out.setflags(write=False)
        return out

    def seq(v, n, none_to, dtype=np.float64):
        if isinstance(v, (list, tuple)):
            v = [none_to if x is None else x for x in v]
        elif v is None:
            v = none_to
        return bcast(v, n, none_to, dtype)

    a, l = n_agents, n_landmarks
    movable = np.concatenate([bcast(agent_movable, a, None, bool), np.zeros(l, bool)])
    collide = np.concatenate([bcast(agent_collide, a, None, bool),
                              bcast(landmark_collide, l, None, bool)])
    size = np.concatenate([seq(agent_size, a, 0.05), seq(landmark_size, l, 0.05)])
    max_speed = np.concatenate([seq(agent_max_speed, a, np.inf), np.full(l, np.inf)])
    per_entity_mass = isinstance(mass, (list, tuple, np.ndarray)) and len(mass) == a + l
    initial_mass = (seq(mass, a + l, 1.0) if per_entity_mass
                    else np.concatenate([seq(mass, a, 1.0), seq(mass, l, 1.0)]))
    for arr in (movable, collide, size, max_speed, initial_mass):
        arr.setflags(write=False)
    return ScenarioSpec(
        name=name,
        n_agents=a,
        n_landmarks=l,
        movable=movable,
        collide=collide,
        size=size,
        initial_mass=initial_mass,
        max_speed=max_speed,
        silent=bcast(agent_silent, a, None, bool),
        adversary=bcast(adversary, a, None, bool),
        leader=bcast(leader, a, None, bool),
        accel=seq(agent_accel, a, 5.0),
        u_range=seq(agent_u_range, a, 1.0),
        u_noise=seq(agent_u_noise, a, 0.0),
        c_noise=seq(agent_c_noise, a, 0.0),
        **world_kwargs,
    )

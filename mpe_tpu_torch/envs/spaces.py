"""Gym-free action/observation space descriptors (counterpart of
``mpe_tpu/envs/spaces.py``).

The reference depends on gym spaces plus a vendored old-gym
``MultiDiscrete`` (reference multiagent/multi_discrete.py:9-44,
environment.py:38-70). This module has the same four space kinds with no
gym dependency. ``sample(generator)`` draws with a ``torch.Generator`` and
puts the sample on the generator's device; ``contains`` takes numpy
arrays, Python values and tensors on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpe_tpu_torch._device import to_host


class Space:
    def sample(self, generator: torch.Generator):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    """{0, ..., n-1} (gym.spaces.Discrete equivalent)."""

    n: int

    def sample(self, generator):
        """An int32 0-d tensor."""
        return torch.randint(0, self.n, (), generator=generator, device=generator.device,
                             dtype=torch.int32)

    def contains(self, x):
        x = int(to_host(x))
        return 0 <= x < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


@dataclasses.dataclass(frozen=True)
class Box(Space):
    """Bounded continuous box (gym.spaces.Box equivalent)."""

    low: float
    high: float
    shape: tuple[int, ...]
    dtype: np.dtype = np.float32

    def sample(self, generator):
        """A tensor of ``shape`` in ``[low, high)``, of ``dtype``."""
        dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        u = torch.rand(self.shape, generator=generator, device=generator.device, dtype=dtype)
        return u * (self.high - self.low) + self.low

    def contains(self, x):
        x = to_host(x)
        return x.shape == self.shape and bool(
            (x >= self.low).all() and (x <= self.high).all()
        )

    def __repr__(self):
        return f"Box({self.low}, {self.high}, {self.shape})"


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """Series of discrete sub-spaces given as (min, max) inclusive ranges —
    the vendored old-gym space (multi_discrete.py:9-44). Like the
    reference, a sample is a vector with one integer per sub-space; the
    env also accepts the concatenated one-hot format that ``_set_action``
    splits by sub-space size (environment.py:148-155)."""

    low: tuple[int, ...]
    high: tuple[int, ...]

    @classmethod
    def of(cls, ranges):
        return cls(tuple(int(r[0]) for r in ranges), tuple(int(r[1]) for r in ranges))

    @property
    def num_discrete_space(self) -> int:
        return len(self.low)

    @property
    def sizes(self) -> tuple[int, ...]:
        """Per-sub-space one-hot segment widths (high - low + 1)."""
        return tuple(h - l + 1 for l, h in zip(self.low, self.high))

    def sample(self, generator):
        """An int32 vector, each entry in its sub-space's ``[low, high]``."""
        return torch.stack([torch.randint(lo, hi + 1, (), generator=generator,
                                          device=generator.device, dtype=torch.int32)
                            for lo, hi in zip(self.low, self.high)])

    def contains(self, x):
        x = to_host(x)
        return (
            x.shape == (len(self.low),)
            and bool((x >= np.asarray(self.low)).all())
            and bool((x <= np.asarray(self.high)).all())
        )

    def __repr__(self):
        return f"MultiDiscrete{self.num_discrete_space}"


@dataclasses.dataclass(frozen=True)
class Tuple(Space):
    """Product of sub-spaces (gym.spaces.Tuple equivalent;
    environment.py:63)."""

    spaces: tuple[Space, ...]

    def sample(self, generator):
        """One sample per sub-space, drawn in order from ``generator``."""
        return tuple(s.sample(generator) for s in self.spaces)

    def contains(self, x):
        return len(x) == len(self.spaces) and all(
            s.contains(v) for s, v in zip(self.spaces, x)
        )

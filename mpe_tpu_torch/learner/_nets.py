"""Shared tiny-MLP building blocks for the learners (counterpart of
``mpe_tpu/learner/_nets.py``)."""

from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, n_in: int, n_out: int, dtype=torch.float32,
               scale=None) -> dict[str, torch.Tensor]:
    """He-scaled dense layer params ``{w [n_in, n_out], b [n_out]}`` on the
    generator's device; pass ``scale`` to override (0.01 for near-zero policy
    heads). The normals come from ``generator``, so they differ from JAX's
    for the same seed: tests carry weights across with
    ``convert.params_from_numpy``."""
    s = math.sqrt(2.0 / n_in) if scale is None else scale
    w = torch.randn((n_in, n_out), generator=generator, dtype=dtype, device=generator.device)
    return {"w": w * s, "b": torch.zeros(n_out, dtype=dtype, device=generator.device)}

"""Scenario registry of the port: the scenarios ported so far.

``load`` accepts names with or without the legacy ``.py`` suffix
(reference make_env.py:36). An unported name raises ``KeyError`` listing
what is available; the JAX package holds all nine.
"""

from __future__ import annotations

import importlib

from mpe_tpu_torch.scenarios._base import Scenario

# name -> (module, class); modules imported lazily
_REGISTRY: dict[str, tuple[str, str]] = {
    "simple_spread": ("mpe_tpu_torch.scenarios.simple_spread", "SimpleSpreadScenario"),
}


def names() -> list[str]:
    return sorted(_REGISTRY)


def load(name: str) -> Scenario:
    """Instantiate a scenario by name (``'simple_spread'`` or
    ``'simple_spread.py'``)."""
    key = name[:-3] if name.endswith(".py") else name
    if key not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported scenario {name!r}; available: {names()}")
    module, cls = _REGISTRY[key]
    return getattr(importlib.import_module(module), cls)()


__all__ = ["Scenario", "load", "names"]

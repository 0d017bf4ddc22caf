"""Scenario registry of the port: the nine published MPE scenarios.

``load`` accepts names with or without the legacy ``.py`` suffix
(reference make_env.py:36). An unknown name raises ``KeyError`` listing
what is available.
"""

from __future__ import annotations

import importlib

from mpe_tpu_torch.scenarios._base import Scenario

# name -> (module, class); modules imported lazily
_REGISTRY: dict[str, tuple[str, str]] = {
    "simple": ("mpe_tpu_torch.scenarios.simple", "SimpleScenario"),
    "simple_adversary": ("mpe_tpu_torch.scenarios.simple_adversary", "SimpleAdversaryScenario"),
    "simple_crypto": ("mpe_tpu_torch.scenarios.simple_crypto", "SimpleCryptoScenario"),
    "simple_push": ("mpe_tpu_torch.scenarios.simple_push", "SimplePushScenario"),
    "simple_reference": ("mpe_tpu_torch.scenarios.simple_reference", "SimpleReferenceScenario"),
    "simple_speaker_listener": ("mpe_tpu_torch.scenarios.simple_speaker_listener",
                                "SimpleSpeakerListenerScenario"),
    "simple_spread": ("mpe_tpu_torch.scenarios.simple_spread", "SimpleSpreadScenario"),
    "simple_tag": ("mpe_tpu_torch.scenarios.simple_tag", "SimpleTagScenario"),
    "simple_world_comm": ("mpe_tpu_torch.scenarios.simple_world_comm",
                          "SimpleWorldCommScenario"),
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

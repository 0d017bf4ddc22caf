"""Device resolution shared by every public entry point of the port.

``device=None`` means the CUDA card. When no card is visible the entry
points raise instead of quietly running on the CPU; callers that want the
CPU (the tests, the plain reference paths) ask for it by name.
"""

from __future__ import annotations

import numpy as np
import torch

_TABLES: dict[tuple, torch.Tensor] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and none
    is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mpe_tpu_torch: no CUDA device is visible. The port runs on the "
            "card by default and never falls back to the CPU on its own; "
            "pass device='cpu' to run the plain PyTorch path explicitly.")
    return dev


def device_table(values, dtype=None, device=None) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and then reused. The generic engine reads the
    spec's per-entity tables in every step; made anew each time, every one
    is a copy from pageable host memory that makes the host wait for the
    stream. The tensor is shared: never write to it in place."""
    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype,
           None if device is None else torch.device(device))
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(arr, dtype=dtype, device=device)
    return table


def to_host(x) -> np.ndarray:
    """``np.asarray(x)``, for a tensor on any device too (numpy refuses a
    CUDA tensor: it is copied to the host first)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the port's
    stand-in for a ``jax.random.PRNGKey``)."""
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(seed))

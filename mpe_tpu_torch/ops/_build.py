"""Build and load the port's CUDA kernels.

Each source under ``mpe_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
libraries go into ``build/kernels/`` beside the package at first use; the
sources build in parallel, and each is rebuilt only when it, the shared
header or the flags change (the file name carries their hash).
``-fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise ops round them, so a kernel can be held tightly
against its plain version.

Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mpe_kernels.cu", "mpe_policy.cu", "mpe_update.cu")
HEADERS = ("spread_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _target(source: str) -> Path:
    src = CSRC / source
    text = src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns ``{source: ptxas log}`` (the
    registers and spills of each kernel; empty for a cached library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in SOURCES:
        out = _target(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[source] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {source: "" for source in SOURCES}
    failed = []
    for source, (out, tmp, proc) in procs.items():
        logs[source], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{logs[source]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# argtypes of each library's C functions (all return a cudaError_t as int)
SIGNATURES = {
    "mpe_kernels.cu": {
        "mpe_spread_rollout_a3l3c2": [_P] * 5 + [_I] * 4 + [_U, _U, _P],
        "mpe_spread_det_rollout_a3l3c2": [_P] * 8 + [_I] * 3 + [_P],
    },
    "mpe_policy.cu": {
        "mpe_spread_policy_traj_a3l3": [_P] * 6 + [_I] * 5 + [_U, _U, _P],
        "mpe_spread_policy_rollout_a3l3": [_P] * 5 + [_I] * 4 + [_U, _U, _P],
    },
    "mpe_update.cu": {
        "mpe_ppo_update_h64": [_P] * 9 + [_I] * 3 + [_F] * 6 + [_P],
        "mpe_ppo_update_packed_size": [],
    },
}


@functools.cache
def library(source: str = "mpe_kernels.cu") -> ctypes.CDLL:
    """The loaded library of one source under ``csrc/`` (every source is
    built first if needed)."""
    build_all()
    lib = ctypes.CDLL(str(_target(source)))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    if source == "mpe_kernels.cu":
        lib.mpe_cuda_error_string.argtypes = [_I]
        lib.mpe_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return f"cudaError {code} ({library().mpe_cuda_error_string(code).decode()})"


@functools.cache
def _params_type(a: int) -> type:
    """ctypes mirror of ``SpreadParams<A, L>`` in ``mpe_kernels.cu``."""
    f = ctypes.c_float

    class SpreadParams(ctypes.Structure):
        _fields_ = [
            ("accel", f * a), ("dmin", f * (a * a)), ("coll_thresh2", f * (a * a)),
            ("keep_vel", f), ("dt", f), ("contact_force", f), ("contact_margin", f),
            ("agent_range", f), ("landmark_range", f),
        ]

    return SpreadParams


def spread_params(kscn):
    """The kernel's constants for a simple_spread-shaped kernel scenario.

    Every constant is computed in double and rounded once to float32, as
    the JAX kernels bake Python floats into float32 arithmetic. Raises
    ``NotImplementedError`` for a spec outside what the kernels implement:
    3 movable agents of unit mass and no speed limit, all colliding with
    each other, 3 fixed landmarks that collide with nothing, dim_p 2,
    dim_c 2."""
    from mpe_tpu_torch.ops.kernel_scenarios import KernelSpread

    spec = kscn.spec
    a, l = spec.n_agents, spec.n_landmarks
    supported = (isinstance(kscn, KernelSpread) and (a, l, spec.dim_p, spec.dim_c) == (3, 3, 2, 2)
                 and spec.movable[:a].all() and not spec.movable[a:].any()
                 and spec.collide[:a].all() and not spec.collide[a:].any()
                 and (spec.initial_mass[:a] == 1.0).all()
                 and not np.isfinite(spec.max_speed[:a]).any())
    if not supported:
        raise NotImplementedError(
            f"the CUDA kernels implement simple_spread's physics only (3 movable colliding "
            f"agents of unit mass and no speed limit, 3 fixed landmarks, dim_p=2, dim_c=2); "
            f"got {spec.name!r} with {a} agents, {l} landmarks, masses "
            f"{spec.initial_mass[:a].tolist()}, max_speed {spec.max_speed[:a].tolist()}")
    params = _params_type(a)()
    for i in range(a):
        params.accel[i] = float(spec.accel[i])
        for j in range(a):
            dmin = float(spec.size[i] + spec.size[j])
            params.dmin[i * a + j] = dmin
            params.coll_thresh2[i * a + j] = dmin ** 2
    params.keep_vel = 1.0 - float(spec.damping)
    params.dt = float(spec.dt)
    params.contact_force = float(spec.contact_force)
    params.contact_margin = float(spec.contact_margin)
    params.agent_range, params.landmark_range = (float(r) for r in kscn.reset_ranges())
    return params

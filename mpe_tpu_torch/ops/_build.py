"""Build and load the port's CUDA kernels.

Each source under ``mpe_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
libraries go into ``build/kernels/`` beside the package at first use; the
sources build in parallel, and each is rebuilt only when it, the shared
header or the flags change (the file name carries their hash). The sources
of K4-K9 and of K6-bf16, K7-bf16 and K9-bf16 (``HIDDEN_SOURCES``) take the MLPs' hidden
width at compile time (``-DMPE_HIDDEN``): one library per (source, width) of
that source's row of ``HIDDEN_WIDTHS``, built at the first use of that width;
``build_all`` builds every source at width 64.
``spread_params`` and ``scenario_params`` fill the kernels' constant structs.
``-fmad=false`` keeps every multiply and add separately rounded, as
PyTorch's elementwise ops round them, so a kernel can be held tightly
against its plain version.

Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("mpe_kernels.cu", "mpe_policy.cu", "mpe_update.cu", "mpe_maddpg.cu",
           "mpe_trajectory.cu", "mpe_update_bf16.cu", "mpe_maddpg_bf16.cu")
HEADERS = ("spread_common.cuh", "policy_mlp.cuh", "scenario_blocks.cuh", "bf16_mma.cuh",
           "wide_stream.cuh", "bf16_wide.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# the sources whose kernels run an MLP (K4, K5; K6, K7; K8, K9; K6-bf16,
# K7-bf16; K9-bf16) and the hidden widths each is compiled for (each source's
# static_assert on MPE_HIDDEN lists the same), and the width a plain build takes
HIDDEN_WIDTHS = {
    "mpe_policy.cu": (8, 16, 32, 64, 128, 256),
    "mpe_update.cu": (8, 16, 32, 64, 128, 256),
    "mpe_maddpg.cu": (8, 16, 32, 64, 128, 256),
    "mpe_update_bf16.cu": (8, 16, 32, 64, 128, 256),
    "mpe_maddpg_bf16.cu": (8, 16, 32, 64, 128, 256),
}
HIDDEN_SOURCES = tuple(HIDDEN_WIDTHS)
DEFAULT_HIDDEN = 64


def check_hidden(hidden: int, what: str, source: str) -> int:
    """``hidden`` if ``source``'s kernels are compiled for it, else
    ``NotImplementedError`` naming the widths that source takes."""
    if hidden not in HIDDEN_WIDTHS[source]:
        raise NotImplementedError(f"{what} (csrc/{source}) are compiled for hidden widths "
                                  f"{', '.join(map(str, HIDDEN_WIDTHS[source]))}; got {hidden}")
    return int(hidden)


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _flags(source: str, hidden: int) -> tuple:
    if hidden != DEFAULT_HIDDEN:
        if source not in HIDDEN_SOURCES:
            raise ValueError(f"{source} has no hidden width; only {HIDDEN_SOURCES} take one")
        check_hidden(hidden, "the MLP kernels", source)
        return NVCC_FLAGS + (f"-DMPE_HIDDEN={hidden}",)
    return NVCC_FLAGS


def _target(source: str, hidden: int = DEFAULT_HIDDEN) -> Path:
    """The library of ``source`` at ``hidden``: its name carries a hash of the
    source, the headers and the flags (the width among them, except at the
    default 64)."""
    src = CSRC / source
    text = src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(_flags(source, hidden)).encode()).hexdigest()[:16]
    width = "" if hidden == DEFAULT_HIDDEN else f"_h{hidden}"
    return BUILD_DIR / f"lib{src.stem}{width}_{digest}.so"


# the seconds each ``nvcc`` of the last ``build`` took, by (source, hidden),
# from its start to its end (they run side by side)
COMPILE_SECONDS: dict = {}


def build(pairs) -> dict:
    """Compile every ``(source, hidden)`` of ``pairs`` whose library is
    missing, one ``nvcc`` each, all started together. Returns ``{(source,
    hidden): ptxas log}`` (the registers and spills of each kernel; empty for
    a cached library); ``COMPILE_SECONDS`` holds each compile's seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pairs = list(dict.fromkeys(pairs))
    procs = {}
    for source, hidden in pairs:
        out = _target(source, hidden)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[source, hidden] = (out, tmp, time.perf_counter(), subprocess.Popen(
            [nvcc(), *_flags(source, hidden), "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def finish(job):
        start, proc = job[2], job[3]
        log, _ = proc.communicate()
        return log, time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = dict(zip(procs, pool.map(finish, procs.values())))
    COMPILE_SECONDS.clear()
    logs = {pair: "" for pair in pairs}
    failed = []
    for pair, (out, tmp, _, proc) in procs.items():
        logs[pair], COMPILE_SECONDS[pair] = done[pair]
        if proc.returncode != 0:
            failed.append(f"{pair[0]} (hidden {pair[1]}):\n{logs[pair]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def build_all(hidden_widths=()) -> dict:
    """Compile every source at width 64 and each MLP source at each of
    ``hidden_widths`` that it takes too, all at once (``build``). Returns
    ``{source: ptxas log}`` of the width-64 builds, and ``{(source, hidden):
    log}`` of the others."""
    pairs = [(source, DEFAULT_HIDDEN) for source in SOURCES]
    pairs += [(source, h) for h in hidden_widths if h != DEFAULT_HIDDEN
              for source in HIDDEN_SOURCES if h in HIDDEN_WIDTHS[source]]
    logs = build(pairs)
    return {(source if hidden == DEFAULT_HIDDEN else (source, hidden)): log
            for (source, hidden), log in logs.items()}


_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# argtypes of each library's C functions (all return a cudaError_t as int)
SIGNATURES = {
    "mpe_kernels.cu": {
        "mpe_det_rollout": [_I] + [_P] * 10 + [_I] * 4 + [_P],
        "mpe_scenario_rollout": [_I] + [_P] * 5 + [_I] * 4 + [_U, _U, _I, _P],
    },
    "mpe_policy.cu": {
        "mpe_policy_traj": [_I] + [_P] * 7 + [_I] * 5 + [_U, _U, _I, _P],
        "mpe_policy_rollout": [_I] + [_P] * 5 + [_I] * 4 + [_U, _U, _I, _P],
        "mpe_policy_ctas_per_sm": [_I] * 3,
    },
    "mpe_update.cu": {
        "mpe_ppo_update": [_I] * 2 + [_P] * 10 + [_I] * 5 + [_F] * 6 + [_P],
        "mpe_mappo_update": [_I] * 2 + [_P] * 11 + [_I] * 5 + [_F] * 7 + [_P],
        "mpe_update_packed_size": [_I] * 2,
        "mpe_update_smem": [_I] * 3,
    },
    "mpe_update_bf16.cu": {                 # mpe_update.cu's C entries, and the wide grid's
        "mpe_ppo_update": [_I] * 2 + [_P] * 10 + [_I] * 5 + [_F] * 6 + [_P],
        "mpe_mappo_update": [_I] * 2 + [_P] * 11 + [_I] * 5 + [_F] * 7 + [_P],
        "mpe_update_packed_size": [_I] * 2,
        "mpe_update_smem": [_I] * 3,
        "mpe_update_scratch": [_I] * 3,
        "mpe_update_grid": [_I] * 3,
    },
    "mpe_maddpg.cu": {
        "mpe_maddpg_traj": [_I] + [_P] * 7 + [_I] * 5 + [_F, _U, _U, _I, _P],
        "mpe_maddpg_traj_ctas_per_sm": [_I] * 2,
        "mpe_maddpg_update": [_I] + [_P] * 7 + [_I] + [_F] * 3 + [_P],
        "mpe_maddpg_update_layout": [_I, _I],
        "mpe_maddpg_update_smem": [_I, _I],
    },
    "mpe_maddpg_bf16.cu": {                 # mpe_maddpg.cu's K9 entries
        "mpe_maddpg_update": [_I] + [_P] * 7 + [_I] + [_F] * 3 + [_P],
        "mpe_maddpg_update_layout": [_I, _I],
        "mpe_maddpg_update_smem": [_I, _I],
    },
    "mpe_trajectory.cu": {
        "mpe_trajectory": [_I] + [_P] * 6 + [_I] * 5 + [_U, _U, _I, _P],
    },
}

# the scenario argument of every C entry but mpe_update.cu's
# (csrc/scenario_blocks.cuh::MPE_SCENARIO_SWITCH): kernel-scenario class -> id
SCENARIO_IDS = {"KernelSpread": 0, "KernelSimple": 1, "KernelReference": 2,
                "KernelSpeakerListener": 3, "KernelAdversary": 4, "KernelPush": 5,
                "KernelCrypto": 6, "KernelTag": 7, "KernelWorldComm": 8}
# what each block instantiation is compiled for: (agents, landmarks, dim_c,
# goal choices, collide pairs); the pairs are the constexpr tables of the
# structs in csrc/scenario_blocks.cuh
_TAG_PAIRS = tuple((i, j) for i in range(6) for j in range(i + 1, 6) if i < 4)
_WORLD_COMM_PAIRS = tuple((i, j) for i in range(7) for j in range(i + 1, 7))
_BLOCK_SHAPES = {"KernelSimple": (1, 1, 0, (), ()), "KernelReference": (2, 3, 10, (3, 3), ()),
                 "KernelSpeakerListener": (2, 3, 3, (3,), ()),
                 "KernelAdversary": (3, 2, 2, (2,), ()), "KernelPush": (2, 2, 2, (2,), ((0, 1),)),
                 "KernelCrypto": (3, 2, 4, (2, 2), ()), "KernelTag": (4, 2, 2, (), _TAG_PAIRS),
                 "KernelWorldComm": (6, 5, 4, (), _WORLD_COMM_PAIRS)}


@functools.cache
def library(source: str = "mpe_kernels.cu", hidden: int = DEFAULT_HIDDEN) -> ctypes.CDLL:
    """The loaded library of one source under ``csrc/`` at hidden width
    ``hidden`` (an MLP source's; the others take 64 only). The first call
    builds every source at 64 if needed, a call at another width the MLP
    sources that take that width."""
    _flags(source, hidden)
    if hidden == DEFAULT_HIDDEN:
        build_all()
    else:
        build([(s, hidden) for s in HIDDEN_SOURCES if hidden in HIDDEN_WIDTHS[s]])
    lib = ctypes.CDLL(str(_target(source, hidden)))
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


@functools.cache
def _phys_params_type(a: int, k: int, t: int) -> type:
    """ctypes mirror of ``PhysParams<A, K, T>`` in ``scenario_blocks.cuh``."""
    f, i = ctypes.c_float, ctypes.c_int

    class PhysParams(ctypes.Structure):
        _fields_ = [
            ("accel", f * a), ("movable", i * a), ("silent", i * a), ("keep_vel", f), ("dt", f),
            ("agent_range", f), ("landmark_range", f), ("inv_mass_dt", f * a),
            ("max_speed", f * a), ("max_speed2", f * a), ("dmin", f * max(k, 1)),
            ("contact_force", f), ("contact_margin", f), ("thresh2", f * max(t, 1)),
        ]

    return PhysParams


def _thresholds(kind: str, spec) -> list[float]:
    """The squared thresholds ``(size_i + size_j)^2`` that an instantiation's
    reward and obs compare with, in double, in its ``thresh2`` layout:
    simple_tag predator i vs the prey; simple_world_comm (good g,
    adversary v), (good g, food f) and (agent i, forest f), each row-major."""
    size = [float(x) for x in spec.size]
    a = spec.n_agents
    if kind == "KernelTag":
        return [(size[i] + size[a - 1]) ** 2 for i in range(a - 1)]
    if kind == "KernelWorldComm":
        return ([(size[4 + g] + size[v]) ** 2 for g in range(2) for v in range(4)]
                + [(size[4 + g] + size[a + f]) ** 2 for g in range(2) for f in (1, 2)]
                + [(size[i] + size[a + f]) ** 2 for i in range(a) for f in (3, 4)])
    return []


# simple_world_comm's roles, which its device functions hard-code
_WORLD_COMM_ROLES = ((True,) * 4 + (False,) * 2, (True,) + (False,) * 5)


def scenario_params(kscn):
    """The constants of a scenario's block instantiation (``PhysParams`` in
    ``csrc/scenario_blocks.cuh``), each computed in double and rounded once
    to float32, as ``spread_params``'s: ``dt / mass``, ``max_speed`` and its
    square (taken in float32, as ``mxu_physics_block`` squares it), the pair
    distances ``size_i + size_j`` and the thresholds.

    Raises ``NotImplementedError`` for a spec outside what the kernels
    compute: a shape or a collide-pair list other than the instantiation's, a
    movable landmark, a ``dim_p`` other than 2; a finite ``max_speed`` below
    ``MIN_MXU_PAIRS`` pairs (``generic_physics`` has no clamp); and other
    roles than simple_world_comm's."""
    from mpe_tpu_torch.ops.kernel_scenarios import collide_pairs

    spec = kscn.spec
    a, l = spec.n_agents, spec.n_landmarks
    kind = type(kscn).__name__
    pairs = tuple(collide_pairs(spec))
    shape = (a, l, spec.dim_c, tuple(kscn.goal_choices), pairs)
    problems = []
    if _BLOCK_SHAPES.get(kind) != shape:
        problems.append(f"{kind} with (agents, landmarks, dim_c, goals, collide pairs) {shape}")
    if spec.movable[a:].any() or spec.dim_p != 2:
        problems.append(f"movable landmarks or dim_p={spec.dim_p}")
    if np.isfinite(spec.max_speed).any() and len(pairs) < kscn.MIN_MXU_PAIRS:
        problems.append(f"max_speed {spec.max_speed.tolist()} without the pair physics")
    if kind == "KernelWorldComm" and (tuple(spec.adversary), tuple(spec.leader)) != _WORLD_COMM_ROLES:
        problems.append(f"adversaries {spec.adversary.tolist()}, leaders {spec.leader.tolist()}")
    if problems:
        raise NotImplementedError(
            f"the CUDA kernels compute the nine scenarios as published only (their shapes "
            f"and collide pairs, fixed landmarks, dim_p=2; no speed limit below "
            f"{kscn.MIN_MXU_PAIRS} collide pairs); got {spec.name!r} with " + "; ".join(problems))
    thresh2 = _thresholds(kind, spec)
    params = _phys_params_type(a, len(pairs), len(thresh2))()
    for i in range(a):
        ms = float(spec.max_speed[i])
        params.accel[i] = float(spec.accel[i])
        params.movable[i] = int(spec.movable[i])
        params.silent[i] = int(spec.silent[i])
        params.inv_mass_dt[i] = float(spec.dt) / float(spec.initial_mass[i])
        params.max_speed[i] = ms
        params.max_speed2[i] = float(np.float32(ms) * np.float32(ms))
    for k, (i, j) in enumerate(pairs):
        params.dmin[k] = float(spec.size[i] + spec.size[j])
    params.contact_force = float(spec.contact_force)
    params.contact_margin = float(spec.contact_margin)
    for k, x in enumerate(thresh2):
        params.thresh2[k] = x
    params.keep_vel = 1.0 - float(spec.damping)
    params.dt = float(spec.dt)
    params.agent_range, params.landmark_range = (float(r) for r in kscn.reset_ranges())
    return params


def kernel_params(kscn):
    """``(scenario id, constants)`` of a kernel scenario for K1
    (``mpe_det_rollout``), K2 (``mpe_scenario_rollout``), K3
    (``mpe_trajectory``), K4 (``mpe_policy_rollout``), K5
    (``mpe_policy_traj``) and K8 (``mpe_maddpg_traj``); K9
    (``mpe_maddpg_update``) takes the id alone."""
    kind = type(kscn).__name__
    if kind not in SCENARIO_IDS:
        raise NotImplementedError(f"no CUDA instantiation for {kind} ({kscn.spec.name!r}); "
                                  f"the kernels take {sorted(SCENARIO_IDS)}")
    params = spread_params(kscn) if kind == "KernelSpread" else scenario_params(kscn)
    return SCENARIO_IDS[kind], params

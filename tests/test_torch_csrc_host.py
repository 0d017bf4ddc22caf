"""The CUDA sources of K2 and K3 (``csrc/mpe_kernels.cu``,
``csrc/mpe_trajectory.cu``) compiled for the host by a C++ compiler and held
against their plain versions on the CPU, for every scenario instantiation.

A stand-in ``cuda_runtime.h`` defines the few CUDA names the sources use
(the execution-space keywords as nothing, ``rsqrtf`` as ``1 / sqrtf``,
``__stcs`` as a plain store), and each ``kernel<<<blocks, threads, 0,
stream>>>(...)`` launch becomes a loop over (block, thread). This checks the
device functions' indexing, order of operations and RNG streams without a
card. The arithmetic is the host's (its libm and an exact reciprocal square
root), not the card's, so actions (raw hash draws) are held equal and the
rest within float32 tolerances; on the card ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels to the bit. Without a C++ compiler the
tests skip.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

from mpe_tpu_torch.ops import _build
from mpe_tpu_torch.ops.fused_rollout import plain_rollout
from mpe_tpu_torch.ops.fused_trajectory import plain_trajectory
from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

NAMES = ["simple_spread", "simple", "simple_reference", "simple_speaker_listener",
         "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm"]
N_ENVS, BLOCK_ENVS, HORIZON = 256, 128, 10
F32_TOL = dict(rtol=1e-5, atol=1e-5)

CUDA_RUNTIME = """\
#pragma once
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <math.h>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
struct host_dim3 { unsigned x = 0, y = 0, z = 0; };
inline host_dim3 blockIdx, threadIdx, blockDim;
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
"""
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(\w+), (\w+), 0, stream>>>\((.*?)\);", re.S)


def _loop(match) -> str:
    kernel, blocks, threads, args = match.groups()
    return (f"for (unsigned b_ = 0; b_ < (unsigned)({blocks}); ++b_) "
            f"for (unsigned t_ = 0; t_ < (unsigned)({threads}); ++t_) {{ blockIdx.x = b_; "
            f"threadIdx.x = t_; blockDim.x = {threads}; {kernel}({args}); }}")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) to build the CUDA sources for the host")
    out = tmp_path_factory.mktemp("csrc_host")
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    for header in _build.HEADERS:
        shutil.copy(_build.CSRC / header, out / header)
    libs = {}
    for source in ("mpe_kernels.cu", "mpe_trajectory.cu"):
        cpp = out / f"{source}.cpp"
        cpp.write_text(LAUNCH.sub(_loop, (_build.CSRC / source).read_text()))
        lib = out / f"lib{source}.so"
        subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-w",
                        "-shared", "-fPIC", "-I", str(out), "-o", str(lib), str(cpp)], check=True)
        libs[source] = ctypes.CDLL(str(lib))
        for name, argtypes in _build.SIGNATURES[source].items():
            getattr(libs[source], name).argtypes = argtypes
            getattr(libs[source], name).restype = ctypes.c_int
    return libs


def _close(got, ref, label):
    for k, a, b in zip(label, got, ref):
        tol = dict(rtol=0, atol=0) if k == "act" else F32_TOL
        torch.testing.assert_close(a, b, msg=k, **tol)


# generic_physics divides each agent's force by its own mass (dt / mass
# rounded once), as generic_physics_block does: two cases with other masses
ROLLOUT_CASES = ([pytest.param(name, None, id=name) for name in NAMES]
                 + [pytest.param(name, [2.5, 0.75], id=f"{name}-masses")
                    for name in ("simple_reference", "simple_push")])


@pytest.mark.parametrize("name, masses", ROLLOUT_CASES)
def test_host_built_rollout_kernel_matches_plain(host_libs, name, masses):
    """K2 (``mpe_scenario_rollout``) over 30 steps with resets, two RNG blocks
    at block offset 1; the obs checksum within 1e-5 of its largest."""
    kscn = kernel_scenario(name)
    spec = kscn.spec
    if masses is not None:
        mass = spec.initial_mass.copy()
        mass[:spec.n_agents] = masses
        spec = dataclasses.replace(spec, initial_mass=mass)
        kscn = type(kscn)(spec)
    scenario, params = _build.kernel_params(kscn)
    shapes = ((spec.n_entities, 2, N_ENVS),) * 2 + ((kscn.reward_rows, N_ENVS), (1, N_ENVS))
    got = [torch.empty(s) for s in shapes]
    rc = host_libs["mpe_kernels.cu"].mpe_scenario_rollout(
        scenario, ctypes.byref(params), *(x.data_ptr() for x in got), N_ENVS, BLOCK_ENVS, 30,
        HORIZON, 7, 1, None)
    assert rc == 0
    ref = plain_rollout(kscn, N_ENVS, 30, HORIZON, BLOCK_ENVS, 7, 1, "cpu")
    _close(got[:3], ref[:3], ("pos", "vel", "rew_sum"))
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-5 * float(ref[3].abs().max()),
                               msg="obs_sum")


@pytest.mark.parametrize("name", NAMES)
def test_host_built_trajectory_kernel_matches_plain(host_libs, name):
    """K3 (``mpe_trajectory``) over 24 steps in chunks of 4 with resets, two
    RNG blocks at block offset 1."""
    kscn = kernel_scenario(name)
    scenario, params = _build.kernel_params(kscn)
    spec = kscn.spec
    a, n_steps, t_chunk = spec.n_agents, 24, 4
    dim_c = spec.dim_c if kscn.uses_comm else 0
    shapes = ((n_steps, a, kscn.obs_w, N_ENVS), (n_steps, a, 5 + dim_c, N_ENVS),
              (n_steps, kscn.reward_rows, N_ENVS)) + ((spec.n_entities, 2, N_ENVS),) * 2
    got = [torch.empty(s) for s in shapes]
    rc = host_libs["mpe_trajectory.cu"].mpe_trajectory(
        scenario, ctypes.byref(params), *(x.data_ptr() for x in got), N_ENVS, BLOCK_ENVS,
        n_steps // t_chunk, t_chunk, HORIZON, 3, 1, None)
    assert rc == 0
    ref = plain_trajectory(kscn, N_ENVS, n_steps, HORIZON, BLOCK_ENVS, t_chunk, 3, 1, "cpu")
    _close(got, ref, ("obs", "act", "rew", "pos", "vel"))

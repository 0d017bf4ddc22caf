"""The host build of the port's CUDA sources (``mpe_tpu_torch/csrc/``) that
the ``test_torch_*_host.py`` files share, at a hidden width of the MLP
sources' (``-DMPE_HIDDEN``, as ``ops/_build.py`` builds them for the card).

A stand-in ``cuda_runtime.h`` defines the few CUDA names the sources use
(the execution-space keywords as nothing, ``__shared__`` as a static,
``rsqrtf`` as ``1 / sqrtf``, ``__stcs`` as a plain store, ``float4``, ``dim3``),
and each ``kernel<<<blocks, threads, smem, stream>>>(...)`` launch runs its
blocks one after another on the calling thread. A block's threads are
cooperative fibers, each on a stack of its own, that one host thread runs in
turn: a fiber runs until it waits at ``__syncthreads()`` (a barrier of the
whole block) or ``__syncwarp()`` (a barrier of the thread's warp, 32
consecutive threads) and then hands over to the next; ``__shfl_sync`` and
``__shfl_xor_sync`` exchange values through the warp's barrier. The order in
which the fibers run is fixed, so a launch does the same thing every time, and
a block whose fibers all wait at barriers that can never open aborts with a
message. A kernel's dynamic shared memory becomes one static buffer. A cluster
kernel (``host_cluster_size`` set before its launch) runs the blocks of each
cluster together, their threads' fibers interleaved, each block with its own
shared memory (``host_block_smem``, ``host_map_rank``) and the cluster's
split barrier (``HostSplitBarrier``); shuffle, warp and mma slots are the
fiber's. The occupancy query answers 1 (one block at a time) and the card has
``HOST_SMS`` SMs (or the ``sms`` a build asks for). For the bf16 kernels it
has ``__nv_bfloat16`` with the device's round-to-nearest-even conversion and
``host_mma_m16n8k16_bf16``, the m16n8k16 bf16 ``mma.sync`` over the warp's
fragments as the PTX ISA lays them out (each product exact, the sums in
double); for the float32 wide kernel ``host_cvt_rna_tf32``
(``cvt.rna.tf32.f32``) and ``host_mma_m16n8k8_tf32``, the m16n8k8 tf32
``mma.sync`` by the same rule; for K9's wide kernels an mbarrier
(``host_mbar_init``, ``host_mbar_arrive`` with the bytes it expects,
``host_mbar_wait`` on a phase's parity, yielding until it completes) and
``host_bulk_load``, a ``cp.async.bulk`` that lands when it is issued and
counts its bytes on the barrier.

Each library is built once per (source, width, flags, stand-in header): into
a directory under ``build/host/`` named by a hash of all of them and of the
headers, under a file lock, so that the test files and the xdist workers of
one run share it.
"""

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from mpe_tpu_torch.ops import _build

MAX_SMEM_FLOATS = 232448 // 4          # a CTA's dynamic shared memory on the card
HOST_SMS = 4                           # the stand-in card's SMs
HOST_BUILD_DIR = _build.BUILD_DIR.parent / "host"
CXX_FLAGS = ("-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math", "-w", "-shared", "-fPIC")
CUDA_RUNTIME_TEXT = """\
#pragma once
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <math.h>
#define HOST_SMS @HOST_SMS@
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = HOST_SMS; return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;                          // the host runs one block at a time
  return 0;
}
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct host_dim3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline host_dim3 blockIdx, threadIdx, blockDim, gridDim;   // of the running fiber
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
// A block's threads are fibers that one host thread runs in turn; a fiber
// hands over at a barrier (host_yield). host_fiber_switch saves the running
// stack's callee-saved registers and stack pointer at *save and resumes the
// stack at to.
constexpr size_t HOST_STACK = 256 * 1024;
struct HostFiber {
  void* sp;
  bool done;
};
// a launch's fibers: the threads of one block, or of the blocks of one
// cluster (host_cluster_size of them, set before a cluster kernel's launch),
// fiber f being thread f % blockDim.x of the cluster's block f / blockDim.x
constexpr unsigned HOST_MAX_FIBERS = 1024;
inline unsigned host_cluster_size = 1;
inline unsigned host_fiber_id;
inline std::vector<HostFiber> host_fibers;
inline std::vector<char*> host_stacks;
inline void* host_sched_sp;
inline unsigned host_current;
inline bool host_progress;
inline void (*host_body)(void*);
inline void* host_body_arg;
#if defined(__x86_64__)
extern "C" __attribute__((visibility("hidden"))) void host_fiber_switch(void** save, void* to);
asm(".text\\n.p2align 4\\n.globl host_fiber_switch\\n.hidden host_fiber_switch\\n"
    ".type host_fiber_switch,@function\\nhost_fiber_switch:\\n"
    "pushq %rbp\\npushq %rbx\\npushq %r12\\npushq %r13\\npushq %r14\\npushq %r15\\n"
    "movq %rsp, (%rdi)\\nmovq %rsi, %rsp\\n"
    "popq %r15\\npopq %r14\\npopq %r13\\npopq %r12\\npopq %rbx\\npopq %rbp\\nret\\n"
    ".size host_fiber_switch, .-host_fiber_switch\\n");
#else
#error "the host stand-in's fibers switch stacks on x86-64 only"
#endif
inline void host_yield() { host_fiber_switch(&host_fibers[host_current].sp, host_sched_sp); }
extern "C" inline void host_fiber_entry() {
  host_body(host_body_arg);
  host_fibers[host_current].done = true;
  host_progress = true;
  host_yield();
  std::abort();                      // a finished fiber is never resumed
}
// the block's threads meet here; blocks run one after another
struct HostBarrier {
  unsigned count = 0, waiting = 0, generation = 0;
  void wait() {
    const unsigned gen = generation;
    host_progress = true;
    if (++waiting == count) {
      waiting = 0;
      ++generation;
      return;
    }
    do host_yield(); while (gen == generation);
  }
};
inline HostBarrier host_block_barriers[HOST_MAX_FIBERS / 32];
inline void __syncthreads() { host_block_barriers[host_fiber_id / blockDim.x].wait(); }
// a warp's lanes (32 consecutive threads) meet at their warp's barrier
inline HostBarrier host_warp_barriers[HOST_MAX_FIBERS / 32];
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp_barriers[host_fiber_id / 32].wait(); }
inline unsigned long long host_lanes[HOST_MAX_FIBERS];
template <class T> inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "a shuffled value fits a slot");
  std::memcpy(&host_lanes[host_fiber_id], &v, sizeof(T));
  __syncwarp();
  T out;
  std::memcpy(&out, &host_lanes[(host_fiber_id & ~(unsigned)(width - 1)) + (unsigned)src], sizeof(T));
  __syncwarp();
  return out;
}
// the cluster's split barrier (barrier.cluster.arrive / .wait): a fiber's
// wait returns once every fiber of the cluster has arrived since its own arrive
struct HostSplitBarrier {
  unsigned count = 0, arrived = 0, generation = 0, mine[HOST_MAX_FIBERS] = {};
  void arrive() {
    mine[host_fiber_id] = generation;
    host_progress = true;
    if (++arrived == count) {
      arrived = 0;
      ++generation;
    }
  }
  void wait() {
    while (mine[host_fiber_id] == generation) host_yield();
  }
};
inline HostSplitBarrier host_cluster_barrier;
inline unsigned host_cluster_rank() { return host_fiber_id / blockDim.x; }
// each block of a cluster has its own dynamic shared memory (a cluster kernel
// takes it from here; its peers' through host_map_rank)
alignas(16) inline float host_cluster_smem[8][232448 / 4];
inline float* host_block_smem() { return host_cluster_smem[host_cluster_rank()]; }
template <class T> inline T* host_map_rank(T* p, unsigned rank) {
  return reinterpret_cast<T*>(reinterpret_cast<char*>(p) -
                              reinterpret_cast<char*>(host_block_smem()) +
                              reinterpret_cast<char*>(host_cluster_smem[rank]));
}
template <class T> inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask, int width = 32) {
  return __shfl_sync(mask, v, (int)((threadIdx.x & (unsigned)(width - 1)) ^ (unsigned)lane_mask),
                     width);
}
// bf16 as cuda_bf16.h gives it: float -> bf16 rounds to nearest even
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40u)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 over the warp's
// fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane 4 g + t
// holds a[0] = A[g][2t, 2t+1], a[1] = A[g+8][..], a[2] = A[g][2t+8, 2t+9],
// a[3] = A[g+8][2t+8, 2t+9], b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g]
// (the lower k in the lower half) and d = D[g][2t, 2t+1], D[g+8][2t, 2t+1];
// each lane's fragments go through the warp's slots, and each output is its
// c plus the 16 exact products, summed in double and rounded once
#define MPE_HOST_MMA 1
struct HostMmaSlot { uint32_t a[4], b[2]; };
inline HostMmaSlot host_mma_slots[HOST_MAX_FIBERS];
inline float host_bf16_float(uint32_t bits) {
  const uint32_t u = (bits & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline void host_mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const unsigned lane = threadIdx.x & 31u, base = host_fiber_id - lane;
  HostMmaSlot& mine = host_mma_slots[host_fiber_id];
  for (int i = 0; i < 4; ++i) mine.a[i] = a[i];
  mine.b[0] = b[0];
  mine.b[1] = b[1];
  __syncwarp();
  const int g = (int)(lane >> 2), t = (int)(lane & 3u);
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double sum = d[i];
    for (int k = 0; k < 16; ++k) {
      const HostMmaSlot& sa = host_mma_slots[base + (row % 8) * 4 + (k % 8) / 2];
      const uint32_t ar = sa.a[(row >= 8) + 2 * (k >= 8)];
      const uint32_t br = host_mma_slots[base + col * 4 + (k % 8) / 2].b[k >= 8];
      sum += (double)host_bf16_float((k & 1) ? ar >> 16 : ar) *
             (double)host_bf16_float((k & 1) ? br >> 16 : br);
    }
    out[i] = (float)sum;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
// cvt.rna.tf32.f32: x rounded to tf32 (10 fraction bits), to nearest with
// ties away from zero, in a 32-bit word whose low 13 bits are zero; NaN and
// infinity pass
inline uint32_t host_cvt_rna_tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 over the warp's
// fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32): lane 4 g + t
// holds a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] = A[g+8][t+4],
// b[0] = B[t][g], b[1] = B[t+4][g] and d = D[g][2t, 2t+1], D[g+8][2t, 2t+1];
// an operand's low 13 bits are not read; each output is its c plus the 8
// exact products, summed in double and rounded once
struct HostTf32Slot { uint32_t a[4], b[2]; };
inline HostTf32Slot host_tf32_slots[HOST_MAX_FIBERS];
inline void host_mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const unsigned lane = threadIdx.x & 31u, base = host_fiber_id - lane;
  HostTf32Slot& mine = host_tf32_slots[host_fiber_id];
  for (int i = 0; i < 4; ++i) mine.a[i] = a[i];
  mine.b[0] = b[0];
  mine.b[1] = b[1];
  __syncwarp();
  const int g = (int)(lane >> 2), t = (int)(lane & 3u);
  auto val = [](uint32_t bits) { return (double)__uint_as_float(bits & 0xffffe000u); };
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double sum = d[i];
    for (int k = 0; k < 8; ++k) {
      const uint32_t ar = host_tf32_slots[base + (row % 8) * 4 + k % 4].a[(row >= 8) + 2 * (k >= 4)];
      const uint32_t br = host_tf32_slots[base + col * 4 + k % 4].b[k >= 4];
      sum += val(ar) * val(br);
    }
    out[i] = (float)sum;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}
// an mbarrier in its 8 bytes of shared memory: the bulk copies' bytes still
// to land (a copy may land before its bytes are expected), the arrivals still
// to come, and the arrivals a phase takes with the current phase's parity in
// its top bit; a phase completes when both counts reach 0
struct HostMbar { int32_t tx; uint16_t pending, count; };
static_assert(sizeof(HostMbar) == 8, "an mbarrier is 8 bytes");
inline void host_mbar_init(uint64_t* bar, unsigned count) {
  *reinterpret_cast<HostMbar*>(bar) = HostMbar{0, (uint16_t)count, (uint16_t)count};
}
inline void host_mbar_complete(uint64_t* bar) {
  HostMbar& m = *reinterpret_cast<HostMbar*>(bar);
  if (m.pending == 0 && m.tx == 0) {
    m.count ^= 0x8000u;
    m.pending = m.count & 0x7fffu;
    host_progress = true;
  }
}
// an arrival, expecting `tx` more bytes of copies in this phase
inline void host_mbar_arrive(uint64_t* bar, int tx) {
  HostMbar& m = *reinterpret_cast<HostMbar*>(bar);
  m.tx += tx;
  --m.pending;
  host_progress = true;
  host_mbar_complete(bar);
}
// mbarrier.try_wait.parity in a loop: returns once the phase of this parity completed
inline void host_mbar_wait(uint64_t* bar, unsigned parity) {
  while ((reinterpret_cast<HostMbar*>(bar)->count >> 15) == parity) host_yield();
}
// cp.async.bulk: the copy lands when it is issued, and its bytes count on bar
inline void host_bulk_load(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  reinterpret_cast<HostMbar*>(bar)->tx -= (int)bytes;
  host_mbar_complete(bar);
}
template <class F> void host_launch(dim3 grid, unsigned block, F body) {
  const unsigned cl = host_cluster_size, threads = cl * block;
  host_cluster_size = 1;
  if (threads > HOST_MAX_FIBERS || grid.x % cl != 0) {
    std::fprintf(stderr, "host_launch: %u blocks of %u threads in clusters of %u\\n", grid.x, block, cl);
    std::abort();
  }
  for (unsigned r = 0; r < cl; ++r) host_block_barriers[r] = HostBarrier{block};
  host_cluster_barrier.count = threads;
  host_cluster_barrier.arrived = 0;
  for (unsigned w = 0; 32 * w < threads; ++w)
    host_warp_barriers[w] = HostBarrier{block - (32 * w) % block < 32 ? block - (32 * w) % block : 32};
  while (host_stacks.size() < threads) host_stacks.push_back(static_cast<char*>(std::malloc(HOST_STACK)));
  host_fibers.assign(threads, HostFiber{nullptr, false});
  host_body = [](void* f) { (*static_cast<F*>(f))(); };
  host_body_arg = &body;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; bx += cl) {
      for (unsigned t = 0; t < threads; ++t) {   // each fiber enters host_fiber_entry
        void** sp = reinterpret_cast<void**>(
            reinterpret_cast<uintptr_t>(host_stacks[t] + HOST_STACK) & ~uintptr_t(15));
        *--sp = nullptr;                         // host_fiber_entry's return address
        *--sp = reinterpret_cast<void*>(&host_fiber_entry);
        for (int r = 0; r < 6; ++r) *--sp = nullptr;
        host_fibers[t] = HostFiber{sp, false};
      }
      blockIdx.y = by;
      blockIdx.z = bz;
      blockDim.x = block;
      gridDim.x = grid.x;
      gridDim.y = grid.y;
      gridDim.z = grid.z;
      for (unsigned live = threads; live > 0;) {
        host_progress = false;
        for (unsigned t = 0; t < threads; ++t) {
          if (host_fibers[t].done) continue;
          blockIdx.x = bx + t / block;
          threadIdx.x = t % block;
          host_fiber_id = t;
          host_current = t;
          host_fiber_switch(&host_sched_sp, host_fibers[t].sp);
          live -= host_fibers[t].done ? 1 : 0;
        }
        if (!host_progress && live > 0) {
          std::fprintf(stderr, "host_launch: block (%u, %u) waits at barriers that never open\\n",
                       bx, by);
          std::abort();
        }
      }
    }
}
"""


def cuda_runtime(sms: int = HOST_SMS) -> str:
    """The stand-in ``cuda_runtime.h`` of a card with ``sms`` SMs."""
    return CUDA_RUNTIME_TEXT.replace("@HOST_SMS@", str(sms))
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?), (\w+), (.*?), stream>>>\((.*?)\);", re.S)
DYNAMIC_SMEM = "extern __shared__ __align__(16) float smem[];"


def _launch(match) -> str:
    kernel, blocks, threads, _, args = match.groups()
    return f"host_launch(dim3({blocks}), (unsigned)({threads}), [&] {{ {kernel}({args}); }});"


def build_host_libs(sources=_build.SOURCES) -> dict:
    """Compile ``sources`` (of ``_build.SOURCES``) for the host at the
    default hidden width, one compiler per source, all started
    together -> {source: ctypes.CDLL} with the C entries' argtypes set. Skips
    the calling test without a C++ compiler."""
    libs = build_host_libs_at([(source, _build.DEFAULT_HIDDEN) for source in sources])
    return {source: lib for (source, _), lib in libs.items()}


def _host_text(source) -> str:
    """The C++ text of ``source`` (a file of ``_build.CSRC`` by name, or a
    path) for the host build: the dynamic shared memory a static buffer, each
    launch a ``host_launch``."""
    path = Path(source) if Path(source).is_absolute() else _build.CSRC / source
    text = path.read_text().replace(
        DYNAMIC_SMEM, f"alignas(16) static float smem[{MAX_SMEM_FLOATS}];")
    return LAUNCH.sub(_launch, text)


def _host_dir(text: str, hidden: int, cxx: str, runtime: str) -> Path:
    """The directory of one host library: a hash of its text, the headers, the
    stand-in header, the compiler and the flags."""
    digest = hashlib.sha256()
    for part in (text, runtime, cxx, " ".join(CXX_FLAGS), str(hidden),
                 *((_build.CSRC / h).read_text() for h in _build.HEADERS)):
        digest.update(part.encode())
        digest.update(b"\0")
    return HOST_BUILD_DIR / digest.hexdigest()[:20]


def build_host_libs_at(pairs, signatures=None, sms: int = HOST_SMS) -> dict:
    """Compile each ``(source, hidden width)`` of ``pairs`` for the host
    (``-DMPE_HIDDEN``), all at once -> {(source, hidden): ctypes.CDLL}. A
    source is a file of ``_build.CSRC`` by name, or a path (a test's own
    source, which may include the headers by name) whose C entries' argtypes
    ``signatures`` gives by file name. Each library is built into its own directory under
    ``HOST_BUILD_DIR`` (``_host_dir``) unless it is there already, under a lock
    that other processes building it wait on (taken in the directories' order,
    so that two processes never wait on each other). ``sms`` is the stand-in
    card's SMs, which sets the persistent grids of the wide kernels."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) to build the CUDA sources for the host")
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    runtime = cuda_runtime(sms)
    texts = {pair: _host_text(pair[0]) for pair in pairs}
    wheres = {pair: _host_dir(text, pair[1], cxx, runtime) for pair, text in texts.items()}
    jobs = {}
    for source, hidden in sorted(pairs, key=lambda pair: wheres[pair]):   # one lock order
        text, where = texts[source, hidden], wheres[source, hidden]
        lib = where / f"lib{Path(source).name}_h{hidden}.so"
        where.mkdir(exist_ok=True)
        lock = open(where / "lock", "w")
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = None
        if not lib.exists():
            (where / "cuda_runtime.h").write_text(runtime)
            for header in _build.HEADERS:
                shutil.copy(_build.CSRC / header, where / header)
            cpp = where / f"{Path(source).name}.cpp"
            cpp.write_text(text)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = (tmp, subprocess.Popen([cxx, *CXX_FLAGS, f"-DMPE_HIDDEN={hidden}", "-I",
                                           str(where), "-o", str(tmp), str(cpp)]))
        jobs[source, hidden] = (lib, lock, proc)
    libs = {}
    for (source, hidden), (lib, lock, proc) in jobs.items():
        if proc is not None:
            tmp, popen = proc
            if popen.wait() == 0:
                os.replace(tmp, lib)
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
        assert lib.exists(), f"the host build of {source} at hidden {hidden} failed"
        libs[source, hidden] = ctypes.CDLL(str(lib))
        sigs = (signatures or {}).get(Path(source).name) or _build.SIGNATURES[source]
        for name, argtypes in sigs.items():
            getattr(libs[source, hidden], name).argtypes = argtypes
            getattr(libs[source, hidden], name).restype = ctypes.c_int
    return libs

// Hopper (sm_90a) kernels of the simple_spread rollout.
//
// K1  spread_det_rollout_kernel  replaces  mpe_tpu/ops/fused_parity.py::_det_kernel
//     (fused_det_rollout): n_steps of generic_physics_block + the spread
//     reward/obs from a given initial state, moves from hash_uniform_2d, no
//     reset. Out: pos, vel [E,P,N], rew_sum, rew_last [1,N], obs_last [A,OW,N].
// K2  spread_rollout_kernel      replaces  mpe_tpu/ops/fused_rollout.py::_generic_rollout_kernel
//     (fused_rollout with KernelSpread): uniform moves from the murmur hash
//     _hash_uniform, physics, reward and obs-checksum accumulation, per-lane
//     reset at the horizon. Out: pos, vel [E,P,N], rew_sum [1,N], obs_sum [1,N].
//
// What bounds them: operation issue, not bytes. K2 reads nothing and writes
// 104 B per env (pos and vel 6x2 floats each, two sums); K1 reads 96 B and
// writes 320 B per env. Against that, one env-step needs (chip_smoke.py::
// OPS, counted from the formulas below) 12 hashes (10 integer operations and
// one int->float conversion each), 3 pair forces (rsqrt, a divide, exp,
// log1p), 9 agent-landmark sqrts and, in K2, the obs sum: 295 fp32, 18
// special-function, 123 integer and 12 conversion operations in K2 (217 fp32
// and 124 integer in K1). Each lane's steps are one dependent chain, so at a
// few thousand envs (one warp per scheduler or less) the time is the chain's
// latency, not the issue rate.
//
// What the design does about it: one thread owns one env lane for the whole
// rollout. Its positions, velocities and accumulators live in registers, the
// step loop runs inside the thread, and device memory is touched only at the
// start (K1's inputs) and the end (the outputs), as the TPU kernel keeps its
// state in VMEM. With one thread per lane the env-minor [.., N] layout gives
// coalesced loads and stores. The entity loops are unrolled over the template
// sizes; reset candidates are stateless hash draws, so a thread computes them
// only for a lane that resets and still gets the values the Pallas kernel drew.
// The library is built with -fmad=false: every multiply and add is rounded
// on its own, as PyTorch's elementwise ops round them, so the kernels agree
// with their plain versions on the card up to the order of the obs sum.
// The kernels implement simple_spread's physics only: every agent collides,
// unit masses (dt/mass = dt) and no speed limit; ops/_build.py::spread_params
// refuses any other spec.
//
// The RNG block (block_envs lanes) is part of each stream's definition: the
// hash indexes the lane within its RNG block, and K2 salts with the global
// RNG block id. It is an argument, independent of the CUDA block size.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 2;             // dim_p
constexpr int MW = 2 * P + 1;    // move row width
constexpr int THREADS = 32;      // see the note on the launch below

template <int A, int L>
struct SpreadParams {            // mirrored by ops/_build.py::_params_type
  float accel[A];                // decode sensitivity
  float dmin[A * A];             // size_i + size_j
  float coll_thresh2[A * A];     // (size_i + size_j)^2, rounded once
  float keep_vel;                // 1 - damping
  float dt;
  float contact_force;
  float contact_margin;
  float agent_range;
  float landmark_range;
};

// ---- hashes ---------------------------------------------------------------

// murmur3 finalizer (both hashes, fused_rollout.py:203-207, fused_parity.py:47-50)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// top 24 bits as U[0, 1): exact in float
__device__ __forceinline__ float unit24(uint32_t h) {
  return (float)(h >> 8) * 0x1p-24f;
}

// _hash_uniform with make_uniform's salt: mixed + step*64 + call_id, times 0x9E3779B1
__device__ __forceinline__ uint32_t rollout_salt(uint32_t mixed, int step, int call_id) {
  return (mixed + (uint32_t)step * 64u + (uint32_t)call_id) * 0x9E3779B1u;
}

// hash_uniform_2d's salt for agent i: step*131071 + 7*i + 3, times 0x9E3779B9
__device__ __forceinline__ uint32_t det_salt(int step, int agent) {
  return ((uint32_t)step * 131071u + (uint32_t)(7 * agent + 3)) * 0x9E3779B9u;
}

__device__ __forceinline__ float hash_uniform(uint32_t salt_mul, uint32_t flat) {
  return unit24(fmix32(flat + salt_mul));
}

// ---- physics: decode_move_block + generic_physics_block, agents only -------

template <int A, int L>
__device__ __forceinline__ void physics(const SpreadParams<A, L>& c, const float (&mv)[A][MW],
                                        float (&ax)[A], float (&ay)[A], float (&vx)[A],
                                        float (&vy)[A]) {
  float fx[A], fy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    fx[i] = (mv[i][1] - mv[i][2]) * c.accel[i];
    fy[i] = (mv[i][3] - mv[i][4]) * c.accel[i];
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = i + 1; j < A; ++j) {
      const float dx = ax[i] - ax[j];
      const float dy = ay[i] - ay[j];
      const float d2 = dx * dx + dy * dy;
      // rsqrt of max(d2, tiny): an exact overlap gives dist 0 and a zero force
      const float inv = rsqrtf(fmaxf(d2, FLT_MIN));
      const float dist = d2 * inv;
      const float x = -(dist - c.dmin[i * A + j]) / c.contact_margin;
      // logaddexp(0, x) = max(x, 0) + log1p(exp(-|x|)): x reaches the thousands
      const float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * c.contact_margin;
      const float s = (c.contact_force * pen) * inv;
      const float gx = s * dx;
      const float gy = s * dy;
      fx[i] = fx[i] + gx;
      fy[i] = fy[i] + gy;
      fx[j] = fx[j] - gx;
      fy[j] = fy[j] - gy;
    }
  }
  // damping before force, then position (core.py:158-169); unit mass, no clamp
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float nvx = vx[i] * c.keep_vel + fx[i] * c.dt;
    const float nvy = vy[i] * c.keep_vel + fy[i] * c.dt;
    vx[i] = nvx;
    vy[i] = nvy;
    ax[i] = ax[i] + nvx * c.dt;
    ay[i] = ay[i] + nvy * c.dt;
  }
}

// ---- spread reward (fused_rollout.py:127-162): shared, pairs counted twice --

template <int A, int L>
__device__ __forceinline__ float spread_reward(const SpreadParams<A, L>& c, const float (&ax)[A],
                                               const float (&ay)[A], const float (&lx)[L],
                                               const float (&ly)[L]) {
  float base = 0.0f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float dj = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float dx = ax[i] - lx[j];
      const float dy = ay[i] - ly[j];
      const float d = sqrtf(dx * dx + dy * dy);
      dj = (i == 0) ? d : fminf(dj, d);
    }
    base = base - dj;
  }
  float coll = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = i + 1; j < A; ++j) {
      const float dx = ax[i] - ax[j];
      const float dy = ay[i] - ay[j];
      coll = coll + 2.0f * ((dx * dx + dy * dy < c.coll_thresh2[i * A + j]) ? 1.0f : 0.0f);
    }
  }
  return (float)A * base - coll - (float)A;
}

// ---- spread obs row r of agent i (simple_spread.py:84-100) ------------------
// [vel(2), pos(2), landmark rel (2L), other rel (2(A-1)), other comm (C(A-1)) = 0]

template <int A, int L, int C>
struct Obs {
  static constexpr int W = 2 * P + P * L + P * (A - 1) + C * (A - 1);
};

template <int A, int L>
__device__ __forceinline__ float obs_entry(int i, int r, const float (&ax)[A], const float (&ay)[A],
                                           const float (&vx)[A], const float (&vy)[A],
                                           const float (&lx)[L], const float (&ly)[L]) {
  if (r < 2) return r == 0 ? vx[i] : vy[i];
  if (r < 4) return r == 2 ? ax[i] : ay[i];
  r -= 4;
  if (r < 2 * L) return (r & 1) ? ly[r >> 1] - ay[i] : lx[r >> 1] - ax[i];
  r -= 2 * L;
  if (r < 2 * (A - 1)) {
    int j = r >> 1;
    j += (j >= i);                                   // other agents in world order
    return (r & 1) ? ay[j] - ay[i] : ax[j] - ax[i];
  }
  return 0.0f;                                       // silent agents' comm
}

// sum of the [A, OW] obs: per row over agents, then over rows
template <int A, int L, int C>
__device__ __forceinline__ float obs_checksum(const float (&ax)[A], const float (&ay)[A],
                                              const float (&vx)[A], const float (&vy)[A],
                                              const float (&lx)[L], const float (&ly)[L]) {
  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < Obs<A, L, C>::W; ++r) {
    float col = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) col = col + obs_entry<A, L>(i, r, ax, ay, vx, vy, lx, ly);
    total = total + col;
  }
  return total;
}

// ---- K2 ---------------------------------------------------------------------

// make_samplers' sample_state: agents on call id `call`, landmarks on
// `call + 1`, zero velocity; element (e, d, lane) of a [rows, P, n] draw has
// flat index (e*P + d)*n + lane
template <int A, int L>
__device__ __forceinline__ void sample_state(const SpreadParams<A, L>& c, uint32_t mixed,
                                             uint32_t n, uint32_t lane, int step, int call,
                                             float (&ax)[A], float (&ay)[A], float (&vx)[A],
                                             float (&vy)[A], float (&lx)[L], float (&ly)[L]) {
  const uint32_t sa = rollout_salt(mixed, step, call);
  const uint32_t sl = rollout_salt(mixed, step, call + 1);
  const float ar = c.agent_range, lr = c.landmark_range;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    ax[i] = hash_uniform(sa, (uint32_t)(i * P + 0) * n + lane) * (2.0f * ar) - ar;
    ay[i] = hash_uniform(sa, (uint32_t)(i * P + 1) * n + lane) * (2.0f * ar) - ar;
    vx[i] = 0.0f;
    vy[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lx[j] = hash_uniform(sl, (uint32_t)(j * P + 0) * n + lane) * (2.0f * lr) - lr;
    ly[j] = hash_uniform(sl, (uint32_t)(j * P + 1) * n + lane) * (2.0f * lr) - lr;
  }
}

template <int A, int L, int C>
__global__ void __launch_bounds__(THREADS)
spread_rollout_kernel(const SpreadParams<A, L> c, float* __restrict__ pos, float* __restrict__ vel,
                      float* __restrict__ rew_sum, float* __restrict__ obs_sum, int n_envs,
                      int block_envs, int n_steps, int horizon, uint32_t seed,
                      uint32_t block_offset) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed = seed * 7919u + rng_block * 104729u;

  float ax[A], ay[A], vx[A], vy[A], lx[L], ly[L];
  sample_state<A, L>(c, mixed, n, lane, 0, 0, ax, ay, vx, vy, lx, ly);

  float racc = 0.0f, oacc = 0.0f;
  int t = 0;
  for (int step = 0; step < n_steps; ++step) {
    const uint32_t sm = rollout_salt(mixed, step, 2);
    float mv[A][MW];
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int k = 0; k < MW; ++k) mv[i][k] = hash_uniform(sm, (uint32_t)(i * MW + k) * n + lane);
    physics<A, L>(c, mv, ax, ay, vx, vy);
    racc = racc + spread_reward<A, L>(c, ax, ay, lx, ly);
    oacc = oacc + obs_checksum<A, L, C>(ax, ay, vx, vy, lx, ly);
    t += 1;
    if (horizon > 0 && t >= horizon) {              // per-lane reset, call ids 3/4
      sample_state<A, L>(c, mixed, n, lane, step, 3, ax, ay, vx, vy, lx, ly);
      t = 0;
    }
  }

  const int N = n_envs;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    pos[(i * P + 0) * N + g] = ax[i];
    pos[(i * P + 1) * N + g] = ay[i];
    vel[(i * P + 0) * N + g] = vx[i];
    vel[(i * P + 1) * N + g] = vy[i];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    pos[((A + j) * P + 0) * N + g] = lx[j];
    pos[((A + j) * P + 1) * N + g] = ly[j];
    vel[((A + j) * P + 0) * N + g] = 0.0f;
    vel[((A + j) * P + 1) * N + g] = 0.0f;
  }
  rew_sum[g] = racc;
  obs_sum[g] = oacc;
}

// ---- K1 ---------------------------------------------------------------------

template <int A, int L, int C>
__global__ void __launch_bounds__(THREADS)
spread_det_rollout_kernel(const SpreadParams<A, L> c, const float* __restrict__ pos0,
                          const float* __restrict__ vel0, float* __restrict__ pos,
                          float* __restrict__ vel, float* __restrict__ rew_sum,
                          float* __restrict__ rew_last, float* __restrict__ obs_last, int n_envs,
                          int block_envs, int n_steps) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const int N = n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;

  float ax[A], ay[A], vx[A], vy[A], lx[L], ly[L];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    ax[i] = pos0[(i * P + 0) * N + g];
    ay[i] = pos0[(i * P + 1) * N + g];
    vx[i] = vel0[(i * P + 0) * N + g];
    vy[i] = vel0[(i * P + 1) * N + g];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lx[j] = pos0[((A + j) * P + 0) * N + g];
    ly[j] = pos0[((A + j) * P + 1) * N + g];
  }

  float racc = 0.0f, r = 0.0f;
  for (int step = 0; step < n_steps; ++step) {
    float mv[A][MW];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const uint32_t s = det_salt(step, i);
#pragma unroll
      for (int k = 0; k < MW; ++k) mv[i][k] = hash_uniform(s, (uint32_t)k * n + lane);
    }
    physics<A, L>(c, mv, ax, ay, vx, vy);
    r = spread_reward<A, L>(c, ax, ay, lx, ly);
    racc = racc + r;
  }

#pragma unroll
  for (int i = 0; i < A; ++i) {
    pos[(i * P + 0) * N + g] = ax[i];
    pos[(i * P + 1) * N + g] = ay[i];
    vel[(i * P + 0) * N + g] = vx[i];
    vel[(i * P + 1) * N + g] = vy[i];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {                     // landmarks do not move
    pos[((A + j) * P + 0) * N + g] = lx[j];
    pos[((A + j) * P + 1) * N + g] = ly[j];
    vel[((A + j) * P + 0) * N + g] = vel0[((A + j) * P + 0) * N + g];
    vel[((A + j) * P + 1) * N + g] = vel0[((A + j) * P + 1) * N + g];
  }
  rew_sum[g] = racc;
  rew_last[g] = r;
  // the last step's obs is the obs of the final state; zeros after no step
  constexpr int OW = Obs<A, L, C>::W;
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int row = 0; row < OW; ++row)
      obs_last[(i * OW + row) * N + g] =
          n_steps > 0 ? obs_entry<A, L>(i, row, ax, ay, vx, vy, lx, ly) : 0.0f;
}

}  // namespace

// Launch: one thread per env in 32-thread blocks, so that 4096 envs spread
// over 128 SMs instead of 32.
extern "C" {

int mpe_spread_rollout_a3l3c2(const void* params, float* pos, float* vel, float* rew_sum,
                              float* obs_sum, int n_envs, int block_envs, int n_steps, int horizon,
                              uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (n_envs + THREADS - 1) / THREADS;
  spread_rollout_kernel<3, 3, 2><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const SpreadParams<3, 3>*>(params), pos, vel, rew_sum, obs_sum, n_envs,
      block_envs, n_steps, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

int mpe_spread_det_rollout_a3l3c2(const void* params, const float* pos0, const float* vel0,
                                  float* pos, float* vel, float* rew_sum, float* rew_last,
                                  float* obs_last, int n_envs, int block_envs, int n_steps,
                                  cudaStream_t stream) {
  const int blocks = (n_envs + THREADS - 1) / THREADS;
  spread_det_rollout_kernel<3, 3, 2><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const SpreadParams<3, 3>*>(params), pos0, vel0, pos, vel, rew_sum, rew_last,
      obs_last, n_envs, block_envs, n_steps);
  return (int)cudaGetLastError();
}

const char* mpe_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

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

#include "spread_common.cuh"

namespace {

constexpr int THREADS = 32;      // see the note on the launch below

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

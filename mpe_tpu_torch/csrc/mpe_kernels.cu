// Hopper (sm_90a) kernels of the fused rollouts, for the nine scenarios of
// scenario_blocks.cuh.
//
// K1  det_rollout_kernel<S>      replaces  mpe_tpu/ops/fused_parity.py::_det_kernel
//     (fused_det_rollout): n_steps of the scenario's physics, reward and obs
//     from a given initial state (pos0/vel0 [E,P,N], comm0 [A,max(C,1),N] held
//     constant, goal0 [G,N] int32), moves from hash_uniform_2d with no block
//     salt (every RNG block draws the same moves), no reset. Out: pos, vel
//     [E,P,N], rew_sum, rew_last [R,N], obs_last [A,OW,N].
// K2  scenario_rollout_kernel<S> replaces  mpe_tpu/ops/fused_rollout.py::_generic_rollout_kernel
//     (fused_rollout) on all nine scenarios (scenario_blocks.cuh): uniform
//     moves from the murmur hash _hash_uniform (call id 2), physics, the
//     silent-masked comm draw (call id 16), reward and obs-checksum
//     accumulation, per-lane reset at the horizon (call ids 3/4, goals 26+).
//     Out: pos, vel [E,P,N], rew_sum [R,N], obs_sum [1,N].
//
// What bounds them: operation issue, not bytes. K2 reads nothing and writes
// 4 (2 E P + R + 1) B per env (104 B on simple_spread); K1 reads its inputs
// and writes 4 (2 E P + 2 R + A OW) B per env (320 B on simple_spread).
// Against that, one env-step on simple_spread needs (chip_smoke.py::OPS,
// counted from the formulas below) 12 hashes (10 integer
// operations and one int->float conversion each), 3 pair forces (rsqrt, a
// divide, exp, log1p), 9 agent-landmark sqrts and, in K2, the obs sum: 261
// fp32 (a multiply-add counted once), 18 special-function, 123 integer and 12
// conversion operations in K2 (183 fp32 and 124 integer in K1); simple_tag's
// 14 and simple_world_comm's 21 pairs take 42 and 63 special-function
// operations per env-step. Each lane's steps are one dependent chain, so at a
// few thousand envs (one warp per scheduler or less) the time is the chain's
// latency, not the issue rate.
//
// What the design does about it: one thread owns one env lane for the whole
// rollout. Its positions, velocities and accumulators live in registers, the
// step loop runs inside the thread, and device memory is touched only at the
// start (K1's inputs) and the end (the outputs), as the TPU kernels keep
// their state in VMEM. With one thread per lane the env-minor [.., N] layout
// gives coalesced loads and stores. The entity loops are unrolled over the template
// sizes; reset candidates are stateless hash draws, so a thread computes them
// only for a lane that resets and still gets the values the Pallas kernel drew.
// The library is built with -fmad=false: every multiply and add is rounded
// on its own, as PyTorch's elementwise ops round them, so the kernels agree
// with their plain versions on the card up to the order of the obs sum.
// What each scenario's device functions compute, and what ops/_build.py
// refuses for them, is in scenario_blocks.cuh.
//
// The RNG block (block_envs lanes) is part of each stream's definition: the
// hash indexes the lane within its RNG block, and K2 salts with the global
// RNG block id. It is an argument, independent of the CUDA block size.

#include "scenario_blocks.cuh"

namespace {

constexpr int THREADS = 32;      // see the note on the launch below

template <class S>
__global__ void __launch_bounds__(THREADS)
scenario_rollout_kernel(const typename S::Params c, float* __restrict__ pos,
                        float* __restrict__ vel, float* __restrict__ rew_sum,
                        float* __restrict__ obs_sum, int n_envs, int block_envs, int n_steps,
                        int horizon, uint32_t seed, uint32_t block_offset) {
  constexpr int A = S::A, R = S::R;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed = seed * 7919u + rng_block * 104729u;

  typename S::W w;
  draw_world<S>(c, mixed, n, lane, 0, 0, 8, w);
  float racc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) racc[k] = 0.0f;
  float oacc = 0.0f;
  int t = 0;
  for (int step = 0; step < n_steps; ++step) {
    float mv[A][MW];
    draw_moves<A>(rollout_salt(mixed, step, 2), n, lane, mv);
    S::physics(c, mv, w);
    float cm[A][S::CW];
    draw_comm<S>(c, rollout_salt(mixed, step, 16), n, lane, cm);
    const typename S::Derived d = S::derive(c, w, cm);
    float rew[R];
    S::reward(c, w, cm, d, rew);
#pragma unroll
    for (int k = 0; k < R; ++k) racc[k] = racc[k] + rew[k];
    float total = 0.0f;                             // the obs sum: per row over agents
#pragma unroll
    for (int r = 0; r < S::OW; ++r) {
      float col = 0.0f;
#pragma unroll
      for (int i = 0; i < A; ++i) col = col + S::obs(i, r, w, cm, d);
      total = total + col;
    }
    oacc = oacc + total;
    t += 1;
    if (horizon > 0 && t >= horizon) {              // per-lane reset, call ids 3/4, goals 26+
      draw_world<S>(c, mixed, n, lane, step, 3, 24, w);
      t = 0;
    }
  }
  store_world<S>(w, pos, vel, (size_t)n_envs, g);
#pragma unroll
  for (int k = 0; k < R; ++k) rew_sum[(size_t)k * n_envs + g] = racc[k];
  obs_sum[g] = oacc;
}

template <class S>
int launch_rollout(const void* params, float* pos, float* vel, float* rew_sum, float* obs_sum,
                   int n_envs, int block_envs, int n_steps, int horizon, uint32_t seed,
                   uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (n_envs + THREADS - 1) / THREADS;
  scenario_rollout_kernel<S><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), pos, vel, rew_sum, obs_sum, n_envs,
      block_envs, n_steps, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

// ---- K1 ---------------------------------------------------------------------

// The scenario's state of one lane from the inputs: pos0/vel0 [E,P,N], goal0
// [G,N] int32, comm0 [A,max(C,1),N] (held for the whole rollout)
template <class S>
__device__ __forceinline__ void load_world(const float* __restrict__ pos0,
                                           const float* __restrict__ vel0,
                                           const int* __restrict__ goal0,
                                           const float* __restrict__ comm0, size_t N, int g,
                                           typename S::W& w, float (&cm)[S::A][S::CW]) {
#pragma unroll
  for (int i = 0; i < S::A; ++i) {
    w.ax[i] = pos0[(i * P + 0) * N + g];
    w.ay[i] = pos0[(i * P + 1) * N + g];
    w.vx[i] = vel0[(i * P + 0) * N + g];
    w.vy[i] = vel0[(i * P + 1) * N + g];
  }
#pragma unroll
  for (int j = 0; j < S::L; ++j) {
    w.lx[j] = pos0[((S::A + j) * P + 0) * N + g];
    w.ly[j] = pos0[((S::A + j) * P + 1) * N + g];
  }
#pragma unroll
  for (int q = 0; q < S::G; ++q) w.goal[q] = goal0[q * N + g];
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int k = 0; k < S::CW; ++k) cm[i][k] = k < S::C ? comm0[(i * S::C + k) * N + g] : 0.0f;
}

template <class S>
__global__ void __launch_bounds__(THREADS)
det_rollout_kernel(const typename S::Params c, const float* __restrict__ pos0,
                   const float* __restrict__ vel0, const float* __restrict__ comm0,
                   const int* __restrict__ goal0, float* __restrict__ pos,
                   float* __restrict__ vel, float* __restrict__ rew_sum,
                   float* __restrict__ rew_last, float* __restrict__ obs_last, int n_envs,
                   int block_envs, int n_steps) {
  constexpr int A = S::A, R = S::R;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;

  typename S::W w;
  float cm[A][S::CW];
  load_world<S>(pos0, vel0, goal0, comm0, N, g, w, cm);
  float racc[R], r[R];
#pragma unroll
  for (int k = 0; k < R; ++k) racc[k] = r[k] = 0.0f;
  for (int step = 0; step < n_steps; ++step) {
    float mv[A][MW];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const uint32_t s = det_salt(step, i);       // hash_uniform_2d: no block salt
#pragma unroll
      for (int k = 0; k < MW; ++k) mv[i][k] = hash_uniform(s, (uint32_t)k * n + lane);
    }
    S::physics(c, mv, w);
    S::reward(c, w, cm, S::derive(c, w, cm), r);
#pragma unroll
    for (int k = 0; k < R; ++k) racc[k] = racc[k] + r[k];
  }

#pragma unroll
  for (int i = 0; i < A; ++i) {                     // an immovable agent keeps its vel0
    pos[(i * P + 0) * N + g] = w.ax[i];
    pos[(i * P + 1) * N + g] = w.ay[i];
    vel[(i * P + 0) * N + g] = w.vx[i];
    vel[(i * P + 1) * N + g] = w.vy[i];
  }
#pragma unroll
  for (int j = 0; j < S::L; ++j) {                  // landmarks neither move nor lose vel0
    pos[((A + j) * P + 0) * N + g] = w.lx[j];
    pos[((A + j) * P + 1) * N + g] = w.ly[j];
    vel[((A + j) * P + 0) * N + g] = vel0[((A + j) * P + 0) * N + g];
    vel[((A + j) * P + 1) * N + g] = vel0[((A + j) * P + 1) * N + g];
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    rew_sum[k * N + g] = racc[k];
    rew_last[k * N + g] = r[k];
  }
  // the last step's obs is the obs of the final state; zeros after no step
  const typename S::Derived d = S::derive(c, w, cm);
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int row = 0; row < S::OW; ++row)
      obs_last[(i * S::OW + row) * N + g] = n_steps > 0 ? S::obs(i, row, w, cm, d) : 0.0f;
}

template <class S>
int launch_det(const void* params, const float* pos0, const float* vel0, const float* comm0,
               const int* goal0, float* pos, float* vel, float* rew_sum, float* rew_last,
               float* obs_last, int n_envs, int block_envs, int n_steps, cudaStream_t stream) {
  const int blocks = (n_envs + THREADS - 1) / THREADS;
  det_rollout_kernel<S><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), pos0, vel0, comm0, goal0, pos, vel,
      rew_sum, rew_last, obs_last, n_envs, block_envs, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch: one thread per env in 32-thread blocks, so that 4096 envs spread
// over 128 SMs instead of 32.
extern "C" {

// scenario: ops/_build.py::SCENARIO_IDS
int mpe_scenario_rollout(int scenario, const void* params, float* pos, float* vel, float* rew_sum,
                         float* obs_sum, int n_envs, int block_envs, int n_steps, int horizon,
                         uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
#define MPE_ROLLOUT(S)                                                                      \
  return launch_rollout<S>(params, pos, vel, rew_sum, obs_sum, n_envs, block_envs, n_steps, \
                           horizon, seed, block_offset, stream)
  MPE_SCENARIO_SWITCH(MPE_ROLLOUT)
#undef MPE_ROLLOUT
}

// K1; comm0 [A, max(C, 1), N] and goal0 [max(G, 1), N] are read where the
// scenario has comm and goals
int mpe_det_rollout(int scenario, const void* params, const float* pos0, const float* vel0,
                    const float* comm0, const int* goal0, float* pos, float* vel, float* rew_sum,
                    float* rew_last, float* obs_last, int n_envs, int block_envs, int n_steps,
                    cudaStream_t stream) {
#define MPE_DET(S)                                                                          \
  return launch_det<S>(params, pos0, vel0, comm0, goal0, pos, vel, rew_sum, rew_last, obs_last, \
                       n_envs, block_envs, n_steps, stream)
  MPE_SCENARIO_SWITCH(MPE_DET)
#undef MPE_DET
}

const char* mpe_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

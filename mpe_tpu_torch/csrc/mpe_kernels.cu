// Hopper (sm_90a) kernels of the fused rollouts, for the nine scenarios of
// scenario_blocks.cuh.
//
// K1  det_rollout_kernel<S>      replaces  mpe_tpu/ops/fused_parity.py::_det_kernel
//     (fused_det_rollout): n_steps of the scenario's physics, reward and obs
//     from a given initial state (pos0/vel0 [E,P,N], comm0 [A,max(C,1),N] held
//     constant, goal0 [G,N] int32), moves from hash_uniform_2d with no block
//     salt (every RNG block draws the same moves), no reset. Out: pos, vel
//     [E,P,N], rew_sum, rew_last [R,N], obs_last [A,OW,N].
// K2  scenario_rollout_kernel<S, G> replaces  mpe_tpu/ops/fused_rollout.py::_generic_rollout_kernel
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
// few thousand envs with one thread per lane (one warp per SM) the time is
// the chain's latency, not the issue rate.
//
// What the designs do about it. K1: one thread owns one env lane for the
// whole rollout; its positions, velocities and accumulators live in
// registers, the step loop runs inside the thread, and device memory is
// touched only at the start (K1's inputs) and the end (the outputs), as the
// TPU kernels keep their state in VMEM. K2: a group of G threads of one warp
// (G = 1, 2, 4 or 8, ops/fused_rollout.py::rollout_group) owns one env lane,
// which gives the card G times the warps to hide the chain's latency and
// shortens the chain: each rank draws its agents' moves and comm, computes
// its pairs' contact forces (simple_tag's 14 over 4 ranks, world_comm's 21
// over 8) and sums its agents' obs rows; __shfl_sync brings the results back
// to every rank, which adds them in the per-lane order (scenario_blocks.cuh,
// the group functions), so pos, vel, rew_sum and obs_sum are the same for
// every G. What stays on every rank: the integration, derive, the reward rows
// and resets (the same inputs, the same values), and the shuffles
// themselves, about 2 (A + K) + A C + A per step: the next bound once the
// pairs are split. Rank 0 of a group stores. The entity loops are unrolled over the template
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

constexpr int THREADS = 32;      // one warp per CTA: see the note on the launch below

// K2: G threads per env lane (the group functions of scenario_blocks.cuh);
// rank 0 of each group stores. Threads past n_envs run the last lane and
// store nothing, so that every lane of a warp takes part in the shuffles.
template <class S, int G>
__global__ void __launch_bounds__(THREADS)
scenario_rollout_kernel(const typename S::Params c, float* __restrict__ pos,
                        float* __restrict__ vel, float* __restrict__ rew_sum,
                        float* __restrict__ obs_sum, int n_envs, int block_envs, int n_steps,
                        int horizon, uint32_t seed, uint32_t block_offset) {
  constexpr int R = S::R;
  static_assert(THREADS % G == 0, "a group lies inside one warp");
  __shared__ GroupCopy<S> copies[THREADS / G];
  const int rank = G == 1 ? 0 : (int)threadIdx.x % G;
  const int grp = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = grp < n_envs;
  const int g = live ? grp : n_envs - 1;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed = seed * 7919u + rng_block * 104729u;
  GroupCopy<S>& cp = copies[threadIdx.x / G];

  GroupSlots<S, G> sl;
  init_slots<S, G>(c, rank, sl);
  typename S::W w;
  draw_world<S>(c, mixed, n, lane, 0, 0, 8, w);
  if constexpr (G > 1) cp.w = w;
  // the slots read the copy; with G = 1 their indices are compile-time and
  // they read the registers
  const typename S::W& wv = G > 1 ? cp.w : w;
  float racc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) racc[k] = 0.0f;
  float oacc = 0.0f;
  int t = 0;
  for (int step = 0; step < n_steps; ++step) {
    group_sync<G>();                                // the copy holds this step's start
    group_physics<S, G>(c, sl, rollout_salt(mixed, step, 2), n, lane, wv, w);
    float cm[S::A][S::CW];
    group_comm<S, G>(c, sl, rollout_salt(mixed, step, 16), n, lane, cm);
    const typename S::Derived d = S::derive(c, w, cm);
    float rew[R];
    group_reward<S, G>(c, rank, w, cm, d, rew);
#pragma unroll
    for (int k = 0; k < R; ++k) racc[k] = racc[k] + rew[k];
    if constexpr (G > 1) {
      cp.w = w;
#pragma unroll
      for (int i = 0; i < S::A; ++i)
#pragma unroll
        for (int k = 0; k < S::CW; ++k) cp.cm[i][k] = cm[i][k];
      cp.d = d;
    }
    group_sync<G>();
    oacc = oacc + group_obs_total<S, G>(sl, wv, G > 1 ? cp.cm : cm, G > 1 ? cp.d : d);
    t += 1;
    if (horizon > 0 && t >= horizon) {              // reset, call ids 3/4, goals 26+: t is
      draw_world<S>(c, mixed, n, lane, step, 3, 24, w);   // the same on every lane
      t = 0;
      if constexpr (G > 1) {
        group_sync<G>();                            // the obs reads are done
        cp.w = w;
      }
    }
  }
  if (live && rank == 0) {
    store_world<S>(w, pos, vel, (size_t)n_envs, g);
#pragma unroll
    for (int k = 0; k < R; ++k) rew_sum[(size_t)k * n_envs + g] = racc[k];
    obs_sum[g] = oacc;
  }
}

template <class S, int G>
int launch_rollout_group(const void* params, float* pos, float* vel, float* rew_sum,
                         float* obs_sum, int n_envs, int block_envs, int n_steps, int horizon,
                         uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (int)(((long long)n_envs * G + THREADS - 1) / THREADS);
  scenario_rollout_kernel<S, G><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), pos, vel, rew_sum, obs_sum, n_envs,
      block_envs, n_steps, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

template <class S>
int launch_rollout(const void* params, float* pos, float* vel, float* rew_sum, float* obs_sum,
                   int n_envs, int block_envs, int n_steps, int horizon, uint32_t seed,
                   uint32_t block_offset, int group, cudaStream_t stream) {
#define MPE_GROUP(G)                                                                         \
  case G:                                                                                    \
    return launch_rollout_group<S, G>(params, pos, vel, rew_sum, obs_sum, n_envs, block_envs, \
                                      n_steps, horizon, seed, block_offset, stream)
  switch (group) {
    MPE_GROUP(1);
    MPE_GROUP(2);
    MPE_GROUP(4);
    MPE_GROUP(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPE_GROUP
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

// Launch: one warp per CTA. K1 runs one thread per env, so that 4096 envs
// spread over 128 SMs instead of 32; K2 runs G threads per env (group 1, 2,
// 4 or 8, chosen by ops/fused_rollout.py::rollout_group), n_envs G / 32
// warps, so that 4096 envs give the card 4-8 warps per SM instead of one.
extern "C" {

// scenario: ops/_build.py::SCENARIO_IDS; group: threads per env lane
int mpe_scenario_rollout(int scenario, const void* params, float* pos, float* vel, float* rew_sum,
                         float* obs_sum, int n_envs, int block_envs, int n_steps, int horizon,
                         uint32_t seed, uint32_t block_offset, int group, cudaStream_t stream) {
#define MPE_ROLLOUT(S)                                                                      \
  return launch_rollout<S>(params, pos, vel, rew_sum, obs_sum, n_envs, block_envs, n_steps, \
                           horizon, seed, block_offset, group, stream)
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

// Hopper (sm_90a) kernel of the fused trajectory, for the nine scenarios of
// scenario_blocks.cuh.
//
// K3  trajectory_kernel<S, G>  replaces  mpe_tpu/ops/fused_trajectory.py::_traj_kernel
//     (fused_trajectory): uniform moves and comm from the murmur hash, one
//     physics step, reward and obs, per-lane reset at the horizon, streaming
//     the learner batch. Out: obs [T,A,OW,N] and rew [T,R,N] after the physics
//     of step t and before its reset; act [T,A,5+C,N], the raw uniform move
//     draw and the silent-masked comm draw; the final pos, vel [E,P,N].
//
// What bounds it: bytes, at width. Per env-step it writes (A*OW + A*(5+C) + R)
// floats and reads nothing: 40 B on simple, 280 B on simple_spread, 1,056 B on
// simple_world_comm. Its operations are K2's step less the reward and obs
// sums, a few hundred per env-step (chip_smoke.py::OPS), so at 3.35 TB/s
// against 67 TFLOP/s the stores take several times longer than the
// arithmetic. At a few thousand envs, though, one thread per lane leaves one
// warp per SM, and each lane's step (draws, physics, derive, reward, then
// every obs element computed and stored one after another) is one dependent
// chain: at 4096 envs x 64 steps the one-thread kernel ran at 3-5x its byte
// bound, at 65,536 envs at 1.14x.
//
// What the design does about it: G threads of one warp share an env lane (G =
// 1, 2, 4 or 8; ops/fused_trajectory.py::traj_group picks it, the C entry
// takes it), which gives the card G times the warps to hide the chain's
// latency and shortens the chain. With G = 1 one thread owns one lane for all
// n_steps and stores every element of it (a warp's 32 lanes store 128
// contiguous bytes of a row), its state in registers, as the one-thread
// kernel did. With G > 1 the lane runs on the group functions of
// scenario_blocks.cuh, as K2's scenario_rollout_kernel<S, G>: each rank draws
// its slot agents' moves and comm and computes its pairs' contact forces,
// __shfl_sync brings them back in the per-lane order, every rank integrates,
// derives and computes the reward rows, so every output is the same bits for
// every G. The stores split by rank: rank r stores the obs rows [i, 0..OW) and
// the action rows [i, 0..5+C) of its slot agents i (the obs read from the
// group's copy of the world, comm and derived values in shared memory, since i
// differs by rank; the move and comm draws are the slot's own, from
// group_physics and group_comm), reward row k goes to rank k mod G, the final
// pos and vel to rank 0. One store instruction covers G rows of 32 / G
// consecutive lanes: whole 32-byte sectors up to G = 4; at G = 8 it writes
// half sectors, which the rule avoids. CTAs are one warp, as K2's. Threads
// past n_envs run the last lane and store nothing, so every lane of a warp
// takes part in the shuffles.
// Two other designs gave the same bits and lost on the H100 (PERF.md §6, PR
// 11): the group's state into shared memory and the CTA's warps storing whole
// rows of 32 lanes after a barrier, with the stores either after the step or
// in store warps beside it. A CTA then holds all the lanes of its SM, and the
// barrier each step couples the step's chain to the stores.
// The TPU's grid of (env blocks, time chunks) survives only as the RNG salt:
// chunk j adds j * 15485863 to the block's mix and the step counts within the
// chunk, as in K5, so t_chunk is part of the stream's definition. Reset
// candidates are stateless hashes, drawn only for a lane that resets (every
// rank draws them). Built with -fmad=false, like the other kernels, so it
// rounds as its plain version (ops/fused_trajectory.py::plain_trajectory) does.

#include "scenario_blocks.cuh"

namespace {

constexpr int THREADS = 32;       // one warp per CTA, as K2

// G = 1: one thread per lane stores every element of its lane
template <class S>
__device__ __forceinline__ void trajectory_lane(const typename S::Params& c, float* __restrict__ obs,
                                                float* __restrict__ act, float* __restrict__ rew,
                                                float* __restrict__ pos, float* __restrict__ vel,
                                                int n_envs, int block_envs, int n_chunks,
                                                int t_chunk, int horizon, uint32_t seed,
                                                uint32_t block_offset) {
  constexpr int A = S::A, OW = S::OW, AW = MW + S::C;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed0 = seed * 7919u + rng_block * 104729u;

  typename S::W w;
  draw_world<S>(c, mixed0, n, lane, 0, 0, 8, w);
  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const size_t ts = (size_t)chunk * t_chunk + step;
      float mv[A][MW];
      draw_moves<A>(rollout_salt(mixed, step, 2), n, lane, mv);
      S::physics(c, mv, w);
      float cm[A][S::CW];
      draw_comm<S>(c, rollout_salt(mixed, step, 16), n, lane, cm);
      const typename S::Derived d = S::derive(c, w, cm);
      float r_t[S::R];
      S::reward(c, w, cm, d, r_t);
#pragma unroll
      for (int k = 0; k < S::R; ++k) __stcs(rew + (ts * S::R + k) * N + g, r_t[k]);
      float* obs_t = obs + ts * A * OW * N + g;
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int r = 0; r < OW; ++r)
          __stcs(obs_t + (size_t)(i * OW + r) * N, S::obs(i, r, w, cm, d));
      float* act_t = act + ts * A * AW * N + g;
#pragma unroll
      for (int i = 0; i < A; ++i) {
#pragma unroll
        for (int k = 0; k < MW; ++k) __stcs(act_t + (size_t)(i * AW + k) * N, mv[i][k]);
#pragma unroll
        for (int k = 0; k < S::C; ++k) __stcs(act_t + (size_t)(i * AW + MW + k) * N, cm[i][k]);
      }
      t += 1;
      if (t >= horizon) {                             // per-lane reset, call ids 3/4, goals 26+
        draw_world<S>(c, mixed, n, lane, step, 3, 24, w);
        t = 0;
      }
    }
  }
  store_world<S>(w, pos, vel, N, g);
}

// G > 1: the group functions' step, the stores split by rank (the header)
template <class S, int G>
__device__ __forceinline__ void trajectory_group(const typename S::Params& c,
                                                 float* __restrict__ obs, float* __restrict__ act,
                                                 float* __restrict__ rew, float* __restrict__ pos,
                                                 float* __restrict__ vel, int n_envs,
                                                 int block_envs, int n_chunks, int t_chunk,
                                                 int horizon, uint32_t seed,
                                                 uint32_t block_offset) {
  constexpr int A = S::A, OW = S::OW, AW = MW + S::C, R = S::R;
  using Sl = GroupSlots<S, G>;
  static_assert(THREADS % G == 0, "a group lies inside one warp");
  __shared__ GroupCopy<S> copies[THREADS / G];
  const int rank = (int)threadIdx.x % G;
  const int grp = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  const bool live = grp < n_envs;
  const int g = live ? grp : n_envs - 1;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t mixed0 = seed * 7919u + ((uint32_t)g / n + block_offset) * 104729u;
  GroupCopy<S>& cp = copies[threadIdx.x / G];

  Sl sl;
  init_slots<S, G>(c, rank, sl);
  bool own[Sl::QA];                                 // slot q holds an agent of its own
#pragma unroll
  for (int q = 0; q < Sl::QA; ++q) own[q] = live && rank + q * G < A;
  typename S::W w;
  draw_world<S>(c, mixed0, n, lane, 0, 0, 8, w);
  cp.w = w;
  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const size_t ts = (size_t)chunk * t_chunk + step;
      const uint32_t salt_m = rollout_salt(mixed, step, 2);
      float mvq[Sl::QA][MW];                        // the slot agents' move draws
      float cm[A][S::CW], cq[Sl::QA][S::CW];        // comm rows; the slot agents' rows
      group_sync<G>();                              // the copy holds this step's start
      group_physics<S, G>(c, sl, RolloutMoves{salt_m, n, lane}, cp.w, w, mvq);
#pragma unroll
      for (int q = 0; q < Sl::QA; ++q)
        mvq[q][0] = hash_uniform(salt_m, (uint32_t)(sl.agent[q] * MW) * n + lane);
      group_comm<S, G>(c, sl, rollout_salt(mixed, step, 16), n, lane, cm, cq);
      const typename S::Derived d = S::derive(c, w, cm);
      float r_t[R];
      group_reward<S, G>(c, rank, w, cm, d, r_t);
      cp.w = w;
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int k = 0; k < S::CW; ++k) cp.cm[i][k] = cm[i][k];
      cp.d = d;
      group_sync<G>();
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (live && k % G == rank) __stcs(rew + (ts * R + k) * N + g, r_t[k]);
      float* obs_t = obs + ts * A * OW * N + g;
      float* act_t = act + ts * A * AW * N + g;
#pragma unroll
      for (int q = 0; q < Sl::QA; ++q) {
        if (!own[q]) continue;
        const int i = sl.agent[q];
#pragma unroll
        for (int r = 0; r < OW; ++r)
          __stcs(obs_t + (size_t)(i * OW + r) * N, S::obs(i, r, cp.w, cp.cm, cp.d));
#pragma unroll
        for (int k = 0; k < MW; ++k) __stcs(act_t + (size_t)(i * AW + k) * N, mvq[q][k]);
#pragma unroll
        for (int k = 0; k < S::C; ++k)
          __stcs(act_t + (size_t)(i * AW + MW + k) * N, cq[q][k]);
      }
      t += 1;
      if (t >= horizon) {                           // per-lane reset, call ids 3/4, goals 26+:
        draw_world<S>(c, mixed, n, lane, step, 3, 24, w);   // t is the same on every lane
        t = 0;
        group_sync<G>();                            // the obs reads are done
        cp.w = w;
      }
    }
  }
  if (live && rank == 0) store_world<S>(w, pos, vel, N, g);
}

template <class S, int G>
__global__ void __launch_bounds__(THREADS)
trajectory_kernel(const typename S::Params c, float* __restrict__ obs, float* __restrict__ act,
                  float* __restrict__ rew, float* __restrict__ pos, float* __restrict__ vel,
                  int n_envs, int block_envs, int n_chunks, int t_chunk, int horizon,
                  uint32_t seed, uint32_t block_offset) {
  if constexpr (G == 1) {
    trajectory_lane<S>(c, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks, t_chunk,
                       horizon, seed, block_offset);
  } else {
    trajectory_group<S, G>(c, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks, t_chunk,
                           horizon, seed, block_offset);
  }
}

template <class S, int G>
int launch_group(const void* params, float* obs, float* act, float* rew, float* pos, float* vel,
                 int n_envs, int block_envs, int n_chunks, int t_chunk, int horizon,
                 uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (int)(((long long)n_envs * G + THREADS - 1) / THREADS);
  trajectory_kernel<S, G><<<blocks, THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), obs, act, rew, pos, vel, n_envs,
      block_envs, n_chunks, t_chunk, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

template <class S>
int launch(const void* params, float* obs, float* act, float* rew, float* pos, float* vel,
           int n_envs, int block_envs, int n_chunks, int t_chunk, int horizon, uint32_t seed,
           uint32_t block_offset, int group, cudaStream_t stream) {
#define MPE_GROUP(G)                                                                       \
  case G:                                                                                  \
    return launch_group<S, G>(params, obs, act, rew, pos, vel, n_envs, block_envs,         \
                              n_chunks, t_chunk, horizon, seed, block_offset, stream)
  switch (group) {
    MPE_GROUP(1);
    MPE_GROUP(2);
    MPE_GROUP(4);
    MPE_GROUP(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MPE_GROUP
}

}  // namespace

extern "C" {

// scenario: ops/_build.py::SCENARIO_IDS; group: threads per env lane (1, 2, 4
// or 8)
int mpe_trajectory(int scenario, const void* params, float* obs, float* act, float* rew,
                   float* pos, float* vel, int n_envs, int block_envs, int n_chunks, int t_chunk,
                   int horizon, uint32_t seed, uint32_t block_offset, int group,
                   cudaStream_t stream) {
#define MPE_TRAJECTORY(S)                                                                 \
  return launch<S>(params, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks, t_chunk, \
                   horizon, seed, block_offset, group, stream)
  MPE_SCENARIO_SWITCH(MPE_TRAJECTORY)
#undef MPE_TRAJECTORY
}

}  // extern "C"

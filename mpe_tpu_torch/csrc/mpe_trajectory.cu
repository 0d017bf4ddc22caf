// Hopper (sm_90a) kernel of the fused trajectory, for simple_spread, simple,
// simple_reference and simple_speaker_listener.
//
// K3  trajectory_kernel<S>  replaces  mpe_tpu/ops/fused_trajectory.py::_traj_kernel
//     (fused_trajectory): uniform moves and comm from the murmur hash, one
//     physics step, reward and obs, per-lane reset at the horizon, streaming
//     the learner batch. Out: obs [T,A,OW,N] and rew [T,1,N] after the physics
//     of step t and before its reset; act [T,A,5+C,N], the raw uniform move
//     draw and the silent-masked comm draw; the final pos, vel [E,P,N].
//
// What bounds it: bytes, at width. Per env-step it writes (A*OW + A*(5+C) + 1)
// floats: 280 B on simple_spread, 292 B on simple_reference, and reads
// nothing. Its operations are K2's step less the reward and obs sums, a few
// hundred per env-step (chip_smoke.py::OPS), so at 3.35 TB/s against 67
// TFLOP/s the stores take several times longer than the arithmetic. At a few
// thousand envs, though, each lane's steps are one dependent chain, as in K2,
// and the chain sets the pace.
//
// What the design does about it: one thread owns one env lane for all
// n_steps, with positions, velocities, the step counter and the goals in
// registers, as K2 and K5 do, so the only traffic is the trajectory itself.
// Every output element (t, i, r, lane) goes straight to [T, A, W, N], so a
// warp's 32 lanes store 128 contiguous bytes; the stores are streaming
// (__stcs), since nothing here reads the trajectory again, and no thread waits
// for them. The TPU's grid of (env blocks, time chunks) survives only as the
// RNG salt: chunk j adds j * 15485863 to the block's mix and the step counts
// within the chunk, as in K5, so t_chunk is part of the stream's definition.
// Reset candidates are stateless hashes, drawn only for a lane that resets.
// Built with -fmad=false, like the other kernels, so it rounds as its plain
// version (ops/fused_trajectory.py::plain_trajectory) does.

#include "scenario_blocks.cuh"

namespace {

constexpr int TRAJ_THREADS = 32;     // one warp per CTA, as K2 (4096 envs -> 128 SMs)

template <class S>
__global__ void __launch_bounds__(TRAJ_THREADS)
trajectory_kernel(const typename S::Params c, float* __restrict__ obs, float* __restrict__ act,
                  float* __restrict__ rew, float* __restrict__ pos, float* __restrict__ vel,
                  int n_envs, int block_envs, int n_chunks, int t_chunk, int horizon,
                  uint32_t seed, uint32_t block_offset) {
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
      __stcs(rew + ts * N + g, S::reward(c, w));
      float* obs_t = obs + ts * A * OW * N + g;
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int r = 0; r < OW; ++r) __stcs(obs_t + (size_t)(i * OW + r) * N, S::obs(i, r, w, cm));
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

template <class S>
int launch(const void* params, float* obs, float* act, float* rew, float* pos, float* vel,
           int n_envs, int block_envs, int n_chunks, int t_chunk, int horizon, uint32_t seed,
           uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (n_envs + TRAJ_THREADS - 1) / TRAJ_THREADS;
  trajectory_kernel<S><<<blocks, TRAJ_THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), obs, act, rew, pos, vel, n_envs,
      block_envs, n_chunks, t_chunk, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scenario: 0 simple_spread, 1 simple, 2 simple_reference, 3
// simple_speaker_listener (ops/_build.py::SCENARIO_IDS)
int mpe_trajectory(int scenario, const void* params, float* obs, float* act, float* rew,
                   float* pos, float* vel, int n_envs, int block_envs, int n_chunks, int t_chunk,
                   int horizon, uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
  switch (scenario) {
    case 0:
      return launch<SpreadScn>(params, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks,
                               t_chunk, horizon, seed, block_offset, stream);
    case 1:
      return launch<SimpleScn>(params, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks,
                               t_chunk, horizon, seed, block_offset, stream);
    case 2:
      return launch<ReferenceScn>(params, obs, act, rew, pos, vel, n_envs, block_envs, n_chunks,
                                  t_chunk, horizon, seed, block_offset, stream);
    case 3:
      return launch<SpeakerListenerScn>(params, obs, act, rew, pos, vel, n_envs, block_envs,
                                        n_chunks, t_chunk, horizon, seed, block_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

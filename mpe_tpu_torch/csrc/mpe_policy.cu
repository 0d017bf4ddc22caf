// Hopper (sm_90a) kernels of the policy-in-the-loop rollout, for the nine
// scenarios of scenario_blocks.cuh.
//
// K5  policy_traj_kernel<S>    replaces  mpe_tpu/ops/fused_policy.py::_policy_traj_kernel
//     (fused_policy_trajectory): obs -> MLP OW-64-64-(5+C) -> Gumbel-max move
//     (and comm, where the agent speaks) -> physics -> reward -> per-lane reset,
//     streaming the on-policy batch. Out: obs [T,A,OW,N] (the obs each agent
//     acted on), act [T,A,N] and, with a comm head, cact [T,A,N] int32 (0 for
//     a silent agent), rew [T,R,N], last_obs [A,OW,N].
// K4  policy_rollout_kernel<S> replaces  mpe_tpu/ops/fused_policy.py::_policy_rollout_kernel
//     (fused_policy_rollout): the same loop, accumulating per-lane returns of
//     every reward row and completed episodes. Out: ret [R,N], pos [E,P,N],
//     episodes [1,N].
//
// What bounds them: fp32 operations. One env-step runs the MLP once per agent,
// 64 (OW + 64 + 5 + C) multiply-adds and 128 tanh each (chip_smoke.py::OPS),
// against a few hundred bytes of obs per env-step that K5 writes and nothing
// that K4 writes per step.
//
// What the design does about it: one thread owns one env lane for the whole
// rollout, as in K2 and K3; its world state (S::W) lives in registers and the
// obs rows are recomputed from it (S::obs) instead of being carried. The obs
// an agent acts on at step t reads the utterances of step t - 1, so the lane
// carries each agent's last comm index, -1 for a zero row: a silent agent
// always, every agent after a reset ("zero comm at episode start",
// make_lane_reset). Its one-hot rows are rebuilt where the obs and the reward
// read them. The weights (at most 6,608 floats, 26 KB, on simple_reference)
// are copied into shared memory once per CTA, and every thread of a warp reads
// the same weight at the same time (a broadcast). The MLP (policy_mlp.cuh)
// keeps h1[64] in registers and streams the second layer four units at a time
// into the logit sums; it sits behind a __noinline__ sampler, so that it gets
// its own register allocation.
//
// Rounding: the MLP sums each layer in the plain versions' order; with
// -fmad=false each multiply and add rounds on its own, and tanhf/logf are the
// functions PyTorch's CUDA tanh/log call. So the kernels reproduce their plain
// versions on the card, actions included: Gumbel-max turns a one-ulp change in
// a logit into another action and the trajectories part.
//
// RNG: the interpret-mode hash stream of the JAX kernels. Moves draw on call
// id 7, comm on id 9, element (k*A + i)*n + lane of uniform((K, A*n)); the
// block init and the resets as in K3 (ids 0/1 and 3/4, goals 8+2+g and
// 24+2+g). K5 salts with the time chunk (chunk * 15485863) and counts steps
// within a chunk, so t_chunk is part of the stream's definition although the
// thread does not chunk time. K4 has no chunk salt and counts steps from 0 to
// n_steps - 1.

#include "scenario_blocks.cuh"
#include "policy_mlp.cuh"

namespace {

constexpr int POLICY_THREADS = 32;   // one warp per CTA, as K2 (4096 envs -> 128 SMs)

// Gumbel-max over logits z[K0, K0 + K) with uniforms uniform((K, A*n), ...) of
// salt `salt`, first-max tie-break
template <int A, int K0, int K, int KP>
__device__ __forceinline__ int gumbel_argmax(const float (&z)[KP], uint32_t salt, uint32_t n,
                                             uint32_t lane, int agent) {
  int best = 0;
  float best_s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float s = gumbel_score(z[K0 + c], hash_uniform(salt, (uint32_t)(c * A + agent) * n + lane));
    if (c == 0 || s > best_s) {
      best_s = s;
      best = c;
    }
  }
  return best;
}

// _policy_sample for agent `agent`: the MLP on its obs x, the move on salt_m
// and, where it speaks, the comm on salt_c -> move + 8 (comm + 1), comm -1
// for a silent agent (the JAX kernel draws its row and zeroes it)
template <class S>
__device__ __noinline__ int sample_action(const float* __restrict__ w, const float (&x)[S::OW],
                                          uint32_t salt_m, uint32_t salt_c, uint32_t n,
                                          uint32_t lane, int agent, bool speaks) {
  float z[MW + S::C];
  policy_logits(w, x, z);
  const int move = gumbel_argmax<S::A, 0, MW>(z, salt_m, n, lane, agent);
  int comm = -1;
  if constexpr (S::C > 0) {
    if (speaks) comm = gumbel_argmax<S::A, MW, S::C>(z, salt_c, n, lane, agent);
  }
  return move + 8 * (comm + 1);
}

// agent i's obs row r of the lane's state, the utterances of the last step
template <class S>
__device__ __forceinline__ void obs_rows(const typename S::Params& c, const typename S::W& w,
                                         const int (&cidx)[S::A], float* __restrict__ out,
                                         size_t N) {
  float cm[S::A][S::CW];
  comm_rows<S>(cidx, cm);
  const typename S::Derived d = S::derive(c, w, cm);
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int r = 0; r < S::OW; ++r) out[(size_t)(i * S::OW + r) * N] = S::obs(i, r, w, cm, d);
}

// one step of a lane: every agent acts on its obs (obs_t, act_t, cact_t
// receive the rows and indices where not null, stride N), then the physics,
// the new utterances and this step's reward rows r
template <class S>
__device__ __forceinline__ void policy_step(const typename S::Params& c,
                                            const float* __restrict__ w, uint32_t salt_m,
                                            uint32_t salt_c, uint32_t n, uint32_t lane,
                                            typename S::W& wd, int (&cidx)[S::A], float (&r)[S::R],
                                            float* __restrict__ obs_t, int* __restrict__ act_t,
                                            int* __restrict__ cact_t, size_t N) {
  constexpr int A = S::A;
  float mv[A][MW];
  int ncidx[A];
  {
    float cm[A][S::CW];
    comm_rows<S>(cidx, cm);
    const typename S::Derived d = S::derive(c, wd, cm);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      float x[S::OW];
#pragma unroll
      for (int k = 0; k < S::OW; ++k) x[k] = S::obs(i, k, wd, cm, d);
      if (obs_t != nullptr) {
#pragma unroll
        for (int k = 0; k < S::OW; ++k) __stcs(obs_t + (size_t)(i * S::OW + k) * N, x[k]);
      }
      const bool speaks = S::C > 0 && !S::silent(c, i);
      const int a = sample_action<S>(w, x, salt_m, salt_c, n, lane, i, speaks);
      const int move = a & 7;
      ncidx[i] = (a >> 3) - 1;
      if (act_t != nullptr) __stcs(act_t + (size_t)i * N, move);
      if (cact_t != nullptr) __stcs(cact_t + (size_t)i * N, ncidx[i] < 0 ? 0 : ncidx[i]);
#pragma unroll
      for (int k = 0; k < MW; ++k) mv[i][k] = (k == move) ? 1.0f : 0.0f;
    }
  }
  S::physics(c, mv, wd);
#pragma unroll
  for (int i = 0; i < A; ++i) cidx[i] = ncidx[i];
  float cm[A][S::CW];
  comm_rows<S>(cidx, cm);
  S::reward(c, wd, cm, S::derive(c, wd, cm), r);
}

// the actor's weights into shared memory, once per CTA
template <class S>
__device__ __forceinline__ void load_weights(float* __restrict__ s, const float* __restrict__ g) {
  for (int i = threadIdx.x; i < MlpLayout<S::OW, MW + S::C>::NW; i += blockDim.x) s[i] = g[i];
  __syncthreads();
}

// ---- K5 ---------------------------------------------------------------------

template <class S>
__global__ void __launch_bounds__(POLICY_THREADS)
policy_traj_kernel(const typename S::Params c, const float* __restrict__ weights,
                   float* __restrict__ obs, int* __restrict__ act, int* __restrict__ cact,
                   float* __restrict__ rew, float* __restrict__ last_obs, int n_envs,
                   int block_envs, int n_chunks, int t_chunk, int horizon, uint32_t seed,
                   uint32_t block_offset) {
  constexpr int A = S::A, OW = S::OW;
  __shared__ __align__(16) float w[MlpLayout<OW, MW + S::C>::NW];
  load_weights<S>(w, weights);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed0 = seed * 7919u + rng_block * 104729u;

  typename S::W wd;
  draw_world<S>(c, mixed0, n, lane, 0, 0, 8, wd);
  int cidx[A];
  reset_comm<S>(cidx);
  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const size_t ts = (size_t)chunk * t_chunk + step;
      float r[S::R];
      policy_step<S>(c, w, rollout_salt(mixed, step, 7), rollout_salt(mixed, step, 9), n, lane,
                     wd, cidx, r, obs + ts * A * OW * N + g, act + ts * A * N + g,
                     S::C > 0 ? cact + ts * A * N + g : nullptr, N);
#pragma unroll
      for (int k = 0; k < S::R; ++k) __stcs(rew + (ts * S::R + k) * N + g, r[k]);
      t += 1;
      if (t >= horizon) {                           // lane_fresh: call ids 3/4, goals 24+2+g
        draw_world<S>(c, mixed, n, lane, step, 3, 24, wd);
        reset_comm<S>(cidx);
        t = 0;
      }
    }
  }
  obs_rows<S>(c, wd, cidx, last_obs + g, N);
}

// ---- K4 ---------------------------------------------------------------------

template <class S>
__global__ void __launch_bounds__(POLICY_THREADS)
policy_rollout_kernel(const typename S::Params c, const float* __restrict__ weights,
                      float* __restrict__ ret, float* __restrict__ pos,
                      float* __restrict__ episodes, int n_envs, int block_envs, int n_steps,
                      int horizon, uint32_t seed, uint32_t block_offset) {
  constexpr int A = S::A;
  __shared__ __align__(16) float w[MlpLayout<S::OW, MW + S::C>::NW];
  load_weights<S>(w, weights);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed = seed * 7919u + rng_block * 104729u;

  typename S::W wd;
  draw_world<S>(c, mixed, n, lane, 0, 0, 8, wd);
  int cidx[A];
  reset_comm<S>(cidx);
  float racc[S::R];
#pragma unroll
  for (int k = 0; k < S::R; ++k) racc[k] = 0.0f;
  float eps = 0.0f;
  int t = 0;
  for (int step = 0; step < n_steps; ++step) {
    float r[S::R];
    policy_step<S>(c, w, rollout_salt(mixed, step, 7), rollout_salt(mixed, step, 9), n, lane, wd,
                   cidx, r, nullptr, nullptr, nullptr, N);
#pragma unroll
    for (int k = 0; k < S::R; ++k) racc[k] = racc[k] + r[k];
    t += 1;
    if (t >= horizon) {
      eps = eps + 1.0f;
      draw_world<S>(c, mixed, n, lane, step, 3, 24, wd);
      reset_comm<S>(cidx);
      t = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    pos[(i * P + 0) * N + g] = wd.ax[i];
    pos[(i * P + 1) * N + g] = wd.ay[i];
  }
#pragma unroll
  for (int j = 0; j < S::L; ++j) {
    pos[((A + j) * P + 0) * N + g] = wd.lx[j];
    pos[((A + j) * P + 1) * N + g] = wd.ly[j];
  }
#pragma unroll
  for (int k = 0; k < S::R; ++k) ret[k * N + g] = racc[k];
  episodes[g] = eps;
}

template <class S>
int launch_traj(const void* params, const float* weights, float* obs, int* act, int* cact,
                float* rew, float* last_obs, int n_envs, int block_envs, int n_chunks,
                int t_chunk, int horizon, uint32_t seed, uint32_t block_offset,
                cudaStream_t stream) {
  const int blocks = (n_envs + POLICY_THREADS - 1) / POLICY_THREADS;
  policy_traj_kernel<S><<<blocks, POLICY_THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), weights, obs, act, cact, rew, last_obs,
      n_envs, block_envs, n_chunks, t_chunk, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

template <class S>
int launch_rollout(const void* params, const float* weights, float* ret, float* pos,
                   float* episodes, int n_envs, int block_envs, int n_steps, int horizon,
                   uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (n_envs + POLICY_THREADS - 1) / POLICY_THREADS;
  policy_rollout_kernel<S><<<blocks, POLICY_THREADS, 0, stream>>>(
      *static_cast<const typename S::Params*>(params), weights, ret, pos, episodes, n_envs,
      block_envs, n_steps, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5; cact is null for a scenario without a comm head
int mpe_policy_traj(int scenario, const void* params, const float* weights, float* obs, int* act,
                    int* cact, float* rew, float* last_obs, int n_envs, int block_envs,
                    int n_chunks, int t_chunk, int horizon, uint32_t seed, uint32_t block_offset,
                    cudaStream_t stream) {
#define MPE_POLICY_TRAJ(S)                                                                    \
  return launch_traj<S>(params, weights, obs, act, cact, rew, last_obs, n_envs, block_envs, \
                        n_chunks, t_chunk, horizon, seed, block_offset, stream)
  MPE_SCENARIO_SWITCH(MPE_POLICY_TRAJ)
#undef MPE_POLICY_TRAJ
}

// K4
int mpe_policy_rollout(int scenario, const void* params, const float* weights, float* ret,
                       float* pos, float* episodes, int n_envs, int block_envs, int n_steps,
                       int horizon, uint32_t seed, uint32_t block_offset, cudaStream_t stream) {
#define MPE_POLICY_ROLLOUT(S)                                                                  \
  return launch_rollout<S>(params, weights, ret, pos, episodes, n_envs, block_envs, n_steps, \
                           horizon, seed, block_offset, stream)
  MPE_SCENARIO_SWITCH(MPE_POLICY_ROLLOUT)
#undef MPE_POLICY_ROLLOUT
}

}  // extern "C"

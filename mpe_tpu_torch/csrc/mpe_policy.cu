// Hopper (sm_90a) kernels of the policy-in-the-loop simple_spread rollout.
//
// K5  spread_policy_traj_kernel    replaces  mpe_tpu/ops/fused_policy.py::_policy_traj_kernel
//     (fused_policy_trajectory): obs -> MLP 18-64-64-5 -> Gumbel-max move ->
//     spread step -> per-lane reset, streaming the on-policy batch. Out: obs
//     [T,A,OW,N] (the obs each agent acted on), act [T,A,N] int32, rew
//     [T,1,N], last_obs [A,OW,N].
// K4  spread_policy_rollout_kernel replaces  mpe_tpu/ops/fused_policy.py::_policy_rollout_kernel
//     (fused_policy_rollout): the same loop, accumulating per-lane returns and
//     completed episodes. Out: ret [1,N], pos [E,P,N], episodes [1,N].
//
// What bounds them: fp32 operations. One env-step runs the MLP once per agent,
// about 11.6k multiplies and adds each (chip_smoke.py::OPS), against 57 KB of
// obs per 4096 envs that K5 writes and nothing that K4 writes per step.
//
// What the design does about it: one thread owns one env lane for the whole
// rollout, as in K2; its world state lives in registers and the obs rows are
// recomputed from it (obs_entry) instead of being carried. The weights (5,701
// floats, 22.8 KB) are copied into shared memory once per CTA, and every
// thread of a warp reads the same weight at the same time (a broadcast).
// Per agent the thread keeps h1[64] in registers and streams the second layer,
// four units at a time, into the five logit sums, so no second 64-float array
// is live.
//
// Rounding: the MLP (policy_mlp.cuh) sums each layer in the plain versions'
// order; with -fmad=false each multiply and add rounds on its own, and
// tanhf/logf are the functions PyTorch's CUDA tanh/log call. So the kernels
// reproduce their plain versions on the card, actions included: Gumbel-max turns
// a one-ulp change in a logit into another action and the trajectories part.
//
// RNG: the interpret-mode hash stream of the JAX kernels. K5 salts with the
// time chunk (chunk * 15485863) and counts steps within a chunk, so t_chunk is
// part of the stream's definition although the thread does not chunk time.
// K4 has no chunk salt and counts steps from 0 to n_steps - 1.

#include "policy_mlp.cuh"

namespace {

constexpr int POLICY_THREADS = 32;   // one warp per CTA, as K2 (4096 envs -> 128 SMs)

// _policy_sample for agent `agent`: MLP on its obs x, Gumbel-max over the K
// move logits with uniforms uniform((K, A*n), step, 7), first-max tie-break.
// Not inlined, so that the MLP gets its own register allocation.
template <int A>
__device__ __noinline__ int sample_move(const float* __restrict__ w, const float (&x)[OW],
                                           uint32_t salt, uint32_t n, uint32_t lane, int agent) {
  float z[K];
  policy_logits(w, x, z);
  int best = 0;
  float best_s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float s = gumbel_score(z[c], hash_uniform(salt, (uint32_t)(c * A + agent) * n + lane));
    if (c == 0 || s > best_s) {
      best_s = s;
      best = c;
    }
  }
  return best;
}

// one policy step of all agents from the current state: fills the one-hot
// moves, returns nothing else; `obs_t` (K5) receives each agent's obs rows
template <int A, int L>
__device__ __forceinline__ void policy_moves(const float* __restrict__ w, uint32_t salt, uint32_t n,
                                             uint32_t lane, const float (&ax)[A],
                                             const float (&ay)[A], const float (&vx)[A],
                                             const float (&vy)[A], const float (&lx)[L],
                                             const float (&ly)[L], float (&mv)[A][MW],
                                             float* __restrict__ obs_t, int* __restrict__ act_t,
                                             size_t stride) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float x[OW];
#pragma unroll
    for (int r = 0; r < OW; ++r) x[r] = obs_entry<A, L>(i, r, ax, ay, vx, vy, lx, ly);
    if (obs_t != nullptr) {
#pragma unroll
      for (int r = 0; r < OW; ++r) obs_t[(size_t)(i * OW + r) * stride] = x[r];
    }
    const int a = sample_move<A>(w, x, salt, n, lane, i);
    if (act_t != nullptr) act_t[(size_t)i * stride] = a;
#pragma unroll
    for (int k = 0; k < MW; ++k) mv[i][k] = (k == a) ? 1.0f : 0.0f;
  }
}

__device__ __forceinline__ void load_weights(float* __restrict__ s, const float* __restrict__ g) {
  for (int i = threadIdx.x; i < NW; i += blockDim.x) s[i] = g[i];
  __syncthreads();
}

// ---- K5 ---------------------------------------------------------------------

template <int A, int L>
__global__ void __launch_bounds__(POLICY_THREADS)
spread_policy_traj_kernel(const SpreadParams<A, L> c, const float* __restrict__ weights,
                          float* __restrict__ obs, int* __restrict__ act, float* __restrict__ rew,
                          float* __restrict__ last_obs, int n_envs, int block_envs, int n_chunks,
                          int t_chunk, int horizon, uint32_t seed, uint32_t block_offset) {
  __shared__ __align__(16) float w[NW];
  load_weights(w, weights);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const size_t N = (size_t)n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed0 = seed * 7919u + rng_block * 104729u;

  float ax[A], ay[A], vx[A], vy[A], lx[L], ly[L];
  sample_state<A, L>(c, mixed0, n, lane, 0, 0, ax, ay, vx, vy, lx, ly);
  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const size_t ts = (size_t)chunk * t_chunk + step;
      float mv[A][MW];
      policy_moves<A, L>(w, rollout_salt(mixed, step, 7), n, lane, ax, ay, vx, vy, lx, ly, mv,
                         obs + ts * A * OW * N + g, act + ts * A * N + g, N);
      physics<A, L>(c, mv, ax, ay, vx, vy);
      rew[ts * N + g] = spread_reward<A, L>(c, ax, ay, lx, ly);
      t += 1;
      if (t >= horizon) {                           // lane_fresh: call ids 3/4
        sample_state<A, L>(c, mixed, n, lane, step, 3, ax, ay, vx, vy, lx, ly);
        t = 0;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int r = 0; r < OW; ++r)
      last_obs[(size_t)(i * OW + r) * N + g] = obs_entry<A, L>(i, r, ax, ay, vx, vy, lx, ly);
}

// ---- K4 ---------------------------------------------------------------------

template <int A, int L>
__global__ void __launch_bounds__(POLICY_THREADS)
spread_policy_rollout_kernel(const SpreadParams<A, L> c, const float* __restrict__ weights,
                             float* __restrict__ ret, float* __restrict__ pos,
                             float* __restrict__ episodes, int n_envs, int block_envs, int n_steps,
                             int horizon, uint32_t seed, uint32_t block_offset) {
  __shared__ __align__(16) float w[NW];
  load_weights(w, weights);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_envs) return;
  const int N = n_envs;
  const uint32_t n = (uint32_t)block_envs;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t rng_block = (uint32_t)g / n + block_offset;
  const uint32_t mixed = seed * 7919u + rng_block * 104729u;

  float ax[A], ay[A], vx[A], vy[A], lx[L], ly[L];
  sample_state<A, L>(c, mixed, n, lane, 0, 0, ax, ay, vx, vy, lx, ly);
  float racc = 0.0f, eps = 0.0f;
  int t = 0;
  for (int step = 0; step < n_steps; ++step) {
    float mv[A][MW];
    policy_moves<A, L>(w, rollout_salt(mixed, step, 7), n, lane, ax, ay, vx, vy, lx, ly, mv,
                       nullptr, nullptr, 0);
    physics<A, L>(c, mv, ax, ay, vx, vy);
    racc = racc + spread_reward<A, L>(c, ax, ay, lx, ly);
    t += 1;
    if (t >= horizon) {
      eps = eps + 1.0f;
      sample_state<A, L>(c, mixed, n, lane, step, 3, ax, ay, vx, vy, lx, ly);
      t = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    pos[(i * P + 0) * N + g] = ax[i];
    pos[(i * P + 1) * N + g] = ay[i];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    pos[((A + j) * P + 0) * N + g] = lx[j];
    pos[((A + j) * P + 1) * N + g] = ly[j];
  }
  ret[g] = racc;
  episodes[g] = eps;
}

}  // namespace

extern "C" {

int mpe_spread_policy_traj_a3l3(const void* params, const float* weights, float* obs, int* act,
                                float* rew, float* last_obs, int n_envs, int block_envs,
                                int n_chunks, int t_chunk, int horizon, uint32_t seed,
                                uint32_t block_offset, cudaStream_t stream) {
  const int blocks = (n_envs + POLICY_THREADS - 1) / POLICY_THREADS;
  spread_policy_traj_kernel<3, 3><<<blocks, POLICY_THREADS, 0, stream>>>(
      *static_cast<const SpreadParams<3, 3>*>(params), weights, obs, act, rew, last_obs, n_envs,
      block_envs, n_chunks, t_chunk, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

int mpe_spread_policy_rollout_a3l3(const void* params, const float* weights, float* ret,
                                   float* pos, float* episodes, int n_envs, int block_envs,
                                   int n_steps, int horizon, uint32_t seed, uint32_t block_offset,
                                   cudaStream_t stream) {
  const int blocks = (n_envs + POLICY_THREADS - 1) / POLICY_THREADS;
  spread_policy_rollout_kernel<3, 3><<<blocks, POLICY_THREADS, 0, stream>>>(
      *static_cast<const SpreadParams<3, 3>*>(params), weights, ret, pos, episodes, n_envs,
      block_envs, n_steps, horizon, seed, block_offset);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Hopper (sm_90a) kernels of the policy-in-the-loop rollout, for the nine
// scenarios of scenario_blocks.cuh.
//
// K5  policy_traj_kernel<S>    replaces  mpe_tpu/ops/fused_policy.py::_policy_traj_kernel
//     (fused_policy_trajectory): obs -> MLP OW-H-H-(5+C) -> Gumbel-max move
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
// H (OW + H + 5 + C) multiply-adds and 2 H tanh each (H the hidden width,
// policy_mlp.cuh; chip_smoke.py::OPS;
// with -fmad=false a multiply-add issues as two operations, so the floor is
// about twice that bound), against a few hundred bytes of obs per env-step that
// K5 writes and nothing that K4 writes per step.
//
// What the design does about it: a CTA of TILE_THREADS threads owns a tile of
// TL env lanes (ops/fused_policy.py::policy_tile picks TL from the CTAs an SM
// holds, mpe_policy_ctas_per_sm; the C entries take it), where the old kernel
// ran one warp per CTA and each lane's MLP as one thread's serial chain. Both
// kernels are thin wrappers over one body, policy_tile_body<S, TRAJ>. Per step:
//   1. the MLP of every (agent, lane) row of the tile as CTA-wide register-tiled
//      products (policy_mlp.cuh::tile_mlp), the actor's weights (at most 6,884
//      floats, 27 KB, on simple_reference) loaded into shared memory once per CTA;
//   2. the Gumbel-max draws, one (agent, lane) row per thread, the logits read
//      from shared memory, each row's action index written back;
//   3. the world step, one thread per lane as before: thread l < TL owns lane l,
//      its world state (S::W) in registers, and after the physics and the reward
//      writes the obs of the next step into the tile's input rows (K5 also to the
//      batch), so the obs rows are computed once per step from the state that the
//      reward read (from the fresh state after a reset).
// The obs an agent acts on at step t reads the utterances of step t - 1, so the
// lane carries each agent's last comm index, -1 for a zero row: a silent agent
// always, every agent after a reset ("zero comm at episode start",
// make_lane_reset). Its one-hot rows are rebuilt where the obs and the reward
// read them. A ragged last tile leaves its spare lanes' threads idle in phase 3.
//
// Rounding: the MLP sums each layer in the plain versions' order; with
// -fmad=false each multiply and add rounds on its own, and tanhf/logf are the
// functions PyTorch's CUDA tanh/log call. So the kernels reproduce their plain
// versions on the card, actions included, for every tile size: Gumbel-max turns
// a one-ulp change in a logit into another action and the trajectories part.
//
// RNG: the interpret-mode hash stream of the JAX kernels. Moves draw on call
// id 7, comm on id 9, element (k*A + i)*n + lane of uniform((K, A*n)); the
// block init and the resets as in K3 (ids 0/1 and 3/4, goals 8+2+g and
// 24+2+g). K5 salts with the time chunk (chunk * 15485863) and counts steps
// within a chunk, so t_chunk is part of the stream's definition although the
// kernel does not chunk time. K4 has no chunk salt and counts steps from 0 to
// n_steps - 1: one chunk of n_steps.

#include "policy_mlp.cuh"

namespace {

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

// what the two kernels write: K5 the batch (obs, act, cact, rew, last_obs),
// K4 the returns, final positions and episodes
struct PolicyOut {
  float* obs;
  int* act;
  int* cact;
  float* rew;
  float* last_obs;
  float* ret;
  float* pos;
  float* episodes;
};

// _policy_sample on the tile's rows: row (agent i, lane l) draws its move on
// salt 7 and, where agent i speaks, its comm on salt 9 -> act[row] = move +
// 8 (comm + 1), comm -1 for a silent agent (the JAX kernel draws its row and
// zeroes it)
template <class S>
__device__ __forceinline__ void sample_rows(const typename S::Params& c, const float* z, int* act,
                                            const TileRows& tr, int tlv, int g0, uint32_t n,
                                            uint32_t seed, uint32_t block_offset, int chunk,
                                            int step) {
  constexpr int KP = MW + S::C;
  for (int row = threadIdx.x; row < tr.nr; row += blockDim.x) {
    const int i = row / tr.tlp, l = row - i * tr.tlp;
    if (l >= tlv) continue;
    const uint32_t g = (uint32_t)(g0 + l), lane = g % n;
    const uint32_t mixed = seed * 7919u + (g / n + block_offset) * 104729u +
                           (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    float zr[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) zr[k] = z[k * tr.ldx + row];
    const int move = gumbel_argmax<S::A, 0, MW>(zr, rollout_salt(mixed, step, 7), n, lane, i);
    int comm = -1;
    if constexpr (S::C > 0) {
      if (!S::silent(c, i))
        comm = gumbel_argmax<S::A, MW, S::C>(zr, rollout_salt(mixed, step, 9), n, lane, i);
    }
    act[row] = move + 8 * (comm + 1);
  }
}

// K5 (TRAJ true): n_chunks chunks of t_chunk steps; K4 (TRAJ false): one
// chunk of n_steps
template <class S, bool TRAJ>
__device__ __forceinline__ void policy_tile_body(const typename S::Params& c,
                                                 const float* __restrict__ weights,
                                                 const PolicyOut& out, int n_envs, int block_envs,
                                                 int n_chunks, int t_chunk, int horizon,
                                                 uint32_t seed, uint32_t block_offset, int tile) {
  constexpr int A = S::A, OW = S::OW, KP = MW + S::C;
  using M = TileActor<OW, KP>;
  extern __shared__ __align__(16) float smem[];
  const TileRows tr = tile_rows(tile, A);
  float* const w = smem;
  float* const xt = w + M::NWP;
  float* const h1 = xt + OW * tr.ldx;        // then the logits
  float* const h2 = h1 + H * tr.ldx;
  int* const act = reinterpret_cast<int*>(h2 + H * tr.ldx);
  load_float4s(w, weights, M::NWP / 4);

  const int g0 = blockIdx.x * tile;
  const int tlv = n_envs - g0 < tile ? n_envs - g0 : tile;      // lanes of a ragged tile
  const int l = threadIdx.x;
  const bool owner = l < tlv;
  const size_t N = (size_t)n_envs;
  const int n_steps = n_chunks * t_chunk;
  const uint32_t n = (uint32_t)block_envs;
  const int g = g0 + l;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t mixed0 = seed * 7919u + ((uint32_t)g / n + block_offset) * 104729u;
  // the batch's obs rows of step s (the bootstrap obs after the last step)
  auto obs_at = [&](int s) -> float* {
    if constexpr (!TRAJ) return nullptr;
    return s < n_steps ? out.obs + (size_t)s * A * OW * N + g : out.last_obs + g;
  };

  typename S::W wd;
  int cidx[A];
  float racc[S::R];
  float eps = 0.0f;
  if (owner) {
    draw_world<S>(c, mixed0, n, lane, 0, 0, 8, wd);
    reset_comm<S>(cidx);
#pragma unroll
    for (int k = 0; k < S::R; ++k) racc[k] = 0.0f;
    put_fresh_obs<S>(c, wd, cidx, xt, tr, l, obs_at(0), N);
  }
  int t = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const int ts = chunk * t_chunk + step;
      __syncthreads();                                 // the input rows are the tile's obs
      tile_mlp<OW, KP>(w, 0, xt, h1, h2, tr);
      sample_rows<S>(c, h1, act, tr, tlv, g0, n, seed, block_offset, chunk, step);
      __syncthreads();
      t += 1;
      const bool reset = t >= horizon;                 // every lane's horizon is shared
      if (owner) {
        float mv[A][MW];
#pragma unroll
        for (int i = 0; i < A; ++i) {
          const int a = act[i * tr.tlp + l], move = a & 7;
          cidx[i] = (a >> 3) - 1;
          if constexpr (TRAJ) {
            __stcs(out.act + ((size_t)ts * A + i) * N + g, move);
            if (out.cact != nullptr)
              __stcs(out.cact + ((size_t)ts * A + i) * N + g, cidx[i] < 0 ? 0 : cidx[i]);
          }
#pragma unroll
          for (int k = 0; k < MW; ++k) mv[i][k] = (k == move) ? 1.0f : 0.0f;
        }
        S::physics(c, mv, wd);
        float cm[A][S::CW];
        comm_rows<S>(cidx, cm);
        const typename S::Derived d = S::derive(c, wd, cm);
        float r[S::R];
        S::reward(c, wd, cm, d, r);
#pragma unroll
        for (int k = 0; k < S::R; ++k) {
          if constexpr (TRAJ) {
            __stcs(out.rew + ((size_t)ts * S::R + k) * N + g, r[k]);
          } else {
            racc[k] = racc[k] + r[k];
          }
        }
        if (reset) {                                   // lane_fresh: call ids 3/4, goals 24+2+g
          eps = eps + 1.0f;
          draw_world<S>(c, mixed, n, lane, step, 3, 24, wd);
          reset_comm<S>(cidx);
          put_fresh_obs<S>(c, wd, cidx, xt, tr, l, obs_at(ts + 1), N);
        } else {
          put_obs<S>(wd, cm, d, xt, tr, l, obs_at(ts + 1), N);
        }
      }
      if (reset) t = 0;
    }
  }
  if constexpr (!TRAJ) {
    if (owner) {
#pragma unroll
      for (int i = 0; i < A; ++i) {
        out.pos[(i * P + 0) * N + g] = wd.ax[i];
        out.pos[(i * P + 1) * N + g] = wd.ay[i];
      }
#pragma unroll
      for (int j = 0; j < S::L; ++j) {
        out.pos[((A + j) * P + 0) * N + g] = wd.lx[j];
        out.pos[((A + j) * P + 1) * N + g] = wd.ly[j];
      }
#pragma unroll
      for (int k = 0; k < S::R; ++k) out.ret[k * N + g] = racc[k];
      out.episodes[g] = eps;
    }
  }
}

// ---- K5 and K4 ----------------------------------------------------------------

template <class S>
__global__ void __launch_bounds__(TILE_THREADS)
policy_traj_kernel(const typename S::Params c, const float* __restrict__ weights,
                   const PolicyOut out, int n_envs, int block_envs, int n_chunks, int t_chunk,
                   int horizon, uint32_t seed, uint32_t block_offset, int tile) {
  policy_tile_body<S, true>(c, weights, out, n_envs, block_envs, n_chunks, t_chunk, horizon, seed,
                            block_offset, tile);
}

template <class S>
__global__ void __launch_bounds__(TILE_THREADS)
policy_rollout_kernel(const typename S::Params c, const float* __restrict__ weights,
                      const PolicyOut out, int n_envs, int block_envs, int n_chunks, int t_chunk,
                      int horizon, uint32_t seed, uint32_t block_offset, int tile) {
  policy_tile_body<S, false>(c, weights, out, n_envs, block_envs, n_chunks, t_chunk, horizon,
                             seed, block_offset, tile);
}

// the tile's shared memory (the actor, the input rows [OW][LDX], h1 (then the
// logits) and h2 [H][LDX], the rows' action indices [NR]), or 0 for a tile
// size the kernels do not take
template <class S>
size_t policy_smem(int tile) {
  if (tile < 1 || tile > TILE_MAX) return 0;
  const TileRows tr = tile_rows(tile, S::A);
  const size_t bytes = ((size_t)TileActor<S::OW, MW + S::C>::NWP +
                        (size_t)(S::OW + 2 * H) * tr.ldx + tr.nr) * sizeof(float);
  return bytes <= SMEM_MAX ? bytes : 0;
}

template <class S, bool TRAJ>
int launch(const void* params, const float* weights, const PolicyOut& out, int n_envs,
           int block_envs, int n_chunks, int t_chunk, int horizon, uint32_t seed,
           uint32_t block_offset, int tile, cudaStream_t stream) {
  constexpr auto kernel = TRAJ ? policy_traj_kernel<S> : policy_rollout_kernel<S>;
  const cudaError_t attr = tile_smem_attr<kernel, policy_smem<S>>();
  const size_t smem = policy_smem<S>(tile);
  if (attr != cudaSuccess) return (int)attr;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_envs + tile - 1) / tile;
  kernel<<<blocks, TILE_THREADS, smem, stream>>>(
      *static_cast<const typename S::Params*>(params), weights, out, n_envs, block_envs, n_chunks,
      t_chunk, horizon, seed, block_offset, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5; weights in TileActor's layout; cact is null for a scenario without a
// comm head; tile lanes per CTA, 1 to TILE_MAX
int mpe_policy_traj(int scenario, const void* params, const float* weights, float* obs, int* act,
                    int* cact, float* rew, float* last_obs, int n_envs, int block_envs,
                    int n_chunks, int t_chunk, int horizon, uint32_t seed, uint32_t block_offset,
                    int tile, cudaStream_t stream) {
  const PolicyOut out{obs, act, cact, rew, last_obs, nullptr, nullptr, nullptr};
#define MPE_POLICY_TRAJ(S)                                                                  \
  return launch<S, true>(params, weights, out, n_envs, block_envs, n_chunks, t_chunk, horizon, \
                         seed, block_offset, tile, stream)
  MPE_SCENARIO_SWITCH(MPE_POLICY_TRAJ)
#undef MPE_POLICY_TRAJ
}

// K4
int mpe_policy_rollout(int scenario, const void* params, const float* weights, float* ret,
                       float* pos, float* episodes, int n_envs, int block_envs, int n_steps,
                       int horizon, uint32_t seed, uint32_t block_offset, int tile,
                       cudaStream_t stream) {
  const PolicyOut out{nullptr, nullptr, nullptr, nullptr, nullptr, ret, pos, episodes};
#define MPE_POLICY_ROLLOUT(S)                                                            \
  return launch<S, false>(params, weights, out, n_envs, block_envs, 1, n_steps, horizon, seed, \
                          block_offset, tile, stream)
  MPE_SCENARIO_SWITCH(MPE_POLICY_ROLLOUT)
#undef MPE_POLICY_ROLLOUT
}

// K5's (kernel 0) or K4's (kernel 1) CTAs of `tile` lanes that one SM of the
// current card holds at once; ops/fused_policy.py::policy_tile reads it
int mpe_policy_ctas_per_sm(int scenario, int kernel, int tile) {
#define MPE_POLICY_CTAS(S)                                                   \
  return kernel == 0 ? tile_ctas_per_sm<policy_traj_kernel<S>, policy_smem<S>>(tile) \
                     : tile_ctas_per_sm<policy_rollout_kernel<S>, policy_smem<S>>(tile)
  MPE_SCENARIO_SWITCH(MPE_POLICY_CTAS)
#undef MPE_POLICY_CTAS
}

}  // extern "C"

// Hopper (sm_90a) kernels of the fused MADDPG loop on simple_spread.
//
// K8  spread_maddpg_traj_kernel  replaces  mpe_tpu/ops/fused_maddpg.py::_maddpg_traj_kernel
//     (fused_maddpg_trajectory): per step, each agent's own actor 18-64-64-5 on
//     its obs, Gumbel-max over the move logits eps-mixed with a uniform one-hot,
//     the spread step, per-lane reset at the horizon. Out: obs [T,A,OW,N], act
//     [T,A,5,N] one-hot, rew [T,1,N], obs2 [T,A,OW,N] (the true pre-reset next
//     obs), or the finished replay rows [T,N,W], W = A*(2*OW + 5 + 1).
// K9  maddpg_target_actions_kernel + maddpg_update_kernel + maddpg_reduce_kernel
//     replace  mpe_tpu/ops/fused_maddpg_update.py::_maddpg_update_kernel
//     (fused_maddpg_update): on a batch of replay rows [B, W], the first-argmax
//     target actions, the TD targets y = r + gamma Q'(s', a'), the critic's
//     forward and backward on the mean of (Q - y)^2 over [A, B], the exact
//     expected-Q actor gradient p (qbar - E) with each candidate's Q built from
//     the critic's layer-1 pre-activation (minus the agent's own-action columns,
//     plus the candidate's column), and the entropy adjoint with its 1e-10 eps.
//     Out: every agent's actor and critic gradient and the metric sums.
//
// What bounds them: fp32 operations. K8 runs three actors per env-step (about
// 11.6k multiply-adds each) and writes 504 bytes of replay row; K9 needs about
// 72k multiply-adds per (sample, agent) pair (chip_smoke.py::OPS counts them)
// against 504 bytes read per sample.
//
// What the designs do about it.
// K8 is K5 (mpe_policy.cu) with a weight block per agent: one thread owns one
// env lane, its world state in registers, the three actors' weights (68 KB) in
// dynamic shared memory, each agent's block padded to a 16-byte boundary for
// the float4 rows of policy_mlp.cuh. The MLP is the one K5 uses, inside a
// __noinline__ sampler, so it gets its own register allocation. At 1024 envs
// this fills 32 warps, one per SM on 32 SMs: the collection is one lane's
// serial chain, not the card's throughput (PERF.md).
// K9: the agents' networks are independent until the loss, so a CTA takes one
// agent and a tile of TS = 32 samples (grid: batch tiles x agents). Lane =
// sample; each of the 8 warps owns 8 of the 64 hidden units of every layer, so
// a thread carries 8 independent sums (its instruction-level parallelism) over
// the layer's inputs, which it reads from [row][TS+1] tiles of activations in
// shared memory, the agent's weights (critic, target critic, actor: 92 KB)
// being broadcast from shared memory too. Each sum still runs over its inputs
// in order from the first product, the plain version's order: the expected-Q
// gradient p (qbar - E) is ill-conditioned in float32 on a trained critic
// (PERF.md), and in this order qbar, p and E agree with the plain version's to
// the bit. The five candidates' first layer is recomputed by each warp from
// the stored base. Target actions need every agent's target actor on a sample,
// so a first kernel computes them, one thread per (sample, agent), in the plain
// version's order (the argmax agrees). For the weight gradients, the CTA's
// threads share out the entries, each summed over the tile's samples in order
// (the critic's, then, reusing the tiles, the actor's); each CTA writes its
// partial gradient, and the reduce kernel sums the partials of an agent over
// the tiles in a fixed order. No float atomics: the result is the same from run
// to run.

#include "policy_mlp.cuh"

namespace {

constexpr int OW = 18;                   // simple_spread obs width
constexpr int K = MW;                    // move logits (spread has no comm head)
using Actor = MlpLayout<OW, K>;          // one actor's packed weights
constexpr int W1 = Actor::W1, B1 = Actor::B1, W2 = Actor::W2, B2 = Actor::B2, W3 = Actor::W3,
              B3 = Actor::B3, NW = Actor::NW;
constexpr int NWP = (NW + 3) / 4 * 4;    // an actor's padded stride (16-byte aligned rows)

// ---- K8 ---------------------------------------------------------------------

constexpr int MADDPG_THREADS = 32;       // one warp per CTA, as K5

// _peragent_sample for one agent: its MLP on x, Gumbel-max over the move
// logits with uniform((K, n), step, 28 + 6i) (salt_g), eps-mixed: a uniform
// one-hot by Gumbel-max of zeros on salt_e, taken where uniform((1, n)) on
// salt_c is below eps. First-max tie-break. Not inlined (see K5).
__device__ __noinline__ int sample_action(const float* __restrict__ w, const float (&x)[OW],
                                          uint32_t salt_g, uint32_t salt_e, uint32_t salt_c,
                                          uint32_t n, uint32_t lane, float eps) {
  float z[K];
  policy_logits(w, x, z);
  int best = 0;
  float best_s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float s = gumbel_score(z[c], hash_uniform(salt_g, (uint32_t)c * n + lane));
    if (c == 0 || s > best_s) {
      best_s = s;
      best = c;
    }
  }
  if (eps > 0.0f) {
    int rnd = 0;
    float rnd_s = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float s = gumbel_score(0.0f, hash_uniform(salt_e, (uint32_t)c * n + lane));
      if (c == 0 || s > rnd_s) {
        rnd_s = s;
        rnd = c;
      }
    }
    if (hash_uniform(salt_c, lane) < eps) best = rnd;
  }
  return best;
}

template <int A, int L>
__global__ void __launch_bounds__(MADDPG_THREADS)
spread_maddpg_traj_kernel(const SpreadParams<A, L> c, const float* __restrict__ weights,
                          float* __restrict__ obs, float* __restrict__ act, float* __restrict__ rew,
                          float* __restrict__ obs2, float* __restrict__ rows, int n_envs,
                          int block_envs, int n_chunks, int t_chunk, int horizon, float eps,
                          uint32_t seed, uint32_t block_offset) {
  constexpr int RW = A * (2 * OW + K + 1);           // replay row width
  constexpr int R_ACT = A * OW, R_REW = R_ACT + A * K, R_OBS2 = R_REW + A;
  extern __shared__ __align__(16) float w[];
  for (int i = threadIdx.x; i < A * NW; i += blockDim.x) {
    const int ag = i / NW;
    w[ag * NWP + i - ag * NW] = weights[i];
  }
  __syncthreads();
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
      float* row = rows != nullptr ? rows + (ts * N + g) * RW : nullptr;
      float mv[A][MW];
#pragma unroll
      for (int i = 0; i < A; ++i) {
        float x[OW];
#pragma unroll
        for (int r = 0; r < OW; ++r) {
          x[r] = obs_entry<A, L>(i, r, ax, ay, vx, vy, lx, ly);
          if (row != nullptr) {
            row[i * OW + r] = x[r];
          } else {
            obs[((ts * A + i) * OW + r) * N + g] = x[r];
          }
        }
        const int base = 28 + 6 * i;
        const int a = sample_action(w + i * NWP, x, rollout_salt(mixed, step, base),
                                    rollout_salt(mixed, step, base + 1),
                                    rollout_salt(mixed, step, base + 2), n, lane, eps);
#pragma unroll
        for (int k = 0; k < MW; ++k) {
          mv[i][k] = (k == a) ? 1.0f : 0.0f;
          if (row != nullptr) {
            row[R_ACT + i * K + k] = mv[i][k];
          } else {
            act[((ts * A + i) * K + k) * N + g] = mv[i][k];
          }
        }
      }
      physics<A, L>(c, mv, ax, ay, vx, vy);
      const float r = spread_reward<A, L>(c, ax, ay, lx, ly);
      if (row != nullptr) {
#pragma unroll
        for (int i = 0; i < A; ++i) row[R_REW + i] = r;
      } else {
        rew[ts * N + g] = r;
      }
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int q = 0; q < OW; ++q) {
          const float v = obs_entry<A, L>(i, q, ax, ay, vx, vy, lx, ly);   // the TRUE s'
          if (row != nullptr) {
            row[R_OBS2 + i * OW + q] = v;
          } else {
            obs2[((ts * A + i) * OW + q) * N + g] = v;
          }
        }
      t += 1;
      if (t >= horizon) {                           // lane_fresh: call ids 3/4
        sample_state<A, L>(c, mixed, n, lane, step, 3, ax, ay, vx, vy, lx, ly);
        t = 0;
      }
    }
  }
}

// ---- K9 ---------------------------------------------------------------------

constexpr int A9 = 3;                       // agents
constexpr int J = A9 * (OW + K);            // the critic's joint input: all obs, then all actions
constexpr int AO = A9 * OW, AK = A9 * K;
constexpr int RW9 = A9 * (2 * OW + K + 1);  // replay row [obs | act | rew | obs2]
constexpr int R9_REW = AO + AK, R9_OBS2 = R9_REW + A9;
// one critic J-64-64-1, kernel layout: w1 [H,J], b1 [H], w2 [H,H], b2 [H], w3 [1,H], b3 [1]
constexpr int CW1 = 0, CB1 = CW1 + H * J, CW2 = CB1 + H, CB2 = CW2 + H * H, CW3 = CB2 + H,
              CB3 = CW3 + H, NC = CB3 + 1;
constexpr int NCP = (NC + 3) / 4 * 4;
// the weight buffer: actors, critics, target actors, target critics, agent-major
constexpr int OFF_A = 0, OFF_C = OFF_A + A9 * NWP, OFF_TA = OFF_C + A9 * NCP,
              OFF_TC = OFF_TA + A9 * NWP, N_WEIGHTS = OFF_TC + A9 * NCP;
// an agent's gradient: its actor (the NW layout), its critic (the NC layout),
// then the (critic loss, Q, actor objective) sums
constexpr int G_ACTOR = 0, G_CRITIC = NW, G_MS = G_CRITIC + NC, NG9 = G_MS + 3;
constexpr int TS9 = 32;                     // samples per CTA: lane = sample
constexpr int LD9 = TS9 + 1;                // tile row stride (rows read across lanes and down
                                            // columns without bank conflicts)
constexpr int THREADS9 = 256;               // 8 warps, each owning 8 of the 64 hidden units
constexpr int GW = H / (THREADS9 / 32);     // hidden units per warp
// tile rows: inputs (the joint, or the agent's obs), the candidates' base
// pre-activation, h1, h2, gh1, gh2, output gradients (1 critic, 5 actor), the
// five candidates' h2
constexpr int R_X = 0, R_BASE = R_X + J, R_H1 = R_BASE + H, R_H2 = R_H1 + H, R_GH1 = R_H2 + H,
              R_GH2 = R_GH1 + H, R_G3 = R_GH2 + H, R_CAND = R_G3 + K, R_N9 = R_CAND + K * H;
// shared memory: the agent's critic, target critic and actor, per-sample
// scalars (y, q, qbar [K], logits [K], metric terms [3]), then the tiles
constexpr int S_C = 0, S_TC = S_C + NCP, S_A = S_TC + NCP, S_Y = S_A + NWP, S_Q = S_Y + TS9,
              S_QC = S_Q + TS9, S_Z = S_QC + K * TS9, S_MS = S_Z + K * TS9,
              S_TILE = (S_MS + 3 * TS9 + 3) / 4 * 4;
constexpr size_t SMEM9 = (size_t)(S_TILE + R_N9 * LD9) * sizeof(float);
static_assert(OFF_TA % 4 == 0 && NCP % 4 == 0, "actors' rows must stay 16-byte aligned");
static_assert(GW == 8 && TS9 == 32, "a warp owns 8 hidden units of 32 samples");

struct MaddpgConsts {
  float gamma;
  float ent_coef;
  float inv;                                // 1 / (A * B)
};

// one thread per (sample, agent): the target actor's first-argmax move on s'
__global__ void __launch_bounds__(128)
maddpg_target_actions_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                             int* __restrict__ act2, int batch) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= A9 * batch) return;
  const int i = idx / batch, b = idx - i * batch;
  float x[OW];
#pragma unroll
  for (int r = 0; r < OW; ++r) x[r] = rows[(size_t)b * RW9 + R9_OBS2 + i * OW + r];
  float z[K];
  policy_logits(weights + OFF_TA + i * NWP, x, z);
  int best = 0;
#pragma unroll
  for (int c = 1; c < K; ++c)
    if (z[c] > z[best]) best = c;
  act2[idx] = best;
}

// The warp's GW units g0.. of a dense layer on the tile rows at x (this lane's
// column, stride LD9): acc[j] = sum over the NIN inputs, in order from the
// first product, of w[(g0 + j) * NIN + h] x[h]. The units are independent
// sums (the lane's instruction-level parallelism); the weights are broadcast.
template <int NIN>
__device__ __forceinline__ void dense_units(const float* __restrict__ w, const float* x, int g0,
                                            float (&acc)[GW]) {
  const float x0 = x[0];
#pragma unroll
  for (int j = 0; j < GW; ++j) acc[j] = w[(g0 + j) * NIN] * x0;
#pragma unroll 4
  for (int h = 1; h < NIN; ++h) {
    const float xh = x[h * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = acc[j] + w[(g0 + j) * NIN + h] * xh;
  }
}

// layer 2 of a critic on the h1 rows at x: h2 = tanh(w2 h1 + b2) into rows out
__device__ __forceinline__ void critic_layer2(const float* __restrict__ wc, const float* x,
                                              float* out, int g0) {
  float acc[GW];
  dense_units<H>(wc + CW2, x, g0, acc);
#pragma unroll
  for (int j = 0; j < GW; ++j) out[(g0 + j) * LD9] = tanhf(acc[j] + wc[CB2 + g0 + j]);
}

// a critic's output on the h2 rows at x: sum over the 64 units in order, then b3
__device__ __forceinline__ float critic_out(const float* __restrict__ wc, const float* x) {
  float q = wc[CW3] * x[0];
  for (int g = 1; g < H; ++g) q = q + wc[CW3 + g] * x[g * LD9];
  return q + wc[CB3];
}

// the weight gradient of an NIN-64-64-NOUT net summed over the tile's samples
// in order: entry e of the NW/NC layout, the CTA's threads taking every
// blockDim-th entry; x at tile row `rx`
template <int NIN, int NOUT>
__device__ __forceinline__ void weight_grads(const float* __restrict__ tile, int rx,
                                             float* __restrict__ part) {
  constexpr int E_B1 = H * NIN, E_W2 = E_B1 + H, E_B2 = E_W2 + H * H, E_W3 = E_B2 + H,
                E_B3 = E_W3 + NOUT * H, NE = E_B3 + NOUT;
  for (int e = threadIdx.x; e < NE; e += blockDim.x) {
    int ra, rb = -1;                         // the sum of row ra (times row rb)
    if (e < E_B1) {
      ra = R_GH1 + e / NIN;
      rb = rx + e % NIN;
    } else if (e < E_W2) {
      ra = R_GH1 + e - E_B1;
    } else if (e < E_B2) {
      ra = R_GH2 + (e - E_W2) / H;
      rb = R_H1 + (e - E_W2) % H;
    } else if (e < E_W3) {
      ra = R_GH2 + e - E_B2;
    } else if (e < E_B3) {
      ra = R_G3 + (e - E_W3) / H;
      rb = R_H2 + (e - E_W3) % H;
    } else {
      ra = R_G3 + e - E_B3;
    }
    const float* pa = tile + ra * LD9;
    float acc = 0.0f;
    if (rb >= 0) {
      const float* pb = tile + rb * LD9;
#pragma unroll 8
      for (int s = 0; s < TS9; ++s) acc = acc + pa[s] * pb[s];
    } else {
#pragma unroll 8
      for (int s = 0; s < TS9; ++s) acc = acc + pa[s];
    }
    part[e] = acc;
  }
}

// grid (batch tiles of TS9 samples, agents), THREADS9 threads: lane = sample,
// warp w owns hidden units 8w .. 8w + 7 of every layer; partials [A][tiles][NG9]
__global__ void __launch_bounds__(THREADS9, 1)
maddpg_update_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                     const int* __restrict__ act2, float* __restrict__ partials, int batch,
                     MaddpgConsts k) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, s = tid & 31, g0 = (tid >> 5) * GW;
  const int i = blockIdx.y;
  const int b0 = blockIdx.x * TS9;
  float* wc = smem + S_C;
  float* wt = smem + S_TC;
  float* wa = smem + S_A;
  float* tile = smem + S_TILE;
  float* col = tile + s;                    // this lane's sample column
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * NG9;
  const bool valid = b0 + s < batch;
  const float* rb = rows + (size_t)(valid ? b0 + s : 0) * RW9;

  for (int e = tid; e < NC; e += THREADS9) {
    wc[e] = weights[OFF_C + i * NCP + e];
    wt[e] = weights[OFF_TC + i * NCP + e];
  }
  for (int e = tid; e < NW; e += THREADS9) wa[e] = weights[OFF_A + i * NWP + e];
  // s' and the target actions a' (invalid lanes read sample 0 and are masked)
  for (int r = tid >> 5; r < AO; r += THREADS9 / 32) col[(R_X + r) * LD9] = rb[R9_OBS2 + r];
  for (int r = tid >> 5; r < AK; r += THREADS9 / 32) {
    const int a = act2[(r / K) * batch + (valid ? b0 + s : b0)];
    col[(R_X + AO + r) * LD9] = (r % K == a) ? 1.0f : 0.0f;
  }
  __syncthreads();

  // ---- TD target: y = r_i + gamma Q'_i(s', a') ----
  {
    float acc[GW];
    dense_units<J>(wt + CW1, col + R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j) col[(R_H1 + g0 + j) * LD9] = tanhf(acc[j] + wt[CB1 + g0 + j]);
  }
  __syncthreads();
  critic_layer2(wt, col + R_H1 * LD9, col + R_H2 * LD9, g0);
  __syncthreads();
  if (tid < TS9) smem[S_Y + s] = rb[R9_REW + i] + k.gamma * critic_out(wt, col + R_H2 * LD9);
  for (int r = tid >> 5; r < J; r += THREADS9 / 32) col[(R_X + r) * LD9] = rb[r];   // (s, a)
  __syncthreads();

  // ---- critic forward, the candidates' base, the candidates ----
  {
    float acc[GW];
    dense_units<J>(wc + CW1, col + R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float* row = wc + CW1 + (g0 + j) * J + AO + i * K;
      float own = row[0] * col[(R_X + AO + i * K) * LD9];    // agent i's own-action columns
#pragma unroll
      for (int c = 1; c < K; ++c) own = own + row[c] * col[(R_X + AO + i * K + c) * LD9];
      const float pre = acc[j] + wc[CB1 + g0 + j];
      col[(R_H1 + g0 + j) * LD9] = tanhf(pre);
      col[(R_BASE + g0 + j) * LD9] = pre - own;
    }
  }
  __syncthreads();
  critic_layer2(wc, col + R_H1 * LD9, col + R_H2 * LD9, g0);
  // candidate c: h1 = tanh(base + w1[:, own column c]), recomputed by each warp
  // for the 64 inputs of its units' sums
#pragma unroll 1
  for (int c = 0; c < K; ++c) {
    const float* wcol = wc + CW1 + AO + i * K + c;
    float acc[GW];
    float x = tanhf(col[R_BASE * LD9] + wcol[0]);
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = wc[CW2 + (g0 + j) * H] * x;
#pragma unroll 4
    for (int h = 1; h < H; ++h) {
      x = tanhf(col[(R_BASE + h) * LD9] + wcol[h * J]);
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wc[CW2 + (g0 + j) * H + h] * x;
    }
#pragma unroll
    for (int j = 0; j < GW; ++j)
      col[(R_CAND + c * H + g0 + j) * LD9] = tanhf(acc[j] + wc[CB2 + g0 + j]);
  }
  __syncthreads();
  if (tid < TS9) {                          // warp 0: q and the TD gradient
    const float q = critic_out(wc, col + R_H2 * LD9);
    const float d = valid ? q - smem[S_Y + s] : 0.0f;
    smem[S_Q + s] = q;
    col[R_G3 * LD9] = (2.0f * k.inv) * d;
    smem[S_MS + s] = d * d;
    smem[S_MS + TS9 + s] = valid ? q : 0.0f;
  } else if (tid < TS9 * (1 + K)) {         // warps 1-5: the candidates' Q
    const int c = (tid >> 5) - 1;
    smem[S_QC + c * TS9 + s] = critic_out(wc, col + (R_CAND + c * H) * LD9);
  }
  __syncthreads();

  // ---- critic backward: gh2 = w3 g3 (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2) ----
  {
    const float g3 = col[R_G3 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h2 = col[(R_H2 + g0 + j) * LD9];
      col[(R_GH2 + g0 + j) * LD9] = (wc[CW3 + g0 + j] * g3) * (1.0f - h2 * h2);
    }
  }
  __syncthreads();
  {
    float acc[GW];                            // units h = g0 + j, summed over g in order
    const float gh2 = col[R_GH2 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = wc[CW2 + g0 + j] * gh2;
    for (int g = 1; g < H; ++g) {
      const float x = col[(R_GH2 + g) * LD9];
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wc[CW2 + g * H + g0 + j] * x;
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h1 = col[(R_H1 + g0 + j) * LD9];
      col[(R_GH1 + g0 + j) * LD9] = acc[j] * (1.0f - h1 * h1);
    }
  }
  __syncthreads();
  weight_grads<J, 1>(tile, R_X, part + G_CRITIC);
  __syncthreads();

  // ---- actor: forward, expected-Q and entropy gradient, backward ----
  for (int r = tid >> 5; r < OW; r += THREADS9 / 32) col[(R_X + r) * LD9] = rb[i * OW + r];
  __syncthreads();
  {
    float acc[GW];
    dense_units<OW>(wa + W1, col + R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j) col[(R_H1 + g0 + j) * LD9] = tanhf(acc[j] + wa[B1 + g0 + j]);
  }
  __syncthreads();
  {
    float acc[GW];
    dense_units<H>(wa + W2, col + R_H1 * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j) col[(R_H2 + g0 + j) * LD9] = tanhf(acc[j] + wa[B2 + g0 + j]);
  }
  __syncthreads();
  if (tid < TS9 * K) {                      // warps 0-4: logit c, summed over the units in order
    const int c = tid >> 5;
    float z = wa[W3 + c * H] * col[R_H2 * LD9];
    for (int g = 1; g < H; ++g) z = z + wa[W3 + c * H + g] * col[(R_H2 + g) * LD9];
    smem[S_Z + c * TS9 + s] = z + wa[B3 + c];
  }
  __syncthreads();
  if (tid < TS9) {                          // warp 0: _softmax_eps, E, the logit gradient
    float z[K], zm = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      z[c] = smem[S_Z + c * TS9 + s];
      zm = c == 0 ? z[0] : fmaxf(zm, z[c]);
    }
    float e[K], sum = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      e[c] = expf(z[c] - zm);
      sum = (c == 0) ? e[0] : sum + e[c];
    }
    float p[K], sv[K], qc[K], ent = 0.0f, eq = 0.0f, sps = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      qc[c] = smem[S_QC + c * TS9 + s];
      p[c] = e[c] / sum;
      const float lg = logf(p[c] + 1e-10f);
      sv[c] = lg + p[c] / (p[c] + 1e-10f);
      ent = ent - p[c] * lg;
      eq = (c == 0) ? p[0] * qc[0] : eq + p[c] * qc[c];
      sps = (c == 0) ? p[0] * sv[0] : sps + p[c] * sv[c];
    }
#pragma unroll
    for (int c = 0; c < K; ++c)
      col[(R_G3 + c) * LD9] =
          valid ? (-(p[c] * (qc[c] - eq)) + (k.ent_coef * p[c]) * (sv[c] - sps)) * k.inv : 0.0f;
    smem[S_MS + 2 * TS9 + s] = valid ? eq + k.ent_coef * ent : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < GW; ++j) {            // gh2 = (w3^T gz) (1 - h2^2)
    const int g = g0 + j;
    float sg = wa[W3 + g] * col[R_G3 * LD9];
#pragma unroll
    for (int c = 1; c < K; ++c) sg = sg + wa[W3 + c * H + g] * col[(R_G3 + c) * LD9];
    const float h2 = col[(R_H2 + g) * LD9];
    col[(R_GH2 + g) * LD9] = sg * (1.0f - h2 * h2);
  }
  __syncthreads();
  {
    float acc[GW];
    const float gh2 = col[R_GH2 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = wa[W2 + g0 + j] * gh2;
    for (int g = 1; g < H; ++g) {
      const float x = col[(R_GH2 + g) * LD9];
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wa[W2 + g * H + g0 + j] * x;
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h1 = col[(R_H1 + g0 + j) * LD9];
      col[(R_GH1 + g0 + j) * LD9] = acc[j] * (1.0f - h1 * h1);
    }
  }
  __syncthreads();
  weight_grads<OW, K>(tile, R_X, part + G_ACTOR);

  // metric sums over the tile's samples, in order
  if (tid < 3) {
    float total = 0.0f;
    for (int q = 0; q < TS9; ++q) total = total + smem[S_MS + tid * TS9 + q];
    part[G_MS + tid] = total;
  }
}

// out[a][e] = sum over tiles t = 0, 1, ... of partials[a][t][e]
__global__ void maddpg_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= A9 * NG9) return;
  const int a = idx / NG9, e = idx - a * NG9;
  float total = 0.0f;
  for (int t = 0; t < n_tiles; ++t) total = total + partials[((size_t)a * n_tiles + t) * NG9 + e];
  out[idx] = total;
}

}  // namespace

extern "C" {

// K8: the tensor form (obs, act, rew, obs2) when rows is null, else the rows form
int mpe_spread_maddpg_traj_a3l3(const void* params, const float* weights, float* obs, float* act,
                                float* rew, float* obs2, float* rows, int n_envs, int block_envs,
                                int n_chunks, int t_chunk, int horizon, float eps, uint32_t seed,
                                uint32_t block_offset, cudaStream_t stream) {
  const size_t smem = (size_t)3 * NWP * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spread_maddpg_traj_kernel<3, 3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_envs + MADDPG_THREADS - 1) / MADDPG_THREADS;
  spread_maddpg_traj_kernel<3, 3><<<blocks, MADDPG_THREADS, smem, stream>>>(
      *static_cast<const SpreadParams<3, 3>*>(params), weights, obs, act, rew, obs2, rows, n_envs,
      block_envs, n_chunks, t_chunk, horizon, eps, seed, block_offset);
  return (int)cudaGetLastError();
}

// K9. weights: [N_WEIGHTS] (see OFF_*); rows [batch, RW9]; act2 [A, batch]
// scratch (the target actions, for inspection); partials [A, tiles, NG9]
// scratch; out [A, NG9]
int mpe_maddpg_update_a3h64(const float* weights, const float* rows, int* act2, float* partials,
                            float* out, int batch, float gamma, float ent_coef, float inv,
                            cudaStream_t stream) {
  maddpg_target_actions_kernel<<<(A9 * batch + 127) / 128, 128, 0, stream>>>(weights, rows, act2,
                                                                             batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(maddpg_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM9);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (batch + TS9 - 1) / TS9;
  const MaddpgConsts k{gamma, ent_coef, inv};
  maddpg_update_kernel<<<dim3(n_tiles, A9), THREADS9, SMEM9, stream>>>(weights, rows, act2,
                                                                       partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_reduce_kernel<<<(A9 * NG9 + 255) / 256, 256, 0, stream>>>(partials, out, n_tiles);
  return (int)cudaGetLastError();
}

// the layout constants the wrapper mirrors: 0 actor stride, 1 critic stride,
// 2 weights, 3 gradient per agent, 4 samples per tile
int mpe_maddpg_update_layout(int which) {
  const int v[5] = {NWP, NCP, N_WEIGHTS, NG9, TS9};
  return (which >= 0 && which < 5) ? v[which] : -1;
}

}  // extern "C"

// Hopper (sm_90a) kernels of the fused MADDPG loop, for the nine scenarios of
// scenario_blocks.cuh.
//
// K8  maddpg_traj_kernel<S>  replaces  mpe_tpu/ops/fused_maddpg.py::_maddpg_traj_kernel
//     (fused_maddpg_trajectory): per step, each agent's own actor
//     OW-64-64-(5+C) on its obs, Gumbel-max over the move logits (and over
//     the comm logits where the scenario speaks), each head eps-mixed with a
//     uniform one-hot; the step with the silent agents' comm zeroed, the
//     reward rows, per-lane reset at the horizon. Out: obs [T,A,OW,N], act
//     [T,A,5+C,N] one-hot (the raw comm sample, silent agents' included), rew
//     [T,R,N], obs2 [T,A,OW,N] (the true pre-reset next obs), or the finished
//     replay rows [T,N,W], W = A*(2*OW + 5 + C + 1), the shared reward
//     broadcast to every agent.
// K9  maddpg_target_actions_kernel<D> + maddpg_td_kernel<D> +
//     maddpg_update_kernel<D> + maddpg_reduce_kernel<D>, D = MaddpgDims<A, OW, C>,
//     replace  mpe_tpu/ops/fused_maddpg_update.py::_maddpg_update_kernel
//     (fused_maddpg_update): on a batch of replay rows [B, W], the first-argmax
//     target actions per head, the TD targets y = r + gamma Q'(s', a'), the
//     critic's forward and backward on the mean of (Q - y)^2 over [A, B], the
//     exact expected-Q actor gradient of the factored policy over the full
//     (move x comm) candidate grid, each candidate's Q built from the critic's
//     layer-1 pre-activation (minus the agent's own-action columns, plus the
//     candidate's two columns), and the entropy adjoint of both heads with its
//     1e-10 eps. Out: every agent's actor and critic gradient and the metric
//     sums.
//
// What bounds them: fp32 operations. K8 runs A actors per env-step (64 (OW +
// 64 + 5 + C) multiply-adds each) and writes 4 W bytes of replay row; K9
// needs per (sample, agent) pair the target and live critics on the J = A (OW
// + 5 + C) joint inputs, 5 max(C, 1) candidates' layers 2-3 and the backward
// passes (chip_smoke.py::OPS counts them) against 4 W bytes read per sample.
//
// What the designs do about it.
// K8 is K5 (mpe_policy.cu) with a weight block per agent: one thread owns one
// env lane, its world state (S::W) and each agent's last utterance index
// (the comm the obs reads, -1 for a zero row: a silent agent, every agent
// after a reset) in registers; the A actors' weights (at most 6 x 6,988
// floats, 168 KB, on simple_world_comm) in dynamic shared memory, each
// agent's block padded to a 16-byte boundary for the float4 rows of
// policy_mlp.cuh. The MLP is the one K5 uses, inside a __noinline__ sampler,
// so it gets its own register allocation. At 1024 envs this fills 32 warps,
// one per SM on 32 SMs: the collection is one lane's serial chain, not the
// card's throughput (PERF.md).
// K9: the agents' networks are independent until the loss, so a CTA takes one
// agent and a tile of TS9 = 32 samples (grid: batch tiles x agents). Lane =
// sample; each of the 8 warps owns 8 of the 64 hidden units of every layer, so
// a thread carries 8 independent sums (its instruction-level parallelism) over
// the layer's inputs, which it reads from [row][TS9+1] tiles of activations in
// shared memory, the agent's weights being broadcast from shared memory too.
// Each sum still runs over its inputs in order from the first product, the
// plain version's order: the expected-Q gradient p (qbar - E) is
// ill-conditioned in float32 on a trained critic (PERF.md), and in this order
// qbar, p and E agree with the plain version's to the bit. Three kernels run
// before the gradient so that its CTA holds only the live critic and the actor
// (simple_world_comm's J = 258 critic alone is 83 KB): the target actions,
// one thread per (sample, agent), in the plain version's order (the argmax
// agrees); the TD targets y, a CTA per (tile, agent) holding the target
// critic. The gradient kernel then runs the critic's forward and backward and
// its weight gradient, and only then the candidates: their layer-1 inputs are
// recomputed by each warp from the stored base, their h2 rows take the place
// of the joint input's rows (no longer needed) CG candidates at a time (8,
// one per warp), and only each
// candidate's Q is kept, [cand][sample]; then the actor. For the
// weight gradients, the CTA's threads share out the entries, each summed over
// the tile's samples in order; each CTA writes its partial gradient, and the
// reduce kernel sums the partials of an agent over the tiles in a fixed
// order. No float atomics: the result is the same from run to run.

#include "scenario_blocks.cuh"
#include "policy_mlp.cuh"

namespace {

// The widths of one scenario's MADDPG nets and replay rows: A agents, OW obs
// rows, a head of MW moves and C comm logits (0 without comm), hidden H
template <int A_, int OW_, int C_>
struct MaddpgDims {
  static constexpr int A = A_, OW = OW_, C = C_, K = MW + C_;
  static constexpr int CX = C > 0 ? C : 1;                  // comm choices per move
  static constexpr int NCAND = MW * CX;                     // candidate m * CX + j
  static constexpr int NH = C > 0 ? 2 : 1;                  // heads
  using Actor = MlpLayout<OW, K>;                           // one actor's packed weights
  static constexpr int NW = Actor::NW;
  static constexpr int NWP = (NW + 3) / 4 * 4;              // padded stride (16-byte rows)
  static constexpr int J = A * (OW + K);                    // the critic's joint: obs, actions
  static constexpr int AO = A * OW, AK = A * K;
  static constexpr int RW = A * (2 * OW + K + 1);           // row [obs | act | rew | obs2]
  static constexpr int R_REW = AO + AK, R_OBS2 = R_REW + A;
  // one critic J-64-64-1, kernel layout: w1 [H,J], b1 [H], w2 [H,H], b2 [H], w3 [1,H], b3 [1]
  static constexpr int CW1 = 0, CB1 = CW1 + H * J, CW2 = CB1 + H, CB2 = CW2 + H * H,
                       CW3 = CB2 + H, CB3 = CW3 + H, NC = CB3 + 1;
  static constexpr int NCP = (NC + 3) / 4 * 4;
  // the weight buffer: actors, critics, target actors, target critics, agent-major
  static constexpr int OFF_A = 0, OFF_C = OFF_A + A * NWP, OFF_TA = OFF_C + A * NCP,
                       OFF_TC = OFF_TA + A * NWP, N_WEIGHTS = OFF_TC + A * NCP;
  // an agent's gradient: its actor (the NW layout), its critic (the NC
  // layout), then the (critic loss, Q, actor objective) sums
  static constexpr int G_ACTOR = 0, G_CRITIC = NW, G_MS = G_CRITIC + NC, NG = G_MS + 3;
  static_assert(OFF_TA % 4 == 0 && NCP % 4 == 0, "actors' rows must stay 16-byte aligned");
};

template <class S>
using DimsOf = MaddpgDims<S::A, S::OW, S::C>;

// ---- K8 ---------------------------------------------------------------------

constexpr int MADDPG_THREADS = 32;       // one warp per CTA, as K5

// One head of _peragent_sample: Gumbel-max over logits z[K0, K0 + W) with
// uniform((W, n)) on salt_g, eps-mixed: a uniform one-hot by Gumbel-max of
// zeros on salt_e, taken where uniform((1, n)) on salt_c is below eps.
// First-max tie-break.
template <int K0, int W, int KP>
__device__ __forceinline__ int eps_gumbel_head(const float (&z)[KP], uint32_t salt_g,
                                               uint32_t salt_e, uint32_t salt_c, uint32_t n,
                                               uint32_t lane, float eps) {
  int best = 0;
  float best_s = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float s = gumbel_score(z[K0 + c], hash_uniform(salt_g, (uint32_t)c * n + lane));
    if (c == 0 || s > best_s) {
      best_s = s;
      best = c;
    }
  }
  if (eps > 0.0f) {
    int rnd = 0;
    float rnd_s = 0.0f;
#pragma unroll
    for (int c = 0; c < W; ++c) {
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

// agent i's MLP on x, its move head on call ids 28 + 6i (Gumbel), 29 + 6i
// (eps one-hot), 30 + 6i (eps coin) and, where the scenario speaks, its comm
// head on 31-33 + 6i, drawn for a silent agent too -> move + 16 comm. Not
// inlined (see K5).
template <class S>
__device__ __noinline__ int sample_action(const float* __restrict__ w, const float (&x)[S::OW],
                                          uint32_t mixed, int step, int agent, uint32_t n,
                                          uint32_t lane, float eps) {
  float z[MW + S::C];
  policy_logits(w, x, z);
  const int base = 28 + 6 * agent;
  const int move = eps_gumbel_head<0, MW>(z, rollout_salt(mixed, step, base),
                                          rollout_salt(mixed, step, base + 1),
                                          rollout_salt(mixed, step, base + 2), n, lane, eps);
  int comm = 0;
  if constexpr (S::C > 0) {
    comm = eps_gumbel_head<MW, S::C>(z, rollout_salt(mixed, step, base + 3),
                                     rollout_salt(mixed, step, base + 4),
                                     rollout_salt(mixed, step, base + 5), n, lane, eps);
  }
  return move + 16 * comm;
}

template <class S>
__global__ void __launch_bounds__(MADDPG_THREADS)
maddpg_traj_kernel(const typename S::Params c, const float* __restrict__ weights,
                   float* __restrict__ obs, float* __restrict__ act, float* __restrict__ rew,
                   float* __restrict__ obs2, float* __restrict__ rows, int n_envs,
                   int block_envs, int n_chunks, int t_chunk, int horizon, float eps,
                   uint32_t seed, uint32_t block_offset) {
  using D = DimsOf<S>;
  constexpr int A = S::A, OW = S::OW, K = D::K, R = S::R;
  static_assert(R == 1 || R == A, "a replay row holds one reward per agent");
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < A * D::NW; i += blockDim.x) {
    const int ag = i / D::NW;
    smem[ag * D::NWP + i - ag * D::NW] = weights[i];
  }
  __syncthreads();
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
      float* row = rows != nullptr ? rows + (ts * N + g) * D::RW : nullptr;
      float mv[A][MW];
      int ncidx[A];
      {
        float cm[A][S::CW];
        comm_rows<S>(cidx, cm);
        const typename S::Derived d = S::derive(c, wd, cm);
#pragma unroll
        for (int i = 0; i < A; ++i) {
          float x[OW];
#pragma unroll
          for (int r = 0; r < OW; ++r) {
            x[r] = S::obs(i, r, wd, cm, d);
            if (row != nullptr) {
              row[i * OW + r] = x[r];
            } else {
              obs[((ts * A + i) * OW + r) * N + g] = x[r];
            }
          }
          const int a = sample_action<S>(smem + i * D::NWP, x, mixed, step, i, n, lane, eps);
          const int move = a & 15, comm = a >> 4;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float v = (k < MW ? k == move : k - MW == comm) ? 1.0f : 0.0f;
            if (k < MW) mv[i][k] = v;
            if (row != nullptr) {
              row[D::AO + i * K + k] = v;
            } else {
              act[((ts * A + i) * K + k) * N + g] = v;
            }
          }
          ncidx[i] = (S::C > 0 && !S::silent(c, i)) ? comm : -1;   // the dynamics' comm
        }
      }
      S::physics(c, mv, wd);
#pragma unroll
      for (int i = 0; i < A; ++i) cidx[i] = ncidx[i];
      float cm[A][S::CW];
      comm_rows<S>(cidx, cm);
      const typename S::Derived d = S::derive(c, wd, cm);
      float r[R];
      S::reward(c, wd, cm, d, r);
      if (row != nullptr) {
#pragma unroll
        for (int i = 0; i < A; ++i) row[D::R_REW + i] = r[R == 1 ? 0 : i];
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) rew[(ts * R + k) * N + g] = r[k];
      }
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int q = 0; q < OW; ++q) {
          const float v = S::obs(i, q, wd, cm, d);                     // the TRUE s'
          if (row != nullptr) {
            row[D::R_OBS2 + i * OW + q] = v;
          } else {
            obs2[((ts * A + i) * OW + q) * N + g] = v;
          }
        }
      t += 1;
      if (t >= horizon) {                           // lane_fresh: call ids 3/4, goals 24+2+g
        draw_world<S>(c, mixed, n, lane, step, 3, 24, wd);
        reset_comm<S>(cidx);
        t = 0;
      }
    }
  }
}

// ---- K9 ---------------------------------------------------------------------

constexpr int TS9 = 32;                     // samples per CTA: lane = sample
constexpr int LD9 = TS9 + 1;                // tile row stride (rows read across lanes and down
                                            // columns without bank conflicts)
constexpr int THREADS9 = 256;               // 8 warps, each owning 8 of the 64 hidden units
constexpr int WARPS9 = THREADS9 / 32;
constexpr int GW = H / WARPS9;              // hidden units per warp
constexpr size_t SMEM_MAX = 232448;         // a CTA's dynamic shared memory on sm_90
static_assert(GW == 8 && TS9 == 32, "a warp owns 8 hidden units of 32 samples");

// The gradient kernel's shared memory (floats): the agent's critic and actor,
// per-sample scalars (y, q, the candidates' Q [NCAND], logits [K], metric
// terms [3]), then the tiles. Tile rows: the inputs (the joint, later the
// agent's obs; in between the h2 rows of CG candidates, one per warp), the
// candidates' base pre-activation, h1, h2, gh1, gh2, output gradients (1
// critic, K actor). launch_update's static_assert holds every scenario's
// layout to an SM's shared memory.
template <class D>
struct Layout9 {
  static constexpr int CG = D::NCAND < WARPS9 ? D::NCAND : WARPS9;
  static constexpr int RXN = D::J > CG * H ? D::J : CG * H;
  static constexpr int R_X = 0, R_CAND = 0, R_BASE = RXN, R_H1 = R_BASE + H, R_H2 = R_H1 + H,
                       R_GH1 = R_H2 + H, R_GH2 = R_GH1 + H, R_G3 = R_GH2 + H, R_N = R_G3 + D::K;
  static constexpr int S_C = 0, S_A = S_C + D::NCP, S_Y = S_A + D::NWP, S_Q = S_Y + TS9,
                       S_QC = S_Q + TS9, S_Z = S_QC + D::NCAND * TS9, S_MS = S_Z + D::K * TS9,
                       S_TILE = (S_MS + 3 * TS9 + 3) / 4 * 4;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LD9) * sizeof(float);
};

// the TD kernel's tiles: the joint (s', a'), h1, h2, then y
template <class D>
struct TdLayout {
  static constexpr int R_X = 0, R_H1 = D::J, R_H2 = R_H1 + H, R_N = R_H2 + H;
  static constexpr size_t SMEM = (size_t)(D::NCP + R_N * LD9) * sizeof(float);
};

struct MaddpgConsts {
  float gamma;
  float ent_coef;
  float inv;                                // 1 / (A * B)
};

// first max of z[K0, K0 + W)
template <int K0, int W, int KP>
__device__ __forceinline__ int first_argmax(const float (&z)[KP]) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < W; ++c)
    if (z[K0 + c] > z[K0 + best]) best = c;
  return best;
}

// one thread per (sample, agent): the target actor's first-argmax move and
// comm on s' -> act2 [A, NH, B]
template <class D>
__global__ void __launch_bounds__(128)
maddpg_target_actions_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                             int* __restrict__ act2, int batch) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D::A * batch) return;
  const int i = idx / batch, b = idx - i * batch;
  float x[D::OW];
#pragma unroll
  for (int r = 0; r < D::OW; ++r) x[r] = rows[(size_t)b * D::RW + D::R_OBS2 + i * D::OW + r];
  float z[D::K];
  policy_logits(weights + D::OFF_TA + i * D::NWP, x, z);
  act2[(i * D::NH) * batch + b] = first_argmax<0, MW>(z);
  if constexpr (D::C > 0) act2[(i * D::NH + 1) * batch + b] = first_argmax<MW, D::C>(z);
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
template <class D>
__device__ __forceinline__ void critic_layer2(const float* __restrict__ wc, const float* x,
                                              float* out, int g0) {
  float acc[GW];
  dense_units<H>(wc + D::CW2, x, g0, acc);
#pragma unroll
  for (int j = 0; j < GW; ++j) out[(g0 + j) * LD9] = tanhf(acc[j] + wc[D::CB2 + g0 + j]);
}

// a critic's output on the h2 rows at x: sum over the 64 units in order, then b3
template <class D>
__device__ __forceinline__ float critic_out(const float* __restrict__ wc, const float* x) {
  float q = wc[D::CW3] * x[0];
  for (int g = 1; g < H; ++g) q = q + wc[D::CW3 + g] * x[g * LD9];
  return q + wc[D::CB3];
}

// the weight gradient of an NIN-64-64-NOUT net summed over the tile's samples
// in order: entry e of the NW/NC layout, the CTA's threads taking every
// blockDim-th entry; x at tile row `rx`
template <class L, int NIN, int NOUT>
__device__ __forceinline__ void weight_grads(const float* __restrict__ tile, int rx,
                                             float* __restrict__ part) {
  constexpr int E_B1 = H * NIN, E_W2 = E_B1 + H, E_B2 = E_W2 + H * H, E_W3 = E_B2 + H,
                E_B3 = E_W3 + NOUT * H, NE = E_B3 + NOUT;
  for (int e = threadIdx.x; e < NE; e += blockDim.x) {
    int ra, rb = -1;                         // the sum of row ra (times row rb)
    if (e < E_B1) {
      ra = L::R_GH1 + e / NIN;
      rb = rx + e % NIN;
    } else if (e < E_W2) {
      ra = L::R_GH1 + e - E_B1;
    } else if (e < E_B2) {
      ra = L::R_GH2 + (e - E_W2) / H;
      rb = L::R_H1 + (e - E_W2) % H;
    } else if (e < E_W3) {
      ra = L::R_GH2 + e - E_B2;
    } else if (e < E_B3) {
      ra = L::R_G3 + (e - E_W3) / H;
      rb = L::R_H2 + (e - E_W3) % H;
    } else {
      ra = L::R_G3 + e - E_B3;
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

// _softmax_eps of one head, logits z[K0, K0 + W) (stride TS9): p, s = log(p +
// 1e-10) + p / (p + 1e-10) -> the entropy -sum p log(p + 1e-10), each sum in
// index order
template <int K0, int W, int K>
__device__ __forceinline__ float softmax_eps(const float* z, float (&p)[K], float (&sv)[K]) {
  float zm = 0.0f, sum = 0.0f, ent = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) zm = c == 0 ? z[K0 * TS9] : fmaxf(zm, z[(K0 + c) * TS9]);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    p[K0 + c] = expf(z[(K0 + c) * TS9] - zm);
    sum = c == 0 ? p[K0] : sum + p[K0 + c];
  }
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float pc = p[K0 + c] / sum;
    const float lg = logf(pc + 1e-10f);
    p[K0 + c] = pc;
    sv[K0 + c] = lg + pc / (pc + 1e-10f);
    ent = ent - pc * lg;
  }
  return ent;
}

// grid (batch tiles of TS9 samples, agents): y [A, B] = r_i + gamma Q'_i(s', a')
template <class D>
__global__ void __launch_bounds__(THREADS9)
maddpg_td_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                 const int* __restrict__ act2, float* __restrict__ y, int batch, float gamma) {
  using L = TdLayout<D>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, s = tid & 31, g0 = (tid >> 5) * GW;
  const int i = blockIdx.y;
  const int b0 = blockIdx.x * TS9;
  const bool valid = b0 + s < batch;
  const int b = valid ? b0 + s : b0;        // invalid lanes read sample b0 and write nothing
  const float* rb = rows + (size_t)b * D::RW;
  float* wt = smem;
  float* col = smem + D::NCP + s;           // this lane's sample column
  for (int e = tid; e < D::NC; e += THREADS9) wt[e] = weights[D::OFF_TC + i * D::NCP + e];
  for (int r = tid >> 5; r < D::AO; r += WARPS9) col[(L::R_X + r) * LD9] = rb[D::R_OBS2 + r];
  for (int r = tid >> 5; r < D::AK; r += WARPS9) {
    const int q = r / D::K, k = r % D::K;
    const int move = act2[(q * D::NH) * batch + b];
    const bool hot = k < MW ? k == move : k - MW == act2[(q * D::NH + 1) * batch + b];
    col[(L::R_X + D::AO + r) * LD9] = hot ? 1.0f : 0.0f;
  }
  __syncthreads();
  {
    float acc[GW];
    dense_units<D::J>(wt + D::CW1, col + L::R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j)
      col[(L::R_H1 + g0 + j) * LD9] = tanhf(acc[j] + wt[D::CB1 + g0 + j]);
  }
  __syncthreads();
  critic_layer2<D>(wt, col + L::R_H1 * LD9, col + L::R_H2 * LD9, g0);
  __syncthreads();
  if (tid < TS9 && valid)
    y[(size_t)i * batch + b] = rb[D::R_REW + i] + gamma * critic_out<D>(wt, col + L::R_H2 * LD9);
}

// grid (batch tiles of TS9 samples, agents), THREADS9 threads: lane = sample,
// warp w owns hidden units 8w .. 8w + 7 of every layer; partials [A][tiles][NG]
template <class D>
__global__ void __launch_bounds__(THREADS9, 1)
maddpg_update_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                     const float* __restrict__ y, float* __restrict__ partials, int batch,
                     MaddpgConsts k) {
  using L = Layout9<D>;
  constexpr int K = D::K, C = D::C, CX = D::CX, J = D::J;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, s = tid & 31, warp = tid >> 5, g0 = warp * GW;
  const int i = blockIdx.y;
  const int b0 = blockIdx.x * TS9;
  float* wc = smem + L::S_C;
  float* wa = smem + L::S_A;
  float* tile = smem + L::S_TILE;
  float* col = tile + s;                    // this lane's sample column
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;
  const bool valid = b0 + s < batch;
  const float* rb = rows + (size_t)(valid ? b0 + s : b0) * D::RW;

  for (int e = tid; e < D::NC; e += THREADS9) wc[e] = weights[D::OFF_C + i * D::NCP + e];
  for (int e = tid; e < D::NW; e += THREADS9) wa[e] = weights[D::OFF_A + i * D::NWP + e];
  if (tid < TS9) smem[L::S_Y + s] = valid ? y[(size_t)i * batch + b0 + s] : 0.0f;
  for (int r = warp; r < J; r += WARPS9) col[(L::R_X + r) * LD9] = rb[r];        // (s, a)
  __syncthreads();

  // ---- critic forward and the candidates' base ----
  {
    float acc[GW];
    dense_units<J>(wc + D::CW1, col + L::R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float* row = wc + D::CW1 + (g0 + j) * J + D::AO + i * K;
      float own = row[0] * col[(L::R_X + D::AO + i * K) * LD9];   // agent i's own-action columns
#pragma unroll
      for (int c = 1; c < K; ++c) own = own + row[c] * col[(L::R_X + D::AO + i * K + c) * LD9];
      const float pre = acc[j] + wc[D::CB1 + g0 + j];
      col[(L::R_H1 + g0 + j) * LD9] = tanhf(pre);
      col[(L::R_BASE + g0 + j) * LD9] = pre - own;
    }
  }
  __syncthreads();
  critic_layer2<D>(wc, col + L::R_H1 * LD9, col + L::R_H2 * LD9, g0);
  __syncthreads();
  if (tid < TS9) {                          // warp 0: q and the TD gradient
    const float q = critic_out<D>(wc, col + L::R_H2 * LD9);
    const float d = valid ? q - smem[L::S_Y + s] : 0.0f;
    smem[L::S_Q + s] = q;
    col[L::R_G3 * LD9] = (2.0f * k.inv) * d;
    smem[L::S_MS + s] = d * d;
    smem[L::S_MS + TS9 + s] = valid ? q : 0.0f;
  }
  __syncthreads();

  // ---- critic backward: gh2 = w3 g3 (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2) ----
  {
    const float g3 = col[L::R_G3 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h2 = col[(L::R_H2 + g0 + j) * LD9];
      col[(L::R_GH2 + g0 + j) * LD9] = (wc[D::CW3 + g0 + j] * g3) * (1.0f - h2 * h2);
    }
  }
  __syncthreads();
  {
    float acc[GW];                            // units h = g0 + j, summed over g in order
    const float gh2 = col[L::R_GH2 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = wc[D::CW2 + g0 + j] * gh2;
    for (int g = 1; g < H; ++g) {
      const float x = col[(L::R_GH2 + g) * LD9];
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wc[D::CW2 + g * H + g0 + j] * x;
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h1 = col[(L::R_H1 + g0 + j) * LD9];
      col[(L::R_GH1 + g0 + j) * LD9] = acc[j] * (1.0f - h1 * h1);
    }
  }
  __syncthreads();
  weight_grads<L, J, 1>(tile, L::R_X, part + D::G_CRITIC);
  __syncthreads();

  // ---- the candidates' Q, CG at a time in the joint's rows ----
  // candidate c = m CX + j: h1 = tanh(base + (w1[:, own move m] + w1[:, own
  // comm j])), recomputed by each warp for the 64 inputs of its units' sums
  for (int c0 = 0; c0 < D::NCAND; c0 += L::CG) {
    const int ng = D::NCAND - c0 < L::CG ? D::NCAND - c0 : L::CG;
#pragma unroll 1
    for (int cc = 0; cc < ng; ++cc) {
      const int m = (c0 + cc) / CX, jc = (c0 + cc) % CX;
      const float* wm = wc + D::CW1 + D::AO + i * K + m;
      const float* wj = wc + D::CW1 + D::AO + i * K + MW + jc;
      float acc[GW];
      float x = tanhf(col[L::R_BASE * LD9] + (C > 0 ? wm[0] + wj[0] : wm[0]));
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = wc[D::CW2 + (g0 + j) * H] * x;
#pragma unroll 4
      for (int h = 1; h < H; ++h) {
        x = tanhf(col[(L::R_BASE + h) * LD9] + (C > 0 ? wm[h * J] + wj[h * J] : wm[h * J]));
#pragma unroll
        for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wc[D::CW2 + (g0 + j) * H + h] * x;
      }
#pragma unroll
      for (int j = 0; j < GW; ++j)
        col[(L::R_CAND + cc * H + g0 + j) * LD9] = tanhf(acc[j] + wc[D::CB2 + g0 + j]);
    }
    __syncthreads();
    if (warp < ng)
      smem[L::S_QC + (c0 + warp) * TS9 + s] = critic_out<D>(wc, col + (L::R_CAND + warp * H) * LD9);
    __syncthreads();
  }

  // ---- actor: forward, expected-Q and entropy gradient, backward ----
  for (int r = warp; r < D::OW; r += WARPS9) col[(L::R_X + r) * LD9] = rb[i * D::OW + r];
  __syncthreads();
  {
    float acc[GW];
    dense_units<D::OW>(wa + D::Actor::W1, col + L::R_X * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j)
      col[(L::R_H1 + g0 + j) * LD9] = tanhf(acc[j] + wa[D::Actor::B1 + g0 + j]);
  }
  __syncthreads();
  {
    float acc[GW];
    dense_units<H>(wa + D::Actor::W2, col + L::R_H1 * LD9, g0, acc);
#pragma unroll
    for (int j = 0; j < GW; ++j)
      col[(L::R_H2 + g0 + j) * LD9] = tanhf(acc[j] + wa[D::Actor::B2 + g0 + j]);
  }
  __syncthreads();
  for (int c = warp; c < K; c += WARPS9) {  // logit c, summed over the units in order
    const float* w3 = wa + D::Actor::W3 + c * H;
    float z = w3[0] * col[L::R_H2 * LD9];
    for (int g = 1; g < H; ++g) z = z + w3[g] * col[(L::R_H2 + g) * LD9];
    smem[L::S_Z + c * TS9 + s] = z + wa[D::Actor::B3 + c];
  }
  __syncthreads();
  if (tid < TS9) {                          // warp 0: _softmax_eps per head, E, the gradients
    float p[K], sv[K];
    const float ent = softmax_eps<0, MW, K>(smem + L::S_Z + s, p, sv) +
                      (C > 0 ? softmax_eps<MW, C, K>(smem + L::S_Z + s, p, sv) : 0.0f);
    // qbar_m[m] = sum_j pc[j] Q[m CX + j], qbar_c[j] = sum_m pm[m] Q[m CX + j],
    // each from the first term in index order; without comm qbar_m[m] = Q[m]
    const float* qc = smem + L::S_QC + s;
    float qbar[K], eq = 0.0f, sps_m = 0.0f;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      float qm = qc[(m * CX) * TS9];
      if constexpr (C > 0) {
        qm = p[MW] * qm;
#pragma unroll
        for (int j = 1; j < C; ++j) qm = qm + p[MW + j] * qc[(m * CX + j) * TS9];
      }
      qbar[m] = qm;
      eq = m == 0 ? p[0] * qm : eq + p[m] * qm;
      sps_m = m == 0 ? p[0] * sv[0] : sps_m + p[m] * sv[m];
    }
    float sps_c = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float qj = p[0] * qc[j * TS9];
#pragma unroll
      for (int m = 1; m < MW; ++m) qj = qj + p[m] * qc[(m * CX + j) * TS9];
      qbar[MW + j] = qj;
      sps_c = j == 0 ? p[MW] * sv[MW] : sps_c + p[MW + j] * sv[MW + j];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float sps = c < MW ? sps_m : sps_c;
      col[(L::R_G3 + c) * LD9] =
          valid ? (-(p[c] * (qbar[c] - eq)) + (k.ent_coef * p[c]) * (sv[c] - sps)) * k.inv
                : 0.0f;
    }
    smem[L::S_MS + 2 * TS9 + s] = valid ? eq + k.ent_coef * ent : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < GW; ++j) {            // gh2 = (w3^T gz) (1 - h2^2)
    const int g = g0 + j;
    float sg = wa[D::Actor::W3 + g] * col[L::R_G3 * LD9];
#pragma unroll
    for (int c = 1; c < K; ++c) sg = sg + wa[D::Actor::W3 + c * H + g] * col[(L::R_G3 + c) * LD9];
    const float h2 = col[(L::R_H2 + g) * LD9];
    col[(L::R_GH2 + g) * LD9] = sg * (1.0f - h2 * h2);
  }
  __syncthreads();
  {
    float acc[GW];
    const float gh2 = col[L::R_GH2 * LD9];
#pragma unroll
    for (int j = 0; j < GW; ++j) acc[j] = wa[D::Actor::W2 + g0 + j] * gh2;
    for (int g = 1; g < H; ++g) {
      const float x = col[(L::R_GH2 + g) * LD9];
#pragma unroll
      for (int j = 0; j < GW; ++j) acc[j] = acc[j] + wa[D::Actor::W2 + g * H + g0 + j] * x;
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const float h1 = col[(L::R_H1 + g0 + j) * LD9];
      col[(L::R_GH1 + g0 + j) * LD9] = acc[j] * (1.0f - h1 * h1);
    }
  }
  __syncthreads();
  weight_grads<L, D::OW, K>(tile, L::R_X, part + D::G_ACTOR);

  // metric sums over the tile's samples, in order
  if (tid < 3) {
    float total = 0.0f;
    for (int q = 0; q < TS9; ++q) total = total + smem[L::S_MS + tid * TS9 + q];
    part[D::G_MS + tid] = total;
  }
}

// out[a][e] = sum over tiles t = 0, 1, ... of partials[a][t][e]
template <class D>
__global__ void maddpg_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D::A * D::NG) return;
  const int a = idx / D::NG, e = idx - a * D::NG;
  float total = 0.0f;
  for (int t = 0; t < n_tiles; ++t) total = total + partials[((size_t)a * n_tiles + t) * D::NG + e];
  out[idx] = total;
}

template <class S>
int launch_traj(const void* params, const float* weights, float* obs, float* act, float* rew,
                float* obs2, float* rows, int n_envs, int block_envs, int n_chunks, int t_chunk,
                int horizon, float eps, uint32_t seed, uint32_t block_offset,
                cudaStream_t stream) {
  const size_t smem = (size_t)S::A * DimsOf<S>::NWP * sizeof(float);
  // once per instantiation: the attribute holds for the process
  static const cudaError_t attr = cudaFuncSetAttribute(
      maddpg_traj_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n_envs + MADDPG_THREADS - 1) / MADDPG_THREADS;
  maddpg_traj_kernel<S><<<blocks, MADDPG_THREADS, smem, stream>>>(
      *static_cast<const typename S::Params*>(params), weights, obs, act, rew, obs2, rows, n_envs,
      block_envs, n_chunks, t_chunk, horizon, eps, seed, block_offset);
  return (int)cudaGetLastError();
}

template <class D>
int launch_update(const float* weights, const float* rows, int* act2, float* y, float* partials,
                  float* out, int batch, float gamma, float ent_coef, float inv,
                  cudaStream_t stream) {
  static_assert(Layout9<D>::SMEM <= SMEM_MAX && TdLayout<D>::SMEM <= SMEM_MAX,
                "a K9 CTA exceeds the shared memory of an SM");
  // once per instantiation: the attributes hold for the process
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        maddpg_td_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TdLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_update_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Layout9<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  maddpg_target_actions_kernel<D><<<(D::A * batch + 127) / 128, 128, 0, stream>>>(
      weights, rows, act2, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (batch + TS9 - 1) / TS9;
  const dim3 grid(n_tiles, D::A);
  maddpg_td_kernel<D><<<grid, THREADS9, TdLayout<D>::SMEM, stream>>>(weights, rows, act2, y,
                                                                      batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const MaddpgConsts k{gamma, ent_coef, inv};
  maddpg_update_kernel<D><<<grid, THREADS9, Layout9<D>::SMEM, stream>>>(weights, rows, y,
                                                                         partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_reduce_kernel<D><<<(D::A * D::NG + 255) / 256, 256, 0, stream>>>(partials, out,
                                                                          n_tiles);
  return (int)cudaGetLastError();
}

// the layout constants the wrapper mirrors: 0 actor stride, 1 critic stride,
// 2 weights, 3 gradient per agent, 4 samples per tile
template <class D>
int layout(int which) {
  const int v[5] = {D::NWP, D::NCP, D::N_WEIGHTS, D::NG, TS9};
  return (which >= 0 && which < 5) ? v[which] : -1;
}

}  // namespace

extern "C" {

// K8: the tensor form (obs, act, rew, obs2) when rows is null, else the rows form
int mpe_maddpg_traj(int scenario, const void* params, const float* weights, float* obs,
                    float* act, float* rew, float* obs2, float* rows, int n_envs, int block_envs,
                    int n_chunks, int t_chunk, int horizon, float eps, uint32_t seed,
                    uint32_t block_offset, cudaStream_t stream) {
#define MPE_MADDPG_TRAJ(S)                                                                  \
  return launch_traj<S>(params, weights, obs, act, rew, obs2, rows, n_envs, block_envs,    \
                        n_chunks, t_chunk, horizon, eps, seed, block_offset, stream)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_TRAJ)
#undef MPE_MADDPG_TRAJ
}

// K9. weights [N_WEIGHTS] (see OFF_*); rows [batch, RW]; act2 [A, NH, batch]
// (the target actions, kept for inspection) and y [A, batch] scratch;
// partials [A, tiles, NG] scratch; out [A, NG]
int mpe_maddpg_update(int scenario, const float* weights, const float* rows, int* act2, float* y,
                      float* partials, float* out, int batch, float gamma, float ent_coef,
                      float inv, cudaStream_t stream) {
#define MPE_MADDPG_UPDATE(S)                                                                  \
  return launch_update<DimsOf<S>>(weights, rows, act2, y, partials, out, batch, gamma, ent_coef, \
                                  inv, stream)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_UPDATE)
#undef MPE_MADDPG_UPDATE
}

int mpe_maddpg_update_layout(int scenario, int which) {
#define MPE_MADDPG_LAYOUT(S) return layout<DimsOf<S>>(which)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_LAYOUT)
#undef MPE_MADDPG_LAYOUT
}

}  // extern "C"

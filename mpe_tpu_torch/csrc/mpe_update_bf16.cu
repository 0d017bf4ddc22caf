// Hopper (sm_90a) kernels of the fused PPO and MAPPO epoch gradients with
// bf16 products on the tensor cores, for every head of the nine scenarios.
//
// K6-bf16  ppo_update_bf16_kernel<OW, 5, KC, true, false> + update_reduce_kernel
//          replace mpe_tpu/ops/fused_update.py::_update_kernel at cd=bfloat16
//          (fused_ppo_update(..., compute_dtype=bfloat16), JAX's default on a
//          TPU): the function of mpe_update.cu's K6 with every product of the
//          forward (W1 X, W2 H1, W3 H2), the backward (W3^T G3, W2^T GH2) and
//          the weight gradients (G3 H2^T, GH2 H1^T, GH1 X^T) taken on bf16
//          operands, rounded to nearest even, and summed in float32 (JAX's
//          _dot / _dot_nt, fused_update.py:56-66). The tanh derivatives
//          1 - h^2, the bias sums, the softmaxes and the head stay float32 on
//          float32 activations (fused_update.py:153-163).
// K7-bf16  ppo_update_bf16_kernel<OW, 5, KC, false, true> (the actor over the
//          (t, agent, env) samples) + ppo_update_bf16_kernel<A*OW, 0, 0, true,
//          false> (the critic on the joint obs of every (t, env)) + reduces
//          replace _mappo_update_kernel at cd=bfloat16.
// Out: the gradient in mpe_update.cu's packed layout and the metric sums, in
// float32, as JAX's acc_t.
//
// What bounds them on the H100: no longer the products (989 TFLOP/s of bf16
// on the tensor cores against 67 of fp32 FMA: K6's 2 x 15.7 k flops a sample
// take about 0.025 ms over path b's 786,432 samples), but the tanh on the
// special-function units, the head's float32 work and the bytes of the batch
// (chip_smoke.py::update_bf16_sample counts them). The kernel as written is
// held back by its shared-memory traffic: every mma fragment is loaded by
// 32- or 64-bit shared loads, the activations' fragments converted by cvt.
//
// What the design does about it. mpe_update.cu's shape is kept: a persistent
// grid (two CTAs per SM where they fit) whose CTAs keep per-CTA partials,
// summed by update_reduce_kernel in a fixed order (no float atomics, the same
// result every run); tiles of TS = 64 samples staged by cp.async into a
// second buffer while the current one computes; one thread per sample for the
// head. The products become mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16
// .f32 (HMMA) over warp fragments:
//   forward, backward  D[unit][sample] = W . B: warp w owns the tile's samples
//             8w .. 8w + 7 (one n8 column block) and every 16-unit row block;
//             A is the weight (W1, W2, W3, and W2^T, W3^T for the backward),
//             rounded to bf16 once per launch and kept in shared memory in
//             row-major rows padded so that a fragment's 32 words lie in 32
//             banks; B is the float32 activation tile ([unit][sample], rows
//             LD floats apart, as in mpe_update.cu), rounded on the way into
//             the fragment (two loads, one cvt pair). The epilogue adds the
//             bias and takes tanh, or multiplies by 1 - h^2 with h the float32
//             activation under the same entry, and writes float32 over the
//             tile, so that every activation the next product rounds is the
//             float32 value JAX rounds. Only __syncwarp between these.
//   gradient  dW[m][n] += sum over the tile's 64 samples of P[m][s] Q[n][s]:
//             the (16 x 8) output tiles are dealt to the warps, each keeping
//             its tiles' accumulators in registers over all the CTA's tiles;
//             both fragments come from the float32 tiles (float2 loads, cvt).
//   bias sums ride along in float32: db1, db2 in the backward epilogues (per
//             thread, then over the 4 lanes of a row and the 8 warps in order),
//             db3 in the head.
// Padding: the x rows to 16 (the mma's depth; obs widths 4-34, joint widths
// up to 204), the hidden units to 16 (hidden 8), the outputs to 16 (5 + C + 1
// of 6-16 logits, the critic's 1): zeros in both operands, which add exact
// zeros; padded units compute tanh(0) = 0 and are never stored.

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#ifndef MPE_HIDDEN
#define MPE_HIDDEN 64
#endif
constexpr int H = MPE_HIDDEN;    // hidden width: 8, 16, 32 or 64 (ops/_build.py, one library each)
static_assert(H == 8 || H == 16 || H == 32 || H == 64, "the kernels take hidden 8, 16, 32 or 64");
constexpr int HP = H < 16 ? 16 : H;   // hidden units padded to the mma's 16 rows
constexpr int THREADS = 256;     // per CTA
constexpr int WARPS = THREADS / 32;
constexpr int TS = 64;           // samples per tile: 8 per warp
constexpr int LD = TS + 4;       // a float32 tile row's stride
constexpr int KO_MAX = 16;       // outputs: one mma row block
static_assert(TS == 8 * WARPS, "each warp owns one n8 block of the tile's samples");
constexpr size_t SM_SMEM = 233472;   // shared memory of an SM; a CTA takes 1 KB more than it asks

// the row stride (in bf16) of a weight matrix of k columns: the words of a
// row a multiple of 4 but not of 8, so that the 8 rows x 4 words of an A
// fragment fall in 32 distinct banks
constexpr int lda(int k) {
  int w = k / 2;
  while (w % 8 != 4) ++w;
  return 2 * w;
}

// the packed weights (input) and gradient (output, partials) of an IN-H-H-KO
// MLP, as mpe_update.cu's: w1 [H,IN], b1 [H], w2 [H,H], b2 [H], w3 [KO,H]
// (policy rows, then v), b3 [KO], then the three metric sums;
// ops/fused_update.py::_packed mirrors it
struct Packed {
  int g_w1, g_b1, g_w2, g_b2, g_w3, g_b3, g_ms, ng;
};

__host__ __device__ constexpr Packed packed(int in, int ko) {
  return Packed{0,
                H * in,
                H * in + H,
                H * in + H + H * H,
                H * in + 2 * H + H * H,
                H * in + 2 * H + H * H + ko * H,
                H * in + 2 * H + H * H + ko * H + ko,
                H * in + 2 * H + H * H + ko * H + ko + 3};
}

__host__ __device__ constexpr size_t update_smem(int f_tile, int stage_rows, int stages) {
  return sizeof(float) * (f_tile + (size_t)(stages * stage_rows + 2 * HP + KO_MAX) * LD);
}

__host__ __device__ constexpr bool smem_fits(size_t bytes, int ctas) {
  return ctas * (bytes + 1024) <= SM_SMEM;
}

// One instantiation's widths and shared-memory layout: IN inputs, KP policy
// logits (0: the critic), KC comm logits, a value output (HAS_V), the team
// advantage of (t, env) (TEAM)
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct UpdateDims {
  static constexpr int IN = IN_, KP = KP_, KC = KC_;
  static constexpr bool HAS_V = HAS_V_, TEAM = TEAM_;
  static constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  static_assert(KO <= KO_MAX, "the outputs fit one mma row block");
  static constexpr int INP = (IN + 15) / 16 * 16;      // x rows, zero-padded to the mma's depth
  static constexpr int IN8 = (IN + 7) / 8 * 8;         // dW1's columns in n8 blocks
  // a stage: x rows, then the per-sample inputs of the head
  static constexpr int A_MV = INP, A_CM = A_MV + KP, A_LPO = A_CM + KC, A_ADV = A_LPO + 1;
  static constexpr int A_RET = KP > 0 ? A_ADV + 1 : INP, A_VOLD = A_RET + 1;
  static constexpr int NAUX = (KP > 0 ? KP + KC + 2 : 0) + (HAS_V ? 2 : 0);
  static constexpr int STAGE_ROWS = INP + NAUX;
  static constexpr int IN_ROWS = IN + NAUX;            // rows read from the batch
  // the bf16 weights (in bf16 elements): W1 [HP][L1], W2 [HP][LH], W2T
  // [HP][LH], W3 [16][LH], W3T [HP][L3]
  static constexpr int L1 = lda(INP), LH = lda(HP), L3 = lda(KO_MAX);
  static constexpr int S_W1 = 0, S_W2 = S_W1 + HP * L1, S_W2T = S_W2 + HP * LH,
                       S_W3 = S_W2T + HP * LH, S_W3T = S_W3 + KO_MAX * LH,
                       S_WEND = S_W3T + HP * L3;
  // then in floats: b1 [HP], b2 [HP], b3 [16], the tiles
  static constexpr int F_B1 = (S_WEND / 2 + 3) / 4 * 4, F_B2 = F_B1 + HP, F_B3 = F_B2 + HP,
                       F_TILE = (F_B3 + KO_MAX + 3) / 4 * 4;
  // two CTAs per SM where they fit, then two stages where they fit
  static constexpr size_t SMEM2 = update_smem(F_TILE, STAGE_ROWS, 2),
                          SMEM1 = update_smem(F_TILE, STAGE_ROWS, 1);
  static constexpr int CTAS = smem_fits(SMEM1, 2) ? 2 : 1;
  static constexpr int STAGES = smem_fits(SMEM2, CTAS) ? 2 : 1;
  static constexpr size_t SMEM = STAGES == 2 ? SMEM2 : SMEM1;
  // tile rows after the stages: H1 (then GH1), H2 (then GH2), Z (then G3)
  static constexpr int T_H1 = STAGES * STAGE_ROWS, T_H2 = T_H1 + HP, T_G = T_H2 + HP;
  static_assert(smem_fits(SMEM, 1), "the weights and one stage must fit in shared memory");
  // the gradient's (16 x 8) output tiles and how many each warp keeps
  static constexpr int MT = HP / 16;                   // unit row blocks
  static constexpr int NT1 = MT * (IN8 / 8), NT2 = MT * (H / 8), NT3 = H / 8;
  static constexpr int J1 = (NT1 + WARPS - 1) / WARPS, J2 = (NT2 + WARPS - 1) / WARPS,
                       J3 = (NT3 + WARPS - 1) / WARPS;
};

struct UpdateConsts {
  float ratio_lo, ratio_hi;      // 1 - clip, 1 + clip
  float vclip;                   // clip of the value change
  float vf_scale;                // vf_coef * 2 / B_v
  float ent_scale;               // ent_coef / B
  float inv_b;                   // 1 / B, B = T * A * N
  int n_agents;                  // A: the agent of row (t, i) and the team advantage's index
  int speak_mask;                // bit i: agent i speaks (its comm factor counts)
};

// ---- staging: cp.async where the card has it (as mpe_update.cu's) ----------

__device__ __forceinline__ void stage16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void stage4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void stage_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int pending>
__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

struct Batch {
  const float *obs, *mvoh, *cmoh, *lpo, *adv, *ret, *vold;
};

// row r of the tile's inputs at batch row ta: a pointer to its lane 0
template <class D>
__device__ __forceinline__ const float* input_row(const Batch& b, int r, size_t ta, size_t N,
                                                  int n_agents) {
  if (r < D::IN) return b.obs + (ta * D::IN + r) * N;
  r -= D::IN;
  if constexpr (D::KP > 0) {
    if (r < D::KP) return b.mvoh + (ta * D::KP + r) * N;
    r -= D::KP;
    if (r < D::KC) return b.cmoh + (ta * D::KC + r) * N;
    r -= D::KC;
    if (r == 0) return b.lpo + ta * N;
    if (r == 1) return b.adv + (D::TEAM ? ta / (size_t)n_agents : ta) * N;
    r -= 2;
  }
  return (r == 0 ? b.ret : b.vold) + ta * N;
}

template <class D>
__device__ __forceinline__ int stage_row(int r) {
  return r < D::IN ? r : D::INP + (r - D::IN);
}

// tile ti's inputs into stage st: 16-byte pieces where the tile's samples are
// one run of lanes in one batch row, else element by element, zeros past the
// end
template <class D>
__device__ __forceinline__ void stage_tile(const Batch& b, float* __restrict__ st, size_t ti,
                                           size_t n_samples, size_t N, int n_agents, int tid) {
  const size_t m0 = ti * TS;
  const size_t ta0 = m0 / N, lane0 = m0 - ta0 * N;
  if (m0 + TS <= n_samples && lane0 + TS <= N && N % 4 == 0) {
    constexpr int PIECES = TS / 4;
    for (int i = tid; i < D::IN_ROWS * PIECES; i += THREADS) {
      const int r = i / PIECES, q = i - r * PIECES;
      stage16(st + stage_row<D>(r) * LD + 4 * q,
              input_row<D>(b, r, ta0, N, n_agents) + lane0 + 4 * q);
    }
  } else {
    for (int i = tid; i < D::IN_ROWS * TS; i += THREADS) {
      const int r = i / TS, s = i - r * TS;
      const size_t m = m0 + s;
      float* dst = st + stage_row<D>(r) * LD + s;
      if (m < n_samples) {
        const size_t ta = m / N;
        stage4(dst, input_row<D>(b, r, ta, N, n_agents) + (m - ta * N));
      } else {
        *dst = 0.0f;
      }
    }
  }
}

}  // namespace

#include "bf16_mma.cuh"

namespace {

// ---- the head: one thread per sample (mpe_update.cu's arithmetic) ----------

template <int K0, int K, int KO>
__device__ __forceinline__ void softmax_head(const float (&z)[KO], const float* __restrict__ oh,
                                             int s, float (&p)[K], float (&ls)[K], float (&o)[K],
                                             float& ent, float& lp) {
  float zm = z[K0];
#pragma unroll
  for (int c = 1; c < K; ++c) zm = fmaxf(zm, z[K0 + c]);
  float e[K], sum = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    e[c] = expf(z[K0 + c] - zm);
    sum = sum + e[c];
  }
  const float lse = logf(sum);
  ent = 0.0f;
  lp = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    ls[c] = (z[K0 + c] - zm) - lse;
    p[c] = e[c] / sum;
    o[c] = oh[c * LD + s];
    ent = ent + p[c] * ls[c];
    lp = lp + ls[c] * o[c];
  }
  ent = -ent;
}

// sample s of the tile (batch row ta): the outputs z in rows T_G of the tile
// -> the output gradient G3 there; adds the sample's (pg, vloss, entropy)
// terms to ms and its G3 to ab3. A sample past the end gets G3 = 0
template <class D>
__device__ __forceinline__ void head(const float* __restrict__ st, float* __restrict__ gt, int s,
                                     bool valid, size_t ta, const UpdateConsts& k,
                                     float (&ms)[3], float (&ab3)[D::KO]) {
  constexpr int KO = D::KO, KP = D::KP, KC = D::KC;
  float z[KO], g3[KO];
#pragma unroll
  for (int c = 0; c < KO; ++c) z[c] = gt[c * LD + s];
  if constexpr (KP > 0) {
    float p[KP], ls[KP], oh[KP], ent_m, lp;
    softmax_head<0, KP, KO>(z, st + D::A_MV * LD, s, p, ls, oh, ent_m, lp);
    float ent = ent_m;
    [[maybe_unused]] float speak = 0.0f;
    [[maybe_unused]] float pc[KC > 0 ? KC : 1], lsc[KC > 0 ? KC : 1], ohc[KC > 0 ? KC : 1];
    [[maybe_unused]] float ent_c = 0.0f;
    if constexpr (KC > 0) {
      const int agent = (int)(ta % (size_t)k.n_agents);
      speak = ((k.speak_mask >> agent) & 1) ? 1.0f : 0.0f;
      float lp_c;
      softmax_head<KP, KC, KO>(z, st + D::A_CM * LD, s, pc, lsc, ohc, ent_c, lp_c);
      lp = lp + lp_c * speak;
      ent = ent_m + ent_c * speak;
    }
    const float a = st[D::A_ADV * LD + s];
    const float ratio = expf(lp - st[D::A_LPO * LD + s]);
    const float rc = fminf(fmaxf(ratio, k.ratio_lo), k.ratio_hi);
    const float s1 = ratio * a, s2 = rc * a;
    const float cpg = (s1 <= s2) ? -(a * ratio) * k.inv_b : 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) g3[c] = cpg * (oh[c] - p[c]) + (k.ent_scale * p[c]) * (ls[c] + ent_m);
    if constexpr (KC > 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        g3[KP + c] = (cpg * (ohc[c] - pc[c]) + (k.ent_scale * pc[c]) * (lsc[c] + ent_c)) * speak;
    }
    if (valid) {
      ms[0] = ms[0] - fminf(s1, s2);
      ms[2] = ms[2] + ent;
    }
  }
  if constexpr (D::HAS_V) {
    const float v = z[KO - 1], vo = st[D::A_VOLD * LD + s], r = st[D::A_RET * LD + s];
    const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
    const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
    // live where the max's first branch wins or the clip does not bind
    // (ops/fused_update.py::_value_clip_grad)
    g3[KO - 1] = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
    if (valid) ms[1] = ms[1] + fmaxf(d1, d2);
  }
#pragma unroll
  for (int c = 0; c < KO; ++c) {
    const float g = valid ? g3[c] : 0.0f;
    gt[c * LD + s] = g;
    ab3[c] = ab3[c] + g;
  }
}

// ---- the kernel --------------------------------------------------------------

// n_rows * n_envs samples: rows are (t, agent) pairs (K6, the K7 actor) or
// time steps (the K7 critic, whose IN = A * OW joint rows are contiguous)
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__global__ void __launch_bounds__(THREADS, (UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>::CTAS))
ppo_update_bf16_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                       const float* __restrict__ mvoh, const float* __restrict__ cmoh,
                       const float* __restrict__ lpo, const float* __restrict__ adv,
                       const float* __restrict__ ret, const float* __restrict__ vold,
                       float* __restrict__ partials, int n_rows, int n_envs, UpdateConsts k) {
  using D = UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>;
  constexpr int KO = D::KO, MT = D::MT;
  constexpr Packed L = packed(IN, KO);
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  float* b1 = smem + D::F_B1;
  float* b2 = smem + D::F_B2;
  float* b3 = smem + D::F_B3;
  float* tile = smem + D::F_TILE;
  float* h1t = tile + D::T_H1 * LD;
  float* h2t = tile + D::T_H2 * LD;
  float* gt = tile + D::T_G * LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = 8 * warp;                             // the warp's samples in a tile
  const size_t N = (size_t)n_envs;
  const size_t n_samples = (size_t)n_rows * N;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  const Batch b{obs, mvoh, cmoh, lpo, adv, ret, vold};

  if (blockIdx.x < n_tiles) stage_tile<D>(b, tile, blockIdx.x, n_samples, N, k.n_agents, tid);
  stage_commit();
  // the weights rounded to bf16, zeros in every padding row and column
  for (int i = tid; i < HP * D::L1; i += THREADS) {
    const int m = i / D::L1, c = i - m * D::L1;
    w16[D::S_W1 + i] = (uint16_t)bf16_bits(m < H && c < IN ? weights[L.g_w1 + m * IN + c] : 0.0f);
  }
  for (int i = tid; i < HP * D::LH; i += THREADS) {
    const int m = i / D::LH, c = i - m * D::LH;
    const bool in = m < H && c < H;
    w16[D::S_W2 + i] = (uint16_t)bf16_bits(in ? weights[L.g_w2 + m * H + c] : 0.0f);
    w16[D::S_W2T + i] = (uint16_t)bf16_bits(in ? weights[L.g_w2 + c * H + m] : 0.0f);
  }
  for (int i = tid; i < KO_MAX * D::LH; i += THREADS) {  // W3 [KO, H]
    const int m = i / D::LH, c = i - m * D::LH;
    w16[D::S_W3 + i] = (uint16_t)bf16_bits(m < KO && c < H ? weights[L.g_w3 + m * H + c] : 0.0f);
  }
  for (int i = tid; i < HP * D::L3; i += THREADS) {    // W3^T [H, KO]
    const int m = i / D::L3, c = i - m * D::L3;
    w16[D::S_W3T + i] = (uint16_t)bf16_bits(m < H && c < KO ? weights[L.g_w3 + c * H + m] : 0.0f);
  }
  if (tid < HP) {
    b1[tid] = tid < H ? weights[L.g_b1 + tid] : 0.0f;
    b2[tid] = tid < H ? weights[L.g_b2 + tid] : 0.0f;
  }
  if (tid < KO_MAX) b3[tid] = tid < KO ? weights[L.g_b3 + tid] : 0.0f;
  for (int st = 0; st < D::STAGES; ++st)               // the x rows' padding stays zero
    for (int i = tid; i < (D::INP - IN) * LD; i += THREADS)
      tile[(st * D::STAGE_ROWS + IN) * LD + i] = 0.0f;

  float a1[D::J1][4], a2[D::J2][4], a3[D::J3][4];
  float ab1[MT][2], ab2[MT][2], ab3[KO], ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < D::J1; ++j) a1[j][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D::J2; ++j) a2[j][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D::J3; ++j) a3[j][i] = 0.0f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ab1[mt][0] = ab1[mt][1] = ab2[mt][0] = ab2[mt][1] = 0.0f;
#pragma unroll
  for (int c = 0; c < KO; ++c) ab3[c] = 0.0f;

  const uint16_t* W1 = w16 + D::S_W1;
  const uint16_t* W2 = w16 + D::S_W2;
  const uint16_t* W2T = w16 + D::S_W2T;
  const uint16_t* W3 = w16 + D::S_W3;
  const uint16_t* W3T = w16 + D::S_W3T;

  int it = 0;
  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x, ++it) {
    float* st = tile + (D::STAGES == 2 ? (it & 1) : 0) * D::STAGE_ROWS * LD;
    if constexpr (D::STAGES == 2) {                    // the next tile's inputs in flight
      if (ti + gridDim.x < n_tiles)
        stage_tile<D>(b, tile + ((it + 1) & 1) * D::STAGE_ROWS * LD, ti + gridDim.x, n_samples,
                      N, k.n_agents, tid);
      stage_commit();
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();
    // forward, the warp's 8 samples: H1 = tanh(W1 X + b1), H2, Z = W3 H2 + b3
    warp_product<MT, D::INP / 16, D::L1>(W1, st, n0, lane, [&](int m, int n, float v, int, int) {
      h1t[m * LD + n] = tanhf(v + b1[m]);
    });
    __syncwarp();
    warp_product<MT, HP / 16, D::LH>(W2, h1t, n0, lane, [&](int m, int n, float v, int, int) {
      h2t[m * LD + n] = tanhf(v + b2[m]);
    });
    __syncwarp();
    warp_product<1, HP / 16, D::LH>(W3, h2t, n0, lane, [&](int m, int n, float v, int, int) {
      gt[m * LD + n] = v + b3[m];
    });
    __syncwarp();
    if (lane < 8) {
      const int s = n0 + lane;
      const size_t m = ti * TS + s;
      head<D>(st, gt, s, m < n_samples, m / N, k, ms, ab3);
    }
    __syncthreads();
    // dW3 += G3 H2^T
    warp_outer<D::NT3, 1>(gt, h2t, warp, lane, a3);
    __syncthreads();
    // GH2 = (W3^T G3) (1 - H2^2) over H2, db2 beside it
    warp_product<MT, 1, D::L3>(W3T, gt, n0, lane, [&](int m, int n, float v, int mt, int half) {
      const float h = h2t[m * LD + n];
      const float g = v * (1.0f - h * h);
      h2t[m * LD + n] = g;
      ab2[mt][half] = ab2[mt][half] + g;
    });
    __syncthreads();
    // dW2 += GH2 H1^T
    warp_outer<D::NT2, MT>(h2t, h1t, warp, lane, a2);
    __syncthreads();
    // GH1 = (W2^T GH2) (1 - H1^2) over H1, db1 beside it
    warp_product<MT, HP / 16, D::LH>(W2T, h2t, n0, lane,
                                     [&](int m, int n, float v, int mt, int half) {
      const float h = h1t[m * LD + n];
      const float g = v * (1.0f - h * h);
      h1t[m * LD + n] = g;
      ab1[mt][half] = ab1[mt][half] + g;
    });
    __syncthreads();
    // dW1 += GH1 X^T; the padding rows of X add zeros
    warp_outer<D::NT1, MT>(h1t, st, warp, lane, a1);
    __syncthreads();                                    // this stage's reads are done
    if constexpr (D::STAGES == 1) {
      if (ti + gridDim.x < n_tiles)
        stage_tile<D>(b, tile, ti + gridDim.x, n_samples, N, k.n_agents, tid);
      stage_commit();
    }
  }
  stage_wait<0>();

  float* part = partials + (size_t)blockIdx.x * L.ng;
  store_outer<D::NT1, MT>(part + L.g_w1, H, IN, warp, lane, a1);
  store_outer<D::NT2, MT>(part + L.g_w2, H, H, warp, lane, a2);
  store_outer<D::NT3, 1>(part + L.g_w3, KO, H, warp, lane, a3);
  // the bias and metric sums over the CTA's threads, in a fixed order: db1 and
  // db2 of unit m from the 4 lanes of its row in each warp (warp-major), db3
  // over the head's 64 threads, the metrics over all 256
  __syncthreads();
  float* red = tile;                                   // [2][HP][32], [KO][TS], [3][THREADS]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * mt + (lane >> 2) + 8 * half, q = 4 * warp + (lane & 3);
      red[m * 32 + q] = ab1[mt][half];
      red[(HP + m) * 32 + q] = ab2[mt][half];
    }
  float* red3 = red + 2 * HP * 32;
  if (lane < 8) {
#pragma unroll
    for (int c = 0; c < KO; ++c) red3[c * TS + n0 + lane] = ab3[c];
  }
  float* redm = red3 + KO * TS;
#pragma unroll
  for (int q = 0; q < 3; ++q) redm[q * THREADS + tid] = ms[q];
  __syncthreads();
  if (tid < H) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int q = 0; q < 32; ++q) {
      s1 = s1 + red[tid * 32 + q];
      s2 = s2 + red[(HP + tid) * 32 + q];
    }
    part[L.g_b1 + tid] = s1;
    part[L.g_b2 + tid] = s2;
  }
  if (tid < KO) {
    float s3 = 0.0f;
    for (int s = 0; s < TS; ++s) s3 = s3 + red3[tid * TS + s];
    part[L.g_b3 + tid] = s3;
  }
  if (tid < 3) {
    float total = 0.0f;
    for (int i = 0; i < THREADS; ++i) total = total + redm[tid * THREADS + i];
    part[L.g_ms + tid] = total;
  }
}

// out[e] = sum over CTAs b = 0, 1, ... of partials[b][e]; the three metric
// sums at the end are scaled to means
__global__ void update_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int n_parts, int ng, float ms_pg, float ms_v, float ms_ent) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ng) return;
  float total = 0.0f;
  for (int b = 0; b < n_parts; ++b) total = total + partials[(size_t)b * ng + e];
  const int q = e - (ng - 3);
  out[e] = q < 0 ? total : total * (q == 0 ? ms_pg : q == 1 ? ms_v : ms_ent);
}

// one pass: the persistent grid of n_parts CTAs, then the reduce into out
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
cudaError_t update_pass(const float* weights, const float* obs, const float* mvoh,
                        const float* cmoh, const float* lpo, const float* adv, const float* ret,
                        const float* vold, float* partials, float* out, int n_rows, int n_envs,
                        int n_parts, const UpdateConsts& k, float ms_pg, float ms_v,
                        float ms_ent, cudaStream_t stream) {
  using D = UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>;
  const int ng = packed(IN, D::KO).ng;
  auto kernel = ppo_update_bf16_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<n_parts, THREADS, D::SMEM, stream>>>(weights, obs, mvoh, cmoh, lpo, adv, ret, vold,
                                                partials, n_rows, n_envs, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_reduce_kernel<<<(ng + 255) / 256, 256, 0, stream>>>(partials, out, n_parts, ng, ms_pg,
                                                             ms_v, ms_ent);
  return cudaGetLastError();
}

// f(integral_constant<OW>, integral_constant<C>) for the actor head (obs width,
// comm logits) of each of the nine scenarios; ops/fused_update.py::actor_heads
// lists the same pairs
template <class F>
cudaError_t by_actor_head(int ow, int kc, F f) {
#define MPE_ACTOR_HEAD(OW, C)   \
  if (ow == OW && kc == C)       \
    return f(std::integral_constant<int, OW>{}, std::integral_constant<int, C>{});
  MPE_ACTOR_HEAD(18, 0)    // simple_spread
  MPE_ACTOR_HEAD(4, 0)     // simple
  MPE_ACTOR_HEAD(21, 10)   // simple_reference
  MPE_ACTOR_HEAD(11, 3)    // simple_speaker_listener
  MPE_ACTOR_HEAD(10, 0)    // simple_adversary
  MPE_ACTOR_HEAD(19, 0)    // simple_push
  MPE_ACTOR_HEAD(8, 4)     // simple_crypto
  MPE_ACTOR_HEAD(16, 0)    // simple_tag
  MPE_ACTOR_HEAD(34, 4)    // simple_world_comm
#undef MPE_ACTOR_HEAD
  return cudaErrorInvalidValue;
}

// f(integral_constant<J>) for the MAPPO critic's joint width J = A * OW of each
// of the nine scenarios; ops/fused_update.py::critic_widths lists the same
template <class F>
cudaError_t by_joint_width(int j, F f) {
#define MPE_JOINT_WIDTH(J) \
  if (j == J) return f(std::integral_constant<int, J>{});
  MPE_JOINT_WIDTH(54)      // simple_spread: 3 x 18
  MPE_JOINT_WIDTH(4)       // simple
  MPE_JOINT_WIDTH(42)      // simple_reference: 2 x 21
  MPE_JOINT_WIDTH(22)      // simple_speaker_listener: 2 x 11
  MPE_JOINT_WIDTH(30)      // simple_adversary: 3 x 10
  MPE_JOINT_WIDTH(38)      // simple_push: 2 x 19
  MPE_JOINT_WIDTH(24)      // simple_crypto: 3 x 8
  MPE_JOINT_WIDTH(64)      // simple_tag: 4 x 16
  MPE_JOINT_WIDTH(204)     // simple_world_comm: 6 x 34
#undef MPE_JOINT_WIDTH
  return cudaErrorInvalidValue;
}

constexpr int MOVES = 5;

}  // namespace

extern "C" {

// K6-bf16: mpe_update.cu's mpe_ppo_update, the same arguments and layout
int mpe_ppo_update(int in, int kc, const float* weights, const float* obs, const float* mvoh,
                   const float* cmoh, const float* lpo, const float* adv, const float* ret,
                   const float* vold, float* partials, float* out, int n_ta, int n_envs,
                   int n_agents, int speak_mask, int n_parts, float ratio_lo, float ratio_hi,
                   float vclip, float vf_scale, float ent_scale, float inv_b,
                   cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, n_agents,
                       speak_mask};
  return (int)by_actor_head(in, kc, [&](auto ow, auto c) {
    return update_pass<decltype(ow)::value, MOVES, decltype(c)::value, true, false>(
        weights, obs, mvoh, cmoh, lpo, adv, ret, vold, partials, out, n_ta, n_envs, n_parts, k,
        inv_b, inv_b, inv_b, stream);
  });
}

// K7-bf16: mpe_update.cu's mpe_mappo_update, the same arguments and layout
int mpe_mappo_update(int ow, int kc, const float* actor_w, const float* critic_w,
                     const float* obs, const float* mvoh, const float* cmoh, const float* lpo,
                     const float* adv, const float* ret, const float* vold, float* partials,
                     float* out, int n_steps, int n_agents, int n_envs, int speak_mask,
                     int n_parts, float ratio_lo, float ratio_hi, float vclip, float vf_scale,
                     float ent_scale, float inv_b, float inv_bv, cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, n_agents,
                       speak_mask};
  if (by_joint_width(n_agents * ow, [](auto) { return cudaSuccess; }) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = by_actor_head(ow, kc, [&](auto w, auto c) {
    return update_pass<decltype(w)::value, MOVES, decltype(c)::value, false, true>(
        actor_w, obs, mvoh, cmoh, lpo, adv, nullptr, nullptr, partials, out, n_steps * n_agents,
        n_envs, n_parts, k, inv_b, 0.0f, inv_b, stream);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)by_joint_width(n_agents * ow, [&](auto j) {
    return update_pass<decltype(j)::value, 0, 0, true, false>(
        critic_w, obs, nullptr, nullptr, nullptr, nullptr, ret, vold, partials,
        out + packed(ow, MOVES + kc).ng, n_steps, n_envs, n_parts, k, 0.0f, inv_bv, 0.0f,
        stream);
  });
}

int mpe_update_packed_size(int in, int ko) { return packed(in, ko).ng; }

}  // extern "C"

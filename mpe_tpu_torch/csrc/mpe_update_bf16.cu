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
// What bounds them on the H100: not the products (989 TFLOP/s of bf16 on the
// tensor cores against 67 of fp32 FMA: K6's 2 x 15.7 k flops a sample take
// about 0.025 ms over path b's 786,432 samples) but the tanh on the
// special-function units, the head's float32 work and the bytes of the batch
// (chip_smoke.py::update_bf16_sample counts them). A first design, a warp's 8
// samples on the N side of each product, was held back by shared memory:
// every layer's float32 activations went out to a tile and came back through
// scalar loads and cvts into the next product's fragments, the weight
// gradients rebuilt both operands from float32 tiles the same way, the weights
// were staged twice (W2^T, W3^T), and each 64-sample tile passed seven
// __syncthreads.
//
// What the design does about it. mpe_update.cu's shape is kept: a persistent
// grid (two CTAs per SM where they fit) whose CTAs keep per-CTA partials,
// summed by update_reduce_kernel in a fixed order (no float atomics, the same
// result every run); tiles of TS = 64 samples staged by cp.async into a
// second buffer while the current one computes. The products are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (HMMA), sample-major
// (bf16_mma.cuh): warp w owns the tile's samples 16w .. 16w + 15 as the M side
// of every product.
//   forward   h1 = tanh(x W1^T + b1), h2, z = h2 W3^T + b3: x's fragments by
//             ldmatrix.trans from the tile's bf16 x rows, each later layer's
//             from the previous layer's accumulators, packed in registers;
//             the weights, rounded to bf16 once a launch into shared memory as
//             row-major rows (padded against bank conflicts), give the B
//             fragments by ldmatrix. h1 and h2 stay float32 in the registers
//             for 1 - h^2; the value rounded is the one JAX rounds.
//   head      one lane a sample (16 of the warp's 32) on the logits through a
//             small float32 tile per warp, mpe_update.cu's arithmetic and order.
//   backward  gh2 = (g3 W3) (1 - h2^2), gh1 = (gh2 W2) (1 - h1^2): W by
//             ldmatrix.trans (no transposed copies), g3 and gh2 packed in
//             registers; db1, db2 from the float32 values in the registers,
//             summed over the warp's rows by a shuffle reduce-scatter.
//   gradient  each product's operands go once to shared memory as bf16
//             sample-major rows (x as the tile's bf16 x rows); dW[m][n] +=
//             sum over the tile's 64 samples by ldmatrix fragments, a row
//             block a warp at hidden 64 (else the (16 x 8) output tiles dealt
//             in turn), each warp keeping its tiles' accumulators in registers
//             over the CTA's tiles (dW1 of more than 24 inputs, the critics'
//             joints and simple_world_comm's actor, adds each tile's sums into
//             the CTA's partial instead).
// Two __syncthreads a tile: the staging handoff and the gradient pass. What
// still bounds them: no single stage (the tanh, the head and the gradient
// pass each 5-20% of the time), but the per-tile work of 8 warps an SM, two
// CTAs being all their shared memory allows.
// Padding: the x rows to 16 (the mma's depth; obs widths 4-34, joint widths
// up to 204), the hidden units to 16 (hidden 8), the outputs to 8 or 16
// (5 + C + 1 of 6-16 logits, the critic's 1): zeros in both operands, which
// add exact zeros; padded units compute tanh(0) = 0 and are never stored.
//
// Hidden 128 and 256 (ppo_update_bf16_wide_kernel, WideDims). There the
// design above does not fit: the bf16 w2 alone is 135 KB at 256 (the four
// sample-major tiles another 135 KB), simple_world_comm's 204-wide critic
// does not fit at 128 either, a warp's float32 h1 and h2 for its 16 samples
// would take 128 registers a lane each at 256, and dW2 alone is 65,536
// floats. So the wide kernel keeps the grid, the tiles of TS = 64 samples,
// the staging, the head (the same function) and the fixed-order reduce, and
// changes the products:
//   layout    8 warps (256 threads); warp w owns UW = H / 8 units (16 at 128,
//             32 at 256: the N side of its products) for the whole tile (the
//             M side, 4 m16 blocks), so its float32 h1, h2 (64 registers a
//             lane each at 256) and with them 1 - h^2 stay with the warp
//             that needs them in the backward;
//   weights   w1, w2 and w2^T rounded to bf16 once a call into the scratch
//             after the partials (update_round_bf16_kernel, fragment-packed:
//             bf16_wide.cuh), which L2 holds for every CTA; each lane streams
//             its own B fragments through a ring of RING k16 steps by
//             cp.async (BRing::product); w3 and the biases stay resident;
//   operands  the next product's A fragments and the weight gradients'
//             operands go through two bf16 sample-major tiles [TS][LH]: A
//             holds h1, then gh1; B holds h2, then gh2 (eight __syncthreads a
//             tile);
//   gradient  dW3 (16 x H) stays in registers over the CTA's tiles; dW2 and
//             dW1 are added into the CTA's partial, zeroed first, once a tile
//             (add_outer: each lane owns its entries, reads them before its
//             products). That read-modify-write is the price of the width:
//             at 256, 2 x 4 (H^2 + H IN) bytes a tile, 0.56 MB on
//             simple_spread's actor and 0.94 MB on simple_world_comm's critic
//             (at 128, 0.15 and 0.34 MB). The samples between adds are one
//             tile, 64: a second tile's h1, gh2 and gh1 tiles would need
//             another 101 KB at 256, which the 204-wide critic's stage and x
//             tile leave no room for.
// The grid is all the CTAs the card holds at once (mpe_update_grid asks the
// occupancy API). Widths 8-64 keep ppo_update_bf16_kernel unchanged.

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
constexpr int H = MPE_HIDDEN;    // hidden width (ops/_build.py::HIDDEN_WIDTHS, one library each)
static_assert(H == 8 || H == 16 || H == 32 || H == 64 || H == 128 || H == 256,
              "K6-bf16 and K7-bf16 take hidden 8, 16, 32, 64, 128 or 256");
constexpr bool WIDE = H > 64;    // hidden 128 and 256: ppo_update_bf16_wide_kernel
constexpr int HP = H < 16 ? 16 : H;   // hidden units padded to the mma's 16
constexpr int NBH = HP / 8, KTH = HP / 16;   // the hidden units' n8 blocks and k16 steps
constexpr int THREADS = 128;     // per CTA
constexpr int WARPS = THREADS / 32;
constexpr int WS = 16;           // samples per warp: the mma's M
constexpr int TS = WS * WARPS;   // samples per tile
constexpr int LD = TS + 4;       // a float32 stage row's stride
constexpr int KO_MAX = 16;       // outputs: at most two n8 blocks
constexpr int ZLD = KO_MAX + 1;  // a row of a warp's logit tile
constexpr size_t SM_SMEM = 233472;   // shared memory of an SM; a CTA takes 1 KB more than it asks

}  // namespace

#include "bf16_mma.cuh"
#include "bf16_wide.cuh"

namespace {

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

__host__ __device__ constexpr bool smem_fits(size_t bytes, int ctas) {
  return ctas * (bytes + 1024) <= SM_SMEM;
}

// One instantiation's widths and stage layout: IN inputs, KP policy logits
// (0: the critic), KC comm logits, a value output (HAS_V), the team advantage
// of (t, env) (TEAM)
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct StageDims {
  static constexpr int IN = IN_, KP = KP_, KC = KC_;
  static constexpr bool HAS_V = HAS_V_, TEAM = TEAM_;
  static constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  static_assert(KO <= KO_MAX, "the outputs fit two n8 blocks");
  static constexpr int NBO = (KO + 7) / 8;             // the outputs' n8 blocks
  static constexpr int INP = (IN + 15) / 16 * 16;      // x rows, zero-padded to the mma's depth
  static constexpr int IN8 = (IN + 7) / 8 * 8;         // dW1's columns in n8 blocks
  // a stage (float32 [row][LD]): the x rows, then the per-sample inputs of the head
  static constexpr int A_MV = IN, A_CM = A_MV + KP, A_LPO = A_CM + KC, A_ADV = A_LPO + 1;
  static constexpr int A_RET = KP > 0 ? A_ADV + 1 : IN, A_VOLD = A_RET + 1;
  static constexpr int NAUX = (KP > 0 ? KP + KC + 2 : 0) + (HAS_V ? 2 : 0);
  static constexpr int STAGE_ROWS = IN + NAUX;         // rows read from the batch
};

// ... and the shared-memory layout of ppo_update_bf16_kernel (hidden 8-64)
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct UpdateDims : StageDims<IN_, KP_, KC_, HAS_V_, TEAM_> {
  using S = StageDims<IN_, KP_, KC_, HAS_V_, TEAM_>;
  using S::IN, S::KO, S::INP, S::IN8, S::STAGE_ROWS;
  // bf16 (in elements): the weights W1 [HP][L1], W2 [HP][LH], W3 [16][LH];
  // the tile's x [INP][LX] (feature-major, as the batch lays it out); the
  // sample-major operands of the weight gradients H1, H2, GH1, GH2 [TS][LH]
  // and G3 [TS][L3]
  static constexpr int L1 = lda(INP), LH = lda(HP), L3 = lda(KO_MAX), LX = lda(TS);
  static constexpr int S_W1 = 0, S_W2 = S_W1 + HP * L1, S_W3 = S_W2 + HP * LH,
                       S_X = S_W3 + KO_MAX * LH, S_H1 = S_X + INP * LX, S_H2 = S_H1 + TS * LH,
                       S_GH1 = S_H2 + TS * LH, S_GH2 = S_GH1 + TS * LH, S_G3 = S_GH2 + TS * LH,
                       S_END = S_G3 + TS * L3;
  // then in floats: b1 [HP], b2 [HP], b3 [16], the warps' logit tiles
  // [WARPS][WS][ZLD], the stages
  static constexpr int F_B1 = (S_END / 2 + 3) / 4 * 4, F_B2 = F_B1 + HP, F_B3 = F_B2 + HP,
                       F_Z = F_B3 + KO_MAX, F_TILE = (F_Z + WARPS * WS * ZLD + 3) / 4 * 4;
  // two CTAs per SM where they fit, then two stages where they fit
  static constexpr size_t SMEM2 = sizeof(float) * ((size_t)F_TILE + 2 * STAGE_ROWS * LD),
                          SMEM1 = sizeof(float) * ((size_t)F_TILE + STAGE_ROWS * LD);
  static constexpr int CTAS = smem_fits(SMEM1, 2) ? 2 : 1;
  static constexpr int STAGES = smem_fits(SMEM2, CTAS) ? 2 : 1;
  static constexpr size_t SMEM = STAGES == 2 ? SMEM2 : SMEM1;
  static_assert(smem_fits(SMEM, 1), "the weights, the tiles and one stage must fit an SM");
  // the closing reduce ([2][HP][WARPS], [KO][TS], [3][THREADS] floats) reuses the tiles from H1
  static_assert((2 * HP * WARPS + KO_MAX * TS + 3 * THREADS) * 4 <= (S_END - S_H1) * 2,
                "the closing reduce fits the tiles");
  // the gradient's (16 x 8) output tiles and how many each warp keeps: at
  // hidden 64 (ROWS) warp w takes row block w of dW1 and dW2 whole and the
  // n8 blocks 2w, 2w + 1 of dW3, else the tiles are dealt in turn
  static constexpr int MT = HP / 16;                   // unit row blocks
  static constexpr bool ROWS = MT == WARPS;
  static constexpr int NC1 = IN8 / 8, NT1 = MT * NC1, NT2 = MT * (H / 8), NT3 = H / 8;
  static constexpr int J1 = (NT1 + WARPS - 1) / WARPS, J2 = (NT2 + WARPS - 1) / WARPS,
                       J3 = (NT3 + WARPS - 1) / WARPS;
  // dW1 of more than 24 inputs (the critics' joints, simple_world_comm's
  // actor) is added into the partial tile by tile, not kept in registers
  static constexpr bool W1_REGS = J1 <= 3;
};

// ... and that of ppo_update_bf16_wide_kernel (hidden 128 and 256)
constexpr int THREADS_W = 256;   // per CTA: 8 warps
constexpr int WARPS_W = THREADS_W / 32;
constexpr int UW = WIDE ? H / WARPS_W : 16;   // the units a warp owns: 16 at 128, 32 at 256
constexpr int NBW = UW / 8, QW = NBW / 2;   // their n8 blocks, their k16 steps as an A operand
constexpr int MTS = TS / 16;     // a tile's m16 row blocks
constexpr int MTW = UW / 16;     // the warp's units' m16 row blocks (a weight gradient's rows)
constexpr int NGW = 8 / MTW;     // add_outer's column blocks at a time
constexpr int RING = 4;          // the k16 steps of a lane's weight ring
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct WideDims : StageDims<IN_, KP_, KC_, HAS_V_, TEAM_> {
  using S = StageDims<IN_, KP_, KC_, HAS_V_, TEAM_>;
  using S::IN, S::KO, S::INP, S::IN8, S::STAGE_ROWS;
  static constexpr int KTX = INP / 16, NC1 = IN8 / 8;
  using P1 = PackedB<UW, KTX>;                         // w1 (the forward)
  using P2 = PackedB<UW, H / 16>;                      // w2 (the forward), w2^T (the backward)
  using Ring = BRing<NBW, RING>;
  // the bf16 scratch after the partials, in words: w1, w2, w2^T
  static constexpr int SCRATCH_WORDS = P1::WORDS + 2 * P2::WORDS;
  // bf16 (in elements): W3 [16][LH]; the tile's x [INP][LX] (feature-major);
  // A [TS][LH] (h1, then gh1) and B [TS][LH] (h2, then gh2), sample-major; G3
  // [TS][L3]; the warps' weight rings
  static constexpr int LH = lda(H), LX = lda(TS), L3 = lda(KO_MAX);
  static constexpr int S_W3 = 0, S_X = S_W3 + KO_MAX * LH, S_A = S_X + INP * LX,
                       S_B = S_A + TS * LH, S_G3 = S_B + TS * LH, S_RING = S_G3 + TS * L3,
                       S_END = S_RING + 2 * WARPS_W * Ring::WARP_WORDS;
  // then in floats: b1 [H], b2 [H], b3 [16], the logit tile [TS][ZLD], one stage
  static constexpr int F_B1 = (S_END / 2 + 3) / 4 * 4, F_B2 = F_B1 + H, F_B3 = F_B2 + H,
                       F_Z = F_B3 + KO_MAX, F_STAGE = (F_Z + TS * ZLD + 3) / 4 * 4;
  static constexpr size_t SMEM = sizeof(float) * ((size_t)F_STAGE + STAGE_ROWS * LD);
  static_assert(smem_fits(SMEM, 1), "the tiles, the rings and one stage must fit an SM");
  // the closing reduce ([KO][TS], [3][TS] floats) reuses A
  static_assert(!WIDE || (KO_MAX + 3) * TS * 4 <= TS * LH * 2, "the closing reduce fits A");
};

// where a wide pass's bf16 weights start in partials (floats): after its
// n_parts partials, 16-byte aligned
__host__ __device__ constexpr size_t scratch_offset(int n_parts, int ng) {
  return ((size_t)n_parts * ng + 3) / 4 * 4;
}

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

// tile ti's inputs into stage st by a CTA of NT threads: 16-byte pieces where
// the tile's samples are one run of lanes in one batch row, else element by
// element, zeros past the end
template <class D, int NT = THREADS>
__device__ __forceinline__ void stage_tile(const Batch& b, float* __restrict__ st, size_t ti,
                                           size_t n_samples, size_t N, int n_agents, int tid) {
  const size_t m0 = ti * TS;
  const size_t ta0 = m0 / N, lane0 = m0 - ta0 * N;
  if (m0 + TS <= n_samples && lane0 + TS <= N && N % 4 == 0) {
    constexpr int PIECES = TS / 4;
    for (int i = tid; i < D::STAGE_ROWS * PIECES; i += NT) {
      const int r = i / PIECES, q = i - r * PIECES;
      stage16(st + r * LD + 4 * q,
              input_row<D>(b, r, ta0, N, n_agents) + lane0 + 4 * q);
    }
  } else {
    for (int i = tid; i < D::STAGE_ROWS * TS; i += NT) {
      const int r = i / TS, s = i - r * TS;
      const size_t m = m0 + s;
      float* dst = st + r * LD + s;
      if (m < n_samples) {
        const size_t ta = m / N;
        stage4(dst, input_row<D>(b, r, ta, N, n_agents) + (m - ta * N));
      } else {
        *dst = 0.0f;
      }
    }
  }
}

// ---- the head: one thread per sample (mpe_update.cu's arithmetic) ----------

// the softmax of logits zr[K0, K0 + K) against the one-hots oh (rows LD
// apart, sample s): p, the entropy -sum p log p and the log-probability of
// the one-hot action (mpe_update.cu's arithmetic and order); the log-softmax
// is recomputed where it is needed, z - zm - lse
template <int K0, int K>
__device__ __forceinline__ void softmax_head(const float* __restrict__ zr,
                                             const float* __restrict__ oh, int s, float (&p)[K],
                                             float& zm, float& lse, float& ent, float& lp) {
  zm = zr[K0];
#pragma unroll
  for (int c = 1; c < K; ++c) zm = fmaxf(zm, zr[K0 + c]);
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    p[c] = expf(zr[K0 + c] - zm);
    sum = sum + p[c];
  }
  lse = logf(sum);
  ent = 0.0f;
  lp = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float ls = (zr[K0 + c] - zm) - lse;
    p[c] = p[c] / sum;
    ent = ent + p[c] * ls;
    lp = lp + ls * oh[c * LD + s];
  }
  ent = -ent;
}

// sample s of the stage st (batch row ta): its outputs z in the logit row zr
// -> its output gradient G3 there; adds the sample's (pg, vloss, entropy)
// terms to ms and its G3 to ab3. A sample past the end gets G3 = 0
template <class D>
__device__ __forceinline__ void head(const float* __restrict__ st, float* __restrict__ zr, int s,
                                     bool valid, size_t ta, const UpdateConsts& k,
                                     float (&ms)[3], float (&ab3)[D::KO]) {
  constexpr int KO = D::KO, KP = D::KP, KC = D::KC;
  [[maybe_unused]] float gv = 0.0f;
  if constexpr (D::HAS_V) {                           // the value gradient, before zr changes
    const float v = zr[KO - 1], vo = st[D::A_VOLD * LD + s], r = st[D::A_RET * LD + s];
    const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
    const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
    // live where the max's first branch wins or the clip does not bind
    // (ops/fused_update.py::_value_clip_grad)
    gv = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
    if (valid) ms[1] = ms[1] + fmaxf(d1, d2);
  }
  if constexpr (KP > 0) {
    float p[KP], zm, lse, ent_m, lp;
    softmax_head<0, KP>(zr, st + D::A_MV * LD, s, p, zm, lse, ent_m, lp);
    float ent = ent_m;
    [[maybe_unused]] float speak = 0.0f;
    [[maybe_unused]] float pc[KC > 0 ? KC : 1];
    [[maybe_unused]] float zmc = 0.0f, lsec = 0.0f, ent_c = 0.0f;
    if constexpr (KC > 0) {
      const int agent = (int)(ta % (size_t)k.n_agents);
      speak = ((k.speak_mask >> agent) & 1) ? 1.0f : 0.0f;
      float lp_c;
      softmax_head<KP, KC>(zr, st + D::A_CM * LD, s, pc, zmc, lsec, ent_c, lp_c);
      lp = lp + lp_c * speak;
      ent = ent_m + ent_c * speak;
    }
    const float a = st[D::A_ADV * LD + s];
    const float ratio = expf(lp - st[D::A_LPO * LD + s]);
    const float rc = fminf(fmaxf(ratio, k.ratio_lo), k.ratio_hi);
    const float s1 = ratio * a, s2 = rc * a;
    const float cpg = (s1 <= s2) ? -(a * ratio) * k.inv_b : 0.0f;
    if constexpr (KC > 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float ls = (zr[KP + c] - zmc) - lsec, oh = st[(D::A_CM + c) * LD + s];
        const float g = valid ? (cpg * (oh - pc[c]) + (k.ent_scale * pc[c]) * (ls + ent_c)) * speak
                              : 0.0f;
        zr[KP + c] = g;
        ab3[KP + c] = ab3[KP + c] + g;
      }
    }
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      const float ls = (zr[c] - zm) - lse, oh = st[(D::A_MV + c) * LD + s];
      const float g = valid ? cpg * (oh - p[c]) + (k.ent_scale * p[c]) * (ls + ent_m) : 0.0f;
      zr[c] = g;
      ab3[c] = ab3[c] + g;
    }
    if (valid) {
      ms[0] = ms[0] - fminf(s1, s2);
      ms[2] = ms[2] + ent;
    }
  }
  if constexpr (D::HAS_V) {
    const float g = valid ? gv : 0.0f;
    zr[KO - 1] = g;
    ab3[KO - 1] = ab3[KO - 1] + g;
  }
}

// the bias sums of one tile: v[NB][2] (a lane's two columns of each n8 block,
// its two rows summed) summed over the warp's 16 rows by a reduce-scatter
// over the row lanes (xor 16, 8, 4), in the same order every run, and added
// to acc[2], the columns of the n8 block the lane owns (own_block): g >> (3 -
// log2 NB), where the lane's low row bits are 0
template <int NB>
__device__ __forceinline__ void tile_bias_sums(float (&v)[NB][2], float (&acc)[2], int lane) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "hidden units in 2, 4 or 8 n8 blocks");
  const int g = lane >> 2;
#pragma unroll
  for (int level = 0; level < 3; ++level) {
    const int mask = 16 >> level, half = (NB >> level) / 2;
    const bool hi = (g >> (2 - level)) & 1;
    if (half >= 1) {                                     // keep one half, pass the other on
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        if (i < half) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float keep = hi ? v[i + half][q] : v[i][q];
            const float send = hi ? v[i][q] : v[i + half][q];
            v[i][q] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
          }
        }
      }
    } else {                                             // one block left: plain butterfly
#pragma unroll
      for (int q = 0; q < 2; ++q) v[0][q] = v[0][q] + __shfl_xor_sync(0xffffffffu, v[0][q], mask);
    }
  }
  constexpr int SHIFT = NB == 8 ? 0 : NB == 4 ? 1 : 2;
  if ((g & ((1 << SHIFT) - 1)) == 0) {
    acc[0] = acc[0] + v[0][0];
    acc[1] = acc[1] + v[0][1];
  }
}

// ---- the kernel --------------------------------------------------------------

// the dW tiles j WARPS + warp (j < J) of an (MT row blocks) x (NC column blocks)
// gradient, summed over the tile's samples: G sample-major [TS][ldg]; X
// sample-major [TS][ldx] or, XF, feature-major [n][ldx] (the tile's x)
template <int NT, int NC, int J, bool XF>
__device__ __forceinline__ void outer_tiles(const uint16_t* G, int ldg, const uint16_t* X, int ldx,
                                            int warp, int lane, float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int tile = j * WARPS + warp;
    if (tile < NT) {                                    // the same in the whole warp
      const int m0 = 16 * (tile / NC), n0 = 8 * (tile % NC);
#pragma unroll
      for (int s0 = 0; s0 < TS; s0 += 16) {
        uint32_t a[4], b[2];
        frag_a_km(G, ldg, s0, m0, lane, a);
        if constexpr (XF) {
          frag_b_nk(X, ldx, n0, s0, lane, b);
        } else {
          frag_b_kn(X, ldx, s0, n0, lane, b);
        }
        mma_bf16(acc[j], a, b);
      }
    }
  }
}

// the tiles' accumulators acc[j] into dst [n_rows][n_cols], as outer_tiles
// deals them (ADD: added to what dst holds)
template <int NT, int NC, int J, bool ADD = false>
__device__ __forceinline__ void store_tiles(float* __restrict__ dst, int n_rows, int n_cols,
                                            int warp, int lane, const float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int tile = j * WARPS + warp;
    if (tile >= NT) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 16 * (tile / NC) + (lane >> 2) + 8 * (i >> 1);
      const int n = 8 * (tile % NC) + 2 * (lane & 3) + (i & 1);
      if (m < n_rows && n < n_cols) {
        float* p = dst + m * n_cols + n;
        *p = ADD ? *p + acc[j][i] : acc[j][i];
      }
    }
  }
}

// acc[nb] += G[s][m0 ..]^T X[s][n0 + 8 nb ..] over the tile's samples: one
// row block of a weight gradient, its A fragment loaded once a k16 step; X
// sample-major or, XF, feature-major (the tile's x)
template <int NB, bool XF>
__device__ __forceinline__ void outer_row(const uint16_t* G, int ldg, int m0, const uint16_t* X,
                                          int ldx, int n0, int lane, float (&acc)[NB][4]) {
#pragma unroll
  for (int s0 = 0; s0 < TS; s0 += 16) {
    uint32_t a[4];
    frag_a_km(G, ldg, s0, m0, lane, a);
#pragma unroll
    for (int nb = 0; nb + 1 < NB; nb += 2) {
      uint32_t b[2][2];
      if constexpr (XF) {
        frag_b2_nk(X, ldx, n0 + 8 * nb, s0, lane, b);
      } else {
        frag_b2_kn(X, ldx, s0, n0 + 8 * nb, lane, b);
      }
      mma_bf16(acc[nb], a, b[0]);
      mma_bf16(acc[nb + 1], a, b[1]);
    }
    if constexpr (NB % 2 == 1) {
      uint32_t b[2];
      if constexpr (XF) {
        frag_b_nk(X, ldx, n0 + 8 * (NB - 1), s0, lane, b);
      } else {
        frag_b_kn(X, ldx, s0, n0 + 8 * (NB - 1), lane, b);
      }
      mma_bf16(acc[NB - 1], a, b);
    }
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

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
  constexpr int KO = D::KO, NBO = D::NBO, KTX = D::INP / 16;
  constexpr Packed L = packed(IN, KO);
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  const uint16_t* W1 = w16 + D::S_W1;
  const uint16_t* W2 = w16 + D::S_W2;
  const uint16_t* W3 = w16 + D::S_W3;
  uint16_t* Xf = w16 + D::S_X;
  uint16_t* H1s = w16 + D::S_H1;
  uint16_t* H2s = w16 + D::S_H2;
  uint16_t* GH1s = w16 + D::S_GH1;
  uint16_t* GH2s = w16 + D::S_GH2;
  uint16_t* G3s = w16 + D::S_G3;
  float* b1 = smem + D::F_B1;
  float* b2 = smem + D::F_B2;
  float* b3 = smem + D::F_B3;
  float* stages = smem + D::F_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int s0 = WS * warp;                            // the warp's samples in a tile
  float* zt = smem + D::F_Z + warp * WS * ZLD;         // the warp's logit tile [WS][ZLD]
  const size_t N = (size_t)n_envs;
  const size_t n_samples = (size_t)n_rows * N;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  const Batch b{obs, mvoh, cmoh, lpo, adv, ret, vold};
  float* part = partials + (size_t)blockIdx.x * L.ng;

  if (blockIdx.x < n_tiles) stage_tile<D>(b, stages, blockIdx.x, n_samples, N, k.n_agents, tid);
  stage_commit();
  // the weights rounded to bf16, a pair a thread at a time, zeros in every
  // padding row and column
  auto round_rows = [&](int s_off, int rows, int ld, int n_rows_in, int n_cols_in, int g_off) {
    for (int i = tid; i < rows * ld / 2; i += THREADS) {
      const int m = 2 * i / ld, c = 2 * i - m * ld;
      const bool in = m < n_rows_in;
      const float lo = in && c < n_cols_in ? weights[g_off + m * n_cols_in + c] : 0.0f;
      const float hi = in && c + 1 < n_cols_in ? weights[g_off + m * n_cols_in + c + 1] : 0.0f;
      *reinterpret_cast<uint32_t*>(w16 + s_off + 2 * i) = pack_bf16(lo, hi);
    }
  };
  round_rows(D::S_W1, HP, D::L1, H, IN, L.g_w1);
  round_rows(D::S_W2, HP, D::LH, H, H, L.g_w2);
  round_rows(D::S_W3, KO_MAX, D::LH, KO, H, L.g_w3);
  for (int i = tid; i < (D::INP - IN) * D::LX; i += THREADS) Xf[IN * D::LX + i] = 0;
  for (int i = tid; i < WARPS * WS * ZLD; i += THREADS) smem[D::F_Z + i] = 0.0f;
  if (tid < HP) {
    b1[tid] = tid < H ? weights[L.g_b1 + tid] : 0.0f;
    b2[tid] = tid < H ? weights[L.g_b2 + tid] : 0.0f;
  }
  if (tid < KO_MAX) b3[tid] = tid < KO ? weights[L.g_b3 + tid] : 0.0f;
  if constexpr (!D::W1_REGS) {                          // dW1 is added into the partial
    for (int i = tid; i < H * IN; i += THREADS) part[L.g_w1 + i] = 0.0f;
  }

  float a1[D::W1_REGS ? D::J1 : 1][4], a2[D::J2][4], a3[D::J3][4];
  // db1, db2 of the lane's own n8 block's two columns (tile_bias_sums); db3
  // and the metrics of the head's lanes
  float ab1[2] = {0.0f, 0.0f}, ab2[2] = {0.0f, 0.0f}, ab3[KO], ms[3] = {0.0f, 0.0f, 0.0f};
  zero(a1);
  zero(a2);
  zero(a3);
#pragma unroll
  for (int c = 0; c < KO; ++c) ab3[c] = 0.0f;

  int it = 0;
  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x, ++it) {
    float* st = stages + (D::STAGES == 2 ? (it & 1) : 0) * D::STAGE_ROWS * LD;
    stage_wait<0>();
    __syncthreads();                                   // the tile's inputs in, the last pass done
    if (ti + gridDim.x < n_tiles) {                    // the next tile's inputs in flight
      if constexpr (D::STAGES == 2)
        stage_tile<D>(b, stages + ((it + 1) & 1) * D::STAGE_ROWS * LD, ti + gridDim.x, n_samples,
                      N, k.n_agents, tid);
    }
    if constexpr (D::STAGES == 2) stage_commit();
    // the warp's x columns rounded to bf16, a pair of samples a lane at a time
    for (int e = lane; e < IN * (WS / 2); e += 32) {
      const int r = e / (WS / 2), c = s0 + 2 * (e - r * (WS / 2));
      *reinterpret_cast<uint32_t*>(Xf + r * D::LX + c) =
          pack_bf16(st[r * LD + c], st[r * LD + c + 1]);
    }
    __syncwarp();
    // forward: h1 = tanh(x W1^T + b1), h2 = tanh(h1 W2^T + b2), z = h2 W3^T + b3
    float h1[NBH][4], h2[NBH][4];
    uint32_t ah[KTH][4];
    warp_dense_f<NBH, KTX, false>(
        [&](int kt, uint32_t (&a)[4]) { frag_a_km(Xf, D::LX, 16 * kt, s0, lane, a); }, W1, D::L1,
        lane, h1);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) h1[nb][i] = tanhf(h1[nb][i] + b1[8 * nb + 2 * t + (i & 1)]);
    pack_a(h1, ah);
    store_a(ah, H1s, D::LH, s0, lane);
    warp_dense<NBH, KTH, false>(ah, W2, D::LH, lane, h2);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) h2[nb][i] = tanhf(h2[nb][i] + b2[8 * nb + 2 * t + (i & 1)]);
    pack_a(h2, ah);
    store_a(ah, H2s, D::LH, s0, lane);
    {
      float z[NBO][4];
      warp_dense<NBO, KTH, false>(ah, W3, D::LH, lane, z);
#pragma unroll
      for (int nb = 0; nb < NBO; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * nb + 2 * t + (i & 1);
          zt[(g + 8 * (i >> 1)) * ZLD + c] = z[nb][i] + b3[c];
        }
    }
    __syncwarp();
    if (lane < WS) {                                   // the head, a sample a lane
      const size_t m = ti * TS + s0 + lane;
      head<D>(st, zt + lane * ZLD, s0 + lane, m < n_samples, m / N, k, ms, ab3);
    }
    __syncwarp();
    // backward: gh2 = (g3 W3) (1 - h2^2), gh1 = (gh2 W2) (1 - h1^2); g3 rounded
    // from the logit tile (zeros past KO)
    uint32_t a3g[1][4];
    {
      const float* r0 = zt + g * ZLD + 2 * t;
      const float* r1 = r0 + 8 * ZLD;
      a3g[0][0] = pack_bf16(r0[0], r0[1]);
      a3g[0][1] = pack_bf16(r1[0], r1[1]);
      a3g[0][2] = pack_bf16(r0[8], r0[9]);
      a3g[0][3] = pack_bf16(r1[8], r1[9]);
    }
    store_a(a3g, G3s, D::L3, s0, lane);
    {
      float gh[NBH][4], cols[NBH][2];
      warp_dense<NBH, 1, true>(a3g, W3, D::LH, lane, gh);
#pragma unroll
      for (int nb = 0; nb < NBH; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) gh[nb][i] = gh[nb][i] * (1.0f - h2[nb][i] * h2[nb][i]);
        cols[nb][0] = gh[nb][0] + gh[nb][2];
        cols[nb][1] = gh[nb][1] + gh[nb][3];
      }
      tile_bias_sums(cols, ab2, lane);
      pack_a(gh, ah);
      store_a(ah, GH2s, D::LH, s0, lane);
      warp_dense<NBH, KTH, true>(ah, W2, D::LH, lane, gh);
#pragma unroll
      for (int nb = 0; nb < NBH; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) gh[nb][i] = gh[nb][i] * (1.0f - h1[nb][i] * h1[nb][i]);
        cols[nb][0] = gh[nb][0] + gh[nb][2];
        cols[nb][1] = gh[nb][1] + gh[nb][3];
      }
      tile_bias_sums(cols, ab1, lane);
      pack_a(gh, ah);
      store_a(ah, GH1s, D::LH, s0, lane);
    }
    __syncthreads();                                   // the tile's operands are in
    if constexpr (D::STAGES == 1) {                    // the stage is free: the next tile's inputs
      if (ti + gridDim.x < n_tiles)
        stage_tile<D>(b, stages, ti + gridDim.x, n_samples, N, k.n_agents, tid);
      stage_commit();
    }
    // the weight gradients over the tile's samples: dW3 += G3^T H2, dW2 +=
    // GH2^T H1, dW1 += GH1^T X (the padding rows of X add zeros)
    if constexpr (D::ROWS) {
      outer_row<2, false>(G3s, D::L3, 0, H2s, D::LH, 16 * warp, lane, a3);
      outer_row<H / 8, false>(GH2s, D::LH, 16 * warp, H1s, D::LH, 0, lane, a2);
      if constexpr (D::W1_REGS) {
        outer_row<D::NC1, true>(GH1s, D::LH, 16 * warp, Xf, D::LX, 0, lane, a1);
      } else {                                         // a tile at a time, added into the partial
#pragma unroll 1
        for (int nb = 0; nb < D::NC1; ++nb) {
          float a1t[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
          outer_row<1, true>(GH1s, D::LH, 16 * warp, Xf, D::LX, 8 * nb, lane, a1t);
          store_tile<false, true>(part + L.g_w1, H, IN, 16 * warp, 8 * nb, lane, a1t[0]);
        }
      }
    } else {
      outer_tiles<D::NT3, D::NT3, D::J3, false>(G3s, D::L3, H2s, D::LH, warp, lane, a3);
      outer_tiles<D::NT2, H / 8, D::J2, false>(GH2s, D::LH, H1s, D::LH, warp, lane, a2);
      if constexpr (D::W1_REGS) {
        outer_tiles<D::NT1, D::NC1, D::J1, true>(GH1s, D::LH, Xf, D::LX, warp, lane, a1);
      } else {                                         // a tile at a time, added into the partial
#pragma unroll 1
        for (int j = 0; j < D::J1; ++j) {
          float a1t[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
          outer_tiles<D::NT1, D::NC1, 1, true>(GH1s, D::LH, Xf, D::LX, j * WARPS + warp, lane,
                                               a1t);
          store_tiles<D::NT1, D::NC1, 1, true>(part + L.g_w1, H, IN, j * WARPS + warp, lane, a1t);
        }
      }
    }
  }
  stage_wait<0>();

  if constexpr (D::ROWS) {
#pragma unroll
    for (int nb = 0; nb < D::J1; ++nb)
      if constexpr (D::W1_REGS) store_tile(part + L.g_w1, H, IN, 16 * warp, 8 * nb, lane, a1[nb]);
#pragma unroll
    for (int nb = 0; nb < H / 8; ++nb)
      store_tile(part + L.g_w2, H, H, 16 * warp, 8 * nb, lane, a2[nb]);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
      store_tile(part + L.g_w3, KO, H, 0, 16 * warp + 8 * nb, lane, a3[nb]);
  } else {
    if constexpr (D::W1_REGS)
      store_tiles<D::NT1, D::NC1, D::J1>(part + L.g_w1, H, IN, warp, lane, a1);
    store_tiles<D::NT2, H / 8, D::J2>(part + L.g_w2, H, H, warp, lane, a2);
    store_tiles<D::NT3, D::NT3, D::J3>(part + L.g_w3, KO, H, warp, lane, a3);
  }
  // the bias and metric sums over the CTA's threads, in a fixed order: db1 and
  // db2 of unit u from its owning lane in each warp, the warps in order, db3
  // over the head's 64 lanes, the metrics over all 128 threads
  __syncthreads();
  float* red = reinterpret_cast<float*>(H1s);          // [2][HP][WARPS], [KO][TS], [3][THREADS]
  {
    constexpr int SHIFT = NBH == 8 ? 0 : NBH == 4 ? 1 : 2;   // tile_bias_sums' owners
    if ((g & ((1 << SHIFT) - 1)) == 0) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int u = 8 * (g >> SHIFT) + 2 * t + p;
        red[u * WARPS + warp] = ab1[p];
        red[(HP + u) * WARPS + warp] = ab2[p];
      }
    }
  }
  float* red3 = red + 2 * HP * WARPS;
  if (lane < WS) {
#pragma unroll
    for (int c = 0; c < KO; ++c) red3[c * TS + s0 + lane] = ab3[c];
  }
  float* redm = red3 + KO * TS;
#pragma unroll
  for (int q = 0; q < 3; ++q) redm[q * THREADS + tid] = ms[q];
  __syncthreads();
  if (tid < H) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int q = 0; q < WARPS; ++q) {
      s1 = s1 + red[tid * WARPS + q];
      s2 = s2 + red[(HP + tid) * WARPS + q];
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

// ---- the wide kernel (hidden 128 and 256) ---------------------------------------

// w1, w2 and w2^T of a wide pass rounded to bf16 into the scratch, each
// fragment-packed (PackedB; zeros past IN): a launch of the call, before the
// gradient kernel
template <int IN>
__global__ void update_round_bf16_kernel(const float* __restrict__ weights,
                                         uint32_t* __restrict__ scratch) {
  using P1 = PackedB<UW, (IN + 15) / 16>;
  using P2 = PackedB<UW, H / 16>;
  constexpr Packed L = packed(IN, 1);                  // w1's and w2's offsets take no outputs
  const float* w1 = weights + L.g_w1;
  const float* w2 = weights + L.g_w2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < P1::WORDS + 2 * P2::WORDS;
       e += gridDim.x * blockDim.x) {
    uint32_t v;
    if (e < P1::WORDS) {
      v = P1::word(e, [&](int n, int k) { return k < IN ? w1[n * IN + k] : 0.0f; });
    } else if (e < P1::WORDS + P2::WORDS) {
      v = P2::word(e - P1::WORDS, [&](int n, int k) { return w2[n * H + k]; });
    } else {
      v = P2::word(e - P1::WORDS - P2::WORDS, [&](int n, int k) { return w2[k * H + n]; });
    }
    scratch[e] = v;
  }
}

// h[mt][nb] = tanh(h + b[unit]) for the warp's units (b from the first), then
// rounded into rows of the sample-major bf16 tile T (the warp's columns)
__device__ __forceinline__ void tanh_rows(float (&h)[MTS][NBW][4], const float* b, uint16_t* T,
                                          int ld, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[mt][nb][i] = tanhf(h[mt][nb][i] + b[8 * nb + 2 * t + (i & 1)]);
    uint32_t a[QW][4];
    pack_a(h[mt], a);
    store_a(a, T, ld, 16 * mt, lane);
  }
}

// g *= 1 - h^2 (float32), its two columns of each n8 block summed into db
// over the lane's two rows
__device__ __forceinline__ void tanh_grad(float (&g)[NBW][4], const float (&h)[NBW][4],
                                          float (&db)[NBW][2]) {
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) g[nb][i] = g[nb][i] * (1.0f - h[nb][i] * h[nb][i]);
    db[nb][0] = db[nb][0] + (g[nb][0] + g[nb][2]);
    db[nb][1] = db[nb][1] + (g[nb][1] + g[nb][3]);
  }
}

// ppo_update_bf16_kernel's function at hidden 128 and 256 (the source note):
// a persistent grid over tiles of TS samples, 8 warps each owning UW units;
// the products streamed from the bf16 scratch (update_round_bf16_kernel),
// dW1 and dW2 added into the CTA's partial tile by tile
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__global__ void __launch_bounds__(THREADS_W, 1)
ppo_update_bf16_wide_kernel(const float* __restrict__ weights,
                            const uint32_t* __restrict__ scratch, const float* __restrict__ obs,
                            const float* __restrict__ mvoh, const float* __restrict__ cmoh,
                            const float* __restrict__ lpo, const float* __restrict__ adv,
                            const float* __restrict__ ret, const float* __restrict__ vold,
                            float* __restrict__ partials, int n_rows, int n_envs,
                            UpdateConsts k) {
  using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
  using Ring = typename D::Ring;
  constexpr int KO = D::KO, NBO = D::NBO, LH = D::LH, LX = D::LX, L3 = D::L3, KTW = H / 16;
  constexpr Packed L = packed(IN, KO);
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* W3s = w16 + D::S_W3;
  uint16_t* Xf = w16 + D::S_X;
  uint16_t* As = w16 + D::S_A;
  uint16_t* Bs = w16 + D::S_B;
  uint16_t* G3s = w16 + D::S_G3;
  float* b1 = smem + D::F_B1;
  float* b2 = smem + D::F_B2;
  float* b3 = smem + D::F_B3;
  float* zt = smem + D::F_Z;
  float* st = smem + D::F_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int u0 = UW * warp;                            // the warp's units
  uint32_t* ring = reinterpret_cast<uint32_t*>(w16 + D::S_RING) + warp * Ring::WARP_WORDS;
  const uint32_t* p1 = scratch + warp * D::P1::WARP_WORDS;
  const uint32_t* p2 = scratch + D::P1::WORDS + warp * D::P2::WARP_WORDS;
  const uint32_t* p2t = p2 + D::P2::WORDS;
  const size_t N = (size_t)n_envs;
  const size_t n_samples = (size_t)n_rows * N;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  const Batch b{obs, mvoh, cmoh, lpo, adv, ret, vold};
  float* part = partials + (size_t)blockIdx.x * L.ng;

  if (blockIdx.x < n_tiles)
    stage_tile<D, THREADS_W>(b, st, blockIdx.x, n_samples, N, k.n_agents, tid);
  stage_commit();
  for (int i = tid; i < KO_MAX * LH / 2; i += THREADS_W) {   // w3 in bf16 rows, zeros past KO
    const int m = 2 * i / LH, c = 2 * i - m * LH;
    const bool in = m < KO;
    const float lo = in && c < H ? weights[L.g_w3 + m * H + c] : 0.0f;
    const float hi = in && c + 1 < H ? weights[L.g_w3 + m * H + c + 1] : 0.0f;
    *reinterpret_cast<uint32_t*>(W3s + 2 * i) = pack_bf16(lo, hi);
  }
  for (int i = tid; i < (D::INP - IN) * LX; i += THREADS_W) Xf[IN * LX + i] = 0;
  for (int i = tid; i < TS * ZLD; i += THREADS_W) zt[i] = 0.0f;
  for (int i = tid; i < H; i += THREADS_W) {
    b1[i] = weights[L.g_b1 + i];
    b2[i] = weights[L.g_b2 + i];
  }
  if (tid < KO_MAX) b3[tid] = tid < KO ? weights[L.g_b3 + tid] : 0.0f;
  for (int i = tid; i < L.ng; i += THREADS_W) part[i] = 0.0f;   // dW1, dW2 are added into it

  // dW3 of the warp's units over the CTA's tiles; db1, db2 of the lane's
  // columns over its rows; db3 and the metrics of the head's threads
  float a3[NBW][4], ab1[NBW][2], ab2[NBW][2], ab3[KO], ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a3[nb][i] = 0.0f;
    ab1[nb][0] = ab1[nb][1] = ab2[nb][0] = ab2[nb][1] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < KO; ++c) ab3[c] = 0.0f;

  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    stage_wait<0>();
    __syncthreads();                                   // the tile's inputs in, the last tile done
    for (int e = tid; e < IN * (TS / 2); e += THREADS_W) {   // x in bf16, two samples at a time
      const int r = e / (TS / 2), c = 2 * (e - r * (TS / 2));
      *reinterpret_cast<uint32_t*>(Xf + r * LX + c) = pack_bf16(st[r * LD + c], st[r * LD + c + 1]);
    }
    __syncthreads();
    // forward: h1 = tanh(x W1^T + b1), h2 = tanh(h1 W2^T + b2) of the warp's
    // units, each rounded into its tile for the next product
    float h1[MTS][NBW][4], h2[MTS][NBW][4];
    Ring::template product<MTS, D::KTX>(
        [&](int mt, int kt, uint32_t (&a)[4]) { frag_a_km(Xf, LX, 16 * kt, 16 * mt, lane, a); },
        p1, ring, lane, h1);
    tanh_rows(h1, b1 + u0, As + u0, LH, lane);
    __syncthreads();
    Ring::template product<MTS, KTW>(
        [&](int mt, int kt, uint32_t (&a)[4]) { frag_a_mk(As, LH, 16 * mt, 16 * kt, lane, a); },
        p2, ring, lane, h2);
    tanh_rows(h2, b2 + u0, Bs + u0, LH, lane);
    __syncthreads();
    {                                    // z = h2 W3^T + b3: warp w one (16 x 8) tile
      const int mt = warp % MTS, nb = warp / MTS;
      if (nb < NBO) {
        float z[1][4];
        warp_dense_f<1, KTW, false>(
            [&](int kt, uint32_t (&a)[4]) { frag_a_mk(Bs, LH, 16 * mt, 16 * kt, lane, a); },
            W3s + 8 * nb * LH, LH, lane, z);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * nb + 2 * t + (i & 1);
          zt[(16 * mt + g + 8 * (i >> 1)) * ZLD + c] = z[0][i] + b3[c];
        }
      }
    }
    __syncthreads();
    if (tid < TS) {                                    // the head, a sample a thread; G3 in bf16
      const size_t m = ti * TS + tid;
      float* zr = zt + tid * ZLD;
      head<D>(st, zr, tid, m < n_samples, m / N, k, ms, ab3);
#pragma unroll
      for (int c = 0; c < KO_MAX; c += 2)
        *reinterpret_cast<uint32_t*>(G3s + tid * L3 + c) = pack_bf16(zr[c], zr[c + 1]);
    }
    __syncthreads();
    // dW3 += G3^T H2 over the tile's samples (the warp's units)
#pragma unroll
    for (int ks = 0; ks < MTS; ++ks) {
      uint32_t a[4];
      frag_a_km(G3s, L3, 16 * ks, 0, lane, a);
#pragma unroll
      for (int nb = 0; nb < NBW; nb += 2) {
        uint32_t bb[2][2];
        frag_b2_kn(Bs, LH, 16 * ks, u0 + 8 * nb, lane, bb);
        mma_bf16(a3[nb], a, bb[0]);
        mma_bf16(a3[nb + 1], a, bb[1]);
      }
    }
    __syncwarp();
    {                                                   // gh2 = (g3 W3) (1 - h2^2), into B
      uint32_t bw[NBW][2];
#pragma unroll
      for (int nb = 0; nb < NBW; nb += 2) {
        uint32_t bb[2][2];
        frag_b2_kn(W3s, LH, 0, u0 + 8 * nb, lane, bb);
        bw[nb][0] = bb[0][0];
        bw[nb][1] = bb[0][1];
        bw[nb + 1][0] = bb[1][0];
        bw[nb + 1][1] = bb[1][1];
      }
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) {
        uint32_t a[4];
        frag_a_mk(G3s, L3, 16 * mt, 0, lane, a);
        float gh[NBW][4];
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) gh[nb][i] = 0.0f;
          mma_bf16(gh[nb], a, bw[nb]);
        }
        tanh_grad(gh, h2[mt], ab2);
        uint32_t ap[QW][4];
        pack_a(gh, ap);
        store_a(ap, Bs + u0, LH, 16 * mt, lane);
      }
    }
    __syncthreads();                                   // gh2 whole
    // gh1 = (gh2 W2) (1 - h1^2), kept packed until every warp has read h1
    uint32_t ag1[MTS][QW][4];
    {
      float gh[MTS][NBW][4];
      Ring::template product<MTS, KTW>(
          [&](int mt, int kt, uint32_t (&a)[4]) { frag_a_mk(Bs, LH, 16 * mt, 16 * kt, lane, a); },
          p2t, ring, lane, gh);
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) {
        tanh_grad(gh[mt], h1[mt], ab1);
        pack_a(gh[mt], ag1[mt]);
      }
    }
    // the stage is read: the next tile's inputs in flight
    if (ti + gridDim.x < n_tiles)
      stage_tile<D, THREADS_W>(b, st, ti + gridDim.x, n_samples, N, k.n_agents, tid);
    stage_commit();
    // dW2 += GH2^T H1: rows the warp's units of h2, columns every unit of h1
    add_outer<MTW, MTS, H / 8, NGW>(
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(Bs, LH, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_kn(As, LH, 16 * ks, 8 * nb, lane, bb);
        },
        part + L.g_w2, H, H, u0, lane);
    __syncthreads();                                   // every warp's reads of h1 done
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) store_a(ag1[mt], As + u0, LH, 16 * mt, lane);
    __syncwarp();
    // dW1 += GH1^T X: rows the warp's units of h1 (the padding rows of X add zeros)
    add_outer<MTW, MTS, D::NC1, NGW>(
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(As, LH, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_nk(Xf, LX, 8 * nb, 16 * ks, lane, bb);
        },
        part + L.g_w1, IN, IN, u0, lane);
  }
  stage_wait<0>();

  // dW3, db1 and db2 (each entry one lane's), then db3 and the metrics over
  // the head's threads in a fixed order
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) {
    store_tile(part + L.g_w3, KO, H, 0, u0 + 8 * nb, lane, a3[nb]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v1 = ab1[nb][p], v2 = ab2[nb][p];
#pragma unroll
      for (int mask = 4; mask < 32; mask <<= 1) {       // over the lane's row group g
        v1 = v1 + __shfl_xor_sync(0xffffffffu, v1, mask);
        v2 = v2 + __shfl_xor_sync(0xffffffffu, v2, mask);
      }
      if (g == 0) {
        part[L.g_b1 + u0 + 8 * nb + 2 * t + p] = v1;
        part[L.g_b2 + u0 + 8 * nb + 2 * t + p] = v2;
      }
    }
  }
  __syncthreads();
  float* red3 = reinterpret_cast<float*>(As);           // [KO][TS], then [3][TS]
  float* redm = red3 + KO * TS;
  if (tid < TS) {
#pragma unroll
    for (int c = 0; c < KO; ++c) red3[c * TS + tid] = ab3[c];
#pragma unroll
    for (int q = 0; q < 3; ++q) redm[q * TS + tid] = ms[q];
  }
  __syncthreads();
  if (tid < KO) {
    float s3 = 0.0f;
    for (int s = 0; s < TS; ++s) s3 = s3 + red3[tid * TS + s];
    part[L.g_b3 + tid] = s3;
  }
  if (tid < 3) {
    float total = 0.0f;
    for (int s = 0; s < TS; ++s) total = total + redm[tid * TS + s];
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

// one pass: the persistent grid of n_parts CTAs (at hidden 128 and 256 after
// the weights' rounding into the scratch), then the reduce into out
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
cudaError_t update_pass(const float* weights, const float* obs, const float* mvoh,
                        const float* cmoh, const float* lpo, const float* adv, const float* ret,
                        const float* vold, float* partials, float* out, int n_rows, int n_envs,
                        int n_parts, const UpdateConsts& k, float ms_pg, float ms_v,
                        float ms_ent, cudaStream_t stream) {
  const int ng = packed(IN, KP + KC + (HAS_V ? 1 : 0)).ng;
  cudaError_t err;
  if constexpr (WIDE) {
    using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_bf16_wide_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
    if (err != cudaSuccess) return err;
    uint32_t* scratch = reinterpret_cast<uint32_t*>(partials + scratch_offset(n_parts, ng));
    constexpr int ROUND_BLOCKS = (D::SCRATCH_WORDS + 8 * 256 - 1) / (8 * 256);
    update_round_bf16_kernel<IN><<<ROUND_BLOCKS, 256, 0, stream>>>(weights, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    kernel<<<n_parts, THREADS_W, D::SMEM, stream>>>(weights, scratch, obs, mvoh, cmoh, lpo, adv,
                                                    ret, vold, partials, n_rows, n_envs, k);
  } else {
    using D = UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_bf16_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<n_parts, THREADS, D::SMEM, stream>>>(weights, obs, mvoh, cmoh, lpo, adv, ret, vold,
                                                  partials, n_rows, n_envs, k);
  }
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

// f(integral_constant<IN>, <KP>, <KC>, <HAS_V>, <TEAM>) of K6's pass (pass 0)
// or K7's actor pass (1) on the head (in, kc), or of K7's critic pass (2) on
// the joint width in
template <class F>
cudaError_t by_pass(int in, int kc, int pass, F f) {
  using std::integral_constant;
  if (pass == 2)
    return by_joint_width(in, [&](auto j) {
      return f(j, integral_constant<int, 0>{}, integral_constant<int, 0>{}, std::true_type{},
               std::false_type{});
    });
  if (pass != 0 && pass != 1) return cudaErrorInvalidValue;
  return by_actor_head(in, kc, [&](auto ow, auto c) {
    return pass == 0 ? f(ow, integral_constant<int, MOVES>{}, c, std::true_type{},
                         std::false_type{})
                     : f(ow, integral_constant<int, MOVES>{}, c, std::false_type{},
                         std::true_type{});
  });
}

// the CTAs of the card at once for a wide pass (its occupancy x the SMs;
// -1 where the card cannot say)
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
int wide_grid() {
  static const int n = [] {
    using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_bf16_wide_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)D::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS_W, D::SMEM) !=
            cudaSuccess ||
        per_sm < 1)
      return -1;
    return sms * per_sm;
  }();
  return n;
}

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

// The wrappers' sizes of a pass (0: K6; 1: K7's actor; 2: K7's critic on the
// joint width in), -1 for a head or width the kernels are not compiled for:
// the dynamic shared memory of its kernel in bytes
int mpe_update_smem(int in, int kc, int pass) {
  size_t bytes = 0;
  const cudaError_t err = by_pass(in, kc, pass, [&](auto i, auto p, auto c, auto v, auto team) {
    if constexpr (WIDE) {
      bytes = WideDims<decltype(i)::value, decltype(p)::value, decltype(c)::value,
                       decltype(v)::value, decltype(team)::value>::SMEM;
    } else {
      bytes = UpdateDims<decltype(i)::value, decltype(p)::value, decltype(c)::value,
                         decltype(v)::value, decltype(team)::value>::SMEM;
    }
    return cudaSuccess;
  });
  return err == cudaSuccess ? (int)bytes : -1;
}

// ... the floats of the bf16 weights a wide pass keeps in partials after its
// n_parts partials (from scratch_offset); 0 at hidden 8-64
int mpe_update_scratch(int in, int kc, int pass) {
  int words = 0;
  const cudaError_t err = by_pass(in, kc, pass, [&](auto i, auto p, auto c, auto v, auto team) {
    if constexpr (WIDE)
      words = WideDims<decltype(i)::value, decltype(p)::value, decltype(c)::value,
                       decltype(v)::value, decltype(team)::value>::SCRATCH_WORDS;
    return cudaSuccess;
  });
  return err == cudaSuccess ? words : -1;
}

// ... the persistent grid of a wide pass, all the CTAs the card holds at
// once (wide_grid); 0 at hidden 8-64, where the wrapper sets the grid
int mpe_update_grid(int in, int kc, int pass) {
  int n = 0;
  const cudaError_t err = by_pass(in, kc, pass, [&](auto i, auto p, auto c, auto v, auto team) {
    if constexpr (WIDE)
      n = wide_grid<decltype(i)::value, decltype(p)::value, decltype(c)::value,
                    decltype(v)::value, decltype(team)::value>();
    return cudaSuccess;
  });
  return err == cudaSuccess ? n : -1;
}

}  // extern "C"

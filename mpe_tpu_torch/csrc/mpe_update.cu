// Hopper (sm_90a) kernels of the fused PPO and MAPPO epoch gradients, for every
// head of the nine scenarios: 5 move logits, and 3, 4 or 10 comm logits where
// the scenario speaks.
//
// K6  ppo_update_kernel<OW, 5, KC, true, false> + update_reduce_kernel  replace
//     mpe_tpu/ops/fused_update.py::_update_kernel (fused_ppo_update): for every
//     sample (one (t, agent, env) column of the [T, A, *, N] batch) the forward
//     MLP IN-H-H-(5+KC+1), the analytic clipped-surrogate, entropy and clipped
//     value-loss gradient at the outputs (fused_update.py:21-23), the comm
//     factor's softmax, log-prob and entropy masked by the agent's speak flag,
//     the backward pass through both tanh layers, and the weight-gradient and
//     metric sums.
// K7  ppo_update_kernel<OW, 5, KC, false, true> (the decentralized actor over the
//     (t, agent, env) samples, the team advantage of (t, env) broadcast to every
//     agent) + ppo_update_kernel<A*OW, 0, 0, true, false> (the centralized
//     critic over the (t, env) samples, on the joint obs of A*OW rows) +
//     update_reduce_kernel  replace  mpe_tpu/ops/fused_update.py::
//     _mappo_update_kernel (fused_mappo_update). pg and entropy are means over
//     [T, A, N], the value loss over [T, N]. The TPU kernel pads the value head
//     to 8 rows (VPAD) for its matrix unit; here it is one output.
// Out: the gradient in the packed layout below and the metric sums.
//
// What bounds them: fp32 operations, H (IN + H + KO) multiply-adds of the
// forward, about as many of the backward and of the weight gradients per
// sample (chip_smoke.py::OPS, a multiply-add counted once), against about 4
// (IN + 5 + C + 4) bytes read per sample.
//
// What the design does about it. The TPU kernels add into one output block
// because their grid runs in order; here CTAs run in parallel, so each CTA of a
// persistent grid (one per SM) keeps its own partial gradient and a second
// kernel sums the partials in a fixed order: the result does not change from
// run to run, and no float atomics are used. A CTA of 256 threads (eight warps)
// strides over tiles of TS = 64 samples and runs each tile's work as CTA-wide
// matrix products on shared-memory operands, every activation stored
// [unit][sample] (rows of TS + 4 floats, so that the rows a quarter-warp reads
// as float4s lie in distinct banks):
//   forward   H1 = tanh(W1 X + b1), H2 = tanh(W2 H1 + b2): each thread a
//             register tile of UM units x US samples (4 x 4 at hidden 64, so
//             that every thread has one at every width), per input UM
//             weights (w1, w2 stored transposed) and US samples;
//             Z = W3 H2 + b3 with four threads per sample;
//   head      one thread per sample: the softmaxes, ratio, clips and value
//             clip at the outputs (the JAX kernel's arithmetic, unfused), G3;
//   backward  GH2 = (W3^T G3) (1 - H2^2), GH1 = (W2^T GH2) (1 - H1^2), the
//             forward's tiles, each written over the activation it scales;
//   gradient  dW3 += G3 H2^T, dW2 += GH2 H1^T, dW1 += GH1 X^T: each thread a
//             block of entries (at hidden 64 4 x 4 of dW2, 4 x ceil(IN/16) of
//             dW1, 1 x KOP/4 of dW3), kept in registers over all the CTA's
//             tiles, fed per four samples by float4s of both operands; the bias
//             sums ride along.
// Every sum of a product runs over its inputs (or, in a gradient, over the
// CTA's samples) in order, with fused multiply-adds (fmaf: the library's
// -fmad=false leaves every other multiply and add, the head's included,
// rounded on its own). The tile's inputs (obs, one-hots, logp_old, adv, ret,
// vold: each row's TS samples contiguous in lanes) are staged by cp.async in
// 16-byte pieces into a second buffer while the current tile computes; a tile
// that runs past the samples (or whose lanes cross a row of the batch) is
// staged element by element, zeros past the end, and its samples past the end
// get G3 = 0, so they add exact zeros. Every head is compiled: the actor passes
// for the nine scenarios' (obs width, comm logits) heads (by_actor_head), the
// critic for their nine joint widths (by_joint_width). Weights, stages and
// tiles sit in dynamic shared memory: two CTAs share an SM (16 warps) where
// two fit, with two stages where those fit too (simple_spread's actor 101 KB);
// simple_world_comm's critic (its w1 alone 52 KB) takes 180 KB with one stage
// and runs one CTA per SM. Tiles of 128 samples and one CTA per SM ran 3-4%
// slower on the H100 (PERF.md §6, PR 9); a tanh of one exp and one reciprocal
// in place of tanhf moved nothing (the products, not the activations, take
// the time).
//
// Hidden 128 and 256 (ppo_update_wide_kernel, WideDims). There neither a
// net's weights (w2 alone 256 KB at 256) nor its weight-gradient sums (dW2
// 256 floats a thread of a 256-thread CTA) fit one SM. What bounds the
// epoch gradient there is its multiply-adds: h (2 IN + 3 h) + 3 h KO a
// sample, 210 k on simple_spread's actor at 256. A first wide kernel ran
// them in fp32 FMA, streamed w1 and w2 from L2 three times a 64-sample tile
// and added each tile's weight gradients into its CTA's partial in device
// memory: 1.1 MB of L2 traffic a tile at 256. Its products took about 85%
// of its time, the partials' read-modify-write 8-11% and the weights' loads
// 6-9% (PERF.md §6, the stage cuts), so 3x faster products alone would
// have left it waiting on L2. The design does two things about it.
//   products  every large product (W1 X, W2 H1, W2^T GH2, dW2, dW1) is
//             3xTF32 on the tensor cores (tf32_mma.cuh: mma.sync m16n8k8
//             tf32 with float32 sums, about 2^-21 relative error a product,
//             where one TF32 product keeps three digits). mma.sync and not
//             wgmma: each warp loads its own fragments, so every operand can
//             sit in shared memory in the orientation the other products
//             left it in, and a CTA's 64 x 64 tiles are too small for
//             wgmma's m64 rows across 8 warps. The small ones (W3 H2, W3^T
//             G3, dW3: KO <= 16 outputs) stay fp32 FMA.
//   traffic   a cluster of CL = H / 64 CTAs (2 at 128, 4 at 256) shares
//             each tile of TS = 64 samples, CTA c owning the units [64 c,
//             64 c + 64) of both hidden layers: its rows of w1 and w2 (64 KB
//             at 256) stay in its shared memory for the whole launch (w1 is
//             read from device memory where it does not fit: the 204-wide
//             critic of simple_world_comm), and its rows of dW1 and dW2 stay
//             in registers across the cluster's tiles (64 floats a thread at
//             256), written once into the cluster's partial at the end. Per
//             tile a CTA computes h1 of its units and writes it into every
//             CTA's H1 tile (distributed shared memory); h2 = tanh(H1 W2^T +
//             b2) of its units; its part of the logits, which every CTA sums
//             in rank order and runs the head on; gh2 of its units; dW2 of
//             its rows from gh2 and H1; GH2 W2 over its units for every
//             column block, each block written into its owner's H1 tile once
//             every CTA has read its H1; gh1 of its units from the parts in
//             rank order; dW1 of its rows. Five cluster barriers a tile
//             (split arrive / wait where work fits between). L2 now sees the
//             batch (each CTA stages the tile's inputs) and one partial a
//             cluster: about 27 KB a 64-sample tile on simple_spread's actor
//             at 256, against 1.1 MB.
// The sums run in a fixed order (the parts in rank order, the partials by
// update_reduce_kernel), so the result does not change from run to run; no
// float atomics; the tensor cores sum dW1, dW2 over one tile at a time
// (add_tile). mpe_update_grid asks the card how many clusters it runs at once
// (cudaOccupancyMaxActiveClusters), one partial each. What still bounds it on
// an H100 (PERF.md §7): each product step splits every operand value once per
// warp that reads it, so the splits and loads pace the tensor cores at two
// warps a scheduler, and the writes into other CTAs take about a sixth of the
// time. Widths 8-64 keep ppo_update_kernel unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

#ifndef MPE_HIDDEN
#define MPE_HIDDEN 64
#endif
constexpr int H = MPE_HIDDEN;    // hidden width (ops/_build.py::HIDDEN_WIDTHS, one library each)
static_assert(H == 8 || H == 16 || H == 32 || H == 64 || H == 128 || H == 256,
              "K6 and K7 take hidden 8, 16, 32, 64, 128 or 256");
constexpr bool WIDE = H > 64;    // hidden 128 and 256: ppo_update_wide_kernel
constexpr int THREADS = 256;     // per CTA
constexpr int TS = 64;           // samples per tile
constexpr int LD = TS + 4;       // a tile row's stride
// unit_product's register tile: UM units x US samples per thread, the UG unit
// groups x SG sample groups covering H x TS with every thread (4 x 4 at hidden
// 64, 2 x 4 at 32, 1 x 4 at 16, 1 x 2 at 8)
constexpr int UM = H >= 16 ? H / 16 : 1, US = H >= 16 ? 4 : 2;
constexpr int UG = H / UM, SG = TS / US;
static_assert(UG * SG == THREADS, "unit_product's tiles cover H x TS with the CTA's threads");
// outer_sum's grid of entries: PM rows x QN columns of threads, each thread
// rows pm + PM i (i < RI) (at hidden 8 the columns past H idle in dW2)
constexpr int PM = H < 16 ? H : 16, QN = THREADS / PM, RI = H / PM, RN2 = (H + QN - 1) / QN;
// dW3's threads: unit g3c = tid % H of output rows k3 + KS r (k3 = tid / H < KS)
constexpr int KS_MAX = THREADS / H;
constexpr size_t SM_SMEM = 233472;   // shared memory of an SM; a CTA takes 1 KB more than it asks

// the packed weights (input) and gradient (output, partials) of an IN-H-H-KO
// MLP: w1 [H,IN], b1 [H], w2 [H,H], b2 [H], w3 [KO,H] (policy rows, then v),
// b3 [KO], then the three metric sums (pg, vloss, entropy);
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

// the dynamic shared memory of weights (s_tile floats) and tiles: `stages`
// stages of stage_rows rows, H1, H2 and kop output rows
__host__ __device__ constexpr size_t update_smem(int s_tile, int stage_rows, int kop, int stages) {
  return sizeof(float) * (s_tile + (size_t)(stages * stage_rows + 2 * H + kop) * LD);
}

__host__ __device__ constexpr bool smem_fits(size_t bytes, int ctas) {
  return ctas * (bytes + 1024) <= SM_SMEM;
}

// One instantiation's widths and stage layout: IN inputs (x rows zero-padded
// to INP), KP policy logits (0: the critic), KC comm logits, a value output
// (HAS_V), the team advantage of (t, env) (TEAM)
template <int IN_, int INP_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct StageDims {
  static constexpr int IN = IN_, INP = INP_, KP = KP_, KC = KC_;
  static constexpr bool HAS_V = HAS_V_, TEAM = TEAM_;
  static constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  static constexpr int KOP = (KO + 7) / 8 * 8;        // output rows, zero-padded
  static constexpr int KS = KOP < KS_MAX ? KOP : KS_MAX, R3 = KOP / KS;   // dW3's split
  // a stage: x rows, then the per-sample inputs of the head
  static constexpr int A_MV = INP, A_CM = A_MV + KP, A_LPO = A_CM + KC, A_ADV = A_LPO + 1;
  static constexpr int A_RET = KP > 0 ? A_ADV + 1 : INP, A_VOLD = A_RET + 1;
  static constexpr int NAUX = (KP > 0 ? KP + KC + 2 : 0) + (HAS_V ? 2 : 0);
  static constexpr int STAGE_ROWS = INP + NAUX;
  static constexpr int IN_ROWS = IN + NAUX;            // rows read from the batch
};

// ... and the shared-memory layout of ppo_update_kernel (hidden 8-64)
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct UpdateDims
    : StageDims<IN_, QN * ((IN_ + QN - 1) / QN), KP_, KC_, HAS_V_, TEAM_> {
  using S = StageDims<IN_, QN * ((IN_ + QN - 1) / QN), KP_, KC_, HAS_V_, TEAM_>;
  using S::IN, S::INP, S::KO, S::KOP, S::STAGE_ROWS;
  static constexpr int RQ = INP / QN;                  // dW1 columns per thread
  // the weights: w2 [H][H], w2t [H][H], w1t [IN][H], w3 [KOP][H], w3t [H][KOP],
  // b1, b2, b3 [KOP]
  static constexpr int S_W2 = 0, S_W2T = S_W2 + H * H, S_W1T = S_W2T + H * H,
                       S_W3 = S_W1T + IN * H, S_W3T = S_W3 + KOP * H, S_B1 = S_W3T + H * KOP,
                       S_B2 = S_B1 + H, S_B3 = S_B2 + H, S_TILE = (S_B3 + KOP + 3) / 4 * 4;
  // two CTAs per SM where they fit, then two stages where they fit
  static constexpr size_t SMEM2 = update_smem(S_TILE, STAGE_ROWS, KOP, 2),
                          SMEM1 = update_smem(S_TILE, STAGE_ROWS, KOP, 1);
  static constexpr int CTAS = smem_fits(SMEM1, 2) ? 2 : 1;
  static constexpr int STAGES = smem_fits(SMEM2, CTAS) ? 2 : 1;
  static constexpr size_t SMEM = STAGES == 2 ? SMEM2 : SMEM1;
  // tile rows after the stages: H1 (then GH1), H2 (then GH2), Z (then G3)
  static constexpr int T_H1 = STAGES * STAGE_ROWS, T_H2 = T_H1 + H, T_G = T_H2 + H;
  static_assert(smem_fits(SMEM, 1), "the weights and one stage must fit in shared memory");
  static_assert(KOP % (THREADS / TS) == 0, "the output rows split over a sample's threads");
};

// ... and that of ppo_update_wide_kernel (hidden 128 and 256): a cluster of
// CL CTAs shares each tile, CTA c owning the UO units [UO c, UO c + UO) of
// both hidden layers, with its rows of w1 and w2 resident
constexpr int UO = 64;           // units a CTA of the wide kernel owns
constexpr int CL = WIDE ? H / UO : 1;   // CTAs a cluster: 2 at 128, 4 at 256
constexpr int WLD = H + 4;       // a row of the w2 rows and of the H1 tile (4 mod 32 floats)
// the first stride from k that is 8 mod 32 floats (w1's rows, read as float2s)
__host__ __device__ constexpr int stride8(int k) { return k + ((40 - k % 32) % 32); }
template <int IN_, int KP_, int KC_, bool HAS_V_, bool TEAM_>
struct WideDims : StageDims<IN_, (IN_ + 7) / 8 * 8, KP_, KC_, HAS_V_, TEAM_> {
  using S = StageDims<IN_, (IN_ + 7) / 8 * 8, KP_, KC_, HAS_V_, TEAM_>;
  using S::INP, S::KOP, S::STAGE_ROWS;
  static constexpr int W1LD = stride8(INP);
  // floats: the CTA's w2 rows [UO][WLD]; its w1 rows [UO][W1LD] where they fit
  // (W1_RES; else read from device memory: simple_world_comm's 204-wide
  // critic); its w3 columns [KOP][UO]; b1, b2 of its units, b3; the H1 tile
  // [TS][WLD] (sample-major: every unit, pushed by the cluster's CTAs; then
  // the GH1 parts [CL][TS][UO] the others push); the own-unit tiles [UO][LD]
  // H2 (then GH1) and GH2 (the logit parts [CL][KOP][LD] the others push
  // before it is written); the logits, then G3 [KOP][LD]; the stages
  static constexpr int F_W2 = 0, F_W1 = UO * WLD;
  static constexpr size_t BASE = (size_t)F_W1 + KOP * UO + 2 * UO + KOP +
                                 (size_t)TS * WLD + (2 * UO + KOP) * LD;
  static constexpr bool W1_RES = smem_fits(sizeof(float) * (BASE + UO * W1LD + STAGE_ROWS * LD), 1);
  static constexpr int F_W3 = F_W1 + (W1_RES ? UO * W1LD : 0), F_B1 = F_W3 + KOP * UO,
                       F_B2 = F_B1 + UO, F_B3 = F_B2 + UO, F_H1 = (F_B3 + KOP + 3) / 4 * 4,
                       F_H2 = F_H1 + TS * WLD, F_GH2 = F_H2 + UO * LD, F_G = F_GH2 + UO * LD,
                       F_ST = F_G + KOP * LD;
  static constexpr size_t SMEM2 = sizeof(float) * ((size_t)F_ST + 2 * STAGE_ROWS * LD),
                          SMEM1 = sizeof(float) * ((size_t)F_ST + STAGE_ROWS * LD);
  static constexpr int STAGES = smem_fits(SMEM2, 1) ? 2 : 1;
  static constexpr size_t SMEM = STAGES == 2 ? SMEM2 : SMEM1;
  static_assert(smem_fits(SMEM, 1), "the weights, the tiles and one stage must fit an SM");
  static_assert(CL * KOP <= UO, "the logit parts fit the GH2 tile");
  static_assert(!WIDE || CL * TS * UO <= TS * WLD, "the GH1 parts fit the H1 tile");
  static_assert(!WIDE || (2 * 4 + 3) * THREADS <= TS * WLD, "the closing sums fit the H1 tile");
  static_assert(KOP % (THREADS / UO) == 0, "dW3's rows split over the CTA");
};
static_assert(!WIDE || (H % UO == 0 && CL <= 8 && THREADS == 256 && TS == 64),
              "the wide kernel's warp tiles cover 64 samples x 64 units with 8 warps");

struct UpdateConsts {
  float ratio_lo, ratio_hi;      // 1 - clip, 1 + clip
  float vclip;                   // clip of the value change
  float vf_scale;                // vf_coef * 2 / B_v
  float ent_scale;               // ent_coef / B
  float inv_b;                   // 1 / B, B = T * A * N
  int n_agents;                  // A: the agent of row (t, i) and the team advantage's index
  int speak_mask;                // bit i: agent i speaks (its comm factor counts)
};

// ---- staging: cp.async where the card has it --------------------------------

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

// wait until at most `pending` of this thread's committed stages are in flight
template <int pending>
__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

struct Batch {
  const float *obs, *mvoh, *cmoh, *lpo, *adv, *ret, *vold;
};

// row r of the tile's inputs (r < IN: obs row r; then the head's rows in the
// stage's order) at batch row ta: a pointer to its lane 0
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

// the stage row of input row r (x rows first, then the head's after the padding)
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

// ---- the products ------------------------------------------------------------

// n consecutive floats from shared memory (16-, 8- or 4-byte aligned)
template <int n>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[n]) {
  if constexpr (n == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (n == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = p[i];
  }
}

// C[m][s] = epi(m, sum_k A[k][m] B[k][s], &C[m][s]) for the H units m and the
// TS samples s: A [K][H] (units contiguous), B and C [.][LD]. Thread t owns
// units UM mi .. UM mi + UM - 1, mi = t / SG, and samples US si .. US si + US
// - 1, si = t % SG: per input UM floats of A (a warp reads one or two runs)
// and US of B for UM x US multiply-adds
template <int K, class Epi>
__device__ __forceinline__ void unit_product(const float* __restrict__ A,
                                             const float* __restrict__ B, float* __restrict__ C,
                                             int tid, Epi epi) {
  const int m0 = UM * (tid / SG), s0 = US * (tid % SG);
  float acc[UM][US];
#pragma unroll
  for (int i = 0; i < UM; ++i)
#pragma unroll
    for (int e = 0; e < US; ++e) acc[i][e] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[UM], bv[US];
    load_vec<UM>(A + k * H + m0, av);
    load_vec<US>(B + k * LD + s0, bv);
#pragma unroll
    for (int i = 0; i < UM; ++i)
#pragma unroll
      for (int e = 0; e < US; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
  }
#pragma unroll
  for (int i = 0; i < UM; ++i) {
    float* c = C + (m0 + i) * LD + s0;
    float out[US];
#pragma unroll
    for (int e = 0; e < US; ++e) out[e] = epi(m0 + i, acc[i][e], c + e);
#pragma unroll
    for (int e = 0; e < US; ++e) c[e] = out[e];
  }
}

// acc[i][j] += sum_s P[rp(i)][s] Q[rq(j)][s] over the tile, s in order, rows
// rp(i) = pm + PM i (i < RI) of P and rq(j) = qn + QN j (j < RN) of Q, both
// [.][LD] (a row of Q at or past nq reads row nq - 1 and is not stored); the
// bias sum of P's row pm + PM qn joins in bias for qn < RI. Per four samples:
// RI + RN float4s for 4 RI RN multiply-adds
template <int RN>
__device__ __forceinline__ void outer_sum(const float* __restrict__ P, const float* __restrict__ Q,
                                          int pm, int qn, int nq, float (&acc)[RI][RN],
                                          float& bias) {
  int rq[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) rq[j] = (qn + QN * j < nq ? qn + QN * j : nq - 1) * LD;
#pragma unroll 2
  for (int s = 0; s < TS; s += 4) {
    float pv[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) load_vec<4>(P + (pm + PM * i) * LD + s, pv[i]);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      float qv[4];
      load_vec<4>(Q + rq[j] + s, qv);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j] = fmaf(pv[i][e], qv[e], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
      if (qn == i) bias = ((bias + pv[i][0]) + pv[i][1]) + pv[i][2] + pv[i][3];
  }
}

// ---- the head: one thread per sample -----------------------------------------

// softmax over z[K0, K0 + K): p, log p, entropy and the log-prob of the one-hot
// rows oh[c * LD + s]
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
// -> the output gradient G3 there; adds the sample's (pg, vloss, entropy) terms
// to ms. A sample past the end gets G3 = 0
template <class D>
__device__ __forceinline__ void head(const float* __restrict__ st, float* __restrict__ gt, int s,
                                     bool valid, size_t ta, const UpdateConsts& k,
                                     float (&ms)[3]) {
  constexpr int KO = D::KO, KP = D::KP, KC = D::KC;
  float z[KO], g3[KO];
#pragma unroll
  for (int c = 0; c < KO; ++c) z[c] = gt[c * LD + s];
  if constexpr (KP > 0) {
    // _policy_logit_grad: the move factor, the comm factor times the speak
    // flag, the ratio, the clipped surrogate; each factor's entropy gradient
    // uses its own entropy
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
    // _value_clip_grad
    const float v = z[KO - 1], vo = st[D::A_VOLD * LD + s], r = st[D::A_RET * LD + s];
    const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
    const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
    // live where the max's first branch wins or the clip does not bind (then vc
    // is v up to rounding; ops/fused_update.py::_value_clip_grad)
    g3[KO - 1] = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
    if (valid) ms[1] = ms[1] + fmaxf(d1, d2);
  }
#pragma unroll
  for (int c = 0; c < KO; ++c) gt[c * LD + s] = valid ? g3[c] : 0.0f;
}

// ---- the kernel --------------------------------------------------------------

// n_rows * n_envs samples: rows are (t, agent) pairs (K6, the K7 actor) or
// time steps (the K7 critic, whose IN = A * OW joint rows are contiguous)
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__global__ void __launch_bounds__(THREADS, (UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>::CTAS))
ppo_update_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                  const float* __restrict__ mvoh, const float* __restrict__ cmoh,
                  const float* __restrict__ lpo, const float* __restrict__ adv,
                  const float* __restrict__ ret, const float* __restrict__ vold,
                  float* __restrict__ partials, int n_rows, int n_envs, UpdateConsts k) {
  using D = UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>;
  constexpr int KO = D::KO, KOP = D::KOP, RQ = D::RQ;
  constexpr Packed L = packed(IN, KO);
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* tile = smem + D::S_TILE;
  float* h1t = tile + D::T_H1 * LD;
  float* h2t = tile + D::T_H2 * LD;
  float* gt = tile + D::T_G * LD;
  const int tid = threadIdx.x;
  const size_t N = (size_t)n_envs;
  const size_t n_samples = (size_t)n_rows * N;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  const Batch b{obs, mvoh, cmoh, lpo, adv, ret, vold};

  if (blockIdx.x < n_tiles) stage_tile<D>(b, tile, blockIdx.x, n_samples, N, k.n_agents, tid);
  stage_commit();
  for (int i = tid; i < H * H; i += THREADS) {
    const float v = weights[L.g_w2 + i];
    w[D::S_W2 + i] = v;
    w[D::S_W2T + (i % H) * H + i / H] = v;
  }
  for (int i = tid; i < H * IN; i += THREADS)          // w1 [H, IN] -> [IN, H]
    w[D::S_W1T + (i % IN) * H + i / IN] = weights[L.g_w1 + i];
  for (int i = tid; i < KOP * H; i += THREADS) {       // w3 [KO, H], rows past KO zero
    const float v = i < KO * H ? weights[L.g_w3 + i] : 0.0f;
    w[D::S_W3 + i] = v;
    w[D::S_W3T + (i % H) * KOP + i / H] = v;
  }
  if (tid < H) {
    w[D::S_B1 + tid] = weights[L.g_b1 + tid];
    w[D::S_B2 + tid] = weights[L.g_b2 + tid];
  }
  if (tid < KOP) w[D::S_B3 + tid] = tid < KO ? weights[L.g_b3 + tid] : 0.0f;
  for (int st = 0; st < D::STAGES; ++st)               // the x rows' padding stays zero
    for (int i = tid; i < (D::INP - IN) * LD; i += THREADS)
      tile[(st * D::STAGE_ROWS + IN) * LD + i] = 0.0f;

  // this thread's gradient entries: dW2 rows pm + PM i, columns qn + QN j; dW1
  // rows pm + PM i, columns qn + QN j (j < RQ); db1, db2 row pm + PM qn (qn <
  // RI); dW3 rows k3 + KS r, column g3c (db3 row k3 + KS g3c, g3c < R3); a
  // warp's 8 rows pm of P lie LD = 4 mod 32 floats apart: distinct banks
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int PW = PM / 8;                           // warps across the rows
  const int pm = (lane & 7) | ((warp % PW) << 3), qn = (lane >> 3) | ((warp / PW) << 2);
  const int g3c = tid % H, k3 = tid / H;
  constexpr int KS = D::KS, R3 = D::R3;
  float a2[RI][RN2], a1[RI][RQ], a3[R3], ab1 = 0.0f, ab2 = 0.0f, ab3 = 0.0f;
  float ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < RN2; ++j) a2[i][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < RQ; ++j) a1[i][j] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R3; ++r) a3[r] = 0.0f;
  const float* b1 = w + D::S_B1;
  const float* b2 = w + D::S_B2;
  const float* b3 = w + D::S_B3;

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
    // forward
    unit_product<IN>(w + D::S_W1T, st, h1t, tid,
                             [&](int m, float v, const float*) { return tanhf(v + b1[m]); });
    __syncthreads();
    unit_product<H>(w + D::S_W2T, h1t, h2t, tid,
                            [&](int m, float v, const float*) { return tanhf(v + b2[m]); });
    __syncthreads();
    {                                                   // Z = W3 H2 + b3
      constexpr int PER = THREADS / TS, RZ = KOP / PER;
      const int s = tid % TS, kz = tid / TS;
      float z[RZ];
#pragma unroll
      for (int r = 0; r < RZ; ++r) z[r] = 0.0f;
#pragma unroll 4
      for (int g = 0; g < H; ++g) {
        const float h = h2t[g * LD + s];
#pragma unroll
        for (int r = 0; r < RZ; ++r) z[r] = fmaf(w[D::S_W3T + g * KOP + kz + PER * r], h, z[r]);
      }
#pragma unroll
      for (int r = 0; r < RZ; ++r) gt[(kz + PER * r) * LD + s] = z[r] + b3[kz + PER * r];
    }
    __syncthreads();
    if (tid < TS) {
      const size_t m = ti * TS + tid;
      head<D>(st, gt, tid, m < n_samples, m / N, k, ms);
    }
    __syncthreads();
    // dW3 += G3 H2^T (db3 beside it), then GH2 over H2
    if (k3 < KS) {
#pragma unroll 2
      for (int s = 0; s < TS; s += 4) {
        const float4 hq = *reinterpret_cast<const float4*>(h2t + g3c * LD + s);
#pragma unroll
        for (int r = 0; r < R3; ++r) {
          const float4 gq = *reinterpret_cast<const float4*>(gt + (k3 + KS * r) * LD + s);
          a3[r] = fmaf(gq.x, hq.x, a3[r]);
          a3[r] = fmaf(gq.y, hq.y, a3[r]);
          a3[r] = fmaf(gq.z, hq.z, a3[r]);
          a3[r] = fmaf(gq.w, hq.w, a3[r]);
          if (g3c == r) ab3 = ((ab3 + gq.x) + gq.y) + gq.z + gq.w;
        }
      }
    }
    __syncthreads();
    unit_product<KO>(w + D::S_W3, gt, h2t, tid, [](int, float v, const float* c) {
      return v * (1.0f - *c * *c);
    });
    __syncthreads();
    // dW2 += GH2 H1^T (db2), then GH1 over H1
    outer_sum<RN2>(h2t, h1t, pm, qn, H, a2, ab2);
    __syncthreads();
    unit_product<H>(w + D::S_W2, h2t, h1t, tid, [](int, float v, const float* c) {
      return v * (1.0f - *c * *c);
    });
    __syncthreads();
    // dW1 += GH1 X^T (db1); the padding rows of X add zeros
    outer_sum<RQ>(h1t, st, pm, qn, D::INP, a1, ab1);
    __syncthreads();                                    // this stage's reads are done
    if constexpr (D::STAGES == 1) {
      if (ti + gridDim.x < n_tiles)
        stage_tile<D>(b, tile, ti + gridDim.x, n_samples, N, k.n_agents, tid);
      stage_commit();
    }
  }

  float* part = partials + (size_t)blockIdx.x * L.ng;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < RN2; ++j)
      if (qn + QN * j < H) part[L.g_w2 + (pm + PM * i) * H + qn + QN * j] = a2[i][j];
#pragma unroll
    for (int j = 0; j < RQ; ++j)
      if (qn + QN * j < IN) part[L.g_w1 + (pm + PM * i) * IN + qn + QN * j] = a1[i][j];
  }
  if (qn < RI) {
    part[L.g_b1 + pm + PM * qn] = ab1;
    part[L.g_b2 + pm + PM * qn] = ab2;
  }
  if (k3 < KS) {
#pragma unroll
    for (int r = 0; r < R3; ++r)
      if (k3 + KS * r < KO) part[L.g_w3 + (k3 + KS * r) * H + g3c] = a3[r];
    if (g3c < R3 && k3 + KS * g3c < KO) part[L.g_b3 + k3 + KS * g3c] = ab3;
  }
  // metric sums over the CTA's threads, in thread order
#pragma unroll
  for (int q = 0; q < 3; ++q) tile[q * THREADS + tid] = ms[q];
  __syncthreads();
  if (tid < 3) {
    float total = 0.0f;
    for (int i = 0; i < THREADS; ++i) total = total + tile[tid * THREADS + i];
    part[L.g_ms + tid] = total;
  }
}

// acc += d: a tile's weight-gradient sums into the CTA's, rounded to nearest.
// The tensor cores' float32 sums do not round to nearest: carried across a
// CTA's 200-400 tiles on an H100 they moved a leaf by up to 1.05e-4 of its
// largest entry, so they run over one tile's samples only
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = acc[i] + d[i];
}

// The same gradient at hidden 128 and 256 (the source note): a cluster of CL
// CTAs (2 at 128, 4 at 256) walks the tiles of TS samples; CTA c of the
// cluster owns the units [UO c, UO c + UO) of both hidden layers, keeps its
// rows of w1 and w2 resident, computes their activations and, over the
// cluster's tiles, their weight-gradient rows in registers, and exchanges
// H1, the logits' parts and the GH1 parts through the cluster's shared
// memory. Every product is 3xTF32 on the tensor cores (tf32_mma.cuh). Warp w
// (lane 4 g + t) takes, of a 64 x 64 tile of the CTA's units, the samples
// ws = 16 (w & 3) and the units wu = 32 (w >> 2) (4 n8 blocks); each CTA
// writes its rows into its cluster's partial, which update_reduce_kernel
// sums as at the other widths: no float atomics, the same result every run.
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 1)
ppo_update_wide_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                       const float* __restrict__ mvoh, const float* __restrict__ cmoh,
                       const float* __restrict__ lpo, const float* __restrict__ adv,
                       const float* __restrict__ ret, const float* __restrict__ vold,
                       float* __restrict__ partials, int n_rows, int n_envs, UpdateConsts k) {
  using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
  constexpr int KO = D::KO, KOP = D::KOP, INP = D::INP, W1LD = D::W1LD;
  constexpr int NB2 = H / 32, NB1 = INP / 8, NH1 = (NB1 + 1) / 2;   // dW2's, dW1's n8 blocks
  constexpr int NC1 = NH1 < 4 ? NH1 : 4;                            // dW1's blocks at a time
  constexpr int KS3 = THREADS / UO, R3 = KOP / KS3;                 // dW3's rows at a time
  constexpr Packed L = packed(IN, KO);
  extern __shared__ __align__(16) float smem[];
  float* const sm = cta_smem(smem);
  float* w2s = sm + D::F_W2;
  float* w1s = sm + D::F_W1;
  float* w3s = sm + D::F_W3;
  float* b1 = sm + D::F_B1;
  float* b2 = sm + D::F_B2;
  float* b3 = sm + D::F_B3;
  float* h1t = sm + D::F_H1;       // [TS][WLD]; the GH1 parts [CL][TS][UO]
  float* h2t = sm + D::F_H2;       // [UO][LD]: H2, then GH1
  float* gh2t = sm + D::F_GH2;     // [UO][LD]; the logit parts [CL][KOP][LD]
  float* gt = sm + D::F_G;         // [KOP][LD]: the logits, then G3
  float* stages = sm + D::F_ST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const unsigned rank = cluster_rank();
  const int u0 = UO * (int)rank;
  const size_t cid = blockIdx.x / CL, n_cl = gridDim.x / CL;
  const size_t N = (size_t)n_envs;
  const size_t n_samples = (size_t)n_rows * N;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  const Batch b{obs, mvoh, cmoh, lpo, adv, ret, vold};
  const int ws = 16 * (warp & 3), wu = 32 * (warp >> 2);

  if (cid < n_tiles) stage_tile<D>(b, stages, cid, n_samples, N, k.n_agents, tid);
  stage_commit();
  for (int i = tid; i < UO * H; i += THREADS) {
    const int u = i / H, j = i - u * H;
    w2s[u * WLD + j] = weights[L.g_w2 + (u0 + u) * H + j];
  }
  if constexpr (D::W1_RES) {
    for (int i = tid; i < UO * INP; i += THREADS) {
      const int u = i / INP, c = i - u * INP;
      w1s[u * W1LD + c] = c < IN ? weights[L.g_w1 + (u0 + u) * IN + c] : 0.0f;
    }
  }
  for (int i = tid; i < KOP * UO; i += THREADS) {      // w3's columns of the CTA's units
    const int o = i / UO, u = i - o * UO;
    w3s[i] = o < KO ? weights[L.g_w3 + o * H + u0 + u] : 0.0f;
  }
  if (tid < UO) {
    b1[tid] = weights[L.g_b1 + u0 + tid];
    b2[tid] = weights[L.g_b2 + u0 + tid];
  }
  if (tid < KOP) b3[tid] = tid < KO ? weights[L.g_b3 + tid] : 0.0f;
  for (int i = tid; i < KOP * LD; i += THREADS) gt[i] = 0.0f;   // G3's padding rows stay zero
  for (int st = 0; st < D::STAGES; ++st)               // the x rows' padding stays zero
    for (int i = tid; i < (INP - IN) * LD; i += THREADS)
      stages[(st * D::STAGE_ROWS + IN) * LD + i] = 0.0f;
  cluster_arrive();                // every CTA of the cluster has started (its first wait)

  // over the cluster's tiles: dW2 rows 32 (warp & 1) .. + 31 of the CTA's units,
  // columns (H / 4) (warp >> 1) ..; dW1 rows ws .., n8 blocks NH1 (warp >> 2) ..;
  // db1, db2 of the lane's columns over its rows; dW3 rows k3 + KS3 r, unit u3
  // (db3 row k3 + KS3 u3, u3 < R3); the metrics of the head's threads
  float a2[2][NB2][4], a1[1][NH1][4], a3[R3], ab1[4][2], ab2[4][2], ab3 = 0.0f;
  float ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < NB2; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) a2[0][nb][i] = a2[1][nb][i] = 0.0f;
#pragma unroll
  for (int nb = 0; nb < NH1; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) a1[0][nb][i] = 0.0f;
#pragma unroll
  for (int r = 0; r < R3; ++r) a3[r] = 0.0f;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) ab1[nb][0] = ab1[nb][1] = ab2[nb][0] = ab2[nb][1] = 0.0f;
  const int u3 = tid % UO, k3 = tid / UO;
  // element i of a warp's n8 block nb: sample ws + g + 8 (i >> 1), unit wu + 8 nb + 2t + (i & 1)
  auto row_of = [&](int i) { return ws + g + 8 * (i >> 1); };
  auto col_of = [&](int nb, int i) { return wu + 8 * nb + 2 * t + (i & 1); };

  int it = 0;
  for (size_t ti = cid; ti < n_tiles; ti += n_cl, ++it) {
    float* st = stages + (D::STAGES == 2 ? (it & 1) : 0) * D::STAGE_ROWS * LD;
    if constexpr (D::STAGES == 2) {                    // the next tile's inputs in flight
      if (ti + n_cl < n_tiles)
        stage_tile<D>(b, stages + ((it + 1) & 1) * D::STAGE_ROWS * LD, ti + n_cl, n_samples, N,
                      k.n_agents, tid);
      stage_commit();
      stage_wait<1>();
    } else {
      stage_wait<0>();
    }
    __syncthreads();
    // h1 = tanh(x W1^T + b1) of the CTA's units (k8 steps' columns 2t, 2t + 1)
    float h1[1][4][4] = {};
    warp_mma3<1, 4, INP / 8, true>(
        [&](int, int ks, float (&a)[4]) {
          const float* x = st + (8 * ks + 2 * t) * LD + ws + g;
          a[0] = x[0];
          a[1] = x[8];
          a[2] = x[LD];
          a[3] = x[LD + 8];
        },
        [&](int ks, int nb, float (&w)[2]) {
          const int u = wu + 8 * nb + g, c = 8 * ks + 2 * t;
          if constexpr (D::W1_RES) {
            const float2 q = *reinterpret_cast<const float2*>(w1s + u * W1LD + c);
            w[0] = q.x;
            w[1] = q.y;
          } else {
            const float* p = weights + L.g_w1 + (size_t)(u0 + u) * IN + c;
            w[0] = c < IN ? p[0] : 0.0f;
            w[1] = c + 1 < IN ? p[1] : 0.0f;
          }
        },
        h1);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) h1[0][nb][i] = tanhf(h1[0][nb][i] + b1[col_of(nb, i)]);
    cluster_wait();                // the others have read the last tile's GH1 parts from H1
    for (unsigned r = 0; r < CL; ++r) {                // H1 of the CTA's units into every CTA's
      float* dst = map_rank(h1t, r);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; i += 2)
          *reinterpret_cast<float2*>(dst + row_of(i) * WLD + u0 + col_of(nb, i)) =
              float2{h1[0][nb][i], h1[0][nb][i + 1]};
    }
    cluster_arrive();
    cluster_wait();                // H1 whole in every CTA
    // h2 = tanh(H1 W2^T + b2) of the CTA's units
    float h2[1][4][4] = {};
    warp_mma3<1, 4, H / 8, true>(
        [&](int, int ks, float (&a)[4]) {
          const float* x = h1t + (ws + g) * WLD + 8 * ks + t;
          a[0] = x[0];
          a[1] = x[8 * WLD];
          a[2] = x[4];
          a[3] = x[8 * WLD + 4];
        },
        [&](int ks, int nb, float (&w)[2]) {
          const float* p = w2s + (wu + 8 * nb + g) * WLD + 8 * ks + t;
          w[0] = p[0];
          w[1] = p[4];
        },
        h2);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h2[0][nb][i] = tanhf(h2[0][nb][i] + b2[col_of(nb, i)]);
        h2t[col_of(nb, i) * LD + row_of(i)] = h2[0][nb][i];
      }
    __syncthreads();
    {                              // the logits' part of the CTA's units, into every CTA
      constexpr int PER = THREADS / TS, RZ = KOP / PER;
      const int s = tid % TS, kz = tid / TS;
      float z[RZ];
#pragma unroll
      for (int r = 0; r < RZ; ++r) z[r] = 0.0f;
#pragma unroll 4
      for (int u = 0; u < UO; ++u) {
        const float h = h2t[u * LD + s];
#pragma unroll
        for (int r = 0; r < RZ; ++r) z[r] = fmaf(w3s[(kz + PER * r) * UO + u], h, z[r]);
      }
      for (unsigned r = 0; r < CL; ++r) {
        float* dst = map_rank(gh2t, r) + rank * KOP * LD;
#pragma unroll
        for (int q = 0; q < RZ; ++q) dst[(kz + PER * q) * LD + s] = z[q];
      }
    }
    cluster_arrive();
    cluster_wait();                // every CTA's logit parts in
    if (tid < TS) {                // the head, a sample a thread, in every CTA of the cluster
#pragma unroll
      for (int o = 0; o < KO; ++o) {
        float z = gh2t[o * LD + tid];
        for (int c = 1; c < CL; ++c) z = z + gh2t[(c * KOP + o) * LD + tid];
        gt[o * LD + tid] = z + b3[o];
      }
      const size_t m = ti * TS + tid;
      head<D>(st, gt, tid, m < n_samples, m / N, k, ms);
    }
    __syncthreads();
    // dW3 += G3 H2^T (db3 beside it) of the CTA's units
#pragma unroll 2
    for (int s = 0; s < TS; s += 4) {
      const float4 hq = *reinterpret_cast<const float4*>(h2t + u3 * LD + s);
#pragma unroll
      for (int r = 0; r < R3; ++r) {
        const float4 gq = *reinterpret_cast<const float4*>(gt + (k3 + KS3 * r) * LD + s);
        a3[r] = fmaf(gq.x, hq.x, a3[r]);
        a3[r] = fmaf(gq.y, hq.y, a3[r]);
        a3[r] = fmaf(gq.z, hq.z, a3[r]);
        a3[r] = fmaf(gq.w, hq.w, a3[r]);
        if (u3 == r) ab3 = ((ab3 + gq.x) + gq.y) + gq.z + gq.w;
      }
    }
    // gh2 = (G3 W3) (1 - h2^2) of the CTA's units, into GH2
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = row_of(i), u = col_of(nb, i);
        float v = 0.0f;
#pragma unroll
        for (int o = 0; o < KO; ++o) v = fmaf(w3s[o * UO + u], gt[o * LD + s], v);
        v = v * (1.0f - h2[0][nb][i] * h2[0][nb][i]);
        ab2[nb][i & 1] = ab2[nb][i & 1] + v;
        gh2t[u * LD + s] = v;      // the logit parts there were read before the head's barrier
      }
    __syncthreads();
    // dW2 += GH2^T H1 over the tile's samples (k8 steps' samples 2t, 2t + 1),
    // half the warp's columns at a time, each tile's sums added to the CTA's
    // (add_tile: the tensor cores' own float32 sums are for a tile's samples)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d[2][NB2 / 2][4] = {};
      warp_mma3<2, NB2 / 2, TS / 8>(
          [&](int mt, int ks, float (&a)[4]) {
            const float* p = gh2t + (32 * (warp & 1) + 16 * mt + g) * LD + 8 * ks + 2 * t;
            a[0] = p[0];
            a[1] = p[8 * LD];
            a[2] = p[1];
            a[3] = p[8 * LD + 1];
          },
          [&](int ks, int nb, float (&x)[2]) {
            const float* p = h1t + (8 * ks + 2 * t) * WLD + (H / 4) * (warp >> 1) +
                             8 * (half * NB2 / 2 + nb) + g;
            x[0] = p[0];
            x[1] = p[WLD];
          },
          d);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < NB2 / 2; ++nb) add_tile(a2[mt][half * NB2 / 2 + nb], d[mt][nb]);
    }
    cluster_arrive();              // this CTA's reads of H1 are done
    // the GH1 parts GH2 W2 over the CTA's units, each CTA's columns into its
    // H1 tile (k8 steps' units 2t, 2t + 1; column j of sample s at j ^ 8 (s & 7))
    for (unsigned r = 0; r < CL; ++r) {
      float p[1][4][4] = {};
      warp_mma3<1, 4, UO / 8, true>(
          [&](int, int ks, float (&a)[4]) {
            const float* q = gh2t + (8 * ks + 2 * t) * LD + ws + g;
            a[0] = q[0];
            a[1] = q[8];
            a[2] = q[LD];
            a[3] = q[LD + 8];
          },
          [&](int ks, int nb, float (&w)[2]) {
            const float* q = w2s + (8 * ks + 2 * t) * WLD + UO * r + wu + 8 * nb + g;
            w[0] = q[0];
            w[1] = q[WLD];
          },
          p);
      if (r == 0) cluster_wait();  // every CTA's reads of its H1 are done
      float* dst = map_rank(h1t, r) + rank * TS * UO;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int s = row_of(i);
          *reinterpret_cast<float2*>(dst + s * UO + (col_of(nb, i) ^ (8 * (s & 7)))) =
              float2{p[0][nb][i], p[0][nb][i + 1]};
        }
    }
    cluster_arrive();
    cluster_wait();                // the GH1 parts of the CTA's units in
    // gh1 = (sum of the parts, in rank order) (1 - h1^2), into the H2 tile
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = row_of(i), u = col_of(nb, i), e = s * UO + (u ^ (8 * (s & 7)));
        float v = h1t[e];
        for (int c = 1; c < CL; ++c) v = v + h1t[c * TS * UO + e];
        v = v * (1.0f - h1[0][nb][i] * h1[0][nb][i]);
        ab1[nb][i & 1] = ab1[nb][i & 1] + v;
        h2t[u * LD + s] = v;
      }
    __syncthreads();
    cluster_arrive();              // this CTA's H1 tile is free for the next tile's H1
    // dW1 += GH1^T X over the tile's samples (the padding rows of X add zeros),
    // NC1 of the warp's column blocks at a time, added as dW2's
#pragma unroll
    for (int c0 = 0; c0 < NH1; c0 += NC1) {
      const int nb0 = NH1 * (warp >> 2) + c0;
      float d[1][NC1][4] = {};
      warp_mma3<1, NC1, TS / 8>(
          [&](int, int ks, float (&a)[4]) {
            const float* p = h2t + (ws + g) * LD + 8 * ks + t;
            a[0] = p[0];
            a[1] = p[8 * LD];
            a[2] = p[4];
            a[3] = p[8 * LD + 4];
          },
          [&](int ks, int nb, float (&x)[2]) {
            const bool in = c0 + nb < NH1 && nb0 + nb < NB1;
            const float* p = st + (in ? 8 * (nb0 + nb) + g : 0) * LD + 8 * ks + t;
            x[0] = in ? p[0] : 0.0f;
            x[1] = in ? p[4] : 0.0f;
          },
          d);
#pragma unroll
      for (int nb = 0; nb < NC1; ++nb)
        if (c0 + nb < NH1) add_tile(a1[0][c0 + nb], d[0][nb]);
    }
    __syncthreads();               // this stage's reads are done
    if constexpr (D::STAGES == 1) {
      if (ti + n_cl < n_tiles)
        stage_tile<D>(b, stages, ti + n_cl, n_samples, N, k.n_agents, tid);
      stage_commit();
    }
  }
  cluster_wait();                  // no CTA of the cluster writes into another from here

  // the cluster's partial: the CTA's rows of dW1, dW2, db1, db2 and columns
  // of dW3; db3 and the metrics from rank 0
  float* part = partials + cid * L.ng;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB2; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = 32 * (warp & 1) + 16 * mt + g + 8 * (i >> 1);
        const int j = (H / 4) * (warp >> 1) + 8 * nb + 2 * t + (i & 1);
        part[L.g_w2 + (u0 + u) * H + j] = a2[mt][nb][i];
      }
#pragma unroll
  for (int nb = 0; nb < NH1; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = ws + g + 8 * (i >> 1), c = 8 * (NH1 * (warp >> 2) + nb) + 2 * t + (i & 1);
      if (c < IN) part[L.g_w1 + (u0 + u) * IN + c] = a1[0][nb][i];
    }
#pragma unroll
  for (int r = 0; r < R3; ++r)
    if (k3 + KS3 * r < KO) part[L.g_w3 + (k3 + KS3 * r) * H + u0 + u3] = a3[r];
  // db1, db2: the lanes' sums over their warp's rows, then over the four
  // warps of each unit block in order; db3 and the metrics over the threads
  float* red = h1t;                // [2][4][UO], then [3][THREADS]
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v1 = ab1[nb][p], v2 = ab2[nb][p];
#pragma unroll
      for (int mask = 4; mask < 32; mask <<= 1) {
        v1 = v1 + __shfl_xor_sync(0xffffffffu, v1, mask);
        v2 = v2 + __shfl_xor_sync(0xffffffffu, v2, mask);
      }
      if (g == 0) {
        red[(warp & 3) * UO + wu + 8 * nb + 2 * t + p] = v1;
        red[(4 + (warp & 3)) * UO + wu + 8 * nb + 2 * t + p] = v2;
      }
    }
#pragma unroll
  for (int q = 0; q < 3; ++q) red[8 * UO + q * THREADS + tid] = ms[q];
  __syncthreads();
  if (tid < 2 * UO) {
    const int which = tid / UO, u = tid % UO;
    float v = red[(4 * which) * UO + u];
    for (int q = 1; q < 4; ++q) v = v + red[(4 * which + q) * UO + u];
    part[(which == 0 ? L.g_b1 : L.g_b2) + u0 + u] = v;
  }
  if (rank == 0) {
    if (u3 < R3 && k3 + KS3 * u3 < KO) part[L.g_b3 + k3 + KS3 * u3] = ab3;
    if (tid < 3) {
      float total = 0.0f;
      for (int i = 0; i < THREADS; ++i) total = total + red[8 * UO + tid * THREADS + i];
      part[L.g_ms + tid] = total;
    }
  }
}

// out[e] = sum over CTAs b = 0, 1, ... of partials[b][e]; the three metric
// sums at the end are scaled to means by ms_scale
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
  cudaError_t err;
  if constexpr (WIDE) {            // n_parts clusters of CL CTAs, a partial each
    using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_wide_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
    if (err != cudaSuccess) return err;
#ifndef __CUDACC__
    host_cluster_size = CL;
#endif
    kernel<<<n_parts * CL, THREADS, D::SMEM, stream>>>(weights, obs, mvoh, cmoh, lpo, adv, ret,
                                                       vold, partials, n_rows, n_envs, k);
  } else {
    using D = UpdateDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)D::SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<n_parts, THREADS, D::SMEM, stream>>>(weights, obs, mvoh, cmoh, lpo, adv, ret, vold,
                                                  partials, n_rows, n_envs, k);
  }
  const int ng = packed(IN, KP + KC + (HAS_V ? 1 : 0)).ng;
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

// the clusters of a wide pass the card runs at once (-1 where it cannot say)
template <int IN, int KP, int KC, bool HAS_V, bool TEAM_ADV>
int wide_clusters() {
  static const int n = [] {
    using D = WideDims<IN, KP, KC, HAS_V, TEAM_ADV>;
    auto kernel = ppo_update_wide_kernel<IN, KP, KC, HAS_V, TEAM_ADV>;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)D::SMEM) != cudaSuccess)
      return -1;
#ifdef __CUDACC__
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CL);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes = D::SMEM;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) != cudaSuccess ||
        clusters < 1)
      return -1;
    return clusters;
#else
    return HOST_SMS / CL;
#endif
  }();
  return n;
}


}  // namespace

extern "C" {

// K6. obs [n_ta, IN, N] (n_ta = T * A), mvoh [n_ta, 5, N], cmoh [n_ta, kc, N]
// (unread for kc = 0); partials: [n_parts, NG] scratch, out: [NG]
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

// K7. Actor pass over the T*A rows of obs [T, A, OW, N] (adv [T, N]), then
// critic pass over the T rows of the joint obs [T, A*OW, N] (ret, vold [T, N]).
// partials: [n_parts, max(NG_a, NG_c)] scratch; out: [NG_a + NG_c], the actor's
// packed gradient (its pg and entropy means, vloss slot 0) then the critic's
// (its vloss mean)
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

// the persistent grid of a pass (0: K6; 1: K7's actor; 2: K7's critic on the
// joint width in): at hidden 128 and 256 the clusters the card runs at once,
// each its own partial (the wrapper's n_parts); 0 at 8-64, where the wrapper
// sets the grid; -1 for a head or width the kernels are not compiled for
int mpe_update_grid(int in, int kc, int pass) {
  int n = 0;
  const cudaError_t err = by_pass(in, kc, pass, [&](auto i, auto p, auto c, auto v, auto team) {
    if constexpr (WIDE)
      n = wide_clusters<decltype(i)::value, decltype(p)::value, decltype(c)::value,
                        decltype(v)::value, decltype(team)::value>();
    return cudaSuccess;
  });
  return err == cudaSuccess ? n : -1;
}

// the packed gradient's length of an in-H-H-ko MLP (ops/fused_update.py::_packed)
int mpe_update_packed_size(int in, int ko) { return packed(in, ko).ng; }

// the dynamic shared memory in bytes of K6's pass (pass 0) or K7's actor pass
// (1) on the head (in, kc), or of K7's critic pass (2) on the joint width in;
// -1 for a head or width the kernels are not compiled for
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

}  // extern "C"

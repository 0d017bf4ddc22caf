// Hopper (sm_90a) kernels of the MADDPG gradient with bf16 products on the
// tensor cores, for the nine scenarios.
//
// K9-bf16  maddpg_target_actions_bf16_kernel<D> + maddpg_td_bf16_kernel<D> +
//          maddpg_update_bf16_kernel<D> + maddpg_reduce_bf16_kernel<D>, D =
//          MaddpgBf16Dims<A, OW, C>, replace
//          mpe_tpu/ops/fused_maddpg_update.py::_maddpg_update_kernel at
//          cd=bfloat16 (fused_maddpg_update(..., compute_dtype=bfloat16)): the
//          function of mpe_maddpg.cu's K9 (first-argmax target actions, TD
//          targets, the critic's forward and backward, the candidates' Q over
//          the (move x comm) grid, the expected-Q and entropy gradient of the
//          actors) with every product taken on bf16 operands, rounded to
//          nearest even, and summed in float32 (JAX's _dot, _dot_tn, _dot_nt):
//          the target actor on s' (the s' rows rounded too), the target critic
//          on (s', a'), the critic's forward, its backward (g3 = 2 inv d
//          rounded as an operand of W3^T g3), its weight gradients, the
//          own-action columns the candidates' base subtracts, the candidates'
//          layers 2-3, the actor's forward, backward and weight gradients. The
//          tanh, 1 - h^2, the candidates' float32 column sums (JAX's dcand), the
//          softmaxes, entropies, first argmaxes, bias and metric sums stay
//          float32 on float32 activations. Out: the gradient in the live nets'
//          layout of the weight buffer and the three metrics, in float32, from
//          the same C entries, weight buffer and layout as mpe_maddpg.cu's
//          (ops/fused_maddpg_update.py::PackedLayout).
//
// What bounds it on the H100: not the products (989 TFLOP/s of bf16 against 67
// of fp32: path d's batch of 1024 samples x 3 agents needs about 3.4 M bf16
// multiply-adds of products, a few microseconds at the tensor cores' rate) but
// the tanh of the four MLPs and of every candidate's two layers on the
// special-function units, and the head's and the epilogues' float32 work
// (chip_smoke.py::maddpg_update_bf16_sample counts them).
//
// What the design does about it. K9's four stages, grid and fixed-order
// reduce are kept: a CTA takes one agent and a tile of TS = 32 samples (grid:
// batch tiles x agents, 96 CTAs at path d's batch on simple_spread), each CTA
// writes its partial gradient and maddpg_reduce_bf16_kernel sums an agent's
// partials over the tiles in order (no float atomics: the same result every
// run). The weights come from the float32 buffer (the master weights and Adam
// stay float32) and are rounded to bf16 as a CTA stages them into shared
// memory, every launch (they change every update), in row-major rows padded so
// that an A fragment's 32 words fall in 32 banks (bf16_mma.cuh): W1, W2, W3,
// and the transposes W2^T, W3^T that the backward passes take. The activations
// stay float32 in the tiles ([unit][sample], LD floats apart) and are rounded
// on the way into each B fragment, so that 1 - h^2 and the head read the
// float32 values JAX reads. Every forward and backward product is
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with warp w owning the
// tile's samples 8w .. 8w + 7 (one n8 column block) and every 16-unit row
// block, so the forward passes, the backward passes and the candidates' loop
// run with __syncwarp only. A weight gradient dW = G X^T takes the tile's 32
// samples as the mma's depth (two k16 steps), its (16 x 8) output tiles dealt
// to the warps in turn. Each dimension below the instruction's tile is padded
// with exact zeros in both operands: the obs widths 4-34 and joint widths
// 9-258 to 16, the 5 + C logits and the critic's one output to 16 rows, hidden
// 8 to 16 units (a padded unit computes tanh(0) = 0). A bias sum runs over the
// tile's samples in order, one thread per unit. A simple kernel that is right:
// ldmatrix, wgmma and TMA are later work.

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

#ifndef MPE_HIDDEN
#define MPE_HIDDEN 64
#endif
constexpr int H = MPE_HIDDEN;    // hidden width: 8, 16, 32 or 64 (ops/_build.py, one library each)
static_assert(H == 8 || H == 16 || H == 32 || H == 64, "the kernels take hidden 8, 16, 32 or 64");
constexpr int HP = H < 16 ? 16 : H;   // hidden units padded to the mma's 16 rows
constexpr int MT = HP / 16;           // unit row blocks
constexpr int THREADS = 128;          // per CTA
constexpr int WARPS = THREADS / 32;
constexpr int TS = 32;                // samples per CTA: 8 per warp
constexpr int LD = TS + 4;            // a float32 tile row's stride
constexpr int MW = 5;                 // move logits
constexpr size_t SMEM_MAX = 232448;   // a CTA's dynamic shared memory on sm_90
static_assert(TS == 8 * WARPS, "each warp owns one n8 block of the tile's samples");
static_assert(TS % 16 == 0, "the weight gradients take the samples as k16 steps");

// the row stride (in bf16) of a weight matrix of k columns: the words of a
// row a multiple of 4 but not of 8 (as mpe_update_bf16.cu's)
constexpr int lda(int k) {
  int w = k / 2;
  while (w % 8 != 4) ++w;
  return 2 * w;
}

constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

}  // namespace

#include "bf16_mma.cuh"

namespace {

// The widths of one scenario's MADDPG nets and replay rows, and the weight
// buffer and gradient layouts: mpe_maddpg.cu's MaddpgDims, which
// ops/fused_maddpg_update.py::PackedLayout mirrors
template <int A_, int OW_, int C_>
struct MaddpgBf16Dims {
  static constexpr int A = A_, OW = OW_, C = C_, K = MW + C_;
  static constexpr int CX = C > 0 ? C : 1;                  // comm choices per move
  static constexpr int NCAND = MW * CX;                     // candidate m * CX + j
  static constexpr int NH = C > 0 ? 2 : 1;                  // heads
  static constexpr int J = A * (OW + K), AO = A * OW, AK = A * K;
  static constexpr int RW = A * (2 * OW + K + 1);           // row [obs | act | rew | obs2]
  static constexpr int R_REW = AO + AK, R_OBS2 = R_REW + A;
  // one actor OW-H-H-K: w1 [H,OW], b1 [H], w2 [H,H], b2 [H], w3 [K,H], b3 [K]
  static constexpr int AW1 = 0, AB1 = H * OW, AW2 = AB1 + H, AB2 = AW2 + H * H, AW3 = AB2 + H,
                       AB3 = AW3 + K * H, NW = AB3 + K, NWP = (NW + 3) / 4 * 4;
  // one critic J-H-H-1: w1 [H,J], b1 [H], w2 [H,H], b2 [H], w3 [1,H], b3 [1]
  static constexpr int CW1 = 0, CB1 = H * J, CW2 = CB1 + H, CB2 = CW2 + H * H, CW3 = CB2 + H,
                       CB3 = CW3 + H, NC = CB3 + 1, NCP = (NC + 3) / 4 * 4;
  // the weight buffer: actors, critics, target actors, target critics, agent-major
  static constexpr int OFF_A = 0, OFF_C = OFF_A + A * NWP, OFF_TA = OFF_C + A * NCP,
                       OFF_TC = OFF_TA + A * NWP, N_WEIGHTS = OFF_TC + A * NCP;
  // an agent's gradient: its actor, its critic, the (critic loss, Q, actor objective) sums
  static constexpr int G_ACTOR = 0, G_CRITIC = NW, G_MS = G_CRITIC + NC, NG = G_MS + 3;
  static constexpr int OWP = pad16(OW), JP = pad16(J);     // inputs padded to the mma's depth
  static constexpr int XP = JP > OWP ? JP : OWP;
};

// the nine scenarios' dims by the scenario id of csrc/scenario_blocks.cuh's
// MPE_SCENARIO_SWITCH (ops/_build.py::SCENARIO_IDS): (agents, obs width, comm logits)
using SpreadDims = MaddpgBf16Dims<3, 18, 0>;
using SimpleDims = MaddpgBf16Dims<1, 4, 0>;
using ReferenceDims = MaddpgBf16Dims<2, 21, 10>;
using SpeakerListenerDims = MaddpgBf16Dims<2, 11, 3>;
using AdversaryDims = MaddpgBf16Dims<3, 10, 0>;
using PushDims = MaddpgBf16Dims<2, 19, 0>;
using CryptoDims = MaddpgBf16Dims<3, 8, 4>;
using TagDims = MaddpgBf16Dims<4, 16, 0>;
using WorldCommDims = MaddpgBf16Dims<6, 34, 4>;

#define MPE_BF16_DIMS_SWITCH(CALL)              \
  switch (scenario) {                           \
    case 0: CALL(SpreadDims);                   \
    case 1: CALL(SimpleDims);                   \
    case 2: CALL(ReferenceDims);                \
    case 3: CALL(SpeakerListenerDims);          \
    case 4: CALL(AdversaryDims);                \
    case 5: CALL(PushDims);                     \
    case 6: CALL(CryptoDims);                   \
    case 7: CALL(TagDims);                      \
    case 8: CALL(WorldCommDims);                \
    default: return (int)cudaErrorInvalidValue; \
  }

// A net NIN-H-H-NOUT (NOUT <= 16) rounded to bf16 in shared memory, in bf16
// elements: W1 [HP][L1] (the inputs padded to NINP), W2 [HP][LH], W3 [16][LH],
// and for a net whose gradient the CTA takes (BWD) W2^T [HP][LH] and W3^T
// [HP][L3]; zeros in every padding row and column
template <int NIN, bool BWD>
struct BNet {
  static constexpr int NINP = pad16(NIN), L1 = lda(NINP), LH = lda(HP), L3 = lda(16);
  static constexpr int W1 = 0, W2 = W1 + HP * L1, W3 = W2 + HP * LH, W2T = W3 + 16 * LH,
                       W3T = W2T + (BWD ? HP * LH : 0), N = W3T + (BWD ? HP * L3 : 0);
};

// its float32 biases: b1 [HP], b2 [HP], b3 [16], zero-padded
constexpr int FB1 = 0, FB2 = HP, FB3 = 2 * HP, FBN = 2 * HP + 16;

// the float32 offset after n bf16 elements, 16-byte aligned
constexpr int after_bf16(int n) { return (n / 2 + 4) / 4 * 4; }

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  const uint32_t u = bits << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

// x rounded to bf16 (round to nearest even), as a float32
__device__ __forceinline__ float round_bf16(float x) { return bf16_value(bf16_bits(x)); }

// dst[e] = value(e) for e < n, the CTA's threads taking e in turn, STAGE
// values read (their global loads in flight) before any is stored
constexpr int STAGE = 8;
template <class T, class F>
__device__ __forceinline__ void stage(T* __restrict__ dst, int n, F value) {
  for (int e0 = threadIdx.x; e0 < n; e0 += STAGE * blockDim.x) {
    float v[STAGE];
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x;
      v[p] = e < n ? value(e) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x;
      if (e < n) {
        if constexpr (sizeof(T) == 2) {
          dst[e] = (T)bf16_bits(v[p]);
        } else {
          dst[e] = v[p];
        }
      }
    }
  }
}

// a net's kernel-layout block of the weight buffer (w1 [H, NIN], b1, w2 [H, H],
// b2, w3 [NOUT, H], b3) into its BNet (rounded) and its biases (float32)
template <int NIN, int NOUT, bool BWD>
__device__ __forceinline__ void stage_net(const float* __restrict__ src, uint16_t* w16,
                                          float* bias) {
  using N = BNet<NIN, BWD>;
  constexpr int E_B1 = H * NIN, E_W2 = E_B1 + H, E_B2 = E_W2 + H * H, E_W3 = E_B2 + H,
                E_B3 = E_W3 + NOUT * H;
  stage(w16 + N::W1, HP * N::L1, [&](int e) {
    const int m = e / N::L1, c = e - m * N::L1;
    return m < H && c < NIN ? src[m * NIN + c] : 0.0f;
  });
  stage(w16 + N::W2, HP * N::LH, [&](int e) {
    const int m = e / N::LH, c = e - m * N::LH;
    return m < H && c < H ? src[E_W2 + m * H + c] : 0.0f;
  });
  stage(w16 + N::W3, 16 * N::LH, [&](int e) {
    const int m = e / N::LH, c = e - m * N::LH;
    return m < NOUT && c < H ? src[E_W3 + m * H + c] : 0.0f;
  });
  if constexpr (BWD) {
    stage(w16 + N::W2T, HP * N::LH, [&](int e) {
      const int m = e / N::LH, c = e - m * N::LH;
      return m < H && c < H ? src[E_W2 + c * H + m] : 0.0f;
    });
    stage(w16 + N::W3T, HP * N::L3, [&](int e) {
      const int m = e / N::L3, c = e - m * N::L3;
      return m < H && c < NOUT ? src[E_W3 + c * H + m] : 0.0f;
    });
  }
  stage(bias, FBN, [&](int e) {
    if (e < FB2) return e < H ? src[E_B1 + e] : 0.0f;
    if (e < FB3) return e - FB2 < H ? src[E_B2 + e - FB2] : 0.0f;
    return e - FB3 < NOUT ? src[E_B3 + e - FB3] : 0.0f;
  });
}

// NR rows of the replay rows [b][rw] from column r0 into tile rows, one
// column per sample (row b0 + s, or b0 past the batch)
template <int NR>
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int rw, int r0, int b0,
                                          int batch, float* dst) {
  for (int e0 = threadIdx.x; e0 < NR * TS; e0 += STAGE * blockDim.x) {
    float v[STAGE];
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x, s = e / NR;
      const int b = b0 + s < batch ? b0 + s : b0;
      v[p] = e < NR * TS ? rows[(size_t)b * rw + r0 + e - s * NR] : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x, s = e / NR;
      if (e < NR * TS) dst[(e - s * NR) * LD + s] = v[p];
    }
  }
}

__device__ __forceinline__ void zero_rows(float* dst, int n_rows) {
  for (int e = threadIdx.x; e < n_rows * LD; e += blockDim.x) dst[e] = 0.0f;
}

// dst[m NIN + n] = sum over the tile's TS samples of P[m][s] Q[n][s] on bf16
// operands (m < NOUT, n < NIN): the (16 x 8) output tiles dealt to the warps
// in turn, the samples the mma's depth
template <int NOUT, int NIN>
__device__ __forceinline__ void outer_store(const float* __restrict__ P, const float* __restrict__ Q,
                                            float* __restrict__ dst, int warp, int lane) {
  constexpr int NC = (NIN + 7) / 8, NTILES = (NOUT + 15) / 16 * NC;
  for (int t = warp; t < NTILES; t += WARPS) {
    const int m0 = 16 * (t / NC), n0 = 8 * (t % NC);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s0 = 0; s0 < TS; s0 += 16) {
      uint32_t a[4], b[2];
      frag_a_cols(P, m0, s0, lane, a);
      frag_b_cols(Q, s0, n0, lane, b);
      mma_bf16(acc, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + (lane >> 2) + 8 * (i >> 1), n = n0 + 2 * (lane & 3) + (i & 1);
      if (m < NOUT && n < NIN) dst[m * NIN + n] = acc[i];
    }
  }
}

// dst[m] = the sum of tile row m over the samples, in order (bias gradients)
template <int NR>
__device__ __forceinline__ void row_sums(const float* __restrict__ T, float* __restrict__ dst) {
  for (int m = threadIdx.x; m < NR; m += blockDim.x) {
    float acc = T[m * LD];
#pragma unroll 8
    for (int s = 1; s < TS; ++s) acc = acc + T[m * LD + s];
    dst[m] = acc;
  }
}

// The warp's 8 samples through a net's first two layers: H1 = tanh(W1 X + b1),
// H2 = tanh(W2 H1 + b2)
template <class N>
__device__ __forceinline__ void torso(const uint16_t* w16, const float* bias, const float* X,
                                      float* H1, float* H2, int n0, int lane) {
  warp_product<MT, N::NINP / 16, N::L1>(w16 + N::W1, X, n0, lane,
                                        [&](int m, int n, float v, int, int) {
    H1[m * LD + n] = tanhf(v + bias[FB1 + m]);
  });
  __syncwarp();
  warp_product<MT, MT, N::LH>(w16 + N::W2, H1, n0, lane, [&](int m, int n, float v, int, int) {
    H2[m * LD + n] = tanhf(v + bias[FB2 + m]);
  });
  __syncwarp();
}

// first max of z[K0, K0 + W)
template <int K0, int W, int KP>
__device__ __forceinline__ int first_argmax(const float (&z)[KP]) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < W; ++c)
    if (z[K0 + c] > z[K0 + best]) best = c;
  return best;
}

// The target-action kernel's shared memory: the target actor (bf16, then its
// biases), then the tiles s' [OWP], h1, h2 [HP], the logits [16]
template <class D>
struct TaLayout {
  using Net = BNet<D::OW, false>;
  static constexpr int F_B = after_bf16(Net::N), F_TILE = F_B + FBN;
  static constexpr int T_X = 0, T_H1 = D::OWP, T_H2 = T_H1 + HP, T_Z = T_H2 + HP, T_N = T_Z + 16;
  static constexpr size_t SMEM = (size_t)(F_TILE + T_N * LD) * sizeof(float);
};

// the TD kernel's: the target critic, then the tiles (s', a') [JP], h1, h2
template <class D>
struct TdLayout {
  using Net = BNet<D::J, false>;
  static constexpr int F_B = after_bf16(Net::N), F_TILE = F_B + FBN;
  static constexpr int T_X = 0, T_H1 = D::JP, T_H2 = T_H1 + HP, T_N = T_H2 + HP;
  static constexpr size_t SMEM = (size_t)(F_TILE + T_N * LD) * sizeof(float);
};

// The gradient kernel's: the agent's critic and actor (bf16, with the
// transposes of their backward passes), their biases, the critic's own-action
// columns of W1 in float32 [K][HP], per-sample y, the candidates' Q [NCAND][TS]
// and the metric terms [3][TS]; then the tiles: the inputs (the joint, later
// the agent's obs) [XP], the candidates' base pre-activation, h1, h2, gh1 (the
// candidates' layer-1 rows), gh2 (their layer-2 rows) [HP] each, the output
// rows [16] (the critic's g3 in row 0; the actor's logits, then its logit
// gradient)
template <class D>
struct GradLayout {
  using CNet = BNet<D::J, true>;
  using ANet = BNet<D::OW, true>;
  static constexpr int S_WC = 0, S_WA = CNet::N, S_END = S_WA + ANet::N;
  static constexpr int F_BC = after_bf16(S_END), F_BA = F_BC + FBN, F_OWN = F_BA + FBN,
                       F_Y = F_OWN + D::K * HP, F_QC = F_Y + TS, F_MS = F_QC + D::NCAND * TS,
                       F_TILE = (F_MS + 3 * TS + 3) / 4 * 4;
  static constexpr int T_X = 0, T_BASE = D::XP, T_H1 = T_BASE + HP, T_H2 = T_H1 + HP,
                       T_GH1 = T_H2 + HP, T_GH2 = T_GH1 + HP, T_G = T_GH2 + HP, T_N = T_G + 16;
  static constexpr size_t SMEM = (size_t)(F_TILE + T_N * LD) * sizeof(float);
};

struct Bf16Consts {
  float gamma;
  float ent_coef;
  float inv;                                // 1 / (A * B)
};

// grid (batch tiles of TS samples, agents): agent i's target actor on s' (its
// rows rounded as the product's operand), the first-argmax move and comm ->
// act2 [A, NH, B]
template <class D>
__global__ void __launch_bounds__(THREADS)
maddpg_target_actions_bf16_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                                  int* __restrict__ act2, int batch) {
  using L = TaLayout<D>;
  using N = typename L::Net;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  float* bias = smem + L::F_B;
  float* tile = smem + L::F_TILE;
  float* X = tile + L::T_X * LD;
  float* H1 = tile + L::T_H1 * LD;
  float* H2 = tile + L::T_H2 * LD;
  float* Z = tile + L::T_Z * LD;
  const int lane = threadIdx.x & 31, n0 = 8 * (threadIdx.x >> 5);
  const int i = blockIdx.y, b0 = blockIdx.x * TS;
  stage_net<D::OW, D::K, false>(weights + D::OFF_TA + i * D::NWP, w16, bias);
  load_rows<D::OW>(rows, D::RW, D::R_OBS2 + i * D::OW, b0, batch, X);
  zero_rows(X + D::OW * LD, D::OWP - D::OW);
  __syncthreads();
  torso<N>(w16, bias, X, H1, H2, n0, lane);
  warp_product<1, MT, N::LH>(w16 + N::W3, H2, n0, lane, [&](int m, int n, float v, int, int) {
    Z[m * LD + n] = v + bias[FB3 + m];
  });
  __syncwarp();
  if (lane < 8) {
    const int s = n0 + lane;
    if (b0 + s < batch) {
      float z[D::K];
#pragma unroll
      for (int c = 0; c < D::K; ++c) z[c] = Z[c * LD + s];
      act2[(i * D::NH) * batch + b0 + s] = first_argmax<0, MW>(z);
      if constexpr (D::C > 0) act2[(i * D::NH + 1) * batch + b0 + s] = first_argmax<MW, D::C>(z);
    }
  }
}

// grid (batch tiles of TS samples, agents): y [A, B] = r_i + gamma Q'_i(s', a')
template <class D>
__global__ void __launch_bounds__(THREADS)
maddpg_td_bf16_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                      const int* __restrict__ act2, float* __restrict__ y, int batch, float gamma) {
  using L = TdLayout<D>;
  using N = typename L::Net;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  float* bias = smem + L::F_B;
  float* tile = smem + L::F_TILE;
  float* X = tile + L::T_X * LD;
  float* H1 = tile + L::T_H1 * LD;
  float* H2 = tile + L::T_H2 * LD;
  const int lane = threadIdx.x & 31, n0 = 8 * (threadIdx.x >> 5);
  const int i = blockIdx.y, b0 = blockIdx.x * TS;
  stage_net<D::J, 1, false>(weights + D::OFF_TC + i * D::NCP, w16, bias);
  load_rows<D::AO>(rows, D::RW, D::R_OBS2, b0, batch, X);
  for (int e = threadIdx.x; e < D::AK * TS; e += THREADS) {   // a': the one-hots of act2
    const int s = e / D::AK, r = e - s * D::AK;
    const int b = b0 + s < batch ? b0 + s : b0;
    const int q = r / D::K, kk = r % D::K;
    const bool hot = kk < MW ? kk == act2[(q * D::NH) * batch + b]
                             : kk - MW == act2[(q * D::NH + 1) * batch + b];
    X[(D::AO + r) * LD + s] = hot ? 1.0f : 0.0f;
  }
  zero_rows(X + D::J * LD, D::JP - D::J);
  __syncthreads();
  torso<N>(w16, bias, X, H1, H2, n0, lane);
  warp_product<1, MT, N::LH>(w16 + N::W3, H2, n0, lane, [&](int m, int n, float v, int, int) {
    if (m == 0 && b0 + n < batch) {
      const float r = rows[(size_t)(b0 + n) * D::RW + D::R_REW + i];
      y[(size_t)i * batch + b0 + n] = r + gamma * (v + bias[FB3]);
    }
  });
}

// _softmax_eps of one head, logits z[K0, K0 + W) (rows LD apart): p, s =
// log(p + 1e-10) + p / (p + 1e-10) -> the entropy -sum p log(p + 1e-10), each
// sum in index order (mpe_maddpg.cu's)
template <int K0, int W, int K>
__device__ __forceinline__ float softmax_eps(const float* z, float (&p)[K], float (&sv)[K]) {
  float zm = 0.0f, sum = 0.0f, ent = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) zm = c == 0 ? z[K0 * LD] : fmaxf(zm, z[(K0 + c) * LD]);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    p[K0 + c] = expf(z[(K0 + c) * LD] - zm);
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

// grid (batch tiles of TS samples, agents), THREADS threads; partials
// [A][tiles][NG]
template <class D>
__global__ void __launch_bounds__(THREADS, 1)
maddpg_update_bf16_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                          const float* __restrict__ y, float* __restrict__ partials, int batch,
                          Bf16Consts k) {
  using L = GradLayout<D>;
  using CN = typename L::CNet;
  using AN = typename L::ANet;
  constexpr int K = D::K, C = D::C, CX = D::CX;
  extern __shared__ __align__(16) float smem[];
  uint16_t* wc = reinterpret_cast<uint16_t*>(smem) + L::S_WC;
  uint16_t* wa = reinterpret_cast<uint16_t*>(smem) + L::S_WA;
  float* bc = smem + L::F_BC;
  float* ba = smem + L::F_BA;
  float* own = smem + L::F_OWN;
  float* ys = smem + L::F_Y;
  float* qc = smem + L::F_QC;
  float* ms = smem + L::F_MS;
  float* tile = smem + L::F_TILE;
  float* X = tile + L::T_X * LD;
  float* BASE = tile + L::T_BASE * LD;
  float* H1 = tile + L::T_H1 * LD;
  float* H2 = tile + L::T_H2 * LD;
  float* GH1 = tile + L::T_GH1 * LD;
  float* GH2 = tile + L::T_GH2 * LD;
  float* G = tile + L::T_G * LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n0 = 8 * warp;
  const int i = blockIdx.y, b0 = blockIdx.x * TS;
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;
  const float* cw = weights + D::OFF_C + i * D::NCP;

  stage_net<D::J, 1, true>(cw, wc, bc);
  stage_net<D::OW, K, true>(weights + D::OFF_A + i * D::NWP, wa, ba);
  stage(own, K * HP, [&](int e) {                   // W1's own-action columns, float32
    const int kk = e / HP, m = e - kk * HP;
    return m < H ? cw[D::CW1 + m * D::J + D::AO + i * K + kk] : 0.0f;
  });
  if (tid < TS) ys[tid] = b0 + tid < batch ? y[(size_t)i * batch + b0 + tid] : 0.0f;
  load_rows<D::J>(rows, D::RW, 0, b0, batch, X);                  // (s, a)
  zero_rows(X + D::J * LD, D::XP - D::J);
  zero_rows(G, 16);
  __syncthreads();

  // ---- critic forward; the candidates' base: pre - the own-action product ----
  warp_product<MT, CN::NINP / 16, CN::L1>(wc + CN::W1, X, n0, lane,
                                          [&](int m, int n, float v, int, int) {
    const float pre = v + bc[FB1 + m];
    H1[m * LD + n] = tanhf(pre);
    const uint16_t* w1 = wc + CN::W1 + m * CN::L1 + D::AO + i * K;
    const float* xa = X + (D::AO + i * K) * LD + n;
    float prod = bf16_value(w1[0]) * round_bf16(xa[0]);
#pragma unroll
    for (int kk = 1; kk < K; ++kk) prod = prod + bf16_value(w1[kk]) * round_bf16(xa[kk * LD]);
    BASE[m * LD + n] = pre - prod;
  });
  __syncwarp();
  warp_product<MT, MT, CN::LH>(wc + CN::W2, H1, n0, lane, [&](int m, int n, float v, int, int) {
    H2[m * LD + n] = tanhf(v + bc[FB2 + m]);
  });
  __syncwarp();
  warp_product<1, MT, CN::LH>(wc + CN::W3, H2, n0, lane, [&](int m, int n, float v, int, int) {
    if (m == 0) {                                   // q and the TD gradient
      const float q = v + bc[FB3];
      const bool valid = b0 + n < batch;
      const float d = valid ? q - ys[n] : 0.0f;
      G[n] = (2.0f * k.inv) * d;
      ms[n] = d * d;
      ms[TS + n] = valid ? q : 0.0f;
    }
  });
  __syncwarp();

  // ---- critic backward: gh2 = (W3^T g3) (1 - h2^2), gh1 = (W2^T gh2) (1 - h1^2) ----
  warp_product<MT, 1, CN::L3>(wc + CN::W3T, G, n0, lane, [&](int m, int n, float v, int, int) {
    const float h = H2[m * LD + n];
    GH2[m * LD + n] = v * (1.0f - h * h);
  });
  __syncwarp();
  warp_product<MT, MT, CN::LH>(wc + CN::W2T, GH2, n0, lane, [&](int m, int n, float v, int, int) {
    const float h = H1[m * LD + n];
    GH1[m * LD + n] = v * (1.0f - h * h);
  });
  __syncthreads();
  float* pc = part + D::G_CRITIC;
  outer_store<H, D::J>(GH1, X, pc + D::CW1, warp, lane);
  outer_store<H, H>(GH2, H1, pc + D::CW2, warp, lane);
  outer_store<1, H>(G, H2, pc + D::CW3, warp, lane);
  row_sums<H>(GH1, pc + D::CB1);
  row_sums<H>(GH2, pc + D::CB2);
  row_sums<1>(G, pc + D::CB3);
  __syncthreads();

  // ---- the candidates' Q, the warp's samples: candidate c = m CX + j, h1 =
  // tanh(base + (w1[:, own move m] + w1[:, own comm j])) in rows GH1, h2 in GH2 ----
  for (int c = 0; c < D::NCAND; ++c) {
    const int mv = c / CX, jc = c - mv * CX;
    for (int e = lane; e < HP * 8; e += 32) {
      const int u = e >> 3, n = n0 + (e & 7);
      const float dc = C > 0 ? own[mv * HP + u] + own[(MW + jc) * HP + u] : own[mv * HP + u];
      GH1[u * LD + n] = tanhf(BASE[u * LD + n] + dc);
    }
    __syncwarp();
    warp_product<MT, MT, CN::LH>(wc + CN::W2, GH1, n0, lane, [&](int m, int n, float v, int, int) {
      GH2[m * LD + n] = tanhf(v + bc[FB2 + m]);
    });
    __syncwarp();
    warp_product<1, MT, CN::LH>(wc + CN::W3, GH2, n0, lane, [&](int m, int n, float v, int, int) {
      if (m == 0) qc[c * TS + n] = v + bc[FB3];
    });
    __syncwarp();
  }

  // ---- actor: forward, expected-Q and entropy gradient, backward ----
  __syncthreads();                                  // the joint's rows are free
  load_rows<D::OW>(rows, D::RW, i * D::OW, b0, batch, X);
  zero_rows(X + D::OW * LD, D::OWP - D::OW);
  __syncthreads();
  torso<AN>(wa, ba, X, H1, H2, n0, lane);
  warp_product<1, MT, AN::LH>(wa + AN::W3, H2, n0, lane, [&](int m, int n, float v, int, int) {
    G[m * LD + n] = v + ba[FB3 + m];
  });
  __syncwarp();
  if (lane < 8) {                                   // _softmax_eps per head, E, the gradients
    const int s = n0 + lane;
    const bool valid = b0 + s < batch;
    float p[K], sv[K];
    const float ent = softmax_eps<0, MW, K>(G + s, p, sv) +
                      (C > 0 ? softmax_eps<MW, C, K>(G + s, p, sv) : 0.0f);
    // qbar_m[m] = sum_j pc[j] Q[m CX + j], qbar_c[j] = sum_m pm[m] Q[m CX + j],
    // each from the first term in index order; without comm qbar_m[m] = Q[m]
    const float* q = qc + s;
    float qbar[K], eq = 0.0f, sps_m = 0.0f;
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      float qm = q[(m * CX) * TS];
      if constexpr (C > 0) {
        qm = p[MW] * qm;
#pragma unroll
        for (int j = 1; j < C; ++j) qm = qm + p[MW + j] * q[(m * CX + j) * TS];
      }
      qbar[m] = qm;
      eq = m == 0 ? p[0] * qm : eq + p[m] * qm;
      sps_m = m == 0 ? p[0] * sv[0] : sps_m + p[m] * sv[m];
    }
    float sps_c = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float qj = p[0] * q[j * TS];
#pragma unroll
      for (int m = 1; m < MW; ++m) qj = qj + p[m] * q[(m * CX + j) * TS];
      qbar[MW + j] = qj;
      sps_c = j == 0 ? p[MW] * sv[MW] : sps_c + p[MW + j] * sv[MW + j];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float sps = c < MW ? sps_m : sps_c;
      G[c * LD + s] =
          valid ? (-(p[c] * (qbar[c] - eq)) + (k.ent_coef * p[c]) * (sv[c] - sps)) * k.inv : 0.0f;
    }
    ms[2 * TS + s] = valid ? eq + k.ent_coef * ent : 0.0f;
  }
  __syncwarp();
  warp_product<MT, 1, AN::L3>(wa + AN::W3T, G, n0, lane, [&](int m, int n, float v, int, int) {
    const float h = H2[m * LD + n];
    GH2[m * LD + n] = v * (1.0f - h * h);
  });
  __syncwarp();
  warp_product<MT, MT, AN::LH>(wa + AN::W2T, GH2, n0, lane, [&](int m, int n, float v, int, int) {
    const float h = H1[m * LD + n];
    GH1[m * LD + n] = v * (1.0f - h * h);
  });
  __syncthreads();
  float* pa = part + D::G_ACTOR;
  outer_store<H, D::OW>(GH1, X, pa + D::AW1, warp, lane);
  outer_store<H, H>(GH2, H1, pa + D::AW2, warp, lane);
  outer_store<K, H>(G, H2, pa + D::AW3, warp, lane);
  row_sums<H>(GH1, pa + D::AB1);
  row_sums<H>(GH2, pa + D::AB2);
  row_sums<K>(G, pa + D::AB3);
  if (tid < 3) {                                    // metric sums over the tile's samples, in order
    float total = 0.0f;
    for (int q = 0; q < TS; ++q) total = total + ms[tid * TS + q];
    part[D::G_MS + tid] = total;
  }
}

// The gradient in the parameters' layout, grads [A NWP + A NCP], each entry
// summed over the tiles in order, the padding 0; metrics [3] = (critic loss,
// actor loss, Q mean): each term summed over an agent's tiles, the agents in
// order, times inv, the actor objective negated (mpe_maddpg.cu's reduce)
template <class D>
__global__ void maddpg_reduce_bf16_kernel(const float* __restrict__ partials,
                                          float* __restrict__ grads, float* __restrict__ metrics,
                                          int n_tiles, float inv) {
  constexpr int NA = D::A * D::NWP, NT = NA + D::A * D::NCP;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < NT) {
    int a, e;
    if (idx < NA) {
      a = idx / D::NWP;
      e = idx - a * D::NWP;
      e = e < D::NW ? D::G_ACTOR + e : -1;
    } else {
      a = (idx - NA) / D::NCP;
      e = idx - NA - a * D::NCP;
      e = e < D::NC ? D::G_CRITIC + e : -1;
    }
    float total = 0.0f;
    if (e >= 0) {
      const float* p = partials + (size_t)a * n_tiles * D::NG + e;
      for (int t = 0; t < n_tiles; ++t) total = total + p[(size_t)t * D::NG];
    }
    grads[idx] = total;
  } else if (idx < NT + 3) {
    const int m = idx - NT, term = m == 0 ? 0 : m == 1 ? 2 : 1;
    float sum = 0.0f;
    for (int a = 0; a < D::A; ++a) {
      float ta = 0.0f;
      const float* p = partials + (size_t)a * n_tiles * D::NG + D::G_MS + term;
      for (int t = 0; t < n_tiles; ++t) ta = ta + p[(size_t)t * D::NG];
      sum = a == 0 ? ta : sum + ta;
    }
    metrics[m] = m == 1 ? -sum * inv : sum * inv;
  }
}

template <class D>
int launch_update(const float* weights, const float* rows, int* act2, float* y, float* partials,
                  float* grads, float* metrics, int batch, float gamma, float ent_coef, float inv,
                  cudaStream_t stream) {
  static_assert(GradLayout<D>::SMEM <= SMEM_MAX && TdLayout<D>::SMEM <= SMEM_MAX &&
                    TaLayout<D>::SMEM <= SMEM_MAX,
                "a K9-bf16 CTA exceeds the shared memory of an SM");
  static_assert(D::OFF_C % 4 == 0 && D::NWP % 4 == 0 && D::NCP % 4 == 0,
                "the nets' blocks stay 16-byte aligned");
  if (batch < 1) return (int)cudaErrorInvalidValue;
  // once per instantiation: the attributes hold for the process
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(maddpg_target_actions_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TaLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(maddpg_td_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TdLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_update_bf16_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)GradLayout<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int n_tiles = (batch + TS - 1) / TS;
  const dim3 grid(n_tiles, D::A);
  maddpg_target_actions_bf16_kernel<D><<<grid, THREADS, TaLayout<D>::SMEM, stream>>>(
      weights, rows, act2, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_td_bf16_kernel<D><<<grid, THREADS, TdLayout<D>::SMEM, stream>>>(weights, rows, act2, y,
                                                                          batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Bf16Consts k{gamma, ent_coef, inv};
  maddpg_update_bf16_kernel<D><<<grid, THREADS, GradLayout<D>::SMEM, stream>>>(
      weights, rows, y, partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int n_out = D::A * (D::NWP + D::NCP) + 3;
  maddpg_reduce_bf16_kernel<D><<<(n_out + 255) / 256, 256, 0, stream>>>(partials, grads, metrics,
                                                                        n_tiles, inv);
  return (int)cudaGetLastError();
}

// the layout constants the wrapper mirrors: 0 actor stride, 1 critic stride,
// 2 weights, 3 gradient per agent, 4 samples per tile
template <class D>
int layout(int which) {
  const int v[5] = {D::NWP, D::NCP, D::N_WEIGHTS, D::NG, TS};
  return (which >= 0 && which < 5) ? v[which] : -1;
}

}  // namespace

extern "C" {

// K9-bf16: mpe_maddpg.cu's mpe_maddpg_update, the same arguments and layout
// (weights [N_WEIGHTS] float32; rows [batch, RW]; act2 [A, NH, batch] and y
// [A, batch] scratch; partials [A, tiles, NG] scratch, tiles of TS samples;
// grads [A NWP + A NCP] and metrics [3] out)
int mpe_maddpg_update(int scenario, const float* weights, const float* rows, int* act2, float* y,
                      float* partials, float* grads, float* metrics, int batch, float gamma,
                      float ent_coef, float inv, cudaStream_t stream) {
#define MPE_MADDPG_BF16_UPDATE(D)                                                          \
  return launch_update<D>(weights, rows, act2, y, partials, grads, metrics, batch, gamma, \
                          ent_coef, inv, stream)
  MPE_BF16_DIMS_SWITCH(MPE_MADDPG_BF16_UPDATE)
#undef MPE_MADDPG_BF16_UPDATE
}

int mpe_maddpg_update_layout(int scenario, int which) {
#define MPE_MADDPG_BF16_LAYOUT(D) return layout<D>(which)
  MPE_BF16_DIMS_SWITCH(MPE_MADDPG_BF16_LAYOUT)
#undef MPE_MADDPG_BF16_LAYOUT
}

}  // extern "C"

// Hopper (sm_90a) kernels of the MADDPG gradient with bf16 products on the
// tensor cores, for the nine scenarios.
//
// K9-bf16  maddpg_round_bf16_kernel<D> + maddpg_target_td_bf16_kernel<D> +
//          maddpg_grad_bf16_kernel<D> + maddpg_reduce_bf16_kernel<D>, D =
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
//          rounded as an operand of g3 W3), its weight gradients, the
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
// (chip_smoke.py::maddpg_update_bf16_sample counts them). A first design was
// latency-bound far above that: 96 CTAs of 4 warps at path d's batch, one an
// SM by their ~135 KB of shared memory; each CTA rounded and staged its nets
// (W2^T and W3^T as copies of their own) one scalar at a time before its first
// product; every layer's float32 activations made a round trip through shared
// memory into the next product's fragments; the candidates ran as a dependent
// chain on each warp's 8 samples.
//
// What the design does about it.
//   round     maddpg_round_bf16_kernel rounds the four nets' blocks of the
//             float32 weight buffer (master weights and Adam stay float32) into
//             a bf16 scratch once an update, as row-major rows padded against
//             bank conflicts (BNet, Scratch); the other kernels' CTAs copy their
//             nets in by 16-byte cp.async. No transposed copies: a backward
//             product reads W by ldmatrix.trans.
//   products  sample-major (bf16_mma.cuh): a CTA's 16 samples are the M side
//             of every mma.sync m16n8k16, the weights the B side by ldmatrix,
//             the activations chained in registers from one layer's
//             accumulators to the next layer's A fragments; x's fragments by
//             ldmatrix from the tile's bf16 rows. A weight gradient takes both
//             operands from bf16 sample-major rows written once, by
//             ldmatrix.trans, its (16 x 8) tiles dealt to the warps.
//   target    maddpg_target_td_bf16_kernel: grid (batch / 16, agents), 4 warps;
//             the warps deal the agents' target actors, write the first-argmax
//             actions (the agent-0 CTAs to act2) as one-hots into the tile's
//             (s', a') rows, then warp 0 runs agent i's target critic: y.
//   gradient  maddpg_grad_bf16_kernel: grid (batch / 16, agents), 8 warps, two
//             CTAs an SM (path d: 192 CTAs on the 132 SMs). Phase 1: warp 0 the
//             critic's first layer, warp 1 the actor's forward, warps 2-7 the
//             own-action product (the candidates' base is the first layer's
//             pre-activation minus it). Phase 2: warp 0 the critic's second
//             and third layers and backward; warps 1-7 deal the candidates
//             (each an independent chain of its own). Phase 3: warp 1 the
//             actor's head and backward, warps 0, 2-7 the critic's
//             weight-gradient tiles. Phase 4: the actor's weight-gradient
//             tiles on all 8 warps. Each CTA writes its partial gradient, and
//             maddpg_reduce_bf16_kernel sums an agent's partials over the tiles
//             in order (no float atomics: the same result every run).
//   staging   each kernel's inputs in one pass, 16 global loads in flight a
//             thread (stage_parts).
// What still bounds it: each gradient phase issues the tanh's instructions of
// 3-4 warps on each scheduler, so the phases, not the products, set a CTA's
// span; the reduce sums 64 partials an agent at path d's batch.
// Each dimension below the instruction's tile is padded with exact zeros in
// both operands: the obs widths 4-34 and joint widths 9-258 to 16, the 5 + C
// logits and the critic's one output to 8 or 16, hidden 8 to 16 units (a
// padded unit computes tanh(0) = 0). A bias sum runs over the tile's samples
// in order, one lane per unit.
//
// Hidden 128 and 256 (JAX's one-agent-a-group branch there, gsz = 1): the
// design above does not fit. The live critic and actor as bf16 rows are 344
// KB at 256 on simple_spread (the critic's 69 inputs padded to 80), past a
// CTA's 227 KB, and at 128 simple_world_comm's 258-wide critic and its actor
// leave no room for the tiles; the target kernel's A target actors are six of
// 52 KB at 128 there; one partial per 16-sample tile would be 624 KB at 256
// on simple_spread, about 120 MB an update at path d's batch; and a warp
// chaining its 16 samples over all 256 units would hold 128 floats a lane a
// layer. So the wide kernels ("hidden 128 and 256" below) keep the function,
// its arithmetic and the reduce, and take K6-bf16's wide layout
// (bf16_wide.cuh): tiles of 64 samples, 8 warps each owning H / 8 units for
// the whole tile, the weights rounded once a call into a fragment-packed
// scratch and streamed from L2 through each lane's ring, and the gradient on
// a persistent grid whose CTAs add their tiles into one partial each. Five
// launches a call: the rounding pass, the target actions, the TD targets (a
// kernel of their own: every agent's a' must exist before any TD), the
// gradient and the reduce.
//
// Why tiles of 64: every streamed B fragment then feeds 4 m16 row blocks (at
// 32, 2: twice the L2 reads per product), and a tile's read-modify-write of
// the partial is paid per 64 samples, not 32. What it costs: at path d's
// batch of 1024 the grid is 16 CTAs an agent, one tile each (48 CTAs on
// simple_spread's 3 agents, 96 on simple_world_comm's 6, of the 132 SMs; one
// CTA an SM at 256, where the gradient kernel takes 245-252 registers a
// thread), so a CTA's serial chain of phases sets the time, not the card's
// throughput. Measured on an H100 (700 W) at that batch, a copy with tiles of
// 32 took 0.094 / 0.255 ms a call on simple_spread at 128 / 256 (tiles of 64:
// 0.106 / 0.266) but 0.323 / 0.751 on simple_world_comm (0.226 / 0.484),
// whose grid of 22 CTAs an agent then takes some tiles twice.
//
// Their sums over a product's k16 steps (every layer, the candidates' Q, the
// logits) are taken in float32, each step's tensor-core sum started from 0
// and added to the running sum rounded to nearest (bf16_mma.cuh::
// mma_bf16_add): chained through the tensor core's accumulator, each step's
// products were truncated against the running sum, which biased a layer's
// pre-activation by some ulps and, on one trained batch, put actor.l1.w six
// times further from the plain bf16 version than the plain version with its
// sums reversed lies from itself (PERF.md, PR 24).

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
constexpr int H = MPE_HIDDEN;    // hidden width (ops/_build.py::HIDDEN_WIDTHS, one library each)
static_assert(H == 8 || H == 16 || H == 32 || H == 64 || H == 128 || H == 256,
              "the kernels take hidden 8, 16, 32, 64, 128 or 256");
constexpr bool WIDE = H > 64;    // hidden 128 and 256: the wide kernels (below)
constexpr int HP = H < 16 ? 16 : H;          // hidden units padded to the mma's 16
constexpr int NBH = HP / 8, KTH = HP / 16;   // their n8 blocks and k16 steps
constexpr int MT = HP / 16;                  // their row blocks in a weight gradient
constexpr int TS = 16;                       // samples per CTA: the mma's M
constexpr int GRAD_THREADS = 256;            // the gradient kernel's CTA
constexpr int GRAD_WARPS = GRAD_THREADS / 32;
constexpr int TD_THREADS = 128;              // the target-and-TD kernel's CTA
constexpr int TD_WARPS = TD_THREADS / 32;
constexpr int ROUND_THREADS = 256;           // the rounding pass's CTA
constexpr int ROUND_PAIRS = 4;               // its pairs a thread, their loads in flight together
constexpr int REDUCE_CTAS = 264;             // the reduce's grid at most (two an SM), grid-stride
constexpr int MW = 5;                        // move logits
constexpr int ZLD = 17;                      // a row of a float32 logit tile
constexpr int FLD = HP + 4;                  // a row of a float32 activation tile
constexpr size_t SMEM_MAX = 232448;          // a CTA's dynamic shared memory on sm_90
constexpr size_t SM_SMEM = 233472;           // an SM's; a CTA takes 1 KB more than it asks

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

}  // namespace

#include "bf16_mma.cuh"
#include "bf16_wide.cuh"

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

// A net NIN-H-H-NOUT (NOUT <= 16) as bf16 rows, in elements: W1 [HP][L1] (the
// inputs padded to NINP), W2 [HP][LH], W3 [16][LH]; zeros in every padding row
// and column; N a multiple of 8 elements (whole 16-byte pieces)
template <int NIN>
struct BNet {
  static constexpr int NINP = pad16(NIN), L1 = lda(NINP), LH = lda(HP);
  static constexpr int W1 = 0, W2 = W1 + HP * L1, W3 = W2 + HP * LH, N = W3 + 16 * LH;
  static_assert(N % 8 == 0, "a net is whole 16-byte pieces");
};

// The bf16 scratch of one update, in elements: every net of the weight buffer
// in BNet rows, actors, critics, target actors, target critics, agent-major
template <class D>
struct Scratch {
  using AN = BNet<D::OW>;
  using CN = BNet<D::J>;
  static constexpr int A16 = 0, C16 = A16 + D::A * AN::N, TA16 = C16 + D::A * CN::N,
                       TC16 = TA16 + D::A * AN::N, N16 = TC16 + D::A * CN::N;
  static constexpr int PAIRS = N16 / 2;
};

// a net's float32 biases: b1 [HP], b2 [HP], b3 [16], zero-padded
constexpr int FB1 = 0, FB2 = HP, FB3 = 2 * HP, FBN = 2 * HP + 16;

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  const uint32_t u = bits << 16;
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

// entry e of a net's BNet rows from its kernel-layout block src of the weight
// buffer (w1 [H, NIN], b1, w2 [H, H], b2, w3 [NOUT, H], b3)
template <int NIN, int NOUT>
__device__ __forceinline__ float net_entry(const float* __restrict__ src, int e) {
  using N = BNet<NIN>;
  constexpr int E_W2 = H * NIN + H, E_W3 = E_W2 + H * H + H;
  if (e < N::W2) {
    const int m = e / N::L1, c = e - m * N::L1;
    return m < H && c < NIN ? src[m * NIN + c] : 0.0f;
  }
  if (e < N::W3) {
    e -= N::W2;
    const int m = e / N::LH, c = e - m * N::LH;
    return m < H && c < H ? src[E_W2 + m * H + c] : 0.0f;
  }
  e -= N::W3;
  const int m = e / N::LH, c = e - m * N::LH;
  return m < NOUT && c < H ? src[E_W3 + m * H + c] : 0.0f;
}

// the pair of scratch entries e, e + 1 (one net, one row), rounded
template <class D>
__device__ __forceinline__ uint32_t scratch_pair(const float* __restrict__ weights, int e) {
  using S = Scratch<D>;
  using AN = typename S::AN;
  using CN = typename S::CN;
  if (e < S::C16 || (e >= S::TA16 && e < S::TC16)) {         // an actor or a target actor
    const int base = e < S::C16 ? S::A16 : S::TA16, off = e < S::C16 ? D::OFF_A : D::OFF_TA;
    const int q = (e - base) / AN::N, o = e - base - q * AN::N;
    const float* src = weights + off + q * D::NWP;
    return pack_bf16(net_entry<D::OW, D::K>(src, o), net_entry<D::OW, D::K>(src, o + 1));
  }
  const int base = e < S::TA16 ? S::C16 : S::TC16, off = e < S::TA16 ? D::OFF_C : D::OFF_TC;
  const int q = (e - base) / CN::N, o = e - base - q * CN::N;
  const float* src = weights + off + q * D::NCP;
  return pack_bf16(net_entry<D::J, 1>(src, o), net_entry<D::J, 1>(src, o + 1));
}

// The rounding pass: every net of the weight buffer into the bf16 scratch, a
// pair of entries at a time (ROUND_PAIRS a thread, their loads in flight
// together)
template <class D>
__global__ void __launch_bounds__(ROUND_THREADS)
maddpg_round_bf16_kernel(const float* __restrict__ weights, uint16_t* __restrict__ scratch) {
  using S = Scratch<D>;
  const int p0 = blockIdx.x * ROUND_PAIRS * ROUND_THREADS + threadIdx.x;
  uint32_t v[ROUND_PAIRS];
#pragma unroll
  for (int r = 0; r < ROUND_PAIRS; ++r) {
    const int p = p0 + r * ROUND_THREADS;
    v[r] = p < S::PAIRS ? scratch_pair<D>(weights, 2 * p) : 0u;
  }
#pragma unroll
  for (int r = 0; r < ROUND_PAIRS; ++r) {
    const int p = p0 + r * ROUND_THREADS;
    if (p < S::PAIRS) *reinterpret_cast<uint32_t*>(scratch + 2 * p) = v[r];
  }
}

// ---- staging -------------------------------------------------------------------

// n bf16 elements (whole 16-byte pieces) from the scratch into shared memory by
// cp.async, the CTA's threads taking the pieces in turn
__device__ __forceinline__ void copy_async(uint16_t* dst, const uint16_t* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 8 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 8 * i));
#else
    memcpy(dst + 8 * i, src + 8 * i, 16);
#endif
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// One part of a CTA's staging: n entries, entry e read by value(e) (a
// global load) and put(e, v) into shared memory
template <class V, class P>
struct Part {
  int n;
  V value;
  P put;
};

template <class V, class P>
__device__ __forceinline__ Part<V, P> stage_part(int n, V value, P put) {
  return Part<V, P>{n, value, put};
}

__device__ __forceinline__ float part_value(int) { return 0.0f; }

template <class Q, class... Qs>
__device__ __forceinline__ float part_value(int e, const Q& q, const Qs&... qs) {
  if (e < q.n) return q.value(e);
  return part_value(e - q.n, qs...);
}

__device__ __forceinline__ void part_put(int, float) {}

template <class Q, class... Qs>
__device__ __forceinline__ void part_put(int e, float v, const Q& q, const Qs&... qs) {
  if (e < q.n) {
    q.put(e, v);
    return;
  }
  part_put(e - q.n, v, qs...);
}

// every entry of the parts, the CTA's threads taking the entries in turn,
// STAGE values read (their global loads in flight together) before any is
// put: the whole staging in one or two round trips to memory
constexpr int STAGE = 16;
template <class... Qs>
__device__ __forceinline__ void stage_parts(const Qs&... qs) {
  const int n = (qs.n + ...);
  for (int e0 = threadIdx.x; e0 < n; e0 += STAGE * blockDim.x) {
    float v[STAGE];
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x;
      v[p] = e < n ? part_value(e, qs...) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = e0 + p * blockDim.x;
      if (e < n) part_put(e, v[p], qs...);
    }
  }
}

// the float32 biases of the NETS nets NIN-H-H-NOUT whose blocks of the weight
// buffer start stride apart from src, into bias [NETS][FBN]
template <int NIN, int NOUT, int NETS = 1>
__device__ __forceinline__ auto bias_part(const float* __restrict__ src, int stride, float* bias) {
  constexpr int E_B1 = H * NIN, E_B2 = E_B1 + H + H * H, E_B3 = E_B2 + H + NOUT * H;
  return stage_part(NETS * FBN, [=](int e) {
    const int q = e / FBN;
    const float* b = src + q * stride;
    e -= q * FBN;
    if (e < FB2) return e < H ? b[E_B1 + e] : 0.0f;
    if (e < FB3) return e - FB2 < H ? b[E_B2 + e - FB2] : 0.0f;
    return e - FB3 < NOUT ? b[E_B3 + e - FB3] : 0.0f;
  }, [=](int e, float v) { bias[e] = v; });
}

// columns r0 .. r0 + NR of the replay rows [b][rw] of samples b0 .. b0 + NS
// (row b0 past the batch), rounded to bf16, into columns 0 .. NR of the
// sample-major tile T (ld a row)
template <int NR, int NS = TS>
__device__ __forceinline__ auto cols_part(const float* __restrict__ rows, int rw, int r0, int b0,
                                          int batch, uint16_t* T, int ld) {
  return stage_part(NR * NS, [=](int e) {
    const int s = e / NR;
    const int b = b0 + s < batch ? b0 + s : b0;
    return rows[(size_t)b * rw + r0 + e - s * NR];
  }, [=](int e, float v) {
    const int s = e / NR;
    T[s * ld + e - s * NR] = (uint16_t)bf16_bits(v);
  });
}

// zeros in columns c0 .. c1 of the ns rows of the sample-major tile T
__device__ __forceinline__ void zero_cols(uint16_t* T, int ld, int c0, int c1, int ns = TS) {
  for (int e = threadIdx.x; e < ns * (c1 - c0); e += blockDim.x) {
    const int s = e / (c1 - c0);
    T[s * ld + c0 + e - s * (c1 - c0)] = 0;
  }
}

// the warp's copy of columns c0 .. c0 + NR of the sample-major tile X into
// columns 0 .. NR of T, zeros in T's columns NR .. NRP
template <int NR, int NRP>
__device__ __forceinline__ void copy_cols(const uint16_t* X, int ldx, int c0, uint16_t* T, int ld,
                                          int lane) {
  for (int e = lane; e < TS * NRP; e += 32) {
    const int s = e / NRP, c = e - s * NRP;
    T[s * ld + c] = c < NR ? X[s * ldx + c0 + c] : (uint16_t)0;
  }
  __syncwarp();
}

// ---- the warps' products ----------------------------------------------------

// v = tanh(v + b[column]), in place
template <int NB>
__device__ __forceinline__ void bias_tanh(float (&v)[NB][4], const float* b, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[nb][i] = tanhf(v[nb][i] + b[8 * nb + 2 * (lane & 3) + (i & 1)]);
}

// the lane's entries of v into / from the float32 tile T [TS][FLD]
template <int NB>
__device__ __forceinline__ void put_f32(const float (&v)[NB][4], float* T, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(T + ((lane >> 2) + 8 * h) * FLD + 8 * nb + 2 * (lane & 3)) =
          float2{v[nb][2 * h], v[nb][2 * h + 1]};
}

template <int NB>
__device__ __forceinline__ void get_f32(float (&v)[NB][4], const float* T, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = T + ((lane >> 2) + 8 * h) * FLD + 8 * nb + 2 * (lane & 3);
      const float2 x = *reinterpret_cast<const float2*>(p);
      v[nb][2 * h] = x.x;
      v[nb][2 * h + 1] = x.y;
    }
}

// dst[u] = the sum of column u (u < n) of the tile T (ld a row) over its TS
// rows, in order, a lane a column; the warp's writes to T are in first
__device__ __forceinline__ void col_sums(const float* T, int ld, int n, float* dst, int lane) {
  __syncwarp();
  for (int u = lane; u < n; u += 32) {
    float acc = T[u];
#pragma unroll
    for (int r = 1; r < TS; ++r) acc = acc + T[r * ld + u];
    dst[u] = acc;
  }
  __syncwarp();
}

// the forward of a net's first two layers over the sample-major bf16 x tile
// X: h = tanh(tanh(x W1^T + b1) W2^T + b2), its fragments ah; with H1, the
// first layer's h1 also into H1 (bf16) and H1F (float32)
template <class N>
__device__ __forceinline__ void torso(const uint16_t* net, const float* bias, const uint16_t* X,
                                      int ldx, uint16_t* H1, float* H1F, int lane,
                                      float (&h)[NBH][4], uint32_t (&ah)[KTH][4]) {
  warp_dense_f<NBH, N::NINP / 16, false>(
      [&](int kt, uint32_t (&a)[4]) { frag_a_mk(X, ldx, 0, 16 * kt, lane, a); }, net + N::W1,
      N::L1, lane, h);
  bias_tanh(h, bias + FB1, lane);
  pack_a(h, ah);
  if (H1 != nullptr) {
    put_f32(h, H1F, lane);
    store_a(ah, H1, N::LH, 0, lane);
  }
  warp_dense<NBH, KTH, false>(ah, net + N::W2, N::LH, lane, h);
  bias_tanh(h, bias + FB2, lane);
  pack_a(h, ah);
}

// the (16 x 8) tile at (m0, n0) of dst [n_rows][n_cols] (transposed: dst
// [n_cols][n_rows]) = G[s][m0 ..]^T X[s][n0 ..] over the CTA's 16 samples,
// both fragments by ldmatrix.trans; the part outside the matrix not stored
template <bool TRANSPOSED = false>
__device__ __forceinline__ void outer_tile(const uint16_t* G, int ldg, int m0, const uint16_t* X,
                                           int ldx, int n0, int lane, float* __restrict__ dst,
                                           int n_rows, int n_cols) {
  uint32_t a[4], b[2];
  frag_a_km(G, ldg, 0, m0, lane, a);
  frag_b_kn(X, ldx, 0, n0, lane, b);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(acc, a, b);
  store_tile<TRANSPOSED>(dst, n_rows, n_cols, m0, n0, lane, acc);
}

// first max of z[K0, K0 + W)
template <int K0, int W, int KP>
__device__ __forceinline__ int first_argmax(const float (&z)[KP]) {
  int best = 0;
  float top = z[K0];
#pragma unroll
  for (int c = 1; c < W; ++c)
    if (z[K0 + c] > top) {
      best = c;
      top = z[K0 + c];
    }
  return best;
}

struct Bf16Consts {
  float gamma;
  float ent_coef;
  float inv;                                // 1 / (A * B)
};

// ---- target actions and TD targets ------------------------------------------

// Its shared memory: bf16 the agents' target actors [A][AN::N], agent i's
// target critic, the agents' s' tiles [A][TS][LXA], the joint (s', a') tile
// [TS][LXJ]; float32 the biases (actors [A][FBN], the critic [FBN]), the
// warps' logit tiles [TD_WARPS][TS][ZLD]
template <class D>
struct TdLayout {
  using AN = BNet<D::OW>;
  using CN = BNet<D::J>;
  static constexpr int LXA = lda(D::OWP), LXJ = lda(D::JP);
  static constexpr int S_TA = 0, S_TC = S_TA + D::A * AN::N, S_XA = S_TC + CN::N,
                       S_XJ = S_XA + D::A * TS * LXA, S_END = S_XJ + TS * LXJ;
  static constexpr int F_BA = (S_END / 2 + 3) / 4 * 4, F_BC = F_BA + D::A * FBN, F_Z = F_BC + FBN,
                       F_END = F_Z + TD_WARPS * TS * ZLD;
  static constexpr size_t SMEM = (size_t)F_END * sizeof(float);
};

// grid (batch / TS, agents): every agent's target actor on s' (the warps take
// the agents in turn), the first-argmax move and comm -> act2 [A, NH, B] (the
// agent-0 CTAs) and the one-hots of the tile's a'; then agent i's target
// critic on (s', a') -> y [A, B] = r_i + gamma Q'_i(s', a')
template <class D>
__global__ void __launch_bounds__(TD_THREADS)
maddpg_target_td_bf16_kernel(const float* __restrict__ weights,
                             const uint16_t* __restrict__ scratch, const float* __restrict__ rows,
                             int* __restrict__ act2, float* __restrict__ y, int batch,
                             float gamma) {
  using L = TdLayout<D>;
  using S = Scratch<D>;
  using AN = typename L::AN;
  using CN = typename L::CN;
  constexpr int K = D::K, NBO = (K + 7) / 8;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* XJ = w16 + L::S_XJ;
  float* ba = smem + L::F_BA;
  float* bc = smem + L::F_BC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.y, b0 = blockIdx.x * TS;
  copy_async(w16 + L::S_TA, scratch + S::TA16, D::A * AN::N);
  copy_async(w16 + L::S_TC, scratch + S::TC16 + i * CN::N, CN::N);
  stage_parts(bias_part<D::OW, K, D::A>(weights + D::OFF_TA, D::NWP, ba),
              bias_part<D::J, 1>(weights + D::OFF_TC + i * D::NCP, 0, bc),
              cols_part<D::AO>(rows, D::RW, D::R_OBS2, b0, batch, XJ, L::LXJ));   // s'
  zero_cols(XJ, L::LXJ, D::J, D::JP);              // a' fills the columns between
  for (int e = tid; e < TD_WARPS * TS * ZLD; e += TD_THREADS) smem[L::F_Z + e] = 0.0f;
  copy_wait();
  __syncthreads();

  float* zt = smem + L::F_Z + warp * TS * ZLD;
  auto target_actor = [&](int q) {
    const uint16_t* net = w16 + L::S_TA + q * AN::N;
    const float* bq = ba + q * FBN;
    float h[NBH][4], z[NBO][4];
    uint32_t ah[KTH][4];
    uint16_t* xq = w16 + L::S_XA + q * TS * L::LXA;        // agent q's s', from the joint
    copy_cols<D::OW, D::OWP>(XJ, L::LXJ, q * D::OW, xq, L::LXA, lane);
    torso<AN>(net, bq, xq, L::LXA, nullptr, nullptr, lane, h, ah);
    warp_dense<NBO, KTH, false>(ah, net + AN::W3, AN::LH, lane, z);
#pragma unroll
    for (int nb = 0; nb < NBO; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nb + 2 * (lane & 3) + (e & 1);
        zt[((lane >> 2) + 8 * (e >> 1)) * ZLD + c] = z[nb][e] + bq[FB3 + c];
      }
    __syncwarp();
    if (lane < TS) {                                // a sample a lane
      float zz[K];
#pragma unroll
      for (int c = 0; c < K; ++c) zz[c] = zt[lane * ZLD + c];
      const int mv = first_argmax<0, MW>(zz);
      int cm = -1;
      if constexpr (D::C > 0) cm = first_argmax<MW, D::C>(zz);
      if (i == 0 && b0 + lane < batch) {
        act2[(q * D::NH) * batch + b0 + lane] = mv;
        if constexpr (D::C > 0) act2[(q * D::NH + 1) * batch + b0 + lane] = cm;
      }
      uint16_t* xa = XJ + lane * L::LXJ + D::AO + q * K;
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        xa[kk] = (kk < MW ? kk == mv : kk - MW == cm) ? (uint16_t)0x3f80 : (uint16_t)0;  // 1, 0
    }
    __syncwarp();
  };
  if constexpr (D::A <= TD_WARPS) {                 // an agent a warp
    if (warp < D::A) target_actor(warp);
  } else {
    for (int q = warp; q < D::A; q += TD_WARPS) target_actor(q);
  }
  __syncthreads();
  if (warp == 0) {                                  // agent i's target critic
    float h[NBH][4], z[1][4];
    uint32_t ah[KTH][4];
    torso<CN>(w16 + L::S_TC, bc, XJ, L::LXJ, nullptr, nullptr, lane, h, ah);
    warp_dense<1, KTH, false>(ah, w16 + L::S_TC + CN::W3, CN::LH, lane, z);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int b = b0 + (lane >> 2) + 8 * half;
        if (b < batch) {
          const float r = rows[(size_t)b * D::RW + D::R_REW + i];
          y[(size_t)i * batch + b] = r + gamma * (z[0][2 * half] + bc[FB3]);
        }
      }
    }
  }
}

// ---- the gradient -------------------------------------------------------------

// _softmax_eps of one head, logits zr[K0, K0 + W): p, s = log(p + 1e-10) + p
// / (p + 1e-10) -> the entropy -sum p log(p + 1e-10), each sum in index order
// (mpe_maddpg.cu's)
template <int K0, int W, int K>
__device__ __forceinline__ float softmax_eps(const float* zr, float (&p)[K], float (&sv)[K]) {
  float zm = 0.0f, sum = 0.0f, ent = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) zm = c == 0 ? zr[K0] : fmaxf(zm, zr[K0 + c]);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    p[K0 + c] = expf(zr[K0 + c] - zm);
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

// The actor's head of one sample: _softmax_eps per head, then qbar_m[m] =
// sum_j pc[j] Q[m CX + j] and qbar_c[j] = sum_m pm[m] Q[m CX + j] (without
// comm qbar_m[m] = Q[m]), E and the logits' gradient, each sum from the first
// term in index order; q the candidates' Q, QS apart; zr [K] the logits in,
// their gradient out (0 past the batch) -> the sample's actor objective term
// (0 past the batch)
template <class D, int QS>
__device__ __forceinline__ float actor_head(float* zr, const float* q, bool valid,
                                           const Bf16Consts& k) {
  constexpr int K = D::K, C = D::C, CX = D::CX;
  float p[K], sv[K];
  const float ent = softmax_eps<0, MW, K>(zr, p, sv) +
                    (C > 0 ? softmax_eps<MW, C, K>(zr, p, sv) : 0.0f);
  float qbar[K], eq = 0.0f, sps_m = 0.0f;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    float qm = q[(m * CX) * QS];
    if constexpr (C > 0) {
      qm = p[MW] * qm;
#pragma unroll
      for (int j = 1; j < C; ++j) qm = qm + p[MW + j] * q[(m * CX + j) * QS];
    }
    qbar[m] = qm;
    eq = m == 0 ? p[0] * qm : eq + p[m] * qm;
    sps_m = m == 0 ? p[0] * sv[0] : sps_m + p[m] * sv[m];
  }
  float sps_c = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float qj = p[0] * q[j * QS];
#pragma unroll
    for (int m = 1; m < MW; ++m) qj = qj + p[m] * q[(m * CX + j) * QS];
    qbar[MW + j] = qj;
    sps_c = j == 0 ? p[MW] * sv[MW] : sps_c + p[MW + j] * sv[MW + j];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float sps = c < MW ? sps_m : sps_c;
    zr[c] = valid ? (-(p[c] * (qbar[c] - eq)) + (k.ent_coef * p[c]) * (sv[c] - sps)) * k.inv
                  : 0.0f;
  }
  return valid ? eq + k.ent_coef * ent : 0.0f;
}

// Its shared memory. bf16: the agent's critic and actor (BNet), the joint
// (s, a) [TS][LXJ], the agent's obs [TS][LXA], the weight gradients' operands:
// the critic's H1, H2, GH1, GH2 [TS][LH] and G3 [TS][L3], then the actor's.
// float32: the biases (critic, actor) [FBN], the critic's own-action columns
// of W1 [K][HP], y [TS], the critic's g3 [TS], the candidates' Q [NCAND][TS],
// the metric terms [3][TS]; the tiles [TS][FLD]: the critic's first-layer
// pre-activation and its own-action product (the candidates' base is their
// difference), the critic's h1, the actor's h1 and h2, a tile for the bias
// sums; the actor's
// logits (then their gradient) [TS][ZLD]
template <class D>
struct GradLayout {
  using AN = BNet<D::OW>;
  using CN = BNet<D::J>;
  static constexpr int LXA = lda(D::OWP), LXJ = lda(D::JP), LH = lda(HP), L3 = lda(16);
  static constexpr int S_C = 0, S_A = S_C + CN::N, S_XJ = S_A + AN::N, S_XA = S_XJ + TS * LXJ,
                       S_H1C = S_XA + TS * LXA, S_H2C = S_H1C + TS * LH, S_GH1C = S_H2C + TS * LH,
                       S_GH2C = S_GH1C + TS * LH, S_G3C = S_GH2C + TS * LH,
                       S_H1A = S_G3C + TS * L3, S_H2A = S_H1A + TS * LH, S_GH1A = S_H2A + TS * LH,
                       S_GH2A = S_GH1A + TS * LH, S_G3A = S_GH2A + TS * LH,
                       S_END = S_G3A + TS * L3;
  static constexpr int F_BC = (S_END / 2 + 3) / 4 * 4, F_BA = F_BC + FBN, F_OWN = F_BA + FBN,
                       F_Y = F_OWN + D::K * HP, F_G3 = F_Y + TS, F_QC = F_G3 + TS,
                       F_MS = F_QC + D::NCAND * TS, F_BASE = (F_MS + 3 * TS + 3) / 4 * 4,
                       F_PROD = F_BASE + TS * FLD, F_H1C = F_PROD + TS * FLD,
                       F_H1A = F_H1C + TS * FLD,
                       F_H2A = F_H1A + TS * FLD, F_SUM = F_H2A + TS * FLD,
                       F_Z = F_SUM + TS * FLD, F_END = F_Z + TS * ZLD;
  static constexpr size_t SMEM = (size_t)F_END * sizeof(float);
  static constexpr int CTAS = 2 * (SMEM + 1024) <= SM_SMEM ? 2 : 1;
};

// grid (batch / TS, agents), GRAD_THREADS threads; partials [A][tiles][NG]
template <class D>
__global__ void __launch_bounds__(GRAD_THREADS, GradLayout<D>::CTAS)
maddpg_grad_bf16_kernel(const float* __restrict__ weights, const uint16_t* __restrict__ scratch,
                        const float* __restrict__ rows, const float* __restrict__ y,
                        float* __restrict__ partials, int batch, Bf16Consts k) {
  using L = GradLayout<D>;
  using S = Scratch<D>;
  using CN = typename L::CN;
  using AN = typename L::AN;
  constexpr int K = D::K, C = D::C, CX = D::CX, NBO = (K + 7) / 8, LH = L::LH, L3 = L::L3;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  const uint16_t* cn = w16 + L::S_C;
  const uint16_t* an = w16 + L::S_A;
  uint16_t* XJ = w16 + L::S_XJ;
  uint16_t* XA = w16 + L::S_XA;
  uint16_t* H1C = w16 + L::S_H1C;
  uint16_t* H2C = w16 + L::S_H2C;
  uint16_t* GH1C = w16 + L::S_GH1C;
  uint16_t* GH2C = w16 + L::S_GH2C;
  uint16_t* G3C = w16 + L::S_G3C;
  uint16_t* H1A = w16 + L::S_H1A;
  uint16_t* H2A = w16 + L::S_H2A;
  uint16_t* GH1A = w16 + L::S_GH1A;
  uint16_t* GH2A = w16 + L::S_GH2A;
  uint16_t* G3A = w16 + L::S_G3A;
  float* bc = smem + L::F_BC;
  float* ba = smem + L::F_BA;
  float* own = smem + L::F_OWN;
  float* ys = smem + L::F_Y;
  float* g3c = smem + L::F_G3;
  float* qc = smem + L::F_QC;
  float* ms = smem + L::F_MS;
  float* base = smem + L::F_BASE;
  float* own_prod = smem + L::F_PROD;
  float* h1cf = smem + L::F_H1C;
  float* h1af = smem + L::F_H1A;
  float* h2af = smem + L::F_H2A;
  float* sumt = smem + L::F_SUM;
  float* zt = smem + L::F_Z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int i = blockIdx.y, b0 = blockIdx.x * TS;
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;
  float* pc = part + D::G_CRITIC;
  float* pa = part + D::G_ACTOR;
  const float* cw = weights + D::OFF_C + i * D::NCP;

  copy_async(w16 + L::S_C, scratch + S::C16 + i * CN::N, CN::N);
  copy_async(w16 + L::S_A, scratch + S::A16 + i * AN::N, AN::N);
  const auto own_cols = stage_part(                 // W1's own-action columns, float32
      K * HP,
      [=](int e) {
        const int kk = e / HP, m = e - kk * HP;
        return m < H ? cw[D::CW1 + m * D::J + D::AO + i * K + kk] : 0.0f;
      },
      [=](int e, float v) { own[e] = v; });
  const auto y_tile = stage_part(
      TS, [=](int e) { return b0 + e < batch ? y[(size_t)i * batch + b0 + e] : 0.0f; },
      [=](int e, float v) { ys[e] = v; });
  stage_parts(bias_part<D::J, 1>(cw, 0, bc),
              bias_part<D::OW, K>(weights + D::OFF_A + i * D::NWP, 0, ba), own_cols, y_tile,
              cols_part<D::J>(rows, D::RW, 0, b0, batch, XJ, L::LXJ),             // (s, a)
              cols_part<D::OW>(rows, D::RW, i * D::OW, b0, batch, XA, L::LXA));  // its obs
  zero_cols(XJ, L::LXJ, D::J, D::JP);
  zero_cols(XA, L::LXA, D::OW, D::OWP);
  for (int e = tid; e < TS * ZLD; e += GRAD_THREADS) zt[e] = 0.0f;
  copy_wait();
  __syncthreads();

  // ---- phase 1: the critic's first layer (warp 0), the actor's forward (warp
  // 1), the own-action product the candidates' base subtracts (warps 2-7)
  if (warp == 0) {
    float h[NBH][4];
    warp_dense_f<NBH, CN::NINP / 16, false>(
        [&](int kt, uint32_t (&a)[4]) { frag_a_mk(XJ, L::LXJ, 0, 16 * kt, lane, a); },
        cn + CN::W1, CN::L1, lane, h);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nb][e] = h[nb][e] + bc[FB1 + 8 * nb + 2 * t + (e & 1)];
    put_f32(h, base, lane);                          // pre
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nb][e] = tanhf(h[nb][e]);
    put_f32(h, h1cf, lane);
    uint32_t ah[KTH][4];
    pack_a(h, ah);
    store_a(ah, H1C, LH, 0, lane);
  } else if (warp >= 2) {
    // the own-action product on its bf16 operands, which the candidates'
    // base subtracts from pre (warps 2-7, an entry a thread at a time)
    for (int e = tid - 64; e < TS * HP; e += GRAD_THREADS - 64) {
      const int row = e / HP, u = e - row * HP;
      const uint16_t* w1 = cn + CN::W1 + u * CN::L1 + D::AO + i * K;
      const uint16_t* xa = XJ + row * L::LXJ + D::AO + i * K;
      float prod = bf16_value(w1[0]) * bf16_value(xa[0]);
#pragma unroll
      for (int kk = 1; kk < K; ++kk) prod = prod + bf16_value(w1[kk]) * bf16_value(xa[kk]);
      own_prod[row * FLD + u] = prod;
    }
  } else {
    float h[NBH][4], z[NBO][4];
    uint32_t ah[KTH][4];
    torso<AN>(an, ba, XA, L::LXA, H1A, h1af, lane, h, ah);
    put_f32(h, h2af, lane);
    store_a(ah, H2A, LH, 0, lane);
    warp_dense<NBO, KTH, false>(ah, an + AN::W3, LH, lane, z);
#pragma unroll
    for (int nb = 0; nb < NBO; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nb + 2 * t + (e & 1);
        zt[(g + 8 * (e >> 1)) * ZLD + c] = z[nb][e] + ba[FB3 + c];
      }
  }
  __syncthreads();

  // ---- phase 2: the critic's rest and backward (warp 0); the candidates (warps 1-7)
  if (warp == 0) {
    float h2[NBH][4], gh[NBH][4], z[1][4];
    uint32_t ah[KTH][4];
    warp_dense_f<NBH, KTH, false>(
        [&](int kt, uint32_t (&a)[4]) { frag_a_mk(H1C, LH, 0, 16 * kt, lane, a); }, cn + CN::W2,
        LH, lane, h2);
    bias_tanh(h2, bc + FB2, lane);
    pack_a(h2, ah);
    store_a(ah, H2C, LH, 0, lane);
    warp_dense<1, KTH, false>(ah, cn + CN::W3, LH, lane, z);
    // q and the TD gradient g3 = 2 inv (q - y) in column 0 (lanes t = 0)
    uint32_t a3[1][4] = {{0u, 0u, 0u, 0u}};
    if (t == 0) {
      float gv[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        const float q = z[0][2 * half] + bc[FB3];
        const bool valid = b0 + row < batch;
        const float d = valid ? q - ys[row] : 0.0f;
        gv[half] = (2.0f * k.inv) * d;
        g3c[row] = gv[half];
        ms[row] = d * d;
        ms[TS + row] = valid ? q : 0.0f;
      }
      a3[0][0] = pack_bf16(gv[0], 0.0f);
      a3[0][1] = pack_bf16(gv[1], 0.0f);
    }
    store_a(a3, G3C, L3, 0, lane);
    // gh2 = (g3 W3) (1 - h2^2), gh1 = (gh2 W2) (1 - h1^2)
    warp_dense<NBH, 1, true>(a3, cn + CN::W3, LH, lane, gh);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[nb][e] = gh[nb][e] * (1.0f - h2[nb][e] * h2[nb][e]);
    put_f32(gh, sumt, lane);
    col_sums(sumt, FLD, H, pc + D::CB2, lane);
    pack_a(gh, ah);
    store_a(ah, GH2C, LH, 0, lane);
    warp_dense<NBH, KTH, true>(ah, cn + CN::W2, LH, lane, gh);
    get_f32(h2, h1cf, lane);                         // h1, float32
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[nb][e] = gh[nb][e] * (1.0f - h2[nb][e] * h2[nb][e]);
    put_f32(gh, sumt, lane);
    col_sums(sumt, FLD, H, pc + D::CB1, lane);
    col_sums(g3c, 1, 1, pc + D::CB3, lane);
    pack_a(gh, ah);
    store_a(ah, GH1C, LH, 0, lane);
  } else {
    // candidate c = m CX + j: h1 = tanh(base + (w1[:, own move m] + w1[:, own
    // comm j])), h2 = tanh(h1 W2^T + b2), Q = h2 W3^T + b3
    for (int c = warp - 1; c < D::NCAND; c += GRAD_WARPS - 1) {
      const int mv = c / CX, jc = c - mv * CX;
      float h[NBH][4], z[1][4];
      uint32_t ah[KTH][4];
      float prod[NBH][4];
      get_f32(h, base, lane);
      get_f32(prod, own_prod, lane);
#pragma unroll
      for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = 8 * nb + 2 * t + (e & 1);
          const float dc = C > 0 ? own[mv * HP + u] + own[(MW + jc) * HP + u] : own[mv * HP + u];
          h[nb][e] = tanhf((h[nb][e] - prod[nb][e]) + dc);
        }
      pack_a(h, ah);
      warp_dense<NBH, KTH, false>(ah, cn + CN::W2, LH, lane, h);
      bias_tanh(h, bc + FB2, lane);
      pack_a(h, ah);
      warp_dense<1, KTH, false>(ah, cn + CN::W3, LH, lane, z);
      if (t == 0) {
        qc[c * TS + g] = z[0][0] + bc[FB3];
        qc[c * TS + g + 8] = z[0][2] + bc[FB3];
      }
    }
  }
  __syncthreads();

  // ---- phase 3: the actor's head and backward (warp 1); the critic's weight
  // gradients (warps 0, 2-7)
  if (warp == 1) {
    if (lane < TS)                                  // _softmax_eps per head, E, the gradients
      ms[2 * TS + lane] = actor_head<D, TS>(zt + lane * ZLD, qc + lane, b0 + lane < batch, k);
    col_sums(zt, ZLD, K, pa + D::AB3, lane);
    // the logit gradient g3 from the tile (zeros past K), rounded
    uint32_t a3[1][4];
    {
      const float* r0 = zt + g * ZLD + 2 * t;
      const float* r1 = r0 + 8 * ZLD;
      a3[0][0] = pack_bf16(r0[0], r0[1]);
      a3[0][1] = pack_bf16(r1[0], r1[1]);
      a3[0][2] = pack_bf16(r0[8], r0[9]);
      a3[0][3] = pack_bf16(r1[8], r1[9]);
    }
    store_a(a3, G3A, L3, 0, lane);
    float gh[NBH][4], hf[NBH][4];
    uint32_t ah[KTH][4];
    warp_dense<NBH, 1, true>(a3, an + AN::W3, LH, lane, gh);
    get_f32(hf, h2af, lane);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[nb][e] = gh[nb][e] * (1.0f - hf[nb][e] * hf[nb][e]);
    put_f32(gh, sumt, lane);
    col_sums(sumt, FLD, H, pa + D::AB2, lane);
    pack_a(gh, ah);
    store_a(ah, GH2A, LH, 0, lane);
    warp_dense<NBH, KTH, true>(ah, an + AN::W2, LH, lane, gh);
    get_f32(hf, h1af, lane);
#pragma unroll
    for (int nb = 0; nb < NBH; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) gh[nb][e] = gh[nb][e] * (1.0f - hf[nb][e] * hf[nb][e]);
    put_f32(gh, sumt, lane);
    col_sums(sumt, FLD, H, pa + D::AB1, lane);
    pack_a(gh, ah);
    store_a(ah, GH1A, LH, 0, lane);
  } else {
    // dW1 = GH1^T (s, a), dW2 = GH2^T H1, dW3^T = H2^T G3 over the 16
    // samples, a (16 x 8) tile a turn
    constexpr int NC1 = pad8(D::J) / 8, T1 = MT * NC1, T2 = T1 + MT * (H / 8), T3 = T2 + MT;
    for (int tt = warp == 0 ? 0 : warp - 1; tt < T3; tt += GRAD_WARPS - 1) {
      if (tt < T1) {
        outer_tile(GH1C, LH, 16 * (tt / NC1), XJ, L::LXJ, 8 * (tt % NC1), lane, pc + D::CW1, H,
                   D::J);
      } else if (tt < T2) {
        outer_tile(GH2C, LH, 16 * ((tt - T1) / (H / 8)), H1C, LH, 8 * ((tt - T1) % (H / 8)), lane,
                   pc + D::CW2, H, H);
      } else {
        outer_tile<true>(H2C, LH, 16 * (tt - T2), G3C, L3, 0, lane, pc + D::CW3, H, 1);
      }
    }
  }
  __syncthreads();

  // ---- phase 4: the actor's weight gradients on every warp; the metric sums
  {
    constexpr int NC1 = pad8(D::OW) / 8, T1 = MT * NC1, T2 = T1 + MT * (H / 8),
                  T3 = T2 + MT * NBO;
    for (int tt = warp; tt < T3; tt += GRAD_WARPS) {
      if (tt < T1) {
        outer_tile(GH1A, LH, 16 * (tt / NC1), XA, L::LXA, 8 * (tt % NC1), lane, pa + D::AW1, H,
                   D::OW);
      } else if (tt < T2) {
        outer_tile(GH2A, LH, 16 * ((tt - T1) / (H / 8)), H1A, LH, 8 * ((tt - T1) % (H / 8)), lane,
                   pa + D::AW2, H, H);
      } else {
        outer_tile<true>(H2A, LH, 16 * ((tt - T2) / NBO), G3A, L3, 8 * ((tt - T2) % NBO), lane,
                         pa + D::AW3, H, K);
      }
    }
  }
  if (tid < 3) {                                    // metric sums over the tile's samples, in order
    float total = 0.0f;
    for (int q = 0; q < TS; ++q) total = total + ms[tid * TS + q];
    part[D::G_MS + tid] = total;
  }
}

// The gradient in the parameters' layout, grads [A NWP + A NCP], each entry
// summed over the tiles in order (16 loads in flight), the padding 0; metrics
// [3] = (critic loss, actor loss, Q mean): each term summed over an agent's
// tiles, the agents in order, times inv, the actor objective negated
// (mpe_maddpg.cu's reduce)
template <class D>
__global__ void maddpg_reduce_bf16_kernel(const float* __restrict__ partials,
                                          float* __restrict__ grads, float* __restrict__ metrics,
                                          int n_tiles, float inv) {
  constexpr int NA = D::A * D::NWP, NT = NA + D::A * D::NCP;
  auto tile_sum = [&](const float* p) {
    float total = 0.0f;
    int t = 0;
    for (; t + 16 <= n_tiles; t += 16) {
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = p[(size_t)(t + r) * D::NG];
#pragma unroll
      for (int r = 0; r < 16; ++r) total = total + v[r];
    }
    for (; t < n_tiles; ++t) total = total + p[(size_t)t * D::NG];
    return total;
  };
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < NT + 3;
       idx += gridDim.x * blockDim.x) {
    if (idx >= NT) {
      const int m = idx - NT, term = m == 0 ? 0 : m == 1 ? 2 : 1;
      float sum = 0.0f;
      for (int a = 0; a < D::A; ++a) {
        const float ta = tile_sum(partials + (size_t)a * n_tiles * D::NG + D::G_MS + term);
        sum = a == 0 ? ta : sum + ta;
      }
      metrics[m] = m == 1 ? -sum * inv : sum * inv;
      continue;
    }
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
    grads[idx] = e >= 0 ? tile_sum(partials + (size_t)a * n_tiles * D::NG + e) : 0.0f;
  }
}

// the scratch's offset in the partials buffer (floats, 16-byte aligned):
// after the A x tiles partial gradients
template <class D>
size_t scratch_offset(int batch) {
  return ((size_t)D::A * ((batch + TS - 1) / TS) * D::NG + 3) / 4 * 4;
}

// ---- hidden 128 and 256 ---------------------------------------------------------
//
// The design above does not fit there (the source note): the wide kernels keep
// the function, the arithmetic (every product on bf16 operands, float32 sums;
// the tanh, 1 - h^2, the head and the bias sums in float32) and the reduce,
// and change the layout, as K6-bf16's wide kernel does (bf16_wide.cuh):
//   tiles     TSW = 64 samples, 8 warps; warp w owns UW = H / 8 units (16 at
//             128, 32 at 256: the N side of its products) for the whole tile
//             (the M side, MTS m16 blocks), so its float32 h1, h2 and their
//             1 - h^2 stay with the warp that needs them in the backward;
//   weights   w1, w2 of the eight nets of an agent and w2^T of its live nets
//             rounded once a call into a fragment-packed scratch after the
//             partials (maddpg_round_bf16_wide_kernel, PackedB), which the L2
//             cache holds for every CTA; each lane streams its own B
//             fragments through a ring of RING k16 steps (BRing::product); w3
//             (bf16 rows), the biases and the own-action columns of the
//             critic's w1 (float32) are staged once a CTA;
//   target    maddpg_target_bf16_wide_kernel (grid tiles x agents: agent q's
//             target actor, the first argmax per head -> act2), then
//             maddpg_td_bf16_wide_kernel (agent i's target critic on (s', a'),
//             every agent's a' from act2 -> y): two kernels, since every
//             agent's a' must exist before any TD;
//   gradient  maddpg_grad_bf16_wide_kernel: a persistent grid of wide_parts
//             CTAs an agent, each adding its tiles into its own partial (one
//             owner per entry: add_outer, and store_tile's adds; no atomics),
//             which maddpg_reduce_bf16_kernel sums in its fixed order. Per
//             tile: the critic's forward (Q as each warp's mma over its units,
//             the warps' parts summed in order), its backward and weight
//             gradients; the candidates' base (the first layer again, minus
//             the own-action product: keeping it would take 64 KB of float32
//             at 256) in registers; each candidate's h1 into one of two bf16
//             tiles in turn (one __syncthreads a candidate), its layers 2-3 on
//             the tensor cores; the head in float32, a sample a thread, the
//             8-64 kernel's arithmetic; the actor's forward, backward and
//             weight gradients.
// The partial's read-modify-write is the price of the width (as on K6-bf16's
// wide kernel): per tile 2 x 4 (H J + H^2 + H OW + H^2) bytes of dW1 and dW2
// of the critic and the actor, 1.23 MB on simple_spread and 1.65 MB on
// simple_world_comm at 256 (0.35 and 0.56 MB at 128): 59 and 158 MB of L2
// traffic an update at path d's batch of 1024 at 256.
constexpr int THREADS_W = 256;                // a wide CTA: 8 warps
constexpr int WARPS_W = THREADS_W / 32;
constexpr int UW = WIDE ? H / WARPS_W : 16;   // the units a warp owns: 16 at 128, 32 at 256
constexpr int NBW = UW / 8, QW = NBW / 2;     // their n8 blocks, their k16 steps as an A operand
constexpr int TSW = 64;                       // samples per wide tile
constexpr int MTS = TSW / 16;                 // its m16 row blocks
constexpr int MTW = UW / 16;                  // the warp's units' m16 row blocks (dW's rows)
constexpr int NGW = 8 / MTW;                  // add_outer's column blocks at a time
constexpr int RING = 4;                       // the k16 steps of a lane's weight ring
constexpr int KTW = HP / 16;                  // the hidden units' k16 steps
constexpr int LHW = lda(HP), L3W = lda(16);   // rows of a hidden tile, of a G3 tile
using WRing = BRing<NBW, RING>;

// The fragment-packed bf16 scratch of one wide call, in words: per agent its
// actor (w1, w2, w2^T), its critic (w1, w2, w2^T), its target actor (w1, w2)
// and its target critic (w1, w2), each a PackedB of its inputs padded to 16
template <class D>
struct WideScratch {
  using PA1 = PackedB<UW, D::OWP / 16>;
  using PC1 = PackedB<UW, D::JP / 16>;
  using P2 = PackedB<UW, HP / 16>;
  static constexpr int W2A = PA1::WORDS, W2C = PC1::WORDS;   // w2 within a net's block
  static constexpr int AW = PA1::WORDS + 2 * P2::WORDS, CW = PC1::WORDS + 2 * P2::WORDS,
                       TAW = PA1::WORDS + P2::WORDS, TCW = PC1::WORDS + P2::WORDS;
  static constexpr int OFF_A = 0, OFF_C = D::A * AW, OFF_TA = OFF_C + D::A * CW,
                       OFF_TC = OFF_TA + D::A * TAW, WORDS = OFF_TC + D::A * TCW;
};

// word o of a net's block of the scratch from its kernel-layout block of the
// weight buffer (w1 [H, NIN], b1, w2 [H, H], ...): w1, w2, then w2^T
template <int NIN>
__device__ __forceinline__ uint32_t wide_net_word(const float* __restrict__ net, int o) {
  using P1 = PackedB<UW, pad16(NIN) / 16>;
  using P2 = PackedB<UW, HP / 16>;
  const float* w2 = net + H * NIN + H;
  if (o < P1::WORDS)
    return P1::word(o, [&](int n, int kk) { return kk < NIN ? net[n * NIN + kk] : 0.0f; });
  o -= P1::WORDS;
  if (o < P2::WORDS) return P2::word(o, [&](int n, int kk) { return w2[n * H + kk]; });
  return P2::word(o - P2::WORDS, [&](int n, int kk) { return w2[kk * H + n]; });
}

// The wide rounding pass: every net's streamed weights into the scratch, a
// launch of the call before the others
template <class D>
__global__ void __launch_bounds__(ROUND_THREADS)
maddpg_round_bf16_wide_kernel(const float* __restrict__ weights, uint32_t* __restrict__ scratch) {
  using S = WideScratch<D>;
  for (int e = blockIdx.x * ROUND_THREADS + threadIdx.x; e < S::WORDS;
       e += gridDim.x * ROUND_THREADS) {
    uint32_t v;
    if (e < S::OFF_C) {
      const int q = e / S::AW;
      v = wide_net_word<D::OW>(weights + D::OFF_A + q * D::NWP, e - q * S::AW);
    } else if (e < S::OFF_TA) {
      const int o = e - S::OFF_C, q = o / S::CW;
      v = wide_net_word<D::J>(weights + D::OFF_C + q * D::NCP, o - q * S::CW);
    } else if (e < S::OFF_TC) {
      const int o = e - S::OFF_TA, q = o / S::TAW;
      v = wide_net_word<D::OW>(weights + D::OFF_TA + q * D::NWP, o - q * S::TAW);
    } else {
      const int o = e - S::OFF_TC, q = o / S::TCW;
      v = wide_net_word<D::J>(weights + D::OFF_TC + q * D::NCP, o - q * S::TCW);
    }
    scratch[e] = v;
  }
}

// a net's w3 [NOUT, H] as bf16 rows W3 [16][LHW], zeros in the padding
template <int NIN, int NOUT>
__device__ __forceinline__ auto w3_part(const float* __restrict__ net, uint16_t* W3) {
  constexpr int E_W3 = H * NIN + 2 * H + H * H;
  return stage_part(16 * LHW, [=](int e) {
    const int m = e / LHW, c = e - m * LHW;
    return m < NOUT && c < H ? net[E_W3 + m * H + c] : 0.0f;
  }, [=](int e, float v) { W3[e] = (uint16_t)bf16_bits(v); });
}

// acc = X W^T over the tile's MTS row blocks and the warp's units: X the
// sample-major bf16 tile [TSW][ldx], W streamed from p (the warp's part of a
// PackedB of KT k16 steps) through the warp's ring, each step's sum added in
// float32 (mma_bf16_add)
template <int KT>
__device__ __forceinline__ void wide_dense(const uint16_t* X, int ldx, const uint32_t* p,
                                           uint32_t* ring, int lane, float (&acc)[MTS][NBW][4]) {
  WRing::product<MTS, KT, true>(
      [&](int mt, int kt, uint32_t (&a)[4]) { frag_a_mk(X, ldx, 16 * mt, 16 * kt, lane, a); }, p,
      ring, lane, acc);
}

// h = tanh(h + b[unit]) of the warp's units (b from its first unit)
__device__ __forceinline__ void tanh_bias(float (&h)[MTS][NBW][4], const float* b, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) h[mt][nb][i] = tanhf(h[mt][nb][i] + b[8 * nb + 2 * t + (i & 1)]);
}

// ... then rounded into the warp's columns of the bf16 tile T (from its first unit)
__device__ __forceinline__ void tanh_rows(float (&h)[MTS][NBW][4], const float* b, uint16_t* T,
                                          int lane) {
  tanh_bias(h, b, lane);
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    uint32_t a[QW][4];
    pack_a(h[mt], a);
    store_a(a, T, LHW, 16 * mt, lane);
  }
}

// the sum of the warps' parts qp [WARPS_W][TSW] of sample s's output, in warp order
__device__ __forceinline__ float sum_parts(const float* qp, int s) {
  float v = qp[s];
#pragma unroll
  for (int w = 1; w < WARPS_W; ++w) v = v + qp[w * TSW + s];
  return v;
}

// dst[8 nb + 2t + p] += db[nb][p] summed over the warp's row groups g (dst
// from the warp's first unit; one lane a column)
__device__ __forceinline__ void add_col_sums(float (&db)[NBW][2], float* dst, int lane) {
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = db[nb][p];
#pragma unroll
      for (int mask = 4; mask < 32; mask <<= 1) v = v + __shfl_xor_sync(0xffffffffu, v, mask);
      if ((lane >> 2) == 0) dst[8 * nb + 2 * (lane & 3) + p] += v;
    }
}

// g *= 1 - h^2 (float32) over the tile, its column sums added into db (from
// the warp's first unit)
__device__ __forceinline__ void tanh_grad(float (&g)[MTS][NBW][4], const float (&h)[MTS][NBW][4],
                                          float* db, int lane) {
  float s[NBW][2];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) s[nb][0] = s[nb][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g[mt][nb][i] = g[mt][nb][i] * (1.0f - h[mt][nb][i] * h[mt][nb][i]);
      s[nb][0] = s[nb][0] + (g[mt][nb][0] + g[mt][nb][2]);
      s[nb][1] = s[nb][1] + (g[mt][nb][1] + g[mt][nb][3]);
    }
  add_col_sums(s, db, lane);
}

// the warp's part of a single output h W3^T over its units (h post-tanh,
// rounded here; each k16 step's sum added in float32), rows 16 mt + g and + 8
// from the lanes t = 0 into qp [TSW]
__device__ __forceinline__ void q_part(const float (&h)[MTS][NBW][4], const uint16_t* W3, int u0,
                                       float* qp, int lane) {
  uint32_t bw[QW][2];
#pragma unroll
  for (int j = 0; j < QW; ++j) frag_b_nk(W3, LHW, 0, u0 + 16 * j, lane, bw[j]);
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    uint32_t a[QW][4];
    pack_a(h[mt], a);
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < QW; ++j) mma_bf16_add(z, a[j], bw[j]);
    if ((lane & 3) == 0) {
      qp[16 * mt + (lane >> 2)] = z[0];
      qp[16 * mt + (lane >> 2) + 8] = z[2];
    }
  }
}

// the logits z [TSW][ZLD] = H2 W3^T + b3 of NBO n8 blocks of outputs, warp w
// the (16 x 8) tile (w % MTS, w / MTS)
template <int NBO>
__device__ __forceinline__ void wide_logits(const uint16_t* H2, const uint16_t* W3,
                                            const float* b3, float* zt, int warp, int lane) {
  static_assert(NBO * MTS <= WARPS_W, "a logit tile a warp");
  const int mt = warp % MTS, nb = warp / MTS;
  if (nb < NBO) {
    float z[1][4];
    warp_dense_f<1, KTW, false, true>(
        [&](int kt, uint32_t (&a)[4]) { frag_a_mk(H2, LHW, 16 * mt, 16 * kt, lane, a); },
        W3 + 8 * nb * LHW, LHW, lane, z);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * nb + 2 * (lane & 3) + (i & 1);
      zt[(16 * mt + (lane >> 2) + 8 * (i >> 1)) * ZLD + c] = z[0][i] + b3[c];
    }
  }
}

// The output layer's backward over the tile, for the warp's units: dw3
// [NOUT][H] += G3^T H2 (H2 the bf16 rows of T), then gh2 = (g3 W3) (1 - h2^2)
// (G3 [TSW][L3W] the rounded output gradient, W3 [16][LHW]) rounded into the
// warp's columns of T, its column sums added into db2 (from the warp's first
// unit)
template <int NOUT>
__device__ __forceinline__ void wide_out_backward(const uint16_t* G3, const uint16_t* W3,
                                                  uint16_t* T, const float (&h2)[MTS][NBW][4],
                                                  int u0, float* dw3, float* db2, int lane) {
  float a3[NBW][4];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) a3[nb][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < MTS; ++ks) {
    uint32_t a[4];
    frag_a_km(G3, L3W, 16 * ks, 0, lane, a);
#pragma unroll
    for (int nb = 0; nb < NBW; nb += 2) {
      uint32_t bb[2][2];
      frag_b2_kn(T, LHW, 16 * ks, u0 + 8 * nb, lane, bb);
      mma_bf16(a3[nb], a, bb[0]);
      mma_bf16(a3[nb + 1], a, bb[1]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
    store_tile<false, true>(dw3, NOUT, H, 0, u0 + 8 * nb, lane, a3[nb]);
  __syncwarp();                                        // the warp's reads of H2 done
  uint32_t bw[NBW][2];
#pragma unroll
  for (int nb = 0; nb < NBW; nb += 2) {
    uint32_t bb[2][2];
    frag_b2_kn(W3, LHW, 0, u0 + 8 * nb, lane, bb);
    bw[nb][0] = bb[0][0];
    bw[nb][1] = bb[0][1];
    bw[nb + 1][0] = bb[1][0];
    bw[nb + 1][1] = bb[1][1];
  }
  float s[NBW][2];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb) s[nb][0] = s[nb][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < MTS; ++mt) {
    uint32_t a[4];
    frag_a_mk(G3, L3W, 16 * mt, 0, lane, a);
    float gh[NBW][4];
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) gh[nb][i] = 0.0f;
      mma_bf16(gh[nb], a, bw[nb]);
#pragma unroll
      for (int i = 0; i < 4; ++i) gh[nb][i] = gh[nb][i] * (1.0f - h2[mt][nb][i] * h2[mt][nb][i]);
      s[nb][0] = s[nb][0] + (gh[nb][0] + gh[nb][2]);
      s[nb][1] = s[nb][1] + (gh[nb][1] + gh[nb][3]);
    }
    uint32_t ap[QW][4];
    pack_a(gh, ap);
    store_a(ap, T + u0, LHW, 16 * mt, lane);
  }
  add_col_sums(s, db2, lane);
}

// ---- the wide target actions and TD targets -------------------------------------

// shared memory: bf16 the s' tile [TSW][LXA], h1 [TSW][LHW], h2 [TSW][LHW],
// W3 [16][LHW], the warps' rings; float32 the biases [FBN], the logits
// [TSW][ZLD]
template <class D>
struct WideTaLayout {
  static constexpr int LXA = lda(D::OWP);
  static constexpr int S_X = 0, S_A = S_X + TSW * LXA, S_B = S_A + TSW * LHW,
                       S_W3 = S_B + TSW * LHW, S_RING = S_W3 + 16 * LHW,
                       S_END = S_RING + 2 * WARPS_W * WRing::WARP_WORDS;
  static constexpr int F_B = (S_END / 2 + 3) / 4 * 4, F_Z = F_B + FBN, F_END = F_Z + TSW * ZLD;
  static constexpr size_t SMEM = (size_t)F_END * sizeof(float);
};

// grid (batch / TSW, agents): agent q's target actor on s', its first-argmax
// move and comm -> act2 [A, NH, B]
template <class D>
__global__ void __launch_bounds__(THREADS_W, 1)
maddpg_target_bf16_wide_kernel(const float* __restrict__ weights,
                               const uint32_t* __restrict__ scratch, const float* __restrict__ rows,
                               int* __restrict__ act2, int batch) {
  using L = WideTaLayout<D>;
  using S = WideScratch<D>;
  constexpr int K = D::K, NBO = (K + 7) / 8;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* X = w16 + L::S_X;
  uint16_t* As = w16 + L::S_A;
  uint16_t* Bs = w16 + L::S_B;
  uint16_t* W3 = w16 + L::S_W3;
  float* bias = smem + L::F_B;
  float* zt = smem + L::F_Z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, u0 = UW * warp;
  const int q = blockIdx.y, b0 = blockIdx.x * TSW;
  uint32_t* ring = reinterpret_cast<uint32_t*>(w16 + L::S_RING) + warp * WRing::WARP_WORDS;
  const uint32_t* net = scratch + S::OFF_TA + q * S::TAW;
  const float* wt = weights + D::OFF_TA + q * D::NWP;
  stage_parts(bias_part<D::OW, K>(wt, 0, bias), w3_part<D::OW, K>(wt, W3),
              cols_part<D::OW, TSW>(rows, D::RW, D::R_OBS2 + q * D::OW, b0, batch, X, L::LXA));
  zero_cols(X, L::LXA, D::OW, D::OWP, TSW);
  __syncthreads();
  float h[MTS][NBW][4];
  wide_dense<D::OWP / 16>(X, L::LXA, net + warp * S::PA1::WARP_WORDS, ring, lane, h);
  tanh_rows(h, bias + FB1 + u0, As + u0, lane);
  __syncthreads();
  wide_dense<KTW>(As, LHW, net + S::W2A + warp * S::P2::WARP_WORDS, ring, lane, h);
  tanh_rows(h, bias + FB2 + u0, Bs + u0, lane);
  __syncthreads();
  wide_logits<NBO>(Bs, W3, bias + FB3, zt, warp, lane);
  __syncthreads();
  if (tid < TSW && b0 + tid < batch) {               // a sample a thread
    float zz[K];
#pragma unroll
    for (int c = 0; c < K; ++c) zz[c] = zt[tid * ZLD + c];
    act2[(q * D::NH) * batch + b0 + tid] = first_argmax<0, MW>(zz);
    if constexpr (D::C > 0) act2[(q * D::NH + 1) * batch + b0 + tid] = first_argmax<MW, D::C>(zz);
  }
}

// shared memory: bf16 the (s', a') tile [TSW][LXJ], h1 [TSW][LHW], W3
// [16][LHW], the warps' rings; float32 the biases [FBN], the warps' parts of
// Q [WARPS_W][TSW]
template <class D>
struct WideTdLayout {
  static constexpr int LXJ = lda(D::JP);
  static constexpr int S_X = 0, S_A = S_X + TSW * LXJ, S_W3 = S_A + TSW * LHW,
                       S_RING = S_W3 + 16 * LHW, S_END = S_RING + 2 * WARPS_W * WRing::WARP_WORDS;
  static constexpr int F_B = (S_END / 2 + 3) / 4 * 4, F_Q = F_B + FBN,
                       F_END = F_Q + WARPS_W * TSW;
  static constexpr size_t SMEM = (size_t)F_END * sizeof(float);
};

// grid (batch / TSW, agents): agent i's target critic on (s', a'), the
// agents' a' the one-hots of act2 -> y [A, B] = r_i + gamma Q'_i(s', a')
template <class D>
__global__ void __launch_bounds__(THREADS_W, 1)
maddpg_td_bf16_wide_kernel(const float* __restrict__ weights, const uint32_t* __restrict__ scratch,
                           const float* __restrict__ rows, const int* __restrict__ act2,
                           float* __restrict__ y, int batch, float gamma) {
  using L = WideTdLayout<D>;
  using S = WideScratch<D>;
  constexpr int K = D::K, AO = D::AO, AK = D::AK;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* X = w16 + L::S_X;
  uint16_t* As = w16 + L::S_A;
  uint16_t* W3 = w16 + L::S_W3;
  float* bias = smem + L::F_B;
  float* qp = smem + L::F_Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, u0 = UW * warp;
  const int i = blockIdx.y, b0 = blockIdx.x * TSW;
  uint32_t* ring = reinterpret_cast<uint32_t*>(w16 + L::S_RING) + warp * WRing::WARP_WORDS;
  const uint32_t* net = scratch + S::OFF_TC + i * S::TCW;
  const float* wt = weights + D::OFF_TC + i * D::NCP;
  const auto onehots = stage_part(TSW * AK, [=](int e) {   // a', from act2
    const int s = e / AK, r = e - s * AK, q = r / K, kk = r - q * K;
    const int b = b0 + s < batch ? b0 + s : b0;
    const int idx = kk < MW ? act2[(q * D::NH) * batch + b] : act2[(q * D::NH + 1) * batch + b];
    return (kk < MW ? kk : kk - MW) == idx ? 1.0f : 0.0f;
  }, [=](int e, float v) {
    const int s = e / AK;
    X[s * L::LXJ + AO + e - s * AK] = (uint16_t)bf16_bits(v);
  });
  stage_parts(bias_part<D::J, 1>(wt, 0, bias), w3_part<D::J, 1>(wt, W3),
              cols_part<AO, TSW>(rows, D::RW, D::R_OBS2, b0, batch, X, L::LXJ), onehots);
  zero_cols(X, L::LXJ, D::J, D::JP, TSW);
  __syncthreads();
  float h[MTS][NBW][4];
  wide_dense<D::JP / 16>(X, L::LXJ, net + warp * S::PC1::WARP_WORDS, ring, lane, h);
  tanh_rows(h, bias + FB1 + u0, As + u0, lane);
  __syncthreads();
  wide_dense<KTW>(As, LHW, net + S::W2C + warp * S::P2::WARP_WORDS, ring, lane, h);
  tanh_bias(h, bias + FB2 + u0, lane);
  q_part(h, W3, u0, qp + warp * TSW, lane);
  __syncthreads();
  if (tid < TSW && b0 + tid < batch) {
    const float r = rows[(size_t)(b0 + tid) * D::RW + D::R_REW + i];
    y[(size_t)i * batch + b0 + tid] = r + gamma * (sum_parts(qp, tid) + bias[FB3]);
  }
}

// ---- the wide gradient ------------------------------------------------------------

// shared memory. bf16: the joint (s, a) [TSW][LXJ], the agent's obs
// [TSW][LXA], two hidden tiles A and B [TSW][LHW] (h1 or gh1, h2 or gh2; the
// candidates' h1 in turn), the critic's and the actor's W3 [16][LHW], the
// output gradient G3 [TSW][L3W], the warps' rings. float32: the biases
// (critic, actor) [FBN], the own-action columns of the critic's w1 [K][HP],
// y, g3 [TSW], the warps' parts of a Q [2][WARPS_W][TSW], the candidates' Q
// [NCAND][TSW], the metric terms [3][TSW], the actor's logits (then their
// gradient) [TSW][ZLD]
template <class D>
struct WideGradLayout {
  static constexpr int LXA = lda(D::OWP), LXJ = lda(D::JP);
  static constexpr int S_XJ = 0, S_XA = S_XJ + TSW * LXJ, S_A = S_XA + TSW * LXA,
                       S_B = S_A + TSW * LHW, S_W3C = S_B + TSW * LHW, S_W3A = S_W3C + 16 * LHW,
                       S_G3 = S_W3A + 16 * LHW, S_RING = S_G3 + TSW * L3W,
                       S_END = S_RING + 2 * WARPS_W * WRing::WARP_WORDS;
  static constexpr int F_BC = (S_END / 2 + 3) / 4 * 4, F_BA = F_BC + FBN, F_OWN = F_BA + FBN,
                       F_Y = F_OWN + D::K * HP, F_G3 = F_Y + TSW, F_QP = F_G3 + TSW,
                       F_QC = F_QP + 2 * WARPS_W * TSW, F_MS = F_QC + D::NCAND * TSW,
                       F_Z = F_MS + 3 * TSW, F_END = F_Z + TSW * ZLD;
  static constexpr size_t SMEM = (size_t)F_END * sizeof(float);
};

// grid (wide_parts CTAs, agents): CTA p of agent i takes the tiles p, p + P,
// ... of TSW samples (P = gridDim.x) and adds each into its partial,
// partials [A][P][NG]
template <class D>
__global__ void __launch_bounds__(THREADS_W, 1)
maddpg_grad_bf16_wide_kernel(const float* __restrict__ weights,
                             const uint32_t* __restrict__ scratch, const float* __restrict__ rows,
                             const float* __restrict__ y, float* __restrict__ partials, int batch,
                             Bf16Consts k) {
  using L = WideGradLayout<D>;
  using S = WideScratch<D>;
  constexpr int K = D::K, C = D::C, CX = D::CX, NBO = (K + 7) / 8, J = D::J, OW = D::OW;
  extern __shared__ __align__(16) float smem[];
  uint16_t* w16 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* XJ = w16 + L::S_XJ;
  uint16_t* XA = w16 + L::S_XA;
  uint16_t* As = w16 + L::S_A;
  uint16_t* Bs = w16 + L::S_B;
  uint16_t* W3C = w16 + L::S_W3C;
  uint16_t* W3A = w16 + L::S_W3A;
  uint16_t* G3 = w16 + L::S_G3;
  float* bc = smem + L::F_BC;
  float* ba = smem + L::F_BA;
  float* own = smem + L::F_OWN;
  float* ys = smem + L::F_Y;
  float* g3s = smem + L::F_G3;
  float* qp = smem + L::F_QP;
  float* qc = smem + L::F_QC;
  float* ms = smem + L::F_MS;
  float* zt = smem + L::F_Z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int u0 = UW * warp;
  const int i = blockIdx.y, n_tiles = (batch + TSW - 1) / TSW;
  uint32_t* ring = reinterpret_cast<uint32_t*>(w16 + L::S_RING) + warp * WRing::WARP_WORDS;
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;
  float* pc = part + D::G_CRITIC;
  float* pa = part + D::G_ACTOR;
  const float* cw = weights + D::OFF_C + i * D::NCP;
  const float* aw = weights + D::OFF_A + i * D::NWP;
  const uint32_t* cnet = scratch + S::OFF_C + i * S::CW;
  const uint32_t* anet = scratch + S::OFF_A + i * S::AW;
  const uint32_t* c1 = cnet + warp * S::PC1::WARP_WORDS;
  const uint32_t* c2 = cnet + S::W2C + warp * S::P2::WARP_WORDS;
  const uint32_t* c2t = c2 + S::P2::WORDS;
  const uint32_t* a1 = anet + warp * S::PA1::WARP_WORDS;
  const uint32_t* a2 = anet + S::W2A + warp * S::P2::WARP_WORDS;
  const uint32_t* a2t = a2 + S::P2::WORDS;
  const int own0 = D::AO + i * K;                    // the agent's own-action inputs of the joint

  const auto own_cols = stage_part(                 // w1's own-action columns, float32
      K * HP,
      [=](int e) {
        const int kk = e / HP, m = e - kk * HP;
        return m < H ? cw[D::CW1 + m * J + own0 + kk] : 0.0f;
      },
      [=](int e, float v) { own[e] = v; });
  stage_parts(bias_part<J, 1>(cw, 0, bc), bias_part<OW, K>(aw, 0, ba), w3_part<J, 1>(cw, W3C),
              w3_part<OW, K>(aw, W3A), own_cols);
  zero_cols(XJ, L::LXJ, J, D::JP, TSW);
  zero_cols(XA, L::LXA, OW, D::OWP, TSW);
  for (int e = tid; e < D::NG; e += THREADS_W) part[e] = 0.0f;   // the tiles are added into it

  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const int b0 = ti * TSW;
    const auto y_tile = stage_part(
        TSW, [=](int e) { return b0 + e < batch ? y[(size_t)i * batch + b0 + e] : 0.0f; },
        [=](int e, float v) { ys[e] = v; });
    stage_parts(y_tile, cols_part<J, TSW>(rows, D::RW, 0, b0, batch, XJ, L::LXJ),       // (s, a)
                cols_part<OW, TSW>(rows, D::RW, i * OW, b0, batch, XA, L::LXA));       // its obs
    __syncthreads();

    // ---- the critic's forward: h1, h2 (float32 kept, bf16 into A, B), Q
    float h1[MTS][NBW][4], h2[MTS][NBW][4];
    wide_dense<D::JP / 16>(XJ, L::LXJ, c1, ring, lane, h1);
    tanh_rows(h1, bc + FB1 + u0, As + u0, lane);
    __syncthreads();
    wide_dense<KTW>(As, LHW, c2, ring, lane, h2);
    tanh_rows(h2, bc + FB2 + u0, Bs + u0, lane);
    q_part(h2, W3C, u0, qp + warp * TSW, lane);
    __syncthreads();
    if (tid < TSW) {                                 // Q, the TD gradient g3 (rounded into G3)
      const int s = tid;
      const bool valid = b0 + s < batch;
      const float qv = sum_parts(qp, s) + bc[FB3];
      const float d = valid ? qv - ys[s] : 0.0f;
      const float gv = (2.0f * k.inv) * d;
      g3s[s] = gv;
      ms[s] = d * d;
      ms[TSW + s] = valid ? qv : 0.0f;
      uint32_t* row = reinterpret_cast<uint32_t*>(G3 + s * L3W);
      row[0] = pack_bf16(gv, 0.0f);
#pragma unroll
      for (int c = 1; c < 8; ++c) row[c] = 0u;
    }
    __syncthreads();

    // ---- its backward: dW3, gh2 into B; gh1 = (gh2 W2) (1 - h1^2); dW2, dW1
    wide_out_backward<1>(G3, W3C, Bs, h2, u0, pc + D::CW3, pc + D::CB2 + u0, lane);
    __syncthreads();                                 // gh2 whole
    uint32_t ag1[MTS][QW][4];
    {
      float gh[MTS][NBW][4];
      wide_dense<KTW>(Bs, LHW, c2t, ring, lane, gh);
      tanh_grad(gh, h1, pc + D::CB1 + u0, lane);
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) pack_a(gh[mt], ag1[mt]);
    }
    add_outer<MTW, MTS, HP / 8, NGW>(                // dW2 += GH2^T H1
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(Bs, LHW, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_kn(As, LHW, 16 * ks, 8 * nb, lane, bb);
        },
        pc + D::CW2, H, H, u0, lane);
    __syncthreads();                                 // every warp's reads of h1 done
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) store_a(ag1[mt], As + u0, LHW, 16 * mt, lane);
    __syncwarp();
    add_outer<MTW, MTS, pad8(J) / 8, NGW>(           // dW1 += GH1^T (s, a)
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(As, LHW, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_kn(XJ, L::LXJ, 16 * ks, 8 * nb, lane, bb);
        },
        pc + D::CW1, J, J, u0, lane);
    if (tid == 0) {
      float total = g3s[0];
      for (int s = 1; s < TSW; ++s) total = total + g3s[s];
      pc[D::CB3] += total;
    }
    __syncthreads();

    // ---- the candidates: base = the first layer's pre-activation (again)
    // minus the own-action product; candidate c = m CX + j: h1 = tanh(base +
    // (w1[:, own move m] + w1[:, own comm j])) into A or B in turn, h2 =
    // tanh(h1 W2^T + b2), Q = h2 W3^T + b3
    float base[MTS][NBW][4];
    wide_dense<D::JP / 16>(XJ, L::LXJ, c1, ring, lane, base);
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * mt + g + 8 * (e >> 1), u = u0 + 8 * nb + 2 * t + (e & 1);
          const uint16_t* xa = XJ + s * L::LXJ + own0;
          float prod = bf16_value(bf16_bits(own[u])) * bf16_value(xa[0]);
#pragma unroll
          for (int kk = 1; kk < K; ++kk)
            prod = prod + bf16_value(bf16_bits(own[kk * HP + u])) * bf16_value(xa[kk]);
          base[mt][nb][e] = (base[mt][nb][e] + bc[FB1 + u]) - prod;
        }
#pragma unroll 1
    for (int c = 0; c < D::NCAND; ++c) {
      const int mv = c / CX, jc = c - mv * CX;
      uint16_t* T = (c & 1) ? Bs : As;
      float h[MTS][NBW][4];
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int u = u0 + 8 * nb + 2 * t + p;
          const float dc = C > 0 ? own[mv * HP + u] + own[(MW + jc) * HP + u] : own[mv * HP + u];
#pragma unroll
          for (int mt = 0; mt < MTS; ++mt) {
            h[mt][nb][p] = tanhf(base[mt][nb][p] + dc);
            h[mt][nb][p + 2] = tanhf(base[mt][nb][p + 2] + dc);
          }
        }
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) {
        uint32_t a[QW][4];
        pack_a(h[mt], a);
        store_a(a, T + u0, LHW, 16 * mt, lane);
      }
      __syncthreads();
      if (c > 0 && tid < TSW)                        // the last candidate's Q
        qc[(c - 1) * TSW + tid] = sum_parts(qp + ((c - 1) & 1) * WARPS_W * TSW, tid) + bc[FB3];
      wide_dense<KTW>(T, LHW, c2, ring, lane, h);
      tanh_bias(h, bc + FB2 + u0, lane);
      q_part(h, W3C, u0, qp + (c & 1) * WARPS_W * TSW + warp * TSW, lane);
    }
    __syncthreads();
    if (tid < TSW)
      qc[(D::NCAND - 1) * TSW + tid] =
          sum_parts(qp + ((D::NCAND - 1) & 1) * WARPS_W * TSW, tid) + bc[FB3];

    // ---- the actor: forward, the head, backward, weight gradients
    wide_dense<D::OWP / 16>(XA, L::LXA, a1, ring, lane, h1);
    tanh_rows(h1, ba + FB1 + u0, As + u0, lane);
    __syncthreads();
    wide_dense<KTW>(As, LHW, a2, ring, lane, h2);
    tanh_rows(h2, ba + FB2 + u0, Bs + u0, lane);
    __syncthreads();
    wide_logits<NBO>(Bs, W3A, ba + FB3, zt, warp, lane);
    __syncthreads();
    if (tid < TSW) {                                 // the head, a sample a thread; G3 in bf16
      const int s = tid;
      float* zr = zt + s * ZLD;
      ms[2 * TSW + s] = actor_head<D, TSW>(zr, qc + s, b0 + s < batch, k);
      uint32_t* row = reinterpret_cast<uint32_t*>(G3 + s * L3W);
#pragma unroll
      for (int c = 0; c < 16; c += 2)
        row[c / 2] = pack_bf16(c < K ? zr[c] : 0.0f, c + 1 < K ? zr[c + 1] : 0.0f);
    }
    __syncthreads();
    if (tid < K) {                                   // db3 over the tile's samples, in order
      float total = zt[tid];
      for (int s = 1; s < TSW; ++s) total = total + zt[s * ZLD + tid];
      pa[D::AB3 + tid] += total;
    }
    wide_out_backward<K>(G3, W3A, Bs, h2, u0, pa + D::AW3, pa + D::AB2 + u0, lane);
    __syncthreads();                                 // gh2 whole
    {
      float gh[MTS][NBW][4];
      wide_dense<KTW>(Bs, LHW, a2t, ring, lane, gh);
      tanh_grad(gh, h1, pa + D::AB1 + u0, lane);
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt) pack_a(gh[mt], ag1[mt]);
    }
    add_outer<MTW, MTS, HP / 8, NGW>(                // dW2 += GH2^T H1
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(Bs, LHW, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_kn(As, LHW, 16 * ks, 8 * nb, lane, bb);
        },
        pa + D::AW2, H, H, u0, lane);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MTS; ++mt) store_a(ag1[mt], As + u0, LHW, 16 * mt, lane);
    __syncwarp();
    add_outer<MTW, MTS, pad8(OW) / 8, NGW>(          // dW1 += GH1^T obs
        [&](int mt, int ks, uint32_t (&a)[4]) {
          frag_a_km(As, LHW, 16 * ks, u0 + 16 * mt, lane, a);
        },
        [&](int nb, int ks, uint32_t (&bb)[2][2]) {
          frag_b2_kn(XA, L::LXA, 16 * ks, 8 * nb, lane, bb);
        },
        pa + D::AW1, OW, OW, u0, lane);
    if (tid < 3) {                                   // the metric sums, in order
      float total = ms[tid * TSW];
      for (int s = 1; s < TSW; ++s) total = total + ms[tid * TSW + s];
      part[D::G_MS + tid] += total;
    }
    __syncthreads();                                 // the tile's reads done
  }
}

// the wide gradient kernel's CTAs an agent: all that the card holds at once,
// shared among the agents (at least one each); -1 where the card cannot say
template <class D>
int wide_parts() {
  static const int parts = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(maddpg_grad_bf16_wide_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WideGradLayout<D>::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maddpg_grad_bf16_wide_kernel<D>,
                                                      THREADS_W, WideGradLayout<D>::SMEM) !=
            cudaSuccess)
      return -1;
    const int n = sms * per_sm / D::A;
    return n > 0 ? n : 1;
  }();
  return parts;
}

// the wide scratch's offset in the partials buffer (floats, 16-byte aligned):
// after the A x n_parts partial gradients
template <class D>
size_t wide_scratch_offset(int n_parts) {
  return ((size_t)D::A * n_parts * D::NG + 3) / 4 * 4;
}

// hidden 8-64: grid (batch / TS, agents), a partial per tile
template <class D>
int launch_update_narrow(const float* weights, const float* rows, int* act2, float* y,
                         float* partials, float* grads, float* metrics, int batch, float gamma,
                         float ent_coef, float inv, cudaStream_t stream) {
  static_assert(GradLayout<D>::SMEM <= SMEM_MAX && TdLayout<D>::SMEM <= SMEM_MAX,
                "a K9-bf16 CTA exceeds the shared memory of an SM");
  // once per instantiation: the attributes hold for the process
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(maddpg_target_td_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TdLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_grad_bf16_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)GradLayout<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int n_tiles = (batch + TS - 1) / TS;
  uint16_t* scratch = reinterpret_cast<uint16_t*>(partials + scratch_offset<D>(batch));
  constexpr int round_ctas =
      (Scratch<D>::PAIRS + ROUND_PAIRS * ROUND_THREADS - 1) / (ROUND_PAIRS * ROUND_THREADS);
  maddpg_round_bf16_kernel<D><<<round_ctas, ROUND_THREADS, 0, stream>>>(weights, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, D::A);
  maddpg_target_td_bf16_kernel<D><<<grid, TD_THREADS, TdLayout<D>::SMEM, stream>>>(
      weights, scratch, rows, act2, y, batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Bf16Consts k{gamma, ent_coef, inv};
  maddpg_grad_bf16_kernel<D><<<grid, GRAD_THREADS, GradLayout<D>::SMEM, stream>>>(
      weights, scratch, rows, y, partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int n_out = D::A * (D::NWP + D::NCP) + 3;
  constexpr int reduce_ctas = (n_out + 255) / 256 < REDUCE_CTAS ? (n_out + 255) / 256 : REDUCE_CTAS;
  maddpg_reduce_bf16_kernel<D><<<reduce_ctas, 256, 0, stream>>>(partials, grads, metrics, n_tiles,
                                                               inv);
  return (int)cudaGetLastError();
}

// hidden 128 and 256: the rounding pass, the target actions, the TD targets,
// the gradient on a persistent grid of min(tiles, wide_parts) CTAs an agent
// (a partial each) and the reduce
template <class D>
int launch_update_wide(const float* weights, const float* rows, int* act2, float* y,
                       float* partials, float* grads, float* metrics, int batch, float gamma,
                       float ent_coef, float inv, cudaStream_t stream) {
  static_assert(WideGradLayout<D>::SMEM <= SMEM_MAX && WideTdLayout<D>::SMEM <= SMEM_MAX &&
                    WideTaLayout<D>::SMEM <= SMEM_MAX,
                "a wide K9-bf16 CTA exceeds the shared memory of an SM");
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(maddpg_target_bf16_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)WideTaLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_td_bf16_wide_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)WideTdLayout<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int parts = wide_parts<D>();
  if (parts < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (batch + TSW - 1) / TSW;
  const int n_parts = n_tiles < parts ? n_tiles : parts;
  uint32_t* scratch = reinterpret_cast<uint32_t*>(partials + wide_scratch_offset<D>(n_parts));
  constexpr int round_ctas = (WideScratch<D>::WORDS + 8 * ROUND_THREADS - 1) / (8 * ROUND_THREADS);
  maddpg_round_bf16_wide_kernel<D><<<round_ctas, ROUND_THREADS, 0, stream>>>(weights, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tiles, D::A);
  maddpg_target_bf16_wide_kernel<D><<<grid, THREADS_W, WideTaLayout<D>::SMEM, stream>>>(
      weights, scratch, rows, act2, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_td_bf16_wide_kernel<D><<<grid, THREADS_W, WideTdLayout<D>::SMEM, stream>>>(
      weights, scratch, rows, act2, y, batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Bf16Consts k{gamma, ent_coef, inv};
  const dim3 grid_parts(n_parts, D::A);
  maddpg_grad_bf16_wide_kernel<D><<<grid_parts, THREADS_W, WideGradLayout<D>::SMEM, stream>>>(
      weights, scratch, rows, y, partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int n_out = D::A * (D::NWP + D::NCP) + 3;
  constexpr int reduce_ctas = (n_out + 255) / 256 < REDUCE_CTAS ? (n_out + 255) / 256 : REDUCE_CTAS;
  maddpg_reduce_bf16_kernel<D><<<reduce_ctas, 256, 0, stream>>>(partials, grads, metrics, n_parts,
                                                               inv);
  return (int)cudaGetLastError();
}

template <class D>
int launch_update(const float* weights, const float* rows, int* act2, float* y, float* partials,
                  float* grads, float* metrics, int batch, float gamma, float ent_coef, float inv,
                  cudaStream_t stream) {
  static_assert(D::OFF_C % 4 == 0 && D::NWP % 4 == 0 && D::NCP % 4 == 0,
                "the nets' blocks stay 16-byte aligned");
  if (batch < 1) return (int)cudaErrorInvalidValue;
  if constexpr (WIDE)
    return launch_update_wide<D>(weights, rows, act2, y, partials, grads, metrics, batch, gamma,
                                 ent_coef, inv, stream);
  else
    return launch_update_narrow<D>(weights, rows, act2, y, partials, grads, metrics, batch,
                                   gamma, ent_coef, inv, stream);
}

// the layout constants the wrapper mirrors: 0 actor stride, 1 critic stride,
// 2 weights, 3 gradient per agent, 4 samples per tile; 5 the floats of the
// bf16 scratch the launch keeps after its partials (scratch_offset,
// wide_scratch_offset); at hidden 8-64 6 an actor's and 7 a critic's bf16
// elements, 8 an actor's and 9 a critic's W1 row stride, 10 the W2 and W3
// row stride (BNet), 11 -1 (a partial a tile); at hidden 128 and 256 6-10 -1
// (the scratch is fragment-packed, WideScratch) and 11 the gradient's CTAs an
// agent at most (wide_parts)
template <class D>
int layout(int which) {
  if constexpr (WIDE) {
    const int v[6] = {D::NWP, D::NCP, D::N_WEIGHTS, D::NG, TSW, WideScratch<D>::WORDS};
    if (which == 11) return wide_parts<D>();
    return (which >= 0 && which < 6) ? v[which] : -1;
  } else {
    using S = Scratch<D>;
    const int v[11] = {D::NWP, D::NCP, D::N_WEIGHTS, D::NG, TS, S::N16 / 2, S::AN::N, S::CN::N,
                       S::AN::L1, S::CN::L1, S::AN::LH};
    return (which >= 0 && which < 11) ? v[which] : -1;
  }
}

// the dynamic shared memory of the target-action (which 0), TD (1) and
// gradient (2) kernels in bytes; at hidden 8-64 one kernel takes both 0 and 1
template <class D>
int update_smem(int which) {
  size_t v[3];
  if constexpr (WIDE) {
    v[0] = WideTaLayout<D>::SMEM, v[1] = WideTdLayout<D>::SMEM, v[2] = WideGradLayout<D>::SMEM;
  } else {
    v[0] = TdLayout<D>::SMEM, v[1] = TdLayout<D>::SMEM, v[2] = GradLayout<D>::SMEM;
  }
  return (which >= 0 && which < 3) ? (int)v[which] : -1;
}

}  // namespace

extern "C" {

// K9-bf16: mpe_maddpg.cu's mpe_maddpg_update, the same arguments and layout
// (weights [N_WEIGHTS] float32; rows [batch, RW]; act2 [A, NH, batch] and y
// [A, batch] scratch; partials [A, tiles, NG] scratch, tiles of TS samples,
// then (16-byte aligned) the bf16 nets, layout 5 floats; at hidden 128 and 256
// partials [A, parts, NG], parts = min(tiles, layout 11), then the scratch;
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

// the dynamic shared memory of K9-bf16's target-action (which 0), TD (1) and
// gradient (2) kernels for a scenario id at this library's width, in bytes
int mpe_maddpg_update_smem(int scenario, int which) {
#define MPE_MADDPG_BF16_SMEM(D) return update_smem<D>(which)
  MPE_BF16_DIMS_SWITCH(MPE_MADDPG_BF16_SMEM)
#undef MPE_MADDPG_BF16_SMEM
}

}  // extern "C"

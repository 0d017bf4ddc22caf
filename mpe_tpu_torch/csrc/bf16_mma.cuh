// The bf16 fragment helpers of the tensor-core kernels (mpe_update_bf16.cu:
// K6-bf16, K7-bf16; mpe_maddpg_bf16.cu: K9-bf16): float32 -> bf16 rounding
// (round to nearest even), mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (HMMA), ldmatrix (LDSM, plain and .trans) over bf16 tiles in shared memory,
// and the sample-major products a warp chains in registers.
//
// Sample-major: a warp's 16 samples are the M side of every product, D^T =
// X^T W^T. The accumulators of two n8 blocks of one layer are then the A
// fragment of the next layer's k16 step (pack_a), so a forward x -> h1 -> h2
// -> logits and a backward g3 -> gh2 -> gh1 chain in registers. The weights
// are the B operand: W [out][in] bf16 rows give the forward's fragments by
// plain ldmatrix and the backward's (W^T) by ldmatrix.trans. A weight gradient
// dW = sum_s G[s]^T X[s] contracts over the samples: G and X written once as
// bf16 sample-major rows, both fragments by ldmatrix.trans.
//
// Every ldmatrix row is 16 bytes, so a tile's rows are a multiple of 8
// elements apart (lda) and start 16-byte aligned. On the host
// (tests/_csrc_host.py) MPE_HOST_MMA names the emulated mma, and each lane of
// an ldmatrix reads the elements the PTX ISA's fragment table gives it
// directly: no exchange between lanes, no barrier.

#pragma once

#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace {

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// the row stride (in bf16) of a tile of k columns: 16-byte rows whose words
// are a multiple of 4 but not of 8, so that the 8 rows of an ldmatrix phase
// (or of an A fragment) fall in 32 distinct banks
__host__ __device__ constexpr int lda(int k) {
  int w = (k + 7) / 8 * 4;
  while (w % 8 != 4) ++w;
  return 2 * w;
}

// d += A B over one m16n8k16 tile (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"): lane = 4 g + t holds a[0] = A[g][2t, 2t+1], a[1] =
// A[g+8][2t, 2t+1], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9],
// b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g], d = D[g][2t, 2t+1],
// D[g+8][2t, 2t+1]; the lower k of a pair in the lower 16 bits
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(MPE_HOST_MMA)
  host_mma_m16n8k16_bf16(d, a, b);
#endif
}

// ---- ldmatrix -----------------------------------------------------------------
//
// q[i] of the 8 x 8 matrix i of a row-major bf16 tile M (ld elements a row):
// plain, lane 4 g + t gets (M[g][2t], M[g][2t+1]) of it; .trans, (M[2t][g],
// M[2t+1][g]); the first element in the low half.

// four matrices, i at rows r0 + 8 (i & 1), columns c0 + 8 (i >> 1)
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(const uint16_t* __restrict__ M, int ld, int r0, int c0,
                                        int lane, uint32_t (&q)[4]) {
#if defined(__CUDA_ARCH__)
  const uint16_t* p = M + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 + 8 * (lane >> 4);
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
                 : "r"(a));
  }
#else
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const uint16_t* m = M + (r0 + 8 * (i & 1)) * ld + c0 + 8 * (i >> 1);
    q[i] = TRANS ? (uint32_t)m[2 * t * ld + g] | ((uint32_t)m[(2 * t + 1) * ld + g] << 16)
                 : (uint32_t)m[g * ld + 2 * t] | ((uint32_t)m[g * ld + 2 * t + 1] << 16);
  }
#endif
}

// two matrices at (r0, c0) and, plain, (r0, c0 + 8) or, .trans, (r0 + 8, c0):
// the B fragment of one n8 block and k16 step
template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(const uint16_t* __restrict__ M, int ld, int r0, int c0,
                                        int lane, uint32_t (&q)[2]) {
#if defined(__CUDA_ARCH__)
  const int i = (lane >> 3) & 1;
  const uint16_t* p = M + (r0 + (lane & 7) + (TRANS ? 8 * i : 0)) * ld + c0 + (TRANS ? 0 : 8 * i);
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(q[0]), "=r"(q[1])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(q[0]), "=r"(q[1])
                 : "r"(a));
  }
#else
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 2; ++i) {
    const uint16_t* m = M + (r0 + (TRANS ? 8 * i : 0)) * ld + c0 + (TRANS ? 0 : 8 * i);
    q[i] = TRANS ? (uint32_t)m[2 * t * ld + g] | ((uint32_t)m[(2 * t + 1) * ld + g] << 16)
                 : (uint32_t)m[g * ld + 2 * t] | ((uint32_t)m[g * ld + 2 * t + 1] << 16);
  }
#endif
}

// The fragments a product takes, by how its operand is stored:
// the A fragment of rows m0 .., depth k0 .. of a [m][k] tile (plain)
__device__ __forceinline__ void frag_a_mk(const uint16_t* M, int ld, int m0, int k0, int lane,
                                          uint32_t (&a)[4]) {
  ldsm_x4<false>(M, ld, m0, k0, lane, a);
}

// ... of a [k][m] tile (.trans; the matrices' order swaps)
__device__ __forceinline__ void frag_a_km(const uint16_t* M, int ld, int k0, int m0, int lane,
                                          uint32_t (&a)[4]) {
  uint32_t q[4];
  ldsm_x4<true>(M, ld, k0, m0, lane, q);
  a[0] = q[0];
  a[1] = q[2];
  a[2] = q[1];
  a[3] = q[3];
}

// the B fragments of the n8 blocks n0, n0 + 8, depth k0 .., of a [n][k] tile
// (plain: the weights W [out][in] in a forward product)
__device__ __forceinline__ void frag_b2_nk(const uint16_t* M, int ld, int n0, int k0, int lane,
                                           uint32_t (&b)[2][2]) {
  uint32_t q[4];
  ldsm_x4<false>(M, ld, n0, k0, lane, q);
  b[0][0] = q[0];
  b[0][1] = q[2];
  b[1][0] = q[1];
  b[1][1] = q[3];
}

// ... of a [k][n] tile (.trans: W [out][in] in a backward product, or the
// sample-major activations of a weight gradient)
__device__ __forceinline__ void frag_b2_kn(const uint16_t* M, int ld, int k0, int n0, int lane,
                                           uint32_t (&b)[2][2]) {
  uint32_t q[4];
  ldsm_x4<true>(M, ld, k0, n0, lane, q);
  b[0][0] = q[0];
  b[0][1] = q[1];
  b[1][0] = q[2];
  b[1][1] = q[3];
}

// one n8 block of a [n][k] tile (plain) or a [k][n] tile (.trans)
__device__ __forceinline__ void frag_b_nk(const uint16_t* M, int ld, int n0, int k0, int lane,
                                          uint32_t (&b)[2]) {
  ldsm_x2<false>(M, ld, n0, k0, lane, b);
}

__device__ __forceinline__ void frag_b_kn(const uint16_t* M, int ld, int k0, int n0, int lane,
                                          uint32_t (&b)[2]) {
  ldsm_x2<true>(M, ld, k0, n0, lane, b);
}

// ---- the warp's sample-major chain ------------------------------------------------

// acc[NB] = A W^T (TB false: W [n][k], a forward product) or A W (TB true: W
// [k][n], a backward product): the warp's 16 samples as A, a_of(kt, a) giving
// k16 step kt's fragment, against NB n8 blocks of the bf16 tile W (ld a row)
template <int NB, int KT, bool TB, class AF>
__device__ __forceinline__ void warp_dense_f(AF a_of, const uint16_t* W, int ld, int lane,
                                             float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a[4];
    a_of(kt, a);
#pragma unroll
    for (int nb = 0; nb + 1 < NB; nb += 2) {
      uint32_t b[2][2];
      if constexpr (TB) {
        frag_b2_kn(W, ld, 16 * kt, 8 * nb, lane, b);
      } else {
        frag_b2_nk(W, ld, 8 * nb, 16 * kt, lane, b);
      }
      mma_bf16(acc[nb], a, b[0]);
      mma_bf16(acc[nb + 1], a, b[1]);
    }
    if constexpr (NB % 2 == 1) {
      uint32_t b[2];
      if constexpr (TB) {
        frag_b_kn(W, ld, 16 * kt, 8 * (NB - 1), lane, b);
      } else {
        frag_b_nk(W, ld, 8 * (NB - 1), 16 * kt, lane, b);
      }
      mma_bf16(acc[NB - 1], a, b);
    }
  }
}

// ... with the A fragments in registers, a[KT]
template <int NB, int KT, bool TB>
__device__ __forceinline__ void warp_dense(const uint32_t (&a)[KT][4], const uint16_t* W, int ld,
                                           int lane, float (&acc)[NB][4]) {
  warp_dense_f<NB, KT, TB>(
      [&](int kt, uint32_t (&f)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = a[kt][i];
      },
      W, ld, lane, acc);
}

// the A fragments of the next product from the float32 values v[NB] (lane 4 g
// + t: rows g, g + 8, columns 8 nb + 2t, + 1), rounded: k16 step j takes the
// n8 blocks 2j and 2j + 1 (zeros past NB)
template <int NB, int KT>
__device__ __forceinline__ void pack_a(const float (&v)[NB][4], uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    a[j][0] = 2 * j < NB ? pack_bf16(v[2 * j][0], v[2 * j][1]) : 0u;
    a[j][1] = 2 * j < NB ? pack_bf16(v[2 * j][2], v[2 * j][3]) : 0u;
    a[j][2] = 2 * j + 1 < NB ? pack_bf16(v[2 * j + 1][0], v[2 * j + 1][1]) : 0u;
    a[j][3] = 2 * j + 1 < NB ? pack_bf16(v[2 * j + 1][2], v[2 * j + 1][3]) : 0u;
  }
}

// the packed fragments a[KT] into rows s0 .. s0 + 15 of a sample-major bf16
// tile T (ld a row): one 32-bit store per pair
template <int KT>
__device__ __forceinline__ void store_a(const uint32_t (&a)[KT][4], uint16_t* T, int ld, int s0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    uint16_t* p = T + (s0 + g) * ld + 16 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = a[j][0];
    *reinterpret_cast<uint32_t*>(p + 8 * ld) = a[j][1];
    *reinterpret_cast<uint32_t*>(p + 8) = a[j][2];
    *reinterpret_cast<uint32_t*>(p + 8 * ld + 8) = a[j][3];
  }
}

// the (16 x 8) tile acc at (m0, n0) into dst [n_rows][n_cols] where it lies in
// the matrix (transposed: dst [n_cols][n_rows]; ADD: added to what dst holds)
template <bool TRANSPOSED = false, bool ADD = false>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, int n_rows, int n_cols, int m0,
                                           int n0, int lane, const float (&acc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (lane >> 2) + 8 * (i >> 1), n = n0 + 2 * (lane & 3) + (i & 1);
    if (m < n_rows && n < n_cols) {
      float* p = dst + (TRANSPOSED ? n * n_rows + m : m * n_cols + n);
      *p = ADD ? *p + acc[i] : acc[i];
    }
  }
}

}  // namespace

// The bf16 fragment helpers of the tensor-core kernels (mpe_update_bf16.cu:
// K6-bf16, K7-bf16; mpe_maddpg_bf16.cu: K9-bf16): float32 -> bf16 rounding
// (round to nearest even), mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (HMMA), the A and B fragments of a bf16 weight matrix and of float32
// activation tiles, and the warp-level products built from them.
//
// The including file defines, in an anonymous namespace before it includes
// this header: LD, the row stride in floats of its float32 tiles; TS, the
// samples of a tile (the depth warp_outer sums over); WARPS, the warps of a
// CTA. On the host (tests/_csrc_host.py) MPE_HOST_MMA names the emulated mma.

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

// the A fragment of rows m0 .., columns k0 .. of a bf16 matrix [.][L]
template <int L>
__device__ __forceinline__ void frag_a_bf16(const uint16_t* __restrict__ W, int m0, int k0,
                                            int lane, uint32_t (&a)[4]) {
  const uint16_t* p = W + (m0 + (lane >> 2)) * L + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * L);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * L + 8);
}

// the B fragment of rows k0 .. (the contraction) and columns n0 .. of a
// float32 tile [k][LD], rounded
__device__ __forceinline__ void frag_b_rows(const float* __restrict__ T, int k0, int n0, int lane,
                                            uint32_t (&b)[2]) {
  const float* p = T + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  b[0] = pack_bf16(p[0], p[LD]);
  b[1] = pack_bf16(p[8 * LD], p[9 * LD]);
}

__device__ __forceinline__ uint32_t pack_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}

// the fragments of P Q^T over samples s0 .. s0 + 15 (the contraction runs
// along the rows of the float32 tiles P [m][LD] and Q [n][LD]), rounded
__device__ __forceinline__ void frag_a_cols(const float* __restrict__ P, int m0, int s0, int lane,
                                            uint32_t (&a)[4]) {
  const float* p = P + (m0 + (lane >> 2)) * LD + s0 + 2 * (lane & 3);
  a[0] = pack_pair(p);
  a[1] = pack_pair(p + 8 * LD);
  a[2] = pack_pair(p + 8);
  a[3] = pack_pair(p + 8 * LD + 8);
}

__device__ __forceinline__ void frag_b_cols(const float* __restrict__ Q, int s0, int n0, int lane,
                                            uint32_t (&b)[2]) {
  const float* p = Q + (n0 + (lane >> 2)) * LD + s0 + 2 * (lane & 3);
  b[0] = pack_pair(p);
  b[1] = pack_pair(p + 8);
}

// The warp's columns n0 .. n0 + 7 of D = W B: MT row blocks of W [MT*16][L]
// (bf16), KT steps of 16 rows of the float32 tile B; then epi(m, n, v) for
// each of the thread's entries (rows g, g + 8 of each block, columns 2t, 2t+1)
template <int MT, int KT, int L, class Epi>
__device__ __forceinline__ void warp_product(const uint16_t* __restrict__ W,
                                             const float* __restrict__ B, int n0, int lane,
                                             Epi epi) {
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t b[2];
    frag_b_rows(B, 16 * kt, n0, lane, b);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      frag_a_bf16<L>(W, 16 * mt, 16 * kt, lane, a);
      mma_bf16(acc[mt], a, b);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      epi(16 * mt + (lane >> 2) + 8 * (i >> 1), n0 + 2 * (lane & 3) + (i & 1), acc[mt][i], mt,
          i >> 1);
}

// acc[j] += the tile's share of P Q^T for the output tiles j WARPS + warp of
// the NTM row blocks x (NT / NTM) column blocks, summed over the TS samples
template <int NT, int NTM, int J>
__device__ __forceinline__ void warp_outer(const float* __restrict__ P, const float* __restrict__ Q,
                                           int warp, int lane, float (&acc)[J][4]) {
  constexpr int NC = NT / NTM;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int tile = j * WARPS + warp;
    if (tile < NT) {                                    // the same in the whole warp
      const int m0 = 16 * (tile / NC), n0 = 8 * (tile % NC);
#pragma unroll
      for (int s0 = 0; s0 < TS; s0 += 16) {
        uint32_t a[4], b[2];
        frag_a_cols(P, m0, s0, lane, a);
        frag_b_cols(Q, s0, n0, lane, b);
        mma_bf16(acc[j], a, b);
      }
    }
  }
}

// the tile's (16 x 8) output entries of acc[j] that lie in the n_rows x n_cols
// matrix at dst (row-major), as warp_outer deals them
template <int NT, int NTM, int J>
__device__ __forceinline__ void store_outer(float* __restrict__ dst, int n_rows, int n_cols,
                                            int warp, int lane, const float (&acc)[J][4]) {
  constexpr int NC = NT / NTM;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int tile = j * WARPS + warp;
    if (tile >= NT) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = 16 * (tile / NC) + (lane >> 2) + 8 * (i >> 1);
      const int n = 8 * (tile % NC) + 2 * (lane & 3) + (i & 1);
      if (m < n_rows && n < n_cols) dst[m * n_cols + n] = acc[j][i];
    }
  }
}

}  // namespace

// The streamed bf16 products of the wide tensor-core kernels (hidden 128 and
// 256): ppo_update_bf16_wide_kernel (mpe_update_bf16.cu: K6-bf16, K7-bf16),
// written so that K9-bf16's wide kernels can share them. It is the bf16
// counterpart of wide_stream.cuh.
//
// At those widths a net's bf16 weights (w2 alone 128 KB at 256) do not fit a
// CTA beside its tiles. So the weights are rounded to bf16 once a call, by a
// small kernel, into a device buffer that the L2 cache holds for every CTA,
// laid out in the order of the mma's B fragments ("fragment-packed"): for
// warp w, k16 step kt and lane 4g + t, the words of the warp's NBW n8 blocks,
// four to a 16-byte piece, the pieces of the 32 lanes side by side. A warp
// owns a block of UW = 8 NBW units (the N side of its products) for a whole
// tile of samples (the M side), so it reads only its own part of each
// operand, and each lane only its own pieces: a lane copies its pieces of the
// next R - 1 k16 steps into its ring in shared memory by cp.async while it
// computes on the current one, and reads back only what it copied itself (no
// barrier, no registers held for the prefetch).
//
// The products are mma.sync m16n8k16 bf16 with float32 sums (bf16_mma.cuh);
// the A fragments come from the caller (ldmatrix from bf16 tiles in shared
// memory).

#pragma once

#include <stdint.h>
#include <string.h>

namespace {

// four words of a lane's piece, one 16-byte load or store
struct alignas(16) Words4 {
  uint32_t x, y, z, w;
};

// 16 bytes from device memory into shared memory, asynchronously where the
// card has cp.async (on the host, at once)
__device__ __forceinline__ void copy16_async(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// until at most `pending` of the thread's newest groups are in flight; the
// memory clobber keeps the ring's loads after it
template <int pending>
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
#endif
}

// The fragment-packed B operand of a streamed product over N = 8 UW units
// (8 warps) and KT k16 steps, B[k][n] = M(n, k): word e of the buffer holds
// (M(n, k), M(n, k + 1)) rounded to bf16 (the lower k in the low half), with
// e = (((w KT + kt) Q + q) 32 + lane) 4 + i, Q = NBW / 2 pieces a lane,
// n8 block nbl = 2q + (i >> 1), half j = i & 1, n = UW w + 8 nbl + g and k =
// 16 kt + 8 j + 2t (lane = 4g + t): the B fragment b[j] of n8 block nbl.
template <int UW, int KT>
struct PackedB {
  static constexpr int NBW = UW / 8, Q = NBW / 2;
  static_assert(UW % 16 == 0, "a warp's units are whole pairs of n8 blocks");
  static constexpr int WORDS = 8 * KT * Q * 128;      // the whole operand (8 warps)
  static constexpr int WARP_WORDS = KT * Q * 128;     // one warp's part

  template <class MF>
  static __device__ __forceinline__ uint32_t word(int e, MF m) {
    const int i = e & 3, lane = (e >> 2) & 31;
    int r = e >> 7;
    const int q = r % Q;
    r /= Q;
    const int kt = r % KT, w = r / KT;
    const int g = lane >> 2, t = lane & 3;
    const int n = UW * w + 8 * (2 * q + (i >> 1)) + g, k = 16 * kt + 8 * (i & 1) + 2 * t;
    return pack_bf16(m(n, k), m(n, k + 1));
  }
};

// A lane's ring of R k16 steps of a streamed operand in shared memory: step
// slot r of warp w, piece q at ring + (((w R + r) Q + q) 32 + lane) 4 words
template <int NBW, int R>
struct BRing {
  static constexpr int Q = NBW / 2;
  static constexpr int WARP_WORDS = R * Q * 128;      // a warp's ring
  static_assert(R >= 2, "the ring holds the step computed on and the next one");

  // acc[mt][nb] = sum over the KT k16 steps of A(mt, kt) B(kt, nb): the warp's
  // MT m16 row blocks (a_of(mt, kt, a) gives A's fragment) against its NBW n8
  // blocks, streamed from src (the warp's part of a PackedB) through ring (the
  // warp's ring), R - 1 steps ahead of the one computed on
  template <int MT, int KT, class AF>
  static __device__ __forceinline__ void product(AF a_of, const uint32_t* __restrict__ src,
                                                 uint32_t* ring, int lane,
                                                 float (&acc)[MT][NBW][4]) {
    auto fetch = [&](int kt) {
      if (kt < KT) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          copy16_async(ring + (((kt % R) * Q + q) * 32 + lane) * 4,
                       src + ((kt * Q + q) * 32 + lane) * 4);
      }
      async_commit();                                  // a group a step, empty past KT
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nb][i] = 0.0f;
#pragma unroll
    for (int s = 0; s < R - 1; ++s) fetch(s);
#pragma unroll 1
    for (int kt = 0; kt < KT; ++kt) {
      async_wait<R - 2>();                             // step kt has landed
      uint32_t b[NBW][2];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const Words4 v =
            *reinterpret_cast<const Words4*>(ring + (((kt % R) * Q + q) * 32 + lane) * 4);
        b[2 * q][0] = v.x;
        b[2 * q][1] = v.y;
        b[2 * q + 1][0] = v.z;
        b[2 * q + 1][1] = v.w;
      }
      fetch(kt + R - 1);                               // into the slot read a step ago
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        a_of(mt, kt, a);
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb) mma_bf16(acc[mt][nb], a, b[nb]);
      }
    }
  }
};

// part[m ldp + n] += sum over the tile's KS k16 steps of samples of G^T X for
// the warp's MTW m16 row blocks from m0 and the n8 column blocks below NC
// (entries n < n_cols stored): ga(mt, ks, a) gives G^T's A fragment, xb2(nb,
// ks, b) the B fragments of column blocks nb and nb + 1. NG column blocks at a
// time (even), each group's entries read before its products; one lane owns
// each entry, so the add needs no atomics. The A fragments are loaded once.
template <int MTW, int KS, int NC, int NG, class GA, class XB>
__device__ __forceinline__ void add_outer(GA ga, XB xb2, float* __restrict__ part, int ldp,
                                          int n_cols, int m0, int lane) {
  static_assert(NG % 2 == 0, "column blocks in pairs");
  uint32_t a[MTW][KS][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ga(mt, ks, a[mt][ks]);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int c0 = 0; c0 < NC; c0 += NG) {
    float old[MTW][NG][4], acc[MTW][NG][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nb = 0; nb < NG; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + 16 * mt + g + 8 * (i >> 1), n = 8 * (c0 + nb) + 2 * t + (i & 1);
          old[mt][nb][i] = n < n_cols ? part[m * ldp + n] : 0.0f;
          acc[mt][nb][i] = 0.0f;
        }
#pragma unroll
    for (int nb = 0; nb < NG; nb += 2) {
      if (c0 + nb < NC) {                              // the same in the whole warp
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[2][2];
          xb2(c0 + nb, ks, b);
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt) {
            mma_bf16(acc[mt][nb], a[mt][ks], b[0]);
            mma_bf16(acc[mt][nb + 1], a[mt][ks], b[1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nb = 0; nb < NG; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + 16 * mt + g + 8 * (i >> 1), n = 8 * (c0 + nb) + 2 * t + (i & 1);
          if (n < n_cols) part[m * ldp + n] = old[mt][nb][i] + acc[mt][nb][i];
        }
  }
}

}  // namespace

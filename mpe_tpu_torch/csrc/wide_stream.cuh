// The streamed products and weight-gradient sums of K9's wide kernels (hidden
// 128 and 256, mpe_maddpg.cu). At those widths neither a net's weights nor its
// weight gradients fit a CTA, so the kernels keep the weights in device
// memory (the L2 cache holds them for every CTA) and stream each product's
// weights through shared memory, and add each tile's weight gradients into
// the CTA's partial in device memory, one thread owning each entry, for a
// reduce kernel to sum the partials in a fixed order.
//
// WideRing<THREADS, H, KB, S>: every product of a layer with H units streams
// its weights, as [in][out] rows (a forward product reads the layer's
// transposed copy, the backward one w2 itself), by the Tensor Memory
// Accelerator: one cp.async.bulk a slice of KB input rows into a ring of S
// stages, every stage with a "full" mbarrier (the copy landed) and an "empty"
// one (every warp has read it). Warp 0 keeps S - 1 slices in flight; a warp
// waits only on the barrier of the slice it needs, and no weight passes
// through registers. The threads own register tiles of RU units x RC
// columns; each thread's sums run over the inputs in order from the first
// product, each product rounded before it is added (-fmad=false), so K9's
// forward sums stay the plain version's.
//
// WideStream<THREADS, TS, LD, H>::outer: the weight-gradient sums of a tile
// of TS samples whose rows [.][LD] lie in shared memory, added into the
// CTA's partial.

#pragma once

#include <stdint.h>

namespace {

// ---- mbarriers and bulk copies (sm_90); the host stand-in's in tests/_csrc_host.py ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
#if defined(__CUDA_ARCH__)
  return (uint32_t)__cvta_generic_to_shared(p);
#else
  return 0u;
#endif
}

// an mbarrier whose phase completes after `count` arrivals and the bytes expected
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
#elif !defined(__CUDACC__)
  host_mbar_init(bar, count);
#endif
}

// the initialised barriers made visible to the copy engine (then a __syncthreads)
__device__ __forceinline__ void mbar_fence_init() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
#elif !defined(__CUDACC__)
  host_mbar_arrive(bar, 0);
#endif
}

// one arrival that also expects `bytes` more of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
#elif !defined(__CUDACC__)
  host_mbar_arrive(bar, (int)bytes);
#endif
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#elif !defined(__CUDACC__)
  host_mbar_wait(bar, parity);
#endif
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory by the copy engine, counted on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
#elif !defined(__CUDACC__)
  host_bulk_load(dst, src, bytes, bar);
#endif
}

template <int THREADS, int H, int KB, int S>
struct WideRing {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int STAGE = KB * H;           // floats of a stage: KB rows of H
  static constexpr int FLOATS = S * STAGE;       // the stages, 16-byte aligned
  static constexpr int BAR_FLOATS = 4 * S;       // the 2 S barriers (full, then empty)

  float* buf;
  uint64_t* full;
  uint64_t* empty;
  uint32_t count;                                // slices consumed so far (the same in every thread)

  // bars: BAR_FLOATS floats, ring: FLOATS; thread 0 initialises the barriers,
  // which the caller's next __syncthreads publishes
  __device__ __forceinline__ WideRing(float* bars, float* ring)
      : buf(ring), full(reinterpret_cast<uint64_t*>(bars)), empty(full + S), count(0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, WARPS);
      }
      mbar_fence_init();
    }
  }

  // warp 0: rows j KB .. of w [K][H] (one copy, the last slice's K % KB rows
  // where K is no multiple of KB) into the stage of global slice g, once every
  // warp has released that stage's slice g - S
  template <int K>
  __device__ __forceinline__ void issue(const float* __restrict__ w, int j, uint32_t g) {
    const int st = (int)(g % S);
    const uint32_t bytes =
        (uint32_t)((K - j * KB < KB ? K - j * KB : KB) * H) * (uint32_t)sizeof(float);
    if (g >= (uint32_t)S) mbar_wait(empty + st, ((g / S) - 1) & 1);
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive_expect(full + st, bytes);
      bulk_load(buf + st * STAGE, w + (size_t)j * STAGE, bytes, full + st);
    }
    __syncwarp();
  }

  // acc[r][e] = sum over the K inputs k, in order, of w[k H + u] X[k][c],
  // from -0, for the thread's units u = RU ug + r and columns c = RC cg + e:
  // the threads form THREADS / CGN unit groups (ug) x CGN column groups (cg =
  // tid % CGN). w is a layer's weights as [in][out] rows (a forward product's
  // transposed copy, or w2 itself in the backward, where its rows are the
  // inputs), 16-byte aligned; X [K][LDX] in shared memory
  template <int K, int CGN, int RC, int LDX, int RU>
  __device__ __forceinline__ void product(const float* __restrict__ w, const float* X,
                                          float (&acc)[RU][RC]) {
    constexpr int NK = (K + KB - 1) / KB;        // slices of this product
    static_assert(KB % 4 == 0 && H % 4 == 0, "whole float4 rows");
    static_assert((THREADS / CGN) * RU == H && RC % 4 == 0 && RU % 4 == 0,
                  "register tiles cover H units");
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cg = tid % CGN, u0 = RU * (tid / CGN);
#pragma unroll
    for (int r = 0; r < RU; ++r)
#pragma unroll
      for (int e = 0; e < RC; ++e) acc[r][e] = -0.0f;
    const uint32_t g0 = count;
    if (warp == 0)
      for (int j = 0; j < S - 1 && j < NK; ++j) issue<K>(w, j, g0 + j);
    const float* xc = X + RC * cg;
#pragma unroll 1
    for (int j = 0; j < NK; ++j) {
      const uint32_t g = g0 + j;
      if (warp == 0 && j + S - 1 < NK) issue<K>(w, j + S - 1, g + S - 1);
      mbar_wait(full + g % S, (g / S) & 1);
      const float* sl = buf + (g % S) * STAGE + u0;
      const float* x = xc + j * KB * LDX;
      const int kn = K % KB == 0 || j < NK - 1 ? KB : K % KB;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        float wv[RU], xv[RC];
#pragma unroll
        for (int r = 0; r < RU; r += 4) {
          const float4 q = *reinterpret_cast<const float4*>(sl + k * H + r);
          wv[r] = q.x, wv[r + 1] = q.y, wv[r + 2] = q.z, wv[r + 3] = q.w;
        }
#pragma unroll
        for (int e = 0; e < RC; e += 4) {
          const float4 q = *reinterpret_cast<const float4*>(x + k * LDX + e);
          xv[e] = q.x, xv[e + 1] = q.y, xv[e + 2] = q.z, xv[e + 3] = q.w;
        }
#pragma unroll
        for (int r = 0; r < RU; ++r)
#pragma unroll
          for (int e = 0; e < RC; ++e) acc[r][e] = acc[r][e] + wv[r] * xv[e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + g % S);
    }
    count = g0 + NK;
  }
};

template <int THREADS, int TS, int LD, int H>
struct WideStream {
  // part[m ldp + n] (+)= sum over the tile's samples s, in order, of P[m][s]
  // Q[n][s] for the H rows m of P and the NQ rows n of Q, both [.][LD] in
  // shared memory, and db[m] (+)= sum_s P[m][s]: part and db in device memory
  // (the CTA's partial; one thread owns each entry), written by the CTA's
  // first tile (`first`) and added to by the later ones. A warp takes 16 rows
  // x 8 RN columns of a pass, its 8 column lanes consecutive columns (one
  // 32-byte run of part per row), each thread 4 rows (4 apart, so that a
  // warp's four rows of one float4 load lie in other banks) x RN columns in
  // registers, per four samples 4 + RN float4s for 16 RN multiply-adds; the
  // warps stand one above another. A column past NQ reads row NQ - 1 and is
  // not stored. The partial's entries are read before the sums, so
  // their latency hides behind them.
  template <int NQ>
  static __device__ __forceinline__ void outer(const float* P, const float* Q, float* part,
                                               int ldp, float* db, bool first) {
    constexpr int RN = NQ >= 32 ? 4 : (NQ + 7) / 8;
    constexpr int RB = 16 * (THREADS / 32), CB = 8 * RN;
    static_assert(H % RB == 0, "a pass's rows divide H");
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = 16 * warp + (lane >> 3), c0 = lane & 7;
    for (int mb = 0; mb < H; mb += RB) {
      for (int nb = 0; nb < NQ; nb += CB) {
        float acc[4][RN], old[4][RN];
        int rq[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = nb + c0 + 8 * j;
          rq[j] = (n < NQ ? n : NQ - 1) * LD;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j] = 0.0f;
            old[i][j] = !first && n < NQ ? part[(size_t)(mb + r0 + 4 * i) * ldp + n] : 0.0f;
          }
        }
#pragma unroll 2
        for (int s = 0; s < TS; s += 4) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = *reinterpret_cast<const float4*>(P + (mb + r0 + 4 * i) * LD + s);
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(Q + rq[j] + s);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] = fmaf(pv[i].x, qv.x, acc[i][j]);
              acc[i][j] = fmaf(pv[i].y, qv.y, acc[i][j]);
              acc[i][j] = fmaf(pv[i].z, qv.z, acc[i][j]);
              acc[i][j] = fmaf(pv[i].w, qv.w, acc[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int n = nb + c0 + 8 * j;
            if (n < NQ) part[(size_t)(mb + r0 + 4 * i) * ldp + n] = old[i][j] + acc[i][j];
          }
      }
    }
    for (int m = tid; m < H; m += THREADS) {
      float b = 0.0f;
      for (int s = 0; s < TS; s += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(P + m * LD + s);
        b = (((b + pv.x) + pv.y) + pv.z) + pv.w;
      }
      db[m] = first ? b : db[m] + b;
    }
  }
};

}  // namespace

// The 3xTF32 tensor-core products and the thread-block-cluster helpers of
// the wide float32 update kernel (mpe_update.cu: K6, K7 at hidden 128 and 256).
//
// 3xTF32: a float32 x splits into hi = cvt.rna.tf32.f32(x) and lo =
// cvt.rna.tf32.f32(x - hi) (x - hi is exact), and a product a b becomes
// hi(a) hi(b) + hi(a) lo(b) + lo(a) hi(b) on the tensor cores, summed in
// float32: about 2^-21 relative error a product (the dropped lo lo and lo's
// own rounding), where one TF32 product keeps three decimal digits. The
// tensor cores' float32 sums do not round to nearest, so a sum carried over
// many calls is kept outside the accumulators (mpe_update.cu::add_tile). The product is mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32 (HMMA): its fragments are float32 words a lane loads itself, so
// every operand may sit in shared memory in either orientation (wgmma takes
// B from shared memory in its own swizzled layouts only, and its m64 rows
// would make each product's warp tiles four times taller than the kernel's
// 64-unit blocks allow).
//
// The fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32), lane
// 4 g + t: a[0] = A[g][t], a[1] = A[g+8][t], a[2] = A[g][t+4], a[3] =
// A[g+8][t+4]; b[0] = B[t][g], b[1] = B[t+4][g]; d[0] = D[g][2t], d[1] =
// D[g][2t+1], d[2] = D[g+8][2t], d[3] = D[g+8][2t+1]. A product may take its
// k8 step's columns in another order (k = t as 2t, t + 4 as 2t + 1) where
// that spreads a load over the banks: both operands read the same order.
//
// Clusters: the CTAs of a cluster (barrier.cluster, mapa) write into each
// other's shared memory. In a host build (tests/_csrc_host.py, no __CUDACC__)
// the emulated mma, cvt, split barrier and per-block shared memory stand in;
// nvcc's host pass sees bodies that are never called.

#pragma once

#include <stdint.h>

namespace {

// cvt.rna.tf32.f32: round to nearest, ties away from zero, low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
#if defined(__CUDA_ARCH__)
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
#elif defined(__CUDACC__)
  return 0u;                       // nvcc's host pass, never called
#else
  return host_cvt_rna_tf32(x);
#endif
}

// d += A B over one m16n8k8 tile, tf32 operands, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm(                             // not volatile: the compiler may interleave independent ones
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif !defined(__CUDACC__)
  host_mma_m16n8k8_tf32(d, a, b);
#endif
}

// x = hi + lo, each a tf32
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// acc[mt][nb] += sum over the KS k8 steps of A(mt, ks) B(ks, nb) in 3xTF32: the
// warp's MT m16 row blocks against its NB n8 column blocks; af(mt, ks, a) gives
// A's fragment as float32, bf(ks, nb, b) B's. Each fragment is split once a
// step. An mma waits for the one before it on the same accumulator, so a step
// issues the MT x NB lo hi products, then the hi hi, then the hi lo ones. SEP:
// the hi hi sums and the small ones in separate accumulators, added at the end
// (twice the chains between dependent mma, twice the registers; for products
// whose accumulators live only through the call)
template <int MT, int NB, int KS, bool SEP = false, class AF, class BF>
__device__ __forceinline__ void warp_mma3(AF af, BF bf, float (&acc)[MT][NB][4]) {
  float small[SEP ? MT : 1][SEP ? NB : 1][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[MT][4], al[MT][4], bh[NB][2], bl[NB][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float a[4];
      af(mt, ks, a);
      split_tf32(a, ah[mt], al[mt]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      float b[2];
      bf(ks, nb, b);
      split_tf32(b, bh[nb], bl[nb]);
    }
    auto lo_acc = [&](int mt, int nb) -> float (&)[4] {
      if constexpr (SEP) {
        return small[mt][nb];
      } else {
        return acc[mt][nb];
      }
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(lo_acc(mt, nb), al[mt], bh[nb]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(acc[mt][nb], ah[mt], bh[nb]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(lo_acc(mt, nb), ah[mt], bl[nb]);
  }
  if constexpr (SEP) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nb][i] = acc[mt][nb][i] + small[mt][nb][i];
  }
}

// ---- thread-block clusters ---------------------------------------------------------

// this CTA's rank in its cluster
__device__ __forceinline__ unsigned cluster_rank() {
#if defined(__CUDA_ARCH__)
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
#elif defined(__CUDACC__)
  return 0u;
#else
  return host_cluster_rank();
#endif
}

// the split cluster barrier: every thread of every CTA of the cluster
// arrives (releasing its earlier writes, shared memory of other CTAs
// included), then waits until all have (acquiring theirs)
__device__ __forceinline__ void cluster_arrive() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  host_cluster_barrier.arrive();
#endif
}

__device__ __forceinline__ void cluster_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#elif !defined(__CUDACC__)
  host_cluster_barrier.wait();
#endif
}

// the dynamic shared memory of this CTA (smem: the kernel's extern array)
__device__ __forceinline__ float* cta_smem(float* smem) {
#if defined(__CUDA_ARCH__) || defined(__CUDACC__)
  return smem;
#else
  (void)smem;
  return host_block_smem();
#endif
}

// the address p of this CTA's shared memory in the CTA of rank `rank`
template <class T>
__device__ __forceinline__ T* map_rank(T* p, unsigned rank) {
#if defined(__CUDA_ARCH__)
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
#elif defined(__CUDACC__)
  return p;
#else
  return host_map_rank(p, rank);
#endif
}

}  // namespace

// The streamed products and weight-gradient sums of the wide kernels (hidden
// 128 and 256): ppo_update_wide_kernel (mpe_update.cu: K6, K7) and K9's wide
// kernels (mpe_maddpg.cu). At those widths neither a net's weights nor its
// weight gradients fit a CTA, so both kernels keep the weights in device
// memory (the L2 cache holds them for every CTA) and stream each product's
// weights through two shared slice buffers, and both add each tile's weight
// gradients into the CTA's partial in device memory, one thread owning each
// entry, for a reduce kernel to sum the partials in a fixed order.
//
// WideStream<THREADS, TS, LD, H, UB, KB, SLD, FUSED, CG>: a CTA of THREADS
// threads works on a tile of TS samples, the sample columns of rows [.][LD] in
// shared memory; the layers have H units, taken in unit blocks of UB; a weight
// slice holds KB inputs x UB units, its rows SLD apart. FUSED: a product's
// sums are fused multiply-adds from +0 (K6, K7); otherwise each product is
// rounded before it is added, from -0 (-0 + x is x: the first product), so
// that K9's forward sums are the plain version's. CG: the column groups of
// warps in a weight-gradient pass.

#pragma once

namespace {

template <int THREADS, int TS, int LD, int H, int UB, int KB, int SLD, bool FUSED, int CG>
struct WideStream {
  static constexpr int SLICES = 2 * KB * SLD;   // the two slice buffers (floats)

  // C(u, s) = epi(u, s, sum over the K inputs k, in order, of A(k, u) B[k][s])
  // for the H units u and the TS samples s. A in device memory: A(k, u) =
  // a[u K + k] (TRANS: a layer's w [H, K] in the forward) or a[k H + u] (w
  // [K, H] in the backward); B [K][LD] in shared memory. Unit blocks of UB
  // units, each over slices of KB inputs that the CTA fetches into registers
  // while it computes on the slice before, then stores into the other of the
  // two slice buffers: one barrier a slice. Thread t owns units 4 (t / (TS /
  // 4)) .. + 3 of the block and samples 4 (t % (TS / 4)) .. + 3. B's rows past
  // K are not read. epi stores the value; it may read C where it writes. Ends
  // at a barrier.
  template <int K, bool TRANS, class Epi>
  static __device__ __forceinline__ void product(const float* __restrict__ a, const float* B,
                                                 float* slices, Epi epi) {
    static_assert(UB * TS == 16 * THREADS && H % UB == 0 && KB * UB % THREADS == 0,
                  "a unit block's 4 x 4 register tiles and a slice's loads cover the CTA");
    constexpr int NS = (K + KB - 1) / KB, NQ = (H / UB) * NS, PER = KB * UB / THREADS;
    const int tid = threadIdx.x;
    const int m0 = 4 * (tid / (TS / 4)), s0 = 4 * (tid % (TS / 4));
    float pre[PER];
    // the slice element of piece p: TRANS walks a unit's inputs first, so a
    // warp reads runs of KB floats; otherwise an input's units
    auto piece = [&](int p, int& kk, int& mm) {
      const int e = tid + THREADS * p;
      kk = TRANS ? e % KB : e / UB;
      mm = TRANS ? e / KB : e % UB;
    };
    auto fetch = [&](int q) {
      const int u0 = (q / NS) * UB, k0 = (q % NS) * KB;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        int kk, mm;
        piece(p, kk, mm);
        const int k = k0 + kk;
        pre[p] = k >= K ? 0.0f : TRANS ? a[(size_t)(u0 + mm) * K + k] : a[(size_t)k * H + u0 + mm];
      }
    };
    auto put = [&](float* buf) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        int kk, mm;
        piece(p, kk, mm);
        buf[kk * SLD + mm] = pre[p];
      }
    };
    fetch(0);
    put(slices);
    __syncthreads();
    float acc[4][4];
    for (int q = 0; q < NQ; ++q) {
      const int j = q % NS;
      if (q + 1 < NQ) fetch(q + 1);
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = FUSED ? 0.0f : -0.0f;
      }
      const float* sl = slices + (q & 1) * KB * SLD;
      const float* b = B + j * KB * LD;
      auto step = [&](int k) {
        const float4 av = *reinterpret_cast<const float4*>(sl + k * SLD + m0);
        const float4 bv = *reinterpret_cast<const float4*>(b + k * LD + s0);
        const float ai[4] = {av.x, av.y, av.z, av.w}, be[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][e] = FUSED ? fmaf(ai[i], be[e], acc[i][e]) : acc[i][e] + ai[i] * be[e];
      };
      if (K % KB == 0 || j < NS - 1) {                // a whole slice, its count known
#pragma unroll 4
        for (int k = 0; k < KB; ++k) step(k);
      } else {                                        // the last slice's K % KB inputs
#pragma unroll 4
        for (int k = 0; k < K % KB; ++k) step(k);
      }
      if (j == NS - 1) {
        const int u0 = (q / NS) * UB;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) epi(u0 + m0 + i, s0 + e, acc[i][e]);
      }
      if (q + 1 < NQ) put(slices + ((q + 1) & 1) * KB * SLD);
      __syncthreads();
    }
  }

  // part[m ldp + n] (+)= sum over the tile's samples s, in order, of P[m][s]
  // Q[n][s] for the H rows m of P and the NQ rows n of Q, both [.][LD] in
  // shared memory, and db[m] (+)= sum_s P[m][s]: part and db in device memory
  // (the CTA's partial; one thread owns each entry), written by the CTA's
  // first tile (`first`) and added to by the later ones. A warp takes 16 rows
  // x 8 RN columns of a pass, its 8 column lanes consecutive columns (one
  // 32-byte run of part per row), each thread 4 rows x RN columns in
  // registers, per four samples 4 + RN float4s for 16 RN multiply-adds; the
  // warps stand CG abreast over the columns. A column past NQ reads row NQ - 1
  // and is not stored. The partial's entries are read before the sums, so
  // their latency hides behind them.
  template <int NQ>
  static __device__ __forceinline__ void outer(const float* P, const float* Q, float* part,
                                               int ldp, float* db, bool first) {
    constexpr int RN = NQ >= 32 * CG ? 4 : (NQ + 8 * CG - 1) / (8 * CG);
    constexpr int RB = 16 * (THREADS / 32) / CG, CB = 8 * RN * CG;
    static_assert(H % RB == 0, "a pass's rows divide H");
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int r0 = 16 * (warp / CG) + 4 * (lane >> 3), c0 = 8 * RN * (warp % CG) + (lane & 7);
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
            old[i][j] = !first && n < NQ ? part[(size_t)(mb + r0 + i) * ldp + n] : 0.0f;
          }
        }
#pragma unroll 2
        for (int s = 0; s < TS; s += 4) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = *reinterpret_cast<const float4*>(P + (mb + r0 + i) * LD + s);
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
            if (n < NQ) part[(size_t)(mb + r0 + i) * ldp + n] = old[i][j] + acc[i][j];
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

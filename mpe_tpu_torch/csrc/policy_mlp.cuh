// The actor MLP OW-H-H-KP of the policy kernels (mpe_policy.cu: K4, K5;
// mpe_maddpg.cu: K8), OW = the scenario's obs width, KP = 5 + dim_c logits
// when it speaks, else 5, run as CTA-wide products over a tile of env lanes;
// and MlpLayout, the kernel layout of one actor that K9 (mpe_maddpg.cu) reads
// its gradients in. The hidden width H is a compile-time constant,
// -DMPE_HIDDEN=H (64 by default): ops/_build.py builds one library per
// width, and each source that includes this header asserts the widths it
// takes (mpe_policy.cu: 8-256; mpe_maddpg.cu: 8-64).
//
// The lane tile. A CTA of TILE_THREADS threads owns TL env lanes (a tile).
// Thread l < TL owns lane l: its world state stays in its registers, and it
// writes its agents' obs into the tile's input rows in shared memory. The
// rows are the tile's (agent, lane) pairs, row = agent * TLP + lane, TLP = TL
// rounded up to 4 (a padding row computes on whatever it holds and is never
// read). Every activation is stored [input][row] (rows contiguous, LDX floats
// apart), every weight matrix transposed, [input][unit] (the units of an
// input contiguous). A layer is split into items of 4 rows x 4 units; each
// thread takes items in turn and keeps its item's 16 sums in registers: per
// input, one float4 of weights and one float4 of rows from shared memory feed
// 16 independent multiply-add chains, so the latency of each H-long chain
// hides behind the others and behind the CTA's other warps, where the
// one-thread-per-lane MLP ran one dependent chain at a time.
//
// Rounding. Every (row, unit) sum runs over its inputs in order from the
// first product, then adds the bias, as the plain versions
// (ops/fused_policy.py::_seq_dense) do; with -fmad=false each multiply and add
// rounds on its own, and tanhf is the function PyTorch's CUDA tanh calls, so
// the kernels and their plain versions take the same actions (Gumbel-max turns
// one ulp of a logit into another action). No sum is split or reordered, so no
// tensor cores.

#pragma once

#include "scenario_blocks.cuh"

namespace {

#ifndef MPE_HIDDEN
#define MPE_HIDDEN 64
#endif
constexpr int H = MPE_HIDDEN;    // hidden width
constexpr int HG = H / 4;        // groups of 4 units

// packed weights of one actor in K9's layout (ops/fused_maddpg_update.py::PackedLayout):
// w1 [H,OW], b1 [H], w2 [H,H], b2 [H], w3 [KP,H], b3 [KP]
template <int OW, int KP>
struct MlpLayout {
  static constexpr int W1 = 0, B1 = W1 + H * OW, W2 = B1 + H, B2 = W2 + H * H, W3 = B2 + H,
                       B3 = W3 + KP * H, NW = B3 + KP;
};

// ---- the lane tile (K4, K5, K8) ------------------------------------------------

constexpr int TILE_THREADS = 128;
constexpr int TILE_MAX = 32;                // lanes per tile at most
constexpr size_t SMEM_MAX = 232448;         // a CTA's dynamic shared memory on sm_90

// one actor in the tile kernels' layout (ops/fused_policy.py::_pack_weights,
// ops/fused_maddpg.py::_pack_weights): w1 transposed [OW][H], b1 [H], w2
// transposed [H][H], b2 [H], w3 transposed [H][KP], b3 [KP], padded to a
// multiple of 4 floats (K8's agents follow one another NWP floats apart)
template <int OW, int KP>
struct TileActor {
  static constexpr int W1T = 0, B1 = W1T + OW * H, W2T = B1 + H, B2 = W2T + H * H, W3T = B2 + H,
                       B3 = W3T + H * KP, NW = B3 + KP, NWP = (NW + 3) / 4 * 4;
  static_assert(B1 % 4 == 0 && W2T % 4 == 0 && B2 % 4 == 0, "float4 rows stay 16-byte aligned");
};

// The rows of a tile of TL lanes and A agents: NR = A * TLP rows, LDX floats
// between two inputs' rows. LDX / 4 is odd, so a quarter-warp storing one
// unit's float4 of rows for 8 units hits 8 different bank groups less often.
struct TileRows {
  int tl, tlp, nr, ldx;
};
__host__ __device__ inline TileRows tile_rows(int tl, int agents) {
  const int tlp = (tl + 3) / 4 * 4, nr = agents * tlp;
  return {tl, tlp, nr, (nr / 4) % 2 == 1 ? nr : nr + 4};
}

// Once per kernel: allow it the dynamic shared memory of its largest tile
// (SMEM(tile) is 0 for a tile the kernel does not take); the attribute holds
// for the process
template <auto KERNEL, size_t (*SMEM)(int)>
cudaError_t tile_smem_attr() {
  static const cudaError_t e = [] {
    int top = TILE_MAX;
    while (top > 1 && SMEM(top) == 0) top /= 2;
    return cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM(top));
  }();
  return e;
}

// KERNEL's CTAs of `tile` lanes that one SM of the current card holds at once
// (0 for a tile it does not take), or minus a CUDA error
template <auto KERNEL, size_t (*SMEM)(int)>
int tile_ctas_per_sm(int tile) {
  const size_t smem = SMEM(tile);
  if (smem == 0) return 0;
  int n = 0;
  cudaError_t e = tile_smem_attr<KERNEL, SMEM>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, KERNEL, TILE_THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// n4 float4s from device memory (16-byte aligned) into shared memory
__device__ __forceinline__ void load_float4s(float* dst, const float* __restrict__ src, int n4) {
  const float4* __restrict__ s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d[i] = s[i];
}

// out[u][r] = tanh(sum over the NIN inputs k, in order from the first product,
// of wt[k][u] x[k][r], then + b[u]) for the tile's rows; row r takes the actor
// of its agent, wstride floats further per agent (0: one actor for all). The
// weights may lie in shared or in device memory (generic loads)
template <int NIN>
__device__ __forceinline__ void tile_dense_tanh(const float* wt, const float* b, int wstride,
                                                const float* x, float* out, const TileRows& tr) {
  const int n_items = (tr.nr / 4) * HG;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int r0 = (item / HG) * 4, g0 = (item % HG) * 4;
    const int agent = r0 / tr.tlp;
    const float* w = wt + agent * wstride + g0;
    const float* xr = x + r0;
    float acc[4][4];
    {
      const float4 wv = *reinterpret_cast<const float4*>(w);
      const float4 xv = *reinterpret_cast<const float4*>(xr);
      const float wu[4] = {wv.x, wv.y, wv.z, wv.w}, xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] = wu[u] * xq[q];
    }
#pragma unroll 4
    for (int k = 1; k < NIN; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * H);
      const float4 xv = *reinterpret_cast<const float4*>(xr + k * tr.ldx);
      const float wu[4] = {wv.x, wv.y, wv.z, wv.w}, xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] = acc[q][u] + wu[u] * xq[q];
    }
    const float4 bv = *reinterpret_cast<const float4*>(b + agent * wstride + g0);
    const float bu[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 o;
      o.x = tanhf(acc[0][u] + bu[u]);
      o.y = tanhf(acc[1][u] + bu[u]);
      o.z = tanhf(acc[2][u] + bu[u]);
      o.w = tanhf(acc[3][u] + bu[u]);
      *reinterpret_cast<float4*>(out + (g0 + u) * tr.ldx + r0) = o;
    }
  }
}

// tile_dense_tanh over items of 8 rows x 4 units: two row blocks of 4 share
// each float4 of weights (32 sums a thread), for an actor read from device
// memory (mpe_policy.cu at hidden 128 and 256), where the weight loads set
// the pace. One actor for all rows (no agent stride). A last row block past
// the rows recomputes the block before it and is not stored. Every sum runs
// as in tile_dense_tanh, so the outputs are the same bits.
template <int NIN>
__device__ __forceinline__ void tile_dense_tanh_x2(const float* wt, const float* b,
                                                   const float* x, float* out,
                                                   const TileRows& tr) {
  const int n_pairs = (tr.nr / 4 + 1) / 2;
  const int n_items = n_pairs * HG;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int ra = (item / HG) * 8, g0 = (item % HG) * 4;
    const bool second = ra + 4 < tr.nr;
    const int rb = second ? ra + 4 : ra;
    const float* w = wt + g0;
    float acc[8][4];
    {
      const float4 wv = *reinterpret_cast<const float4*>(w);
      const float4 xa = *reinterpret_cast<const float4*>(x + ra);
      const float4 xb = *reinterpret_cast<const float4*>(x + rb);
      const float wu[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xq[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] = wu[u] * xq[q];
    }
#pragma unroll 4
    for (int k = 1; k < NIN; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * H);
      const float4 xa = *reinterpret_cast<const float4*>(x + ra + k * tr.ldx);
      const float4 xb = *reinterpret_cast<const float4*>(x + rb + k * tr.ldx);
      const float wu[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xq[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[q][u] = acc[q][u] + wu[u] * xq[q];
    }
    const float4 bv = *reinterpret_cast<const float4*>(b + g0);
    const float bu[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !second) break;
      const int r0 = h == 0 ? ra : rb;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 o;
        o.x = tanhf(acc[4 * h + 0][u] + bu[u]);
        o.y = tanhf(acc[4 * h + 1][u] + bu[u]);
        o.z = tanhf(acc[4 * h + 2][u] + bu[u]);
        o.w = tanhf(acc[4 * h + 3][u] + bu[u]);
        *reinterpret_cast<float4*>(out + (g0 + u) * tr.ldx + r0) = o;
      }
    }
  }
}

// z[c][r] = sum over the H units g, in order from the first product, of
// w3t[g][c] h[g][r], then + b3[c]; items of 4 rows x 1 logit
template <int KP>
__device__ __forceinline__ void tile_logits(const float* w3t, const float* b3, int wstride,
                                            const float* h, float* z, const TileRows& tr) {
  const int n_items = (tr.nr / 4) * KP;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int rb = item / KP, c = item - rb * KP, r0 = rb * 4;
    const int agent = r0 / tr.tlp;
    const float* w = w3t + agent * wstride + c;
    const float* hr = h + r0;
    float acc[4];
    {
      const float4 hv = *reinterpret_cast<const float4*>(hr);
      acc[0] = w[0] * hv.x;
      acc[1] = w[0] * hv.y;
      acc[2] = w[0] * hv.z;
      acc[3] = w[0] * hv.w;
    }
#pragma unroll 8
    for (int g = 1; g < H; ++g) {
      const float wg = w[g * KP];
      const float4 hv = *reinterpret_cast<const float4*>(hr + g * tr.ldx);
      acc[0] = acc[0] + wg * hv.x;
      acc[1] = acc[1] + wg * hv.y;
      acc[2] = acc[2] + wg * hv.z;
      acc[3] = acc[3] + wg * hv.w;
    }
    const float bc = b3[agent * wstride + c];
    float4 o;
    o.x = acc[0] + bc;
    o.y = acc[1] + bc;
    o.z = acc[2] + bc;
    o.w = acc[3] + bc;
    *reinterpret_cast<float4*>(z + c * tr.ldx + r0) = o;
  }
}

// the logits [KP][row] of the tile's rows: the actor (or, wstride apart, one
// per agent) at w in TileActor's layout on the input rows x; h1 and h2 are
// the hidden rows, and the logits overwrite h1. Each phase ends at a barrier.
// PAIRS: the hidden layers by tile_dense_tanh_x2 (one actor, wstride 0)
template <int OW, int KP, bool PAIRS = false>
__device__ __forceinline__ void tile_mlp(const float* w, int wstride, const float* x, float* h1,
                                         float* h2, const TileRows& tr) {
  using M = TileActor<OW, KP>;
  if constexpr (PAIRS) {
    tile_dense_tanh_x2<OW>(w + M::W1T, w + M::B1, x, h1, tr);
    __syncthreads();
    tile_dense_tanh_x2<H>(w + M::W2T, w + M::B2, h1, h2, tr);
  } else {
    tile_dense_tanh<OW>(w + M::W1T, w + M::B1, wstride, x, h1, tr);
    __syncthreads();
    tile_dense_tanh<H>(w + M::W2T, w + M::B2, wstride, h1, h2, tr);
  }
  __syncthreads();
  tile_logits<KP>(w + M::W3T, w + M::B3, wstride, h2, h1, tr);
  __syncthreads();
}

// the obs rows of lane l (its state wd, comm rows cm and derived values d)
// into the tile's input rows xt and, where gobs is not null, into an [A][OW]
// tensor of stride N at gobs
template <class S>
__device__ __forceinline__ void put_obs(const typename S::W& wd, const float (&cm)[S::A][S::CW],
                                        const typename S::Derived& d, float* xt,
                                        const TileRows& tr, int l, float* __restrict__ gobs,
                                        size_t N) {
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int r = 0; r < S::OW; ++r) {
      const float v = S::obs(i, r, wd, cm, d);
      xt[r * tr.ldx + i * tr.tlp + l] = v;
      if (gobs != nullptr) __stcs(gobs + (size_t)(i * S::OW + r) * N, v);
    }
}

// the same from the lane's state and its agents' carried comm indices (a
// fresh lane: the start, a reset)
template <class S>
__device__ __forceinline__ void put_fresh_obs(const typename S::Params& c,
                                              const typename S::W& wd, const int (&cidx)[S::A],
                                              float* xt, const TileRows& tr, int l,
                                              float* __restrict__ gobs, size_t N) {
  float cm[S::A][S::CW];
  comm_rows<S>(cidx, cm);
  put_obs<S>(wd, cm, S::derive(c, wd, cm), xt, tr, l, gobs, N);
}

// the Gumbel score of logit z at U[0, 1) draw u: z - log(-log(u + 1e-12) + 1e-12)
__device__ __forceinline__ float gumbel_score(float z, float u) {
  return z - logf(-logf(u + 1e-12f) + 1e-12f);
}

}  // namespace

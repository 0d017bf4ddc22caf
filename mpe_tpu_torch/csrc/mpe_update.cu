// Hopper (sm_90a) kernels of the fused PPO epoch gradient.
//
// K6  ppo_update_kernel + ppo_update_reduce_kernel  replace
//     mpe_tpu/ops/fused_update.py::_update_kernel (fused_ppo_update): for every
//     sample (one (t, agent, env) column of the [T, A, *, N] batch) the forward
//     MLP 18-64-64-(5+1), the analytic clipped-surrogate, entropy and clipped
//     value-loss gradient at the outputs (fused_update.py:21-23), the backward
//     pass through both tanh layers, and the weight-gradient and metric sums.
//     Out: the gradient in the packed layout below and the (pg, vloss, entropy)
//     means.
//
// What bounds it: fp32 operations, about 32k multiplies and adds per sample
// (chip_smoke.py::OPS), against 108 bytes read per sample.
//
// What the design does about it. The TPU kernel adds into one output block
// because its grid runs in order; here CTAs run in parallel, so each CTA of a
// persistent grid (one per SM) keeps its own partial gradient in registers and
// a second kernel sums the partials in a fixed order: the result does not
// change from run to run, and no float atomics are used. A CTA strides over
// tiles of TS = 128 samples. For a tile:
//   A. each thread takes one sample: forward (h1 in registers, h2 streamed
//      into the six output sums), the output gradient g3, the backward pass,
//      and writes x, h1, h2, gh1, gh2, g3 as columns of [row][TS+1] tiles in
//      shared memory (the +1 pad makes a warp's column writes and the row
//      reads of phase B free of bank conflicts);
//   B. each thread owns a fixed slice of dW2 (4 x 8), dW1 (1 x 9), dW3
//      (3 x 1) and one or two bias entries, and adds the tile's outer
//      products into it in registers.
// The weights (23 KB) and the tiles (141 KB) sit in 164 KB of dynamic shared
// memory, so one CTA of four warps runs on each SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OW = 18;           // obs width
constexpr int H = 64;            // hidden width
constexpr int KP = 5;            // policy logits
constexpr int KO = KP + 1;       // + the value
constexpr int TS = 128;          // samples per tile = threads per CTA
constexpr int LD = TS + 1;       // row stride of the tiles

// packed weights (input) and gradient (output, partials): w1 [H,OW], b1 [H],
// w2 [H,H], b2 [H], w3 [KO,H] (pi rows, then v), b3 [KO], then the three
// metric sums; ops/fused_update.py::_PACKED mirrors it
constexpr int G_W1 = 0, G_B1 = G_W1 + H * OW, G_W2 = G_B1 + H, G_B2 = G_W2 + H * H,
              G_W3 = G_B2 + H, G_B3 = G_W3 + KO * H, G_MS = G_B3 + KO, NG = G_MS + 3;
// the same weights in shared memory, w2 first so that its rows are 16-byte aligned
constexpr int S_W2 = 0, S_W1 = S_W2 + H * H, S_W3 = S_W1 + H * OW, S_B1 = S_W3 + KO * H,
              S_B2 = S_B1 + H, S_B3 = S_B2 + H, S_TILE = (S_B3 + KO + 3) / 4 * 4;
// tile rows
constexpr int R_X = 0, R_H1 = R_X + OW, R_H2 = R_H1 + H, R_GH1 = R_H2 + H, R_GH2 = R_GH1 + H,
              R_G3 = R_GH2 + H, R_N = R_G3 + KO;
constexpr size_t SMEM_BYTES = (size_t)(S_TILE + R_N * LD) * sizeof(float);

struct UpdateConsts {
  float ratio_lo, ratio_hi;      // 1 - clip, 1 + clip
  float vclip;                   // clip of the value change
  float vf_scale;                // vf_coef * 2 / B
  float ent_scale;               // ent_coef / B
  float inv_b;                   // 1 / B, B = T * A * N
};

// phase A for one sample m: writes column `col` of the tiles, adds the
// sample's (pg, vloss, entropy) terms to `ms`
__device__ __forceinline__ void sample_pass(
    const float* __restrict__ w, float* __restrict__ tile, int col, size_t m, int n_envs,
    const float* __restrict__ obs, const float* __restrict__ mvoh, const float* __restrict__ lpo,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ vold,
    const UpdateConsts& k, float (&ms)[3]) {
  const size_t ta = m / (size_t)n_envs;
  const size_t lane = m - ta * (size_t)n_envs;
  const size_t N = (size_t)n_envs;

  float z[KO];
  {
    float x[OW];
#pragma unroll
    for (int r = 0; r < OW; ++r) {
      x[r] = obs[(ta * OW + r) * N + lane];
      tile[(R_X + r) * LD + col] = x[r];
    }
    float h1[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      const float* row = w + S_W1 + g * OW;
      float acc = row[0] * x[0];
#pragma unroll
      for (int q = 1; q < OW; ++q) acc = acc + row[q] * x[q];
      h1[g] = tanhf(acc + w[S_B1 + g]);
      tile[(R_H1 + g) * LD + col] = h1[g];
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < H; ++g) {
      const float4* r4 = reinterpret_cast<const float4*>(w + S_W2 + g * H);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = r4[q];
        acc = acc + v.x * h1[4 * q + 0];
        acc = acc + v.y * h1[4 * q + 1];
        acc = acc + v.z * h1[4 * q + 2];
        acc = acc + v.w * h1[4 * q + 3];
      }
      const float h2 = tanhf(acc + w[S_B2 + g]);
      tile[(R_H2 + g) * LD + col] = h2;
#pragma unroll
      for (int c = 0; c < KO; ++c) z[c] = z[c] + w[S_W3 + c * H + g] * h2;
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = z[c] + w[S_B3 + c];
  }

  // _policy_logit_grad: softmax over the move logits, ratio, clipped surrogate
  float zm = z[0];
#pragma unroll
  for (int c = 1; c < KP; ++c) zm = fmaxf(zm, z[c]);
  float e[KP], s = 0.0f;
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    e[c] = expf(z[c] - zm);
    s = s + e[c];
  }
  const float lse = logf(s);
  float ls[KP], p[KP], ent = 0.0f, lp = 0.0f;
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    ls[c] = (z[c] - zm) - lse;
    p[c] = e[c] / s;
    ent = ent + p[c] * ls[c];
    lp = lp + ls[c] * mvoh[(ta * KP + c) * N + lane];
  }
  ent = -ent;
  const float a = adv[m];
  const float ratio = expf(lp - lpo[m]);
  const float rc = fminf(fmaxf(ratio, k.ratio_lo), k.ratio_hi);
  const float s1 = ratio * a, s2 = rc * a;
  const float cpg = (s1 <= s2) ? -(a * ratio) * k.inv_b : 0.0f;
  float g3[KO];
#pragma unroll
  for (int c = 0; c < KP; ++c) {
    const float oh = mvoh[(ta * KP + c) * N + lane];
    g3[c] = cpg * (oh - p[c]) + (k.ent_scale * p[c]) * (ls[c] + ent);
  }
  // _value_clip_grad
  const float v = z[KP], vo = vold[m], r = ret[m];
  const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
  const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
  // live where the max's first branch wins or the clip does not bind (then vc
  // is v up to rounding; ops/fused_update.py::_value_clip_grad)
  g3[KP] = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
  ms[0] = ms[0] - fminf(s1, s2);
  ms[1] = ms[1] + fmaxf(d1, d2);
  ms[2] = ms[2] + ent;
#pragma unroll
  for (int c = 0; c < KO; ++c) tile[(R_G3 + c) * LD + col] = g3[c];

  // backward: gh2 = (w3^T g3) (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2)
  float gh1[H];
#pragma unroll
  for (int q = 0; q < H; ++q) gh1[q] = 0.0f;
#pragma unroll 2
  for (int g = 0; g < H; ++g) {
    float sg = w[S_W3 + g] * g3[0];
#pragma unroll
    for (int c = 1; c < KO; ++c) sg = sg + w[S_W3 + c * H + g] * g3[c];
    const float h2 = tile[(R_H2 + g) * LD + col];
    const float gh2 = sg * (1.0f - h2 * h2);
    tile[(R_GH2 + g) * LD + col] = gh2;
    const float4* r4 = reinterpret_cast<const float4*>(w + S_W2 + g * H);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 v4 = r4[q];
      gh1[4 * q + 0] = gh1[4 * q + 0] + v4.x * gh2;
      gh1[4 * q + 1] = gh1[4 * q + 1] + v4.y * gh2;
      gh1[4 * q + 2] = gh1[4 * q + 2] + v4.z * gh2;
      gh1[4 * q + 3] = gh1[4 * q + 3] + v4.w * gh2;
    }
  }
#pragma unroll
  for (int q = 0; q < H; ++q) {
    const float h1 = tile[(R_H1 + q) * LD + col];
    tile[(R_GH1 + q) * LD + col] = gh1[q] * (1.0f - h1 * h1);
  }
}

__global__ void __launch_bounds__(TS, 1)
ppo_update_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                  const float* __restrict__ mvoh, const float* __restrict__ lpo,
                  const float* __restrict__ adv, const float* __restrict__ ret,
                  const float* __restrict__ vold, float* __restrict__ partials, int n_ta,
                  int n_envs, UpdateConsts k) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* tile = smem + S_TILE;
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += TS) w[S_W2 + i] = weights[G_W2 + i];
  for (int i = tid; i < H * OW; i += TS) w[S_W1 + i] = weights[G_W1 + i];
  for (int i = tid; i < KO * H; i += TS) w[S_W3 + i] = weights[G_W3 + i];
  if (tid < H) {
    w[S_B1 + tid] = weights[G_B1 + tid];
    w[S_B2 + tid] = weights[G_B2 + tid];
  }
  if (tid < KO) w[S_B3 + tid] = weights[G_B3 + tid];
  __syncthreads();

  // this thread's slices of the gradient (see the layout note above)
  const int gb = tid >> 3, kb = tid & 7;     // dW2 rows gb + 16 i, columns kb + 8 j
  const int g1 = tid >> 1, k1 = tid & 1;     // dW1 row g1, columns k1 + 2 j; dW3 column g1,
                                             // rows 3 k1 + j
  const int brow = tid < H ? R_GH1 + tid : R_GH2 + tid - H;   // db1 or db2 entry
  float a2[4][8], a1[9], a3[3], ab = 0.0f, ab3 = 0.0f, ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a2[i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < 9; ++j) a1[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) a3[j] = 0.0f;

  const size_t n_samples = (size_t)n_ta * (size_t)n_envs;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const size_t m = ti * TS + tid;
    if (m < n_samples) {
      sample_pass(w, tile, tid, m, n_envs, obs, mvoh, lpo, adv, ret, vold, k, ms);
    } else {                                  // the ragged end adds zeros
      for (int r = 0; r < R_N; ++r) tile[r * LD + tid] = 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < TS; ++s) {
      float gh2[4], h1[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gh2[i] = tile[(R_GH2 + gb + 16 * i) * LD + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) h1[j] = tile[(R_H1 + kb + 8 * j) * LD + s];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a2[i][j] = a2[i][j] + gh2[i] * h1[j];
      const float gh1 = tile[(R_GH1 + g1) * LD + s];
#pragma unroll
      for (int j = 0; j < 9; ++j) a1[j] = a1[j] + gh1 * tile[(R_X + k1 + 2 * j) * LD + s];
      const float h2 = tile[(R_H2 + g1) * LD + s];
#pragma unroll
      for (int j = 0; j < 3; ++j) a3[j] = a3[j] + tile[(R_G3 + 3 * k1 + j) * LD + s] * h2;
      ab = ab + tile[brow * LD + s];
      if (tid < KO) ab3 = ab3 + tile[(R_G3 + tid) * LD + s];
    }
    __syncthreads();
  }

  float* part = partials + (size_t)blockIdx.x * NG;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[G_W2 + (gb + 16 * i) * H + kb + 8 * j] = a2[i][j];
#pragma unroll
  for (int j = 0; j < 9; ++j) part[G_W1 + g1 * OW + k1 + 2 * j] = a1[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) part[G_W3 + (3 * k1 + j) * H + g1] = a3[j];
  part[tid < H ? G_B1 + tid : G_B2 + tid - H] = ab;
  if (tid < KO) part[G_B3 + tid] = ab3;
  // metric sums over the CTA's threads, in thread order
#pragma unroll
  for (int q = 0; q < 3; ++q) tile[q * TS + tid] = ms[q];
  __syncthreads();
  if (tid < 3) {
    float total = 0.0f;
    for (int i = 0; i < TS; ++i) total = total + tile[tid * TS + i];
    part[G_MS + tid] = total;
  }
}

// out[e] = sum over CTAs b = 0, 1, ... of partials[b][e]; the metric sums are
// scaled to means
__global__ void ppo_update_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                         int n_parts, float inv_b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= NG) return;
  float total = 0.0f;
  for (int b = 0; b < n_parts; ++b) total = total + partials[(size_t)b * NG + e];
  out[e] = e >= G_MS ? total * inv_b : total;
}

}  // namespace

extern "C" {

// partials: [n_parts, NG] scratch, out: [NG]; n_parts CTAs of the update kernel
int mpe_ppo_update_h64(const float* weights, const float* obs, const float* mvoh,
                       const float* lpo, const float* adv, const float* ret, const float* vold,
                       float* partials, float* out, int n_ta, int n_envs, int n_parts,
                       float ratio_lo, float ratio_hi, float vclip, float vf_scale,
                       float ent_scale, float inv_b, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ppo_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b};
  ppo_update_kernel<<<n_parts, TS, SMEM_BYTES, stream>>>(weights, obs, mvoh, lpo, adv, ret, vold,
                                                         partials, n_ta, n_envs, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ppo_update_reduce_kernel<<<(NG + 255) / 256, 256, 0, stream>>>(partials, out, n_parts, inv_b);
  return (int)cudaGetLastError();
}

int mpe_ppo_update_packed_size() { return NG; }

}  // extern "C"

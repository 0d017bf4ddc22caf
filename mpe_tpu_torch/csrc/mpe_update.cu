// Hopper (sm_90a) kernels of the fused PPO and MAPPO epoch gradients.
//
// K6  ppo_update_kernel<18, 5, true, false> + update_reduce_kernel  replace
//     mpe_tpu/ops/fused_update.py::_update_kernel (fused_ppo_update): for every
//     sample (one (t, agent, env) column of the [T, A, *, N] batch) the forward
//     MLP 18-64-64-(5+1), the analytic clipped-surrogate, entropy and clipped
//     value-loss gradient at the outputs (fused_update.py:21-23), the backward
//     pass through both tanh layers, and the weight-gradient and metric sums.
// K7  ppo_update_kernel<18, 5, false, true> (the decentralized actor over the
//     (t, agent, env) samples, the team advantage of (t, env) broadcast to every
//     agent) + ppo_update_kernel<54, 0, true, false> (the centralized critic
//     over the (t, env) samples, on the joint obs of 54 rows) +
//     update_reduce_kernel  replace  mpe_tpu/ops/fused_update.py::
//     _mappo_update_kernel (fused_mappo_update). pg and entropy are means over
//     [T, A, N], the value loss over [T, N]. The TPU kernel pads the value head
//     to 8 rows (VPAD) for its matrix unit; here it is one output.
// Out: the gradient in the packed layout below and the metric sums.
//
// What bounds them: fp32 operations, about 17k multiply-adds per K6 sample and
// 23k per K7 critic sample (chip_smoke.py::OPS), against about 100 bytes read
// per sample.
//
// What the design does about it. The TPU kernels add into one output block
// because their grid runs in order; here CTAs run in parallel, so each CTA of a
// persistent grid (one per SM) keeps its own partial gradient in registers and
// a second kernel sums the partials in a fixed order: the result does not
// change from run to run, and no float atomics are used. A CTA strides over
// tiles of TS = 128 samples. For a tile:
//   A. each thread takes one sample: forward (h1 in registers, h2 streamed
//      into the output sums), the output gradient g3, the backward pass, and
//      writes x, h1, h2, gh1, gh2, g3 as columns of [row][TS+1] tiles in shared
//      memory (the +1 pad makes a warp's column writes and the row reads of
//      phase B free of bank conflicts);
//   B. each thread owns a fixed slice of dW2 (4 x 8), dW1 (1 x IN/2), dW3
//      (one column, every other row) and one or two bias entries, and adds the
//      tile's outer products into it in registers.
// The weights and the tiles sit in dynamic shared memory (K6 164 KB, the K7
// critic 192 KB), so one CTA of four warps runs on each SM. K7's two passes are
// two launches of the same persistent grid, each with its own partials.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int H = 64;            // hidden width
constexpr int TS = 128;          // samples per tile = threads per CTA
constexpr int LD = TS + 1;       // row stride of the tiles

// IN inputs, KP policy logits, HAS_V: a value output after them; TEAM_ADV: the
// advantage is indexed by (t, env) and shared by the A agents of a time step
template <int IN, int KP, bool HAS_V>
struct Layout {
  static constexpr int KO = KP + (HAS_V ? 1 : 0);    // outputs
  // packed weights (input) and gradient (output, partials): w1 [H,IN], b1 [H],
  // w2 [H,H], b2 [H], w3 [KO,H] (pi rows, then v), b3 [KO], then the three
  // metric sums (pg, vloss, entropy); ops/fused_update.py::_packed mirrors it
  static constexpr int G_W1 = 0, G_B1 = G_W1 + H * IN, G_W2 = G_B1 + H, G_B2 = G_W2 + H * H,
                       G_W3 = G_B2 + H, G_B3 = G_W3 + KO * H, G_MS = G_B3 + KO, NG = G_MS + 3;
  // the same weights in shared memory, w2 first so that its rows are 16-byte aligned
  static constexpr int S_W2 = 0, S_W1 = S_W2 + H * H, S_W3 = S_W1 + H * IN, S_B1 = S_W3 + KO * H,
                       S_B2 = S_B1 + H, S_B3 = S_B2 + H, S_TILE = (S_B3 + KO + 3) / 4 * 4;
  // tile rows
  static constexpr int R_X = 0, R_H1 = R_X + IN, R_H2 = R_H1 + H, R_GH1 = R_H2 + H,
                       R_GH2 = R_GH1 + H, R_G3 = R_GH2 + H, R_N = R_G3 + KO;
  static constexpr size_t SMEM_BYTES = (size_t)(S_TILE + R_N * LD) * sizeof(float);
  static_assert(IN % 2 == 0, "dW1 is split over column pairs");
  static_assert(KO >= 1 && KO <= 2 * 3, "dW3 rows: at most three per thread");
};

struct UpdateConsts {
  float ratio_lo, ratio_hi;      // 1 - clip, 1 + clip
  float vclip;                   // clip of the value change
  float vf_scale;                // vf_coef * 2 / B_v
  float ent_scale;               // ent_coef / B
  float inv_b;                   // 1 / B, B = T * A * N
  int n_agents;                  // A, for the team advantage's index
};

// phase A for one sample m: writes column `col` of the tiles, adds the
// sample's (pg, vloss, entropy) terms to `ms`
template <int IN, int KP, bool HAS_V, bool TEAM_ADV>
__device__ __forceinline__ void sample_pass(
    const float* __restrict__ w, float* __restrict__ tile, int col, size_t m, int n_envs,
    const float* __restrict__ obs, const float* __restrict__ mvoh, const float* __restrict__ lpo,
    const float* __restrict__ adv, const float* __restrict__ ret, const float* __restrict__ vold,
    const UpdateConsts& k, float (&ms)[3]) {
  using L = Layout<IN, KP, HAS_V>;
  constexpr int KO = L::KO;
  const size_t ta = m / (size_t)n_envs;
  const size_t lane = m - ta * (size_t)n_envs;
  const size_t N = (size_t)n_envs;

  float z[KO];
  {
    float x[IN];
#pragma unroll
    for (int r = 0; r < IN; ++r) {
      x[r] = obs[(ta * IN + r) * N + lane];
      tile[(L::R_X + r) * LD + col] = x[r];
    }
    float h1[H];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      const float* row = w + L::S_W1 + g * IN;
      float acc = row[0] * x[0];
#pragma unroll
      for (int q = 1; q < IN; ++q) acc = acc + row[q] * x[q];
      h1[g] = tanhf(acc + w[L::S_B1 + g]);
      tile[(L::R_H1 + g) * LD + col] = h1[g];
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < H; ++g) {
      const float4* r4 = reinterpret_cast<const float4*>(w + L::S_W2 + g * H);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = r4[q];
        acc = acc + v.x * h1[4 * q + 0];
        acc = acc + v.y * h1[4 * q + 1];
        acc = acc + v.z * h1[4 * q + 2];
        acc = acc + v.w * h1[4 * q + 3];
      }
      const float h2 = tanhf(acc + w[L::S_B2 + g]);
      tile[(L::R_H2 + g) * LD + col] = h2;
#pragma unroll
      for (int c = 0; c < KO; ++c) z[c] = z[c] + w[L::S_W3 + c * H + g] * h2;
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = z[c] + w[L::S_B3 + c];
  }

  float g3[KO];
  if constexpr (KP > 0) {
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
    const float a = TEAM_ADV ? adv[(ta / (size_t)k.n_agents) * N + lane] : adv[m];
    const float ratio = expf(lp - lpo[m]);
    const float rc = fminf(fmaxf(ratio, k.ratio_lo), k.ratio_hi);
    const float s1 = ratio * a, s2 = rc * a;
    const float cpg = (s1 <= s2) ? -(a * ratio) * k.inv_b : 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      const float oh = mvoh[(ta * KP + c) * N + lane];
      g3[c] = cpg * (oh - p[c]) + (k.ent_scale * p[c]) * (ls[c] + ent);
    }
    ms[0] = ms[0] - fminf(s1, s2);
    ms[2] = ms[2] + ent;
  }
  if constexpr (HAS_V) {
    // _value_clip_grad
    const float v = z[KP], vo = vold[m], r = ret[m];
    const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
    const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
    // live where the max's first branch wins or the clip does not bind (then vc
    // is v up to rounding; ops/fused_update.py::_value_clip_grad)
    g3[KP] = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
    ms[1] = ms[1] + fmaxf(d1, d2);
  }
#pragma unroll
  for (int c = 0; c < KO; ++c) tile[(L::R_G3 + c) * LD + col] = g3[c];

  // backward: gh2 = (w3^T g3) (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2)
  float gh1[H];
#pragma unroll
  for (int q = 0; q < H; ++q) gh1[q] = 0.0f;
#pragma unroll 2
  for (int g = 0; g < H; ++g) {
    float sg = w[L::S_W3 + g] * g3[0];
#pragma unroll
    for (int c = 1; c < KO; ++c) sg = sg + w[L::S_W3 + c * H + g] * g3[c];
    const float h2 = tile[(L::R_H2 + g) * LD + col];
    const float gh2 = sg * (1.0f - h2 * h2);
    tile[(L::R_GH2 + g) * LD + col] = gh2;
    const float4* r4 = reinterpret_cast<const float4*>(w + L::S_W2 + g * H);
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
    const float h1 = tile[(L::R_H1 + q) * LD + col];
    tile[(L::R_GH1 + q) * LD + col] = gh1[q] * (1.0f - h1 * h1);
  }
}

// n_rows * n_envs samples: rows are (t, agent) pairs (K6, the K7 actor) or
// time steps (the K7 critic, whose IN = A * OW joint rows are contiguous)
template <int IN, int KP, bool HAS_V, bool TEAM_ADV>
__global__ void __launch_bounds__(TS, 1)
ppo_update_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                  const float* __restrict__ mvoh, const float* __restrict__ lpo,
                  const float* __restrict__ adv, const float* __restrict__ ret,
                  const float* __restrict__ vold, float* __restrict__ partials, int n_rows,
                  int n_envs, UpdateConsts k) {
  using L = Layout<IN, KP, HAS_V>;
  constexpr int KO = L::KO;
  constexpr int J1 = IN / 2;               // dW1 columns per thread
  constexpr int J3 = (KO + 1) / 2;         // dW3 rows per thread
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* tile = smem + L::S_TILE;
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += TS) w[L::S_W2 + i] = weights[L::G_W2 + i];
  for (int i = tid; i < H * IN; i += TS) w[L::S_W1 + i] = weights[L::G_W1 + i];
  for (int i = tid; i < KO * H; i += TS) w[L::S_W3 + i] = weights[L::G_W3 + i];
  if (tid < H) {
    w[L::S_B1 + tid] = weights[L::G_B1 + tid];
    w[L::S_B2 + tid] = weights[L::G_B2 + tid];
  }
  if (tid < KO) w[L::S_B3 + tid] = weights[L::G_B3 + tid];
  __syncthreads();

  // this thread's slices of the gradient (see the layout note above)
  const int gb = tid >> 3, kb = tid & 7;     // dW2 rows gb + 16 i, columns kb + 8 j
  const int g1 = tid >> 1, k1 = tid & 1;     // dW1 row g1, columns k1 + 2 j; dW3 column g1,
                                             // rows k1 + 2 j
  const int brow = tid < H ? L::R_GH1 + tid : L::R_GH2 + tid - H;   // db1 or db2 entry
  float a2[4][8], a1[J1], a3[J3], ab = 0.0f, ab3 = 0.0f, ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a2[i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < J1; ++j) a1[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < J3; ++j) a3[j] = 0.0f;

  const size_t n_samples = (size_t)n_rows * (size_t)n_envs;
  const size_t n_tiles = (n_samples + TS - 1) / TS;
  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const size_t m = ti * TS + tid;
    if (m < n_samples) {
      sample_pass<IN, KP, HAS_V, TEAM_ADV>(w, tile, tid, m, n_envs, obs, mvoh, lpo, adv, ret,
                                           vold, k, ms);
    } else {                                  // the ragged end adds zeros
      for (int r = 0; r < L::R_N; ++r) tile[r * LD + tid] = 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < TS; ++s) {
      float gh2[4], h1[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gh2[i] = tile[(L::R_GH2 + gb + 16 * i) * LD + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) h1[j] = tile[(L::R_H1 + kb + 8 * j) * LD + s];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a2[i][j] = a2[i][j] + gh2[i] * h1[j];
      const float gh1 = tile[(L::R_GH1 + g1) * LD + s];
#pragma unroll
      for (int j = 0; j < J1; ++j) a1[j] = a1[j] + gh1 * tile[(L::R_X + k1 + 2 * j) * LD + s];
      const float h2 = tile[(L::R_H2 + g1) * LD + s];
#pragma unroll
      for (int j = 0; j < J3; ++j)
        if (k1 + 2 * j < KO) a3[j] = a3[j] + tile[(L::R_G3 + k1 + 2 * j) * LD + s] * h2;
      ab = ab + tile[brow * LD + s];
      if (tid < KO) ab3 = ab3 + tile[(L::R_G3 + tid) * LD + s];
    }
    __syncthreads();
  }

  float* part = partials + (size_t)blockIdx.x * L::NG;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[L::G_W2 + (gb + 16 * i) * H + kb + 8 * j] = a2[i][j];
#pragma unroll
  for (int j = 0; j < J1; ++j) part[L::G_W1 + g1 * IN + k1 + 2 * j] = a1[j];
#pragma unroll
  for (int j = 0; j < J3; ++j)
    if (k1 + 2 * j < KO) part[L::G_W3 + (k1 + 2 * j) * H + g1] = a3[j];
  part[tid < H ? L::G_B1 + tid : L::G_B2 + tid - H] = ab;
  if (tid < KO) part[L::G_B3 + tid] = ab3;
  // metric sums over the CTA's threads, in thread order
#pragma unroll
  for (int q = 0; q < 3; ++q) tile[q * TS + tid] = ms[q];
  __syncthreads();
  if (tid < 3) {
    float total = 0.0f;
    for (int i = 0; i < TS; ++i) total = total + tile[tid * TS + i];
    part[L::G_MS + tid] = total;
  }
}

// out[e] = sum over CTAs b = 0, 1, ... of partials[b][e]; the three metric
// sums at the end are scaled to means by ms_scale
__global__ void update_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int n_parts, int ng, float ms_pg, float ms_v, float ms_ent) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ng) return;
  float total = 0.0f;
  for (int b = 0; b < n_parts; ++b) total = total + partials[(size_t)b * ng + e];
  const int q = e - (ng - 3);
  out[e] = q < 0 ? total : total * (q == 0 ? ms_pg : q == 1 ? ms_v : ms_ent);
}

// one pass: the persistent grid of n_parts CTAs, then the reduce into out
template <int IN, int KP, bool HAS_V, bool TEAM_ADV>
cudaError_t update_pass(const float* weights, const float* obs, const float* mvoh, const float* lpo,
                        const float* adv, const float* ret, const float* vold, float* partials,
                        float* out, int n_rows, int n_envs, int n_parts, const UpdateConsts& k,
                        float ms_pg, float ms_v, float ms_ent, cudaStream_t stream) {
  using L = Layout<IN, KP, HAS_V>;
  auto kernel = ppo_update_kernel<IN, KP, HAS_V, TEAM_ADV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<n_parts, TS, L::SMEM_BYTES, stream>>>(weights, obs, mvoh, lpo, adv, ret, vold, partials,
                                                 n_rows, n_envs, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_reduce_kernel<<<(L::NG + 255) / 256, 256, 0, stream>>>(partials, out, n_parts, L::NG,
                                                                ms_pg, ms_v, ms_ent);
  return cudaGetLastError();
}

using PpoLayout = Layout<18, 5, true>;
using ActorLayout = Layout<18, 5, false>;
using CriticLayout = Layout<54, 0, true>;

}  // namespace

extern "C" {

// K6. partials: [n_parts, NG] scratch, out: [NG]; n_parts CTAs of the update kernel
int mpe_ppo_update_h64(const float* weights, const float* obs, const float* mvoh,
                       const float* lpo, const float* adv, const float* ret, const float* vold,
                       float* partials, float* out, int n_ta, int n_envs, int n_parts,
                       float ratio_lo, float ratio_hi, float vclip, float vf_scale,
                       float ent_scale, float inv_b, cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, 1};
  return (int)update_pass<18, 5, true, false>(weights, obs, mvoh, lpo, adv, ret, vold, partials,
                                              out, n_ta, n_envs, n_parts, k, inv_b, inv_b, inv_b,
                                              stream);
}

int mpe_ppo_update_packed_size() { return PpoLayout::NG; }

// K7. Actor pass over the T*A rows of obs [T, A, 18, N] (adv [T, N]), then
// critic pass over the T rows of the joint obs [T, 54, N] (ret, vold [T, N]).
// partials: [n_parts, max(NG_a, NG_c)] scratch; out: [NG_a + NG_c], the actor's
// packed gradient (its pg and entropy means, vloss slot 0) then the critic's
// (its vloss mean)
int mpe_mappo_update_h64(const float* actor_w, const float* critic_w, const float* obs,
                         const float* mvoh, const float* lpo, const float* adv, const float* ret,
                         const float* vold, float* partials, float* out, int n_steps,
                         int n_agents, int n_envs, int n_parts, float ratio_lo, float ratio_hi,
                         float vclip, float vf_scale, float ent_scale, float inv_b, float inv_bv,
                         cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, n_agents};
  cudaError_t err = update_pass<18, 5, false, true>(
      actor_w, obs, mvoh, lpo, adv, nullptr, nullptr, partials, out, n_steps * n_agents, n_envs,
      n_parts, k, inv_b, 0.0f, inv_b, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)update_pass<54, 0, true, false>(
      critic_w, obs, nullptr, nullptr, nullptr, ret, vold, partials, out + ActorLayout::NG,
      n_steps, n_envs, n_parts, k, 0.0f, inv_bv, 0.0f, stream);
}

int mpe_mappo_update_packed_size(int part) {
  return part == 0 ? ActorLayout::NG : CriticLayout::NG;
}

}  // extern "C"

// Hopper (sm_90a) kernels of the fused PPO and MAPPO epoch gradients, for every
// head of the nine scenarios: 5 move logits, and 3, 4 or 10 comm logits where
// the scenario speaks.
//
// K6  ppo_update_kernel<OW, 5, KC, true, false> + update_reduce_kernel  replace
//     mpe_tpu/ops/fused_update.py::_update_kernel (fused_ppo_update): for every
//     sample (one (t, agent, env) column of the [T, A, *, N] batch) the forward
//     MLP IN-64-64-(5+KC+1), the analytic clipped-surrogate, entropy and clipped
//     value-loss gradient at the outputs (fused_update.py:21-23), the comm
//     factor's softmax, log-prob and entropy masked by the agent's speak flag,
//     the backward pass through both tanh layers, and the weight-gradient and
//     metric sums.
// K7  ppo_update_kernel<OW, 5, KC, false, true> (the decentralized actor over the
//     (t, agent, env) samples, the team advantage of (t, env) broadcast to every
//     agent) + ppo_update_kernel<0, 0, 0, true, false> (the centralized critic over
//     the (t, env) samples, on the joint obs of A*OW rows, 4 to 204) +
//     update_reduce_kernel  replace  mpe_tpu/ops/fused_update.py::
//     _mappo_update_kernel (fused_mappo_update). pg and entropy are means over
//     [T, A, N], the value loss over [T, N]. The TPU kernel pads the value head
//     to 8 rows (VPAD) for its matrix unit; here it is one output.
// Out: the gradient in the packed layout below and the metric sums.
//
// What bounds them: fp32 operations, 64 (IN + 64 + KO) multiply-adds of the
// forward, about as many of the backward and of the weight gradients per
// sample (chip_smoke.py::OPS), against about 4 (IN + 5 + C + 4) bytes read per
// sample.
//
// What the design does about it. The TPU kernels add into one output block
// because their grid runs in order; here CTAs run in parallel, so each CTA of a
// persistent grid (one per SM) keeps its own partial gradient and a second
// kernel sums the partials in a fixed order: the result does not change from
// run to run, and no float atomics are used. A CTA strides over tiles of TS
// samples (128, or 64 where the tiles of 128 would not fit in shared memory:
// the critic on simple_world_comm's 204-wide joint obs). For a tile:
//   A. each of TS threads takes one sample: stages its obs column x in shared
//      memory, the forward (h1 in registers, summed over the inputs in order
//      against w1 stored transposed, so a thread reads 64 consecutive weights
//      per input; h2 streamed into the output sums), the output gradient g3,
//      the backward pass, and writes h1, h2, gh1, gh2, g3 as further columns of
//      [row][TS+1] tiles (the +1 pad makes a warp's column writes and the row
//      reads of phase B free of bank conflicts);
//   B. each of the 128 threads owns a fixed slice of dW2 (4 x 8), dW1 (one row,
//      every other column: IN/2 entries), dW3 (one column, every other row)
//      and one or two bias entries, and adds the tile's outer products into it
//      in registers.
// The actor passes (K6, K7's actor) are compiled for each scenario's head: IN,
// KP and KC are template arguments, nine (OW, C) pairs (by_actor_head), so the
// outputs and the dW1 slice (at most 17 entries, simple_world_comm's 34
// inputs) stay in registers. The critic of K7 takes the joint obs, 4 to 204
// inputs, with IN a run-time argument (IN_C = 0): its dW1 slice (up to 102
// entries) goes through the CTA's partial in global memory, 8 columns per pass
// over the tile, so that no width needs more registers. TS is a template
// argument everywhere (two critic instantiations, 128 and 64). Both choices
// were measured on an H100 (tools/torch_update_ab.py, K6 on simple_spread):
// with a run-time row stride every tile address of phase B took a register of
// its own, each instantiation reached 255 registers and K6 ran about 19% slower;
// the actor passes with a run-time IN (the stride compiled in) ran 15-20%
// slower than with the heads compiled in. The
// weights and the tiles sit in dynamic shared memory (K6 on simple_spread
// 168 KB, on simple_reference 178 KB; the world_comm critic with tiles of 64
// samples 189 KB), so one CTA of four warps runs on each SM. K7's two passes
// are two launches of the same persistent grid, each with its own partials.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int H = 64;            // hidden width
constexpr int THREADS = 128;     // per CTA
constexpr int DW1_PASS = 8;      // dW1 columns per pass over a tile
constexpr size_t MAX_SMEM = 232448;

// the layout of an IN-64-64-KO MLP's weights, gradient and tiles
struct Layout {
  int in, ko, ts, ld;
  // packed weights (input) and gradient (output, partials): w1 [H,IN], b1 [H],
  // w2 [H,H], b2 [H], w3 [KO,H] (policy rows, then v), b3 [KO], then the three
  // metric sums (pg, vloss, entropy); ops/fused_update.py::_packed mirrors it
  int g_w1, g_b1, g_w2, g_b2, g_w3, g_b3, g_ms, ng;
  // the weights in shared memory: w2 first so that its rows are 16-byte
  // aligned, w1 transposed [IN][H]
  int s_w2, s_w1t, s_w3, s_b1, s_b2, s_b3, s_tile;
  // tile rows
  int r_x, r_h1, r_h2, r_gh1, r_gh2, r_g3, r_n;
  size_t smem_bytes;
};

__host__ __device__ inline Layout make_layout(int in, int ko, int ts) {
  Layout L;
  L.in = in;
  L.ko = ko;
  L.ts = ts;
  L.ld = ts + 1;
  L.g_w1 = 0;
  L.g_b1 = L.g_w1 + H * in;
  L.g_w2 = L.g_b1 + H;
  L.g_b2 = L.g_w2 + H * H;
  L.g_w3 = L.g_b2 + H;
  L.g_b3 = L.g_w3 + ko * H;
  L.g_ms = L.g_b3 + ko;
  L.ng = L.g_ms + 3;
  L.s_w2 = 0;
  L.s_w1t = L.s_w2 + H * H;
  L.s_w3 = L.s_w1t + H * in;
  L.s_b1 = L.s_w3 + ko * H;
  L.s_b2 = L.s_b1 + H;
  L.s_b3 = L.s_b2 + H;
  L.s_tile = (L.s_b3 + ko + 3) / 4 * 4;
  L.r_x = 0;
  L.r_h1 = L.r_x + in;
  L.r_h2 = L.r_h1 + H;
  L.r_gh1 = L.r_h2 + H;
  L.r_gh2 = L.r_gh1 + H;
  L.r_g3 = L.r_gh2 + H;
  L.r_n = L.r_g3 + ko;
  L.smem_bytes = (size_t)(L.s_tile + L.r_n * L.ld) * sizeof(float);
  return L;
}

// the widest tile that fits: 128 samples, else 64; 0 if neither does
inline int tile_samples(int in, int ko) {
  for (int ts = THREADS; ts >= THREADS / 2; ts /= 2)
    if (make_layout(in, ko, ts).smem_bytes <= MAX_SMEM) return ts;
  return 0;
}

struct UpdateConsts {
  float ratio_lo, ratio_hi;      // 1 - clip, 1 + clip
  float vclip;                   // clip of the value change
  float vf_scale;                // vf_coef * 2 / B_v
  float ent_scale;               // ent_coef / B
  float inv_b;                   // 1 / B, B = T * A * N
  int n_agents;                  // A: the agent of row (t, i) and the team advantage's index
  int speak_mask;                // bit i: agent i speaks (its comm factor counts)
};

// softmax over z[K0, K0 + K): p, log p, entropy and the log-prob of the one-hot
// oh (rows (ta * K + c) of an [.., K, N] tensor at lane)
template <int K0, int K, int KO>
__device__ __forceinline__ void softmax_head(const float (&z)[KO], const float* __restrict__ oh,
                                             size_t ta, size_t lane, size_t N, float (&p)[K],
                                             float (&ls)[K], float (&o)[K], float& ent,
                                             float& lp) {
  float zm = z[K0];
#pragma unroll
  for (int c = 1; c < K; ++c) zm = fmaxf(zm, z[K0 + c]);
  float e[K], s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    e[c] = expf(z[K0 + c] - zm);
    s = s + e[c];
  }
  const float lse = logf(s);
  ent = 0.0f;
  lp = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    ls[c] = (z[K0 + c] - zm) - lse;
    p[c] = e[c] / s;
    o[c] = oh[(ta * K + c) * N + lane];
    ent = ent + p[c] * ls[c];
    lp = lp + ls[c] * o[c];
  }
  ent = -ent;
}

// phase A for one sample m: writes column `col` of the tiles, adds the
// sample's (pg, vloss, entropy) terms to `ms`
template <int IN_C, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__device__ __forceinline__ void sample_pass(
    const Layout& L, const float* __restrict__ w, float* __restrict__ tile, int col, size_t m,
    int n_envs, const float* __restrict__ obs, const float* __restrict__ mvoh,
    const float* __restrict__ cmoh, const float* __restrict__ lpo, const float* __restrict__ adv,
    const float* __restrict__ ret, const float* __restrict__ vold, const UpdateConsts& k,
    float (&ms)[3]) {
  constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  const int ld = L.ld, in = IN_C > 0 ? IN_C : L.in;
  const size_t ta = m / (size_t)n_envs;
  const size_t lane = m - ta * (size_t)n_envs;
  const size_t N = (size_t)n_envs;

  float z[KO];
  {
    for (int q = 0; q < in; ++q) tile[(L.r_x + q) * ld + col] = obs[(ta * in + q) * N + lane];
    // h1 = tanh(w1 x + b1), each unit summed over the inputs in order
    float h1[H];
    {
      const float x0 = tile[L.r_x * ld + col];
      const float4* w4 = reinterpret_cast<const float4*>(w + L.s_w1t);
#pragma unroll
      for (int g = 0; g < H / 4; ++g) {
        const float4 v = w4[g];
        h1[4 * g + 0] = v.x * x0;
        h1[4 * g + 1] = v.y * x0;
        h1[4 * g + 2] = v.z * x0;
        h1[4 * g + 3] = v.w * x0;
      }
    }
#pragma unroll 1
    for (int q = 1; q < in; ++q) {
      const float xq = tile[(L.r_x + q) * ld + col];
      const float4* w4 = reinterpret_cast<const float4*>(w + L.s_w1t + q * H);
#pragma unroll
      for (int g = 0; g < H / 4; ++g) {
        const float4 v = w4[g];
        h1[4 * g + 0] = h1[4 * g + 0] + v.x * xq;
        h1[4 * g + 1] = h1[4 * g + 1] + v.y * xq;
        h1[4 * g + 2] = h1[4 * g + 2] + v.z * xq;
        h1[4 * g + 3] = h1[4 * g + 3] + v.w * xq;
      }
    }
#pragma unroll
    for (int g = 0; g < H; ++g) {
      h1[g] = tanhf(h1[g] + w[L.s_b1 + g]);
      tile[(L.r_h1 + g) * ld + col] = h1[g];
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = 0.0f;
#pragma unroll 4
    for (int g = 0; g < H; ++g) {
      const float4* r4 = reinterpret_cast<const float4*>(w + L.s_w2 + g * H);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 v = r4[q];
        acc = acc + v.x * h1[4 * q + 0];
        acc = acc + v.y * h1[4 * q + 1];
        acc = acc + v.z * h1[4 * q + 2];
        acc = acc + v.w * h1[4 * q + 3];
      }
      const float h2 = tanhf(acc + w[L.s_b2 + g]);
      tile[(L.r_h2 + g) * ld + col] = h2;
#pragma unroll
      for (int c = 0; c < KO; ++c) z[c] = z[c] + w[L.s_w3 + c * H + g] * h2;
    }
#pragma unroll
    for (int c = 0; c < KO; ++c) z[c] = z[c] + w[L.s_b3 + c];
  }

  float g3[KO];
  if constexpr (KP > 0) {
    // _policy_logit_grad: the move factor, the comm factor times the speak
    // flag, the ratio, the clipped surrogate; each factor's entropy gradient
    // uses its own entropy
    float p[KP], ls[KP], oh[KP], ent_m, lp;
    softmax_head<0, KP>(z, mvoh, ta, lane, N, p, ls, oh, ent_m, lp);
    float ent = ent_m;
    [[maybe_unused]] float speak = 0.0f;
    [[maybe_unused]] float pc[KC > 0 ? KC : 1], lsc[KC > 0 ? KC : 1], ohc[KC > 0 ? KC : 1];
    [[maybe_unused]] float ent_c = 0.0f;
    if constexpr (KC > 0) {
      const int agent = (int)(ta % (size_t)k.n_agents);
      speak = ((k.speak_mask >> agent) & 1) ? 1.0f : 0.0f;
      float lp_c;
      softmax_head<KP, KC>(z, cmoh, ta, lane, N, pc, lsc, ohc, ent_c, lp_c);
      lp = lp + lp_c * speak;
      ent = ent_m + ent_c * speak;
    }
    const float a = TEAM_ADV ? adv[(ta / (size_t)k.n_agents) * N + lane] : adv[m];
    const float ratio = expf(lp - lpo[m]);
    const float rc = fminf(fmaxf(ratio, k.ratio_lo), k.ratio_hi);
    const float s1 = ratio * a, s2 = rc * a;
    const float cpg = (s1 <= s2) ? -(a * ratio) * k.inv_b : 0.0f;
#pragma unroll
    for (int c = 0; c < KP; ++c) g3[c] = cpg * (oh[c] - p[c]) + (k.ent_scale * p[c]) * (ls[c] + ent_m);
    if constexpr (KC > 0) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
        g3[KP + c] = (cpg * (ohc[c] - pc[c]) + (k.ent_scale * pc[c]) * (lsc[c] + ent_c)) * speak;
    }
    ms[0] = ms[0] - fminf(s1, s2);
    ms[2] = ms[2] + ent;
  }
  if constexpr (HAS_V) {
    // _value_clip_grad
    const float v = z[KO - 1], vo = vold[m], r = ret[m];
    const float vc = vo + fminf(fmaxf(v - vo, -k.vclip), k.vclip);
    const float d1 = (v - r) * (v - r), d2 = (vc - r) * (vc - r);
    // live where the max's first branch wins or the clip does not bind (then vc
    // is v up to rounding; ops/fused_update.py::_value_clip_grad)
    g3[KO - 1] = (d1 >= d2 || fabsf(v - vo) <= k.vclip) ? k.vf_scale * (v - r) : 0.0f;
    ms[1] = ms[1] + fmaxf(d1, d2);
  }
#pragma unroll
  for (int c = 0; c < KO; ++c) tile[(L.r_g3 + c) * ld + col] = g3[c];

  // backward: gh2 = (w3^T g3) (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2)
  float gh1[H];
#pragma unroll
  for (int q = 0; q < H; ++q) gh1[q] = 0.0f;
#pragma unroll 2
  for (int g = 0; g < H; ++g) {
    float sg = w[L.s_w3 + g] * g3[0];
#pragma unroll
    for (int c = 1; c < KO; ++c) sg = sg + w[L.s_w3 + c * H + g] * g3[c];
    const float h2 = tile[(L.r_h2 + g) * ld + col];
    const float gh2 = sg * (1.0f - h2 * h2);
    tile[(L.r_gh2 + g) * ld + col] = gh2;
    const float4* r4 = reinterpret_cast<const float4*>(w + L.s_w2 + g * H);
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
    const float h1 = tile[(L.r_h1 + q) * ld + col];
    tile[(L.r_gh1 + q) * ld + col] = gh1[q] * (1.0f - h1 * h1);
  }
}

// n_rows * n_envs samples: rows are (t, agent) pairs (K6, the K7 actor) or
// time steps (the K7 critic, whose IN = A * OW joint rows are contiguous).
// IN_C > 0: the input width, compiled in; 0: the run-time in_arg. TS: the
// samples per tile, so that the tiles' row stride is constant and their
// addresses immediates
template <int IN_C, int TS, int KP, int KC, bool HAS_V, bool TEAM_ADV>
__global__ void __launch_bounds__(THREADS, 1)
ppo_update_kernel(const float* __restrict__ weights, const float* __restrict__ obs,
                  const float* __restrict__ mvoh, const float* __restrict__ cmoh,
                  const float* __restrict__ lpo, const float* __restrict__ adv,
                  const float* __restrict__ ret, const float* __restrict__ vold,
                  float* __restrict__ partials, int n_rows, int n_envs, int in_arg,
                  UpdateConsts k) {
  constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  constexpr int J1 = IN_C > 0 ? (IN_C + 1) / 2 : 1;   // dW1 columns per thread in registers
  constexpr int J3 = (KO + 1) / 2;                     // dW3 rows per thread
  constexpr int ts = TS;
  const int in = IN_C > 0 ? IN_C : in_arg;
  const Layout L = make_layout(in, KO, ts);
  const int ld = L.ld;
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* tile = smem + L.s_tile;
  const int tid = threadIdx.x;
  for (int i = tid; i < H * H; i += THREADS) w[L.s_w2 + i] = weights[L.g_w2 + i];
  for (int i = tid; i < H * in; i += THREADS)        // w1 [H, IN] -> [IN, H]
    w[L.s_w1t + (i % in) * H + i / in] = weights[L.g_w1 + i];
  for (int i = tid; i < KO * H; i += THREADS) w[L.s_w3 + i] = weights[L.g_w3 + i];
  if (tid < H) {
    w[L.s_b1 + tid] = weights[L.g_b1 + tid];
    w[L.s_b2 + tid] = weights[L.g_b2 + tid];
  }
  if (tid < KO) w[L.s_b3 + tid] = weights[L.g_b3 + tid];

  // this thread's slices of the gradient (see the layout note above)
  const int gb = tid >> 3, kb = tid & 7;     // dW2 rows gb + 16 i, columns kb + 8 j
  const int g1 = tid >> 1, k1 = tid & 1;     // dW1 row g1, columns k1 + 2 j; dW3 column g1,
                                             // rows k1 + 2 j
  const int brow = tid < H ? L.r_gh1 + tid : L.r_gh2 + tid - H;   // db1 or db2 entry
  float* part = partials + (size_t)blockIdx.x * L.ng;
  if constexpr (IN_C == 0)
    for (int q = k1; q < in; q += 2) part[L.g_w1 + g1 * in + q] = 0.0f;
  float a2[4][8], a1[J1], a3[J3], ab = 0.0f, ab3 = 0.0f, ms[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a2[i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < J1; ++j) a1[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < J3; ++j) a3[j] = 0.0f;
  __syncthreads();

  const size_t n_samples = (size_t)n_rows * (size_t)n_envs;
  const size_t n_tiles = (n_samples + ts - 1) / ts;
  for (size_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const size_t m = ti * ts + tid;
    if (tid < ts) {
      if (m < n_samples) {
        sample_pass<IN_C, KP, KC, HAS_V, TEAM_ADV>(L, w, tile, tid, m, n_envs, obs, mvoh, cmoh, lpo,
                                                   adv, ret, vold, k, ms);
      } else {                                // the ragged end adds zeros
        for (int r = 0; r < L.r_n; ++r) tile[r * ld + tid] = 0.0f;
      }
    }
    __syncthreads();
    for (int s = 0; s < ts; ++s) {
      float gh2[4], h1[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gh2[i] = tile[(L.r_gh2 + gb + 16 * i) * ld + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) h1[j] = tile[(L.r_h1 + kb + 8 * j) * ld + s];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a2[i][j] = a2[i][j] + gh2[i] * h1[j];
      if constexpr (IN_C > 0) {
        const float gh1 = tile[(L.r_gh1 + g1) * ld + s];
#pragma unroll
        for (int j = 0; j < J1; ++j)
          if (k1 + 2 * j < IN_C) a1[j] = a1[j] + gh1 * tile[(L.r_x + k1 + 2 * j) * ld + s];
      }
      const float h2 = tile[(L.r_h2 + g1) * ld + s];
#pragma unroll
      for (int j = 0; j < J3; ++j)
        if (k1 + 2 * j < KO) a3[j] = a3[j] + tile[(L.r_g3 + k1 + 2 * j) * ld + s] * h2;
      ab = ab + tile[brow * ld + s];
      if (tid < KO) ab3 = ab3 + tile[(L.r_g3 + tid) * ld + s];
    }
    // run-time IN: dW1 row g1, DW1_PASS columns per pass; rows past x are read
    // and dropped
    if constexpr (IN_C == 0)
    for (int q0 = k1; q0 < in; q0 += 2 * DW1_PASS) {
      float a1[DW1_PASS];
#pragma unroll
      for (int j = 0; j < DW1_PASS; ++j) a1[j] = 0.0f;
      for (int s = 0; s < ts; ++s) {
        const float gh1 = tile[(L.r_gh1 + g1) * ld + s];
#pragma unroll
        for (int j = 0; j < DW1_PASS; ++j)
          a1[j] = a1[j] + gh1 * tile[(L.r_x + q0 + 2 * j) * ld + s];
      }
#pragma unroll
      for (int j = 0; j < DW1_PASS; ++j)
        if (q0 + 2 * j < in) part[L.g_w1 + g1 * in + q0 + 2 * j] += a1[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[L.g_w2 + (gb + 16 * i) * H + kb + 8 * j] = a2[i][j];
  if constexpr (IN_C > 0) {
#pragma unroll
    for (int j = 0; j < J1; ++j)
      if (k1 + 2 * j < IN_C) part[L.g_w1 + g1 * IN_C + k1 + 2 * j] = a1[j];
  }
#pragma unroll
  for (int j = 0; j < J3; ++j)
    if (k1 + 2 * j < KO) part[L.g_w3 + (k1 + 2 * j) * H + g1] = a3[j];
  part[tid < H ? L.g_b1 + tid : L.g_b2 + tid - H] = ab;
  if (tid < KO) part[L.g_b3 + tid] = ab3;
  // metric sums over the CTA's threads, in thread order
#pragma unroll
  for (int q = 0; q < 3; ++q) tile[q * THREADS + tid] = ms[q];
  __syncthreads();
  if (tid < 3) {
    float total = 0.0f;
    for (int i = 0; i < THREADS; ++i) total = total + tile[tid * THREADS + i];
    part[L.g_ms + tid] = total;
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

// one pass: the persistent grid of n_parts CTAs, then the reduce into out. A
// compiled-in head takes tiles of THREADS samples; a run-time IN the widest
// that fits (tile_samples)
template <int IN_C, int KP, int KC, bool HAS_V, bool TEAM_ADV>
cudaError_t update_pass(int in, const float* weights, const float* obs, const float* mvoh,
                        const float* cmoh, const float* lpo, const float* adv, const float* ret,
                        const float* vold, float* partials, float* out, int n_rows, int n_envs,
                        int n_parts, const UpdateConsts& k, float ms_pg, float ms_v,
                        float ms_ent, cudaStream_t stream) {
  constexpr int KO = KP + KC + (HAS_V ? 1 : 0);
  const int ts = tile_samples(in, KO);
  if (in < 1 || ts == 0 || (IN_C > 0 && (in != IN_C || ts != THREADS)))
    return cudaErrorInvalidValue;
  const Layout L = make_layout(in, KO, ts);
  auto kernel = ppo_update_kernel<IN_C, THREADS, KP, KC, HAS_V, TEAM_ADV>;
  if constexpr (IN_C == 0)
    if (ts != THREADS) kernel = ppo_update_kernel<IN_C, THREADS / 2, KP, KC, HAS_V, TEAM_ADV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<n_parts, THREADS, L.smem_bytes, stream>>>(weights, obs, mvoh, cmoh, lpo, adv, ret,
                                                     vold, partials, n_rows, n_envs, in, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  update_reduce_kernel<<<(L.ng + 255) / 256, 256, 0, stream>>>(partials, out, n_parts, L.ng,
                                                               ms_pg, ms_v, ms_ent);
  return cudaGetLastError();
}

// f(integral_constant<OW>, integral_constant<C>) for the actor head (obs width,
// comm logits) of each of the nine scenarios; ops/fused_update.py::actor_heads
// lists the same pairs
template <class F>
cudaError_t by_actor_head(int ow, int kc, F f) {
#define MPE_ACTOR_HEAD(OW, C)   \
  if (ow == OW && kc == C)       \
    return f(std::integral_constant<int, OW>{}, std::integral_constant<int, C>{});
  MPE_ACTOR_HEAD(18, 0)    // simple_spread
  MPE_ACTOR_HEAD(4, 0)     // simple
  MPE_ACTOR_HEAD(21, 10)   // simple_reference
  MPE_ACTOR_HEAD(11, 3)    // simple_speaker_listener
  MPE_ACTOR_HEAD(10, 0)    // simple_adversary
  MPE_ACTOR_HEAD(19, 0)    // simple_push
  MPE_ACTOR_HEAD(8, 4)     // simple_crypto
  MPE_ACTOR_HEAD(16, 0)    // simple_tag
  MPE_ACTOR_HEAD(34, 4)    // simple_world_comm
#undef MPE_ACTOR_HEAD
  return cudaErrorInvalidValue;
}

constexpr int MOVES = 5;

}  // namespace

extern "C" {

// K6. obs [n_ta, IN, N] (n_ta = T * A), mvoh [n_ta, 5, N], cmoh [n_ta, kc, N]
// (unread for kc = 0); partials: [n_parts, NG] scratch, out: [NG]
int mpe_ppo_update(int in, int kc, const float* weights, const float* obs, const float* mvoh,
                   const float* cmoh, const float* lpo, const float* adv, const float* ret,
                   const float* vold, float* partials, float* out, int n_ta, int n_envs,
                   int n_agents, int speak_mask, int n_parts, float ratio_lo, float ratio_hi,
                   float vclip, float vf_scale, float ent_scale, float inv_b,
                   cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, n_agents,
                       speak_mask};
  return (int)by_actor_head(in, kc, [&](auto ow, auto c) {
    return update_pass<decltype(ow)::value, MOVES, decltype(c)::value, true, false>(
        in, weights, obs, mvoh, cmoh, lpo, adv, ret, vold, partials, out, n_ta, n_envs, n_parts,
        k, inv_b, inv_b, inv_b, stream);
  });
}

// K7. Actor pass over the T*A rows of obs [T, A, OW, N] (adv [T, N]), then
// critic pass over the T rows of the joint obs [T, A*OW, N] (ret, vold [T, N]).
// partials: [n_parts, max(NG_a, NG_c)] scratch; out: [NG_a + NG_c], the actor's
// packed gradient (its pg and entropy means, vloss slot 0) then the critic's
// (its vloss mean)
int mpe_mappo_update(int ow, int kc, const float* actor_w, const float* critic_w,
                     const float* obs, const float* mvoh, const float* cmoh, const float* lpo,
                     const float* adv, const float* ret, const float* vold, float* partials,
                     float* out, int n_steps, int n_agents, int n_envs, int speak_mask,
                     int n_parts, float ratio_lo, float ratio_hi, float vclip, float vf_scale,
                     float ent_scale, float inv_b, float inv_bv, cudaStream_t stream) {
  const UpdateConsts k{ratio_lo, ratio_hi, vclip, vf_scale, ent_scale, inv_b, n_agents,
                       speak_mask};
  cudaError_t err = by_actor_head(ow, kc, [&](auto w, auto c) {
    return update_pass<decltype(w)::value, MOVES, decltype(c)::value, false, true>(
        ow, actor_w, obs, mvoh, cmoh, lpo, adv, nullptr, nullptr, partials, out,
        n_steps * n_agents, n_envs, n_parts, k, inv_b, 0.0f, inv_b, stream);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)update_pass<0, 0, 0, true, false>(
      n_agents * ow, critic_w, obs, nullptr, nullptr, nullptr, nullptr, ret, vold, partials,
      out + make_layout(ow, MOVES + kc, THREADS).ng, n_steps, n_envs, n_parts, k, 0.0f, inv_bv,
      0.0f, stream);
}

// the packed gradient's length of an in-64-64-ko MLP (ops/fused_update.py::_packed)
int mpe_update_packed_size(int in, int ko) { return make_layout(in, ko, THREADS).ng; }

}  // extern "C"

// The actor MLP 18-64-64-5 shared by the policy kernels (mpe_policy.cu: K4, K5;
// mpe_maddpg.cu: K8): one thread evaluates one agent's logits for one env lane.
// Every layer sums over its inputs in order, starting from the first product,
// then adds the bias, as the plain versions (ops/fused_policy.py::_seq_dense)
// do; with -fmad=false each multiply and add rounds on its own, and tanhf is
// the function PyTorch's CUDA tanh calls, so kernels and plain versions take
// the same actions.

#pragma once

#include "spread_common.cuh"

namespace {

constexpr int OW = 18;           // simple_spread obs width
constexpr int H = 64;            // hidden width
constexpr int K = MW;            // move logits (spread has no comm head)
// packed weights of one actor, kernel layout (ops/fused_policy.py::_pack_weights):
// w1 [H,OW], b1 [H], w2 [H,H], b2 [H], w3 [K,H], b3 [K]
constexpr int W1 = 0, B1 = W1 + H * OW, W2 = B1 + H, B2 = W2 + H * H, W3 = B2 + H,
              B3 = W3 + K * H, NW = B3 + K;
static_assert(W2 % 4 == 0 && H % 4 == 0, "w2 rows are read as float4, four rows at a time");

// four rows g..g+3 of w2 against h, each summed over its 64 inputs in order
// from the first product; the rows are independent chains, interleaved for
// instruction-level parallelism (one warp per SM has no other warp to hide
// the adds' latency)
__device__ __forceinline__ void dot64x4(const float* __restrict__ rows, const float (&h)[H],
                                        float (&acc)[4]) {
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(rows + j * H)[q];
      acc[j] = (q == 0) ? v.x * h[0] : acc[j] + v.x * h[4 * q + 0];
      acc[j] = acc[j] + v.y * h[4 * q + 1];
      acc[j] = acc[j] + v.z * h[4 * q + 2];
      acc[j] = acc[j] + v.w * h[4 * q + 3];
    }
  }
}

// the logits z = w3 tanh(w2 tanh(w1 x + b1) + b2) + b3 of the actor at `w`
// (16-byte aligned); h1 stays in registers, the second layer is streamed four
// units at a time into the logit sums, which run over the units in order
__device__ __forceinline__ void policy_logits(const float* __restrict__ w, const float (&x)[OW],
                                              float (&z)[K]) {
  float h1[H];
#pragma unroll
  for (int g = 0; g < H; ++g) {
    const float* row = w + W1 + g * OW;
    float acc = row[0] * x[0];
#pragma unroll
    for (int k = 1; k < OW; ++k) acc = acc + row[k] * x[k];
    h1[g] = tanhf(acc + w[B1 + g]);
  }
#pragma unroll
  for (int c = 0; c < K; ++c) z[c] = 0.0f;
#pragma unroll 1
  for (int g = 0; g < H; g += 4) {
    float acc[4];
    dot64x4(w + W2 + g * H, h1, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float h2 = tanhf(acc[j] + w[B2 + g + j]);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float p = w[W3 + c * H + g + j] * h2;
        z[c] = (g + j == 0) ? p : z[c] + p;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) z[c] = z[c] + w[B3 + c];
}

// the Gumbel score of logit z at U[0, 1) draw u: z - log(-log(u + 1e-12) + 1e-12)
__device__ __forceinline__ float gumbel_score(float z, float u) {
  return z - logf(-logf(u + 1e-12f) + 1e-12f);
}

}  // namespace

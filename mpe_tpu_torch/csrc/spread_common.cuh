// Device functions of simple_spread shared by the fused kernels (mpe_kernels.cu:
// K1, K2 through scenario_blocks.cuh's SpreadScn; mpe_policy.cu: K4, K5;
// mpe_maddpg.cu: K8): hashes, decode + pair physics, the shared reward, obs
// rows and the reset draw. Each function mirrors a plain PyTorch
// block in ops/fused_rollout.py or ops/kernel_scenarios.py.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 2;             // dim_p
constexpr int MW = 2 * P + 1;    // move row width

template <int A, int L>
struct SpreadParams {            // mirrored by ops/_build.py::_params_type
  float accel[A];                // decode sensitivity
  float dmin[A * A];             // size_i + size_j
  float coll_thresh2[A * A];     // (size_i + size_j)^2, rounded once
  float keep_vel;                // 1 - damping
  float dt;
  float contact_force;
  float contact_margin;
  float agent_range;
  float landmark_range;
};

// ---- hashes ---------------------------------------------------------------

// murmur3 finalizer (both hashes, fused_rollout.py:203-207, fused_parity.py:47-50)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// top 24 bits as U[0, 1): exact in float
__device__ __forceinline__ float unit24(uint32_t h) {
  return (float)(h >> 8) * 0x1p-24f;
}

// _hash_uniform with make_uniform's salt: mixed + step*64 + call_id, times 0x9E3779B1
__device__ __forceinline__ uint32_t rollout_salt(uint32_t mixed, int step, int call_id) {
  return (mixed + (uint32_t)step * 64u + (uint32_t)call_id) * 0x9E3779B1u;
}

// hash_uniform_2d's salt for agent i: step*131071 + 7*i + 3, times 0x9E3779B9
__device__ __forceinline__ uint32_t det_salt(int step, int agent) {
  return ((uint32_t)step * 131071u + (uint32_t)(7 * agent + 3)) * 0x9E3779B9u;
}

__device__ __forceinline__ float hash_uniform(uint32_t salt_mul, uint32_t flat) {
  return unit24(fmix32(flat + salt_mul));
}

// ---- physics: decode_move_block + generic_physics_block, agents only -------

template <int A, int L>
__device__ __forceinline__ void physics(const SpreadParams<A, L>& c, const float (&mv)[A][MW],
                                        float (&ax)[A], float (&ay)[A], float (&vx)[A],
                                        float (&vy)[A]) {
  float fx[A], fy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    fx[i] = (mv[i][1] - mv[i][2]) * c.accel[i];
    fy[i] = (mv[i][3] - mv[i][4]) * c.accel[i];
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = i + 1; j < A; ++j) {
      const float dx = ax[i] - ax[j];
      const float dy = ay[i] - ay[j];
      const float d2 = dx * dx + dy * dy;
      // rsqrt of max(d2, tiny): an exact overlap gives dist 0 and a zero force
      const float inv = rsqrtf(fmaxf(d2, FLT_MIN));
      const float dist = d2 * inv;
      const float x = -(dist - c.dmin[i * A + j]) / c.contact_margin;
      // logaddexp(0, x) = max(x, 0) + log1p(exp(-|x|)): x reaches the thousands
      const float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * c.contact_margin;
      const float s = (c.contact_force * pen) * inv;
      const float gx = s * dx;
      const float gy = s * dy;
      fx[i] = fx[i] + gx;
      fy[i] = fy[i] + gy;
      fx[j] = fx[j] - gx;
      fy[j] = fy[j] - gy;
    }
  }
  // damping before force, then position (core.py:158-169); unit mass, no clamp
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const float nvx = vx[i] * c.keep_vel + fx[i] * c.dt;
    const float nvy = vy[i] * c.keep_vel + fy[i] * c.dt;
    vx[i] = nvx;
    vy[i] = nvy;
    ax[i] = ax[i] + nvx * c.dt;
    ay[i] = ay[i] + nvy * c.dt;
  }
}

// ---- spread reward (fused_rollout.py:127-162): shared, pairs counted twice --

template <int A, int L>
__device__ __forceinline__ float spread_reward(const SpreadParams<A, L>& c, const float (&ax)[A],
                                               const float (&ay)[A], const float (&lx)[L],
                                               const float (&ly)[L]) {
  float base = 0.0f;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float dj = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float dx = ax[i] - lx[j];
      const float dy = ay[i] - ly[j];
      const float d = sqrtf(dx * dx + dy * dy);
      dj = (i == 0) ? d : fminf(dj, d);
    }
    base = base - dj;
  }
  float coll = 0.0f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = i + 1; j < A; ++j) {
      const float dx = ax[i] - ax[j];
      const float dy = ay[i] - ay[j];
      coll = coll + 2.0f * ((dx * dx + dy * dy < c.coll_thresh2[i * A + j]) ? 1.0f : 0.0f);
    }
  }
  return (float)A * base - coll - (float)A;
}

// ---- spread obs row r of agent i (simple_spread.py:84-100) ------------------
// [vel(2), pos(2), landmark rel (2L), other rel (2(A-1)), other comm (C(A-1)) = 0]

template <int A, int L, int C>
struct Obs {
  static constexpr int W = 2 * P + P * L + P * (A - 1) + C * (A - 1);
};

template <int A, int L>
__device__ __forceinline__ float obs_entry(int i, int r, const float (&ax)[A], const float (&ay)[A],
                                           const float (&vx)[A], const float (&vy)[A],
                                           const float (&lx)[L], const float (&ly)[L]) {
  if (r < 2) return r == 0 ? vx[i] : vy[i];
  if (r < 4) return r == 2 ? ax[i] : ay[i];
  r -= 4;
  if (r < 2 * L) return (r & 1) ? ly[r >> 1] - ay[i] : lx[r >> 1] - ax[i];
  r -= 2 * L;
  if (r < 2 * (A - 1)) {
    int j = r >> 1;
    j += (j >= i);                                   // other agents in world order
    return (r & 1) ? ay[j] - ay[i] : ax[j] - ax[i];
  }
  return 0.0f;                                       // silent agents' comm
}

// ---- reset draw (K2, K4, K5) ---------------------------------------------------

// make_samplers' sample_state: agents on call id `call`, landmarks on
// `call + 1`, zero velocity; element (e, d, lane) of a [rows, P, n] draw has
// flat index (e*P + d)*n + lane
template <int A, int L>
__device__ __forceinline__ void sample_state(const SpreadParams<A, L>& c, uint32_t mixed,
                                             uint32_t n, uint32_t lane, int step, int call,
                                             float (&ax)[A], float (&ay)[A], float (&vx)[A],
                                             float (&vy)[A], float (&lx)[L], float (&ly)[L]) {
  const uint32_t sa = rollout_salt(mixed, step, call);
  const uint32_t sl = rollout_salt(mixed, step, call + 1);
  const float ar = c.agent_range, lr = c.landmark_range;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    ax[i] = hash_uniform(sa, (uint32_t)(i * P + 0) * n + lane) * (2.0f * ar) - ar;
    ay[i] = hash_uniform(sa, (uint32_t)(i * P + 1) * n + lane) * (2.0f * ar) - ar;
    vx[i] = 0.0f;
    vy[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lx[j] = hash_uniform(sl, (uint32_t)(j * P + 0) * n + lane) * (2.0f * lr) - lr;
    ly[j] = hash_uniform(sl, (uint32_t)(j * P + 1) * n + lane) * (2.0f * lr) - lr;
  }
}

}  // namespace

// Device functions of the scenarios that the fused kernels run (mpe_kernels.cu:
// K2; mpe_trajectory.cu: K3), behind one interface so that a kernel is a
// template over the scenario:
//
//   S::A, S::L, S::G     agents, landmarks, goal indices per lane
//   S::C, S::CW          comm width drawn and emitted (0 without comm), its
//                        array width (at least 1)
//   S::GOAL_K            choices of each goal (floor(u * GOAL_K))
//   S::OW                obs row width
//   S::Params            the constants, mirrored by ops/_build.py
//   S::sample(...)       reset draw of the positions, zero velocity
//   S::physics(...)      decode + one physics step
//   S::reward(...)       the shared reward after the collaborative sum (R = 1)
//   S::obs(i, r, ...)    entry r of agent i's obs row
//   S::silent(c, i)      whether agent i's comm draw is zeroed
//
// SpreadScn wraps spread_common.cuh unchanged. SimpleScn, ReferenceScn and
// SpeakerListenerScn mirror KernelSimple, KernelReference and
// KernelSpeakerListener of ops/kernel_scenarios.py: no collide pair, so the
// physics is the decode, damping and integration of the movable agents
// (free_physics; an immovable agent's position and velocity are never
// touched), and a goal picks its landmark and color by an unrolled select, so
// the state stays in registers.

#pragma once

#include "spread_common.cuh"

namespace {

template <int A>
struct BlockParams {             // mirrored by ops/_build.py::_block_params_type
  float accel[A];                // decode sensitivity
  int movable[A];
  int silent[A];
  float keep_vel;                // 1 - damping
  float dt;                      // dt / mass with unit masses
  float agent_range;
  float landmark_range;
};

template <int A, int L, int G>
struct World {                   // one lane's state; landmarks never move
  float ax[A], ay[A], vx[A], vy[A], lx[L], ly[L];
  int goal[G > 0 ? G : 1];
};

// values[g] by an unrolled select (select_by_goal)
template <int L>
__device__ __forceinline__ float pick(const float (&v)[L], int g) {
  float out = v[0];
#pragma unroll
  for (int j = 1; j < L; ++j) out = (g == j) ? v[j] : out;
  return out;
}

// make_samplers' sample_state for BlockParams: agents on call id `call`,
// landmarks on `call + 1`, zero velocity
template <int A, int L, int G>
__device__ __forceinline__ void sample_block(const BlockParams<A>& c, uint32_t mixed, uint32_t n,
                                             uint32_t lane, int step, int call,
                                             World<A, L, G>& w) {
  const uint32_t sa = rollout_salt(mixed, step, call);
  const uint32_t sl = rollout_salt(mixed, step, call + 1);
  const float ar = c.agent_range, lr = c.landmark_range;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    w.ax[i] = hash_uniform(sa, (uint32_t)(i * P + 0) * n + lane) * (2.0f * ar) - ar;
    w.ay[i] = hash_uniform(sa, (uint32_t)(i * P + 1) * n + lane) * (2.0f * ar) - ar;
    w.vx[i] = 0.0f;
    w.vy[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    w.lx[j] = hash_uniform(sl, (uint32_t)(j * P + 0) * n + lane) * (2.0f * lr) - lr;
    w.ly[j] = hash_uniform(sl, (uint32_t)(j * P + 1) * n + lane) * (2.0f * lr) - lr;
  }
}

// generic_physics_block without collide pairs: damping before force, then
// position; unit masses and no speed limit (ops/_build.py refuses others)
template <int A, int L, int G>
__device__ __forceinline__ void free_physics(const BlockParams<A>& c, const float (&mv)[A][MW],
                                             World<A, L, G>& w) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    if (!c.movable[i]) continue;
    const float fx = (mv[i][1] - mv[i][2]) * c.accel[i];
    const float fy = (mv[i][3] - mv[i][4]) * c.accel[i];
    const float nvx = w.vx[i] * c.keep_vel + fx * c.dt;
    const float nvy = w.vy[i] * c.keep_vel + fy * c.dt;
    w.vx[i] = nvx;
    w.vy[i] = nvy;
    w.ax[i] = w.ax[i] + nvx * c.dt;
    w.ay[i] = w.ay[i] + nvy * c.dt;
  }
}

// ---- simple_spread: spread_common.cuh ------------------------------------------

struct SpreadScn {
  static constexpr int A = 3, L = 3, G = 0, C = 0, CW = 1, GOAL_K = 1;
  static constexpr int OW = Obs<3, 3, 2>::W;
  using Params = SpreadParams<A, L>;
  using W = World<A, L, G>;
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_state<A, L>(c, mixed, n, lane, step, call, w.ax, w.ay, w.vx, w.vy, w.lx, w.ly);
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    ::physics<A, L>(c, mv, w.ax, w.ay, w.vx, w.vy);
  }
  static __device__ __forceinline__ float reward(const Params& c, const W& w) {
    return spread_reward<A, L>(c, w.ax, w.ay, w.lx, w.ly);
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&)[A][CW]) {
    return obs_entry<A, L>(i, r, w.ax, w.ay, w.vx, w.vy, w.lx, w.ly);
  }
  static __device__ __forceinline__ bool silent(const Params&, int) { return true; }
};

// ---- simple (simple.py:41-50): reward -|l - a|^2, obs [vel, l - a] ------------

struct SimpleScn {
  static constexpr int A = 1, L = 1, G = 0, C = 0, CW = 1, GOAL_K = 1, OW = 4;
  using Params = BlockParams<A>;
  using W = World<A, L, G>;
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_block<A, L, G>(c, mixed, n, lane, step, call, w);
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    free_physics<A, L, G>(c, mv, w);
  }
  static __device__ __forceinline__ float reward(const Params&, const W& w) {
    const float rx = w.lx[0] - w.ax[0];
    const float ry = w.ly[0] - w.ay[0];
    return -(rx * rx + ry * ry);
  }
  static __device__ __forceinline__ float obs(int, int r, const W& w, const float (&)[A][CW]) {
    switch (r) {
      case 0: return w.vx[0];
      case 1: return w.vy[0];
      case 2: return w.lx[0] - w.ax[0];
      default: return w.ly[0] - w.ay[0];
    }
  }
  static __device__ __forceinline__ bool silent(const Params& c, int i) { return c.silent[i]; }
};

// ---- simple_reference (simple_reference.py:55-80) ------------------------------
// goal[i] is agent i's goal landmark; the reward, -|other - goal landmark|^2
// summed over both agents, is shared; obs [vel(2), landmark rel(6), goal
// color(3), the other's comm(10)]

__device__ __forceinline__ float reference_color(int g, int ch) {
  const float hi = (float)0.75, lo = (float)0.25;
  return g == ch ? hi : lo;
}

struct ReferenceScn {
  static constexpr int A = 2, L = 3, G = 2, C = 10, CW = 10, GOAL_K = 3, OW = 21;
  using Params = BlockParams<A>;
  using W = World<A, L, G>;
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_block<A, L, G>(c, mixed, n, lane, step, call, w);
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    free_physics<A, L, G>(c, mv, w);
  }
  static __device__ __forceinline__ float reward(const Params&, const W& w) {
    float shared = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int other = 1 - i;
      const float dx = w.ax[other] - pick<L>(w.lx, w.goal[i]);
      const float dy = w.ay[other] - pick<L>(w.ly, w.goal[i]);
      shared = shared - (dx * dx + dy * dy);
    }
    return shared;
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW]) {
    if (r < 2) return r == 0 ? w.vx[i] : w.vy[i];
    r -= 2;
    if (r < 2 * L) return (r & 1) ? w.ly[r >> 1] - w.ay[i] : w.lx[r >> 1] - w.ax[i];
    r -= 2 * L;
    if (r < 3) return reference_color(w.goal[i], r);
    return cm[1 - i][r - 3];
  }
  static __device__ __forceinline__ bool silent(const Params& c, int i) { return c.silent[i]; }
};

// ---- simple_speaker_listener (simple_speaker_listener.py:63-92) ---------------
// agent 0 speaks and never moves, agent 1 listens and moves; the shared reward
// is -2 |listener - goal landmark|^2; the speaker sees the goal color padded
// to 11, the listener [vel(2), landmark rel(6), the speaker's comm(3)]

__device__ __forceinline__ float speaker_listener_color(int g, int ch) {
  const float hi = (float)0.65, lo = (float)0.15;
  return g == ch ? hi : lo;
}

struct SpeakerListenerScn {
  static constexpr int A = 2, L = 3, G = 1, C = 3, CW = 3, GOAL_K = 3, OW = 11;
  using Params = BlockParams<A>;
  using W = World<A, L, G>;
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_block<A, L, G>(c, mixed, n, lane, step, call, w);
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    free_physics<A, L, G>(c, mv, w);
  }
  static __device__ __forceinline__ float reward(const Params&, const W& w) {
    const float dx = w.ax[1] - pick<L>(w.lx, w.goal[0]);
    const float dy = w.ay[1] - pick<L>(w.ly, w.goal[0]);
    return -2.0f * (dx * dx + dy * dy);
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW]) {
    if (i == 0) return r < 3 ? speaker_listener_color(w.goal[0], r) : 0.0f;
    if (r < 2) return r == 0 ? w.vx[1] : w.vy[1];
    r -= 2;
    if (r < 2 * L) return (r & 1) ? w.ly[r >> 1] - w.ay[1] : w.lx[r >> 1] - w.ax[1];
    return cm[0][r - 2 * L];
  }
  static __device__ __forceinline__ bool silent(const Params& c, int i) { return c.silent[i]; }
};

// ---- draws and state shared by the kernels ------------------------------------

// the block init (call ids 0/1, goals 8+2+g) or a lane's reset (3/4, 24+2+g)
template <class S>
__device__ __forceinline__ void draw_world(const typename S::Params& c, uint32_t mixed, uint32_t n,
                                           uint32_t lane, int step, int call, int goal_call,
                                           typename S::W& w) {
  S::sample(c, mixed, n, lane, step, call, w);
#pragma unroll
  for (int g = 0; g < S::G; ++g)
    w.goal[g] = (int)floorf(hash_uniform(rollout_salt(mixed, step, goal_call + 2 + g), lane) *
                            (float)S::GOAL_K);
}

// uniform((A, 5), step, 2): element (i, k) has flat index (i*5 + k)*n + lane
template <int A>
__device__ __forceinline__ void draw_moves(uint32_t salt, uint32_t n, uint32_t lane,
                                           float (&mv)[A][MW]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int k = 0; k < MW; ++k) mv[i][k] = hash_uniform(salt, (uint32_t)(i * MW + k) * n + lane);
}

// uniform((A, C), step, 16), silent agents' rows zeroed: element (i, k) has
// flat index (i*C + k)*n + lane
template <class S>
__device__ __forceinline__ void draw_comm(const typename S::Params& c, uint32_t salt, uint32_t n,
                                          uint32_t lane, float (&cm)[S::A][S::CW]) {
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int k = 0; k < S::C; ++k)
      cm[i][k] = S::silent(c, i) ? 0.0f : hash_uniform(salt, (uint32_t)(i * S::C + k) * n + lane);
}

// pos and vel [E, P, N] of one lane (landmarks at rest)
template <class S>
__device__ __forceinline__ void store_world(const typename S::W& w, float* __restrict__ pos,
                                            float* __restrict__ vel, size_t N, int g) {
#pragma unroll
  for (int i = 0; i < S::A; ++i) {
    pos[(i * P + 0) * N + g] = w.ax[i];
    pos[(i * P + 1) * N + g] = w.ay[i];
    vel[(i * P + 0) * N + g] = w.vx[i];
    vel[(i * P + 1) * N + g] = w.vy[i];
  }
#pragma unroll
  for (int j = 0; j < S::L; ++j) {
    pos[((S::A + j) * P + 0) * N + g] = w.lx[j];
    pos[((S::A + j) * P + 1) * N + g] = w.ly[j];
    vel[((S::A + j) * P + 0) * N + g] = 0.0f;
    vel[((S::A + j) * P + 1) * N + g] = 0.0f;
  }
}

}  // namespace

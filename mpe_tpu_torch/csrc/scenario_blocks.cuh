// Device functions of the scenarios that the fused kernels run (mpe_kernels.cu:
// K1, K2; mpe_trajectory.cu: K3; mpe_policy.cu: K4, K5; mpe_maddpg.cu: K8),
// behind one interface so that a kernel is a template over the scenario (K2
// runs them through the group functions at the end of this file):
//
//   S::A, S::L, S::G     agents, landmarks, goal indices per lane
//   S::C, S::CW          comm width drawn and emitted (0 without comm), its
//                        array width (at least 1)
//   S::GOAL_K            choices of each goal (floor(u * GOAL_K))
//   S::OW, S::R          obs row width, reward rows
//   S::Params            the constants, mirrored by ops/_build.py
//   S::sample(...)       reset draw of the positions, zero velocity
//   S::physics(...)      decode + one physics step
//   S::derive(c, w, cm)  per-step values that reward and obs share (world_comm's
//                        forest flags, visibility and squared distances; empty
//                        for the others), computed once per step
//   S::reward(c, w, cm, d, r)  fills the R reward rows (R = 1: the shared
//                        reward after the collaborative sum)
//   S::obs(i, r, w, cm, d)     entry r of agent i's obs row
//   S::silent(c, i)      whether agent i's comm draw is zeroed
//
// SpreadScn wraps spread_common.cuh unchanged. The others mirror the Kernel*
// blocks of ops/kernel_scenarios.py literally (a distance squares its sqrt
// where the block does, a min of squares takes one sqrt where the block does),
// and a goal picks its landmark and color by an unrolled select, so the state
// stays in registers. The physics takes the order of the scenario's JAX kernel:
//   - fewer than MIN_MXU_PAIRS = 4 pairs (simple_push's one; simple,
//     simple_reference, simple_speaker_listener, simple_adversary and
//     simple_crypto have none): generic_physics, generic_physics_block's
//     order, the pair forces added onto the action force;
//   - 4 pairs or more (simple_tag's 14, simple_world_comm's 21): pair_physics,
//     mxu_physics_block's order (ops/mxu_physics.py): the pair forces summed
//     from zero in pair order, then the action force, then (force + u) dt/m,
//     and the speed clamp v (1 + (factor - 1)). The pair list is a constexpr
//     table in the struct, unrolled by template recursion, so each pair's
//     entities are compile-time indices and the force accumulators stay in
//     registers; with one lane per thread (K1, K3-K5, K8) there is nothing to
//     gather across threads, so neither a matmul nor shared memory (K2's group
//     functions at the end split the pairs over a warp). An immovable entity (an
//     obstacle, an immobile agent) is never integrated, as the prep's damp = 1,
//     dt = 0 rows leave it.

#pragma once

#include "spread_common.cuh"

namespace {

// the constants of the eight scenarios other than simple_spread. K collide
// pairs, T squared thresholds of the reward and obs (each (size_i + size_j)^2
// in double, rounded once).
template <int A, int K, int T>
struct PhysParams {              // mirrored by ops/_build.py::_phys_params_type
  float accel[A];                // decode sensitivity
  int movable[A];
  int silent[A];
  float keep_vel;                // 1 - damping
  float dt;
  float agent_range;
  float landmark_range;
  float inv_mass_dt[A];          // dt / mass in double, rounded once
  float max_speed[A];            // +inf without a limit
  float max_speed2[A];           // max_speed^2 squared in float32
  float dmin[K > 0 ? K : 1];     // size_i + size_j of each collide pair
  float contact_force;
  float contact_margin;
  float thresh2[T > 0 ? T : 1];
};

struct NoDerived {};

// which physics a scenario's S::physics runs (the group functions below
// mirror each): spread_common.cuh's physics, generic_physics, pair_physics
enum { PHYS_SPREAD = 0, PHYS_GENERIC = 1, PHYS_PAIR = 2 };

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

// make_samplers' sample_state for PhysParams: agents on call id `call`,
// landmarks on `call + 1`, zero velocity
template <int A, int L, int G, class Pr>
__device__ __forceinline__ void sample_block(const Pr& c, uint32_t mixed, uint32_t n,
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

// ---- collide pairs ----------------------------------------------------------------

// entity e's coordinates: agents first, then landmarks
template <class S, int e>
__device__ __forceinline__ float ent_x(const typename S::W& w) {
  if constexpr (e < S::A) return w.ax[e]; else return w.lx[e - S::A];
}
template <class S, int e>
__device__ __forceinline__ float ent_y(const typename S::W& w) {
  if constexpr (e < S::A) return w.ay[e]; else return w.ly[e - S::A];
}

// the contact forces of pairs k.. in pair order, +f to i and -f to j where
// they are agents (landmarks never move): the pair math of
// generic_physics_block and mxu_physics_block, which agree per pair
template <class S, int k>
__device__ __forceinline__ void pair_forces(const typename S::Params& c, const typename S::W& w,
                                            float (&fx)[S::A], float (&fy)[S::A]) {
  if constexpr (k < S::K) {
    constexpr int i = S::pair(k, 0), j = S::pair(k, 1);
    const float dx = ent_x<S, i>(w) - ent_x<S, j>(w);
    const float dy = ent_y<S, i>(w) - ent_y<S, j>(w);
    const float d2 = dx * dx + dy * dy;
    // rsqrt of max(d2, tiny): an exact overlap gives dist 0 and a zero force
    const float inv = rsqrtf(fmaxf(d2, FLT_MIN));
    const float dist = d2 * inv;
    const float x = -(dist - c.dmin[k]) / c.contact_margin;
    const float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * c.contact_margin;
    const float s = (c.contact_force * pen) * inv;
    const float gx = s * dx;
    const float gy = s * dy;
    if constexpr (i < S::A) {
      fx[i] = fx[i] + gx;
      fy[i] = fy[i] + gy;
    }
    if constexpr (j < S::A) {
      fx[j] = fx[j] - gx;
      fy[j] = fy[j] - gy;
    }
    pair_forces<S, k + 1>(c, w, fx, fy);
  }
}

// generic_physics_block: each movable agent's force is its action force with
// the pair forces added on in pair order; damping before force, then
// position; no speed limit (ops/_build.py refuses one here)
template <class S>
__device__ __forceinline__ void generic_physics(const typename S::Params& c,
                                                const float (&mv)[S::A][MW], typename S::W& w) {
  constexpr int A = S::A;
  float fx[A], fy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    fx[i] = (mv[i][1] - mv[i][2]) * c.accel[i];
    fy[i] = (mv[i][3] - mv[i][4]) * c.accel[i];
  }
  pair_forces<S, 0>(c, w, fx, fy);
#pragma unroll
  for (int i = 0; i < A; ++i) {
    if (!c.movable[i]) continue;
    const float nvx = w.vx[i] * c.keep_vel + fx[i] * c.inv_mass_dt[i];
    const float nvy = w.vy[i] * c.keep_vel + fy[i] * c.inv_mass_dt[i];
    w.vx[i] = nvx;
    w.vy[i] = nvy;
    w.ax[i] = w.ax[i] + nvx * c.dt;
    w.ay[i] = w.ay[i] + nvy * c.dt;
  }
}

// mxu_physics_block: the pair forces summed from zero in pair order, then the
// action force; v = vel keep + (force + u) dt/m; the speed clamp multiplies by
// 1 + (factor - 1), factor = max_speed rsqrt(s2) where s2 > max_speed^2 (the
// square in float32); then position. 3 special functions per pair (rsqrt,
// exp, log1p) and 1 per agent (the clamp's rsqrt).
template <class S>
__device__ __forceinline__ void pair_physics(const typename S::Params& c,
                                             const float (&mv)[S::A][MW], typename S::W& w) {
  constexpr int A = S::A;
  float fx[A], fy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    fx[i] = 0.0f;
    fy[i] = 0.0f;
  }
  pair_forces<S, 0>(c, w, fx, fy);
#pragma unroll
  for (int i = 0; i < A; ++i) {
    if (!c.movable[i]) continue;
    const float ux = (mv[i][1] - mv[i][2]) * c.accel[i];
    const float uy = (mv[i][3] - mv[i][4]) * c.accel[i];
    float nvx = w.vx[i] * c.keep_vel + (fx[i] + ux) * c.inv_mass_dt[i];
    float nvy = w.vy[i] * c.keep_vel + (fy[i] + uy) * c.inv_mass_dt[i];
    const float s2 = nvx * nvx + nvy * nvy;
    const float inv_s = rsqrtf(fmaxf(s2, FLT_MIN));
    const float factor = s2 > c.max_speed2[i] ? c.max_speed[i] * inv_s : 1.0f;
    const float scale = 1.0f + (factor - 1.0f);
    nvx = nvx * scale;
    nvy = nvy * scale;
    w.vx[i] = nvx;
    w.vy[i] = nvy;
    w.ax[i] = w.ax[i] + nvx * c.dt;
    w.ay[i] = w.ay[i] + nvy * c.dt;
  }
}

// the screen-exit penalty of simple_tag.py:103-108 (scenarios/_base.py::bound_penalty)
__device__ __forceinline__ float bound_penalty(float x) {
  if (x < 0.9f) return 0.0f;
  if (x < 1.0f) return (x - 0.9f) * 10.0f;
  return fminf(expf(2.0f * x - 2.0f), 10.0f);
}

// ---- simple_spread: spread_common.cuh ------------------------------------------

struct SpreadScn {
  static constexpr int A = 3, L = 3, G = 0, C = 0, CW = 1, GOAL_K = 1, R = 1;
  static constexpr int OW = Obs<3, 3, 2>::W;
  static constexpr int K = 3, PHYS = PHYS_SPREAD;   // the agent pairs of physics<A, L>
  __host__ __device__ static constexpr int pair(int k, int side) {
    constexpr int t[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    return t[k][side];
  }
  using Params = SpreadParams<A, L>;
  using W = World<A, L, G>;
  using Derived = NoDerived;
  template <class Cm>
  static __device__ __forceinline__ Derived derive(const Params&, const W&, const Cm&) {
    return {};
  }
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_state<A, L>(c, mixed, n, lane, step, call, w.ax, w.ay, w.vx, w.vy, w.lx, w.ly);
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    ::physics<A, L>(c, mv, w.ax, w.ay, w.vx, w.vy);
  }
  static __device__ __forceinline__ void reward(const Params& c, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    r[0] = spread_reward<A, L>(c, w.ax, w.ay, w.lx, w.ly);
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&)[A][CW],
                                              const Derived&) {
    return obs_entry<A, L>(i, r, w.ax, w.ay, w.vx, w.vy, w.lx, w.ly);
  }
  static __device__ __forceinline__ bool silent(const Params&, int) { return true; }
};

// ---- the other eight scenarios (PhysParams) --------------------------------------

// sampling, the silent mask and nothing derived, shared by the eight below
template <int A_, int L_, int G_, int K_, int T_>
struct PhysScn {
  static constexpr int A = A_, L = L_, G = G_, K = K_, PHYS = PHYS_GENERIC;
  using Params = PhysParams<A, K, T_>;
  using W = World<A, L, G>;
  using Derived = NoDerived;
  static __device__ __forceinline__ void sample(const Params& c, uint32_t mixed, uint32_t n,
                                                uint32_t lane, int step, int call, W& w) {
    sample_block<A, L, G>(c, mixed, n, lane, step, call, w);
  }
  template <class Cm>
  static __device__ __forceinline__ Derived derive(const Params&, const W&, const Cm&) {
    return {};
  }
  static __device__ __forceinline__ bool silent(const Params& c, int i) { return c.silent[i]; }
};

// ---- simple (simple.py:41-50): reward -|l - a|^2, obs [vel, l - a] ------------

struct SimpleScn : PhysScn<1, 1, 0, 0, 0> {
  static constexpr int C = 0, CW = 1, GOAL_K = 1, OW = 4, R = 1;
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<SimpleScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    const float rx = w.lx[0] - w.ax[0];
    const float ry = w.ly[0] - w.ay[0];
    r[0] = -(rx * rx + ry * ry);
  }
  static __device__ __forceinline__ float obs(int, int r, const W& w, const float (&)[A][CW],
                                              const Derived&) {
    switch (r) {
      case 0: return w.vx[0];
      case 1: return w.vy[0];
      case 2: return w.lx[0] - w.ax[0];
      default: return w.ly[0] - w.ay[0];
    }
  }
};

// ---- simple_reference (simple_reference.py:55-80) ------------------------------
// goal[i] is agent i's goal landmark; the reward, -|other - goal landmark|^2
// summed over both agents, is shared; obs [vel(2), landmark rel(6), goal
// color(3), the other's comm(10)]

__device__ __forceinline__ float reference_color(int g, int ch) {
  const float hi = (float)0.75, lo = (float)0.25;
  return g == ch ? hi : lo;
}

struct ReferenceScn : PhysScn<2, 3, 2, 0, 0> {
  static constexpr int C = 10, CW = 10, GOAL_K = 3, OW = 21, R = 1;
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<ReferenceScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    float shared = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int other = 1 - i;
      const float dx = w.ax[other] - pick<L>(w.lx, w.goal[i]);
      const float dy = w.ay[other] - pick<L>(w.ly, w.goal[i]);
      shared = shared - (dx * dx + dy * dy);
    }
    r[0] = shared;
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW],
                                              const Derived&) {
    if (r < 2) return r == 0 ? w.vx[i] : w.vy[i];
    r -= 2;
    if (r < 2 * L) return (r & 1) ? w.ly[r >> 1] - w.ay[i] : w.lx[r >> 1] - w.ax[i];
    r -= 2 * L;
    if (r < 3) return reference_color(w.goal[i], r);
    return cm[1 - i][r - 3];
  }
};

// ---- simple_speaker_listener (simple_speaker_listener.py:63-92) ---------------
// agent 0 speaks and never moves, agent 1 listens and moves; the shared reward
// is -2 |listener - goal landmark|^2; the speaker sees the goal color padded
// to 11, the listener [vel(2), landmark rel(6), the speaker's comm(3)]

__device__ __forceinline__ float speaker_listener_color(int g, int ch) {
  const float hi = (float)0.65, lo = (float)0.15;
  return g == ch ? hi : lo;
}

struct SpeakerListenerScn : PhysScn<2, 3, 1, 0, 0> {
  static constexpr int C = 3, CW = 3, GOAL_K = 3, OW = 11, R = 1;
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<SpeakerListenerScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    const float dx = w.ax[1] - pick<L>(w.lx, w.goal[0]);
    const float dy = w.ay[1] - pick<L>(w.ly, w.goal[0]);
    r[0] = -2.0f * (dx * dx + dy * dy);
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW],
                                              const Derived&) {
    if (i == 0) return r < 3 ? speaker_listener_color(w.goal[0], r) : 0.0f;
    if (r < 2) return r == 0 ? w.vx[1] : w.vy[1];
    r -= 2;
    if (r < 2 * L) return (r & 1) ? w.ly[r >> 1] - w.ay[1] : w.lx[r >> 1] - w.ax[1];
    return cm[0][r - 2 * L];
  }
};

// ---- the scenarios with per-agent rewards ----------------------------------------

// agent i's position relative to entity e (a landmark if e >= A), coordinate r & 1
template <int A, int L, int G>
__device__ __forceinline__ float rel_to(const World<A, L, G>& w, int i, int e, int r) {
  if (e < A) return (r & 1) ? w.ay[e] - w.ay[i] : w.ax[e] - w.ax[i];
  return (r & 1) ? w.ly[e - A] - w.ay[i] : w.lx[e - A] - w.ax[i];
}

// ---- simple_adversary (simple_adversary.py:82-139) ----------------------------
// agent 0 the adversary; goal 0 picks 1 of 2 landmarks. Rewards: adversary
// -d0^2 with d0 = sqrt(d0^2) as the block computes it, good -min(d1, d2) + d0.
// Obs: good [goal rel(2), landmark rel(4), other rel(4)], the adversary the
// same without the goal, padded 8 -> 10.

struct AdversaryScn : PhysScn<3, 2, 1, 0, 0> {
  static constexpr int C = 0, CW = 1, GOAL_K = 2, OW = 10, R = 3;
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<AdversaryScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    const float gx = pick<L>(w.lx, w.goal[0]), gy = pick<L>(w.ly, w.goal[0]);
    float d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float dx = w.ax[i] - gx;
      const float dy = w.ay[i] - gy;
      d[i] = sqrtf(dx * dx + dy * dy);
    }
    r[0] = -(d[0] * d[0]);
    r[1] = -fminf(d[1], d[2]) + d[0];
    r[2] = r[1];
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&)[A][CW],
                                              const Derived&) {
    if (i != 0) {
      if (r < 2) return r == 0 ? pick<L>(w.lx, w.goal[0]) - w.ax[i]
                               : pick<L>(w.ly, w.goal[0]) - w.ay[i];
      r -= 2;
    } else if (r >= 8) {
      return 0.0f;
    }
    if (r < 4) return rel_to(w, i, A + (r >> 1), r);
    r -= 4;
    int j = r >> 1;
    j += (j >= i);                                   // other agents in world order
    return rel_to(w, i, j, r);
  }
};

// ---- simple_push (simple_push.py:62-96) ----------------------------------------
// agent 0 the adversary, 1 the good agent; one collide pair; goal 0 picks 1 of
// 2 landmarks. Rewards [d1 - d0, -d1]. Obs: adversary [vel, landmark rel(4),
// other rel(2)] padded 8 -> 19; good [vel, goal rel, own color(3), landmark
// rel(4), landmark colors(6), other rel(2)].

__device__ __forceinline__ float push_landmark_color(int k) {   // KernelPush.PUSH_LANDMARK_COLORS
  return (k == 1 || k == 5) ? 0.9f : 0.1f;
}

struct PushScn : PhysScn<2, 2, 1, 1, 0> {
  static constexpr int C = 0, CW = 1, GOAL_K = 2, OW = 19, R = 2;
  __host__ __device__ static constexpr int pair(int k, int side) {
    constexpr int t[1][2] = {{0, 1}};                // ops/_build.py::_BLOCK_SHAPES
    return t[k][side];
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<PushScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    const float gx = pick<L>(w.lx, w.goal[0]), gy = pick<L>(w.ly, w.goal[0]);
    const float dx0 = w.ax[0] - gx, dy0 = w.ay[0] - gy;
    const float dx1 = w.ax[1] - gx, dy1 = w.ay[1] - gy;
    const float d0 = sqrtf(dx0 * dx0 + dy0 * dy0);
    const float d1 = sqrtf(dx1 * dx1 + dy1 * dy1);
    r[0] = d1 - d0;
    r[1] = -d1;
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&)[A][CW],
                                              const Derived&) {
    if (r < 2) return r == 0 ? w.vx[i] : w.vy[i];
    r -= 2;
    if (i == 0) {
      if (r < 4) return rel_to(w, 0, A + (r >> 1), r);
      r -= 4;
      return r < 2 ? rel_to(w, 0, 1, r) : 0.0f;
    }
    const int g = w.goal[0];
    if (r < 2) return r == 0 ? pick<L>(w.lx, g) - w.ax[1] : pick<L>(w.ly, g) - w.ay[1];
    r -= 2;
    if (r < 3) return r == 0 ? 0.25f : (g == r - 1 ? 0.75f : 0.25f);   // 0.25 + 0.5 on goal+1
    r -= 3;
    if (r < 4) return rel_to(w, 1, A + (r >> 1), r);
    r -= 4;
    if (r < 6) return push_landmark_color(r);
    return rel_to(w, 1, 0, r - 6);
  }
};

// ---- simple_crypto (simple_crypto.py:97-169) -----------------------------------
// eve 0, bob 1, alice 2, all immobile, no pair: the physics moves nothing.
// goal 0 is the goal landmark, goal 1 the key landmark, each color a one-hot
// of width 4. The reward reads this step's utterances: guarded(c) = [c != 0]
// |c - goal color|^2, summed over the 4 channels in order; eve -guarded(eve),
// alice and bob -guarded(bob) + guarded(eve). Obs: eve [alice's comm, 0(4)],
// bob [key, alice's comm], alice [goal color, key].

struct CryptoScn : PhysScn<3, 2, 2, 0, 0> {
  static constexpr int C = 4, CW = 4, GOAL_K = 2, OW = 8, R = 3;
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    generic_physics<CryptoScn>(c, mv, w);
  }
  static __device__ __forceinline__ float guarded(const float (&c)[CW], int goal) {
    float nz = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) nz = fmaxf(nz, c[k] != 0.0f ? 1.0f : 0.0f);
    float err = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float e = c[k] - (goal == k ? 1.0f : 0.0f);
      err = k == 0 ? e * e : err + e * e;
    }
    return nz * err;
  }
  static __device__ __forceinline__ void reward(const Params&, const W& w, const float (&cm)[A][CW],
                                                const Derived&, float (&r)[R]) {
    const float eve = guarded(cm[0], w.goal[0]);
    r[0] = -eve;
    r[1] = -guarded(cm[1], w.goal[0]) + eve;
    r[2] = r[1];
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW],
                                              const Derived&) {
    if (i == 0) return r < 4 ? cm[2][r] : 0.0f;
    if (i == 1) return r < 4 ? (w.goal[1] == r ? 1.0f : 0.0f) : cm[2][r - 4];
    return r < 4 ? (w.goal[0] == r ? 1.0f : 0.0f) : (w.goal[1] == r - 4 ? 1.0f : 0.0f);
  }
};

// ---- simple_tag (simple_tag.py:89-147) -----------------------------------------
// agents 0-2 predators, 3 the prey; 2 colliding immovable obstacles; 14 collide
// pairs. thresh2[i] = (size_i + size_prey)^2. Rewards: predators 10 hits, the
// prey -10 hits - bound penalty. Obs [vel, pos, landmark rel(4), other rel(6),
// the prey's velocity or 0 for the prey].

struct TagScn : PhysScn<4, 2, 0, 14, 3> {
  static constexpr int C = 0, CW = 1, GOAL_K = 1, OW = 16, R = 4, PHYS = PHYS_PAIR;
  __host__ __device__ static constexpr int pair(int k, int side) {
    constexpr int t[14][2] = {{0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {1, 2}, {1, 3},
                              {1, 4}, {1, 5}, {2, 3}, {2, 4}, {2, 5}, {3, 4}, {3, 5}};
    return t[k][side];                               // ops/_build.py::_BLOCK_SHAPES
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    pair_physics<TagScn>(c, mv, w);
  }
  static __device__ __forceinline__ void reward(const Params& c, const W& w, const float (&)[A][CW],
                                                const Derived&, float (&r)[R]) {
    float hits = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float dx = w.ax[i] - w.ax[3];
      const float dy = w.ay[i] - w.ay[3];
      hits = hits + (dx * dx + dy * dy < c.thresh2[i] ? 1.0f : 0.0f);
    }
    const float bound = (0.0f + bound_penalty(fabsf(w.ax[3]))) + bound_penalty(fabsf(w.ay[3]));
    r[0] = r[1] = r[2] = 10.0f * hits;
    r[3] = -10.0f * hits - bound;
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&)[A][CW],
                                              const Derived&) {
    if (r < 2) return r == 0 ? w.vx[i] : w.vy[i];
    if (r < 4) return r == 2 ? w.ax[i] : w.ay[i];
    r -= 4;
    if (r < 4) return rel_to(w, i, A + (r >> 1), r);
    r -= 4;
    if (r < 6) {
      int j = r >> 1;
      j += (j >= i);
      return rel_to(w, i, j, r);
    }
    r -= 6;
    return i == 3 ? 0.0f : (r == 0 ? w.vx[3] : w.vy[3]);
  }
};

// ---- simple_world_comm (simple_world_comm.py:155-287) --------------------------
// agents 0-3 adversaries (0 the leader, the only speaker), 4-5 good;
// landmarks [obstacle, food0, food1, forest0, forest1]; 21 collide pairs (the
// agents and the obstacle). thresh2: [0, 8) (good g, adversary v) collisions,
// [8, 12) (good g, food f) touches, [12, 24) (agent i, forest f) membership,
// each row-major. Derived once per step: the squared good x adversary
// distances, the forest flags and the visibility. Rewards: adversary
// -0.1 sqrt(min over good of d^2) + 5 pair hits; good -5 hits - 2 bound + 2
// food touched + 0.05 sqrt(min food d^2) (the reference's positive sign).
// Obs: [vel, pos, landmark rel(10), other rel(10) masked by visibility], then
// adversary [good others' vel(4) masked, forest +-1(2), the leader's comm(4)],
// good [forest +-1(2), the other good's vel(2) masked, 0(6)].

struct WorldCommDerived {
  float d2ga[2][4];                // |good g - adversary v|^2
  bool in_f[6][2];                 // agent i inside forest f
  bool vis[6][6];                  // agent i sees agent j
};

struct WorldCommScn : PhysScn<6, 5, 0, 21, 24> {
  static constexpr int C = 4, CW = 4, GOAL_K = 1, OW = 34, R = 6, PHYS = PHYS_PAIR;
  static constexpr int NA = 4, NG = 2;
  using Derived = WorldCommDerived;
  __host__ __device__ static constexpr int pair(int k, int side) {
    constexpr int t[21][2] = {{0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {0, 6}, {1, 2},
                              {1, 3}, {1, 4}, {1, 5}, {1, 6}, {2, 3}, {2, 4}, {2, 5},
                              {2, 6}, {3, 4}, {3, 5}, {3, 6}, {4, 5}, {4, 6}, {5, 6}};
    return t[k][side];                               // ops/_build.py::_BLOCK_SHAPES
  }
  static __device__ __forceinline__ void physics(const Params& c, const float (&mv)[A][MW], W& w) {
    pair_physics<WorldCommScn>(c, mv, w);
  }
  template <class Cm>
  static __device__ __forceinline__ Derived derive(const Params& c, const W& w, const Cm&) {
    Derived d;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int v = 0; v < NA; ++v) {
        const float dx = w.ax[NA + g] - w.ax[v];
        const float dy = w.ay[NA + g] - w.ay[v];
        d.d2ga[g][v] = dx * dx + dy * dy;
      }
    bool out[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float dx = w.ax[i] - w.lx[3 + f];
        const float dy = w.ay[i] - w.ly[3 + f];
        d.in_f[i][f] = dx * dx + dy * dy < c.thresh2[12 + 2 * i + f];
      }
      out[i] = !(d.in_f[i][0] || d.in_f[i][1]);
    }
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < A; ++j)
        d.vis[i][j] = i == 0 || (d.in_f[i][0] && d.in_f[j][0]) || (d.in_f[i][1] && d.in_f[j][1]) ||
                      (out[i] && out[j]);
    return d;
  }
  static __device__ __forceinline__ void reward(const Params& c, const W& w, const float (&)[A][CW],
                                                const Derived& d, float (&r)[R]) {
    float pair_hits = 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int v = 0; v < NA; ++v)
        pair_hits = pair_hits + (d.d2ga[g][v] < c.thresh2[4 * g + v] ? 1.0f : 0.0f);
#pragma unroll
    for (int v = 0; v < NA; ++v) {
      const float dmin2 = fminf(d.d2ga[0][v], d.d2ga[1][v]);
      r[v] = -0.1f * sqrtf(dmin2) + 5.0f * pair_hits;
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int i = NA + g;
      float hits = 0.0f;
#pragma unroll
      for (int v = 0; v < NA; ++v) hits = hits + (d.d2ga[g][v] < c.thresh2[4 * g + v] ? 1.0f : 0.0f);
      const float bound = (0.0f + bound_penalty(fabsf(w.ax[i]))) + bound_penalty(fabsf(w.ay[i]));
      float touch = 0.0f, food_dmin2 = 0.0f;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float dx = w.ax[i] - w.lx[1 + f];
        const float dy = w.ay[i] - w.ly[1 + f];
        const float df2 = dx * dx + dy * dy;
        touch = touch + (df2 < c.thresh2[8 + 2 * g + f] ? 1.0f : 0.0f);
        food_dmin2 = f == 0 ? df2 : fminf(food_dmin2, df2);
      }
      r[i] = -5.0f * hits - 2.0f * bound + 2.0f * touch + 0.05f * sqrtf(food_dmin2);
    }
  }
  static __device__ __forceinline__ float obs(int i, int r, const W& w, const float (&cm)[A][CW],
                                              const Derived& d) {
    if (r < 2) return r == 0 ? w.vx[i] : w.vy[i];
    if (r < 4) return r == 2 ? w.ax[i] : w.ay[i];
    r -= 4;
    if (r < 2 * L) return rel_to(w, i, A + (r >> 1), r);
    r -= 2 * L;
    if (r < 2 * (A - 1)) {
      int j = r >> 1;
      j += (j >= i);
      return d.vis[i][j] ? rel_to(w, i, j, r) : 0.0f;
    }
    r -= 2 * (A - 1);
    if (i < NA) {
      if (r < 4) {                                   // the good agents' velocities
        const int j = NA + (r >> 1);
        return d.vis[i][j] ? ((r & 1) ? w.vy[j] : w.vx[j]) : 0.0f;
      }
      r -= 4;
      if (r < 2) return d.in_f[i][r] ? 1.0f : -1.0f;
      return cm[0][r - 2];                           // the leader's comm
    }
    if (r < 2) return d.in_f[i][r] ? 1.0f : -1.0f;
    r -= 2;
    if (r < 2) {                                     // the other good agent's velocity
      const int j = 2 * NA + 1 - i;
      return d.vis[i][j] ? (r == 0 ? w.vx[j] : w.vy[j]) : 0.0f;
    }
    return 0.0f;
  }
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

// the comm one-hot rows of the carried indices (a zero row where cidx < 0)
template <class S>
__device__ __forceinline__ void comm_rows(const int (&cidx)[S::A], float (&cm)[S::A][S::CW]) {
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int k = 0; k < S::CW; ++k) cm[i][k] = (k < S::C && cidx[i] == k) ? 1.0f : 0.0f;
}

// no utterance: the lane's start and every reset
template <class S>
__device__ __forceinline__ void reset_comm(int (&cidx)[S::A]) {
#pragma unroll
  for (int i = 0; i < S::A; ++i) cidx[i] = -1;
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

// ---- group-cooperative device functions (K1, K2) --------------------------------
//
// G threads of one warp share an env lane (G = 1, 2, 4 or 8; a thread's rank
// is its place in the group). Every thread of the group keeps the lane's world
// (S::W), comm and derived values in registers, the same on each; what splits
// without changing an operation's inputs or order is divided by rank:
//   - agent i's action force (its move draws and the decode) on rank i mod G,
//   - pair k's contact force on rank k mod G,
//   - agent i's comm draw on rank i mod G,
//   - the sum of agent i's obs row on rank i mod G.
// Each result reaches the group by __shfl_sync and is added in the per-lane
// functions' order: the forces in pair order, from the action force
// (generic_physics, spread's physics) or from zero (pair_physics); the obs
// total over the agents in order. So pos, vel, rew_sum and obs_sum do not
// depend on G. Integration, derive, reward and resets run on every thread
// of the group. The pair and obs slots read the state from a per-group copy
// in shared memory: their entity indices differ by rank, and a run-time index
// into the registers would move the world to local memory.

// a thread's agents and pairs, fixed for the rollout (rank r owns agents r,
// r + G, ... and pairs r, r + G, ...; a slot past the end repeats the last)
template <class S, int G>
struct GroupSlots {
  static constexpr int QA = (S::A + G - 1) / G, QK = (S::K + G - 1) / G;
  int agent[QA];
  float accel[QA];
  bool silent[QA];
  int pi[QK > 0 ? QK : 1], pj[QK > 0 ? QK : 1];
  float dmin[QK > 0 ? QK : 1];
};

// the state the group's slots read: a copy of the registers
template <class S>
struct GroupCopy {
  typename S::W w;
  float cm[S::A][S::CW];
  typename S::Derived d;
};

// v from rank src of this thread's group (every lane of the warp takes part)
template <int G>
__device__ __forceinline__ float group_get(float v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
    return __shfl_sync(0xffffffffu, v, src, G);
  }
}

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G > 1) __syncwarp();
}

// size_i + size_j of pair k
template <class S, int k>
__device__ __forceinline__ float pair_dmin(const typename S::Params& c) {
  if constexpr (S::PHYS == PHYS_SPREAD) {
    return c.dmin[S::pair(k, 0) * S::A + S::pair(k, 1)];
  } else {
    return c.dmin[k];
  }
}

template <class S, int k>
__device__ __forceinline__ void pair_slot(const typename S::Params& c, int kq, int& pi, int& pj,
                                          float& dmin) {
  if constexpr (k < S::K) {
    if (kq == k) {
      pi = S::pair(k, 0);
      pj = S::pair(k, 1);
      dmin = pair_dmin<S, k>(c);
    }
    pair_slot<S, k + 1>(c, kq, pi, pj, dmin);
  }
}

template <class S>
__device__ __forceinline__ bool silent_of(const typename S::Params& c, int i) {
  bool s = S::silent(c, 0);
#pragma unroll
  for (int j = 1; j < S::A; ++j) s = (i == j) ? S::silent(c, j) : s;
  return s;
}

template <class S, int G>
__device__ __forceinline__ void init_slots(const typename S::Params& c, int rank,
                                           GroupSlots<S, G>& sl) {
  using Sl = GroupSlots<S, G>;
#pragma unroll
  for (int q = 0; q < Sl::QA; ++q) {
    const int i = rank + q * G < S::A ? rank + q * G : S::A - 1;
    sl.agent[q] = i;
    sl.accel[q] = pick<S::A>(c.accel, i);
    sl.silent[q] = silent_of<S>(c, i);
  }
#pragma unroll
  for (int q = 0; q < Sl::QK; ++q) {
    const int k = rank + q * G < S::K ? rank + q * G : S::K - 1;
    pair_slot<S, 0>(c, k, sl.pi[q], sl.pj[q], sl.dmin[q]);
  }
}

// entity e's coordinates, e at run time
template <class S>
__device__ __forceinline__ float ent_x_at(const typename S::W& w, int e) {
  if (e < S::A) return w.ax[e];
  return w.lx[e - S::A];
}
template <class S>
__device__ __forceinline__ float ent_y_at(const typename S::W& w, int e) {
  if (e < S::A) return w.ay[e];
  return w.ly[e - S::A];
}

// the contact force of one pair on its separation: pair_forces' arithmetic
template <class Pr>
__device__ __forceinline__ void contact_force(const Pr& c, float dx, float dy, float dmin,
                                              float& gx, float& gy) {
  const float d2 = dx * dx + dy * dy;
  const float inv = rsqrtf(fmaxf(d2, FLT_MIN));
  const float dist = d2 * inv;
  const float x = -(dist - dmin) / c.contact_margin;
  const float pen = (fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)))) * c.contact_margin;
  const float s = (c.contact_force * pen) * inv;
  gx = s * dx;
  gy = s * dy;
}

// pairs k.. from their ranks, added in pair order: +f to i, -f to j (agents)
template <class S, int G, int k, int Q>
__device__ __forceinline__ void gather_pairs(const float (&gxq)[Q], const float (&gyq)[Q],
                                             float (&fx)[S::A], float (&fy)[S::A]) {
  if constexpr (k < S::K) {
    constexpr int i = S::pair(k, 0), j = S::pair(k, 1);
    const float gx = group_get<G>(gxq[k / G], k % G);
    const float gy = group_get<G>(gyq[k / G], k % G);
    if constexpr (i < S::A) {
      fx[i] = fx[i] + gx;
      fy[i] = fy[i] + gy;
    }
    if constexpr (j < S::A) {
      fx[j] = fx[j] - gx;
      fy[j] = fy[j] - gy;
    }
    gather_pairs<S, G, k + 1>(gxq, gyq, fx, fy);
  }
}

// The move draws of a step, move(i, k) = entry k of agent i's row, for the
// two streams: K2's draw_moves (one salt per step, entry (i MW + k) n + lane)
// and K1's hash_uniform_2d (no block salt: salt det_salt(step, i) per agent,
// entry k n + lane)
struct RolloutMoves {
  uint32_t salt, n, lane;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return hash_uniform(salt, (uint32_t)(i * MW + k) * n + lane);
  }
};
struct DetMoves {
  int step;
  uint32_t n, lane;
  __device__ __forceinline__ float operator()(int i, int k) const {
    return hash_uniform(det_salt(step, i), (uint32_t)k * n + lane);
  }
};

// S::physics split over the group: the action forces (from move, a
// RolloutMoves or DetMoves) and the pair forces by rank (the pairs read the
// copy wv, which holds w), then every thread integrates as the scenario's
// physics does. Ends with the group's reads of wv done. The move draws of
// entries 1-4 of each slot agent land in mvq[q][1..4] (K3 stores them; the
// rollouts call the overload below, whose array nothing reads).
template <class S, int G, class Moves>
__device__ __forceinline__ void group_physics(const typename S::Params& c,
                                              const GroupSlots<S, G>& sl, const Moves& move,
                                              const typename S::W& wv, typename S::W& w,
                                              float (&mvq)[GroupSlots<S, G>::QA][MW]) {
  using Sl = GroupSlots<S, G>;
  constexpr int A = S::A;
  float ux[A], uy[A];
  {
    float uxq[Sl::QA], uyq[Sl::QA];
#pragma unroll
    for (int q = 0; q < Sl::QA; ++q) {            // the decode reads entries 1-4 of agent i
      const int i = sl.agent[q];
      const float m1 = move(i, 1);
      const float m2 = move(i, 2);
      const float m3 = move(i, 3);
      const float m4 = move(i, 4);
      mvq[q][1] = m1;
      mvq[q][2] = m2;
      mvq[q][3] = m3;
      mvq[q][4] = m4;
      uxq[q] = (m1 - m2) * sl.accel[q];
      uyq[q] = (m3 - m4) * sl.accel[q];
    }
#pragma unroll
    for (int i = 0; i < A; ++i) {
      ux[i] = group_get<G>(uxq[i / G], i % G);
      uy[i] = group_get<G>(uyq[i / G], i % G);
    }
  }
  float fx[A], fy[A];
#pragma unroll
  for (int i = 0; i < A; ++i) {
    fx[i] = S::PHYS == PHYS_PAIR ? 0.0f : ux[i];
    fy[i] = S::PHYS == PHYS_PAIR ? 0.0f : uy[i];
  }
  if constexpr (S::K > 0) {
    float gxq[Sl::QK], gyq[Sl::QK];
#pragma unroll
    for (int q = 0; q < Sl::QK; ++q) {
      const float dx = ent_x_at<S>(wv, sl.pi[q]) - ent_x_at<S>(wv, sl.pj[q]);
      const float dy = ent_y_at<S>(wv, sl.pi[q]) - ent_y_at<S>(wv, sl.pj[q]);
      contact_force(c, dx, dy, sl.dmin[q], gxq[q], gyq[q]);
    }
    gather_pairs<S, G, 0>(gxq, gyq, fx, fy);
  }
  group_sync<G>();
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float nvx, nvy;
    if constexpr (S::PHYS == PHYS_SPREAD) {       // unit mass, no clamp
      nvx = w.vx[i] * c.keep_vel + fx[i] * c.dt;
      nvy = w.vy[i] * c.keep_vel + fy[i] * c.dt;
    } else if constexpr (S::PHYS == PHYS_GENERIC) {
      if (!c.movable[i]) continue;
      nvx = w.vx[i] * c.keep_vel + fx[i] * c.inv_mass_dt[i];
      nvy = w.vy[i] * c.keep_vel + fy[i] * c.inv_mass_dt[i];
    } else {                                      // pair_physics: + u, then the clamp
      if (!c.movable[i]) continue;
      nvx = w.vx[i] * c.keep_vel + (fx[i] + ux[i]) * c.inv_mass_dt[i];
      nvy = w.vy[i] * c.keep_vel + (fy[i] + uy[i]) * c.inv_mass_dt[i];
      const float s2 = nvx * nvx + nvy * nvy;
      const float inv_s = rsqrtf(fmaxf(s2, FLT_MIN));
      const float factor = s2 > c.max_speed2[i] ? c.max_speed[i] * inv_s : 1.0f;
      const float scale = 1.0f + (factor - 1.0f);
      nvx = nvx * scale;
      nvy = nvy * scale;
    }
    w.vx[i] = nvx;
    w.vy[i] = nvy;
    w.ax[i] = w.ax[i] + nvx * c.dt;
    w.ay[i] = w.ay[i] + nvy * c.dt;
  }
}

template <class S, int G, class Moves>
__device__ __forceinline__ void group_physics(const typename S::Params& c,
                                              const GroupSlots<S, G>& sl, const Moves& move,
                                              const typename S::W& wv, typename S::W& w) {
  float mvq[GroupSlots<S, G>::QA][MW];
  group_physics<S, G>(c, sl, move, wv, w, mvq);
}

// draw_comm split over the group: agent i's row drawn on its rank; each slot
// agent's silent-masked row also lands in cq[q] (K3 stores it)
template <class S, int G>
__device__ __forceinline__ void group_comm(const typename S::Params& c, const GroupSlots<S, G>& sl,
                                           uint32_t salt, uint32_t n, uint32_t lane,
                                           float (&cm)[S::A][S::CW],
                                           float (&cq)[GroupSlots<S, G>::QA][S::CW]) {
  using Sl = GroupSlots<S, G>;
#pragma unroll
  for (int i = 0; i < S::A; ++i)
#pragma unroll
    for (int k = 0; k < S::CW; ++k) cm[i][k] = 0.0f;
  if constexpr (S::C > 0) {
#pragma unroll
    for (int q = 0; q < Sl::QA; ++q)
#pragma unroll
      for (int k = 0; k < S::C; ++k)
        cq[q][k] = sl.silent[q] ? 0.0f
                                : hash_uniform(salt, (uint32_t)(sl.agent[q] * S::C + k) * n + lane);
#pragma unroll
    for (int i = 0; i < S::A; ++i) {
      if (S::silent(c, i)) continue;                // a zero row: nothing to bring
#pragma unroll
      for (int k = 0; k < S::C; ++k) cm[i][k] = group_get<G>(cq[i / G][k], i % G);
    }
  }
}

template <class S, int G>
__device__ __forceinline__ void group_comm(const typename S::Params& c, const GroupSlots<S, G>& sl,
                                           uint32_t salt, uint32_t n, uint32_t lane,
                                           float (&cm)[S::A][S::CW]) {
  float cq[GroupSlots<S, G>::QA][S::CW];
  group_comm<S, G>(c, sl, salt, n, lane, cm, cq);
}

// S::reward on the group: simple_spread's nearest-agent distance to landmark
// j (three square roots) on rank j mod G, the landmarks added in order as
// spread_reward adds them; the other scenarios' rows on every rank
template <class S, int G>
__device__ __forceinline__ void group_reward(const typename S::Params& c, int rank,
                                             const typename S::W& w,
                                             const float (&cm)[S::A][S::CW],
                                             const typename S::Derived& d, float (&r)[S::R]) {
  if constexpr (S::PHYS == PHYS_SPREAD && G > 1) {
    constexpr int A = S::A, L = S::L, QL = (L + G - 1) / G;
    float djq[QL];
#pragma unroll
    for (int q = 0; q < QL; ++q) {
      const int j = rank + q * G < L ? rank + q * G : L - 1;
      const float lx = pick<L>(w.lx, j), ly = pick<L>(w.ly, j);
      float dj = 0.0f;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float dx = w.ax[i] - lx;
        const float dy = w.ay[i] - ly;
        const float dist = sqrtf(dx * dx + dy * dy);
        dj = (i == 0) ? dist : fminf(dj, dist);
      }
      djq[q] = dj;
    }
    float base = 0.0f;
#pragma unroll
    for (int j = 0; j < L; ++j) base = base - group_get<G>(djq[j / G], j % G);
    float coll = 0.0f;
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = i + 1; j < A; ++j) {
        const float dx = w.ax[i] - w.ax[j];
        const float dy = w.ay[i] - w.ay[j];
        coll = coll + 2.0f * ((dx * dx + dy * dy < c.coll_thresh2[i * A + j]) ? 1.0f : 0.0f);
      }
    }
    r[0] = (float)A * base - coll - (float)A;
  } else {
    S::reward(c, w, cm, d, r);
  }
}

// the obs checksum of one step: each agent's row summed in order on its rank,
// then the agents' sums in order
template <class S, int G>
__device__ __forceinline__ float group_obs_total(const GroupSlots<S, G>& sl,
                                                 const typename S::W& wv,
                                                 const float (&cmv)[S::A][S::CW],
                                                 const typename S::Derived& dv) {
  using Sl = GroupSlots<S, G>;
  float sq[Sl::QA];
#pragma unroll
  for (int q = 0; q < Sl::QA; ++q) {
    const int i = sl.agent[q];
    float s = S::obs(i, 0, wv, cmv, dv);
#pragma unroll
    for (int r = 1; r < S::OW; ++r) s = s + S::obs(i, r, wv, cmv, dv);
    sq[q] = s;
  }
  float total = group_get<G>(sq[0], 0);
#pragma unroll
  for (int i = 1; i < S::A; ++i) total = total + group_get<G>(sq[i / G], i % G);
  return total;
}

}  // namespace

// the scenario argument: ops/_build.py::SCENARIO_IDS
#define MPE_SCENARIO_SWITCH(CALL)     \
  switch (scenario) {                 \
    case 0: CALL(SpreadScn);          \
    case 1: CALL(SimpleScn);          \
    case 2: CALL(ReferenceScn);       \
    case 3: CALL(SpeakerListenerScn); \
    case 4: CALL(AdversaryScn);       \
    case 5: CALL(PushScn);            \
    case 6: CALL(CryptoScn);          \
    case 7: CALL(TagScn);             \
    case 8: CALL(WorldCommScn);       \
    default: return (int)cudaErrorInvalidValue; \
  }

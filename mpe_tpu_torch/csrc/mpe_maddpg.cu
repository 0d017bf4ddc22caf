// Hopper (sm_90a) kernels of the fused MADDPG loop, for the nine scenarios of
// scenario_blocks.cuh.
//
// K8  maddpg_traj_kernel<S>  replaces  mpe_tpu/ops/fused_maddpg.py::_maddpg_traj_kernel
//     (fused_maddpg_trajectory): per step, each agent's own actor
//     OW-H-H-(5+C) on its obs, Gumbel-max over the move logits (and over
//     the comm logits where the scenario speaks), each head eps-mixed with a
//     uniform one-hot; the step with the silent agents' comm zeroed, the
//     reward rows, per-lane reset at the horizon. Out: obs [T,A,OW,N], act
//     [T,A,5+C,N] one-hot (the raw comm sample, silent agents' included), rew
//     [T,R,N], obs2 [T,A,OW,N] (the true pre-reset next obs), or the finished
//     replay rows [T,N,W], W = A*(2*OW + 5 + C + 1), the shared reward
//     broadcast to every agent.
// K9  maddpg_target_actions_kernel<D> + maddpg_td_kernel<D> +
//     maddpg_update_kernel<D> + maddpg_reduce_kernel<D>, D = MaddpgDims<A, OW, C>,
//     replace  mpe_tpu/ops/fused_maddpg_update.py::_maddpg_update_kernel
//     (fused_maddpg_update): on a batch of replay rows [B, W], the first-argmax
//     target actions per head, the TD targets y = r + gamma Q'(s', a'), the
//     critic's forward and backward on the mean of (Q - y)^2 over [A, B], the
//     exact expected-Q actor gradient of the factored policy over the full
//     (move x comm) candidate grid, each candidate's Q built from the critic's
//     layer-1 pre-activation (minus the agent's own-action columns, plus the
//     candidate's two columns), and the entropy adjoint of both heads with its
//     1e-10 eps. Out: every agent's actor and critic gradient in the live
//     nets' layout of the weight buffer, and the three metrics.
//
// What bounds them: fp32 operations. K8 runs A actors per env-step (H (OW +
// H + 5 + C) multiply-adds each, H the hidden width of policy_mlp.cuh) and writes 4 W bytes of replay row; K9
// needs per (sample, agent) pair the target and live critics on the J = A (OW
// + 5 + C) joint inputs, 5 max(C, 1) candidates' layers 2-3 and the backward
// passes (chip_smoke.py::OPS counts them) against 4 W bytes read per sample;
// on the card a CTA also waits on its shared-memory reads and, at path d's
// 192 CTAs, on the one wave it fills.
//
// What the designs do about it.
// K8 is K5's lane tile (mpe_policy.cu, policy_mlp.cuh) with a weight block per
// agent: a CTA of TILE_THREADS threads owns a tile of TL env lanes
// (ops/fused_maddpg.py::maddpg_tile picks TL, 1 to 8; at path d's 1024 envs
// 2 to 8, so that the grid of 128-512 CTAs runs in one wave where the old
// one-warp CTAs filled 32 SMs). The A actors (at most 6 x 6,988 floats,
// 168 KB, on simple_world_comm) sit in dynamic shared memory in TileActor's
// layout, NWP floats apart, and the MLP of every (agent, lane) row runs as
// CTA-wide register-tiled products, each row with its agent's weights. Then
// one thread per row draws both eps-mixed heads, and one thread per lane
// steps its world (state and each agent's last utterance index in
// registers, as in K5) and writes the TRUE s' into the second of two
// input-row buffers, which is the next step's input unless the lanes reset.
// The rows form is written by the whole CTA: a step's rows of the tile's
// lanes are TL contiguous rows of RW floats, which the threads write in
// order from the two input-row buffers, the rows' action indices and the
// reward rows in shared memory (the old kernel wrote one row per thread, RW
// floats apart: a 32-byte sector per 4-byte store).
// K9: the agents' networks are independent until the loss, so a CTA takes one
// agent and a tile of TS9 = 1024 / H samples, 16 at hidden 64 (grid: batch
// tiles x agents: 64 x A CTAs at path d's batch of 1024, 192 on
// simple_spread). Four kernels, each
// with its nets in shared memory, w1 and w2 transposed so that a hidden unit's
// weights of one input are contiguous (SNet), loaded as float4s, eight in
// flight per thread: the target actions (the agent's target actor, at most
// 28 KB), the TD targets y (the target critic, simple_world_comm's J = 258
// critic 86 KB), the gradient, the reduce. Every dense layer runs as register
// tiles: each of the 128 threads owns 2 samples x 4 hidden units, and one
// float4 of weights and two activations from shared memory feed 8
// multiply-adds (one shared read per multiply-add and one weight per unit
// before); the backward pass through w2 reads w2's transpose by rows (four
// inputs of a unit per float4). Each (sample, unit) sum still runs over its
// inputs in order from the first product, the plain version's order: the
// expected-Q gradient p (qbar - E) is ill-conditioned in float32 on a trained
// critic (PERF.md), and in this order qbar, p and E agree with the plain
// version's to the bit, and so do the target logits (the argmax agrees). The
// gradient kernel holds the live critic and the actor (173 KB on
// simple_world_comm; 99 KB on simple_spread, two CTAs per SM). It runs the
// critic's forward and backward and its weight gradient, then the candidates:
// CG at a time (2 where two CTAs then share an SM, else 4), their layer-1 rows
// tanh(base + (w1[:, m] + w1[:, C + j])) and their h2 rows in the joint's
// place (no longer needed); only each candidate's Q is kept, [cand][sample];
// then the actor. A weight gradient is the tile's samples summed in order per
// entry, each thread a 4 x 4 micro-tile of entries (8 shared reads per 16
// multiply-adds); each CTA writes its partial gradient, and the reduce kernel
// sums the partials of an agent over the tiles in a fixed order, into the
// live nets' padded layout (the gradient buffer the trainer's Adam reads), and
// scales the metric sums. No float atomics: the result is the same from run
// to run. Tensor cores (TF32 or 3xTF32) would sum in another order and are
// left out.
//
// Hidden 128 and 256. The A actors no longer fit a CTA (235 KB at 128 on
// simple_spread), so K8 reads them from device memory (ACTORS_SMEM), its
// hidden layers on 8-row items that share each weight load within an agent's
// rows, as K4 and K5 do there. K9's nets and its per-tile partials would not
// fit either (about 480 MB of partials an update on simple_spread at 256):
// it runs three wide kernels on tiles of 32 samples that stream the nets from
// device memory in slices, its gradient on a persistent grid whose CTAs add
// each tile into their own partial ("K9 at hidden 128 and 256" below). Widths
// 8-64 keep the kernels above unchanged.

#include "policy_mlp.cuh"
#include "wide_stream.cuh"

static_assert(H == 8 || H == 16 || H == 32 || H == 64 || H == 128 || H == 256,
              "K8 and K9 take hidden 8, 16, 32, 64, 128 or 256 (ops/_build.py::HIDDEN_WIDTHS)");

namespace {

// Where K8's actors sit: up to hidden 64 in the CTA's shared memory; from 128
// in device memory (A actors of 19,589 floats at 128 on simple_spread are
// already 235 KB), read through the caches by 8-row items
// (tile_dense_tanh_x2), as K4 and K5 read theirs there
constexpr bool ACTORS_SMEM = H <= 64;

// The widths of one scenario's MADDPG nets and replay rows: A agents, OW obs
// rows, a head of MW moves and C comm logits (0 without comm), hidden H
template <int A_, int OW_, int C_>
struct MaddpgDims {
  static constexpr int A = A_, OW = OW_, C = C_, K = MW + C_;
  static constexpr int CX = C > 0 ? C : 1;                  // comm choices per move
  static constexpr int NCAND = MW * CX;                     // candidate m * CX + j
  static constexpr int NH = C > 0 ? 2 : 1;                  // heads
  using Actor = MlpLayout<OW, K>;                           // one actor's packed weights
  static constexpr int NW = Actor::NW;
  static constexpr int NWP = (NW + 3) / 4 * 4;              // padded stride (16-byte rows)
  static constexpr int J = A * (OW + K);                    // the critic's joint: obs, actions
  static constexpr int AO = A * OW, AK = A * K;
  static constexpr int RW = A * (2 * OW + K + 1);           // row [obs | act | rew | obs2]
  static constexpr int R_REW = AO + AK, R_OBS2 = R_REW + A;
  // one critic J-H-H-1, kernel layout: w1 [H,J], b1 [H], w2 [H,H], b2 [H], w3 [1,H], b3 [1]
  static constexpr int CW1 = 0, CB1 = CW1 + H * J, CW2 = CB1 + H, CB2 = CW2 + H * H,
                       CW3 = CB2 + H, CB3 = CW3 + H, NC = CB3 + 1;
  static constexpr int NCP = (NC + 3) / 4 * 4;
  // the weight buffer: actors, critics, target actors, target critics, agent-major
  static constexpr int OFF_A = 0, OFF_C = OFF_A + A * NWP, OFF_TA = OFF_C + A * NCP,
                       OFF_TC = OFF_TA + A * NWP, N_WEIGHTS = OFF_TC + A * NCP;
  // an agent's gradient: its actor (the NW layout), its critic (the NC
  // layout), then the (critic loss, Q, actor objective) sums
  static constexpr int G_ACTOR = 0, G_CRITIC = NW, G_MS = G_CRITIC + NC, NG = G_MS + 3;
  static_assert(OFF_TA % 4 == 0 && NCP % 4 == 0, "actors' rows must stay 16-byte aligned");
};

template <class S>
using DimsOf = MaddpgDims<S::A, S::OW, S::C>;

// ---- K8 ---------------------------------------------------------------------

// One head of _peragent_sample: Gumbel-max over logits z[K0, K0 + W) with
// uniform((W, n)) on salt_g, eps-mixed: a uniform one-hot by Gumbel-max of
// zeros on salt_e, taken where uniform((1, n)) on salt_c is below eps.
// First-max tie-break.
template <int K0, int W, int KP>
__device__ __forceinline__ int eps_gumbel_head(const float (&z)[KP], uint32_t salt_g,
                                               uint32_t salt_e, uint32_t salt_c, uint32_t n,
                                               uint32_t lane, float eps) {
  int best = 0;
  float best_s = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float s = gumbel_score(z[K0 + c], hash_uniform(salt_g, (uint32_t)c * n + lane));
    if (c == 0 || s > best_s) {
      best_s = s;
      best = c;
    }
  }
  if (eps > 0.0f) {
    int rnd = 0;
    float rnd_s = 0.0f;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float s = gumbel_score(0.0f, hash_uniform(salt_e, (uint32_t)c * n + lane));
      if (c == 0 || s > rnd_s) {
        rnd_s = s;
        rnd = c;
      }
    }
    if (hash_uniform(salt_c, lane) < eps) best = rnd;
  }
  return best;
}

// _peragent_sample on the tile's rows: row (agent i, lane l) runs its move
// head on call ids 28 + 6i (Gumbel), 29 + 6i (eps one-hot), 30 + 6i (eps
// coin) and, where the scenario speaks, its comm head on 31-33 + 6i, drawn
// for a silent agent too -> act[row] = move + 16 comm
template <class S>
__device__ __forceinline__ void sample_rows(const float* z, int* act, const TileRows& tr, int tlv,
                                            int g0, uint32_t n, uint32_t seed,
                                            uint32_t block_offset, int chunk, int step,
                                            float eps) {
  constexpr int KP = MW + S::C;
  for (int row = threadIdx.x; row < tr.nr; row += blockDim.x) {
    const int i = row / tr.tlp, l = row - i * tr.tlp;
    if (l >= tlv) continue;
    const uint32_t g = (uint32_t)(g0 + l), lane = g % n;
    const uint32_t mixed = seed * 7919u + (g / n + block_offset) * 104729u +
                           (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    float zr[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) zr[k] = z[k * tr.ldx + row];
    const int base = 28 + 6 * i;
    const int move = eps_gumbel_head<0, MW>(zr, rollout_salt(mixed, step, base),
                                            rollout_salt(mixed, step, base + 1),
                                            rollout_salt(mixed, step, base + 2), n, lane, eps);
    int comm = 0;
    if constexpr (S::C > 0) {
      comm = eps_gumbel_head<MW, S::C>(zr, rollout_salt(mixed, step, base + 3),
                                       rollout_salt(mixed, step, base + 4),
                                       rollout_salt(mixed, step, base + 5), n, lane, eps);
    }
    act[row] = move + 16 * comm;
  }
}

// The rows form of one step: the tile's lanes' rows [obs | act | rew | obs2]
// are contiguous, TLV RW floats at dst; the CTA's threads write them in order,
// reading the obs and obs2 from the two input-row buffers, the one-hots from
// the rows' action indices and the rewards from their rows
template <class S>
__device__ __forceinline__ void write_rows(float* __restrict__ dst, const float* x, const float* x2,
                                           const int* act, const float* rew,
                                           const TileRows& tr, int tlv) {
  using D = DimsOf<S>;
  constexpr int OW = S::OW, K = D::K;
  for (int e = threadIdx.x; e < tlv * D::RW; e += blockDim.x) {
    const int l = e / D::RW, col = e - l * D::RW;
    float v;
    if (col < D::AO) {
      const int i = col / OW;
      v = x[(col - i * OW) * tr.ldx + i * tr.tlp + l];
    } else if (col < D::R_REW) {
      const int q = col - D::AO, i = q / K, k = q - i * K;
      const int a = act[i * tr.tlp + l];
      v = (k < MW ? k == (a & 15) : k - MW == (a >> 4)) ? 1.0f : 0.0f;
    } else if (col < D::R_OBS2) {
      v = rew[(S::R == 1 ? 0 : col - D::R_REW) * tr.tlp + l];
    } else {
      const int q = col - D::R_OBS2, i = q / OW;
      v = x2[(q - i * OW) * tr.ldx + i * tr.tlp + l];
    }
    dst[e] = v;
  }
}

template <class S>
__global__ void __launch_bounds__(TILE_THREADS)
maddpg_traj_kernel(const typename S::Params c, const float* __restrict__ weights,
                   float* __restrict__ obs, float* __restrict__ act, float* __restrict__ rew,
                   float* __restrict__ obs2, float* __restrict__ rows, int n_envs,
                   int block_envs, int n_chunks, int t_chunk, int horizon, float eps,
                   uint32_t seed, uint32_t block_offset, int tile) {
  using D = DimsOf<S>;
  using M = TileActor<S::OW, D::K>;
  constexpr int A = S::A, OW = S::OW, K = D::K, R = S::R;
  static_assert(R == 1 || R == A, "a replay row holds one reward per agent");
  extern __shared__ __align__(16) float smem[];
  const TileRows tr = tile_rows(tile, A);
  const float* const w = ACTORS_SMEM ? smem : weights;
  float* const xb = smem + (ACTORS_SMEM ? A * M::NWP : 0);   // two input-row buffers,
  float* const h1 = xb + 2 * OW * tr.ldx;    // then the logits     // OW LDX floats each
  float* const h2 = h1 + H * tr.ldx;
  int* const acts = reinterpret_cast<int*>(h2 + H * tr.ldx);
  float* const rews = reinterpret_cast<float*>(acts + tr.nr);
  if constexpr (ACTORS_SMEM) load_float4s(smem, weights, A * M::NWP / 4);

  const int g0 = blockIdx.x * tile;
  const int tlv = n_envs - g0 < tile ? n_envs - g0 : tile;      // lanes of a ragged tile
  const int l = threadIdx.x;
  const bool owner = l < tlv;
  const size_t N = (size_t)n_envs;
  const int n_steps = n_chunks * t_chunk;
  const uint32_t n = (uint32_t)block_envs;
  const int g = g0 + l;
  const uint32_t lane = (uint32_t)g % n;
  const uint32_t mixed0 = seed * 7919u + ((uint32_t)g / n + block_offset) * 104729u;
  // the tensor form's obs rows of step s, null past the last step
  auto obs_at = [&](int s) -> float* {
    return rows == nullptr && s < n_steps ? obs + (size_t)s * A * OW * N + g : nullptr;
  };

  typename S::W wd;
  int cidx[A];
  if (owner) {
    draw_world<S>(c, mixed0, n, lane, 0, 0, 8, wd);
    reset_comm<S>(cidx);
    put_fresh_obs<S>(c, wd, cidx, xb, tr, l, obs_at(0), N);
  }
  int t = 0, cur = 0;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint32_t mixed = mixed0 + (uint32_t)chunk * 15485863u;   // make_uniform's extra salt 0
    for (int step = 0; step < t_chunk; ++step) {
      const int ts = chunk * t_chunk + step;
      float* const x = xb + cur * OW * tr.ldx;
      float* const x2 = xb + (cur ^ 1) * OW * tr.ldx;
      __syncthreads();                                 // x holds the tile's obs
      tile_mlp<OW, K, !ACTORS_SMEM>(w, M::NWP, x, h1, h2, tr);
      sample_rows<S>(h1, acts, tr, tlv, g0, n, seed, block_offset, chunk, step, eps);
      __syncthreads();
      t += 1;
      const bool reset = t >= horizon;                 // every lane's horizon is shared
      if (owner) {
        float mv[A][MW];
#pragma unroll
        for (int i = 0; i < A; ++i) {
          const int a = acts[i * tr.tlp + l], move = a & 15, comm = a >> 4;
#pragma unroll
          for (int k = 0; k < MW; ++k) mv[i][k] = (k == move) ? 1.0f : 0.0f;
          if (rows == nullptr) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              act[(((size_t)ts * A + i) * K + k) * N + g] =
                  (k < MW ? k == move : k - MW == comm) ? 1.0f : 0.0f;
          }
          cidx[i] = (S::C > 0 && !S::silent(c, i)) ? comm : -1;   // the dynamics' comm
        }
        S::physics(c, mv, wd);
        float cm[A][S::CW];
        comm_rows<S>(cidx, cm);
        const typename S::Derived d = S::derive(c, wd, cm);
        float r[R];
        S::reward(c, wd, cm, d, r);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (rows == nullptr) {
            rew[((size_t)ts * R + k) * N + g] = r[k];
          } else {
            rews[k * tr.tlp + l] = r[k];
          }
        }
        float* const gobs2 = rows == nullptr ? obs2 + (size_t)ts * A * OW * N + g : nullptr;
        float* const gnext = reset ? nullptr : obs_at(ts + 1);
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int q = 0; q < OW; ++q) {
            const float v = S::obs(i, q, wd, cm, d);                 // the TRUE s'
            x2[q * tr.ldx + i * tr.tlp + l] = v;
            if (gobs2 != nullptr) gobs2[(size_t)(i * OW + q) * N] = v;
            if (gnext != nullptr) gnext[(size_t)(i * OW + q) * N] = v;
          }
      }
      if (rows != nullptr) {
        __syncthreads();                               // every lane's row is in place
        write_rows<S>(rows + ((size_t)ts * N + g0) * D::RW, x, x2, acts, rews, tr, tlv);
      }
      if (reset) {                                     // lane_fresh: call ids 3/4, goals 24+2+g
        if (rows != nullptr) __syncthreads();          // the rows have read x2
        if (owner) {
          draw_world<S>(c, mixed, n, lane, step, 3, 24, wd);
          reset_comm<S>(cidx);
          put_fresh_obs<S>(c, wd, cidx, x2, tr, l, obs_at(ts + 1), N);
        }
        t = 0;
      }
      cur ^= 1;
    }
  }
}

// ---- K9 ---------------------------------------------------------------------

constexpr int THREADS9 = 128;
constexpr int WARPS9 = THREADS9 / 32;
constexpr int UG9 = H / 4;                  // groups of 4 hidden units
constexpr int TS9 = 2 * THREADS9 / UG9;     // samples per CTA: 16 at hidden 64, 128 at 8
constexpr int LD9 = TS9 + 1;                // tile row stride (rows read down columns without
                                            // bank conflicts)
constexpr int SO9 = TS9 / 2;                // a thread's two samples: s and s + SO9
static_assert(THREADS9 == (TS9 / 2) * UG9, "the 2 x 4 micro-tiles cover TS9 samples x H units");

// a thread's micro-tile of a dense layer on a tile: samples s, s + SO9 and units
// g0 .. g0 + 3. Threads UG9 apart share the units; at hidden 64 a warp's 16
// unit groups read 256 contiguous bytes of a weight row as float4.
struct Tile9 {
  int s, g0;
};
__device__ __forceinline__ Tile9 tile9() {
  return {(int)threadIdx.x / UG9, ((int)threadIdx.x % UG9) * 4};
}

// a net NIN-H-H-NOUT in shared memory: w1 and w2 transposed (input major,
// the units of an input contiguous, rows WS9 = H + 4 floats apart so that a
// warp storing an input's units of consecutive inputs hits 8 banks, not 1),
// w3 [NOUT, H] and the biases as in the kernel layout
constexpr int WS9 = H + 4;
template <int NIN, int NOUT>
struct SNet {
  static constexpr int W1T = 0, B1 = W1T + NIN * WS9, W2T = B1 + H, B2 = W2T + H * WS9,
                       W3 = B2 + H, B3 = W3 + NOUT * H, N = B3 + (NOUT + 3) / 4 * 4;
};

// entry e of a net's kernel-layout block (w1 [H, NIN], b1, w2 [H, H], b2, w3
// [NOUT, H], b3) to its place in the SNet
template <int NIN, int NOUT>
__device__ __forceinline__ void place_weight(int e, float v, float* dst) {
  using N = SNet<NIN, NOUT>;
  constexpr int E_B1 = H * NIN, E_W2 = E_B1 + H, E_B2 = E_W2 + H * H, E_W3 = E_B2 + H,
                NE = E_W3 + NOUT * H + NOUT;
  if (e < E_B1) {
    dst[N::W1T + (e % NIN) * WS9 + e / NIN] = v;
  } else if (e < E_W2) {
    dst[N::B1 + e - E_B1] = v;
  } else if (e < E_B2) {
    const int f = e - E_W2;
    dst[N::W2T + (f % H) * WS9 + f / H] = v;
  } else if (e < E_W3) {
    dst[N::B2 + e - E_B2] = v;
  } else if (e < NE) {
    dst[N::W3 + e - E_W3] = v;               // w3, then b3 right after it
  }
}

// a net's kernel-layout block (16-byte aligned, padded to a multiple of 4
// floats) into its SNet, the CTA's threads sharing it as float4s, LOADS9 of
// them in flight per thread before any is placed
constexpr int LOADS9 = 8;
template <int NIN, int NOUT>
__device__ __forceinline__ void load_net(const float* __restrict__ src, float* dst) {
  constexpr int NQ = (H * NIN + H + H * H + H + NOUT * H + NOUT + 3) / 4;
  const float4* __restrict__ src4 = reinterpret_cast<const float4*>(src);
  for (int q0 = threadIdx.x; q0 < NQ; q0 += LOADS9 * blockDim.x) {
    float4 v[LOADS9];
#pragma unroll
    for (int p = 0; p < LOADS9; ++p) {
      const int q = q0 + p * blockDim.x;
      if (q < NQ) v[p] = src4[q];
    }
#pragma unroll
    for (int p = 0; p < LOADS9; ++p) {
      const int q = q0 + p * blockDim.x;
      if (q < NQ) {
        place_weight<NIN, NOUT>(4 * q + 0, v[p].x, dst);
        place_weight<NIN, NOUT>(4 * q + 1, v[p].y, dst);
        place_weight<NIN, NOUT>(4 * q + 2, v[p].z, dst);
        place_weight<NIN, NOUT>(4 * q + 3, v[p].w, dst);
      }
    }
  }
}

// acc[q][u] = sum over the NIN inputs h, in order from the first product, of
// w[h WS + g0 + u] x[h LD9 + s + q SO9]: 2 x 4 sums per thread, each input's
// four weights read as one float4 and its two samples as two scalars
template <int NIN, int WS>
__device__ __forceinline__ void dense_tile(const float* __restrict__ w, const float* x, Tile9 t,
                                           float (&acc)[2][4]) {
  {
    const float4 wv = *reinterpret_cast<const float4*>(w + t.g0);
    const float x0 = x[t.s], x1 = x[t.s + SO9];
    acc[0][0] = wv.x * x0;
    acc[0][1] = wv.y * x0;
    acc[0][2] = wv.z * x0;
    acc[0][3] = wv.w * x0;
    acc[1][0] = wv.x * x1;
    acc[1][1] = wv.y * x1;
    acc[1][2] = wv.z * x1;
    acc[1][3] = wv.w * x1;
  }
#pragma unroll 4
  for (int h = 1; h < NIN; ++h) {
    const float4 wv = *reinterpret_cast<const float4*>(w + h * WS + t.g0);
    const float x0 = x[h * LD9 + t.s], x1 = x[h * LD9 + t.s + SO9];
    acc[0][0] = acc[0][0] + wv.x * x0;
    acc[0][1] = acc[0][1] + wv.y * x0;
    acc[0][2] = acc[0][2] + wv.z * x0;
    acc[0][3] = acc[0][3] + wv.w * x0;
    acc[1][0] = acc[1][0] + wv.x * x1;
    acc[1][1] = acc[1][1] + wv.y * x1;
    acc[1][2] = acc[1][2] + wv.z * x1;
    acc[1][3] = acc[1][3] + wv.w * x1;
  }
}

// The backward pass through w2 on its transpose (rows of units, each unit's
// inputs contiguous, rows WS9 apart): acc[q][u] = sum over the H inputs g, in
// order from the first product, of wt[(ug + UG9 u) WS9 + g] x[g LD9 + s + q
// SO9], units ug, ug + UG9, ug + 2 UG9, ug + 3 UG9 (ug = g0 / 4); four inputs
// of a unit read as one float4
__device__ __forceinline__ void dense_rows(const float* __restrict__ wt, const float* x, Tile9 t,
                                           float (&acc)[2][4]) {
  const int ug = t.g0 >> 2;
#pragma unroll 2
  for (int g = 0; g < H; g += 4) {
    float4 wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wv[u] = *reinterpret_cast<const float4*>(wt + (ug + UG9 * u) * WS9 + g);
    float x0[4], x1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x0[c] = x[(g + c) * LD9 + t.s];
      x1[c] = x[(g + c) * LD9 + t.s + SO9];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float w4[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      if (g == 0) {
        acc[0][u] = w4[0] * x0[0];
        acc[1][u] = w4[0] * x1[0];
      } else {
        acc[0][u] = acc[0][u] + w4[0] * x0[0];
        acc[1][u] = acc[1][u] + w4[0] * x1[0];
      }
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        acc[0][u] = acc[0][u] + w4[c] * x0[c];
        acc[1][u] = acc[1][u] + w4[c] * x1[c];
      }
    }
  }
}

// tanh(acc + b) of a micro-tile into the rows at out
__device__ __forceinline__ void store_tanh(const float (&acc)[2][4], const float* __restrict__ b,
                                           float* out, Tile9 t) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[(t.g0 + u) * LD9 + t.s + q * SO9] = tanhf(acc[q][u] + b[t.g0 + u]);
}

// a net's single output on the h2 rows at x (one sample's column): the sum
// over the H units in order, then b3 (right after w3)
__device__ __forceinline__ float net_out(const float* __restrict__ w3, const float* x) {
  float q = w3[0] * x[0];
#pragma unroll 16
  for (int g = 1; g < H; ++g) q = q + w3[g] * x[g * LD9];
  return q + w3[H];
}

// The weight and bias gradients of a layer NIN -> NOUT on a tile: part[o NIN +
// i] = sum over the tile's samples, in order from 0, of tile[ro + o][s]
// tile[ri + i][s], then part[NOUT NIN + o] = the sum of row ro + o. A warp
// takes 16 x 32 entries at a time, a thread a 4 x 4 micro-tile: 8 shared
// reads feed 16 multiply-adds.
template <int NOUT, int NIN>
__device__ __forceinline__ void weight_grads(const float* tile, int ro, int ri,
                                             float* __restrict__ part) {
  constexpr int SBO = (NOUT + 15) / 16, SBI = (NIN + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int sb = threadIdx.x >> 5; sb < SBO * SBI; sb += WARPS9) {
    const int o0 = (sb / SBI) * 16 + (lane >> 3) * 4, i0 = (sb % SBI) * 32 + (lane & 7) * 4;
    int ra[4], rb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {           // rows past the end read the last and store nothing
      ra[u] = (ro + (o0 + u < NOUT ? o0 + u : NOUT - 1)) * LD9;
      rb[u] = (ri + (i0 + u < NIN ? i0 + u : NIN - 1)) * LD9;
    }
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < TS9; ++s) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = tile[ra[u] + s];
        b[u] = tile[rb[u] + s];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = acc[u][v] + a[u] * b[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (o0 + u < NOUT && i0 + v < NIN) part[(o0 + u) * NIN + i0 + v] = acc[u][v];
  }
  for (int o = threadIdx.x; o < NOUT; o += blockDim.x) {
    const float* a = tile + (ro + o) * LD9;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < TS9; ++s) acc = acc + a[s];
    part[NOUT * NIN + o] = acc;
  }
}

// the tiles of the target-action kernel: s' of the agent, h1, h2; then the
// logits [K][TS9]
template <class D>
struct TaLayout {
  using Net = SNet<D::OW, D::K>;
  static constexpr int R_X = 0, R_H1 = D::OW, R_H2 = R_H1 + H, R_N = R_H2 + H;
  static constexpr int S_Z = Net::N, S_TILE = (S_Z + D::K * TS9 + 3) / 4 * 4;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LD9) * sizeof(float);
};

// the TD kernel's tiles: the joint (s', a'), h1, h2
template <class D>
struct TdLayout {
  using Net = SNet<D::J, 1>;
  static constexpr int R_X = 0, R_H1 = D::J, R_H2 = R_H1 + H, R_N = R_H2 + H;
  static constexpr size_t SMEM = (size_t)(Net::N + R_N * LD9) * sizeof(float);
};

// The gradient kernel's shared memory (floats): the agent's critic and actor
// (SNet), per-sample scalars (y, q, the candidates' Q [NCAND], logits [K],
// metric terms [3]), then the tiles. Tile rows: the inputs (the joint, later
// the agent's obs; in between the h1 and h2 rows of CG candidates), the
// candidates' base pre-activation, h1, h2, gh1, gh2, output gradients (1
// critic, K actor). CG is 2 where that lets two CTAs share an SM (the small
// scenarios; path d's simple_spread), else 4. launch_update's static_assert
// holds every scenario's layout to an SM's shared memory.
constexpr size_t SMEM_HALF = 115712;       // two CTAs per SM, 1 KB reserved each
template <class D, int CG_>
struct Layout9Of {
  using CNet = SNet<D::J, 1>;
  using ANet = SNet<D::OW, D::K>;
  static constexpr int CG = D::NCAND < CG_ ? D::NCAND : CG_;
  static constexpr int RXN = D::J > 2 * CG * H ? D::J : 2 * CG * H;
  static constexpr int R_X = 0, R_C1 = 0, R_C2 = CG * H, R_BASE = RXN, R_H1 = R_BASE + H,
                       R_H2 = R_H1 + H, R_GH1 = R_H2 + H, R_GH2 = R_GH1 + H, R_G3 = R_GH2 + H,
                       R_N = R_G3 + D::K;
  static constexpr int S_C = 0, S_A = S_C + CNet::N, S_Y = S_A + ANet::N, S_Q = S_Y + TS9,
                       S_QC = S_Q + TS9, S_Z = S_QC + D::NCAND * TS9, S_MS = S_Z + D::K * TS9,
                       S_TILE = (S_MS + 3 * TS9 + 3) / 4 * 4;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LD9) * sizeof(float);
};
template <class D>
using Layout9 = Layout9Of<D, Layout9Of<D, 2>::SMEM <= SMEM_HALF ? 2 : 4>;

struct MaddpgConsts {
  float gamma;
  float ent_coef;
  float inv;                                // 1 / (A * B)
};

// first max of z[K0, K0 + W)
template <int K0, int W, int KP>
__device__ __forceinline__ int first_argmax(const float (&z)[KP]) {
  int best = 0;
#pragma unroll
  for (int c = 1; c < W; ++c)
    if (z[K0 + c] > z[K0 + best]) best = c;
  return best;
}

// rows r0.. of width NR of the replay rows [b][RW] into tile rows (TS samples,
// rows LD floats apart), one column per sample (row b0 + s, or b0 past the
// batch); consecutive threads read consecutive floats of a replay row
template <int NR, int TS = TS9, int LD = LD9>
__device__ __forceinline__ void load_rows(const float* __restrict__ rows, int rw, int r0, int b0,
                                          int batch, float* dst) {
  for (int e0 = threadIdx.x; e0 < NR * TS; e0 += LOADS9 * blockDim.x) {
    float v[LOADS9];
#pragma unroll
    for (int p = 0; p < LOADS9; ++p) {
      const int e = e0 + p * blockDim.x, s = e / NR;
      const int b = b0 + s < batch ? b0 + s : b0;
      if (e < NR * TS) v[p] = rows[(size_t)b * rw + r0 + e - s * NR];
    }
#pragma unroll
    for (int p = 0; p < LOADS9; ++p) {
      const int e = e0 + p * blockDim.x, s = e / NR;
      if (e < NR * TS) dst[(e - s * NR) * LD + s] = v[p];
    }
  }
}

// grid (batch tiles of TS9 samples, agents): agent i's target actor on s'
// from shared memory, the first-argmax move and comm -> act2 [A, NH, B]
template <class D>
__global__ void __launch_bounds__(THREADS9)
maddpg_target_actions_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                             int* __restrict__ act2, int batch) {
  using L = TaLayout<D>;
  using N = typename L::Net;
  extern __shared__ __align__(16) float smem[];
  const Tile9 t = tile9();
  const int i = blockIdx.y, b0 = blockIdx.x * TS9;
  float* tile = smem + L::S_TILE;
  load_net<D::OW, D::K>(weights + D::OFF_TA + i * D::NWP, smem);
  load_rows<D::OW>(rows, D::RW, D::R_OBS2 + i * D::OW, b0, batch, tile + L::R_X * LD9);
  __syncthreads();
  float acc[2][4];
  dense_tile<D::OW, WS9>(smem + N::W1T, tile + L::R_X * LD9, t, acc);
  store_tanh(acc, smem + N::B1, tile + L::R_H1 * LD9, t);
  __syncthreads();
  dense_tile<H, WS9>(smem + N::W2T, tile + L::R_H1 * LD9, t, acc);
  store_tanh(acc, smem + N::B2, tile + L::R_H2 * LD9, t);
  __syncthreads();
  for (int e = threadIdx.x; e < D::K * TS9; e += THREADS9) {   // logit c, over the units in order
    const int c = e / TS9, s = e - c * TS9;
    const float* w3 = smem + N::W3 + c * H;
    const float* x = tile + L::R_H2 * LD9 + s;
    float z = w3[0] * x[0];
#pragma unroll 16
    for (int g = 1; g < H; ++g) z = z + w3[g] * x[g * LD9];
    smem[L::S_Z + e] = z + smem[N::B3 + c];
  }
  __syncthreads();
  const int s = threadIdx.x;
  if (s < TS9 && b0 + s < batch) {
    float z[D::K];
#pragma unroll
    for (int c = 0; c < D::K; ++c) z[c] = smem[L::S_Z + c * TS9 + s];
    act2[(i * D::NH) * batch + b0 + s] = first_argmax<0, MW>(z);
    if constexpr (D::C > 0) act2[(i * D::NH + 1) * batch + b0 + s] = first_argmax<MW, D::C>(z);
  }
}

// _softmax_eps of one head, logits z[K0, K0 + W) (stride ZS): p, s = log(p +
// 1e-10) + p / (p + 1e-10) -> the entropy -sum p log(p + 1e-10), each sum in
// index order
template <int K0, int W, int K, int ZS>
__device__ __forceinline__ float softmax_eps(const float* z, float (&p)[K], float (&sv)[K]) {
  float zm = 0.0f, sum = 0.0f, ent = 0.0f;
#pragma unroll
  for (int c = 0; c < W; ++c) zm = c == 0 ? z[K0 * ZS] : fmaxf(zm, z[(K0 + c) * ZS]);
#pragma unroll
  for (int c = 0; c < W; ++c) {
    p[K0 + c] = expf(z[(K0 + c) * ZS] - zm);
    sum = c == 0 ? p[K0] : sum + p[K0 + c];
  }
#pragma unroll
  for (int c = 0; c < W; ++c) {
    const float pc = p[K0 + c] / sum;
    const float lg = logf(pc + 1e-10f);
    p[K0 + c] = pc;
    sv[K0 + c] = lg + pc / (pc + 1e-10f);
    ent = ent - pc * lg;
  }
  return ent;
}

// One sample's actor head: _softmax_eps per head on its logits z (stride ZS),
// the expected Q E over its candidates' Q (qc, stride ZS) and the logit
// gradient -(p (qbar - E)) + ent_coef p (s - sum p s), times inv, into g[c
// ldg] (0 for a sample past the batch) -> its objective term E + ent_coef
// entropy (0 past the batch)
template <class D, int ZS>
__device__ __forceinline__ float actor_head(const float* z, const float* qc, float* g, int ldg,
                                            bool valid, const MaddpgConsts& k) {
  constexpr int K = D::K, C = D::C, CX = D::CX;
  float p[K], sv[K];
  const float ent = softmax_eps<0, MW, K, ZS>(z, p, sv) +
                    (C > 0 ? softmax_eps<MW, C, K, ZS>(z, p, sv) : 0.0f);
  // qbar_m[m] = sum_j pc[j] Q[m CX + j], qbar_c[j] = sum_m pm[m] Q[m CX + j],
  // each from the first term in index order; without comm qbar_m[m] = Q[m]
  float qbar[K], eq = 0.0f, sps_m = 0.0f;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    float qm = qc[(m * CX) * ZS];
    if constexpr (C > 0) {
      qm = p[MW] * qm;
#pragma unroll
      for (int j = 1; j < C; ++j) qm = qm + p[MW + j] * qc[(m * CX + j) * ZS];
    }
    qbar[m] = qm;
    eq = m == 0 ? p[0] * qm : eq + p[m] * qm;
    sps_m = m == 0 ? p[0] * sv[0] : sps_m + p[m] * sv[m];
  }
  float sps_c = 0.0f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float qj = p[0] * qc[j * ZS];
#pragma unroll
    for (int m = 1; m < MW; ++m) qj = qj + p[m] * qc[(m * CX + j) * ZS];
    qbar[MW + j] = qj;
    sps_c = j == 0 ? p[MW] * sv[MW] : sps_c + p[MW + j] * sv[MW + j];
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float sps = c < MW ? sps_m : sps_c;
    g[c * ldg] = valid ? (-(p[c] * (qbar[c] - eq)) + (k.ent_coef * p[c]) * (sv[c] - sps)) * k.inv
                       : 0.0f;
  }
  return valid ? eq + k.ent_coef * ent : 0.0f;
}

// grid (batch tiles of TS9 samples, agents): y [A, B] = r_i + gamma Q'_i(s', a')
template <class D>
__global__ void __launch_bounds__(THREADS9)
maddpg_td_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                 const int* __restrict__ act2, float* __restrict__ y, int batch, float gamma) {
  using L = TdLayout<D>;
  using N = typename L::Net;
  extern __shared__ __align__(16) float smem[];
  const Tile9 t = tile9();
  const int i = blockIdx.y, b0 = blockIdx.x * TS9;
  float* tile = smem + N::N;
  load_net<D::J, 1>(weights + D::OFF_TC + i * D::NCP, smem);
  load_rows<D::AO>(rows, D::RW, D::R_OBS2, b0, batch, tile + L::R_X * LD9);
  for (int e = threadIdx.x; e < D::AK * TS9; e += THREADS9) {  // a': the one-hots of act2
    const int s = e / D::AK, r = e - s * D::AK;
    const int b = b0 + s < batch ? b0 + s : b0;
    const int q = r / D::K, k = r % D::K;
    const bool hot = k < MW ? k == act2[(q * D::NH) * batch + b]
                            : k - MW == act2[(q * D::NH + 1) * batch + b];
    tile[(L::R_X + D::AO + r) * LD9 + s] = hot ? 1.0f : 0.0f;
  }
  __syncthreads();
  float acc[2][4];
  dense_tile<D::J, WS9>(smem + N::W1T, tile + L::R_X * LD9, t, acc);
  store_tanh(acc, smem + N::B1, tile + L::R_H1 * LD9, t);
  __syncthreads();
  dense_tile<H, WS9>(smem + N::W2T, tile + L::R_H1 * LD9, t, acc);
  store_tanh(acc, smem + N::B2, tile + L::R_H2 * LD9, t);
  __syncthreads();
  const int s = threadIdx.x;
  if (s < TS9 && b0 + s < batch) {
    const float* rb = rows + (size_t)(b0 + s) * D::RW;
    y[(size_t)i * batch + b0 + s] =
        rb[D::R_REW + i] + gamma * net_out(smem + N::W3, tile + L::R_H2 * LD9 + s);
  }
}

// grid (batch tiles of TS9 samples, agents), THREADS9 threads, each a 2 x 4
// micro-tile of every dense layer; partials [A][tiles][NG]
template <class D>
__global__ void __launch_bounds__(THREADS9, 1)
maddpg_update_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                     const float* __restrict__ y, float* __restrict__ partials, int batch,
                     MaddpgConsts k) {
  using L = Layout9<D>;
  using CN = typename L::CNet;
  using AN = typename L::ANet;
  constexpr int K = D::K, C = D::C, CX = D::CX, J = D::J;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const Tile9 t = tile9();
  const int i = blockIdx.y;
  const int b0 = blockIdx.x * TS9;
  float* wc = smem + L::S_C;
  float* wa = smem + L::S_A;
  float* tile = smem + L::S_TILE;
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;

  load_net<J, 1>(weights + D::OFF_C + i * D::NCP, wc);
  load_net<D::OW, K>(weights + D::OFF_A + i * D::NWP, wa);
  if (tid < TS9) smem[L::S_Y + tid] = b0 + tid < batch ? y[(size_t)i * batch + b0 + tid] : 0.0f;
  load_rows<J>(rows, D::RW, 0, b0, batch, tile + L::R_X * LD9);                   // (s, a)
  __syncthreads();

  // ---- critic forward and the candidates' base: pre - agent i's own-action terms ----
  {
    float acc[2][4], own[2][4];
    dense_tile<J, WS9>(wc + CN::W1T, tile + L::R_X * LD9, t, acc);
    dense_tile<K, WS9>(wc + CN::W1T + (D::AO + i * K) * WS9,
                       tile + (L::R_X + D::AO + i * K) * LD9, t, own);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = t.g0 + u, s = t.s + q * SO9;
        const float pre = acc[q][u] + wc[CN::B1 + g];
        tile[(L::R_H1 + g) * LD9 + s] = tanhf(pre);
        tile[(L::R_BASE + g) * LD9 + s] = pre - own[q][u];
      }
  }
  __syncthreads();
  {
    float acc[2][4];
    dense_tile<H, WS9>(wc + CN::W2T, tile + L::R_H1 * LD9, t, acc);
    store_tanh(acc, wc + CN::B2, tile + L::R_H2 * LD9, t);
  }
  __syncthreads();
  if (tid < TS9) {                          // q and the TD gradient
    const int s = tid;
    const bool valid = b0 + s < batch;
    const float q = net_out(wc + CN::W3, tile + L::R_H2 * LD9 + s);
    const float d = valid ? q - smem[L::S_Y + s] : 0.0f;
    smem[L::S_Q + s] = q;
    tile[L::R_G3 * LD9 + s] = (2.0f * k.inv) * d;
    smem[L::S_MS + s] = d * d;
    smem[L::S_MS + TS9 + s] = valid ? q : 0.0f;
  }
  __syncthreads();

  // ---- critic backward: gh2 = w3 g3 (1 - h2^2), gh1 = (w2^T gh2) (1 - h1^2) ----
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int g = t.g0 + u, s = t.s + q * SO9;
      const float h2 = tile[(L::R_H2 + g) * LD9 + s];
      tile[(L::R_GH2 + g) * LD9 + s] = (wc[CN::W3 + g] * tile[L::R_G3 * LD9 + s]) * (1.0f - h2 * h2);
    }
  __syncthreads();
  {
    float acc[2][4];                          // units h, summed over g in order
    dense_rows(wc + CN::W2T, tile + L::R_GH2 * LD9, t, acc);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = (t.g0 >> 2) + UG9 * u, s = t.s + q * SO9;
        const float h1 = tile[(L::R_H1 + h) * LD9 + s];
        tile[(L::R_GH1 + h) * LD9 + s] = acc[q][u] * (1.0f - h1 * h1);
      }
  }
  __syncthreads();
  weight_grads<H, J>(tile, L::R_GH1, L::R_X, part + D::G_CRITIC + D::CW1);
  weight_grads<H, H>(tile, L::R_GH2, L::R_H1, part + D::G_CRITIC + D::CW2);
  weight_grads<1, H>(tile, L::R_G3, L::R_H2, part + D::G_CRITIC + D::CW3);
  __syncthreads();

  // ---- the candidates' Q, CG at a time in the joint's rows ----
  // candidate c = m CX + j: h1 = tanh(base + (w1[:, own move m] + w1[:, own
  // comm j])) into rows R_C1, then h2 into rows R_C2, then Q
  for (int c0 = 0; c0 < D::NCAND; c0 += L::CG) {
    const int ng = D::NCAND - c0 < L::CG ? D::NCAND - c0 : L::CG;
    for (int e = tid; e < ng * H * TS9; e += THREADS9) {
      const int cc = e / (H * TS9), h = (e / TS9) % H, s = e % TS9;
      const int cand = c0 + cc, m = cand / CX, jc = cand % CX;
      const float wm = wc[CN::W1T + (D::AO + i * K + m) * WS9 + h];
      const float dc = C > 0 ? wm + wc[CN::W1T + (D::AO + i * K + MW + jc) * WS9 + h] : wm;
      tile[(L::R_C1 + cc * H + h) * LD9 + s] = tanhf(tile[(L::R_BASE + h) * LD9 + s] + dc);
    }
    __syncthreads();
#pragma unroll 1
    for (int cc = 0; cc < ng; ++cc) {
      float acc[2][4];
      dense_tile<H, WS9>(wc + CN::W2T, tile + (L::R_C1 + cc * H) * LD9, t, acc);
      store_tanh(acc, wc + CN::B2, tile + (L::R_C2 + cc * H) * LD9, t);
    }
    __syncthreads();
    for (int e = tid; e < ng * TS9; e += THREADS9) {
      const int cc = e / TS9, s = e - cc * TS9;
      smem[L::S_QC + (c0 + cc) * TS9 + s] =
          net_out(wc + CN::W3, tile + (L::R_C2 + cc * H) * LD9 + s);
    }
    __syncthreads();
  }

  // ---- actor: forward, expected-Q and entropy gradient, backward ----
  load_rows<D::OW>(rows, D::RW, i * D::OW, b0, batch, tile + L::R_X * LD9);
  __syncthreads();
  {
    float acc[2][4];
    dense_tile<D::OW, WS9>(wa + AN::W1T, tile + L::R_X * LD9, t, acc);
    store_tanh(acc, wa + AN::B1, tile + L::R_H1 * LD9, t);
  }
  __syncthreads();
  {
    float acc[2][4];
    dense_tile<H, WS9>(wa + AN::W2T, tile + L::R_H1 * LD9, t, acc);
    store_tanh(acc, wa + AN::B2, tile + L::R_H2 * LD9, t);
  }
  __syncthreads();
  for (int e = tid; e < K * TS9; e += THREADS9) {   // logit c, summed over the units in order
    const int c = e / TS9, s = e - c * TS9;
    const float* w3 = wa + AN::W3 + c * H;
    const float* x = tile + L::R_H2 * LD9 + s;
    float z = w3[0] * x[0];
#pragma unroll 16
    for (int g = 1; g < H; ++g) z = z + w3[g] * x[g * LD9];
    smem[L::S_Z + e] = z + wa[AN::B3 + c];
  }
  __syncthreads();
  if (tid < TS9) {                          // _softmax_eps per head, E, the gradients
    const int s = tid;
    smem[L::S_MS + 2 * TS9 + s] =
        actor_head<D, TS9>(smem + L::S_Z + s, smem + L::S_QC + s, tile + L::R_G3 * LD9 + s, LD9,
                           b0 + s < batch, k);
  }
  __syncthreads();
  {
    float acc[2][4];                          // gh2 = (w3^T gz) (1 - h2^2), over c in order
    dense_tile<K, H>(wa + AN::W3, tile + L::R_G3 * LD9, t, acc);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = t.g0 + u, s = t.s + q * SO9;
        const float h2 = tile[(L::R_H2 + g) * LD9 + s];
        tile[(L::R_GH2 + g) * LD9 + s] = acc[q][u] * (1.0f - h2 * h2);
      }
  }
  __syncthreads();
  {
    float acc[2][4];
    dense_rows(wa + AN::W2T, tile + L::R_GH2 * LD9, t, acc);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = (t.g0 >> 2) + UG9 * u, s = t.s + q * SO9;
        const float h1 = tile[(L::R_H1 + h) * LD9 + s];
        tile[(L::R_GH1 + h) * LD9 + s] = acc[q][u] * (1.0f - h1 * h1);
      }
  }
  __syncthreads();
  weight_grads<H, D::OW>(tile, L::R_GH1, L::R_X, part + D::G_ACTOR + D::Actor::W1);
  weight_grads<H, H>(tile, L::R_GH2, L::R_H1, part + D::G_ACTOR + D::Actor::W2);
  weight_grads<K, H>(tile, L::R_G3, L::R_H2, part + D::G_ACTOR + D::Actor::W3);

  // metric sums over the tile's samples, in order
  if (tid < 3) {
    float total = 0.0f;
    for (int q = 0; q < TS9; ++q) total = total + smem[L::S_MS + tid * TS9 + q];
    part[D::G_MS + tid] = total;
  }
}

// ---- K9 at hidden 128 and 256 -------------------------------------------------

// There the nets do not fit a CTA (simple_world_comm's critic alone 517 KB at
// 256), nor would one partial gradient per tile of 1024 / H samples (about
// 480 MB an update on simple_spread at 256). So the wide kernels keep K9's
// four stages, its sums' order and its reduce, and change three things:
//   tiles    TSW = 32 samples, 256 threads; every dense layer a product of
//            unit blocks of UBW = 128 units, each thread 4 units x 4 samples;
//   weights  every net stays in device memory (the L2 cache holds them for
//            every CTA); a product streams its weights in slices of KBW
//            inputs x UBW units through two shared buffers, the next slice
//            loaded into registers while the CTA computes on the last one
//            (WS::product), read in place: no transposed copies; w3, the
//            biases and the candidates' own-action columns are read where
//            they lie;
//   gradient a persistent grid of wide_parts CTAs an agent (the card's
//            occupancy), each striding over its agent's tiles; each tile's
//            weight gradients are summed over its samples in registers and
//            added into the CTA's partial in device memory (WS::outer; the
//            CTA's first tile writes it), and maddpg_reduce_kernel sums the
//            partials in a fixed order: no float atomics.
// Each (sample, unit) sum of a forward product still runs over its inputs in
// order from the first product, each product rounded before it is added, so
// the target logits, the Q of every candidate, qbar, p and E are the plain
// version's, as at the other widths. The candidates run one at a time: the
// candidate's layer-1 rows tanh(base + (w1[:, m] + w1[:, C + j])) over the
// critic's h1 rows, its layer 2 streamed into the h2 rows, its Q kept.
constexpr int THREADSW = 256;                 // a wide CTA's threads
constexpr int TSW = 32;                       // samples per wide tile
constexpr int LDW = TSW + 4;                  // a wide tile row's stride
constexpr int UBW = 128;                      // units of a unit block
constexpr int KBW = 16;                       // inputs of a weight slice
constexpr int SLDW = UBW + 4;                 // a slice row's stride
// the streamed products and weight-gradient sums (wide_stream.cuh, which
// ppo_update_wide_kernel shares): each product rounded before its add, from
// the first, and the warps one column group in a gradient pass
using WS = WideStream<THREADSW, TSW, LDW, H, UBW, KBW, SLDW, false, 1>;
constexpr int SLICESW = WS::SLICES;           // the two slice buffers

// a net's single output on the h2 rows at x (one sample's column, rows LDW
// apart): the sum over the H units in order, then b3 (right after w3)
__device__ __forceinline__ float net_out_w(const float* __restrict__ w3, const float* x) {
  float q = w3[0] * x[0];
#pragma unroll 16
  for (int g = 1; g < H; ++g) q = q + w3[g] * x[g * LDW];
  return q + w3[H];
}

// the logits z[c][s] (stride TSW) of a net's w3 [K, H] and b3 on the h2 rows,
// each over the units in order, then the bias
template <int K>
__device__ __forceinline__ void wide_logits(const float* __restrict__ w3,
                                            const float* __restrict__ b3, const float* h2,
                                            float* z) {
  for (int e = threadIdx.x; e < K * TSW; e += THREADSW) {
    const int c = e / TSW, s = e - c * TSW;
    const float* w = w3 + c * H;
    const float* x = h2 + s;
    float v = w[0] * x[0];
#pragma unroll 16
    for (int g = 1; g < H; ++g) v = v + w[g] * x[g * LDW];
    z[e] = v + b3[c];
  }
}

// dW3 [NOUT, H] (+)= G H2^T and db3 (+)= the sums of G's NOUT rows over the
// tile, G and H2 [.][LDW]; as WS::outer
template <int NOUT>
__device__ __forceinline__ void wide_out_grads(const float* G, const float* H2, float* w3,
                                               float* b3, bool first) {
  for (int e = threadIdx.x; e < NOUT * H; e += THREADSW) {
    const int c = e / H, g = e - c * H;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < TSW; ++s) acc = fmaf(G[c * LDW + s], H2[g * LDW + s], acc);
    w3[e] = first ? acc : w3[e] + acc;
  }
  for (int c = threadIdx.x; c < NOUT; c += THREADSW) {
    float acc = 0.0f;
    for (int s = 0; s < TSW; ++s) acc = acc + G[c * LDW + s];
    b3[c] = first ? acc : b3[c] + acc;
  }
}

// the wide kernels' shared memory (floats): the slice buffers, the
// per-sample scalars (the gradient kernel's y, q, the candidates' Q [NCAND],
// logits [K], metric terms [3]; the target kernel's logits [K]), then tile
// rows [.][LDW]: the inputs (the joint; the agent's obs or s'), h1, h2, and in
// the gradient kernel the candidates' base and the output gradients (1
// critic, K actor). The candidates' layer-1 and layer-2 rows take h1 and h2.
template <class D>
struct WideTaLayout {
  static constexpr int S_Z = SLICESW, S_TILE = (S_Z + D::K * TSW + 3) / 4 * 4;
  static constexpr int R_X = 0, R_H1 = D::OW, R_H2 = R_H1 + H, R_N = R_H2 + H;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LDW) * sizeof(float);
};
template <class D>
struct WideTdLayout {
  static constexpr int S_TILE = SLICESW;
  static constexpr int R_X = 0, R_H1 = D::J, R_H2 = R_H1 + H, R_N = R_H2 + H;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LDW) * sizeof(float);
};
template <class D>
struct WideLayout9 {
  static constexpr int S_Y = SLICESW, S_Q = S_Y + TSW, S_QC = S_Q + TSW,
                       S_Z = S_QC + D::NCAND * TSW, S_MS = S_Z + D::K * TSW,
                       S_TILE = (S_MS + 3 * TSW + 3) / 4 * 4;
  static constexpr int R_X = 0, R_H1 = D::J, R_H2 = R_H1 + H, R_BASE = R_H2 + H,
                       R_G = R_BASE + H, R_N = R_G + D::K;
  static constexpr size_t SMEM = (size_t)(S_TILE + R_N * LDW) * sizeof(float);
};

// grid (batch tiles of TSW samples, agents): agent i's target actor on s',
// streamed; the first-argmax move and comm -> act2 [A, NH, B]
template <class D>
__global__ void __launch_bounds__(THREADSW)
maddpg_target_actions_wide_kernel(const float* __restrict__ weights,
                                  const float* __restrict__ rows, int* __restrict__ act2,
                                  int batch) {
  using L = WideTaLayout<D>;
  using M = typename D::Actor;
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.y, b0 = blockIdx.x * TSW;
  const float* wt = weights + D::OFF_TA + i * D::NWP;
  float* tile = smem + L::S_TILE;
  float* h1 = tile + L::R_H1 * LDW;
  float* h2 = tile + L::R_H2 * LDW;
  load_rows<D::OW, TSW, LDW>(rows, D::RW, D::R_OBS2 + i * D::OW, b0, batch, tile);
  __syncthreads();
  WS::product<D::OW, true>(wt + M::W1, tile, smem, [&](int u, int s, float v) {
    h1[u * LDW + s] = tanhf(v + wt[M::B1 + u]);
  });
  WS::product<H, true>(wt + M::W2, h1, smem, [&](int u, int s, float v) {
    h2[u * LDW + s] = tanhf(v + wt[M::B2 + u]);
  });
  wide_logits<D::K>(wt + M::W3, wt + M::B3, h2, smem + L::S_Z);
  __syncthreads();
  const int s = threadIdx.x;
  if (s < TSW && b0 + s < batch) {
    float z[D::K];
#pragma unroll
    for (int c = 0; c < D::K; ++c) z[c] = smem[L::S_Z + c * TSW + s];
    act2[(i * D::NH) * batch + b0 + s] = first_argmax<0, MW>(z);
    if constexpr (D::C > 0) act2[(i * D::NH + 1) * batch + b0 + s] = first_argmax<MW, D::C>(z);
  }
}

// grid (batch tiles of TSW samples, agents): y [A, B] = r_i + gamma Q'_i(s', a'),
// the target critic streamed
template <class D>
__global__ void __launch_bounds__(THREADSW)
maddpg_td_wide_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                      const int* __restrict__ act2, float* __restrict__ y, int batch,
                      float gamma) {
  using L = WideTdLayout<D>;
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.y, b0 = blockIdx.x * TSW;
  const float* wt = weights + D::OFF_TC + i * D::NCP;
  float* tile = smem + L::S_TILE;
  float* h1 = tile + L::R_H1 * LDW;
  float* h2 = tile + L::R_H2 * LDW;
  load_rows<D::AO, TSW, LDW>(rows, D::RW, D::R_OBS2, b0, batch, tile);
  for (int e = threadIdx.x; e < D::AK * TSW; e += THREADSW) {  // a': the one-hots of act2
    const int s = e / D::AK, r = e - s * D::AK;
    const int b = b0 + s < batch ? b0 + s : b0;
    const int q = r / D::K, k = r % D::K;
    const bool hot = k < MW ? k == act2[(q * D::NH) * batch + b]
                            : k - MW == act2[(q * D::NH + 1) * batch + b];
    tile[(D::AO + r) * LDW + s] = hot ? 1.0f : 0.0f;
  }
  __syncthreads();
  WS::product<D::J, true>(wt + D::CW1, tile, smem, [&](int u, int s, float v) {
    h1[u * LDW + s] = tanhf(v + wt[D::CB1 + u]);
  });
  WS::product<H, true>(wt + D::CW2, h1, smem, [&](int u, int s, float v) {
    h2[u * LDW + s] = tanhf(v + wt[D::CB2 + u]);
  });
  const int s = threadIdx.x;
  if (s < TSW && b0 + s < batch) {
    const float* rb = rows + (size_t)(b0 + s) * D::RW;
    y[(size_t)i * batch + b0 + s] = rb[D::R_REW + i] + gamma * net_out_w(wt + D::CW3, h2 + s);
  }
}

// grid (wide_parts CTAs, agents), THREADSW threads: CTA p of agent i takes the
// tiles p, p + P, ... of TSW samples (P = gridDim.x) and adds each tile's
// gradient into its partial, partials [A][P][NG]
template <class D>
__global__ void __launch_bounds__(THREADSW, 1)
maddpg_update_wide_kernel(const float* __restrict__ weights, const float* __restrict__ rows,
                          const float* __restrict__ y, float* __restrict__ partials, int batch,
                          MaddpgConsts k) {
  using L = WideLayout9<D>;
  using M = typename D::Actor;
  constexpr int K = D::K, C = D::C, CX = D::CX, J = D::J, OWN = D::AO;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, i = blockIdx.y;
  const int n_tiles = (batch + TSW - 1) / TSW;
  const float* wc = weights + D::OFF_C + i * D::NCP;
  const float* wa = weights + D::OFF_A + i * D::NWP;
  float* tile = smem + L::S_TILE;
  float* xr = tile + L::R_X * LDW;
  float* h1 = tile + L::R_H1 * LDW;
  float* h2 = tile + L::R_H2 * LDW;
  float* base = tile + L::R_BASE * LDW;
  float* g = tile + L::R_G * LDW;
  float* ms = smem + L::S_MS;
  float* part = partials + ((size_t)i * gridDim.x + blockIdx.x) * D::NG;
  float* pc = part + D::G_CRITIC;
  float* pa = part + D::G_ACTOR;
  const int own = OWN + i * K;               // the agent's own-action inputs of the joint

  for (int ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    const bool first = ti == (int)blockIdx.x;
    const int b0 = ti * TSW;
    if (tid < TSW) smem[L::S_Y + tid] = b0 + tid < batch ? y[(size_t)i * batch + b0 + tid] : 0.0f;
    load_rows<J, TSW, LDW>(rows, D::RW, 0, b0, batch, xr);                    // (s, a)
    __syncthreads();

    // ---- critic forward and the candidates' base: pre - the own-action terms ----
    WS::product<J, true>(wc + D::CW1, xr, smem, [&](int u, int s, float v) {
      const float pre = v + wc[D::CB1 + u];
      const float* w = wc + D::CW1 + (size_t)u * J + own;
      float o = w[0] * xr[own * LDW + s];
#pragma unroll
      for (int c = 1; c < K; ++c) o = o + w[c] * xr[(own + c) * LDW + s];
      h1[u * LDW + s] = tanhf(pre);
      base[u * LDW + s] = pre - o;
    });
    WS::product<H, true>(wc + D::CW2, h1, smem, [&](int u, int s, float v) {
      h2[u * LDW + s] = tanhf(v + wc[D::CB2 + u]);
    });
    if (tid < TSW) {                          // q and the TD gradient
      const int s = tid;
      const bool valid = b0 + s < batch;
      const float q = net_out_w(wc + D::CW3, h2 + s);
      const float d = valid ? q - smem[L::S_Y + s] : 0.0f;
      smem[L::S_Q + s] = q;
      g[s] = (2.0f * k.inv) * d;
      ms[s] = d * d;
      ms[TSW + s] = valid ? q : 0.0f;
    }
    __syncthreads();

    // ---- critic backward: dW3, gh2 = w3 g3 (1 - h2^2), dW2, gh1 = (w2^T gh2) (1 - h1^2), dW1 ----
    wide_out_grads<1>(g, h2, pc + D::CW3, pc + D::CB3, first);
    __syncthreads();
    for (int e = tid; e < H * TSW; e += THREADSW) {
      const int u = e / TSW, s = e - u * TSW;
      const float hv = h2[u * LDW + s];
      h2[u * LDW + s] = (wc[D::CW3 + u] * g[s]) * (1.0f - hv * hv);
    }
    __syncthreads();
    WS::outer<H>(h2, h1, pc + D::CW2, H, pc + D::CB2, first);
    __syncthreads();
    WS::product<H, false>(wc + D::CW2, h2, smem, [&](int u, int s, float v) {
      const float hv = h1[u * LDW + s];
      h1[u * LDW + s] = v * (1.0f - hv * hv);
    });
    WS::outer<J>(h1, xr, pc + D::CW1, J, pc + D::CB1, first);
    __syncthreads();

    // ---- the candidates' Q, one at a time: candidate m CX + j's h1 =
    // tanh(base + (w1[:, own move m] + w1[:, own comm j])) into the h1 rows,
    // its h2 into the h2 rows, then its Q ----
    for (int cand = 0; cand < D::NCAND; ++cand) {
      const int m = cand / CX, jc = cand % CX;
      for (int e = tid; e < H * TSW; e += THREADSW) {
        const int u = e / TSW, s = e - u * TSW;
        const float* w = wc + D::CW1 + (size_t)u * J + own;
        const float dc = C > 0 ? w[m] + w[MW + jc] : w[m];
        h1[u * LDW + s] = tanhf(base[u * LDW + s] + dc);
      }
      __syncthreads();
      WS::product<H, true>(wc + D::CW2, h1, smem, [&](int u, int s, float v) {
        h2[u * LDW + s] = tanhf(v + wc[D::CB2 + u]);
      });
      if (tid < TSW) smem[L::S_QC + cand * TSW + tid] = net_out_w(wc + D::CW3, h2 + tid);
    }

    // ---- actor: forward, expected-Q and entropy gradient, backward ----
    load_rows<D::OW, TSW, LDW>(rows, D::RW, i * D::OW, b0, batch, xr);
    __syncthreads();
    WS::product<D::OW, true>(wa + M::W1, xr, smem, [&](int u, int s, float v) {
      h1[u * LDW + s] = tanhf(v + wa[M::B1 + u]);
    });
    WS::product<H, true>(wa + M::W2, h1, smem, [&](int u, int s, float v) {
      h2[u * LDW + s] = tanhf(v + wa[M::B2 + u]);
    });
    wide_logits<K>(wa + M::W3, wa + M::B3, h2, smem + L::S_Z);
    __syncthreads();
    if (tid < TSW)
      ms[2 * TSW + tid] = actor_head<D, TSW>(smem + L::S_Z + tid, smem + L::S_QC + tid, g + tid,
                                             LDW, b0 + tid < batch, k);
    __syncthreads();
    wide_out_grads<K>(g, h2, pa + M::W3, pa + M::B3, first);
    __syncthreads();
    for (int e = tid; e < H * TSW; e += THREADSW) {   // gh2 = (w3^T gz) (1 - h2^2), over c in order
      const int u = e / TSW, s = e - u * TSW;
      float v = wa[M::W3 + u] * g[s];
#pragma unroll
      for (int c = 1; c < K; ++c) v = v + wa[M::W3 + c * H + u] * g[c * LDW + s];
      const float hv = h2[u * LDW + s];
      h2[u * LDW + s] = v * (1.0f - hv * hv);
    }
    __syncthreads();
    WS::outer<H>(h2, h1, pa + M::W2, H, pa + M::B2, first);
    __syncthreads();
    WS::product<H, false>(wa + M::W2, h2, smem, [&](int u, int s, float v) {
      const float hv = h1[u * LDW + s];
      h1[u * LDW + s] = v * (1.0f - hv * hv);
    });
    WS::outer<D::OW>(h1, xr, pa + M::W1, D::OW, pa + M::B1, first);
    if (tid < 3) {                            // the tile's metric sums, in order
      float total = 0.0f;
      for (int s = 0; s < TSW; ++s) total = total + ms[tid * TSW + s];
      part[D::G_MS + tid] = first ? total : part[D::G_MS + tid] + total;
    }
    __syncthreads();                          // the tile's reads are done
  }
}

// the wide gradient kernel's CTAs an agent: all that the card holds at once,
// shared among the agents (at least one each)
template <class D>
int wide_parts() {
  static const int parts = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaFuncSetAttribute(maddpg_update_wide_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WideLayout9<D>::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maddpg_update_wide_kernel<D>,
                                                      THREADSW, WideLayout9<D>::SMEM) !=
            cudaSuccess)
      return -1;
    const int n = sms * per_sm / D::A;
    return n > 0 ? n : 1;
  }();
  return parts;
}

// The gradient in the parameters' layout, grads [A NWP + A NCP]: the actors
// [A][NWP], then the critics [A][NCP], each entry summed over the tiles in order,
// the padding 0; metrics [3] = (critic loss, actor loss, Q mean): each term
// summed over an agent's tiles, the agents in order, times inv, the actor
// objective negated
template <class D>
__global__ void maddpg_reduce_kernel(const float* __restrict__ partials, float* __restrict__ grads,
                                     float* __restrict__ metrics, int n_tiles, float inv) {
  constexpr int NA = D::A * D::NWP, NT = NA + D::A * D::NCP;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < NT) {
    int a, e;
    if (idx < NA) {
      a = idx / D::NWP;
      e = idx - a * D::NWP;
      e = e < D::NW ? D::G_ACTOR + e : -1;
    } else {
      a = (idx - NA) / D::NCP;
      e = idx - NA - a * D::NCP;
      e = e < D::NC ? D::G_CRITIC + e : -1;
    }
    float total = 0.0f;
    if (e >= 0) {
      const float* p = partials + (size_t)a * n_tiles * D::NG + e;
#pragma unroll 8
      for (int t = 0; t < n_tiles; ++t) total = total + p[(size_t)t * D::NG];
    }
    grads[idx] = total;
  } else if (idx < NT + 3) {
    const int m = idx - NT, term = m == 0 ? 0 : m == 1 ? 2 : 1;
    float sum = 0.0f;
    for (int a = 0; a < D::A; ++a) {
      float ta = 0.0f;
      const float* p = partials + (size_t)a * n_tiles * D::NG + D::G_MS + term;
#pragma unroll 8
      for (int t = 0; t < n_tiles; ++t) ta = ta + p[(size_t)t * D::NG];
      sum = a == 0 ? ta : sum + ta;
    }
    metrics[m] = m == 1 ? -sum * inv : sum * inv;
  }
}

// The tile's shared memory: the A actors (TileActor's layout, NWP floats
// apart; none from hidden 128, ACTORS_SMEM), the input rows of this step and
// of the next [2][OW][LDX] (the next step's obs are this step's obs2 unless
// the lanes reset), h1 (then the
// logits) and h2 [H][LDX], the rows' action indices [NR], the reward rows
// [R][TLP]; or 0 for a tile size the kernel does not take
template <class S>
size_t maddpg_smem(int tile) {
  if (tile < 1 || tile > TILE_MAX) return 0;
  const TileRows tr = tile_rows(tile, S::A);
  const size_t bytes = ((ACTORS_SMEM ? (size_t)S::A * TileActor<S::OW, MW + S::C>::NWP : 0) +
                        (size_t)(2 * S::OW + 2 * H) * tr.ldx + tr.nr + (size_t)S::R * tr.tlp) *
                       sizeof(float);
  return bytes <= SMEM_MAX ? bytes : 0;
}

template <class S>
int launch_traj(const void* params, const float* weights, float* obs, float* act, float* rew,
                float* obs2, float* rows, int n_envs, int block_envs, int n_chunks, int t_chunk,
                int horizon, float eps, uint32_t seed, uint32_t block_offset, int tile,
                cudaStream_t stream) {
  const cudaError_t attr = tile_smem_attr<maddpg_traj_kernel<S>, maddpg_smem<S>>();
  const size_t smem = maddpg_smem<S>(tile);
  if (attr != cudaSuccess) return (int)attr;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n_envs + tile - 1) / tile;
  maddpg_traj_kernel<S><<<blocks, TILE_THREADS, smem, stream>>>(
      *static_cast<const typename S::Params*>(params), weights, obs, act, rew, obs2, rows, n_envs,
      block_envs, n_chunks, t_chunk, horizon, eps, seed, block_offset, tile);
  return (int)cudaGetLastError();
}

// hidden 8-64: grid (batch tiles of TS9, agents), a partial per tile
template <class D>
int launch_update_narrow(const float* weights, const float* rows, int* act2, float* y,
                         float* partials, float* grads, float* metrics, int batch, float gamma,
                         float ent_coef, float inv, cudaStream_t stream) {
  static_assert(Layout9<D>::SMEM <= SMEM_MAX && TdLayout<D>::SMEM <= SMEM_MAX &&
                    TaLayout<D>::SMEM <= SMEM_MAX,
                "a K9 CTA exceeds the shared memory of an SM");
  // once per instantiation: the attributes hold for the process
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(maddpg_target_actions_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TaLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(maddpg_td_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TdLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_update_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Layout9<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int n_tiles = (batch + TS9 - 1) / TS9;
  const dim3 grid(n_tiles, D::A);
  maddpg_target_actions_kernel<D><<<grid, THREADS9, TaLayout<D>::SMEM, stream>>>(weights, rows,
                                                                                 act2, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_td_kernel<D><<<grid, THREADS9, TdLayout<D>::SMEM, stream>>>(weights, rows, act2, y,
                                                                      batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const MaddpgConsts k{gamma, ent_coef, inv};
  maddpg_update_kernel<D><<<grid, THREADS9, Layout9<D>::SMEM, stream>>>(weights, rows, y,
                                                                         partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int n_out = D::A * (D::NWP + D::NCP) + 3;
  maddpg_reduce_kernel<D><<<(n_out + 255) / 256, 256, 0, stream>>>(partials, grads, metrics,
                                                                   n_tiles, inv);
  return (int)cudaGetLastError();
}

// hidden 128 and 256: the wide kernels, the gradient on a persistent grid of
// min(tiles, wide_parts) CTAs an agent, a partial per CTA
template <class D>
int launch_update_wide(const float* weights, const float* rows, int* act2, float* y,
                       float* partials, float* grads, float* metrics, int batch, float gamma,
                       float ent_coef, float inv, cudaStream_t stream) {
  static_assert(WideLayout9<D>::SMEM <= SMEM_MAX && WideTdLayout<D>::SMEM <= SMEM_MAX &&
                    WideTaLayout<D>::SMEM <= SMEM_MAX,
                "a wide K9 CTA exceeds the shared memory of an SM");
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(maddpg_target_actions_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)WideTaLayout<D>::SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(maddpg_td_wide_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)WideTdLayout<D>::SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int parts = wide_parts<D>();
  if (parts < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (batch + TSW - 1) / TSW;
  const int n_parts = n_tiles < parts ? n_tiles : parts;
  const dim3 grid(n_tiles, D::A);
  maddpg_target_actions_wide_kernel<D><<<grid, THREADSW, WideTaLayout<D>::SMEM, stream>>>(
      weights, rows, act2, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maddpg_td_wide_kernel<D><<<grid, THREADSW, WideTdLayout<D>::SMEM, stream>>>(
      weights, rows, act2, y, batch, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const MaddpgConsts k{gamma, ent_coef, inv};
  maddpg_update_wide_kernel<D><<<dim3(n_parts, D::A), THREADSW, WideLayout9<D>::SMEM, stream>>>(
      weights, rows, y, partials, batch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int n_out = D::A * (D::NWP + D::NCP) + 3;
  maddpg_reduce_kernel<D><<<(n_out + 255) / 256, 256, 0, stream>>>(partials, grads, metrics,
                                                                   n_parts, inv);
  return (int)cudaGetLastError();
}

template <class D>
int launch_update(const float* weights, const float* rows, int* act2, float* y, float* partials,
                  float* grads, float* metrics, int batch, float gamma, float ent_coef, float inv,
                  cudaStream_t stream) {
  static_assert(D::OFF_C % 4 == 0 && D::NWP % 4 == 0, "the nets' blocks stay 16-byte aligned");
  if constexpr (H > 64)
    return launch_update_wide<D>(weights, rows, act2, y, partials, grads, metrics, batch, gamma,
                                 ent_coef, inv, stream);
  else
    return launch_update_narrow<D>(weights, rows, act2, y, partials, grads, metrics, batch,
                                   gamma, ent_coef, inv, stream);
}

// the layout constants the wrapper mirrors: 0 actor stride, 1 critic stride,
// 2 weights, 3 gradient per agent, 4 samples per tile, 5 no bf16 scratch (-1;
// mpe_maddpg_bf16.cu's), 6 the partial gradients an agent at most (from
// hidden 128 the wide grid's CTAs an agent, wide_parts; else -1: one a tile)
template <class D>
int layout(int which) {
  if (which == 6) {
    if constexpr (H > 64) return wide_parts<D>();
    return -1;
  }
  const int v[5] = {D::NWP, D::NCP, D::N_WEIGHTS, D::NG, H > 64 ? TSW : TS9};
  return (which >= 0 && which < 5) ? v[which] : -1;
}

template <class D>
int update_smem(int which) {
  size_t v[3];
  if constexpr (H > 64) {
    v[0] = WideTaLayout<D>::SMEM, v[1] = WideTdLayout<D>::SMEM, v[2] = WideLayout9<D>::SMEM;
  } else {
    v[0] = TaLayout<D>::SMEM, v[1] = TdLayout<D>::SMEM, v[2] = Layout9<D>::SMEM;
  }
  return (which >= 0 && which < 3) ? (int)v[which] : -1;
}

}  // namespace

extern "C" {

// K8: the tensor form (obs, act, rew, obs2) when rows is null, else the rows
// form; weights: the A actors in TileActor's layout, NWP floats apart; tile
// lanes per CTA, 1 to TILE_MAX where the tile's shared memory fits
int mpe_maddpg_traj(int scenario, const void* params, const float* weights, float* obs,
                    float* act, float* rew, float* obs2, float* rows, int n_envs, int block_envs,
                    int n_chunks, int t_chunk, int horizon, float eps, uint32_t seed,
                    uint32_t block_offset, int tile, cudaStream_t stream) {
#define MPE_MADDPG_TRAJ(S)                                                                  \
  return launch_traj<S>(params, weights, obs, act, rew, obs2, rows, n_envs, block_envs,    \
                        n_chunks, t_chunk, horizon, eps, seed, block_offset, tile, stream)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_TRAJ)
#undef MPE_MADDPG_TRAJ
}

// K8's CTAs of `tile` lanes that one SM of the current card holds at once;
// ops/fused_maddpg.py::maddpg_tile reads it
int mpe_maddpg_traj_ctas_per_sm(int scenario, int tile) {
#define MPE_MADDPG_CTAS(S) return tile_ctas_per_sm<maddpg_traj_kernel<S>, maddpg_smem<S>>(tile)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_CTAS)
#undef MPE_MADDPG_CTAS
}

// K9. weights [N_WEIGHTS] (see OFF_*); rows [batch, RW]; act2 [A, NH, batch]
// (the target actions, kept for inspection) and y [A, batch] scratch;
// partials [A, tiles, NG] scratch; grads [A NWP + A NCP] (the layout of
// weights' live nets, OFF_A..OFF_TA) and metrics [3] out
int mpe_maddpg_update(int scenario, const float* weights, const float* rows, int* act2, float* y,
                      float* partials, float* grads, float* metrics, int batch, float gamma,
                      float ent_coef, float inv, cudaStream_t stream) {
#define MPE_MADDPG_UPDATE(S)                                                                  \
  return launch_update<DimsOf<S>>(weights, rows, act2, y, partials, grads, metrics, batch, gamma, \
                                  ent_coef, inv, stream)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_UPDATE)
#undef MPE_MADDPG_UPDATE
}

int mpe_maddpg_update_layout(int scenario, int which) {
#define MPE_MADDPG_LAYOUT(S) return layout<DimsOf<S>>(which)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_LAYOUT)
#undef MPE_MADDPG_LAYOUT
}

// the dynamic shared memory of K9's target-action (which 0), TD (1) and
// gradient (2) kernels for a scenario id at this library's width, in bytes
int mpe_maddpg_update_smem(int scenario, int which) {
#define MPE_MADDPG_SMEM(S) return update_smem<DimsOf<S>>(which)
  MPE_SCENARIO_SWITCH(MPE_MADDPG_SMEM)
#undef MPE_MADDPG_SMEM
}

}  // extern "C"

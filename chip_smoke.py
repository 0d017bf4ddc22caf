#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, then runs these phases; any
failure ends the run with a non-zero exit code:

  1. environment: card name and power limit, torch and CUDA versions,
     kernel build time and the compiler's register report;
  2. ten main paths, each with every kernel's launch count set to 0 just
     before it and read just after it:
       a. rollout: the generic engine (build_rollout over MpeEnv,
          simple_spread, 4096 envs x 200 steps, horizon 100, env-minor);
          the fused engine (kernel K2) at 4096 envs x 10000 steps, horizon
          100, block_envs 1024 (the bench's headline config), and at 16384
          and 65536 envs; the deterministic rollout (kernel K1) on
          make_det_inputs, 4096 envs x 10000 steps, printed beside the time
          of the spread-only kernel it replaced; the fused mean reward per
          env-step must agree with the generic engine's within 5 standard
          errors; K1 and K2 are kernel templates with one C entry each,
          det_rollout_kernel<S, G> and scenario_rollout_kernel<S, G>, here
          their simple_spread instantiations, with the G threads per env lane
          that ops/fused_parity.py::det_group and
          ops/fused_rollout.py::rollout_group pick at each width;
       b. training: build_fused_ppo_step at tools/train_bench.py's width
          (4096 envs x 64 steps, horizon 32, hidden 64, 4 PPO epochs,
          block_envs 1024, t_chunk 8) for 20 iterations (kernels K5 and K6),
          with per-iteration CUDA-event times by phase and transitions/s over
          iterations 1-19; every metric must be finite;
       b2. MAPPO training: build_fused_mappo_step at the same width for 20
          iterations (kernels K5 and K7), timed and checked the same way;
       b3. PPO on a scenario where agents speak: build_fused_ppo_step on
          simple_reference (two speakers, dim_c 10, 16 outputs with the
          value head) at the same width, 20 iterations (K5, K6 with the comm
          factor), timed and checked the same way;
       b4. MAPPO on simple_speaker_listener (a silent listener, a speaker of
          dim_c 3, joint obs 22) at the same width, 20 iterations (K5, K7);
       c. evaluation (kernel K4), 4096 envs x 1000 steps, horizon 25: the
          trained simple_spread actor of path b, path b3's actor on
          simple_reference and the committed MAPPO actor of
          checkpoints/mappo_speaker_listener_fused.npz on
          simple_speaker_listener; mean return per episode, beside the
          uniform-random return of K2 on the same scenario and shape;
       d. MADDPG: build_fused_maddpg_runner("simple_spread", n_envs=1024,
          horizon=25, batch=1024) (tools/train_bench.py's fused_maddpg row)
          with the runner's defaults (tau 0.01, lr 1e-3, ent 0.01, eps 0.1,
          a ring of 1,638,400 rows), actor_start 250, 40 chunks = 1000
          updates (kernels K8 and K9), CUDA-event times split into collect
          and update, transitions/s over chunks 1-39, critic loss and mean
          reward of the first and last chunk, which must be finite;
       d2. the same runner with comm heads on simple_speaker_listener (a
          speaker, a silent listener; rows of 62 floats), 40 chunks, timed
          and checked the same way (tools/tpu_smoke.py's comm row);
       d3. the same runner on simple_world_comm (6 agents, a 258-wide joint,
          rows of 468 floats, a 3.07 GB ring), 8 chunks;
       e. the other scenarios and trajectories, as tools/tpu_smoke.py runs
          every scenario: the deterministic rollout (K1) on the eight
          scenarios other than simple_spread at 4096 envs x 10000 steps; the
          fused engine (K2) on them (simple, simple_reference,
          simple_speaker_listener, simple_adversary, simple_push,
          simple_crypto, simple_tag and simple_world_comm; the last two
          through the pair physics) at 4096 envs x 10000 steps, horizon
          100, the mean reward per env-step of each reward row within 5
          standard errors of the generic engine's (4096 envs x 200 steps);
          fused_trajectory (kernel K3) on all nine at 4096 envs x 64 steps,
          horizon 32, block_envs 1024, t_chunk 8 (the learner batch of
          tools/train_bench.py), and on simple_spread, simple_reference and
          simple_world_comm (the widest writer) at 65536 envs x 64 steps:
          median CUDA-event time of 3 runs, bytes written and the write
          bandwidth they reach; the launches of each instantiation;
  3. every kernel held against its plain PyTorch version on the card: K1
     on all nine scenarios and K2 over 20 steps (K2 with horizon 10, so
     resets happen), K1 at every group G equal to G = 1 bit for bit on the
     three scenarios with collide pairs; K5 and K4
     on simple_spread over 16 steps with horizon 8, two block offsets; K5 on
     all nine scenarios at 4096 envs x 64 steps (horizon 25, t_chunk 8;
     moves and comm indices equal) and at the training shape (horizon 32)
     with path b's, b3's and b4's actors, K4 at path c's evaluation shape on
     each of the three actors path c evaluates (the committed speaker-
     listener actor among them, on path c's own outputs) and on the eight
     scenarios other than simple_spread at 4096 envs x 200 steps (horizon
     25), with path b's, b3's and b4's actors where they exist and an
     init_policy actor of O(1) logits elsewhere; K6 and K7 on each
     scenario's K5 batch of its trainer at 4096 envs x 64 steps and on the
     same batch with both clips binding (K7's critic compiled for each
     scenario's joint width, simple_world_comm's 204 among them); one whole trainer iteration of each (params and
     metrics) against the same iteration with the plain versions; K8 on
     all nine scenarios at 1024 envs x 25 steps, two block offsets, with
     the actor of the scenario's committed checkpoints/maddpg_*.npz (and
     the trained actor of path d, d2 or d3), in both output forms; K9 on
     all nine at batch 1024 on rows K8 collected with the checkpoint's
     actor, with its trained critic, and on 1024 rows of path d's ring
     (target actions equal per head, their smallest logit gap printed); one
     update chunk of 25 updates of paths d, d2 and d3 with the same
     indices; K2 on all nine scenarios
     over 20 steps (two block offsets, kernel and plain version timed there),
     on simple_reference at path e's 4096 envs x 10000 steps (the obs sums
     within 1e-4 of the largest) and on each of the five scenarios ported
     last (simple_adversary, simple_push, simple_crypto, simple_tag and
     simple_world_comm) at 4096 envs x 1000 steps (pos, vel and rewards
     within 1e-5: on simple_tag and simple_world_comm collisions magnify any
     difference in the order of operations, so each max error is printed);
     K3 on each of the nine scenarios at 512 envs x 24 steps (horizon 10,
     t_chunk 4, block_envs 256, two block offsets, so that chunk salts and
     resets both occur), at path e's 4096 envs x 64 steps and, on
     TRAJ_WIDE, at path e's 65536 envs x 64 steps, actions equal and the
     rest within 1e-5 (at path e's shapes with another seed than path e's,
     so that no stale output can pass);
  4. the plain versions timed at the main paths' shapes (K1's of the eight
     others at 4096 envs x 200 steps), each kernel's bound from the
     operations its function needs (OPS below), and for K6, K7 and K9 the
     same gradient by autograd (the library yardstick), K4-K9 on every
     scenario at the gate's shape; K9 as the trainer calls it (its launcher
     on the packed weight buffer) and from trees; one MADDPG update chunk of
     each of paths d, d2, d3 as the runner runs it (packed_step) under
     torch.profiler (K9's device time split by its four kernels, the
     device's busy share, kernel launches per update), and each K3 call of
     path e (its device time);
  5. a ``{"kernels": [...]}`` line (the K1-K9 rows name their scenarios
     and the one their top-level numbers were timed on, and carry
     per scenario the launches, time, bound, plain time and error of each
     instantiation, K1, K2 (both by group) and K4-K9 also its registers
     and spills, K6, K7 and K9 the library time; K1 and K2 their group and
     the rule that picks it, K6 and K7 their tiling, K9 its tiling and
     launches per update), the ``nvidia-smi``
     name/power-limit line, and ``{"ok":
     true, "device": {...}}`` as the last line.

It needs a CUDA device and the ``mpe_tpu_torch`` package beside it, and
exits non-zero without either.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

N_ENVS = 4096
N_STEPS = 10_000
HORIZON = 100
BLOCK_ENVS = 1024
MID_ENVS = 16_384
WIDE_ENVS = 65_536
GENERIC_STEPS = 200
CHECK_STEPS = 20
CHECK_HORIZON = 10
REPEATS = 3
# training (tools/train_bench.py:35-40) and evaluation (examples/evaluate_policy.py)
TRAIN = dict(n_envs=4096, n_steps=64, horizon=32, hidden=64, lr=3e-4, gamma=0.95, lam=0.95,
             clip=0.2, vf_coef=0.5, ent_coef=0.01, ppo_epochs=4, block_envs=1024, t_chunk=8)
TRAIN_ITERS = 20
EVAL_STEPS, EVAL_HORIZON = 1000, 25
POLICY_CHECK_STEPS, POLICY_CHECK_HORIZON = 16, 8
# the comm paths b3 and b4, and the committed MAPPO actor that path c evaluates
COMM_PPO, COMM_MAPPO = "simple_reference", "simple_speaker_listener"
MAPPO_CKPT = "checkpoints/mappo_speaker_listener_fused.npz"
# K5 and K4 on every scenario: the learner batch with the evaluation's
# horizon, and 200 evaluation steps
POLICY_GATE = dict(n_steps=64, horizon=25, block_envs=1024, t_chunk=8)
EVAL_GATE_STEPS = 200
# MADDPG (tools/train_bench.py:123-126, the runner's defaults otherwise): path
# d on simple_spread, and with comm heads d2 on simple_speaker_listener
# (tools/tpu_smoke.py's comm row, the README's MADDPG comm result) and d3 on
# simple_world_comm (the widest: 6 agents, a 258-wide joint)
MADDPG = dict(n_envs=1024, horizon=25, batch=1024)
MADDPG_CHUNKS, MADDPG_ACTOR_START = 40, 250
MADDPG_COMM = (("simple_speaker_listener", 40), ("simple_world_comm", 8))
MADDPG_CKPT = "checkpoints/maddpg_spread_fused.npz"
# K1: the spread-only kernel that det_rollout_kernel<S> replaced took 7.318 ms
# at 4096 envs x 10,000 steps on an H100 80GB HBM3 at 700 W (PERF.md),
# printed beside <SpreadScn>; the plain K1 of the eight others is timed over
# K1_PLAIN_STEPS steps (simple_spread's takes 23 s at 10,000)
K1_SPREAD_ONLY_MS = 7.318
# the kernels line names K2's group rule and K9's tiling
GROUP_RULE = ("ops/fused_rollout.py::rollout_group: G threads per env lane; below 16384 envs "
              "the collide pairs rounded up to a power of two, at most 8, where there are 2 or "
              "more; else 1")
DET_GROUP_RULE = ("ops/fused_parity.py::det_group: G threads per env lane; the collide pairs "
                  "where there are any, else the movable agents, rounded up to a power of two, "
                  "at most 8 and at most 65536 / n_envs")
# the scenarios whose K1 splits an env lane (collide pairs), held at every G
DET_GROUPED = ("simple_spread", "simple_tag", "simple_world_comm")
UPDATE_TILE = {"threads": 256, "samples_per_tile": 64,
               "ctas_per_sm": "2 where they fit (not the 204-wide critic)",
               "micro_tile": "4 units x 4 samples (forward, backward)",
               "weight_grad_micro_tile": "4 x 4 (dW2), 4 x ceil(IN/16) (dW1)",
               "staging": "cp.async, two stages where they fit"}
K9_TILE = {"samples_per_cta": 16, "threads": 128, "micro_tile": "2 samples x 4 units",
           "grid": "batch / 16 x agents", "weight_grad_micro_tile": "4 x 4"}
K1_PLAIN_STEPS = 200
# the other scenarios (K2) and the trajectories (K3): the learner batch of
# tools/train_bench.py and tools/tpu_smoke.py's t_chunk; the gate's shape
SCENARIOS = ("simple", "simple_reference", "simple_speaker_listener", "simple_adversary",
             "simple_push", "simple_crypto", "simple_tag", "simple_world_comm")
ALL_SCENARIOS = ("simple_spread",) + SCENARIOS
# each scenario's committed MADDPG checkpoint (actor and trained critic)
MADDPG_CKPTS = {"simple_spread": MADDPG_CKPT,
                **{n: f"checkpoints/maddpg_{n.removeprefix('simple_')}.npz" for n in SCENARIOS}}
K2_LONG = "simple_reference"            # K2 against plain at path e's whole shape
# the long K2 gates of the scenarios ported last, at path e's envs
LONG_GATE = ("simple_adversary", "simple_push", "simple_crypto", "simple_tag",
             "simple_world_comm")
LONG_GATE_STEPS = 1000
TRAJ = dict(n_steps=64, horizon=32, block_envs=1024, t_chunk=8)
TRAJ_WIDE = ("simple_spread", "simple_reference", "simple_world_comm")
TRAJ_CHECK = dict(n_envs=512, n_steps=24, horizon=10, block_envs=256, t_chunk=4)

# Kernel against plain version on the card, 20 steps. The library is built
# with -fmad=false, so the dynamics round op for op as PyTorch's
# elementwise ops do; what is left is the order of the obs-checksum sum
# (over a whole rollout: relative to the largest sum).
TOL = {"pos": 1e-5, "vel": 1e-5, "rew_sum": 1e-4, "rew": 1e-5, "obs": 1e-5, "obs_sum": 1e-3,
       "ret": 1e-5, "last_obs": 1e-5, "act": 0.0, "cact": 0.0, "episodes": 0.0, "params": 1e-5,
       "obs2": 1e-5, "rows": 0.0, "chunk params": 1e-4, "obs_sum_rel": 1e-4}
# K6 sums the batch in its own order: each leaf within 1e-4 of its largest
# entry, the metric means within 1e-4 relative. Where the ratio is 1 (an
# epoch-0 batch) the pg mean is 0 up to rounding, since the advantages are
# normalized: it is gated on a batch where the clips bind
GRAD_TOL, METRIC_RTOL = 1e-4, 1e-4

# H100 SXM at its 700 W limit: 3.35 TB/s of HBM; 132 SMs at a 1.98 GHz boost
# clock, each completing per clock 128 fp32 operations, a fused multiply-add
# being one (so 256 flops: the 67 TFLOP/s of the data sheet), 16
# special-function operations (rsqrt, rcp, ex2, lg2), 64 int32 operations and
# 16 int->float conversions (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
PER_CLOCK = {"fp32": 128, "sfu": 16, "int": 64, "cvt": 16}
DISPATCH_PER_CLOCK = 128        # 4 schedulers x one 32-lane instruction each


def _ops(*terms: tuple[int, dict]) -> dict:
    """Sum of ``count x {class: operations}`` terms."""
    out = dict.fromkeys(PER_CLOCK, 0)
    for count, ops in terms:
        for k, v in ops.items():
            out[k] += count * v
    return out


# Operations the kernels' functions need, counted from the formulas of
# csrc/ (simple_spread: 3 agents, 3 landmarks, 3 pairs). Each add, multiply,
# min, max, compare and select is one operation, except that a multiply
# whose product feeds an add is fused with it: a multiply-add is one fp32
# operation, as the card retires it (the kernels' -fmad=false is their own
# choice, to round as PyTorch does, not something the function needs). A
# negation or an absolute value is an operand modifier and free; a special
# function is one SFU operation plus the fp32 operations that scale its
# argument or result (exp: x log2e; log: x ln2, fused with the add that
# takes it; log1p: 1 + y first; sqrt: x rsqrt(x)). The divide by the
# loop-invariant contact margin is a product with its reciprocal, computed
# once, and the correction of a correctly rounded quotient: 3 fp32. Control
# flow and data movement are not operations. Loop-invariant index
# arithmetic is hoisted.
HASH = {"int": 10, "cvt": 1, "fp32": 1}     # + salt, fmix32 (3 shifts, 3 xors, 2 multiplies),
#                                             >> 8; to float; x 2^-24
DECODE = {"fp32": 4}                        # per agent: 2 differences, 2 products with accel
PAIR_FORCE = {"fp32": 21, "sfu": 3}         # dx, dy; d2 (mul, fma); max; d2 inv; - dmin;
#                                             / margin (3); logaddexp (max, exp 1, 1 + y,
#                                             x ln2 + max); x margin, x contact_force, x inv;
#                                             4 accumulations of s dx, s dy (fma)
INTEGRATE = {"fp32": 6}                     # per agent and axis: v keep + f dt (mul, fma),
#                                             p + v dt (fma)
LANDMARK_DIST = {"fp32": 5, "sfu": 1}       # 2 differences, d2 (mul, fma), sqrt
PAIR_COLLISION = {"fp32": 7}                # dx, dy, d2 (2), compare, select, 2 sel + coll (fma)
REWARD_REST = {"fp32": 11}                  # 6 mins over agents, 3 sums over landmarks,
#                                             A base - coll (fma), - A
ACCUMULATE = {"fp32": 1}                    # a running reward sum (K1, K2, K4)
OBS_SUM = {"fp32": 78}                      # 30 relative coordinates, 16 nonzero rows x 2 adds
#                                             over agents, 15 adds over rows, accumulate
SPREAD_STEP = ((12, HASH), (3, DECODE), (3, PAIR_FORCE), (3, INTEGRATE), (9, LANDMARK_DIST),
               (3, PAIR_COLLISION), (1, REWARD_REST))  # 12 hashes: the no-op column is unread
# a reset (and the initial draw) hashes 12 coordinates, scales and shifts
# each (one fma) and salts twice
RESET = _ops((12, HASH), (12, {"fp32": 1}), (2, {"int": 1}))
OPS = {
    # step: + the move salt (1 int), the horizon counter and test (2 int)
    "scenario_rollout_kernel[simple_spread]": {
        "step": _ops(*SPREAD_STEP, (1, ACCUMULATE), (1, OBS_SUM), (3, {"int": 1})),
        "reset": RESET,
        "env": {},
    },
}

# The MLPs of the policy, update and MADDPG kernels. A dense layer of n_in
# inputs needs per output n_in multiply-adds (the first product takes the
# bias); tanh is 1 - 2 / (exp(2x) + 1): 2 SFU (exp, reciprocal) and 4 fp32
# (2x, x log2e, + 1, 1 - 2 r as one fma).
TANH = {"fp32": 4, "sfu": 2}


def dense(n_in: int, n_out: int) -> tuple[int, dict]:
    return n_out, {"fp32": n_in}


def torso(n_in: int) -> tuple:
    """The two tanh layers of an n_in-64-64 MLP."""
    return dense(n_in, 64), (64, TANH), dense(64, 64), (64, TANH)


GUMBEL = {"int": 10, "cvt": 1, "fp32": 6, "sfu": 2}  # the hash (10 int, cvt, x 2^-24); + 1e-12,
#                                                      log, its x ln2 fused with + 1e-12; log,
#                                                      its x ln2 fused with the logit's -;
#                                                      argmax: compare, select


def update_sample(n_in: int, n_out: int, comm: int, value: bool) -> dict:
    """K6 (value) or K7's actor pass per sample (csrc/mpe_update.cu), an
    n_in-64-64-n_out MLP: besides the forward, the softmax of the 5 move
    logits (4 max; 5 x (-, x log2e, exp); 4 sums; log, its x ln2 fused into
    the 5 ls = (z - m) - lse; 1 reciprocal and 5 products), the entropy and
    logp sums (5 + 5), the ratio (-, x log2e, exp), clamp (2), s1, s2, the
    indicator, -(a r) / B and select (3), g3 of the logits (5 x 5), the
    metric terms (5): 81 fp32, 8 SFU; with a value output its clip, both
    squares, the indicator and the value gradient (13 more). A comm head of
    C logits adds its softmax (6C - 2 fp32, C + 2 SFU), its logp and entropy
    sums (2C), the speak products (2) and g3 of its logits (6C): 14C fp32.
    Backward: 64 x (n_out multiply-adds, 1 - h^2 as one fma, the product)
    for gh2, 64 x 64 multiply-adds + 64 x 2 for gh1. Weight gradients:
    64 x n_in + 64 x 64 + n_out x 64 multiply-adds, 128 + n_out bias sums."""
    return _ops(*torso(n_in), dense(64, n_out), (1, {"fp32": 81 + 13 * value, "sfu": 8}),
                (1 if comm else 0, {"fp32": 14 * comm, "sfu": comm + 2}),
                (1, {"fp32": 64 * (n_out + 2) + 64 * 64 + 64 * 2}),
                (1, {"fp32": 64 * n_in + 64 * 64 + n_out * 64 + 128 + n_out}))


def critic_sample(n_in: int) -> dict:
    """K7's critic pass per (t, env) sample: the n_in-64-64-1 MLP, the value
    clip (13), the backward pass (64 x 3 for gh2, 64 x 64 + 64 x 2) and the
    weight gradients (64 x n_in + 64 x 64 + 64 multiply-adds, 129 bias
    sums)."""
    return _ops(*torso(n_in), dense(64, 1), (1, {"fp32": 13}),
                (1, {"fp32": 64 * 3 + 64 * 64 + 64 * 2}),
                (1, {"fp32": 64 * n_in + 64 * 64 + 64 + 129}))


# K3 (csrc/mpe_trajectory.cu) per env-step. It emits every move draw, so all 5
# columns are hashed, and the comm draws of non-silent agents; then the step,
# the reward and the obs rows, and the move salt, the comm salt, the horizon
# counter and test (int). A goal's landmark is picked by 2 compares (int) and
# 2 selects per coordinate; a goal color entry is a compare and a select. A
# reset draws the positions (a hash and a fma per coordinate, a salt per call
# id) and each goal (a hash, x k, floor, a conversion, a salt).
GOAL_PICK = {"int": 2, "fp32": 4}
GOAL_DRAW = _ops((1, HASH), (1, {"fp32": 2, "cvt": 1, "int": 1}))


def reset_ops(coords: int, goals: int) -> dict:
    return _ops((coords, HASH), (coords, {"fp32": 1}), (2, {"int": 1}), (goals, GOAL_DRAW))


TRAJ_OPS = {
    # K2's spread step with 15 move hashes, + 30 obs coordinates; counter 3
    "simple_spread": {"step": _ops((15, HASH), *SPREAD_STEP[1:], (1, {"fp32": 30}),
                                   (3, {"int": 1})), "reset": RESET},
    # decode, integrate; reward: 2 differences, d2 (mul, fma); the obs reuses them
    "simple": {"step": _ops((5, HASH), (1, DECODE), (1, INTEGRATE), (1, {"fp32": 4}),
                            (3, {"int": 1})), "reset": reset_ops(4, 0)},
    # 2 agents: 10 move and 20 comm hashes; reward per agent: the goal pick, dx,
    # dy, d2 (2), the running sum; obs: 12 landmark coordinates, 6 color entries
    "simple_reference": {"step": _ops((30, HASH), (2, DECODE), (2, INTEGRATE), (2, GOAL_PICK),
                                      (2, {"fp32": 5}), (1, {"fp32": 12}),
                                      (6, {"int": 1, "fp32": 1}), (4, {"int": 1})),
                         "reset": reset_ops(10, 2)},
    # the listener moves, the speaker speaks: 10 move and 3 comm hashes; reward:
    # the goal pick, dx, dy, d2 (2), x -2; obs: 6 landmark coordinates, 3 colors
    "simple_speaker_listener": {"step": _ops((13, HASH), (1, DECODE), (1, INTEGRATE),
                                             (1, GOAL_PICK), (1, {"fp32": 5}), (1, {"fp32": 6}),
                                             (3, {"int": 1, "fp32": 1}), (4, {"int": 1})),
                                "reset": reset_ops(10, 1)},
}
OPS.update({f"trajectory_kernel[{k}]": {**v, "env": {}} for k, v in TRAJ_OPS.items()})

# K2 on the other scenarios (csrc/mpe_kernels.cu::scenario_rollout_kernel) per
# env-step: the move hashes that the decode reads (4 per movable agent), the
# comm hashes that the obs reads (non-silent agents), the step and reward as
# in K3, the obs sum (per row over agents, then over rows, then the running
# sum; the speaker's zero rows add nothing), the running reward sum, and the
# move salt, the comm salt (with comm), the horizon counter and test.
K2_SCN_OPS = {
    "simple": {"step": _ops((4, HASH), (1, DECODE), (1, INTEGRATE), (1, {"fp32": 4}),
                            (1, {"fp32": 4}), (1, ACCUMULATE), (3, {"int": 1})),
               "reset": reset_ops(4, 0)},
    # obs: 21 rows over 2 agents, 20 adds over rows, the running sum
    "simple_reference": {"step": _ops((28, HASH), (2, DECODE), (2, INTEGRATE), (2, GOAL_PICK),
                                      (2, {"fp32": 5}), (1, {"fp32": 12}),
                                      (6, {"int": 1, "fp32": 1}), (1, {"fp32": 42}),
                                      (1, ACCUMULATE), (4, {"int": 1})),
                         "reset": reset_ops(10, 2)},
    # obs: 3 color rows over 2 agents, 10 adds over rows, the running sum
    "simple_speaker_listener": {"step": _ops((7, HASH), (1, DECODE), (1, INTEGRATE),
                                             (1, GOAL_PICK), (1, {"fp32": 5}), (1, {"fp32": 6}),
                                             (3, {"int": 1, "fp32": 1}), (1, {"fp32": 14}),
                                             (1, ACCUMULATE), (4, {"int": 1})),
                                "reset": reset_ops(10, 1)},
}

# The five scenarios of csrc/scenario_blocks.cuh with PhysParams. A pair with a
# landmark accumulates into one agent only (2 fp32 less than PAIR_FORCE); the
# pair physics (mxu_physics_block's order) adds the action force to the pair
# sum (2 more per agent) and clamps each agent's speed: s2 (mul, fma), max,
# rsqrt, compare, max_speed x inv_s, select, factor - 1, 1 +, 2 products.
LANDMARK_PAIR_FORCE = {"fp32": 19, "sfu": 3}
CLAMP = {"fp32": 10, "sfu": 1}
INTEGRATE_PAIRS = {"fp32": 8}
DIST = {"fp32": 5, "sfu": 1}                # dx, dy, d2 (mul, fma), sqrt
D2_TEST = {"fp32": 7}                       # dx, dy, d2 (2), compare, select, running add
BOUND = {"fp32": 9, "sfu": 1}               # 2 compares, x - 0.9, x 10, 2x - 2 (fma), x log2e,
#                                             exp, min 10, 2 selects; + the sum over axes
STEP_INT = {"int": 1}                       # a salt, the horizon counter or its test

# Per scenario: the hashes that K2 draws (the move columns that the decode
# reads, 4 per movable agent, and the comm of the speakers) and that K3 draws
# (all 5 move columns of every agent), the decode, the (agent, agent) and
# (agent, landmark) pairs, the integration (and the clamp), the reward terms,
# the obs coordinates and selects; K2 adds the obs sum (one add per nonzero
# entry) and the running sums of the reward rows; the salts, the counter and
# its test; K1 (below) one salt per agent and the step counter (salts).
PHYS = {
    # 3 movable agents, no pair; reward: the goal pick, 3 distances, -d0^2, the
    # min, + d0; obs: 28 relative coordinates, 28 nonzero entries; 3 rows
    "simple_adversary": dict(agents=3, moves=12, all_moves=15, comm=0, pairs=(0, 0), clamp=False,
                             reward=((1, GOAL_PICK), (3, DIST), (1, {"fp32": 3})), obs_rel=28,
                             entries=28, rows=3, salts=4, reset=reset_ops(10, 1)),
    # 2 agents, 1 pair (generic order); reward: the pick, 2 distances, d1 - d0;
    # obs: 14 coordinates, the own color (2 compares, 2 selects), 27 entries
    "simple_push": dict(agents=2, moves=8, all_moves=10, comm=0, pairs=(1, 0), clamp=False,
                        reward=((1, GOAL_PICK), (2, DIST), (1, {"fp32": 1}),
                                (1, {"int": 2, "fp32": 2})), obs_rel=14, entries=27, rows=2,
                        salts=3, reset=reset_ops(8, 1)),
    # immobile agents, 12 comm hashes; reward: 2 guarded errors (4 x (!= 0,
    # select, max) + 4 x (goal compare, select, -, square or fma) + x nz) and
    # -gb + ge; obs: 12 one-hot entries (compare, select), 20 nonzero entries
    "simple_crypto": dict(agents=0, moves=0, all_moves=15, comm=12, pairs=(0, 0), clamp=False,
                          reward=((2, {"fp32": 25, "int": 4}), (1, {"fp32": 1}),
                                  (1, {"int": 12, "fp32": 12})), obs_rel=0, entries=20, rows=3,
                          salts=4, reset=reset_ops(10, 2)),
    # 4 agents, 6 + 8 pairs, clamped; reward: 3 prey tests, 2 bound terms,
    # 10 hits, -10 hits - bound; obs: 40 coordinates, 62 entries
    "simple_tag": dict(agents=4, moves=16, all_moves=20, comm=0, pairs=(6, 8), clamp=True,
                       reward=((3, D2_TEST), (2, BOUND), (1, {"fp32": 3})), obs_rel=40,
                       entries=62, rows=4, salts=5, reset=reset_ops(12, 0)),
    # 6 agents, 15 + 6 pairs, clamped; 4 leader comm hashes. Derived: 8 good x
    # adversary d2 (4 each), 12 forest tests (5 each), the visibility (6
    # boolean operations for each of 30 ordered pairs). Reward: 8 pair hits
    # (compare, select, add); 4 adversary rows (min, sqrt, -0.1 x, + 5 ph);
    # 2 good rows (4 hits (select, add), 2 BOUND, 2 food tests (D2_TEST) and
    # their min, sqrt, 4 terms). Obs: 120 coordinates, 60 + 20 masking
    # selects, 12 forest selects, 192 nonzero entries
    "simple_world_comm": dict(agents=6, moves=24, all_moves=30, comm=4, pairs=(15, 6), clamp=True,
                              reward=((8, {"fp32": 4}), (12, {"fp32": 5}), (30, {"int": 6}),
                                      (8, {"fp32": 3}), (4, {"fp32": 4}), (4, {"sfu": 1}),
                                      (2, _ops((4, {"fp32": 2}), (2, BOUND), (2, D2_TEST),
                                               (1, {"fp32": 6, "sfu": 1})))),
                              obs_rel=212, entries=192, rows=6, salts=7, reset=reset_ops(22, 0)),
}


def phys_ops(p: dict) -> tuple[dict, dict]:
    """(K2's, K3's) operations per env-step of a PHYS scenario."""
    k3 = _ops((p["all_moves"] + p["comm"], HASH), (p["agents"], DECODE),
              (p["pairs"][0], PAIR_FORCE), (p["pairs"][1], LANDMARK_PAIR_FORCE),
              (p["agents"], INTEGRATE_PAIRS if p["clamp"] else INTEGRATE),
              (p["agents"] if p["clamp"] else 0, CLAMP), *p["reward"],
              (1, {"fp32": p["obs_rel"]}), (4 if p["comm"] else 3, STEP_INT))
    k2 = _ops((1, k3), (p["all_moves"] - p["moves"], {k: -v for k, v in HASH.items()}),
              (1, {"fp32": p["entries"] + p["rows"]}))
    return k2, k3


for _name, _p in PHYS.items():
    K2_SCN_OPS[_name], TRAJ_OPS[_name] = ({"step": ops, "reset": _p["reset"]}
                                          for ops in phys_ops(_p))
OPS.update({f"scenario_rollout_kernel[{k}]": {**v, "env": {}} for k, v in K2_SCN_OPS.items()})
OPS.update({f"trajectory_kernel[{k}]": {**v, "env": {}} for k, v in TRAJ_OPS.items()
            if k in PHYS})

# K1 (csrc/mpe_kernels.cu::det_rollout_kernel<S>) per env-step: the move
# hashes that the decode reads (4 per movable agent; the no-op column and an
# immovable agent's draws are unread), the physics and the reward as in K2,
# the running sum of each reward row, one salt per agent and the step counter
# (int); once per env the final obs (its relative coordinates).
K1_OPS = {
    "simple_spread": {"step": _ops(*SPREAD_STEP, (1, ACCUMULATE), (4, STEP_INT)),
                      "env": {"fp32": 30}},
    "simple": {"step": _ops((4, HASH), (1, DECODE), (1, INTEGRATE), (1, {"fp32": 4}),
                            (1, ACCUMULATE), (2, STEP_INT)), "env": {"fp32": 2}},
    "simple_reference": {"step": _ops((8, HASH), (2, DECODE), (2, INTEGRATE), (2, GOAL_PICK),
                                      (2, {"fp32": 5}), (1, ACCUMULATE), (3, STEP_INT)),
                         "env": {"fp32": 12}},
    "simple_speaker_listener": {"step": _ops((4, HASH), (1, DECODE), (1, INTEGRATE),
                                             (1, GOAL_PICK), (1, {"fp32": 5}), (1, ACCUMULATE),
                                             (3, STEP_INT)), "env": {"fp32": 6}},
}
for _name, _p in PHYS.items():
    K1_OPS[_name] = {"step": _ops((_p["moves"], HASH), (_p["agents"], DECODE),
                                  (_p["pairs"][0], PAIR_FORCE),
                                  (_p["pairs"][1], LANDMARK_PAIR_FORCE),
                                  (_p["agents"], INTEGRATE_PAIRS if _p["clamp"] else INTEGRATE),
                                  (_p["agents"] if _p["clamp"] else 0, CLAMP), *_p["reward"],
                                  (_p["rows"], ACCUMULATE), (_p["salts"], STEP_INT)),
                     "env": {"fp32": _p["obs_rel"]}}
OPS.update({f"det_rollout_kernel[{k}]": {**v, "reset": {}} for k, v in K1_OPS.items()})


def widths(name: str) -> tuple[int, int, int, int, int]:
    """(agents, obs width, comm logits C, speakers, reward rows) of a
    scenario's kernel blocks (mpe_tpu_torch.ops.kernel_scenarios)."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    k = kernel_scenario(name)
    return k.spec.n_agents, k.obs_w, k.n_comm, sum(k.speak or ()), k.reward_rows


def policy_ops(name: str) -> tuple[dict, dict]:
    """(K5's, K4's) operations (csrc/mpe_policy.cu) from K3's step on the
    same scenario, which draws as many uniforms (5 moves per agent, C comm
    logits per speaker): each draw becomes a Gumbel-max draw (GUMBEL in
    place of HASH), every agent runs the MLP OW-64-64-(5+C), the one-hot move
    takes 5 compares per agent; K5 writes the last obs (A OW); K4 adds the
    running return of each reward row and counts episodes."""
    a, ow, c, speakers, r = widths(name)
    draws = 5 * a + c * speakers
    step = _ops((1, TRAJ_OPS[name]["step"]), (-draws, HASH), (draws, GUMBEL),
                (a, _ops(*torso(ow), dense(64, 5 + c))), (a, {"int": 5}))
    reset = TRAJ_OPS[name]["reset"]
    return ({"step": step, "reset": reset, "env": {"fp32": a * ow}},
            {"step": _ops((1, step), (r, ACCUMULATE)), "reset": _ops((1, reset), (1, {"fp32": 1})),
             "env": {}})


def maddpg_ops(name: str) -> dict:
    """K8's operations (csrc/mpe_maddpg.cu::maddpg_traj_kernel<S>) from K3's
    step on the same scenario, which hashes the move columns of every agent
    and the comm of the speakers: K8 instead draws per agent and head a
    Gumbel-max of the logits and one of zeros (2 (5 + C) GUMBEL draws), an
    eps coin per head (a hash, compare, select) with 3 salts, runs the MLP
    OW-64-64-(5+C), sets the one-hots (5 + C compares), and computes the obs
    twice (the s' rows: A OW more)."""
    a, ow, c, speakers, _ = widths(name)
    heads = 2 if c else 1
    agent = _ops(*torso(ow), dense(64, 5 + c), (2 * (5 + c), GUMBEL),
                 (heads, {"int": 13, "cvt": 1, "fp32": 3}), (5 + c, {"int": 1}))
    step = _ops((1, TRAJ_OPS[name]["step"]), (-(5 * a + c * speakers), HASH), (a, agent),
                (1, {"fp32": a * ow}))
    return {"step": step, "reset": TRAJ_OPS[name]["reset"], "env": {}}


def maddpg_update_ops(name: str) -> dict:
    """K9's operations per (sample, agent) pair (csrc/mpe_maddpg.cu), a
    "step" being a sample of one agent: the target actor and its first
    argmax per head (a compare and a select per logit); the target critic
    (J-64-64-1) and y (1 fma); the critic forward with the candidates' base
    (64 x (K fma + 1)); each of the 5 max(C, 1) candidates: + base (64),
    tanh, layers 2-3; d, g3 and the backward pass (64 x 3, 64 x 64 + 64 x
    2); the critic's weight gradients (64 J + 64 x 64 + 64 multiply-adds,
    129 bias sums); the actor forward; per head the softmax, entropy and
    logit gradient (18 fp32 and 3 SFU per logit: exp, reciprocal, log), and
    with comm the two qbar sums (2 per candidate); the actor backward and
    weight gradients as in K7."""
    a, ow, c, _, _ = widths(name)
    k, n_cand = 5 + c, 5 * max(c, 1)
    j = a * (ow + k)
    critic_tail = _ops(dense(64, 64), (64, TANH), dense(64, 1))
    sample = _ops(
        *torso(ow), dense(64, k), (1, {"fp32": 2 * k}),
        dense(j, 64), (64, TANH), (1, critic_tail), (1, {"fp32": 1}),
        dense(j, 64), (64, {"fp32": k + 1}), (64, TANH), (1, critic_tail),
        (n_cand * 64, {"fp32": 1}), (n_cand * 64, TANH), (n_cand, critic_tail),
        (1, {"fp32": 2 + 64 * 3 + 64 * 64 + 64 * 2}), (1, {"fp32": 64 * j + 64 * 64 + 64 + 129}),
        *torso(ow), dense(64, k), (k, {"fp32": 18, "sfu": 3}),
        (1 if c else 0, {"fp32": 2 * n_cand}),
        (1, {"fp32": 64 * (k + 2) + 64 * 64 + 64 * 2}),
        (1, {"fp32": 64 * ow + 64 * 64 + k * 64 + 128 + k}))
    return {"step": sample, "reset": {}, "env": {}}


def add_policy_ops() -> None:
    """OPS of K4-K9 on every scenario, from its widths (which need the
    package, so main adds them after importing it)."""
    for name in ALL_SCENARIOS:
        a, ow, c, _, _ = widths(name)
        OPS[f"policy_traj_kernel[{name}]"], OPS[f"policy_rollout_kernel[{name}]"] = \
            policy_ops(name)
        # a "step" is a sample: K6's (t, agent, env); K7's actor sample, and
        # as its "reset" a critic sample (t, env)
        OPS[f"ppo_update_kernel[{name}]"] = {"step": update_sample(ow, 6 + c, c, True),
                                             "reset": {}, "env": {}}
        OPS[f"mappo_update_kernel[{name}]"] = {"step": update_sample(ow, 5 + c, c, False),
                                               "reset": critic_sample(a * ow), "env": {}}
        OPS[f"maddpg_traj_kernel[{name}]"] = maddpg_ops(name)
        OPS[f"maddpg_update_kernel[{name}]"] = maddpg_update_ops(name)


def bound_ms(ops: dict, env_steps: int, resets: int, envs: int,
             bytes_moved: int) -> tuple[float, str, float]:
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate and each class's operations over its rate.
    -> (ms, "bytes" or "operations", issue floor in ms: all operations
    over the schedulers' rate, printed beside the bound and not part of
    it)."""
    total = _ops((env_steps, ops["step"]), (resets, ops["reset"]), (envs, ops["env"]))
    t_ops = max(total[k] / (PER_CLOCK[k] * SM_CLOCKS_PER_S) for k in PER_CLOCK)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_issue = sum(total.values()) / (DISPATCH_PER_CLOCK * SM_CLOCKS_PER_S)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), 1e3 * t_issue


def cuda_time(fn, repeats: int, warm_up: bool = True):
    """(median ms, last output) of ``fn()`` over ``repeats`` runs after one
    warm-up (or none), by CUDA events on the current stream."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def mean_se(x) -> tuple[float, float]:
    """Mean and standard error over envs of a per-env statistic."""
    x = x.double()
    return float(x.mean()), float(x.std() / math.sqrt(x.numel()))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(label: str, errs: dict[str, float]) -> float:
    print(f"{label} max abs err vs plain: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= TOL[k]}
    if bad:
        raise AssertionError(f"{label} disagrees with its plain version beyond {TOL}: {bad}")
    return max(errs.values())


def report_actions(label: str, got, ref) -> None:
    """Share of equal actions and the first step [T, ...] that differs."""
    same = got == ref
    print(f"{label} actions equal to plain: {float(same.double().mean()):.6f}")
    if not bool(same.all()):
        first = int((~same).reshape(same.shape[0], -1).any(1).nonzero()[0])
        print(f"{label} first step with another action: {first}")


def zero_launches(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "launches_by"):
            w.launches_by.clear()


def read_launches(wrappers: dict, path: list[str], label: str) -> dict:
    launches = {name: wrappers[name].launches for name in path}
    print(f"{label} launches: {launches}")
    assert all(n > 0 for n in launches.values()), f"a kernel of the {label} was never launched"
    return launches


def read_instantiations(wrapper, names, label: str) -> dict:
    """Launches of a template kernel by scenario: each of ``names`` launched."""
    by = {name: wrapper.launches_by[name] for name in names}
    print(f"{label} launches by scenario: {by}")
    assert all(n > 0 for n in by.values()), f"an instantiation of the {label} was never launched"
    return by


def check_update(label: str, update, params, batch, gated: tuple[str, ...]) -> float:
    """K6 against its plain version on ``batch``: each gradient leaf within
    GRAD_TOL of its largest entry and the metric means named in ``gated``
    within METRIC_RTOL -> the largest abs error of a leaf."""
    got, got_m = update(params, *batch)
    ref, ref_m = update.plain(params, *batch)
    errs, worst = {}, 0.0
    for k in ref:
        for q in ref[k]:
            err = max_err(got[k][q], ref[k][q])
            errs[f"{k}.{q}"] = err / float(ref[k][q].abs().max())
            worst = max(worst, err)
    metrics = dict(zip(("pg", "vloss", "entropy"), zip(got_m, ref_m)))
    print(f"{label} max abs err vs plain over each leaf's largest entry: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + "; metrics kernel vs plain: "
          + ", ".join(f"{k} {float(a):.8g} vs {float(b):.8g}" for k, (a, b) in metrics.items()))
    assert max(errs.values()) <= GRAD_TOL, f"{label}: the gradient disagrees with its plain version"
    assert all(abs(float(a) - float(b)) <= METRIC_RTOL * abs(float(b))
               for k, (a, b) in metrics.items() if k in gated), \
        f"{label}: the metrics disagree with their plain version"
    return worst


def library_ppo_grads(step, params, batch):
    """The epoch gradient by autograd of the trainer's own loss (its forward
    is torch.einsum, so torch.matmul): the library yardstick for K6 and K7, timed
    here only and never on the port's path. The loss normalizes the
    advantages again, a near-identity on the normalized ones."""
    import torch

    leaves = {k: {q: x.detach().requires_grad_(True) for q, x in layer.items()}
              for k, layer in params.items()}
    loss, _ = step.loss_fn(leaves, batch)
    return torch.autograd.grad(loss, [x for layer in leaves.values() for x in layer.values()])


def generic_engine(name: str, dev):
    """The generic engine (build_rollout over MpeEnv, env-minor, horizon
    HORIZON) on ``name`` at N_ENVS x GENERIC_STEPS, timed: per agent, (mean
    reward per env-step, its SE over envs)."""
    import torch

    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.parallel.mesh import build_rollout

    scn = scenarios.load(name)
    a, ow = scn.spec.n_agents, max(scn.obs_dims)
    env = MpeEnv(scn, max_steps=HORIZON, auto_reset=True)
    rollout = build_rollout(env, n_envs=N_ENVS, n_steps=GENERIC_STEPS, env_axis=-1)
    gen = torch.Generator(device=dev).manual_seed(0)
    float(rollout(gen)[1])                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, total = rollout(gen)
    float(total)
    generic_s = time.perf_counter() - t0
    traj_rollout = build_rollout(env, n_envs=N_ENVS, n_steps=GENERIC_STEPS, env_axis=-1,
                                 return_trajectory=True)
    _, traj = traj_rollout(gen)
    rew = traj["reward"]                                # [T, A, N]
    assert rew.shape == (GENERIC_STEPS, a, N_ENVS) and bool(torch.isfinite(rew).all())
    assert traj["obs"].shape == (GENERIC_STEPS, a, ow, N_ENVS)
    assert bool(torch.isfinite(states.pos).all())
    stats = [mean_se(rew[:, i, :].mean(0)) for i in range(a)]
    print(f"generic engine, {name}: {N_ENVS * GENERIC_STEPS / generic_s:.6g} env-steps/s "
          f"({N_ENVS} envs x {GENERIC_STEPS} steps in {generic_s * 1e3:.1f} ms); "
          f"mean reward per env-step by agent "
          + ", ".join(f"{m:.5f} +- {se:.5f}" for m, se in stats))
    return stats


def agree_with_generic(label: str, rew_sum, generic: list) -> None:
    """Each reward row's mean per env-step of the fused engine within 5 SE of
    the generic engine's for the same agent: row r is agent r's reward, or
    with one row the shared reward that every agent gets. Both engines draw
    the same distributions: uniform moves (the difference of two U[0, 1)
    entries per axis), U[0, 1) utterances for the speakers, uniform goals."""
    for r in range(rew_sum.shape[0]):
        (g_mean, g_se), (f_mean, f_se) = generic[r], mean_se(rew_sum[r] / N_STEPS)
        z = abs(f_mean - g_mean) / math.hypot(f_se, g_se)
        print(f"{label}, reward row {r}: mean reward per env-step {f_mean:.5f} +- {f_se:.5f}; "
              f"fused vs generic {z:.2f} standard errors apart")
        assert z < 5, f"{label}: fused and generic engines disagree in mean reward ({z:.2f} SE)"


def rollout_path(wrappers, spec, dev):
    """Main path a: generic engine, K2 at three widths, K1."""
    import torch

    from mpe_tpu_torch.ops.fused_parity import fused_det_rollout, make_det_inputs
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout

    zero_launches(wrappers)
    generic = generic_engine("simple_spread", dev)

    k2 = fused_spread_rollout(spec, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
    k2_ms, out = cuda_time(lambda: k2(1), REPEATS)
    pos, vel, rew_sum, obs_sum = out
    assert pos.shape == (6, 2, N_ENVS) and rew_sum.shape == (1, N_ENVS)
    for x in out:
        assert bool(torch.isfinite(x).all())
    print(f"fused engine (K2): {N_ENVS * N_STEPS / (k2_ms * 1e-3):.6g} env-steps/s "
          f"({N_ENVS} envs x {N_STEPS} steps, kernel {k2_ms:.4f} ms, median of {REPEATS})")
    agree_with_generic("fused engine (K2), simple_spread", rew_sum, generic)

    k2_ms_at = {N_ENVS: k2_ms}
    for n in (MID_ENVS, WIDE_ENVS):
        run = fused_spread_rollout(spec, n, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
        k2_ms_at[n], out = cuda_time(lambda: run(2), REPEATS)
        for x in out:
            assert bool(torch.isfinite(x).all())
        print(f"fused engine (K2): {n * N_STEPS / (k2_ms_at[n] * 1e-3):.6g} env-steps/s "
              f"({n} envs x {N_STEPS} steps, kernel {k2_ms_at[n]:.4f} ms, median of {REPEATS})")

    det_inputs = make_det_inputs("simple_spread", N_ENVS, seed=0)
    k1 = fused_det_rollout("simple_spread", N_ENVS, N_STEPS, block_envs=BLOCK_ENVS)
    k1_ms, out = cuda_time(lambda: k1(*det_inputs), REPEATS)
    for x in out:
        assert bool(torch.isfinite(x).all())
    assert bool((out[0] != det_inputs[0]).any())
    print(f"deterministic rollout (K1 <SpreadScn>): {N_ENVS * N_STEPS / (k1_ms * 1e-3):.6g} "
          f"env-steps/s ({N_ENVS} envs x {N_STEPS} steps, kernel {k1_ms:.4f} ms, median of "
          f"{REPEATS}; the spread-only kernel it replaced took {K1_SPREAD_ONLY_MS} ms)")
    launches = read_launches(wrappers, ["scenario_rollout_kernel", "det_rollout_kernel"],
                             "rollout path")
    by = read_instantiations(wrappers["scenario_rollout_kernel"], ["simple_spread"],
                             "rollout path's K2")
    k1_by = read_instantiations(wrappers["det_rollout_kernel"], ["simple_spread"],
                                "rollout path's K1")
    return launches, by, k1_by, k2, k2_ms_at, k1_ms, det_inputs


def training_path(wrappers, kscn, build, label: str, kernels: list[str]):
    """Main path b (PPO: K5, K6) or b2 (MAPPO: K5, K7): TRAIN_ITERS
    iterations of the fused trainer ``build``, timed by phase with CUDA
    events."""
    import torch

    step = build(kscn, **TRAIN)
    params = step.init_params(torch.Generator().manual_seed(0))
    state0 = step.init_state(params)
    zero_launches(wrappers)
    state, iters = state0, []
    for i in range(TRAIN_ITERS):
        events = []
        state, metrics = step(state, i, events=events)
        torch.cuda.synchronize()
        phases = dict.fromkeys(("collect", "prep", "update", "optimizer"), 0.0)
        for (_, a), (name, b) in zip(events, events[1:]):
            phases[name] += a.elapsed_time(b)
        total = events[0][1].elapsed_time(events[-1][1])
        m = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in m.values()), f"{label} iteration {i}: metrics {m}"
        iters.append((total, phases, m))
        print(f"{label} iter {i:2d}: {total:8.3f} ms ({step.n_transitions / (total * 1e-3):.6g} "
              f"transitions/s); " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f" ms; mean_reward {m['mean_reward']:.5f}, entropy {m['entropy']:.5f}, "
              f"loss {m['loss']:.5f}")
    launches = read_launches(wrappers, kernels, f"{label} path")
    steady = iters[1:]          # iteration 0 sets up the batched forward
    total_ms = sum(t for t, _, _ in steady)
    phase_ms = {k: sum(p[k] for _, p, _ in steady) for k in steady[0][1]}
    print(f"{label}, iterations 1-{TRAIN_ITERS - 1}: "
          f"{step.n_transitions * len(steady) / (total_ms * 1e-3):.6g} transitions/s "
          f"({len(steady)} x {step.n_transitions} transitions in {total_ms:.3f} ms); mean per "
          f"iteration {total_ms / len(steady):.3f} ms: "
          + ", ".join(f"{k} {v / len(steady):.3f} ms" for k, v in phase_ms.items())
          + f"; median per iteration {statistics.median(t for t, _, _ in steady):.3f} ms")
    for i in (0, 9, 19):
        m = iters[i][2]
        print(f"{label} iter {i}: mean_reward {m['mean_reward']:.6f}, entropy "
              f"{m['entropy']:.6f}, loss {m['loss']:.6f}, pg_loss {m['pg_loss']:.6f}, v_loss "
              f"{m['v_loss']:.6f}")
    return launches, step, state0, state


def maddpg_path(wrappers, name: str = "simple_spread", n_chunks: int = MADDPG_CHUNKS):
    """Main path d (simple_spread), d2 or d3 (the comm scenarios of
    MADDPG_COMM): the fused MADDPG loop (K8 collection, K9 updates) on
    ``name`` for ``n_chunks`` chunks, timed by phase with CUDA events ->
    (launches, launches by scenario, runner, params, info, transitions/s)."""
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner

    label = f"MADDPG ({name})"
    run = build_fused_maddpg_runner(name, **MADDPG)
    horizon = MADDPG["horizon"]
    zero_launches(wrappers)
    events = []
    t0 = time.perf_counter()
    params, info = run(n_chunks * horizon, seed=0, actor_start=MADDPG_ACTOR_START,
                       events=events)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = ["maddpg_traj_kernel", "maddpg_update_kernel"]
    launches = read_launches(wrappers, kernels, f"{label} path")
    by = {k: read_instantiations(wrappers[k], [name], f"{label} path's {k}") for k in kernels}
    chunks = []                 # (collect ms, update ms) per chunk
    for c in range(n_chunks):
        start, col, upd = events[2 * c][1], events[2 * c + 1][1], events[2 * c + 2][1]
        chunks.append((start.elapsed_time(col), col.elapsed_time(upd)))
    steady = chunks[1:]         # chunk 0 sets up the update's first allocations
    collect_ms, update_ms = (sum(x[q] for x in steady) for q in (0, 1))
    total_ms = collect_ms + update_ms
    n = run.transitions_per_chunk
    rate = n * len(steady) / (total_ms * 1e-3)
    mr, cl = info["mean_reward"].double(), info["critic_loss"].double()
    assert bool(torch.isfinite(mr).all()) and bool(torch.isfinite(cl).all()), (mr, cl)
    for net in params.values():
        for layer in net.values():
            assert all(bool(torch.isfinite(x).all()) for x in layer.values())
    print(f"{label}, chunks 1-{n_chunks - 1}: {rate:.6g} transitions/s ({len(steady)} x {n} "
          f"transitions, {len(steady) * horizon} updates of batch {MADDPG['batch']}, in "
          f"{total_ms:.3f} ms); mean per chunk {total_ms / len(steady):.3f} ms: collect "
          f"{collect_ms / len(steady):.3f} ms (K8 + insert), update {update_ms / len(steady):.3f} "
          f"ms ({horizon} x gather + K9 + Adam + polyak); median chunk "
          f"{statistics.median(a + b for a, b in steady):.3f} ms; the whole run with the warm-up "
          f"{wall_s:.2f} s (host clock)")
    print(f"{label} chunk 0: mean reward {float(mr[0]):.6f}, critic loss {float(cl[0]):.6f}; "
          f"chunk {n_chunks - 1}: mean reward {float(mr[-1]):.6f}, critic loss "
          f"{float(cl[-1]):.6f}; ring {info['buffer'].size} of {run.capacity} rows "
          f"({info['buffer'].data.numel() * 4 / 1e6:.0f} MB)")
    return launches, by, run, params, info, rate


def traj_bytes(name: str, n_envs: int, n_steps: int) -> int:
    """Bytes K3 writes on scenario ``name``: obs, act and rew per env-step,
    the final pos and vel."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    spec = kscn.spec
    a = spec.n_agents
    act_w = kscn.n_logits
    per_step = a * kscn.obs_w + a * act_w + kscn.reward_rows
    return 4 * n_envs * (n_steps * per_step + 2 * spec.n_entities * spec.dim_p)


def rollout_bytes(name: str, n_envs: int) -> int:
    """Bytes K2 writes on scenario ``name``: pos and vel, the reward and
    obs sums."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    spec = kscn.spec
    return 4 * n_envs * (2 * spec.n_entities * spec.dim_p + kscn.reward_rows + 1)


def det_bytes(name: str, n_envs: int) -> int:
    """Bytes K1 moves on scenario ``name``: it reads pos0 and vel0, the comm
    and the goals per env and writes pos, vel, the reward sum, the last
    reward and the last obs."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    spec = kscn.spec
    ep = 2 * spec.n_entities * spec.dim_p
    reads = ep + spec.n_agents * kscn.n_comm + len(tuple(kscn.goal_choices or ()))
    return 4 * n_envs * (reads + ep + 2 * kscn.reward_rows + spec.n_agents * kscn.obs_w)


def maddpg_widths(name: str) -> tuple[int, int, int, int, int, int]:
    """(agents, obs width, actor head 5 + C, replay row width, floats of one
    actor, floats of one critic) of a scenario's MADDPG nets, hidden 64."""
    a, ow, c, _, _ = widths(name)
    k = 5 + c
    j = a * (ow + k)
    nw = 64 * ow + 64 + 64 * 64 + 64 + k * 64 + k
    nc = 64 * j + 64 + 64 * 64 + 64 + 64 + 1
    return a, ow, k, a * (2 * ow + k + 1), nw, nc


def scenarios_path(wrappers, dev):
    """Main path e: K1 on the eight other scenarios at N_ENVS x N_STEPS, K2
    on them against the generic engine, then K3 on all nine at N_ENVS and on
    TRAJ_WIDE at WIDE_ENVS -> (launches, K1, K2 and K3 launches by scenario,
    K1 and K2 ms by scenario, {(scenario, envs): K3 ms})."""
    import torch

    from mpe_tpu_torch.ops.fused_parity import fused_det_rollout, make_det_inputs
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory

    zero_launches(wrappers)
    k1_ms, k2_ms = {}, {}
    for name in SCENARIOS:
        inputs = make_det_inputs(name, N_ENVS, seed=0)
        k1 = fused_det_rollout(name, N_ENVS, N_STEPS, block_envs=BLOCK_ENVS)
        k1_ms[name], out = cuda_time(lambda: k1(*inputs), REPEATS)
        for x in out:
            assert bool(torch.isfinite(x).all())
        print(f"deterministic rollout (K1), {name}: {N_ENVS * N_STEPS / (k1_ms[name] * 1e-3):.6g} "
              f"env-steps/s ({N_ENVS} envs x {N_STEPS} steps, kernel {k1_ms[name]:.4f} ms, "
              f"median of {REPEATS}); mean reward per env-step by row "
              + ", ".join(f"{float(x):.5f}" for x in out[2].double().mean(1) / N_STEPS))
        del out
    for name in SCENARIOS:
        generic = generic_engine(name, dev)
        run = fused_rollout(name, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
        k2_ms[name], out = cuda_time(lambda: run(1), REPEATS)
        for x in out:
            assert bool(torch.isfinite(x).all())
        print(f"fused engine (K2), {name}: {N_ENVS * N_STEPS / (k2_ms[name] * 1e-3):.6g} "
              f"env-steps/s ({N_ENVS} envs x {N_STEPS} steps, kernel {k2_ms[name]:.4f} ms, "
              f"median of {REPEATS})")
        agree_with_generic(f"fused engine (K2), {name}", out[2], generic)

    k3_ms = {}
    for name, n in [(x, N_ENVS) for x in ALL_SCENARIOS] + [(x, WIDE_ENVS) for x in TRAJ_WIDE]:
        run = fused_trajectory(name, n, **TRAJ)
        k3_ms[name, n], out = cuda_time(lambda: run(1), REPEATS)
        obs, act, rew, pos, vel = out
        for x in out:
            assert bool(torch.isfinite(x).all())
        assert obs.shape[0] == act.shape[0] == rew.shape[0] == TRAJ["n_steps"]
        assert bool(((act >= 0) & (act < 1)).all())
        nbytes = traj_bytes(name, n, TRAJ["n_steps"])
        print(f"trajectory (K3), {name}: {n} envs x {TRAJ['n_steps']} steps, kernel "
              f"{k3_ms[name, n]:.4f} ms (median of {REPEATS}); writes {nbytes} bytes, "
              f"{nbytes / (k3_ms[name, n] * 1e-3) / 1e12:.4f} TB/s "
              f"({nbytes / (k3_ms[name, n] * 1e-3) / HBM_BYTES_PER_S:.3f} of 3.35 TB/s); "
              f"{n * TRAJ['n_steps'] / (k3_ms[name, n] * 1e-3):.6g} env-steps/s; mean reward "
              f"per env-step by row " + ", ".join(f"{float(x):.5f}" for x in
                                                rew.double().mean((0, 2))))
        del out, obs, act, rew, pos, vel
    launches = read_launches(wrappers, ["det_rollout_kernel", "scenario_rollout_kernel",
                                        "trajectory_kernel"], "scenarios and trajectories path")
    by = {"det_rollout_kernel": read_instantiations(
              wrappers["det_rollout_kernel"], SCENARIOS, "scenarios path's K1"),
          "scenario_rollout_kernel": read_instantiations(
              wrappers["scenario_rollout_kernel"], SCENARIOS, "scenarios path's K2"),
          "trajectory_kernel": read_instantiations(
              wrappers["trajectory_kernel"], ALL_SCENARIOS, "trajectories path's K3")}
    return launches, by, k1_ms, k2_ms, k3_ms


def check_scenario_kernels():
    """K2 and K3 on the nine scenarios against their plain versions. K2 over
    CHECK_STEPS at N_ENVS with horizon CHECK_HORIZON (two block offsets,
    the first timed for the kernel and the plain version), on K2_LONG at path
    e's N_ENVS x N_STEPS and on LONG_GATE at N_ENVS x LONG_GATE_STEPS; K3 at
    TRAJ_CHECK (two block offsets), at path e's N_ENVS x 64 (the plain
    version timed) and, on TRAJ_WIDE, at WIDE_ENVS x 64. At path e's shapes
    the seed is not path e's, so no output that path e left in a recycled
    buffer can pass for the kernel's -> (K2 {scenario: max abs err}, K2
    {scenario: (kernel ms, plain ms)} at the check shape, plain K2 ms on
    K2_LONG at path e's shape, K3 {scenario: max abs err}, K3 {scenario:
    plain ms} at path e's N_ENVS x 64)."""
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory

    k2_err, k2_check_ms = {}, {}
    for name in ALL_SCENARIOS:
        run = fused_rollout(name, N_ENVS, CHECK_STEPS, horizon=CHECK_HORIZON,
                            block_envs=BLOCK_ENVS)
        errs = {}
        for offset in (0, 1):
            if offset == 0:
                ms, got = cuda_time(lambda: run(7), REPEATS)
                plain_ms, ref = cuda_time(lambda: run.plain(7), 1, warm_up=False)
                k2_check_ms[name] = (ms, plain_ms)
            else:
                got, ref = run(7, offset), run.plain(7, offset)
            for k, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got, ref):
                errs[k] = max(errs.get(k, 0.0), max_err(a, b))
        k2_err[name] = check(f"K2 ({name}; kernel {k2_check_ms[name][0]:.4f} ms, plain "
                             f"{k2_check_ms[name][1]:.1f} ms at {N_ENVS} envs x {CHECK_STEPS} "
                             "steps)", errs)
    # whole rollouts: the obs sums, summed in another order each step, drift
    # apart, so they are held relative to their largest; on simple_tag the
    # collisions magnify any difference in the order of operations
    plain_k2_long_ms = None
    for name, steps in ((K2_LONG, N_STEPS), *((n, LONG_GATE_STEPS) for n in LONG_GATE)):
        run = fused_rollout(name, N_ENVS, steps, horizon=HORIZON, block_envs=BLOCK_ENVS)
        plain_ms, ref = cuda_time(lambda: run.plain(5), 1, warm_up=False)
        if name == K2_LONG:
            plain_k2_long_ms = plain_ms
        got = run(5)
        errs = {k: max_err(a, b) for k, a, b in zip(("pos", "vel", "rew_sum"), got, ref)}
        k2_err[name] = max(k2_err[name], *errs.values())
        errs["obs_sum_rel"] = max_err(got[3], ref[3]) / float(ref[3].abs().max())
        check(f"K2 ({name}, {N_ENVS} envs x {steps} steps; plain {plain_ms:.1f} ms)", errs)

    k3_err, plain_k3_ms = {}, {}
    for name in ALL_SCENARIOS:
        small = fused_trajectory(name, **TRAJ_CHECK)
        errs = {}
        for offset in (0, 1):
            got, ref = small(3, offset), small.plain(3, offset)
            report_actions(f"K3 ({name}, block offset {offset})", got[1], ref[1])
            for k, a, b in zip(("obs", "act", "rew", "pos", "vel"), got, ref):
                errs[k] = max(errs.get(k, 0.0), max_err(a, b))
        widths = (N_ENVS, WIDE_ENVS) if name in TRAJ_WIDE else (N_ENVS,)
        for n in widths:
            full = fused_trajectory(name, n, **TRAJ)
            got = full(5)
            if n == N_ENVS:
                plain_k3_ms[name], ref = cuda_time(lambda: full.plain(5), 1,
                                                   warm_up=name == "simple_spread")
            else:
                ref = full.plain(5)
            report_actions(f"K3 ({name}, {n} envs x {TRAJ['n_steps']} steps)", got[1], ref[1])
            for k, a, b in zip(("obs", "act", "rew", "pos", "vel"), got, ref):
                errs[k] = max(errs[k], max_err(a, b))
            del got, ref
        k3_err[name] = check(f"K3 ({name}; {TRAJ_CHECK['n_envs']} envs x "
                             f"{TRAJ_CHECK['n_steps']} steps, two block offsets, and "
                             + " and ".join(f"{n} x {TRAJ['n_steps']}" for n in widths)
                             + f"; plain {plain_k3_ms[name]:.1f} ms at {N_ENVS} envs)", errs)
    return k2_err, k2_check_ms, plain_k2_long_ms, k3_err, plain_k3_ms


def evaluation_path(wrappers, evals: dict):
    """Main path c: each actor of ``evals`` ({scenario: init_policy-layout
    actor}) evaluated by K4 at N_ENVS x EVAL_STEPS, beside K2's
    uniform-random return on the same scenario and shape -> (launches,
    launches by scenario, {scenario: (K4's builder, kernel ms, outputs)})."""
    import torch

    from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout

    zero_launches(wrappers)
    runs = {}
    for name, actor in evals.items():
        k4 = fused_policy_rollout(name, actor, N_ENVS, EVAL_STEPS, horizon=EVAL_HORIZON,
                                  block_envs=BLOCK_ENVS)
        k4_ms, (ret, pos, eps) = cuda_time(lambda: k4(0, actor), REPEATS)
        for x in (ret, pos, eps):
            assert bool(torch.isfinite(x).all())
        assert bool((eps == EVAL_STEPS // EVAL_HORIZON).all())
        per_ep_mean, per_ep_se = mean_se(ret.mean(0) / eps[0])
        uniform = fused_rollout(name, N_ENVS, EVAL_STEPS, horizon=EVAL_HORIZON,
                                block_envs=BLOCK_ENVS)(0)[2]
        u_mean, u_se = mean_se(uniform.mean(0) / (EVAL_STEPS // EVAL_HORIZON))
        print(f"evaluation (K4), {name}: mean return per episode {per_ep_mean:.5f} +- "
              f"{per_ep_se:.5f} over {int(eps.sum())} episodes ({N_ENVS} envs x {EVAL_STEPS} "
              f"steps, horizon {EVAL_HORIZON}); uniform-random moves and utterances (K2) "
              f"{u_mean:.5f} +- {u_se:.5f}; kernel {k4_ms:.4f} ms, median of {REPEATS}")
        runs[name] = (k4, k4_ms, (ret, pos, eps))
    launches = read_launches(wrappers, ["policy_rollout_kernel"], "evaluation path")
    by = read_instantiations(wrappers["policy_rollout_kernel"], list(evals),
                             "evaluation path's K4")
    return launches, by, runs


def update_batches(step, params, label: str):
    """The trainer's epoch-0 batch of ``params`` and the same batch with both
    clips binding (``clip_binding_inputs``) -> (batch, clip batch, the
    library yardstick's batch)."""
    import torch

    from mpe_tpu_torch.ops.fused_update import clip_binding_inputs

    obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
    lpo_c, v_c, shares = clip_binding_inputs(logp_old, value, clip=TRAIN["clip"],
                                             generator=torch.Generator("cuda").manual_seed(11))
    print(f"{label} clip-binding batch: the ratio clip binds for {shares[0]:.4f} of the policy "
          f"samples, the value clip for {shares[1]:.4f} of the value samples")
    assert all(0.2 < s < 0.8 for s in shares), f"the clips bind for too few or too many: {shares}"
    return ((obs, mv_oh, cm_oh, logp_old, adv_n, ret, value),
            (obs, mv_oh, cm_oh, lpo_c, adv_n, ret, v_c),
            (obs, mv_oh, cm_oh, logp_old, value, adv_n, ret))


def check_update_kernels(kind: str, trained: dict) -> dict:
    """K6 (``kind`` "ppo") or K7 ("mappo") on every scenario: the trainer's
    batch at TRAIN's width from the params of ``trained`` ({scenario:
    (step, params)}, the main paths' trainers) or of a fresh trainer's
    init, gated against the plain version there and on the clip-binding
    batch; kernel, plain version and autograd of the trainer's loss timed
    -> {scenario: (max abs err, ms, plain ms, library ms, bound)}."""
    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step

    build = build_fused_ppo_step if kind == "ppo" else build_fused_mappo_step
    label = "K6" if kind == "ppo" else "K7"
    rows = {}
    for i, name in enumerate(ALL_SCENARIOS):
        if name in trained:
            step, params = trained[name]
        else:
            step = build(name, **TRAIN)
            params = step.init_params(torch.Generator().manual_seed(20 + i))
        batch, clipped, lib_batch = update_batches(step, params, f"{label} ({name})")
        gated = ("vloss", "entropy")            # epoch 0: the pg mean is 0 up to rounding
        err = max(check_update(f"{label} ({name}, trainer batch)", step.update, params, batch,
                               gated),
                  check_update(f"{label} ({name}, clip-binding batch)", step.update, params,
                               clipped, ("pg",) + gated))
        ms, _ = cuda_time(lambda: step.update(params, *batch), REPEATS)
        plain_ms, _ = cuda_time(lambda: step.update.plain(params, *batch), REPEATS)
        lib_ms, _ = cuda_time(lambda: library_ppo_grads(step, params, lib_batch), REPEATS)
        a, ow, c, _, _ = widths(name)
        t, n = batch[0].shape[0], batch[0].shape[3]
        per_sample = ow + 5 + c + 1                   # obs, one-hots, logp_old
        if kind == "ppo":
            n_w = 64 * (ow + 64 + 6 + c) + 128 + 6 + c
            bound = bound_ms(OPS[f"ppo_update_kernel[{name}]"], t * a * n, 0, 0,
                             t * a * n * (per_sample + 3) * 4 + 2 * n_w * 4)
        else:
            n_w = 64 * (ow + 64 + 5 + c) + 133 + c + 64 * (a * ow + 64 + 1) + 129
            bound = bound_ms(OPS[f"mappo_update_kernel[{name}]"], t * a * n, t * n, 0,
                             t * a * n * per_sample * 4 + t * n * 3 * 4 + 2 * n_w * 4)
        print(f"{label} ({name}) {ms:.4f} ms (one epoch, {t * a * n} policy samples), plain "
              f"{plain_ms:.3f} ms, autograd of the trainer's loss {lib_ms:.3f} ms; bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue floor "
              f"{bound[2]:.4f} ms")
        rows[name] = (err, ms, plain_ms, lib_ms, bound)
        del batch, clipped, lib_batch
    return rows


def policy_bounds(name: str, n_envs: int, n_steps: int, horizon: int) -> tuple[tuple, tuple]:
    """(K5's, K4's) bound on ``name`` at n_envs x n_steps: K5 writes obs
    [T,A,OW], act (and cact) [T,A] and rew [T,R] per env and last_obs; K4
    writes ret [R], pos [E,2] and episodes per env; both read the weights
    once."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    a, ow, c, _, r = widths(name)
    e = kernel_scenario(name).spec.n_entities
    w_bytes = (64 * (ow + 64 + 5 + c) + 128 + 5 + c) * 4
    env_steps, resets = n_envs * n_steps, n_envs * (n_steps // horizon + 1)
    out_floats = n_steps * (a * ow + a * (2 if c else 1) + r) + a * ow
    return (bound_ms(OPS[f"policy_traj_kernel[{name}]"], env_steps, resets, n_envs,
                     n_envs * out_floats * 4 + w_bytes),
            bound_ms(OPS[f"policy_rollout_kernel[{name}]"], env_steps, resets, n_envs,
                     n_envs * (r + 2 * e + 1) * 4 + w_bytes))


def check_main_policy_shapes(k4_runs: dict, evals: dict, trainer_actors: dict):
    """K4 at path c's shape on each actor it evaluated (``k4_runs`` and
    ``evals`` of evaluation_path), its outputs held against the plain
    version on the same actor and seed; K5 at the training shape (TRAIN,
    horizon 32) with the actor of each trainer of ``trainer_actors``
    ({scenario: actor}); kernels and plain versions timed -> ({scenario:
    (K4 err, ms, plain ms, bound)}, {scenario: (K5 err, ms, plain ms,
    bound)})."""
    from mpe_tpu_torch.ops.fused_policy import fused_policy_trajectory

    k4, k5 = {}, {}
    for name, (run, ms, got) in k4_runs.items():
        # one plain run: about 7 s at this shape
        plain_ms, ref = cuda_time(lambda: run.plain(0, evals[name]), 1, warm_up=False)
        print(f"K4 ({name}) at the evaluation shape: lanes with a return equal to plain "
              f"{float((got[0] == ref[0]).double().mean()):.6f}")
        err = check(f"K4 ({name}) at the evaluation shape ({N_ENVS} envs x {EVAL_STEPS} steps; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms)",
                    {k: max_err(x, y) for k, x, y in zip(("ret", "pos", "episodes"), got, ref)})
        k4[name] = (err, ms, plain_ms, policy_bounds(name, N_ENVS, EVAL_STEPS, EVAL_HORIZON)[1])
        del ref
    for name, actor in trainer_actors.items():
        traj = fused_policy_trajectory(name, actor, TRAIN["n_envs"], TRAIN["n_steps"],
                                       horizon=TRAIN["horizon"], block_envs=TRAIN["block_envs"],
                                       t_chunk=TRAIN["t_chunk"])
        ms, got = cuda_time(lambda: traj(1, actor), REPEATS)
        plain_ms, ref = cuda_time(lambda: traj.plain(1, actor), 1)
        labels = ("obs", "act", "cact", "rew", "last_obs") if traj.has_comm else (
            "obs", "act", "rew", "last_obs")
        report_actions(f"K5 ({name}) at the training shape, moves", got[1], ref[1])
        if traj.has_comm:
            report_actions(f"K5 ({name}) at the training shape, comm", got[2], ref[2])
        err = check(f"K5 ({name}) at the training shape ({TRAIN['n_envs']} envs x "
                    f"{TRAIN['n_steps']} steps, horizon {TRAIN['horizon']}; kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.1f} ms)",
                    {k: max_err(x, y) for k, x, y in zip(labels, got, ref)})
        k5[name] = (err, ms, plain_ms, policy_bounds(name, TRAIN["n_envs"], TRAIN["n_steps"],
                                                      TRAIN["horizon"])[0])
        del got, ref
    return k4, k5


def check_policy_kernels(actors: dict) -> tuple[dict, dict]:
    """K5 on every scenario at N_ENVS x POLICY_GATE and K4 on the eight other
    than simple_spread at N_ENVS x EVAL_GATE_STEPS (horizon EVAL_HORIZON),
    each with the actor of ``actors`` (the main paths' where they exist)
    or an init_policy actor (He-scaled head, O(1) logits): moves and comm
    indices equal, values within 1e-5; kernel and plain version timed ->
    ({scenario: (K5 err, ms, plain ms, bound)}, {scenario: (K4 err, ms,
    plain ms, bound)} without simple_spread, whose K4 is gated at path c's
    shape)."""
    import torch

    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout, fused_policy_trajectory

    k5, k4 = {}, {}
    for i, name in enumerate(ALL_SCENARIOS):
        _, ow, c, _, _ = widths(name)
        actor = actors.get(name)
        if actor is None:
            actor = {k: {q: x.cuda() for q, x in layer.items()} for k, layer in
                     init_policy(torch.Generator().manual_seed(30 + i), ow, 5 + c).items()}
        traj = fused_policy_trajectory(name, actor, N_ENVS, **POLICY_GATE)
        ms, got = cuda_time(lambda: traj(4, actor), REPEATS)
        plain_ms, ref = cuda_time(lambda: traj.plain(4, actor), 1, warm_up=False)
        labels = ("obs", "act", "cact", "rew", "last_obs") if c else ("obs", "act", "rew",
                                                                      "last_obs")
        report_actions(f"K5 ({name}, moves)", got[1], ref[1])
        if c:
            report_actions(f"K5 ({name}, comm)", got[2], ref[2])
        steps = POLICY_GATE["n_steps"]
        err = check(f"K5 ({name}, {N_ENVS} envs x {steps} steps, horizon "
                    f"{POLICY_GATE['horizon']}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms)",
                    {k: max_err(x, y) for k, x, y in zip(labels, got, ref)})
        k5[name] = (err, ms, plain_ms,
                    policy_bounds(name, N_ENVS, steps, POLICY_GATE["horizon"])[0])
        del got, ref
        if name == "simple_spread":
            continue
        run = fused_policy_rollout(name, actor, N_ENVS, EVAL_GATE_STEPS, horizon=EVAL_HORIZON,
                                   block_envs=BLOCK_ENVS)
        ms, got = cuda_time(lambda: run(6, actor), REPEATS)
        plain_ms, ref = cuda_time(lambda: run.plain(6, actor), 1, warm_up=False)
        err = check(f"K4 ({name}, {N_ENVS} envs x {EVAL_GATE_STEPS} steps; kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.1f} ms)",
                    {k: max_err(x, y) for k, x, y in zip(("ret", "pos", "episodes"), got, ref)})
        k4[name] = (err, ms, plain_ms,
                    policy_bounds(name, N_ENVS, EVAL_GATE_STEPS, EVAL_HORIZON)[1])
    return k5, k4


def ptxas_registers(logs: dict) -> dict:
    """{mangled kernel name: [registers, spill store bytes]} from the
    compiler's -Xptxas -v report; the spills are the largest of the kernel's
    and of the functions it calls (a __noinline__ sampler has its own
    frame)."""
    import re

    out, current = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
                out[current] = [None, 0]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and current is not None:
                out[current][1] = max(out[current][1], int(m.group(1)))
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                out[current][0] = int(m.group(1))
    return out


def registers_of(regs: dict, kernel: str, name: str) -> list:
    """[registers, spill bytes] of each entry of ``kernel`` instantiated for
    scenario ``name`` (K4, K5, K8: its struct, KernelX's XScn in
    csrc/scenario_blocks.cuh; K6, K7: its actor head <OW, 5, C>, K7 then
    its critic <A * OW, 0, 0>; K9: its four kernels on MaddpgDims<A, OW,
    C>, in the compiler's order), or []; K1 and K2 (``det_rollout_kernel``,
    ``scenario_rollout_kernel``): {group G: [registers, spill bytes]} of
    their <XScn, G> instantiations."""
    import re

    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    if kernel in ("scenario_rollout_kernel", "det_rollout_kernel"):   # {group: [regs, spills]}
        key = type(kernel_scenario(name)).__name__.removeprefix("Kernel") + "ScnELi"
        return {int(re.search(key + r"(\d+)E", k).group(1)): v for k, v in regs.items()
                if kernel in k and key in k}
    if kernel == "maddpg_update":
        a, ow, c, _, _ = widths(name)
        key = f"MaddpgDimsILi{a}ELi{ow}ELi{c}EE"
        return [v for k, v in regs.items() if key in k]
    if kernel in ("ppo", "mappo"):
        a, ow, c, _, _ = widths(name)
        flags = {"ppo": "ELb1ELb0E", "mappo": "ELb0ELb1E"}[kernel]
        keys = [f"ppo_update_kernelILi{ow}ELi5ELi{c}{flags}"]
        if kernel == "mappo":
            keys.append(f"ppo_update_kernelILi{a * ow}ELi0ELi0ELb1ELb0E")
        return [v for key in keys for k, v in regs.items() if key in k]
    key = type(kernel_scenario(name)).__name__.removeprefix("Kernel") + "ScnE"
    return [v for k, v in regs.items() if kernel in k and key in k]


def replay_rows(obs, act, rew, obs2):
    """K8's tensor form [T, A, X, N] / [T, R, N] -> its rows form [T, N, W]
    (a shared reward, R = 1, broadcast to every agent)."""
    import torch

    a = obs.shape[1]
    rew_a = rew.expand(-1, a, -1) if rew.shape[1] == 1 else rew
    return torch.cat([obs.movedim(-1, 1).flatten(2), act.movedim(-1, 1).flatten(2),
                      rew_a.movedim(-1, 1), obs2.movedim(-1, 1).flatten(2)], dim=-1)


def checkpoint_params(name: str) -> dict:
    """The actor and trained critic of ``name``'s committed MADDPG checkpoint
    on the card."""
    from mpe_tpu_torch.convert import params_from_numpy, read_checkpoint_params

    return params_from_numpy(read_checkpoint_params(MADDPG_CKPTS[name]), device="cuda")


def check_det_kernels(det_inputs) -> tuple[dict, dict]:
    """K1 on the nine scenarios against its plain version over CHECK_STEPS
    at N_ENVS (simple_spread on path a's inputs, the others on
    make_det_inputs with another seed than path e's), and on DET_GROUPED at
    every group G against G = 1, bit for bit; the plain version of the eight
    others timed at N_ENVS x K1_PLAIN_STEPS -> ({scenario: max abs err},
    {scenario: plain ms})."""
    from mpe_tpu_torch.ops.fused_parity import (det_rollout_cuda, fused_det_rollout,
                                                make_det_inputs, plain_det_rollout_blocked)
    from mpe_tpu_torch.ops.fused_rollout import GROUPS
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    k1_err, plain_ms = {}, {}
    for name in ALL_SCENARIOS:
        inputs = det_inputs if name == "simple_spread" else make_det_inputs(name, N_ENVS, seed=1)
        got = fused_det_rollout(name, N_ENVS, CHECK_STEPS, block_envs=BLOCK_ENVS)(*inputs)
        ref = plain_det_rollout_blocked(name, CHECK_STEPS, BLOCK_ENVS)(*inputs)
        k1_err[name] = check(f"K1 ({name}, {N_ENVS} envs x {CHECK_STEPS} steps)",
                             {k: max_err(a, b) for k, a, b in
                              zip(("pos", "vel", "rew_sum", "rew", "obs"), got, ref)})
        if name in DET_GROUPED:
            kscn = kernel_scenario(name)
            one = det_rollout_cuda(kscn, CHECK_STEPS, BLOCK_ENVS, *inputs, group=1)
            for g in GROUPS[1:]:
                split = det_rollout_cuda(kscn, CHECK_STEPS, BLOCK_ENVS, *inputs, group=g)
                diff = {k: max_err(a, b) for k, a, b in
                        zip(("pos", "vel", "rew_sum", "rew", "obs"), split, one)}
                assert max(diff.values()) == 0.0, f"K1 ({name}) at G = {g} differs from G = 1: {diff}"
            print(f"K1 ({name}) at G = {', '.join(map(str, GROUPS[1:]))}: equal to G = 1 bit for "
                  f"bit over {CHECK_STEPS} steps")
        if name != "simple_spread":
            plain = plain_det_rollout_blocked(name, K1_PLAIN_STEPS, BLOCK_ENVS)
            plain_ms[name], _ = cuda_time(lambda: plain(*inputs), 1, warm_up=False)
            print(f"K1 plain version, {name}: {plain_ms[name]:.1f} ms at {N_ENVS} envs x "
                  f"{K1_PLAIN_STEPS} steps")
    return k1_err, plain_ms


def check_maddpg_collect(name: str, actors: dict):
    """K8 on ``name`` against its plain version at the MADDPG paths' shape
    (1024 envs x 25 steps, horizon 25, eps 0.1, two block offsets) with each
    actor of ``actors`` ({label: actor}), both output forms; the eps coins'
    share; then K8 in the rows form and its plain version timed with the
    first actor -> (max abs err, ms, plain ms, bound, the rows of the first
    actor at block offset 0)."""
    import torch

    from mpe_tpu_torch.learner.maddpg import collect_t_chunk
    from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory
    from mpe_tpu_torch.ops.fused_rollout import make_uniform

    n, hor = MADDPG["n_envs"], MADDPG["horizon"]
    t_chunk = collect_t_chunk(hor)
    a, _, k, width, nw, _ = maddpg_widths(name)
    heads = 2 if k > 5 else 1
    first = next(iter(actors.values()))
    kw = dict(horizon=hor, eps_greedy=0.1, block_envs=BLOCK_ENVS, t_chunk=t_chunk)
    tens = fused_maddpg_trajectory(name, first, n, hor, **kw)
    rows = fused_maddpg_trajectory(name, first, n, hor, emit_rows=True, **kw)
    errs, coins = {}, []
    for label, actor in actors.items():
        for offset in (0, 1):
            got, ref = tens(3, actor, offset), tens.plain(3, actor, offset)
            report_actions(f"K8 ({name}, {label} actor, block offset {offset})", got[1], ref[1])
            for key, x, y in zip(("obs", "act", "rew", "obs2"), got, ref):
                errs[key] = max(errs.get(key, 0.0), max_err(x, y))
            errs["rows"] = max(errs.get("rows", 0.0),
                               max_err(rows(3, actor, offset), replay_rows(*got)))
            for chunk in range(hor // t_chunk):
                u = make_uniform(3, offset, n // BLOCK_ENVS, BLOCK_ENVS, chunk, device="cuda")
                coins += [float((u((1,), step, 30 + 6 * i + 3 * h) < 0.1).double().mean())
                          for step in range(t_chunk) for i in range(a) for h in range(heads)]
    share = sum(coins) / len(coins)
    print(f"K8 ({name}) eps coin: binds for {share:.4f} of the draws (eps 0.1, {heads} "
          f"head(s) per agent)")
    assert 0.08 < share < 0.12, share
    err = check(f"K8 ({name}, {n} envs x {hor} steps, {len(actors)} actor(s), two block "
                "offsets, both forms)", errs)
    ms, _ = cuda_time(lambda: rows(1, first), REPEATS)
    plain_ms, _ = cuda_time(lambda: rows.plain(1, first), 1)
    bound = bound_ms(OPS[f"maddpg_traj_kernel[{name}]"], n * hor, n * 2, n,
                     4 * (n * hor * width + a * nw))
    print(f"K8 ({name}) {ms:.4f} ms ({n} envs x {hor} steps, rows form), plain {plain_ms:.1f} "
          f"ms; bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue floor "
          f"{bound[2]:.4f} ms")
    return err, ms, plain_ms, bound, rows(3, first).reshape(n * hor, width)


def check_maddpg_update(name: str, params: dict, rows_all, label: str):
    """K9 on ``name`` against its plain version on MADDPG["batch"] rows drawn
    from ``rows_all``, with ``params`` and targets = params + 0.1 N(0, 1):
    target actions per head equal (the smallest gap between a head's best
    and second target logit printed), each gradient leaf within GRAD_TOL of
    its largest entry, the metrics within METRIC_RTOL; then K9, its plain
    version and autograd of the losses timed -> (max abs err, ms, plain ms,
    library ms, bound, ms from trees): ms is the trainer's call, K9's
    launcher on the packed weight buffer."""
    import torch

    from mpe_tpu_torch.learner.maddpg import maddpg_xla_grads
    from mpe_tpu_torch.ops.fused_maddpg_update import (MaddpgUpdateLauncher, _split_rows,
                                                       fused_maddpg_update, maddpg_update_cuda,
                                                       target_indices, target_logits)

    a, ow, k, width, nw, nc = maddpg_widths(name)
    b, cw = MADDPG["batch"], k - 5
    gen = torch.Generator("cuda").manual_seed(5)
    rows = rows_all[torch.randint(0, rows_all.shape[0], (b,), generator=gen,
                                  device="cuda")].contiguous()
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda")
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    grads_fn = fused_maddpg_update(a, ow, k, 5, 64, b)
    act2 = torch.empty((a, 2 if cw else 1, b), dtype=torch.int32, device="cuda")
    got, got_m = maddpg_update_cuda(params, targets, rows, mw=5, gamma=0.95, ent_coef=0.01,
                                    target_actions=act2)
    ref, ref_m = grads_fn.plain.from_rows(params, targets, rows)
    errs, worst = {}, 0.0
    for n in ref:
        for q in ref[n]:
            for w in ref[n][q]:
                e = max_err(got[n][q][w], ref[n][q][w])
                errs[f"{n}.{q}.{w}"] = e / float(ref[n][q][w].abs().max())
                worst = max(worst, e)
    logits = target_logits(targets["actor"], rows[:, a * (ow + k + 1):].reshape(b, a, ow))
    agree = float((act2.long() == target_indices(logits, 5).permute(1, 2, 0)).double().mean())
    gaps = []
    for lo, hi in ((0, 5), (5, k)) if cw else ((0, 5),):
        top2 = logits[..., lo:hi].topk(2, dim=-1).values
        gaps.append(float((top2[..., 0] - top2[..., 1]).min()))
    print(f"K9 ({name}, {label}) target actions equal to plain per head: {agree:.6f}; smallest "
          f"gap between a head's best and second target logit " + ", ".join(f"{g:.3g}" for g in
                                                                           gaps))
    names = ("critic_loss", "actor_loss", "q_mean")
    print(f"K9 ({name}, {label}) max abs err vs plain over each leaf's largest entry: "
          + ", ".join(f"{k_} {v:.3g}" for k_, v in errs.items()) + "; metrics kernel vs plain: "
          + ", ".join(f"{k_} {float(x):.8g} vs {float(y):.8g}"
                      for k_, x, y in zip(names, got_m, ref_m)))
    assert agree == 1.0, f"K9 ({name}): the target actions disagree with the plain version's"
    assert max(errs.values()) <= GRAD_TOL, f"K9 ({name}): the gradient disagrees with plain"
    assert all(abs(float(x) - float(y)) <= METRIC_RTOL * abs(float(y))
               for x, y in zip(got_m, ref_m)), f"K9 ({name}): the metrics disagree with plain"

    # the trainer's call: K9's launcher on the packed buffers; from_rows packs
    # the trees on every call
    k9 = MaddpgUpdateLauncher(a, ow, k, 5, 64, b, "cuda", gamma=0.95, ent_coef=0.01)
    lay = k9.layout
    weights = lay.pack(params, targets).cuda()
    flat_grads = torch.empty(lay.off_ta, device="cuda")
    metrics = torch.empty(3, device="cuda")
    ms, _ = cuda_time(lambda: k9.launch(weights, rows, flat_grads, metrics), REPEATS)
    tree_ms, _ = cuda_time(lambda: grads_fn.from_rows(params, targets, rows), REPEATS)
    plain_ms, _ = cuda_time(lambda: grads_fn.plain.from_rows(params, targets, rows), REPEATS)
    split = _split_rows(rows, a, ow, k)
    lib_ms, _ = cuda_time(lambda: maddpg_xla_grads(params, targets, *split, mw=5, cw=cw,
                                                   gamma=0.95, ent_coef=0.01), REPEATS)
    bound = bound_ms(OPS[f"maddpg_update_kernel[{name}]"], b * a, 0, 0,
                     4 * (b * width + 2 * a * (nw + nc) + a * (nw + nc + 3)))
    print(f"K9 ({name}, {label}) {ms:.4f} ms per call on the packed buffers (batch {b}; "
          f"{tree_ms:.4f} ms from trees), plain {plain_ms:.3f} ms, autograd of the losses "
          f"{lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue "
          f"floor {bound[2]:.4f} ms")
    return worst, ms, plain_ms, lib_ms, bound, tree_ms


def check_update_chunk(name: str, run, params, info) -> float:
    """One update chunk (25 updates) of the runner of path d, d2 or d3
    (``name``) with the kernels against the same chunk with the plain
    versions, the same indices -> the largest abs error of a param."""
    import torch

    from mpe_tpu_torch.learner.fused_loop import actor_gates

    buf, b, h = info["buffer"], MADDPG["batch"], MADDPG["horizon"]
    gen = torch.Generator("cuda").manual_seed(6)
    idx = torch.randint(0, buf.size, (h, b), generator=gen, device="cuda")
    gates = actor_gates(MADDPG_CHUNKS, h, MADDPG_ACTOR_START)
    state = (params, info["targets"], info["opt_states"])
    pk, tk, _, mk = run.update_chunk(*state, buf, 0, gates, indices=idx)
    pp, tp, _, mp = run.update_chunk.plain(*state, buf, 0, gates, indices=idx)
    chunk_err = max(max_err(x[n][q][w], y[n][q][w]) for x, y in ((pk, pp), (tk, tp))
                    for n in x for q in x[n] for w in x[n][q])
    check(f"one MADDPG update chunk on {name} ({h} updates, kernels vs plain)",
          {"chunk params": chunk_err})
    print(f"one MADDPG update chunk on {name}, last metrics kernels vs plain: "
          + ", ".join(f"{k} {float(mk[k]):.8g} vs {float(mp[k]):.8g}" for k in mk))
    return chunk_err


def device_us(e) -> float:
    """A profiler event's own device time in microseconds."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def profile_trajectories(k3_ms: dict) -> dict:
    """Each K3 call of path e once more under torch.profiler: the kernel's
    device time beside the call's CUDA-event time from path e, which also
    holds the wrapper's host work before the launch. It gates nothing;
    without device events it says so -> {(scenario, envs): device ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory

    device_ms = {}
    for (name, n), ms in k3_ms.items():
        run = fused_trajectory(name, n, **TRAJ)
        run(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(1)
            torch.cuda.synchronize()
        us = sum(device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "trajectory_kernel" in e.key)
        if us <= 0:
            print(f"K3 under torch.profiler, {name} at {n} envs: device time not measured (no "
                  "device events)")
            continue
        device_ms[name, n] = us / 1e3
        nbytes = traj_bytes(name, n, TRAJ["n_steps"])
        print(f"K3 under torch.profiler, {name} at {n} envs: device time {us / 1e3:.4f} ms "
              f"({nbytes / (us * 1e-6) / 1e12:.4f} TB/s) against {ms:.4f} ms by CUDA events "
              f"around the call")
    return device_ms


def profile_maddpg_update(name: str, run, params, info):
    """One MADDPG update chunk (25 updates) of path d, d2 or d3 (``name``)
    as the runner runs it (``packed_step`` on the packed state) under
    torch.profiler: K9's device time per update (its four kernels), the
    device's busy share of the chunk's CUDA-event time, the kernel launches
    per update and the kernels that take the most device time. It gates
    nothing; without device events it says so. -> {device_ms_per_update,
    device_split_ms, launches_per_update, idle_share}, or {} unmeasured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpe_tpu_torch.learner.fused_loop import actor_gates

    h = MADDPG["horizon"]
    chunk = run.update_chunk
    gates = actor_gates(MADDPG_CHUNKS, h, MADDPG_ACTOR_START)
    state = chunk.pack_state(params, info["targets"], info["opt_states"])
    state, _ = chunk.packed_step(state, info["buffer"], 1, gates)          # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        chunk.packed_step(state, info["buffer"], 2, gates)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        print(f"MADDPG update chunk on {name} under torch.profiler: device time not measured "
              "(no device events)")
        return {}
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    k9_ms = {n: sum(device_us(e) for e in kernels if n in e.key) / 1e3 / h
             for n in ("maddpg_target_actions_kernel", "maddpg_td_kernel", "maddpg_update_kernel",
                       "maddpg_reduce_kernel")}
    per_update = sum(e.count for e in kernels) / h
    print(f"MADDPG update chunk on {name} under torch.profiler ({h} updates of the packed "
          f"state, {wall_ms:.3f} ms by CUDA events): device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.4f} of the time, idle {1 - busy_ms / wall_ms:.4f}); K9 device "
          f"time per update {sum(k9_ms.values()):.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in k9_ms.items())
          + f"); {per_update:.1f} kernel launches per update")
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    print("  most device time: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms in {e.count}" for e in top))
    return {"device_ms_per_update": sum(k9_ms.values()), "device_split_ms": k9_ms,
            "launches_per_update": per_update, "idle_share": 1 - busy_ms / wall_ms}


def template_rows_k2(k2_ms_at, k2_scn_ms, k2_by, k2_err, k2_check_ms, regs) -> dict:
    """K2's bound at each shape it ran (simple_spread from path a at 4096,
    16384 and 65536 envs, the eight others from path e), printed beside its
    time and the group rollout_group chose -> {scenario: the kernels line's
    by_scenario entry at N_ENVS; simple_spread's also holds the wider
    shapes' numbers, suffixed with their env count}."""
    from mpe_tpu_torch.ops.fused_rollout import rollout_group
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    k2_rows = {}
    for name, n, ms in ([("simple_spread", n, ms) for n, ms in k2_ms_at.items()]
                        + [(name, N_ENVS, ms) for name, ms in k2_scn_ms.items()]):
        ops = OPS[f"scenario_rollout_kernel[{name}]"]
        b, by, issue = bound_ms(ops, n * N_STEPS, n * (N_STEPS // HORIZON + 1), n,  # resets, draws
                                rollout_bytes(name, n))
        group = rollout_group(kernel_scenario(name), n)
        print(f"K2 bound, {name} at {n} envs (group {group}): {b:.4f} ms by {by} ({ms / b:.2f}x); "
              f"issue floor {issue:.4f} ms ({ms / issue:.2f}x); {ops['step'].get('sfu', 0)} SFU "
              "operations per env-step")
        if n == N_ENVS:
            k2_rows[name] = {"launches": k2_by[name], "ms": ms, "bound_ms": b, "bound_by": by,
                             "group": group, "max_abs_err": k2_err[name],
                             "check_ms": k2_check_ms[name][0],
                             "check_plain_ms": k2_check_ms[name][1],
                             "registers_spill_bytes": registers_of(
                                 regs, "scenario_rollout_kernel", name)}
        else:
            k2_rows["simple_spread"].update({f"ms_{n}": ms, f"bound_ms_{n}": b,
                                             f"bound_by_{n}": by, f"group_{n}": group})
    return k2_rows


def template_rows_k3(k3_ms, k3_device_ms, k3_by, k3_err, plain_k3_ms) -> dict:
    """K3's bound at each shape of path e, printed beside its time by CUDA
    events and in device time -> {scenario: the kernels line's by_scenario
    entry (the wide shape's numbers suffixed with its env count)}."""
    k3_rows = {}
    for (name, n), ms in k3_ms.items():
        ops = OPS[f"trajectory_kernel[{name}]"]
        b, by, issue = bound_ms(ops, n * TRAJ["n_steps"],
                                n * (TRAJ["n_steps"] // TRAJ["horizon"] + 1), n,  # resets, draws
                                traj_bytes(name, n, TRAJ["n_steps"]))
        dev = k3_device_ms.get((name, n))
        print(f"K3 bound, {name} at {n} envs: {b:.4f} ms by {by} ({ms / b:.2f}x by CUDA events"
              + (f", {dev / b:.2f}x in device time" if dev else "") + f"); issue floor "
              f"{issue:.4f} ms; {ops['step'].get('sfu', 0)} SFU operations per env-step")
        row = k3_rows.setdefault(name, {"launches": k3_by[name], "max_abs_err": k3_err[name],
                                        "plain_ms": plain_k3_ms[name]})
        suffix = "" if n == N_ENVS else f"_{n}"
        row.update({f"ms{suffix}": ms, f"device_ms{suffix}": dev, f"bound_ms{suffix}": b,
                    f"bound_by{suffix}": by})
    return k3_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        import mpe_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mpe_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.convert import params_from_numpy, read_checkpoint_params
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_maddpg import maddpg_traj_cuda
    from mpe_tpu_torch.ops.fused_maddpg_update import maddpg_update_cuda
    from mpe_tpu_torch.ops.fused_parity import (det_group, det_rollout_cuda,
                                                plain_det_rollout_blocked)
    from mpe_tpu_torch.ops.fused_policy import (fused_policy_rollout, fused_policy_trajectory,
                                                policy_rollout_cuda, policy_traj_cuda)
    from mpe_tpu_torch.ops.fused_rollout import rollout_cuda
    from mpe_tpu_torch.ops.fused_trajectory import trajectory_cuda
    from mpe_tpu_torch.ops.fused_update import mappo_update_cuda, ppo_update_cuda
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    add_policy_ops()
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off (plain versions)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t_start = t0 = time.perf_counter()
    logs = _build.build_all()
    for source in _build.SOURCES:
        _build.library(source)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}")
    regs = ptxas_registers(logs)

    spec = scenarios.load("simple_spread").spec
    kscn = kernel_scenario("simple_spread")
    wrappers = {"scenario_rollout_kernel": rollout_cuda,
                "trajectory_kernel": trajectory_cuda,
                "det_rollout_kernel": det_rollout_cuda,
                "policy_traj_kernel": policy_traj_cuda,
                "policy_rollout_kernel": policy_rollout_cuda,
                "ppo_update_kernel": ppo_update_cuda,
                "mappo_update_kernel": mappo_update_cuda,
                "maddpg_traj_kernel": maddpg_traj_cuda,
                "maddpg_update_kernel": maddpg_update_cuda}

    # ---- main paths ----------------------------------------------------------
    launches, k2_by, k1_by, k2, k2_ms_at, k1_ms, det_inputs = rollout_path(
        wrappers, spec, torch.device("cuda"))
    # K5 runs in paths b, b2, b3 and b4; K6 in b and b3; K7 in b2 and b4. Each
    # path's launches are read just after it, by instantiation where the
    # kernel is a template over the scenarios
    k5_by, k6_by, k7_by = {}, {}, {}
    trainers = {}
    for label, name, build, update in (("train", "simple_spread", build_fused_ppo_step, "ppo"),
                                       ("MAPPO", "simple_spread", build_fused_mappo_step, "mappo"),
                                       ("comm PPO", COMM_PPO, build_fused_ppo_step, "ppo"),
                                       ("comm MAPPO", COMM_MAPPO, build_fused_mappo_step, "mappo")):
        path_launches, step_, state0_, state_ = training_path(
            wrappers, kernel_scenario(name), build, f"{label} ({name})",
            ["policy_traj_kernel", f"{update}_update_kernel"])
        by = read_instantiations(policy_traj_cuda, [name], f"{label} path's K5")
        k5_by[name] = k5_by.get(name, 0) + by[name]
        kb = k6_by if update == "ppo" else k7_by
        kb[name] = kb.get(name, 0) + path_launches[f"{update}_update_kernel"]
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v
        trainers[label] = (step_, state0_, state_)
    step, state0, state = trainers["train"]
    mstep, mstate0, mstate = trainers["MAPPO"]
    cstep, _, cstate = trainers["comm PPO"]
    lstep, _, lstate = trainers["comm MAPPO"]

    def actor_of(params, torso=("l1", "l2")):
        return {"l1": params[torso[0]], "l2": params[torso[1]], "out": params["pi"]}

    ckpt = read_checkpoint_params(MAPPO_CKPT)
    ckpt_actor = params_from_numpy({"l1": ckpt["a1"], "l2": ckpt["a2"], "out": ckpt["pi"]},
                                   device="cuda")
    evals = {"simple_spread": actor_of(state[0]), COMM_PPO: actor_of(cstate[0]),
             COMM_MAPPO: ckpt_actor}
    eval_launches, k4_by, k4_runs = evaluation_path(wrappers, evals)
    launches.update(eval_launches)
    actor = evals["simple_spread"]
    # MADDPG: path d (simple_spread), then d2 and d3 with comm heads; K8 and K9
    # launches summed over the three paths, by scenario
    maddpg_runs, k8_by, k9_by = {}, {}, {}
    for name, n_chunks in (("simple_spread", MADDPG_CHUNKS),) + MADDPG_COMM:
        path_launches, by, *maddpg_runs[name] = maddpg_path(wrappers, name, n_chunks)
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v
        k8_by.update(by["maddpg_traj_kernel"])
        k9_by.update(by["maddpg_update_kernel"])
    run, mparams, minfo, _ = maddpg_runs["simple_spread"]
    scn_launches, scn_by, k1_scn_ms, k2_scn_ms, k3_ms = scenarios_path(wrappers,
                                                                       torch.device("cuda"))
    # K1 and K2 ran in path a (simple_spread) and path e (the eight others)
    launches["det_rollout_kernel"] += scn_launches["det_rollout_kernel"]
    launches["scenario_rollout_kernel"] += scn_launches["scenario_rollout_kernel"]
    launches["trajectory_kernel"] = scn_launches["trajectory_kernel"]
    k1_by.update(scn_by["det_rollout_kernel"])
    k2_by.update(scn_by["scenario_rollout_kernel"])
    k3_by = scn_by["trajectory_kernel"]
    zero_launches(wrappers)

    # ---- kernels against their plain versions -------------------------------
    k1_err, plain_k1_scn_ms = check_det_kernels(det_inputs)

    k5s = fused_policy_trajectory(kscn, actor, N_ENVS, POLICY_CHECK_STEPS,
                                  horizon=POLICY_CHECK_HORIZON, block_envs=BLOCK_ENVS,
                                  t_chunk=TRAIN["t_chunk"])
    k4s = fused_policy_rollout(kscn, actor, N_ENVS, POLICY_CHECK_STEPS,
                               horizon=POLICY_CHECK_HORIZON, block_envs=BLOCK_ENVS)
    errs5, errs4 = {}, {}
    for offset in (0, 1):
        got, ref = k5s(5, actor, offset), k5s.plain(5, actor, offset)
        report_actions(f"K5 (block offset {offset})", got[1], ref[1])
        for k, a, b in zip(("obs", "act", "rew", "last_obs"), got, ref):
            errs5[k] = max(errs5.get(k, 0.0), max_err(a, b))
        got, ref = k4s(5, actor, offset), k4s.plain(5, actor, offset)
        for k, a, b in zip(("ret", "pos", "episodes"), got, ref):
            errs4[k] = max(errs4.get(k, 0.0), max_err(a, b))
    k5_err = check(f"K5 ({POLICY_CHECK_STEPS} steps, two block offsets)", errs5)
    k4_err = check(f"K4 ({POLICY_CHECK_STEPS} steps, two block offsets)", errs4)

    for label, stp, st0 in (("trainer", step, state0), ("MAPPO", mstep, mstate0)):
        (p_kernel, _), m_kernel = stp(st0, 7)
        (p_plain, _), m_plain = stp.plain(st0, 7)
        it_err = max(max_err(p_kernel[k][q], p_plain[k][q]) for k in p_kernel for q in p_kernel[k])
        check(f"one {label} iteration (kernels vs plain)", {"params": it_err})
        print(f"one {label} iteration, metrics kernels vs plain: "
              + ", ".join(f"{k} {float(m_kernel[k]):.8g} vs {float(m_plain[k]):.8g}"
                          for k in m_plain))
        assert all(abs(float(m_kernel[k]) - float(m_plain[k]))
                   <= METRIC_RTOL * abs(float(m_plain[k])) for k in m_plain), \
            f"the {label} metrics disagree with the plain trainer's"

    # K6 and K7 on every scenario (epoch 0: the ratio is 1 and the value clip
    # idle, so the pg mean is 0 up to rounding and is not gated there; then
    # with both clips binding), the main paths' trainers where they ran
    k6_rows = check_update_kernels("ppo", {"simple_spread": (step, state[0]),
                                           COMM_PPO: (cstep, cstate[0])})
    k7_rows = check_update_kernels("mappo", {"simple_spread": (mstep, mstate[0]),
                                             COMM_MAPPO: (lstep, lstate[0])})
    # K5 and K4 on every scenario, the main paths' actors where they ran
    trainer_actors = {"simple_spread": actor, COMM_PPO: evals[COMM_PPO],
                      COMM_MAPPO: actor_of(lstate[0], ("a1", "a2"))}
    k5_rows, k4_rows = check_policy_kernels(trainer_actors)

    # ---- the main paths' shapes: K4 on every actor path c evaluated, K5 with
    # every trainer's actor at the training shape; checked and timed there
    k4_main, k5_main = check_main_policy_shapes(k4_runs, evals, trainer_actors)
    k4_ms, plain_k4_ms = k4_main["simple_spread"][1:3]
    k5_ms, plain_k5_ms = k5_main["simple_spread"][1:3]
    # the 10,000-step plain loops run once: one call is tens of seconds
    plain_k2_ms, _ = cuda_time(lambda: k2.plain(1), 1, warm_up=False)
    plain_k1 = plain_det_rollout_blocked("simple_spread", N_STEPS, BLOCK_ENVS)
    plain_k1_ms, _ = cuda_time(lambda: plain_k1(*det_inputs), 1, warm_up=False)
    print(f"kernels at the main paths' shapes: K5 {k5_ms:.4f} ms ({TRAIN['n_envs']} envs x "
          f"{TRAIN['n_steps']} steps), K4 {k4_ms:.4f} ms; medians of {REPEATS}")
    print(f"plain versions on the card: K2 {plain_k2_ms:.1f} ms, K1 {plain_k1_ms:.1f} ms "
          f"({N_ENVS} envs x {N_STEPS} steps); K5 {plain_k5_ms:.1f} ms, K4 {plain_k4_ms:.1f} ms")

    # ---- the MADDPG kernels (K8, K9) and the scenario kernels (K2, K3) ------
    # K8 and K9 on every scenario with its committed checkpoint (K8 also with
    # the trained actor of path d, d2 or d3 where one ran; K9 on rows K8
    # collected with the checkpoint's actor); K9 also on path d's ring with
    # its params (the top-level numbers); one update chunk of each MADDPG path
    def scenario_row(by, kernel, name, err, ms, plain_ms, bound, **extra):
        return {"launches": by.get(name, 0), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "registers_spill_bytes": registers_of(regs, kernel, name), **extra}

    k8_rows, k9_rows = {}, {}
    for name in ALL_SCENARIOS:
        ckpt = checkpoint_params(name)
        actors = {"checkpoint": ckpt["actor"]}
        if name in maddpg_runs:
            actors["trained"] = maddpg_runs[name][1]["actor"]
        err, ms, plain_ms, bound, rows8 = check_maddpg_collect(name, actors)
        k8_rows[name] = scenario_row(k8_by, "maddpg_traj_kernel", name, err, ms, plain_ms, bound)
        err, ms, plain_ms, lib_ms, bound, tree_ms = check_maddpg_update(name, ckpt, rows8,
                                                                        "checkpoint")
        k9_rows[name] = scenario_row(k9_by, "maddpg_update", name, err, ms, plain_ms, bound,
                                     library_ms=lib_ms, from_trees_ms=tree_ms)
        del rows8
    ring = minfo["buffer"]
    k9_err, k9_ms, plain_k9_ms, lib_k9_ms, b9, k9_tree_ms = check_maddpg_update(
        "simple_spread", mparams, ring.data[:ring.size], "path d's ring and params")
    k9_err = max([k9_err] + [r["max_abs_err"] for r in k9_rows.values()])
    chunk_err = {name: check_update_chunk(name, *r[:3]) for name, r in maddpg_runs.items()}
    for name, r in maddpg_runs.items():
        k9_rows[name].update(profile_maddpg_update(name, *r[:3]))
    k3_device_ms = profile_trajectories(k3_ms)
    k2_err, k2_check_ms, plain_k2_long_ms, k3_err, plain_k3_ms = check_scenario_kernels()

    # ---- bounds ---------------------------------------------------------------
    # bytes: K2 writes pos and vel (2 E P floats), the R reward sums and the
    # obs sum per env (rollout_bytes); K3 its trajectory (traj_bytes); K1 reads
    # its inputs and writes pos, vel, rew_sum, rew and obs (det_bytes); K8 writes
    # its replay rows, K9 reads them (maddpg_widths); K5 writes
    # obs [T,A,OW], act (and cact) [T,A] and rew [T,R] per env and last_obs;
    # K4 writes ret [R], pos [E,2] and episodes per env; K6 and K7 read obs,
    # the one-hots, logp_old, adv, ret and value per sample and write the
    # gradient; every policy and update kernel reads its weights once
    for name, ops in OPS.items():
        print(f"{name}: operations needed per env-step {ops['step']}, per reset {ops['reset']}, "
              f"per env {ops['env']}")
    k2_rows = template_rows_k2(k2_ms_at, k2_scn_ms, k2_by, k2_err, k2_check_ms, regs)
    b2 = (k2_rows["simple_spread"]["bound_ms"], k2_rows["simple_spread"]["bound_by"])
    # K1 by instantiation at N_ENVS x N_STEPS (path a, path e); the plain
    # version of the eight others timed at K1_PLAIN_STEPS
    k1_rows = {}
    for name in ALL_SCENARIOS:
        ms = k1_ms if name == "simple_spread" else k1_scn_ms[name]
        b, by, issue = bound_ms(OPS[f"det_rollout_kernel[{name}]"], N_ENVS * N_STEPS, 0, N_ENVS,
                                det_bytes(name, N_ENVS))
        print(f"K1 bound, {name} at {N_ENVS} envs x {N_STEPS} steps: {b:.4f} ms by {by} "
              f"({ms / b:.2f}x); issue floor {issue:.4f} ms ({ms / issue:.2f}x)")
        k1_rows[name] = scenario_row(
            k1_by, "det_rollout_kernel", name, k1_err[name], ms,
            plain_k1_ms if name == "simple_spread" else plain_k1_scn_ms[name], (b, by),
            plain_steps=N_STEPS if name == "simple_spread" else K1_PLAIN_STEPS,
            group=det_group(kernel_scenario(name), N_ENVS))
    b1 = (k1_rows["simple_spread"]["bound_ms"], k1_rows["simple_spread"]["bound_by"])
    b5, by5, issue5 = k5_main["simple_spread"][3]
    b4, by4, issue4 = k4_main["simple_spread"][3]
    k3_rows = template_rows_k3(k3_ms, k3_device_ms, k3_by, k3_err, plain_k3_ms)
    b3 = (k3_rows["simple_spread"]["bound_ms"], k3_rows["simple_spread"]["bound_by"])
    print(f"plain versions on the card: K2 on {K2_LONG} ({N_ENVS} envs x {N_STEPS} steps) "
          f"{plain_k2_long_ms:.1f} ms; K3 at {N_ENVS} envs x {TRAJ['n_steps']} steps "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_k3_ms.items()))
    for label, ms, (b, by, issue) in (("K5", k5_ms, (b5, by5, issue5)),
                                      ("K4", k4_ms, (b4, by4, issue4))):
        print(f"{label} bound, simple_spread at the main path's shape: {b:.4f} ms by {by} "
              f"({ms / b:.2f}x); issue floor {issue:.4f} ms ({ms / issue:.2f}x)")

    # K4-K7 by instantiation: the gates' shapes (K4 on simple_spread at path
    # c's), the main paths' launches, the registers of each instantiation
    def policy_row(name, kernel, err, ms, plain_ms, bound, launches_by, **extra):
        return {"launches": launches_by.get(name, 0), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "registers_spill_bytes": registers_of(regs, kernel, name), **extra}

    def main_shape(err, ms, plain_ms, bound):
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    # K5 rows at the gate's shape, with the training shape's numbers beside
    # them where a trainer ran (its error folded into the row's); K4 rows at
    # 4096 x 200, simple_spread's at path c's shape, with path c's numbers
    # beside them where path c evaluated an actor
    k5_scn = {n: policy_row(n, "policy_traj_kernel", *k5_rows[n], k5_by) for n in ALL_SCENARIOS}
    k4_scn = {n: policy_row(n, "policy_rollout_kernel", *k4_rows[n], k4_by) for n in SCENARIOS}
    k4_scn["simple_spread"] = policy_row("simple_spread", "policy_rollout_kernel", k4_err,
                                         *k4_main["simple_spread"][1:], k4_by)
    for rows, main_rows, key in ((k5_scn, k5_main, "training_shape"),
                                 (k4_scn, k4_main, "evaluation_shape")):
        for n, r in main_rows.items():
            rows[n][key] = main_shape(*r)
            rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"], r[0])
    k6_scn = {n: policy_row(n, "ppo", e, ms, pms, b, k6_by, library_ms=lms)
              for n, (e, ms, pms, lms, b) in k6_rows.items()}
    k7_scn = {n: policy_row(n, "mappo", e, ms, pms, b, k7_by, library_ms=lms)
              for n, (e, ms, pms, lms, b) in k7_rows.items()}
    k5_err = max([k5_err] + [r["max_abs_err"] for r in k5_scn.values()])
    k4_err = max(r["max_abs_err"] for r in k4_scn.values())

    def record(name, source, replaces, err, ms, plain_ms, bound, library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": f"mpe_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, **extra}

    pair_physics = {"replaces": "mpe_tpu/ops/mxu_physics.py:152",
                    "source": "mpe_tpu_torch/csrc/scenario_blocks.cuh",
                    "scenarios": ["simple_tag", "simple_world_comm"]}
    spread6, spread7 = k6_scn["simple_spread"], k7_scn["simple_spread"]
    kernels = [
        # K2, one template: its top-level numbers are simple_spread's at 4096
        # envs x 10000 steps (path a); by_scenario holds every instantiation
        # at 4096 envs x 10000 steps, with kernel and plain version also at
        # the check shape (4096 envs x 20 steps)
        record("scenario_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_rollout.py:359",
               max(k2_err.values()), k2_ms_at[N_ENVS], plain_k2_ms, b2,
               scenarios=list(ALL_SCENARIOS), timed_on="simple_spread", by_scenario=k2_rows,
               pair_physics=pair_physics, group=k2_rows["simple_spread"]["group"],
               group_rule=GROUP_RULE),
        # K3's top-level numbers are simple_spread's at 4096 envs x 64 steps
        record("trajectory_kernel", "mpe_trajectory.cu", "mpe_tpu/ops/fused_trajectory.py:40",
               max(k3_err.values()), k3_ms["simple_spread", N_ENVS], plain_k3_ms["simple_spread"],
               b3, scenarios=list(ALL_SCENARIOS), timed_on="simple_spread", by_scenario=k3_rows,
               pair_physics=pair_physics),
        # K1's top-level numbers are simple_spread's at 4096 envs x 10000 steps
        record("det_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_parity.py:99",
               max(k1_err.values()), k1_ms, plain_k1_ms, b1, scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k1_rows, pair_physics=pair_physics,
               group=k1_rows["simple_spread"]["group"], group_rule=DET_GROUP_RULE),
        # K5's top-level numbers are simple_spread's at the training shape
        # (horizon 32); by_scenario at the gate's (horizon 25)
        record("policy_traj_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:245",
               k5_err, k5_ms, plain_k5_ms, (b5, by5), scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k5_scn),
        # K4's top-level numbers are simple_spread's at the evaluation shape
        record("policy_rollout_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:90",
               k4_err, k4_ms, plain_k4_ms, (b4, by4), scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k4_scn),
        # K6 and K7: one epoch of the trainer's batch, simple_spread's at the top
        record("ppo_update_kernel", "mpe_update.cu", "mpe_tpu/ops/fused_update.py:188",
               max(r["max_abs_err"] for r in k6_scn.values()), spread6["ms"],
               spread6["plain_ms"], (spread6["bound_ms"], spread6["bound_by"]),
               spread6["library_ms"], scenarios=list(ALL_SCENARIOS), timed_on="simple_spread",
               by_scenario=k6_scn, tile=UPDATE_TILE),
        record("mappo_update_kernel", "mpe_update.cu", "mpe_tpu/ops/fused_update.py:245",
               max(r["max_abs_err"] for r in k7_scn.values()), spread7["ms"],
               spread7["plain_ms"], (spread7["bound_ms"], spread7["bound_by"]),
               spread7["library_ms"], scenarios=list(ALL_SCENARIOS), timed_on="simple_spread",
               by_scenario=k7_scn, tile=UPDATE_TILE),
        # K8's top-level numbers are simple_spread's with its checkpoint's
        # actor at 1024 envs x 25 steps; K9's on path d's ring with its params;
        # by_scenario holds every instantiation with the scenario's checkpoint
        record("maddpg_traj_kernel", "mpe_maddpg.cu", "mpe_tpu/ops/fused_maddpg.py:105",
               max(r["max_abs_err"] for r in k8_rows.values()), k8_rows["simple_spread"]["ms"],
               k8_rows["simple_spread"]["plain_ms"],
               (k8_rows["simple_spread"]["bound_ms"], k8_rows["simple_spread"]["bound_by"]),
               scenarios=list(ALL_SCENARIOS), timed_on="simple_spread", by_scenario=k8_rows,
               pair_physics=pair_physics),
        record("maddpg_update_kernel", "mpe_maddpg.cu",
               "mpe_tpu/ops/fused_maddpg_update.py:142", k9_err, k9_ms, plain_k9_ms, b9,
               lib_k9_ms, scenarios=list(ALL_SCENARIOS), timed_on="simple_spread",
               by_scenario=k9_rows, update_chunk_max_abs_err=chunk_err,
               transitions_per_s={n: r[3] for n, r in maddpg_runs.items()},
               from_trees_ms=k9_tree_ms, tile=K9_TILE,
               launches_per_update={n: k9_rows[n].get("launches_per_update")
                                    for n in maddpg_runs}),
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, then runs these phases; any
failure ends the run with a non-zero exit code:

  1. environment: card name and power limit, torch and CUDA versions,
     kernel build time and the compiler's register report;
  2. six main paths, each with every kernel's launch count set to 0 just
     before it and read just after it:
       a. rollout: the generic engine (build_rollout over MpeEnv,
          simple_spread, 4096 envs x 200 steps, horizon 100, env-minor);
          the fused engine (kernel K2) at 4096 envs x 10000 steps, horizon
          100, block_envs 1024 (the bench's headline config), and at 16384
          and 65536 envs; the deterministic rollout (kernel K1) on
          make_det_inputs, 4096 envs x 10000 steps; the fused mean reward
          per env-step must agree with the generic engine's within 5
          standard errors;
       b. training: build_fused_ppo_step at tools/train_bench.py's width
          (4096 envs x 64 steps, horizon 32, hidden 64, 4 PPO epochs,
          block_envs 1024, t_chunk 8) for 20 iterations (kernels K5 and K6),
          with per-iteration CUDA-event times by phase and transitions/s over
          iterations 1-19; every metric must be finite;
       b2. MAPPO training: build_fused_mappo_step at the same width for 20
          iterations (kernels K5 and K7), timed and checked the same way;
       c. evaluation: fused_policy_rollout of the trained actor (kernel K4),
          4096 envs x 1000 steps, horizon 25; mean return per episode;
       d. MADDPG: build_fused_maddpg_runner("simple_spread", n_envs=1024,
          horizon=25, batch=1024) (tools/train_bench.py's fused_maddpg row)
          with the runner's defaults (tau 0.01, lr 1e-3, ent 0.01, eps 0.1,
          a ring of 1,638,400 rows), actor_start 250, 40 chunks = 1000
          updates (kernels K8 and K9), CUDA-event times split into collect
          and update, transitions/s over chunks 1-39, critic loss and mean
          reward of the first and last chunk, which must be finite;
       e. the other scenarios and trajectories: the fused engine (K2) on
          simple, simple_reference and simple_speaker_listener at 4096 envs x
          10000 steps, horizon 100, each mean reward per env-step within 5
          standard errors of the generic engine's (4096 envs x 200 steps);
          fused_trajectory (kernel K3) on those three and simple_spread at
          4096 envs x 64 steps, horizon 32, block_envs 1024, t_chunk 8 (the
          learner batch of tools/train_bench.py), and on simple_spread and
          simple_reference at 65536 envs x 64 steps: median CUDA-event time of
          3 runs, bytes written and the write bandwidth they reach;
  3. every kernel held against its plain PyTorch version on the card: K1
     and K2 over 20 steps (K2 with horizon 10, so resets happen); K5 and K4
     over 16 steps with horizon 8, two block offsets, and at the main paths'
     shapes; K6 and K7 on a batch of their trainer and on the same batch
     with both clips binding; one whole trainer iteration of each (params
     and metrics) against the same iteration with the plain versions; K8 at
     1024 envs x 25 steps, two block offsets, with the actor of
     checkpoints/maddpg_spread_fused.npz and with the runner's actor, in
     both output forms; K9 on 1024 rows of the runner's ring (with the
     target actions' agreement and their smallest logit gap) and one update
     chunk of 25 updates with the same indices; K2 on the three other
     scenarios as on simple_spread, and on simple_reference at path e's 4096
     envs x 10000 steps (the obs sums within 1e-4 of the largest); K3 on
     each of the four scenarios at 512 envs x 24 steps (horizon 10, t_chunk
     4, block_envs 256, two block offsets, so that chunk salts and resets
     both occur), at path e's 4096 envs x 64 steps and, on simple_spread and
     simple_reference, at path e's 65536 envs x 64 steps, actions equal and
     the rest within 1e-5 (at path e's shapes with another seed than path
     e's, so that no stale output can pass);
  4. the plain versions timed at the main paths' shapes, each kernel's bound
     from the operations its function needs (OPS below), and for K6, K7 and
     K9 the same gradient by autograd (the library yardstick); one MADDPG
     update chunk under torch.profiler (K9's device time, the device's busy
     share), and each K3 call of path e (its device time);
  5. a ``{"kernels": [...]}`` line (K2 is two rows, spread_rollout_kernel
     and scenario_rollout_kernel; each K2 and K3 row names its scenarios
     and the one it was timed on), the ``nvidia-smi`` name/power-limit
     line, and ``{"ok":
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
# MADDPG (tools/train_bench.py:123-126, the runner's defaults otherwise)
MADDPG = dict(n_envs=1024, horizon=25, batch=1024)
MADDPG_CHUNKS, MADDPG_ACTOR_START = 40, 250
MADDPG_CKPT = "checkpoints/maddpg_spread_fused.npz"
# the other scenarios (K2) and the trajectories (K3): the learner batch of
# tools/train_bench.py and tools/tpu_smoke.py's t_chunk; the gate's shape
SCENARIOS = ("simple", "simple_reference", "simple_speaker_listener")
K2_TIMED = "simple_reference"           # the scenario_rollout_kernel row's numbers
TRAJ = dict(n_steps=64, horizon=32, block_envs=1024, t_chunk=8)
TRAJ_WIDE = ("simple_spread", "simple_reference")
TRAJ_CHECK = dict(n_envs=512, n_steps=24, horizon=10, block_envs=256, t_chunk=4)

# Kernel against plain version on the card, 20 steps. The library is built
# with -fmad=false, so the dynamics round op for op as PyTorch's
# elementwise ops do; what is left is the order of the obs-checksum sum
# (over a whole rollout: relative to the largest sum).
TOL = {"pos": 1e-5, "vel": 1e-5, "rew_sum": 1e-4, "rew": 1e-5, "obs": 1e-5, "obs_sum": 1e-3,
       "ret": 1e-5, "last_obs": 1e-5, "act": 0.0, "episodes": 0.0, "params": 1e-5,
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
    "spread_rollout_kernel": {
        "step": _ops(*SPREAD_STEP, (1, ACCUMULATE), (1, OBS_SUM), (3, {"int": 1})),
        "reset": RESET,
        "env": {},
    },
    # step: + the per-step salt (1 int) and one add per agent (3 int); once per
    # env: the final obs, 30 relative coordinates
    "spread_det_rollout_kernel": {
        "step": _ops(*SPREAD_STEP, (1, ACCUMULATE), (4, {"int": 1})),
        "reset": {},
        "env": {"fp32": 30},
    },
}

# The policy and update kernels (csrc/mpe_policy.cu, csrc/mpe_update.cu; the
# 18-64-64-5 MLP, +1 value output in K6). A dense layer of n_in inputs needs
# per output n_in multiply-adds (the first product takes the bias); tanh is
# 1 - 2 / (exp(2x) + 1): 2 SFU (exp, reciprocal) and 4 fp32 (2x, x log2e,
# + 1, 1 - 2 r as one fma).
TANH = {"fp32": 4, "sfu": 2}


def dense(n_in: int, n_out: int) -> tuple[int, dict]:
    return n_out, {"fp32": n_in}


MLP = (dense(18, 64), (64, TANH), dense(64, 64), (64, TANH))
GUMBEL = {"int": 10, "cvt": 1, "fp32": 6, "sfu": 2}  # the hash (10 int, cvt, x 2^-24); + 1e-12,
#                                                      log, its x ln2 fused with + 1e-12; log,
#                                                      its x ln2 fused with the logit's -;
#                                                      argmax: compare, select
POLICY_AGENT = _ops((1, {"fp32": 10}), *MLP, dense(64, 5), (5, GUMBEL), (5, {"int": 1}))
#                    obs: 10 relative coordinates; one-hot move: 5 compares
POLICY_STEP = ((3, POLICY_AGENT), (3, DECODE), (3, PAIR_FORCE), (3, INTEGRATE), (9, LANDMARK_DIST),
               (3, PAIR_COLLISION), (1, REWARD_REST), (3, {"int": 1}))   # salt, counter, test
# K6 per sample, besides the forward (MLP, dense(64, 6)): softmax of the 5
# logits (4 max; 5 x (-, x log2e, exp); 4 sums; log, its x ln2 fused into the
# 5 ls = (z - m) - lse; 1 reciprocal and 5 products), the entropy and logp
# sums (5 + 5), the ratio (-, x log2e, exp), clamp (2), s1, s2, the
# indicator, -(a r) / B and select (3), g3 of the logits (5 x 5), the value
# clip, both squares, the indicator and the value gradient (13), the metric
# terms (5): 94 fp32, 8 SFU. Backward: 64 x (6 multiply-adds, 1 - h^2 as
# one fma, the product) for gh2, 64 x 64 multiply-adds + 64 x 2 for gh1.
# Weight gradients: 64 x 18 + 64 x 64 + 6 x 64 multiply-adds, 64 + 64 + 6
# bias sums.
UPDATE_SAMPLE = _ops(*MLP, dense(64, 6), (1, {"fp32": 94, "sfu": 8}),
                     (1, {"fp32": 64 * 8 + 64 * 64 + 64 * 2}),
                     (1, {"fp32": 64 * 18 + 64 * 64 + 6 * 64 + 134}))
OPS["spread_policy_traj_kernel"] = {"step": _ops(*POLICY_STEP), "reset": RESET,
                                    "env": {"fp32": 30}}             # last_obs
OPS["spread_policy_rollout_kernel"] = {"step": _ops(*POLICY_STEP, (1, ACCUMULATE)),  # return
                                       "reset": _ops((1, RESET), (1, {"fp32": 1})),   # episodes
                                       "env": {}}
OPS["ppo_update_kernel"] = {"step": UPDATE_SAMPLE, "reset": {}, "env": {}}   # a "step" is a sample

# K7 (csrc/mpe_update.cu): an actor sample is K6's without the value output:
# the MLP, dense(64, 5), the softmax and surrogate gradient (K6's 94 fp32 and
# 8 SFU less the value clip's 13 fp32), the backward pass (64 x (5
# multiply-adds, 1 - h^2, the product) for gh2, 64 x 64 + 64 x 2 for gh1) and
# the weight gradients (64 x 18 + 64 x 64 + 5 x 64 multiply-adds, 133 bias
# sums). A critic sample: the 54-64-64-1 MLP, the value clip (13), the
# backward pass (64 x 3 for gh2, 64 x 64 + 64 x 2) and the weight gradients
# (64 x 54 + 64 x 64 + 64 multiply-adds, 129 bias sums).
MAPPO_ACTOR_SAMPLE = _ops(*MLP, dense(64, 5), (1, {"fp32": 81, "sfu": 8}),
                          (1, {"fp32": 64 * 7 + 64 * 64 + 64 * 2}),
                          (1, {"fp32": 64 * 18 + 64 * 64 + 5 * 64 + 133}))
MAPPO_CRITIC_SAMPLE = _ops(dense(54, 64), (64, TANH), dense(64, 64), (64, TANH), dense(64, 1),
                           (1, {"fp32": 13}), (1, {"fp32": 64 * 3 + 64 * 64 + 64 * 2}),
                           (1, {"fp32": 64 * 54 + 64 * 64 + 64 + 129}))
# a "step" is an actor sample (t, agent, env), a "reset" a critic sample (t, env)
OPS["mappo_update_kernel"] = {"step": MAPPO_ACTOR_SAMPLE, "reset": MAPPO_CRITIC_SAMPLE, "env": {}}

# K8 (csrc/mpe_maddpg.cu) per env-step: per agent K5's MLP and Gumbel-max,
# the eps one-hot's Gumbel-max (5 more draws), the eps coin (a hash, compare,
# select) and 3 salts; the spread step; the obs2 rows (30 relative
# coordinates).
MADDPG_AGENT = _ops((1, POLICY_AGENT), (5, GUMBEL), (1, {"int": 13, "cvt": 1, "fp32": 3}))
MADDPG_STEP = ((3, MADDPG_AGENT), (3, DECODE), (3, PAIR_FORCE), (3, INTEGRATE), (9, LANDMARK_DIST),
               (3, PAIR_COLLISION), (1, REWARD_REST), (3, {"int": 1}), (1, {"fp32": 30}))
OPS["spread_maddpg_traj_kernel"] = {"step": _ops(*MADDPG_STEP), "reset": RESET, "env": {}}

# K9 per sample, for each of the 3 agents: the target actor and its
# first-argmax (4 compares, 4 selects); the target critic (69-64-64-1) and y
# (1 fma); the critic forward with the candidates' base (64 x (5 fma + 1)); 5
# candidates (64 adds, layers 2-3); d, g3 and the backward pass (64 x 3,
# 64 x 64 + 64 x 2); the critic's weight gradients (64 x 69 + 64 x 64 + 64
# multiply-adds, 129 bias sums); the actor forward; the entropy softmax,
# expected Q and logit gradient (88 fp32, 16 SFU: 5 exp, 1 + 5 reciprocals,
# 5 logs); the actor backward and weight gradients as in K7.
MADDPG_AGENT_UPDATE = _ops(
    *MLP, dense(64, 5), (1, {"fp32": 8}),
    dense(69, 64), (64, TANH), dense(64, 64), (64, TANH), dense(64, 1), (1, {"fp32": 1}),
    dense(69, 64), (64, {"fp32": 6}), (64, TANH), dense(64, 64), (64, TANH), dense(64, 1),
    (5 * 64, {"fp32": 1}), (5 * 64, TANH), (5, _ops(dense(64, 64), (64, TANH), dense(64, 1))),
    (1, {"fp32": 2 + 64 * 3 + 64 * 64 + 64 * 2}), (1, {"fp32": 64 * 69 + 64 * 64 + 64 + 129}),
    *MLP, dense(64, 5), (1, {"fp32": 88, "sfu": 16}),
    (1, {"fp32": 64 * 7 + 64 * 64 + 64 * 2}), (1, {"fp32": 64 * 18 + 64 * 64 + 5 * 64 + 133}))
OPS["maddpg_update_kernel"] = {"step": _ops((3, MADDPG_AGENT_UPDATE)), "reset": {}, "env": {}}

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
OPS.update({f"scenario_rollout_kernel[{k}]": {**v, "env": {}} for k, v in K2_SCN_OPS.items()})


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


def read_launches(wrappers: dict, path: list[str], label: str) -> dict:
    launches = {name: wrappers[name].launches for name in path}
    print(f"{label} launches: {launches}")
    assert all(n > 0 for n in launches.values()), f"a kernel of the {label} was never launched"
    return launches


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
    HORIZON) on ``name`` at N_ENVS x GENERIC_STEPS, timed: (mean reward per
    env-step, its SE over envs)."""
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
    g_mean, g_se = mean_se(rew[:, 0, :].mean(0))        # the shared reward
    print(f"generic engine, {name}: {N_ENVS * GENERIC_STEPS / generic_s:.6g} env-steps/s "
          f"({N_ENVS} envs x {GENERIC_STEPS} steps in {generic_s * 1e3:.1f} ms); "
          f"mean reward per env-step {g_mean:.5f} +- {g_se:.5f}")
    return g_mean, g_se


def agree_with_generic(label: str, rew_sum, g_mean: float, g_se: float) -> None:
    """The fused engine's mean reward per env-step within 5 SE of the
    generic engine's."""
    f_mean, f_se = mean_se(rew_sum[0] / N_STEPS)
    z = abs(f_mean - g_mean) / math.hypot(f_se, g_se)
    print(f"{label}: mean reward per env-step {f_mean:.5f} +- {f_se:.5f}; fused vs generic "
          f"{z:.2f} standard errors apart")
    assert z < 5, f"{label}: fused and generic engines disagree in mean reward ({z:.2f} SE)"


def rollout_path(wrappers, spec, dev):
    """Main path a: generic engine, K2 at three widths, K1."""
    import torch

    from mpe_tpu_torch.ops.fused_parity import fused_det_rollout, make_det_inputs
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout

    zero_launches(wrappers)
    g_mean, g_se = generic_engine("simple_spread", dev)

    k2 = fused_spread_rollout(spec, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
    k2_ms, out = cuda_time(lambda: k2(1), REPEATS)
    pos, vel, rew_sum, obs_sum = out
    assert pos.shape == (6, 2, N_ENVS) and rew_sum.shape == (1, N_ENVS)
    for x in out:
        assert bool(torch.isfinite(x).all())
    print(f"fused engine (K2): {N_ENVS * N_STEPS / (k2_ms * 1e-3):.6g} env-steps/s "
          f"({N_ENVS} envs x {N_STEPS} steps, kernel {k2_ms:.4f} ms, median of {REPEATS})")
    agree_with_generic("fused engine (K2), simple_spread", rew_sum, g_mean, g_se)

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
    print(f"deterministic rollout (K1): {N_ENVS * N_STEPS / (k1_ms * 1e-3):.6g} env-steps/s "
          f"({N_ENVS} envs x {N_STEPS} steps, kernel {k1_ms:.4f} ms, median of {REPEATS})")
    launches = read_launches(wrappers, ["spread_rollout_kernel", "spread_det_rollout_kernel"],
                             "rollout path")
    return launches, k2, k2_ms_at, k1_ms, det_inputs


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


def maddpg_path(wrappers):
    """Main path d: the fused MADDPG loop (K8 collection, K9 updates) for
    MADDPG_CHUNKS chunks, timed by phase with CUDA events."""
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner

    run = build_fused_maddpg_runner("simple_spread", **MADDPG)
    horizon = MADDPG["horizon"]
    zero_launches(wrappers)
    events = []
    t0 = time.perf_counter()
    params, info = run(MADDPG_CHUNKS * horizon, seed=0, actor_start=MADDPG_ACTOR_START,
                       events=events)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches(wrappers, ["spread_maddpg_traj_kernel", "maddpg_update_kernel"],
                             "MADDPG path")
    chunks = []                 # (collect ms, update ms) per chunk
    for c in range(MADDPG_CHUNKS):
        start, col, upd = events[2 * c][1], events[2 * c + 1][1], events[2 * c + 2][1]
        chunks.append((start.elapsed_time(col), col.elapsed_time(upd)))
    steady = chunks[1:]         # chunk 0 sets up the update's first allocations
    collect_ms, update_ms = (sum(x[q] for x in steady) for q in (0, 1))
    total_ms = collect_ms + update_ms
    n = run.transitions_per_chunk
    mr, cl = info["mean_reward"].double(), info["critic_loss"].double()
    assert bool(torch.isfinite(mr).all()) and bool(torch.isfinite(cl).all()), (mr, cl)
    for net in params.values():
        for layer in net.values():
            assert all(bool(torch.isfinite(x).all()) for x in layer.values())
    print(f"MADDPG, chunks 1-{MADDPG_CHUNKS - 1}: {n * len(steady) / (total_ms * 1e-3):.6g} "
          f"transitions/s ({len(steady)} x {n} transitions, {len(steady) * horizon} updates of "
          f"batch {MADDPG['batch']}, in {total_ms:.3f} ms); mean per chunk "
          f"{total_ms / len(steady):.3f} ms: collect {collect_ms / len(steady):.3f} ms (K8 + "
          f"insert), update {update_ms / len(steady):.3f} ms ({horizon} x gather + K9 + Adam + "
          f"polyak); median chunk {statistics.median(a + b for a, b in steady):.3f} ms; the "
          f"whole run with the warm-up {wall_s:.2f} s (host clock)")
    print(f"MADDPG chunk 0: mean reward {float(mr[0]):.6f}, critic loss {float(cl[0]):.6f}; "
          f"chunk {MADDPG_CHUNKS - 1}: mean reward {float(mr[-1]):.6f}, critic loss "
          f"{float(cl[-1]):.6f}; ring {info['buffer'].size} of {run.capacity} rows "
          f"({info['buffer'].data.numel() * 4 / 1e6:.0f} MB)")
    return launches, run, params, info


def traj_bytes(name: str, n_envs: int, n_steps: int) -> int:
    """Bytes K3 writes on scenario ``name``: obs, act and rew per env-step,
    the final pos and vel."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    spec = kscn.spec
    a = spec.n_agents
    act_w = 2 * spec.dim_p + 1 + (spec.dim_c if kscn.uses_comm else 0)
    per_step = a * kscn.obs_w + a * act_w + kscn.reward_rows
    return 4 * n_envs * (n_steps * per_step + 2 * spec.n_entities * spec.dim_p)


def rollout_bytes(name: str, n_envs: int) -> int:
    """Bytes K2 writes on scenario ``name``: pos and vel, the reward and
    obs sums."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    spec = kscn.spec
    return 4 * n_envs * (2 * spec.n_entities * spec.dim_p + kscn.reward_rows + 1)


def scenarios_path(wrappers, dev):
    """Main path e: K2 on the three other scenarios against the generic
    engine, then K3 on the four scenarios at N_ENVS and on TRAJ_WIDE at
    WIDE_ENVS -> (launches, K2 ms by scenario, {(scenario, envs): K3 ms})."""
    import torch

    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory

    zero_launches(wrappers)
    k2_ms = {}
    for name in SCENARIOS:
        g_mean, g_se = generic_engine(name, dev)
        run = fused_rollout(name, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
        k2_ms[name], out = cuda_time(lambda: run(1), REPEATS)
        for x in out:
            assert bool(torch.isfinite(x).all())
        print(f"fused engine (K2), {name}: {N_ENVS * N_STEPS / (k2_ms[name] * 1e-3):.6g} "
              f"env-steps/s ({N_ENVS} envs x {N_STEPS} steps, kernel {k2_ms[name]:.4f} ms, "
              f"median of {REPEATS})")
        agree_with_generic(f"fused engine (K2), {name}", out[2], g_mean, g_se)

    k3_ms = {}
    for name, n in [(x, N_ENVS) for x in ("simple_spread",) + SCENARIOS] + \
            [(x, WIDE_ENVS) for x in TRAJ_WIDE]:
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
              f"per env-step {float(rew.double().mean()):.5f}")
        del out, obs, act, rew, pos, vel
    launches = read_launches(wrappers, ["scenario_rollout_kernel", "trajectory_kernel"],
                             "scenarios and trajectories path")
    return launches, k2_ms, k3_ms


def check_scenario_kernels():
    """K2 on the three other scenarios and K3 on all four against their
    plain versions: K2 over CHECK_STEPS at N_ENVS with horizon CHECK_HORIZON
    (two block offsets), and on K2_TIMED at path e's N_ENVS x N_STEPS; K3
    at TRAJ_CHECK (two block offsets), at path e's N_ENVS x 64 and, on
    TRAJ_WIDE, at WIDE_ENVS x 64. At path e's shapes the seed is not path
    e's, so no output that path e left in a recycled buffer can pass for the
    kernel's -> (K2 max abs err, plain K2 ms on K2_TIMED at path e's shape,
    K3 max abs err, plain K3 ms at path e's simple_spread shape)."""
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.ops.fused_trajectory import fused_trajectory

    k2_err = 0.0
    for name in SCENARIOS:
        run = fused_rollout(name, N_ENVS, CHECK_STEPS, horizon=CHECK_HORIZON,
                            block_envs=BLOCK_ENVS)
        errs = {}
        for offset in (0, 1):
            got, ref = run(7, offset), run.plain(7, offset)
            for k, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got, ref):
                errs[k] = max(errs.get(k, 0.0), max_err(a, b))
        k2_err = max(k2_err, check(f"K2 ({name})", errs))
    # the whole rollout: the obs sums, summed in another order each step,
    # drift apart over N_STEPS, so they are held relative to their largest
    run = fused_rollout(K2_TIMED, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
    plain_k2_ms, ref = cuda_time(lambda: run.plain(5), 1, warm_up=False)
    got = run(5)
    errs = {k: max_err(a, b) for k, a, b in zip(("pos", "vel", "rew_sum"), got, ref)}
    k2_err = max(k2_err, *errs.values())
    errs["obs_sum_rel"] = max_err(got[3], ref[3]) / float(ref[3].abs().max())
    check(f"K2 ({K2_TIMED}, {N_ENVS} envs x {N_STEPS} steps)", errs)

    k3_err, plain_k3_ms = 0.0, None
    for name in ("simple_spread",) + SCENARIOS:
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
            if (name, n) == ("simple_spread", N_ENVS):
                plain_k3_ms, ref = cuda_time(lambda: full.plain(5), 1)
            else:
                ref = full.plain(5)
            report_actions(f"K3 ({name}, {n} envs x {TRAJ['n_steps']} steps)", got[1], ref[1])
            for k, a, b in zip(("obs", "act", "rew", "pos", "vel"), got, ref):
                errs[k] = max(errs[k], max_err(a, b))
            del got, ref
        k3_err = max(k3_err, check(f"K3 ({name}; {TRAJ_CHECK['n_envs']} envs x "
                                   f"{TRAJ_CHECK['n_steps']} steps, two block offsets, and "
                                   + " and ".join(f"{n} x {TRAJ['n_steps']}" for n in widths)
                                   + ")", errs))
    return k2_err, plain_k2_ms, k3_err, plain_k3_ms


def evaluation_path(wrappers, kscn, params):
    """Main path c: the trained actor evaluated by K4."""
    import torch

    from mpe_tpu_torch.ops.fused_policy import fused_policy_rollout

    actor = {"l1": params["l1"], "l2": params["l2"], "out": params["pi"]}
    zero_launches(wrappers)
    k4 = fused_policy_rollout(kscn, actor, N_ENVS, EVAL_STEPS, horizon=EVAL_HORIZON,
                              block_envs=BLOCK_ENVS)
    k4_ms, (ret, pos, eps) = cuda_time(lambda: k4(0, actor), REPEATS)
    for x in (ret, pos, eps):
        assert bool(torch.isfinite(x).all())
    assert bool((eps == EVAL_STEPS // EVAL_HORIZON).all())
    per_ep_mean, per_ep_se = mean_se(ret[0] / eps[0])
    print(f"evaluation (K4): mean return per episode {per_ep_mean:.5f} +- {per_ep_se:.5f} over "
          f"{int(eps.sum())} episodes ({N_ENVS} envs x {EVAL_STEPS} steps, horizon "
          f"{EVAL_HORIZON}); kernel {k4_ms:.4f} ms, median of {REPEATS}")
    launches = read_launches(wrappers, ["spread_policy_rollout_kernel"], "evaluation path")
    return launches, k4, actor, k4_ms, (ret, pos, eps)


def check_mappo(mstep, mstate0, mstate):
    """K7 against its plain version on the MAPPO trainer's batch, on the same
    batch with both clips binding, and over one whole iteration; then K7, its
    plain version and autograd of the trainer's loss timed on the trainer's
    batch -> (max abs err, ms, plain ms, library ms, bound)."""
    import torch

    from mpe_tpu_torch.ops.fused_update import clip_binding_inputs

    params = mstate[0]
    obs, mv_oh, logp_old, value, adv_n, ret = mstep.collect(params, 3)
    batch = (obs, mv_oh, None, logp_old, adv_n, ret, value)
    lpo_c, v_c, shares = clip_binding_inputs(logp_old, value, clip=TRAIN["clip"],
                                             generator=torch.Generator("cuda").manual_seed(11))
    print(f"K7 clip-binding batch: the ratio clip binds for {shares[0]:.4f} of the actor samples, "
          f"the value clip for {shares[1]:.4f} of the critic samples")
    assert all(0.2 < s < 0.8 for s in shares), f"the clips bind for too few or too many: {shares}"
    err = max(check_update("K7 (trainer batch)", mstep.update, params, batch, ("vloss", "entropy")),
              check_update("K7 (clip-binding batch)", mstep.update, params,
                           (obs, mv_oh, None, lpo_c, adv_n, ret, v_c), ("pg", "vloss", "entropy")))
    (p_kernel, _), m_kernel = mstep(mstate0, 7)
    (p_plain, _), m_plain = mstep.plain(mstate0, 7)
    it_err = max(max_err(p_kernel[k][q], p_plain[k][q]) for k in p_kernel for q in p_kernel[k])
    check("one MAPPO iteration (kernels vs plain)", {"params": it_err})
    print("one MAPPO iteration, metrics kernels vs plain: "
          + ", ".join(f"{k} {float(m_kernel[k]):.8g} vs {float(m_plain[k]):.8g}" for k in m_plain))
    assert all(abs(float(m_kernel[k]) - float(m_plain[k])) <= METRIC_RTOL * abs(float(m_plain[k]))
               for k in m_plain), "the MAPPO metrics disagree with the plain trainer's"
    ms, _ = cuda_time(lambda: mstep.update(params, *batch), REPEATS)
    plain_ms, _ = cuda_time(lambda: mstep.update.plain(params, *batch), REPEATS)
    lib_ms, _ = cuda_time(lambda: library_ppo_grads(mstep, params, (obs, mv_oh, logp_old, value,
                                                                     adv_n, ret)), REPEATS)
    t, a, _, n = obs.shape
    bound = bound_ms(OPS["mappo_update_kernel"], t * a * n, t * n, 0,
                     t * a * n * (18 + 5 + 1) * 4 + t * n * 3 * 4 + 2 * (5701 + 7745) * 4)
    print(f"K7 {ms:.4f} ms (one epoch, {t * a * n} actor and {t * n} critic samples), plain "
          f"{plain_ms:.3f} ms, autograd of the trainer's loss {lib_ms:.3f} ms; bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue floor {bound[2]:.4f} ms")
    return err, ms, plain_ms, lib_ms, bound


def replay_rows(obs, act, rew, obs2):
    """K8's tensor form [T, A, X, N] / [T, 1, N] -> its rows form [T, N, W]."""
    import torch

    a = obs.shape[1]
    return torch.cat([obs.movedim(-1, 1).flatten(2), act.movedim(-1, 1).flatten(2),
                      rew.expand(-1, a, -1).movedim(-1, 1), obs2.movedim(-1, 1).flatten(2)],
                     dim=-1)


def check_maddpg_collect(run, actor):
    """K8 against its plain version at the runner's shape (1024 envs x 25
    steps, two block offsets) with the checkpoint's actor and the runner's,
    both output forms; then K8 and its plain version timed -> (max abs err,
    ms, plain ms, bound)."""
    import torch

    from mpe_tpu_torch.convert import params_from_numpy, read_checkpoint_params
    from mpe_tpu_torch.ops.fused_maddpg import fused_maddpg_trajectory
    from mpe_tpu_torch.ops.fused_rollout import make_uniform

    n, hor = MADDPG["n_envs"], MADDPG["horizon"]
    traj = run.collect.traj                                  # the runner's rows form
    t_chunk = traj.t_chunk
    ckpt = params_from_numpy(read_checkpoint_params(MADDPG_CKPT), device="cuda")
    tens = fused_maddpg_trajectory("simple_spread", actor, n, hor, horizon=hor, eps_greedy=0.1,
                                   block_envs=BLOCK_ENVS, t_chunk=t_chunk)
    errs, coins = {}, []
    for label, a_params in (("checkpoint", ckpt["actor"]), ("runner", actor)):
        for offset in (0, 1):
            got, ref = tens(3, a_params, offset), tens.plain(3, a_params, offset)
            report_actions(f"K8 ({label} actor, block offset {offset})", got[1], ref[1])
            for k, a, b in zip(("obs", "act", "rew", "obs2"), got, ref):
                errs[k] = max(errs.get(k, 0.0), max_err(a, b))
            errs["rows"] = max(errs.get("rows", 0.0),
                               max_err(traj(3, a_params, offset), replay_rows(*got)))
            for chunk in range(hor // t_chunk):
                u = make_uniform(3, offset, n // BLOCK_ENVS, BLOCK_ENVS, chunk, device="cuda")
                coins += [float((u((1,), step, 30 + 6 * i) < 0.1).double().mean())
                          for step in range(t_chunk) for i in range(3)]
    share = sum(coins) / len(coins)
    print(f"K8 eps coin: binds for {share:.4f} of the draws (eps 0.1)")
    assert 0.08 < share < 0.12, share
    err = check(f"K8 ({n} envs x {hor} steps, two actors, two block offsets, both forms)", errs)
    ms, _ = cuda_time(lambda: traj(1, actor), REPEATS)
    plain_ms, _ = cuda_time(lambda: traj.plain(1, actor), 1)
    bound = bound_ms(OPS["spread_maddpg_traj_kernel"], n * hor, n * 2, n,
                     n * hor * 126 * 4 + 3 * 5701 * 4)
    print(f"K8 {ms:.4f} ms ({n} envs x {hor} steps, rows form), plain {plain_ms:.1f} ms; bound "
          f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue floor {bound[2]:.4f} ms")
    return err, ms, plain_ms, bound


def check_maddpg_update(run, params, info):
    """K9 against its plain version on 1024 rows of the runner's ring, with
    the runner's params and targets = params + 0.1 N(0, 1), then one update
    chunk of 25 updates with the same indices (kernels vs plain); then K9,
    its plain version and autograd of the losses timed -> (max abs err, ms,
    plain ms, library ms, bound)."""
    import torch

    from mpe_tpu_torch.learner.fused_loop import actor_gates
    from mpe_tpu_torch.learner.maddpg import maddpg_xla_grads
    from mpe_tpu_torch.ops.fused_maddpg_update import maddpg_update_cuda, target_logits

    buf, b = info["buffer"], MADDPG["batch"]
    gen = torch.Generator("cuda").manual_seed(5)
    rows = buf.data[torch.randint(0, buf.size, (b,), generator=gen, device="cuda")].contiguous()
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda")
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    grads_fn = run.update_chunk.grads_fn
    act2 = torch.empty((3, b), dtype=torch.int32, device="cuda")
    got, got_m = maddpg_update_cuda(params, targets, rows, gamma=0.95, ent_coef=0.01,
                                    target_actions=act2)
    ref, ref_m = grads_fn.plain.from_rows(params, targets, rows)
    errs, worst = {}, 0.0
    for n in ref:
        for q in ref[n]:
            for w in ref[n][q]:
                e = max_err(got[n][q][w], ref[n][q][w])
                errs[f"{n}.{q}.{w}"] = e / float(ref[n][q][w].abs().max())
                worst = max(worst, e)
    logits = target_logits(targets["actor"], rows[:, -54:].reshape(b, 3, 18))
    top2 = logits.topk(2, dim=-1).values
    agree = float((act2.long() == logits.argmax(-1).T).double().mean())
    print(f"K9 target actions equal to plain: {agree:.6f}; smallest gap between the best and "
          f"the second target logit {float((top2[..., 0] - top2[..., 1]).min()):.3g}")
    names = ("critic_loss", "actor_loss", "q_mean")
    print("K9 max abs err vs plain over each leaf's largest entry: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + "; metrics kernel vs plain: "
          + ", ".join(f"{k} {float(x):.8g} vs {float(y):.8g}"
                      for k, x, y in zip(names, got_m, ref_m)))
    assert max(errs.values()) <= GRAD_TOL, "K9: the gradient disagrees with its plain version"
    assert all(abs(float(x) - float(y)) <= METRIC_RTOL * abs(float(y))
               for x, y in zip(got_m, ref_m)), "K9: the metrics disagree with their plain version"

    h = MADDPG["horizon"]
    idx = torch.randint(0, buf.size, (h, b), generator=gen, device="cuda")
    gates = actor_gates(MADDPG_CHUNKS, h, MADDPG_ACTOR_START)
    state = (params, info["targets"], info["opt_states"])
    pk, tk, _, mk = run.update_chunk(*state, buf, 0, gates, indices=idx)
    pp, tp, _, mp = run.update_chunk.plain(*state, buf, 0, gates, indices=idx)
    chunk_err = max(max_err(x[n][q][w], y[n][q][w]) for x, y in ((pk, pp), (tk, tp))
                    for n in x for q in x[n] for w in x[n][q])
    check(f"one MADDPG update chunk ({h} updates, kernels vs plain)", {"chunk params": chunk_err})
    print("one MADDPG update chunk, last metrics kernels vs plain: "
          + ", ".join(f"{k} {float(mk[k]):.8g} vs {float(mp[k]):.8g}" for k in mk))

    ms, _ = cuda_time(lambda: grads_fn.from_rows(params, targets, rows), REPEATS)
    plain_ms, _ = cuda_time(lambda: grads_fn.plain.from_rows(params, targets, rows), REPEATS)
    split = buf._split(rows)
    lib_ms, _ = cuda_time(lambda: maddpg_xla_grads(params, targets, *split, mw=5, cw=0,
                                                   gamma=0.95, ent_coef=0.01), REPEATS)
    bound = bound_ms(OPS["maddpg_update_kernel"], b, 0, 0,
                     b * 126 * 4 + 2 * 3 * (5701 + 8705) * 4 + 3 * 14409 * 4)
    print(f"K9 {ms:.4f} ms (batch {b}), plain {plain_ms:.3f} ms, autograd of the losses "
          f"{lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue "
          f"floor {bound[2]:.4f} ms")
    return worst, ms, plain_ms, lib_ms, bound


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


def profile_maddpg_update(run, params, info):
    """One MADDPG update chunk (25 updates) under torch.profiler: K9's device
    time per update (its three kernels), the device's busy share of the
    chunk's CUDA-event time, and the kernels that take the most device time.
    It reports and gates nothing; without device events it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpe_tpu_torch.learner.fused_loop import actor_gates

    h = MADDPG["horizon"]
    state = (params, info["targets"], info["opt_states"])
    gates = actor_gates(MADDPG_CHUNKS, h, MADDPG_ACTOR_START)
    run.update_chunk(*state, info["buffer"], 1, gates)          # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run.update_chunk(*state, info["buffer"], 2, gates)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        print("MADDPG update chunk under torch.profiler: device time not measured (no device "
              "events)")
        return
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    k9_ms = {n: sum(device_us(e) for e in kernels if n in e.key) / 1e3 / h
             for n in ("maddpg_target_actions_kernel", "maddpg_update_kernel",
                       "maddpg_reduce_kernel")}
    print(f"MADDPG update chunk under torch.profiler ({h} updates, {wall_ms:.3f} ms by CUDA "
          f"events): device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.4f} of the time, idle "
          f"{1 - busy_ms / wall_ms:.4f}); K9 device time per update "
          f"{sum(k9_ms.values()):.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in k9_ms.items())
          + f"); {sum(e.count for e in kernels) / h:.1f} kernel launches per update")
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    print("  most device time: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms in {e.count}" for e in top))


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
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_maddpg import maddpg_traj_cuda
    from mpe_tpu_torch.ops.fused_maddpg_update import maddpg_update_cuda
    from mpe_tpu_torch.ops.fused_parity import (fused_det_rollout, plain_det_rollout_blocked,
                                                spread_det_rollout_cuda)
    from mpe_tpu_torch.ops.fused_policy import (fused_policy_rollout, fused_policy_trajectory,
                                                spread_policy_rollout_cuda,
                                                spread_policy_traj_cuda)
    from mpe_tpu_torch.ops.fused_rollout import (fused_spread_rollout, scenario_rollout_cuda,
                                                 spread_rollout_cuda)
    from mpe_tpu_torch.ops.fused_trajectory import trajectory_cuda
    from mpe_tpu_torch.ops.fused_update import (clip_binding_inputs, mappo_update_cuda,
                                                ppo_update_cuda)
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off (plain versions)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for source in _build.SOURCES:
        _build.library(source)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}")

    spec = scenarios.load("simple_spread").spec
    kscn = kernel_scenario("simple_spread")
    wrappers = {"spread_rollout_kernel": spread_rollout_cuda,
                "scenario_rollout_kernel": scenario_rollout_cuda,
                "trajectory_kernel": trajectory_cuda,
                "spread_det_rollout_kernel": spread_det_rollout_cuda,
                "spread_policy_traj_kernel": spread_policy_traj_cuda,
                "spread_policy_rollout_kernel": spread_policy_rollout_cuda,
                "ppo_update_kernel": ppo_update_cuda,
                "mappo_update_kernel": mappo_update_cuda,
                "spread_maddpg_traj_kernel": maddpg_traj_cuda,
                "maddpg_update_kernel": maddpg_update_cuda}

    # ---- main paths ----------------------------------------------------------
    launches, k2, k2_ms_at, k1_ms, det_inputs = rollout_path(wrappers, spec, torch.device("cuda"))
    train_launches, step, state0, state = training_path(
        wrappers, kscn, build_fused_ppo_step, "train", ["spread_policy_traj_kernel",
                                                        "ppo_update_kernel"])
    launches.update(train_launches)
    mappo_launches, mstep, mstate0, mstate = training_path(
        wrappers, kscn, build_fused_mappo_step, "MAPPO", ["spread_policy_traj_kernel",
                                                          "mappo_update_kernel"])
    launches["mappo_update_kernel"] = mappo_launches["mappo_update_kernel"]   # K5: path b's
    eval_launches, k4, actor, k4_ms, k4_out = evaluation_path(wrappers, kscn, state[0])
    launches.update(eval_launches)
    maddpg_launches, run, mparams, minfo = maddpg_path(wrappers)
    launches.update(maddpg_launches)
    scn_launches, k2_scn_ms, k3_ms = scenarios_path(wrappers, torch.device("cuda"))
    launches.update(scn_launches)
    zero_launches(wrappers)

    # ---- kernels against their plain versions -------------------------------
    k1s = fused_det_rollout("simple_spread", N_ENVS, CHECK_STEPS, block_envs=BLOCK_ENVS)
    plain1 = plain_det_rollout_blocked("simple_spread", CHECK_STEPS, BLOCK_ENVS)
    got, ref = k1s(*det_inputs), plain1(*det_inputs)
    torch.cuda.synchronize()
    k1_err = check("K1", {k: max_err(a, b) for k, a, b in
                          zip(("pos", "vel", "rew_sum", "rew", "obs"), got, ref)})

    k2s = fused_spread_rollout(spec, N_ENVS, CHECK_STEPS, horizon=CHECK_HORIZON,
                               block_envs=BLOCK_ENVS)
    errs = {}
    for offset in (0, 1):
        got, ref = k2s(7, offset), k2s.plain(7, offset)
        torch.cuda.synchronize()
        for k, a, b in zip(("pos", "vel", "rew_sum", "obs_sum"), got, ref):
            errs[k] = max(errs.get(k, 0.0), max_err(a, b))
    k2_err = check("K2", errs)

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

    # K6 on the trainer's batch (epoch 0: the ratio is 1 and the value clip
    # idle, so the pg mean is 0 up to rounding and is not gated there), then
    # on the same batch with logp_old and value moved so that both clips bind
    params = state[0]
    obs, mv_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
    batch = (obs, mv_oh, None, logp_old, adv_n, ret, value)
    lpo_c, v_c, shares = clip_binding_inputs(logp_old, value, clip=TRAIN["clip"],
                                             generator=torch.Generator("cuda").manual_seed(11))
    print(f"K6 clip-binding batch: the ratio clip binds for {shares[0]:.4f} of the samples, "
          f"the value clip for {shares[1]:.4f}")
    assert all(0.2 < s < 0.8 for s in shares), f"the clips bind for too few or too many: {shares}"
    k6_err = max(check_update("K6 (trainer batch)", step.update, params, batch,
                              ("vloss", "entropy")),
                 check_update("K6 (clip-binding batch)", step.update, params,
                              (obs, mv_oh, None, lpo_c, adv_n, ret, v_c),
                              ("pg", "vloss", "entropy")))

    (p_kernel, _), m_kernel = step(state0, 7)
    (p_plain, _), m_plain = step.plain(state0, 7)
    it_err = max(max_err(p_kernel[k][q], p_plain[k][q]) for k in p_kernel for q in p_kernel[k])
    check("one trainer iteration (kernels vs plain)", {"params": it_err})
    print("one trainer iteration, metrics kernels vs plain: "
          + ", ".join(f"{k} {float(m_kernel[k]):.8g} vs {float(m_plain[k]):.8g}" for k in m_plain))
    assert all(abs(float(m_kernel[k]) - float(m_plain[k])) <= METRIC_RTOL * abs(float(m_plain[k]))
               for k in m_plain), "the trainer's metrics disagree with the plain trainer's"

    # ---- timing at the main paths' shapes, K5 and K4 checked there too ------
    traj = fused_policy_trajectory(kscn, actor, TRAIN["n_envs"], TRAIN["n_steps"],
                                   horizon=TRAIN["horizon"], block_envs=TRAIN["block_envs"],
                                   t_chunk=TRAIN["t_chunk"])
    k5_ms, got = cuda_time(lambda: traj(1, actor), REPEATS)
    plain_k5_ms, ref = cuda_time(lambda: traj.plain(1, actor), 1)
    report_actions("K5 at the training shape", got[1], ref[1])
    k5_err = max(k5_err, check("K5 at the training shape",
                               {k: max_err(a, b) for k, a, b in
                                zip(("obs", "act", "rew", "last_obs"), got, ref)}))
    plain_k4_ms, ref = cuda_time(lambda: k4.plain(0, actor), 1)
    print(f"K4 at the evaluation shape: lanes with a return equal to plain "
          f"{float((k4_out[0] == ref[0]).double().mean()):.6f}")
    k4_err = max(k4_err, check("K4 at the evaluation shape",
                               {k: max_err(a, b) for k, a, b in
                                zip(("ret", "pos", "episodes"), k4_out, ref)}))
    k6_ms, _ = cuda_time(lambda: step.update(params, *batch), REPEATS)
    plain_k6_ms, _ = cuda_time(lambda: step.update.plain(params, *batch), REPEATS)
    lib_batch = (obs, mv_oh, logp_old, value, adv_n, ret)
    lib_k6_ms, _ = cuda_time(lambda: library_ppo_grads(step, params, lib_batch), REPEATS)
    # the 10,000-step plain loops run once: one call is tens of seconds
    plain_k2_ms, _ = cuda_time(lambda: k2.plain(1), 1, warm_up=False)
    plain_k1 = plain_det_rollout_blocked("simple_spread", N_STEPS, BLOCK_ENVS)
    plain_k1_ms, _ = cuda_time(lambda: plain_k1(*det_inputs), 1, warm_up=False)
    samples = obs.shape[0] * obs.shape[1] * obs.shape[3]
    print(f"kernels at the main paths' shapes: K5 {k5_ms:.4f} ms ({TRAIN['n_envs']} envs x "
          f"{TRAIN['n_steps']} steps), K6 {k6_ms:.4f} ms (one epoch, {samples} samples), "
          f"K4 {k4_ms:.4f} ms; medians of {REPEATS}")
    print(f"plain versions on the card: K2 {plain_k2_ms:.1f} ms, K1 {plain_k1_ms:.1f} ms "
          f"({N_ENVS} envs x {N_STEPS} steps); K5 {plain_k5_ms:.1f} ms, K6 {plain_k6_ms:.3f} ms, "
          f"K4 {plain_k4_ms:.1f} ms; K6 by autograd of the trainer's loss {lib_k6_ms:.3f} ms")

    # ---- this slice's kernels: K7 (MAPPO), K8 and K9 (MADDPG) ---------------
    k7_err, k7_ms, plain_k7_ms, lib_k7_ms, b7 = check_mappo(mstep, mstate0, mstate)
    k8_err, k8_ms, plain_k8_ms, b8 = check_maddpg_collect(run, mparams["actor"])
    k9_err, k9_ms, plain_k9_ms, lib_k9_ms, b9 = check_maddpg_update(run, mparams, minfo)
    profile_maddpg_update(run, mparams, minfo)
    k3_device_ms = profile_trajectories(k3_ms)
    k2s_err, plain_k2s_ms, k3_err, plain_k3_ms = check_scenario_kernels()

    # ---- bounds ---------------------------------------------------------------
    # bytes: K2 writes pos, vel (2 x 6 x 2 floats), rew_sum and obs_sum per
    # env; K1 reads pos0, vel0 and writes pos, vel, rew_sum, rew and obs [3,18];
    # K5 writes obs [T,3,18], act [T,3] and rew [T,1] per env and last_obs;
    # K4 writes ret, pos [6,2] and episodes per env; K6 reads obs [18], the
    # one-hot move [5], logp_old, adv, ret and value per sample and writes the
    # gradient; the policy kernels read their weights once (5,701 floats, K6
    # 5,766)
    for name, ops in OPS.items():
        print(f"{name}: operations needed per env-step {ops['step']}, per reset {ops['reset']}, "
              f"per env {ops['env']}")
    bounds = {}
    for n in k2_ms_at:
        bounds[n] = bound_ms(OPS["spread_rollout_kernel"], n * N_STEPS,     # resets and
                             n * (N_STEPS // HORIZON + 1), n, 104 * n)      # initial draws
        b, by, issue = bounds[n]
        print(f"K2 bound at {n} envs: {b:.4f} ms by {by} ({k2_ms_at[n] / b:.2f}x); "
              f"issue floor {issue:.4f} ms ({k2_ms_at[n] / issue:.2f}x)")
    b2, by2, _ = bounds[N_ENVS]
    b1, by1, issue1 = bound_ms(OPS["spread_det_rollout_kernel"], N_ENVS * N_STEPS, 0, N_ENVS,
                               (96 + 320) * N_ENVS)
    print(f"K1 bound at {N_ENVS} envs: {b1:.4f} ms by {by1} ({k1_ms / b1:.2f}x); "
          f"issue floor {issue1:.4f} ms ({k1_ms / issue1:.2f}x)")
    ne, ns, nh = TRAIN["n_envs"], TRAIN["n_steps"], TRAIN["horizon"]
    b5, by5, issue5 = bound_ms(OPS["spread_policy_traj_kernel"], ne * ns, ne * (ns // nh + 1), ne,
                               ne * (ns * (3 * 18 + 3 + 1) + 3 * 18) * 4 + 5701 * 4)
    b4, by4, issue4 = bound_ms(OPS["spread_policy_rollout_kernel"], N_ENVS * EVAL_STEPS,
                               N_ENVS * (EVAL_STEPS // EVAL_HORIZON + 1), N_ENVS,
                               N_ENVS * 14 * 4 + 5701 * 4)
    b6, by6, issue6 = bound_ms(OPS["ppo_update_kernel"], samples, 0, 0,
                               samples * 27 * 4 + 2 * 5766 * 4)
    for (name, n), ms in k3_ms.items():
        ops = OPS[f"trajectory_kernel[{name}]"]
        b, by, issue = bound_ms(ops, n * TRAJ["n_steps"],                # resets and
                                n * (TRAJ["n_steps"] // TRAJ["horizon"] + 1), n,  # initial draws
                                traj_bytes(name, n, TRAJ["n_steps"]))
        dev = k3_device_ms.get((name, n))
        print(f"K3 bound, {name} at {n} envs: {b:.4f} ms by {by} ({ms / b:.2f}x by CUDA events"
              + (f", {dev / b:.2f}x in device time" if dev else "") + f"); issue floor "
              f"{issue:.4f} ms")
        if (name, n) == ("simple_spread", N_ENVS):
            b3 = (b, by)
    for name, ms in k2_scn_ms.items():
        b, by, issue = bound_ms(OPS[f"scenario_rollout_kernel[{name}]"], N_ENVS * N_STEPS,
                                N_ENVS * (N_STEPS // HORIZON + 1), N_ENVS,
                                rollout_bytes(name, N_ENVS))
        print(f"K2 bound, {name} at {N_ENVS} envs: {b:.4f} ms by {by} ({ms / b:.2f}x); issue "
              f"floor {issue:.4f} ms ({ms / issue:.2f}x)")
        if name == K2_TIMED:
            b2s = (b, by)
    print(f"plain versions on the card: K2 on {K2_TIMED} ({N_ENVS} envs x {N_STEPS} steps) "
          f"{plain_k2s_ms:.1f} ms; K3 on simple_spread ({N_ENVS} envs x {TRAJ['n_steps']} "
          f"steps) {plain_k3_ms:.1f} ms")
    for label, ms, (b, by, issue) in (("K5", k5_ms, (b5, by5, issue5)),
                                      ("K4", k4_ms, (b4, by4, issue4)),
                                      ("K6", k6_ms, (b6, by6, issue6))):
        print(f"{label} bound: {b:.4f} ms by {by} ({ms / b:.2f}x); issue floor {issue:.4f} ms "
              f"({ms / issue:.2f}x)")

    def record(name, source, replaces, err, ms, plain_ms, bound, library_ms=None, **extra):
        return {"name": name, "route": "cuda", "source": f"mpe_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, **extra}

    kernels = [
        # K2 is two kernels: simple_spread's at 4096 envs x 10000 steps (path
        # a), and the other scenarios' with K2_TIMED's numbers (path e)
        record("spread_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_rollout.py:359",
               k2_err, k2_ms_at[N_ENVS], plain_k2_ms, (b2, by2), scenarios=["simple_spread"]),
        record("scenario_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_rollout.py:359",
               k2s_err, k2_scn_ms[K2_TIMED], plain_k2s_ms, b2s, scenarios=list(SCENARIOS),
               timed_on=K2_TIMED),
        # K3's numbers are simple_spread's at 4096 envs x 64 steps
        record("trajectory_kernel", "mpe_trajectory.cu", "mpe_tpu/ops/fused_trajectory.py:40",
               k3_err, k3_ms["simple_spread", N_ENVS], plain_k3_ms, b3,
               scenarios=["simple_spread", *SCENARIOS], timed_on="simple_spread"),
        record("spread_det_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_parity.py:99",
               k1_err, k1_ms, plain_k1_ms, (b1, by1)),
        record("spread_policy_traj_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:245",
               k5_err, k5_ms, plain_k5_ms, (b5, by5)),
        record("spread_policy_rollout_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:90",
               k4_err, k4_ms, plain_k4_ms, (b4, by4)),
        record("ppo_update_kernel", "mpe_update.cu", "mpe_tpu/ops/fused_update.py:188",
               k6_err, k6_ms, plain_k6_ms, (b6, by6), lib_k6_ms),
        record("mappo_update_kernel", "mpe_update.cu", "mpe_tpu/ops/fused_update.py:245",
               k7_err, k7_ms, plain_k7_ms, b7, lib_k7_ms),
        record("spread_maddpg_traj_kernel", "mpe_maddpg.cu", "mpe_tpu/ops/fused_maddpg.py:105",
               k8_err, k8_ms, plain_k8_ms, b8),
        record("maddpg_update_kernel", "mpe_maddpg.cu",
               "mpe_tpu/ops/fused_maddpg_update.py:142", k9_err, k9_ms, plain_k9_ms, b9,
               lib_k9_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

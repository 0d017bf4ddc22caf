#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, then runs these phases; any
failure ends the run with a non-zero exit code:

  1. environment: card name and power limit, torch and CUDA versions,
     kernel build time (every source at hidden width 64, the MLP sources
     of K4-K9, K6-bf16, K7-bf16 and K9-bf16 also at 8, 16, 32, 128 and 256,
     one nvcc each, all at once; each library's compile seconds are printed
     with the phases' seconds at the end), the compiler's register report and
     the HMMA and LDSM (ldmatrix) instructions that cuobjdump -sass finds in
     each bf16 library, mpe_update_bf16.cu's and mpe_maddpg_bf16.cu's at
     8-256 (each must hold some of both), and the tf32 HMMA in
     mpe_update.cu's at 128 and 256 (K6 and K7 in 3xTF32; each must hold
     some);
  2. sixteen main paths, each with every kernel's launch count set to 0 just
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
       b5. the bf16 compute path (compute_dtype=torch.bfloat16, the JAX
          package's default on a TPU): PPO and MAPPO on simple_spread at path
          b's width, 20 iterations each, timed by phase as b and b2; each
          launches exactly K5 once and K6-bf16 (K7-bf16) 4 times an
          iteration, and no float32 update kernel; the last iteration's mean
          reward and entropy printed beside paths b's and b2's (not gated);
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
       d4. the bf16 MADDPG update: the runner's pieces with its defaults
          (build_fused_collect: K8; build_fused_update_chunk(...,
          compute_dtype=torch.bfloat16): K9-bf16; path d's widths, ring,
          warm-up, actor_start, keys and gates), 40 chunks on simple_spread
          and on simple_speaker_listener, timed by phase as d and d2
          (transitions/s over chunks 1-39 beside theirs); exactly 1000
          K9-bf16 launches and no K9 launch on each, every metric finite,
          the last chunk's critic loss and mean reward beside d's and d2's
          (not gated: a bf16 run is another function);
       e. the other scenarios and trajectories, as tools/tpu_smoke.py runs
          every scenario: the deterministic rollout (K1) on the eight
          scenarios other than simple_spread at 4096 envs x 10000 steps; the
          fused engine (K2) on them (simple, simple_reference,
          simple_speaker_listener, simple_adversary, simple_push,
          simple_crypto, simple_tag and simple_world_comm; the last two
          through the pair physics) at 4096 envs x 10000 steps, horizon
          100, the mean reward per env-step of each reward row within 5
          standard errors of the generic engine's (4096 envs x 200 steps);
          fused_trajectory (kernel K3, trajectory_kernel<S, G> with the G
          threads per env lane that ops/fused_trajectory.py::traj_group
          picks) on all nine at 4096 envs x 64 steps,
          horizon 32, block_envs 1024, t_chunk 8 (the learner batch of
          tools/train_bench.py), and on simple_spread, simple_reference and
          simple_world_comm (the widest writer) at 65536 envs x 64 steps:
          median CUDA-event time of 3 runs, bytes written and the write
          bandwidth they reach; the launches of each instantiation;
       f. the env API and the non-fused learners, on the card by default:
          make_env("simple_spread", benchmark=True, seed=42) for 100 steps
          of numpy reference-format actions (ms per step, a host round trip;
          obs rows of 18, equal rewards, per-agent rew and collisions); every
          registry id made, reset and stepped, and
          MultiagentSimpleSpeakerListener-v0 done at t = 100;
          VecMultiAgentEnv(MpeEnv(simple_spread), 4096) for 200 steps of
          uniform actions (env-steps/s beside path a's generic engine; env
          7 within 1e-6 of MpeEnv.step on its state alone); parallel_env
          ("simple_tag", max_cycles=25), every agent truncated at 25, and
          aec_env("simple_world_comm", max_cycles=25) through agent_iter,
          with samples drawn on the card; REINFORCE (build_train_step,
          4096 envs x 25 steps, hidden 64) for 5 steps; build_ppo_step and
          build_mappo_step on the generic engine at path b's width for 5
          iterations (ms per iteration and transitions/s beside paths b and
          b2); greedy_state_rollout with path d's MADDPG actor and with
          random actions (128 envs x 25 steps); build_es_step on simple at
          hidden 16, pop 16, 4096 envs x 100 steps, horizon 25, for 30
          generations (kernel K4, one launch per member: 480) and one
          generation on simple_spread at hidden 64; every metric finite;
       g. the MADDPG variants at their runners' defaults (64 envs, horizon
          25, batch 1024), 8 chunks each with the actors stepping from update
          0, CUDA-event times per chunk split into collect and update, launch
          counts zeroed before and read after each phase: g1
          build_fused_maddpg_runner("simple_spread", local_critic=True)
          (independent DDPG: K8, autograd updates on the packed state); g2
          build_ensemble_runner("simple_tag", 3) (K8 on sub-sliced actors,
          through the pair physics), then its best-response probe
          (train_mask (F, F, F, T), k_active (3, 3, 3, 1), 4 chunks; the
          frozen actors equal bit for bit, the trained one moved) and K8 on
          g2's first sub-sliced actor stack against the plain K8, every
          output equal bit for bit; g3 build_approx_runner("simple_spread");
          K9 launched in none of g1-g3; g4 build_maddpg on simple_spread
          (32 envs, a ring of 51,200 rows, batch 256; the generic engine, no
          kernel launched): 100 collect steps and 50 updates by the host
          clock; g5 examples/maddpg_run.py's recipe (64 envs, batch 1024,
          tau 0.01, lr 1e-3, actor_start 1000, 24,000 updates; K8 and K9),
          then greedy_state_rollout (128 envs x 25 steps) of the trained
          actor, of uniform-random moves and of the committed JAX
          checkpoint: the trained actor must score above random;
       i. the side layers, after path g and before path h, the counts zeroed
          before and read after each sub-phase: i1 rendering on the card:
          make_env on each of the nine scenarios (shared viewer), 25 steps of
          RandomPolicy actions with render("rgb_array") after the reset and
          each step, every frame (700, 700, 3) uint8 and not blank, the last
          frame equal bit for bit to the one the same state draws on the CPU,
          agent 0 of simple_spread at alpha 0.5 (its centre pixel 0.5 colour +
          0.5 white within 1), ms per frame beside ms per step (host clock);
          simple_adversary with shared_viewer=False, one frame per agent; the
          gymnasium adapter's render; no kernel launched; i2
          InteractivePolicy under a key script stepping simple_spread, and
          python -m mpe_tpu_torch.interactive_cli --scenario simple.py --steps
          5 --headless as a subprocess on the card (exit 0, "t=4 rewards=");
          i3 the examples of mpe_tpu_torch/examples in this process at their
          defaults: rollout (the generic engine, then --fused: K2; M
          env-steps/s beside path a's), evaluate_policy (K4), es_train (K4,
          480 launches), train with each --algo at 10 iterations (fused_ppo
          K5 and K6, fused_mappo K5 and K7, maddpg --fused-collect K8 and K9,
          reinforce, ppo, mappo and maddpg no kernel), maddpg_run --updates
          1000 (K8, K9), render_policy on the committed speaker_listener
          checkpoint (75 frames) and crypto_demo (its codebook equal to the
          one computed with --device cpu); each with exactly its kernels
          launched and finite figures; neither PIL nor matplotlib imported;
       h. the multi-device path (torch.distributed) and checkpoint/trace, run
          last, after phase 3b (it starts a process group and launches ranks;
          the profiler passes of phase 4 run before it), each phase with the
          counts zeroed before and read after: h1 one rank on
          nccl in this process: one data-parallel iteration of
          build_fused_ppo_step(mesh=) at path b's width (K5, K6) and two
          chunks of build_fused_maddpg_dp at path d's row (1024 envs, batch
          1024, the 1,638,400-row ring; K8, K9), each equal bit for bit to the
          non-DP builder on the same inputs, and NCCL's all_reduce of both
          gradients timed; h2 two ranks launched as processes, over the
          backend init_multihost picks (gloo on one card: NCCL refuses two
          ranks on one device, so the times are the mechanism's cost, not
          scale-out), loading the kernels built
          here (the build directory must not change): sharded_fused_rollout
          at path a's 4096 envs x 10000 steps, K5 at path b's width at the
          ranks' block offsets and sharded_fused_maddpg_trajectory at path d's
          row, each gathered equal bit for bit to one process; the DP PPO and
          MAPPO trainers for 5 iterations and DP MADDPG for 8 chunks (each
          rank a half of the envs and of the ring), params equal across the
          ranks and to one-process twins (both halves collected, their
          gradients averaged); per rank the launches by kernel, ms per DP
          step beside one process at the same total width (paths b, b2, d),
          the all_reduce ms of each gradient and the backend; h3 a fused
          MADDPG train state (a ring of 4 chunks) saved mid-run with
          utils.save_train_state, loaded into a fresh template and continued
          for two chunks bit for bit, then utils.trace over one K2 call in a
          step_phase, in a launched rank (a fresh process: in this one the
          earlier profiler passes leave K2 out of the trace): the mpe/ range
          and K2's kernel in the written trace, and K2's device time;
  3. every kernel held against its plain PyTorch version on the card: ES
     generation 0's member scores (K4) against the plain K4's within 1e-5,
     and one ES generation under torch.profiler (K4's device time and the
     device's busy share of the generation); K1
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
     init_policy actor of O(1) logits elsewhere; K4 and K5 at each of these
     shapes also at another tile (env lanes per CTA) than the one
     pick_tile's rule takes, every output equal bit for bit; K6 and K7 on each
     scenario's K5 batch of its trainer at 4096 envs x 64 steps and on the
     same batch with both clips binding (K7's critic compiled for each
     scenario's joint width, simple_world_comm's 204 among them); one whole trainer iteration of each (params and
     metrics) against the same iteration with the plain versions; K6-bf16
     and K7-bf16 on the trainer's batch (path b5's params on simple_spread, a
     fresh bf16 trainer's on simple_reference and simple_speaker_listener) and
     on it with both clips binding, each leaf within 1e-3 of its largest
     entry of the plain bf16 version (BF16_GRAD_TOL), the distance to the
     plain float32 version printed, the epoch-0 max |ratio - 1| each kernel
     sees (one sample at a time from its pg metric, beside the float32
     kernel's), each timed by CUDA events and torch.profiler beside the
     float32 kernel on the same batch, its plain version and autograd of the
     plain bf16 loss; K8 on
     all nine scenarios at 1024 envs x 25 steps, two block offsets, with
     the actor of the scenario's committed checkpoints/maddpg_*.npz (and
     the trained actor of path d, d2 or d3), in both output forms, and at
     another tile than the rule's, equal bit for bit; K9 on
     all nine at batch 1024 on rows K8 collected with the checkpoint's
     actor, with its trained critic, and on 1024 rows of path d's ring
     (target actions equal per head, their smallest logit gap printed);
     K9-bf16 on simple_spread, simple_speaker_listener and
     simple_world_comm at batch 1024 of the main path's ring (d, d2, d3),
     with fresh init_maddpg params and with the path's trained params
     (targets = params + 0.1 N(0, 1)): target actions equal to the plain
     bf16 version's wherever a head's two best logits lie clear of
     target_logit_tolerance (the flips below it counted with their gaps),
     the gradient with the kernel's target actions fed to the plain bf16
     version within BF16_GRAD_TOL of each leaf's largest entry (beside the
     trained batch's actor leaves the bound of actor_flip_model), the metrics
     within BF16_METRIC_RTOL, on the fresh batch at least 10x nearer the
     plain bf16 version than the plain float32 one; timed per call on the
     packed buffers beside K9 on the same buffers, the plain bf16 version
     and autograd of the losses; one
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
     so that no stale output can pass); K3 at every G (1, 2, 4, 8) equal to
     G = 1 bit for bit on all nine at 512 envs x 24 steps and at 4096 envs x
     64 steps, each timed there;
  3b. the hidden widths: at each of 8, 16 and 32, on simple_spread and on
     simple_speaker_listener (a comm head) at 1024 envs x 64 steps (horizon
     25): K5 and K4 (an init_policy actor of that width, O(1) logits) with
     actions equal, values within 1e-5 and another tile equal bit for bit;
     K6 and K7 on the batch of a trainer of that width and on it with both
     clips binding, each leaf within 1e-4 of its largest entry, and K6-bf16
     and K7-bf16 the same way within 1e-3 of the plain bf16 version; K8 at 1024
     envs x 25 steps (eps 0.1) with actions equal, another tile equal bit for
     bit, and K9 on 1024 of its rows (target actions equal, leaves within
     1e-4) and K9-bf16 on 1024 of them as in phase 3; then, launch counts
     zeroed before each and read after, one
     fused PPO iteration on simple_spread at hidden 16 (K5, K6), one MAPPO
     iteration at 32 (K5, K7), each against the same iteration with the
     plain versions (params within 1e-5), and the MADDPG runner on
     simple_spread at hidden 8 for 2 chunks (K8, K9) and one update chunk
     against the plain chunk (within 1e-4); the phase's seconds printed;
  3c. the wide widths, 128 and 256, which every MLP kernel takes: K4-K7,
     K6-bf16 and K7-bf16 at each, on
     simple_spread and simple_world_comm (K7's widest critic) at 1024 envs x
     64 steps, K5 and K4 held as in 3b and K6 and K7 on a trainer's batch
     and with both clips binding, K6-bf16 and K7-bf16 the same way within
     1e-3 of the plain bf16 version; then paths b, b2 and b5 (the bf16
     trainers, no float32 update kernel launched) at TRAIN's shape with that
     width, 5 iterations each, timed by phase, their launches read; K6, K7,
     K6-bf16 and K7-bf16 on the last iteration's batch gated and timed
     beside their plain versions, autograd of the trainer's loss and their
     bound (device time by the profiler), K6 and K7 beside both of theirs,
     3xTF32 on the tensor cores ("tc_tf32") and fp32 on the CUDA cores, and
     failing where one reads faster than its tensor-core bound, the bf16
     kernels also beside the float32 kernel on the same batch; K5 on
     path b's actor at the training shape and K4's evaluation of it at 4096
     envs x 1000 steps (horizon 25, launches read), K5 against its plain
     version there, K4 at 4096 envs x 200 steps; `evaluate_policy` and `es_train` (2 generations) with
     `--hidden` at that width, K4 alone launched; the phase's seconds;
  3d. K8 and K9 at 128 and 256: at each, on simple_spread and
     simple_world_comm (the widest joint, 258) at path d's shape, K8 at
     1024 envs x 25 steps (an init_maddpg actor of that width, O(1) logits,
     eps 0.1) with actions equal to the plain version's and another tile
     equal bit for bit in both forms, K9 on 1024 of its rows (target actions
     equal, each leaf within 1e-4 of its largest entry), each timed beside
     its plain version, K9 also beside autograd of the losses and against
     its bound; then the runner at that width for 12
     chunks (actor_start 0; 11 timed), by phase, its launches read, K9 gated again on
     its ring with the trained params and one update chunk under
     torch.profiler; then K9-bf16 at that width on K8's rows, with fresh
     init_maddpg params and with the runner's trained params, gated as in
     phase 3 (BF16_GRAD_TOL, BF16_METRIC_RTOL, the target actions clear of
     target_logit_tolerance, actor_flip_model's bound printed on the trained
     batch) and timed per call beside K9 on the same packed buffers, the
     plain bf16 version, autograd of the losses and its bound
     (maddpg_update_bf16_sample at the width), and path d4's pieces at that
     width for 12 chunks (actor_start 0), by phase, K9-bf16 launched once an
     update and K9 never, every metric finite; the phase's seconds;
  4. the collect phases of paths b-b4 and d-d3 printed beside K5's and
     K8's times at the same shapes; the plain versions timed at the main
     paths' shapes (K1's of all nine and simple_spread's K2 at 4096 envs x
     200 steps, K1_PLAIN_STEPS: their outputs are compared nowhere),
     each kernel's bound from the
     operations its function needs (OPS below), and for K6, K7 and K9 the
     same gradient by autograd (the library yardstick), K4-K9 on every
     scenario at the gate's shape; K9 as the trainer calls it (its launcher
     on the packed weight buffer) and from trees; one MADDPG update chunk of
     each of paths d, d2, d3 as the runner runs it (packed_step) under
     torch.profiler (K9's device time split by its kernels, four at hidden
     64 and five at 128 and 256 (K9_WIDE_KERNELS), the
     device's busy share, kernel launches per update) and of path d4 (K9-bf16's
     four kernels), and each K3 call of path e (its device time);
  5. a ``{"kernels": [...]}`` line (the K1-K9 rows name their scenarios
     and the one their top-level numbers were timed on, and carry
     per scenario the launches, time, bound, plain time and error of each
     instantiation, K1, K2 (both by group) and K4-K9 also its registers
     and spills, K6, K7 and K9 the library time; K1 and K2 their group and
     the rule that picks it, K6 and K7 their tiling, K9 its tiling and
     launches per update; K4, K5 and K8 their tile, the rule that picks it
     and, K5 and K8, the collect phases of the paths that run them; K3 its
     group rule and by scenario its G, device time, bound, their ratio, the
     times at every G and its registers by G; K4-K9 their errors at the
     hidden widths and their registers at each width, the widths their
     source is compiled for, K4-K7 by wide width the row's own figures
     (launches, time, plain, bound, library, registers, tile; K6 and K7
     their fp32 bound and tf32 HMMA counts too) and the wide
     paths' transitions/s by phase; K8 path g's figures
     by phase, its launches there by scenario and the sub-sliced gate's
     error, K9 its launches in each phase of path g; every row its launches
     in path h by phase and rank and in path i by example, K6, K7 and K9 the DP step's ms and their
     gradient's all_reduce ms there; K6-bf16 and K7-bf16 rows with their
     HMMA and LDSM counts, path b5's phases and last metrics, and by
     scenario the float32 kernel's times and epoch-0 ratio beside theirs; the
     K9-bf16 row with its HMMA and LDSM counts and tolerances, by scenario
     its gates on both batches, K9's time on the same buffers and path d4's
     figures, its four kernels' launches a call among them, and by wide width
     phase 3d's figures), a line of each phase's seconds, each library's
     compile seconds and the build's wall time, the
     ``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device":
     {...}}`` as the last line.

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
import types
from pathlib import Path

import numpy as np

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
# printed beside <SpreadScn>; the plain K1 of all nine and the plain K2 of
# simple_spread are timed over K1_PLAIN_STEPS steps (simple_spread's plain K2
# and K1 took 49 and 32 s at 10,000)
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
               "micro_tile": "4 units x 4 samples at hidden 64 (2 x 4 at 32, 1 x 4 at 16, "
                             "1 x 2 at 8)",
               "weight_grad_micro_tile": "4 x 4 (dW2), 4 x ceil(IN/16) (dW1) at hidden 64",
               "staging": "cp.async, two stages where they fit"}
BF16_TILE = {"threads": 128, "samples_per_tile": 64,
             "ctas_per_sm": "2 where they fit (not the 204-wide critic)",
             "products": "mma.sync m16n8k16 bf16, float32 sums, sample-major: a warp's 16 "
                         "samples the M side of every product, chained in registers forward and "
                         "backward; the weights' B fragments by ldmatrix (.trans backward); "
                         "(16 x 8) gradient tiles dealt to the warps, both operands by "
                         "ldmatrix from bf16 tiles",
             "staging": "cp.async, two stages where they fit; two __syncthreads a tile"}
POLICY_TILE_RULE = ("ops/fused_policy.py::pick_tile (policy_tile for K4 and K5, "
                    "fused_maddpg.py::maddpg_tile for K8): env lanes per 128-thread CTA, the "
                    "smallest tile whose grid runs in one wave (the CTAs an SM holds, as the "
                    "card reports them) and whose (agent, lane) rows fill a warp's items")
K9_TILE = {"samples_per_cta": "1024 / hidden (16 at 64)", "threads": 128,
           "micro_tile": "2 samples x 4 units", "grid": "batch / samples_per_cta x agents",
           "weight_grad_micro_tile": "4 x 4",
           "at_128_and_256": "five kernels: the nets' layer-1 and layer-2 weights transposed "
                             "once a call; the critic's forward (h1, h2, q and the candidates' "
                             "base into scratch) beside the target actions, one tile of 32 "
                             "samples a CTA; the TD targets beside the candidates' Q, every "
                             "(agent, candidate, sample) a column, 16384 / hidden columns a "
                             "CTA, 8 units x 8 columns a thread; the critic's backward beside "
                             "the actor, a partial per CTA; the reduce. Every product streams "
                             "its weights by bulk copies (TMA) through a ring of 2 stages with "
                             "mbarriers, two CTAs an SM",
           "kernels_at_128_and_256": ["maddpg_transpose_wide_kernel",
                                      "maddpg_forward_wide_kernel",
                                      "maddpg_td_cand_wide_kernel",
                                      "maddpg_backward_wide_kernel", "maddpg_reduce_kernel"]}
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
TRAJ_GROUP_RULE = ("ops/fused_trajectory.py::traj_group: G threads per env lane; below 16384 "
                   "envs TRAJ_GROUP's entry of the scenario, from the sweep on the H100 "
                   "(PERF.md), else 1")
# the hidden widths other than 64 that K4-K9 are compiled for, each held on
# HIDDEN_NAMES at a small shape; the trainers of the repo's own dry run
# (__graft_entry__.py: PPO at hidden 16, MADDPG at 8) and MAPPO at 32
HIDDEN_PHASE = (8, 16, 32)
HIDDEN_NAMES = ("simple_spread", "simple_speaker_listener")
HIDDEN_GATE = dict(n_envs=1024, n_steps=64, horizon=25, block_envs=1024, t_chunk=8)
HIDDEN_TRAINERS = (("PPO", 16), ("MAPPO", 32))
HIDDEN_MADDPG, HIDDEN_MADDPG_CHUNKS = 8, 2
# phase 3c: hidden 128 and 256, which K4-K9, K6-bf16 and K7-bf16 take
# (mpe_policy.cu, mpe_update.cu, mpe_maddpg.cu and mpe_update_bf16.cu;
# K9-bf16 refuses them): K4-K7, K6-bf16 and K7-bf16 against their plain
# versions on WIDE_NAMES at HIDDEN_GATE's shape (simple_world_comm: K7's
# widest critic, 204 inputs), then paths b, b2 and b5 at TRAIN's shape with
# each width for WIDE_ITERS iterations, K5 and the update kernels timed on
# their shapes there, and K4's evaluation of path b's actor at path c's shape
WIDE_PHASE = (128, 256)
WIDE_NAMES = ("simple_spread", "simple_world_comm")
WIDE_ITERS = 5
# phase 3d: K8 and K9 (mpe_maddpg.cu) at WIDE_PHASE's widths: the kernels
# against their plain versions at path d's shape on WIDE_MADDPG_NAMES
# (simple_world_comm: the widest joint, 258), then the runner at each width for
# WIDE_MADDPG_CHUNKS chunks (chunk 0 is the warm-up) with actor_start 0: 11
# timed chunks, where 2 let one slow chunk (the host's, at 128) set the rate
WIDE_MADDPG_NAMES = ("simple_spread", "simple_world_comm")
WIDE_MADDPG_CHUNKS = 12
K9_WIDE_KERNELS = tuple(K9_TILE["kernels_at_128_and_256"])
# ... and K9-bf16 (mpe_maddpg_bf16.cu) at the same widths, on the same rows
# and with the float32 runner's trained params, then its update chunk with K8's
# collection for WIDE_MADDPG_CHUNKS chunks, as path d4 runs it at 64
K9_BF16_WIDE_KERNELS = ("maddpg_round_bf16_wide_kernel", "maddpg_target_bf16_wide_kernel",
                        "maddpg_td_bf16_wide_kernel", "maddpg_grad_bf16_wide_kernel",
                        "maddpg_reduce_bf16_kernel")
# the examples that take --hidden, run in phase 3c at each wide width (es_train
# for 2 generations of its 16 members)
WIDE_EXAMPLES = (("evaluate_policy", []), ("es_train", ["--gens", "2"]))
# path b5: the bf16 compute path (compute_dtype=torch.bfloat16, JAX's default
# on a TPU and so tools/train_bench.py's recipe there): PPO and MAPPO on
# simple_spread at TRAIN's width (K5, K6-bf16 / K7-bf16), and the bf16 kernels
# held to their plain bf16 versions on spread and one comm head each
BF16_TRAINERS = (("PPO-bf16", "ppo"), ("MAPPO-bf16", "mappo"))
BF16_NAMES = {"ppo": ("simple_spread", COMM_PPO), "mappo": ("simple_spread", COMM_MAPPO)}
BF16_PROBE_ENVS = 128           # the epoch-0 ratio probe: this many single-env batches
# path d4: the bf16 MADDPG update (compute_dtype=torch.bfloat16) with path d's
# runner pieces and defaults (build_fused_collect: K8; build_fused_update_chunk:
# K9-bf16), 40 chunks on simple_spread and on simple_speaker_listener (a comm
# head, 15 candidates); K9-bf16 held to its plain bf16 version on three
# scenarios (simple_world_comm: the widest joint, 258), each on a batch with
# fresh init_maddpg params and one with the main path's trained params
D4_NAMES = ("simple_spread", "simple_speaker_listener")
K9_BF16_NAMES = ("simple_spread", "simple_speaker_listener", "simple_world_comm")
RUNNER_HP = dict(tau=0.01, lr=1e-3, ent_coef=0.01, eps=0.1)   # the runner's defaults
# K9-bf16's metrics against the plain bf16 version: a flipped bf16 activation
# (BF16_GRAD_TOL's note) moves one sample's Q by up to 2^-8 of a unit's weight;
# measured on the host-built kernel before this gate was set: 3.0e-4 relative
# (tests/test_torch_maddpg_bf16_host.py)
BF16_METRIC_RTOL = 1e-3
K9_BF16_TILE = {"samples_per_cta": 16, "threads": "256 (gradient), 128 (target and TD)",
                "grid": "batch / 16 x agents",
                "products": "mma.sync m16n8k16 bf16, float32 sums, sample-major: a warp's 16 "
                            "samples the M side, chained in registers; the weights by ldmatrix "
                            "(.trans backward); the candidates dealt to warps 1-7; (16 x 8) "
                            "gradient tiles dealt to the warps, operands by ldmatrix.trans",
                "staging": "the weights rounded to bf16 once a call (maddpg_round_bf16_kernel), "
                           "each CTA's nets by 16-byte cp.async",
                "kernels": ["maddpg_round_bf16_kernel", "maddpg_target_td_bf16_kernel",
                            "maddpg_grad_bf16_kernel", "maddpg_reduce_bf16_kernel"],
                "at_128_and_256": "tiles of 64 samples, 8 warps each owning H / 8 units for the "
                                  "tile; the weights rounded once a call into a fragment-packed "
                                  "scratch and streamed through each lane's ring of 4 k16 "
                                  "steps; the gradient on a persistent grid of the CTAs the "
                                  "card holds, shared among the agents, each adding its tiles "
                                  "into its partial; kernels maddpg_round_bf16_wide_kernel, "
                                  "maddpg_target_bf16_wide_kernel, maddpg_td_bf16_wide_kernel, "
                                  "maddpg_grad_bf16_wide_kernel, maddpg_reduce_bf16_kernel"}
# path f: the env API at the verify recipe's calls (make_env on simple_spread
# with benchmark info, VecMultiAgentEnv at 4096 envs), every registry id, the
# PettingZoo adapters at PettingZoo's default max_cycles, and the non-fused
# learners: REINFORCE and PPO/MAPPO at the trainers' widths, greedy evaluation
# at its defaults, ES on K4 at examples/es_train.py's population
F_STEPS, F_VEC = 100, dict(n_envs=4096, n_steps=200)
F_CYCLES = 25
F_PG, F_PG_STEPS = dict(n_envs=4096, n_steps=25, hidden=64), 5
F_PPO_ITERS = 5
F_EVAL = dict(n_envs=128, n_steps=25)
F_ES = dict(n_envs=4096, n_steps=100, horizon=25, pop=16, sigma=0.1, lr=0.1)
F_ES_NAME, F_ES_HIDDEN, F_ES_GENS = "simple", 16, 30
# path g, the MADDPG variants at their runners' defaults (64 envs, horizon 25,
# batch 1024; tools/ddpg_vs_maddpg.py, tools/ensemble_exploit.py --scenario
# simple_tag, tools/approx_study.py), G_CHUNKS chunks each with the actors
# stepping from update 0; g2's best-response probe freezes the adversaries;
# g4 is build_maddpg at the runners' 1,600 rows per env (the JAX default of
# 50,000 rows is no multiple of 32 envs)
G_CHUNKS, G_PROBE_CHUNKS = 8, 4
G_ENSEMBLE, G_K_ENS = "simple_tag", 3
G_PROBE = dict(train_mask=(False, False, False, True), k_active=(3, 3, 3, 1))
G4 = dict(n_envs=32, capacity=51_200, batch=256)
G4_COLLECTS, G4_UPDATES = 100, 50
# g5: does the port's MADDPG learn? examples/maddpg_run.py's recipe (24,000
# updates = 960 chunks) and the JAX package's recorded greedy result there
# (tools/ddpg_vs_maddpg_report.json, mean of three seeds)
G5 = dict(n_envs=64, horizon=25, batch=1024, tau=0.01, lr=1e-3)
G5_UPDATES, G5_ACTOR_START = 24_000, 1000
G5_JAX_GREEDY = -6.138
# path h: the multi-device path (torch.distributed) and checkpoint/resume with
# the profiling hooks. h1 one rank on nccl in this process, DP PPO at path b's
# width (one iteration) and DP MADDPG at path d's row (H1_CHUNKS chunks); h2
# H_RANKS ranks (over gloo where they share one card, nccl where each has its
# own, as init_multihost picks): K2, K5 and K8 sharded at paths a, b
# and d's widths, DP PPO and MAPPO for H_PPO_ITERS iterations, DP MADDPG for
# H2_CHUNKS chunks on path d's 1,638,400-row ring (1024 envs x 25 steps x 64
# chunks) split over the ranks; h3 a train state of a ring of H3_RING_CHUNKS
# chunks saved and resumed, and a trace of one K2 call in a launched rank
H_RANKS, H_PPO_ITERS, H1_CHUNKS, H2_CHUNKS, H3_RING_CHUNKS = 2, 5, 2, 8, 4
H_CAP_CHUNKS = 64
# the RNG block of path h's MADDPG: a rank's share of path d's envs, so that
# the sharded collection draws the single-device run's streams (a rank's
# lanes must fill whole blocks of the single run's size)
H_MADDPG_BLOCK = MADDPG["n_envs"] // H_RANKS
H2_TIMEOUT, H3_TIMEOUT = 300, 120

# path i: the side layers. i1 renders I_STEPS steps of random actions on each
# scenario (shared viewer) and one per-agent-viewer env; i2 the keyboard
# policy under a key script and the interactive CLI as a subprocess; i3 the
# example scripts in this process at their defaults (train at I_TRAIN_ITERS
# iterations, maddpg_run at I_MADDPG_UPDATES updates), each with the kernels
# it must launch and no other (an empty tuple: no kernel at all)
I_STEPS, I_PER_AGENT, I_TRAIN_ITERS, I_MADDPG_UPDATES = 25, "simple_adversary", 10, 1000
I_KEYS = (["left"], ["up"], [], ["right", "down"], ["down"])
I_CLI = ["--scenario", "simple.py", "--steps", "5", "--headless"]
I_CLI_TIMEOUT = 180
I_RENDER_CKPT = "checkpoints/maddpg_speaker_listener.npz"
I_EXAMPLES = (
    ("rollout", "rollout", [], ()),
    ("rollout --fused", "rollout", ["--fused"], ("scenario_rollout_kernel",)),
    ("evaluate_policy", "evaluate_policy", [], ("policy_rollout_kernel",)),
    ("es_train", "es_train", [], ("policy_rollout_kernel",)),
    *((f"train --algo {a}", "train", ["--algo", a, "--iters", str(I_TRAIN_ITERS)], ())
      for a in ("reinforce", "ppo", "mappo", "maddpg")),
    ("train --algo maddpg --fused-collect", "train",
     ["--algo", "maddpg", "--fused-collect", "--iters", str(I_TRAIN_ITERS)],
     ("maddpg_traj_kernel", "maddpg_update_kernel")),
    ("train --algo fused_ppo", "train", ["--algo", "fused_ppo", "--iters", str(I_TRAIN_ITERS)],
     ("policy_traj_kernel", "ppo_update_kernel")),
    ("train --algo fused_mappo", "train",
     ["--algo", "fused_mappo", "--iters", str(I_TRAIN_ITERS)],
     ("policy_traj_kernel", "mappo_update_kernel")),
    (f"maddpg_run --updates {I_MADDPG_UPDATES}", "maddpg_run",
     ["--updates", str(I_MADDPG_UPDATES)], ("maddpg_traj_kernel", "maddpg_update_kernel")),
    ("render_policy", "render_policy", ["--checkpoint", I_RENDER_CKPT], ()),
    ("crypto_demo", "crypto_demo", [], ()),
)
I_ES_LAUNCHES = 30 * 16              # es_train's defaults: 30 generations of 16 members

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
# K6-bf16 and K7-bf16 round each product's operands to bf16 as their plain
# versions do, but an operand whose float32 value the two computed in another
# order (the mma's sums against the plain einsum's) can round a whole bf16 ulp
# (2^-8) the other way; a leaf's largest entry is a sum with much
# cancellation. Measured before this gate was set: 4.5e-4 on the host-built
# kernels (tests/test_torch_bf16_host.py), 4.0e-4 between the plain version
# and JAX's bf16 kernel (tests/test_torch_bf16.py); K9-bf16 (the same rule)
# 2.6e-4 on the host (tests/test_torch_maddpg_bf16_host.py)
BF16_GRAD_TOL = 1e-3

# H100 SXM at its 700 W limit: 3.35 TB/s of HBM; 132 SMs at a 1.98 GHz boost
# clock, each completing per clock 128 fp32 operations, a fused multiply-add
# being one (so 256 flops: the 67 TFLOP/s of the data sheet), 16
# special-function operations (rsqrt, rcp, ex2, lg2), 64 int32 operations and
# 16 int->float conversions (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0).
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
PER_CLOCK = {"fp32": 128, "sfu": 16, "int": 64, "cvt": 16, "tc_bf16": 1892, "tc_tf32": 947}
DISPATCH_PER_CLOCK = 128        # 4 schedulers x one 32-lane instruction each
# tc_bf16: bf16 multiply-adds on the tensor cores, the data sheet's 989 TFLOP/s
# dense over the 132 SMs at the clock above (989e12 / 2 / (132 x 1.98e9)); a
# packed float32 -> bf16 conversion (two values) is one "cvt". tc_tf32: tf32
# multiply-adds, 495 TFLOP/s dense (495e12 / 2 / (132 x 1.98e9)); a float32
# product in 3xTF32 is three of them
TENSOR_CORES = ("tc_bf16", "tc_tf32")


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


def torso(n_in: int, h: int = 64) -> tuple:
    """The two tanh layers of an n_in-h-h MLP."""
    return dense(n_in, h), (h, TANH), dense(h, h), (h, TANH)


GUMBEL = {"int": 10, "cvt": 1, "fp32": 6, "sfu": 2}  # the hash (10 int, cvt, x 2^-24); + 1e-12,
#                                                      log, its x ln2 fused with + 1e-12; log,
#                                                      its x ln2 fused with the logit's -;
#                                                      argmax: compare, select


def update_sample(n_in: int, n_out: int, comm: int, value: bool, h: int = 64) -> dict:
    """K6 (value) or K7's actor pass per sample (csrc/mpe_update.cu), an
    n_in-h-h-n_out MLP (h = 64 below): besides the forward, the softmax of the 5 move
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
    return _ops(*torso(n_in, h), dense(h, n_out), (1, {"fp32": 81 + 13 * value, "sfu": 8}),
                (1 if comm else 0, {"fp32": 14 * comm, "sfu": comm + 2}),
                (1, {"fp32": h * (n_out + 2) + h * h + h * 2}),
                (1, {"fp32": h * n_in + h * h + n_out * h + 2 * h + n_out}))


def update_bf16_sample(n_in: int, n_out: int, comm: int, value: bool, h: int = 64) -> dict:
    """K6-bf16 or K7-bf16's actor pass per sample (csrc/mpe_update_bf16.cu)
    at hidden ``h``: ``update_sample``'s function with every product on the
    tensor cores as bf16 multiply-adds: the forward's h (n_in + h) + n_out h,
    the backward's h n_out + h x h and the weight gradients' h (n_in + h) +
    n_out h; the forward's bias adds (2h + n_out), both tanh layers, the
    head, the backward's 1 - h^2 and products (h x 4) and the bias sums (2h
    + n_out) in fp32; each product's operand rounded once per value (x, h1,
    h2, g3, gh2, gh1: n_in + 4h + n_out values, two a conversion)."""
    return _ops((1, {"tc_bf16": 2 * h * n_in + 3 * h * h + 3 * h * n_out,
                     "fp32": 2 * (2 * h + n_out) + h * 4,
                     "cvt": (n_in + 4 * h + n_out + 1) // 2}),
                (2 * h, TANH), (1, {"fp32": 81 + 13 * value, "sfu": 8}),
                (1 if comm else 0, {"fp32": 14 * comm, "sfu": comm + 2}))


def tf32_products(n_in: int, n_out: int, h: int) -> dict:
    """The products of a wide float32 pass per sample as the 3xTF32 kernel
    (csrc/mpe_update.cu at hidden 128 and 256) computes them: W1 X, W2 H1,
    W2^T GH2, dW2 and dW1 on the tensor cores, each multiply-add three tf32
    ones, each operand value split once a product (two cvt.rna and a
    subtract: x twice, h1 twice, gh2 twice, gh1 once); W3 H2, W3^T G3 and dW3
    in fp32 as ``update_sample`` counts them."""
    return {"tc_tf32": 3 * (2 * h * n_in + 3 * h * h), "cvt": 2 * (2 * n_in + 5 * h),
            "fp32": (2 * n_in + 5 * h) + 3 * h * n_out}


def update_tf32_sample(n_in: int, n_out: int, comm: int, value: bool, h: int) -> dict:
    """``update_sample``'s function with its products as ``tf32_products``:
    the bias adds and both tanh layers, the head, the backward's 1 - h^2 and
    products (h x 4) and the bias sums (2h + n_out) stay fp32."""
    return _ops((1, tf32_products(n_in, n_out, h)), (1, {"fp32": 2 * (2 * h + n_out) + h * 4}),
                (2 * h, TANH), (1, {"fp32": 81 + 13 * value, "sfu": 8}),
                (1 if comm else 0, {"fp32": 14 * comm, "sfu": comm + 2}))


def critic_tf32_sample(n_in: int, h: int) -> dict:
    """K7's critic pass per (t, env) sample in 3xTF32, as
    ``update_tf32_sample`` with one output and the value clip's 13 fp32."""
    return _ops((1, tf32_products(n_in, 1, h)), (1, {"fp32": 2 * (2 * h + 1) + h * 4 + 13}),
                (2 * h, TANH))


def critic_bf16_sample(n_in: int, h: int = 64) -> dict:
    """K7-bf16's critic pass per (t, env) sample at hidden ``h``:
    ``critic_sample``'s function with the products on the tensor cores, as
    ``update_bf16_sample`` with one output and the value clip's 13 fp32."""
    return _ops((1, {"tc_bf16": 2 * h * n_in + 3 * h * h + 3 * h,
                     "fp32": 2 * (2 * h + 1) + h * 4 + 13, "cvt": (n_in + 4 * h + 1 + 1) // 2}),
                (2 * h, TANH))


def critic_sample(n_in: int, h: int = 64) -> dict:
    """K7's critic pass per (t, env) sample: the n_in-h-h-1 MLP (h = 64
    below), the value clip (13), the backward pass (64 x 3 for gh2, 64 x 64
    + 64 x 2) and the weight gradients (64 x n_in + 64 x 64 + 64
    multiply-adds, 129 bias sums)."""
    return _ops(*torso(n_in, h), dense(h, 1), (1, {"fp32": 13}),
                (1, {"fp32": h * 3 + h * h + h * 2}),
                (1, {"fp32": h * n_in + h * h + h + 2 * h + 1}))


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


def policy_ops(name: str, h: int = 64) -> tuple[dict, dict]:
    """(K5's, K4's) operations (csrc/mpe_policy.cu) from K3's step on the
    same scenario, which draws as many uniforms (5 moves per agent, C comm
    logits per speaker): each draw becomes a Gumbel-max draw (GUMBEL in
    place of HASH), every agent runs the MLP OW-h-h-(5+C), the one-hot move
    takes 5 compares per agent; K5 writes the last obs (A OW); K4 adds the
    running return of each reward row and counts episodes."""
    a, ow, c, speakers, r = widths(name)
    draws = 5 * a + c * speakers
    step = _ops((1, TRAJ_OPS[name]["step"]), (-draws, HASH), (draws, GUMBEL),
                (a, _ops(*torso(ow, h), dense(h, 5 + c))), (a, {"int": 5}))
    reset = TRAJ_OPS[name]["reset"]
    return ({"step": step, "reset": reset, "env": {"fp32": a * ow}},
            {"step": _ops((1, step), (r, ACCUMULATE)), "reset": _ops((1, reset), (1, {"fp32": 1})),
             "env": {}})


def maddpg_ops(name: str, h: int = 64) -> dict:
    """K8's operations (csrc/mpe_maddpg.cu::maddpg_traj_kernel<S>) from K3's
    step on the same scenario, which hashes the move columns of every agent
    and the comm of the speakers: K8 instead draws per agent and head a
    Gumbel-max of the logits and one of zeros (2 (5 + C) GUMBEL draws), an
    eps coin per head (a hash, compare, select) with 3 salts, runs the MLP
    OW-h-h-(5+C) (h the hidden width), sets the one-hots (5 + C compares), and
    computes the obs twice (the s' rows: A OW more)."""
    a, ow, c, speakers, _ = widths(name)
    heads = 2 if c else 1
    agent = _ops(*torso(ow, h), dense(h, 5 + c), (2 * (5 + c), GUMBEL),
                 (heads, {"int": 13, "cvt": 1, "fp32": 3}), (5 + c, {"int": 1}))
    step = _ops((1, TRAJ_OPS[name]["step"]), (-(5 * a + c * speakers), HASH), (a, agent),
                (1, {"fp32": a * ow}))
    return {"step": step, "reset": TRAJ_OPS[name]["reset"], "env": {}}


def maddpg_update_ops(name: str, h: int = 64) -> dict:
    """K9's operations per (sample, agent) pair (csrc/mpe_maddpg.cu) at hidden
    width h, a "step" being a sample of one agent: the target actor and its
    first argmax per head (a compare and a select per logit); the target
    critic (J-h-h-1) and y (1 fma); the critic forward with the candidates'
    base (h x (K fma + 1)); each of the 5 max(C, 1) candidates: + base (h),
    tanh, layers 2-3; d, g3 and the backward pass (h x 3, h x h + h x 2); the
    critic's weight gradients (h J + h x h + h multiply-adds, 2 h + 1 bias
    sums); the actor forward; per head the softmax, entropy and logit gradient
    (18 fp32 and 3 SFU per logit: exp, reciprocal, log), and with comm the two
    qbar sums (2 per candidate); the actor backward and weight gradients as
    in K7."""
    a, ow, c, _, _ = widths(name)
    k, n_cand = 5 + c, 5 * max(c, 1)
    j = a * (ow + k)
    critic_tail = _ops(dense(h, h), (h, TANH), dense(h, 1))
    sample = _ops(
        *torso(ow, h), dense(h, k), (1, {"fp32": 2 * k}),
        dense(j, h), (h, TANH), (1, critic_tail), (1, {"fp32": 1}),
        dense(j, h), (h, {"fp32": k + 1}), (h, TANH), (1, critic_tail),
        (n_cand * h, {"fp32": 1}), (n_cand * h, TANH), (n_cand, critic_tail),
        (1, {"fp32": 2 + h * 3 + h * h + h * 2}), (1, {"fp32": h * j + h * h + h + 2 * h + 1}),
        *torso(ow, h), dense(h, k), (k, {"fp32": 18, "sfu": 3}),
        (1 if c else 0, {"fp32": 2 * n_cand}),
        (1, {"fp32": h * (k + 2) + h * h + h * 2}),
        (1, {"fp32": h * ow + h * h + k * h + 2 * h + k}))
    return {"step": sample, "reset": {}, "env": {}}


def maddpg_update_bf16_sample(name: str, h: int = 64) -> dict:
    """K9-bf16's operations per (sample, agent) pair (csrc/mpe_maddpg_bf16.cu)
    at hidden width h: ``maddpg_update_ops``' function with every product on
    the tensor cores as bf16 multiply-adds: the target actor (h (OW + h) + K
    h) and target critic (h (J + h) + h), the critic's forward (the same), its
    backward (h for gh2, h x h for gh1) and weight gradients (h (J + h) + h),
    each candidate's layers 2-3 (h x h + h), the actor's forward, backward (h
    K + h x h) and weight gradients; in fp32: the bias adds (h x 2 + K, 2h + 1
    twice, h + 1 per candidate), the own-action columns of the base (h x K),
    each candidate's h1 argument (h x 2: the column sum and + base), 1 - h^2
    and its product (3 per unit, 4 layers), y, d and g3 (3), the bias sums (2h
    + 1 and 2h + K), the head (18 fp32 and 3 SFU per logit, the comm qbar sums
    2 per candidate) and the first argmax (2 per logit); every tanh (2h for
    each of the four MLPs and per candidate); each product's operand rounded
    once per value (two a conversion). The weights are rounded once per
    launch (``env``, with ``envs`` 1). What a kernel repeats by its own
    design (the wide kernels' second pass of the critic's first layer for the
    candidates' base) is not the function's and is not counted."""
    a, ow, c, _, _ = widths(name)
    k, n_cand = 5 + c, 5 * max(c, 1)
    j = a * (ow + k)
    actor_fwd = h * (ow + h) + k * h
    critic_fwd = h * (j + h) + h
    tc = (2 * actor_fwd + 2 * critic_fwd + (h + h * h) + (h * (j + h) + h)
          + n_cand * (h * h + h) + (h * k + h * h) + actor_fwd)
    fp32 = (2 * (2 * h + k) + 2 * (2 * h + 1) + n_cand * (h + 1) + h * k + n_cand * 2 * h
            + 4 * 3 * h + 3 + (2 * h + 1) + (2 * h + k) + 2 * k + (2 * n_cand if c else 0))
    rounded = ((ow + 2 * h) + (j + 2 * h) + (j + 2 * h) + (1 + h) + (2 * h + j + 2 * h + 1)
               + n_cand * 2 * h + (ow + 2 * h) + (k + h) + (3 * h + ow + h + k) + k)
    weights = 2 * a * ((h * ow + 2 * h + h * h + k * h + k) + (h * j + 3 * h + h * h + 1))
    return {"step": _ops((1, {"tc_bf16": tc, "fp32": fp32, "cvt": (rounded + 1) // 2}),
                         ((8 + 2 * n_cand) * h, TANH), (k, {"fp32": 18, "sfu": 3})),
            "reset": {}, "env": {"cvt": weights // 2}}


def update_ops(kind: str, name: str, h: int = 64, bf16: bool = False,
               tf32: bool = False) -> dict:
    """OPS of K6 (``kind`` "ppo") or K7 ("mappo") on ``name`` at hidden
    ``h`` (``bf16``: of K6-bf16 or K7-bf16; ``tf32``: of the float32 kernel
    at 128 and 256, its products in 3xTF32): a "step" is a sample, K6's (t,
    agent, env); K7's actor sample, and as its "reset" a critic sample (t,
    env)."""
    a, ow, c, _, _ = widths(name)
    sample, critic = ((update_bf16_sample, critic_bf16_sample) if bf16 else
                      (update_tf32_sample, critic_tf32_sample) if tf32 else
                      (update_sample, critic_sample))
    if kind == "ppo":
        return {"step": sample(ow, 6 + c, c, True, h), "reset": {}, "env": {}}
    return {"step": sample(ow, 5 + c, c, False, h), "reset": critic(a * ow, h), "env": {}}


def add_policy_ops() -> None:
    """OPS of K4-K9 on every scenario, from its widths (which need the
    package, so main adds them after importing it)."""
    for name in ALL_SCENARIOS:
        a, ow, c, _, _ = widths(name)
        OPS[f"policy_traj_kernel[{name}]"], OPS[f"policy_rollout_kernel[{name}]"] = \
            policy_ops(name)
        OPS[f"ppo_update_kernel[{name}]"] = update_ops("ppo", name)
        OPS[f"mappo_update_kernel[{name}]"] = update_ops("mappo", name)
        OPS[f"ppo_update_bf16_kernel[{name}]"] = {"step": update_bf16_sample(ow, 6 + c, c, True),
                                                  "reset": {}, "env": {}}
        OPS[f"mappo_update_bf16_kernel[{name}]"] = {
            "step": update_bf16_sample(ow, 5 + c, c, False), "reset": critic_bf16_sample(a * ow),
            "env": {}}
        OPS[f"maddpg_traj_kernel[{name}]"] = maddpg_ops(name)
        OPS[f"maddpg_update_kernel[{name}]"] = maddpg_update_ops(name)
        OPS[f"maddpg_update_bf16_kernel[{name}]"] = maddpg_update_bf16_sample(name)
        for h in WIDE_PHASE:
            OPS[f"maddpg_update_bf16_kernel[{name}, hidden {h}]"] = maddpg_update_bf16_sample(
                name, h)


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
    # (a tensor-core instruction issues thousands of multiply-adds: not counted)
    t_issue = sum(v for k, v in total.items() if k not in TENSOR_CORES) / (
        DISPATCH_PER_CLOCK * SM_CLOCKS_PER_S)
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


def other_tile(tiles, tile: int) -> int:
    """The tile after ``tile`` in ``tiles``, or the one before the last."""
    i = tiles.index(tile)
    return tiles[i + 1] if i + 1 < len(tiles) else tiles[i - 1]


def same_bits(label: str, got, want) -> None:
    """Every output of ``got`` equal to ``want``'s bit for bit."""
    import torch

    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    assert not bad, f"{label}: outputs {bad} differ"
    print(f"{label}: every output equal bit for bit")


def check_update(label: str, update, params, batch, gated: tuple[str, ...],
                 tol: float = GRAD_TOL) -> float:
    """K6 against its plain version on ``batch``: each gradient leaf within
    ``tol`` of its largest entry and the metric means named in ``gated``
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
    assert max(errs.values()) <= tol, f"{label}: the gradient disagrees with its plain version"
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
    rate = N_ENVS * GENERIC_STEPS / generic_s
    print(f"generic engine, {name}: {rate:.6g} env-steps/s "
          f"({N_ENVS} envs x {GENERIC_STEPS} steps in {generic_s * 1e3:.1f} ms); "
          f"mean reward per env-step by agent "
          + ", ".join(f"{m:.5f} +- {se:.5f}" for m, se in stats))
    return stats, rate


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
    """Main path a: generic engine (its env-steps/s returned last), K2 at
    three widths, K1."""
    import torch

    from mpe_tpu_torch.ops.fused_parity import fused_det_rollout, make_det_inputs
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout

    zero_launches(wrappers)
    generic, generic_rate = generic_engine("simple_spread", dev)

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
    return launches, by, k1_by, k2, k2_ms_at, k1_ms, det_inputs, generic_rate


def training_path(wrappers, kscn, build, label: str, kernels: list[str],
                  n_iters: int = TRAIN_ITERS, hidden: int = TRAIN["hidden"]):
    """Main path b (PPO: K5, K6) or b2 (MAPPO: K5, K7): ``n_iters``
    iterations of the fused trainer ``build`` at TRAIN's shape and hidden
    width ``hidden``, timed by phase with CUDA events."""
    import torch

    step = build(kscn, **dict(TRAIN, hidden=hidden))
    params = step.init_params(torch.Generator().manual_seed(0))
    state0 = step.init_state(params)
    zero_launches(wrappers)
    state, iters = state0, []
    for i in range(n_iters):
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
    print(f"{label}, iterations 1-{n_iters - 1}: "
          f"{step.n_transitions * len(steady) / (total_ms * 1e-3):.6g} transitions/s "
          f"({len(steady)} x {step.n_transitions} transitions in {total_ms:.3f} ms); mean per "
          f"iteration {total_ms / len(steady):.3f} ms: "
          + ", ".join(f"{k} {v / len(steady):.3f} ms" for k, v in phase_ms.items())
          + f"; median per iteration {statistics.median(t for t, _, _ in steady):.3f} ms")
    for i in sorted({0, n_iters // 2 - 1, n_iters - 1}):
        m = iters[i][2]
        print(f"{label} iter {i}: mean_reward {m['mean_reward']:.6f}, entropy "
              f"{m['entropy']:.6f}, loss {m['loss']:.6f}, pg_loss {m['pg_loss']:.6f}, v_loss "
              f"{m['v_loss']:.6f}")
    return (launches, step, state0, state, {k: v / len(steady) for k, v in phase_ms.items()},
            iters[-1][2])


def bf16_path(wrappers, f32_last: dict) -> dict:
    """Path b5 (the module docstring): TRAIN_ITERS iterations of the PPO and
    MAPPO trainers with ``compute_dtype=torch.bfloat16`` on simple_spread at
    TRAIN's width, timed by phase as paths b and b2; each launches K5 once and
    its bf16 update kernel ``ppo_epochs`` times an iteration, and no other
    kernel. The last iteration's mean reward is printed beside the float32
    path's (``f32_last``, not gated) -> {kind: (launches, step, state0, state,
    phases, last metrics)}."""
    import functools

    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    out = {}
    for label, kind in BF16_TRAINERS:
        build = functools.partial(build_fused_ppo_step if kind == "ppo" else
                                  build_fused_mappo_step, compute_dtype=torch.bfloat16)
        kernel = f"{kind}_update_bf16_kernel"
        out[kind] = training_path(wrappers, kernel_scenario("simple_spread"), build,
                                  f"{label} (simple_spread)", ["policy_traj_kernel", kernel])
        launched = {k: w.launches for k, w in wrappers.items() if w.launches}
        want = {"policy_traj_kernel": TRAIN_ITERS, kernel: TRAIN_ITERS * TRAIN["ppo_epochs"]}
        assert launched == want, f"{label}: launched {launched}, expected exactly {want}"
        last, ref = out[kind][5], f32_last[kind]
        print(f"{label} (simple_spread): iteration {TRAIN_ITERS - 1} mean_reward "
              f"{last['mean_reward']:.6f} beside the float32 path's {ref['mean_reward']:.6f}, "
              f"entropy {last['entropy']:.6f} beside {ref['entropy']:.6f} (not gated)")
    return out


def maddpg_path(wrappers, name: str = "simple_spread", n_chunks: int = MADDPG_CHUNKS,
                hidden: int = 64, actor_start: int = MADDPG_ACTOR_START):
    """Main path d (simple_spread), d2 or d3 (the comm scenarios of
    MADDPG_COMM): the fused MADDPG loop (K8 collection, K9 updates) on
    ``name`` for ``n_chunks`` chunks, timed by phase with CUDA events ->
    (launches, launches by scenario, runner, params, info, transitions/s,
    mean collect ms per chunk, mean update ms per chunk). Phase 3d runs it at
    the wide ``hidden`` widths with ``actor_start`` 0."""
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner

    label = f"MADDPG ({name})" if hidden == 64 else f"MADDPG ({name}, hidden {hidden})"
    run = build_fused_maddpg_runner(name, hidden=hidden, **MADDPG)
    horizon = MADDPG["horizon"]
    zero_launches(wrappers)
    events = []
    t0 = time.perf_counter()
    params, info = run(n_chunks * horizon, seed=0, actor_start=actor_start, events=events)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    kernels = ["maddpg_traj_kernel", "maddpg_update_kernel"]
    launches = read_launches(wrappers, kernels, f"{label} path")
    by = {k: read_instantiations(wrappers[k], [name], f"{label} path's {k}") for k in kernels}
    steady = chunk_phase_ms(events, n_chunks)[1:]   # chunk 0 sets up the first allocations
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
          f"{statistics.median(a + b for a, b in steady):.3f} ms; collect per chunk min, median, "
          f"max {min(a for a, _ in steady):.3f}, {statistics.median(a for a, _ in steady):.3f}, "
          f"{max(a for a, _ in steady):.3f} ms; the whole run with the warm-up {wall_s:.2f} s "
          "(host clock)")
    print(f"{label} chunk 0: mean reward {float(mr[0]):.6f}, critic loss {float(cl[0]):.6f}; "
          f"chunk {n_chunks - 1}: mean reward {float(mr[-1]):.6f}, critic loss "
          f"{float(cl[-1]):.6f}; ring {info['buffer'].size} of {run.capacity} rows "
          f"({info['buffer'].data.numel() * 4 / 1e6:.0f} MB)")
    return (launches, by, run, params, info, rate, collect_ms / len(steady),
            update_ms / len(steady))


def bf16_maddpg_path(wrappers, f32_runs: dict, names=D4_NAMES, n_chunks: int = MADDPG_CHUNKS,
                     hidden: int = 64, actor_start: int = MADDPG_ACTOR_START) -> dict:
    """Path d4 (the module docstring): on each of ``names``, the runner's
    pieces with its defaults (RUNNER_HP, MADDPG's widths, a ring of n_envs x
    1600 rows, the warm-up collections, ``actor_start``, chunk keys and gates
    as ``fused_loop``'s), the update chunk with
    ``compute_dtype=torch.bfloat16``: ``n_chunks`` chunks timed by CUDA
    events split into collect and update (phase 3d runs it at the wide
    ``hidden`` widths). K9-bf16 launches exactly once an update and K9 never;
    every metric finite; the last chunk's critic loss and mean reward printed
    beside the float32 path's (``f32_runs``: d, d2; phase 3d: the float32
    runner at that width), not gated -> {name: {launches, transitions_per_s,
    collect_ms, update_ms, last metrics, params, chunk, buffer}}."""
    import torch

    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.learner.fused_loop import actor_gates, chunk_key
    from mpe_tpu_torch.learner.fused_ppo import _mark
    from mpe_tpu_torch.learner.maddpg import (_dims, _tree3, build_fused_collect,
                                              build_fused_update_chunk, init_buffer, init_maddpg)

    n, horizon, batch = MADDPG["n_envs"], MADDPG["horizon"], MADDPG["batch"]
    out = {}
    for name in names:
        label = f"MADDPG-bf16 ({name}" + ("" if hidden == 64 else f", hidden {hidden}") + ")"
        env = MpeEnv(scenarios.load(name), max_steps=horizon, auto_reset=True, device="cuda")
        _, obs_dim, aw, _, _ = _dims(env)
        a = env.n_agents
        collect = build_fused_collect(env, n, horizon, eps_greedy=RUNNER_HP["eps"],
                                      block_envs=min(1024, n))
        chunk = build_fused_update_chunk(env, horizon, batch=batch, tau_polyak=RUNNER_HP["tau"],
                                         actor_lr=RUNNER_HP["lr"], critic_lr=RUNNER_HP["lr"],
                                         ent_coef=RUNNER_HP["ent_coef"], hidden=hidden,
                                         compute_dtype=torch.bfloat16)
        zero_launches(wrappers)
        t0 = time.perf_counter()
        params = _tree3(lambda x: x.to("cuda"),
                        init_maddpg(torch.Generator().manual_seed(0), obs_dim, aw, a,
                                    hidden=hidden))
        targets = _tree3(torch.clone, params)
        buffer = init_buffer(n * 1600, a, obs_dim, aw, device="cuda")
        for i in range(max(1, 200 // horizon)):
            buffer, _ = collect(params["actor"], buffer, i)
        state = chunk.pack_state(params, targets, chunk.init_opt(params))
        events, mean_rewards, critic_losses = [], [], []
        _mark(events, "start")
        for i in range(n_chunks):
            buffer, mr = collect(chunk.actor_of(state), buffer, 10_000 + i)
            _mark(events, "collect")
            state, m = chunk.packed_step(state, buffer, chunk_key(0, i),
                                         actor_gates(i, horizon, actor_start))
            _mark(events, "update")
            mean_rewards.append(mr)
            critic_losses.append(m["critic_loss"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        print(f"{label} path launches: {launches}")
        want = n_chunks * horizon
        assert launches.get("maddpg_update_bf16_kernel") == want, \
            f"{label}: K9-bf16 launched {launches.get('maddpg_update_bf16_kernel')}, not {want}"
        assert set(launches) == {"maddpg_traj_kernel", "maddpg_update_bf16_kernel"}, launches
        read_instantiations(wrappers["maddpg_update_bf16_kernel"], [name],
                            f"{label} path's K9-bf16")
        params, targets, opt_states = chunk.unpack_state(state)
        mr, cl = torch.stack(mean_rewards).double(), torch.stack(critic_losses).double()
        assert bool(torch.isfinite(mr).all()) and bool(torch.isfinite(cl).all()), (mr, cl)
        finite_tree(label, params)
        finite_tree(f"{label} targets", targets)
        steady = chunk_phase_ms(events, n_chunks)[1:]
        collect_ms, update_ms = (sum(x[q] for x in steady) / len(steady) for q in (0, 1))
        rate = n * horizon / ((collect_ms + update_ms) * 1e-3)
        f32_info, f32_rate = f32_runs[name][2], f32_runs[name][3]
        print(f"{label}, chunks 1-{n_chunks - 1}: {rate:.6g} transitions/s beside the float32 "
              f"path's {f32_rate:.6g}; mean per chunk {collect_ms + update_ms:.3f} ms: collect "
              f"{collect_ms:.3f} ms (K8 + insert), update {update_ms:.3f} ms ({horizon} x gather + "
              f"K9-bf16 + Adam + polyak); the whole run with the warm-up {wall_s:.2f} s (host "
              f"clock)")
        print(f"{label} chunk {n_chunks - 1}: mean reward {float(mr[-1]):.6f}, critic loss "
              f"{float(cl[-1]):.6f}; the float32 path's {float(f32_info['mean_reward'][-1]):.6f}, "
              f"{float(f32_info['critic_loss'][-1]):.6f} (not gated: a bf16 run is another "
              f"function)")
        out[name] = {"launches": launches, "transitions_per_s": rate, "collect_ms": collect_ms,
                     "update_ms": update_ms, "last_mean_reward": float(mr[-1]),
                     "last_critic_loss": float(cl[-1]),
                     "float32_last_mean_reward": float(f32_info["mean_reward"][-1]),
                     "float32_last_critic_loss": float(f32_info["critic_loss"][-1]),
                     "params": params, "chunk": chunk, "buffer": buffer, "targets": targets,
                     "opt_states": opt_states}
    return out


def chunk_phase_ms(events, n_chunks: int) -> list[tuple[float, float]]:
    """(collect ms, update ms) of each chunk from a runner's CUDA events
    ("start", then "collect" and "update" per chunk)."""
    out = []
    for c in range(n_chunks):
        start, col, upd = events[2 * c][1], events[2 * c + 1][1], events[2 * c + 2][1]
        out.append((start.elapsed_time(col), col.elapsed_time(upd)))
    return out


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


def maddpg_widths(name: str, h: int = 64) -> tuple[int, int, int, int, int, int]:
    """(agents, obs width, actor head 5 + C, replay row width, floats of one
    actor, floats of one critic) of a scenario's MADDPG nets, hidden h."""
    a, ow, c, _, _ = widths(name)
    k = 5 + c
    j = a * (ow + k)
    nw = h * ow + h + h * h + h + k * h + k
    nc = h * j + h + h * h + h + h + 1
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
        generic, _ = generic_engine(name, dev)
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


def update_bound(kernel: str, name: str, batch, h: int = 64,
                 tf32: bool = False) -> tuple[float, str, float]:
    """``bound_ms`` of one epoch gradient of ``kernel`` (K6, K7 or their bf16
    twins: OPS by sample; at another hidden width ``h`` than 64 the kernel's
    ``update_ops``, the bf16 ones for a bf16 kernel, with ``tf32`` the 3xTF32
    ones of the float32 kernel at 128 and 256) on ``batch``: K6 reads
    obs, the one-hots, logp_old, adv, ret and value per sample, K7 the first
    four per (t, agent, env) and the team's three per (t, env); both read
    their weights and write the gradient once."""
    a, ow, c, _, _ = widths(name)
    t, n = batch[0].shape[0], batch[0].shape[3]
    per_sample = ow + 5 + c + 1                       # obs, one-hots, logp_old
    ops = (OPS[f"{kernel}[{name}]"] if h == 64 else
           update_ops(kernel.split("_")[0], name, h, bf16="bf16" in kernel, tf32=tf32))
    if kernel.startswith("ppo"):
        n_w = h * (ow + h + 6 + c) + 2 * h + 6 + c
        return bound_ms(ops, t * a * n, 0, 0, t * a * n * (per_sample + 3) * 4 + 2 * n_w * 4)
    n_w = h * (ow + h + 5 + c) + 2 * h + 5 + c + h * (a * ow + h + 1) + 2 * h + 1
    return bound_ms(ops, t * a * n, t * n, 0,
                    t * a * n * per_sample * 4 + t * n * 3 * 4 + 2 * n_w * 4)


def leaf_errors(got, ref) -> dict:
    """Each gradient leaf's largest abs error over its largest entry."""
    return {f"{k}.{q}": max_err(got[k][q], ref[k][q]) / float(ref[k][q].abs().max())
            for k in ref for q in ref[k]}


def fmt_ms(x) -> str:
    return x if isinstance(x, str) else f"{x:.4f} ms"


def update_device_ms(fn, launches: int) -> float | str:
    """One call of ``fn`` under torch.profiler after a warm-up: the device ms
    of the ``launches`` update kernels it launches (every kernel whose name
    holds "update": the passes and their reduces), or "not measured" where
    the profiler kept a record of fewer of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and "update" in e.key]
    if sum(e.count for e in dev) != launches:
        return "not measured"
    return sum(device_us(e) for e in dev) / 1e3


def epoch0_ratio_dev(update_fn, params, batch, hp: dict) -> float:
    """max |ratio - 1| that an update kernel's own forward sees against the
    trainer's logp_old at epoch 0, read one sample at a time from its pg
    metric: BF16_PROBE_ENVS single-env, single-step batches (t = 0), the
    advantage 1 and every other agent's logp_old lowered by 10, so that
    their ratios clip at 1 + clip and pg = -(r_i + (A - 1)(1 + clip)) / A."""
    import torch

    obs, mv_oh, cm_oh, lpo, adv, ret, vold = batch
    a = obs.shape[1]
    worst = 0.0
    for n in range(BF16_PROBE_ENVS):
        def one(x):
            return None if x is None else x[:1, ..., n:n + 1].contiguous()

        for i in range(a):
            lp = one(lpo).clone()
            lp[:, [j for j in range(a) if j != i]] -= 10.0
            _, (pg, _, _) = update_fn(params, one(obs), one(mv_oh), one(cm_oh), lp,
                                      torch.ones_like(one(adv)), one(ret), one(vold), **hp)
            r = -a * float(pg) - (a - 1) * (1.0 + hp["clip"])
            worst = max(worst, abs(r - 1.0))
    return worst


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
        bound = update_bound(f"{kind}_update_kernel", name, batch)
        print(f"{label} ({name}) {ms:.4f} ms (one epoch, {batch[3].numel()} policy samples), "
              f"plain {plain_ms:.3f} ms, autograd of the trainer's loss {lib_ms:.3f} ms; bound "
              f"{bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue floor "
              f"{bound[2]:.4f} ms")
        rows[name] = (err, ms, plain_ms, lib_ms, bound)
        del batch, clipped, lib_batch
    return rows


def check_bf16_kernels(trained: dict) -> dict:
    """K6-bf16 and K7-bf16 on BF16_NAMES (spread and a comm head each), on the
    trainer's batch at TRAIN's width from the params of ``trained`` ({kind:
    (step, params)}, path b5's trainers on simple_spread) or of a fresh bf16
    trainer's init: gated against the plain bf16 version there and on the
    clip-binding batch (each leaf within BF16_GRAD_TOL of its largest entry),
    the distance to the plain float32 version printed beside; the epoch-0
    ratio each kernel sees (``epoch0_ratio_dev``, beside the float32 kernel's
    on the same batch); kernel, plain version, autograd of the plain bf16
    loss and the float32 kernel timed by CUDA events and by torch.profiler
    -> {kind: {scenario: row}}."""
    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import fused_update
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    rows = {}
    for kind, names in BF16_NAMES.items():
        build = build_fused_ppo_step if kind == "ppo" else build_fused_mappo_step
        label = "K6-bf16" if kind == "ppo" else "K7-bf16"
        rows[kind] = {}
        for i, name in enumerate(names):
            step, params = trained.get((kind, name)) or (None, None)
            if step is None:
                step = build(name, compute_dtype=torch.bfloat16, **TRAIN)
                params = step.init_params(torch.Generator().manual_seed(30 + i))
            s32 = build(name, **TRAIN)
            tag = f"{label} ({name})"
            batch, clipped, lib_batch = update_batches(step, params, tag)
            gated = ("vloss", "entropy")
            err = max(check_update(f"{tag}, trainer batch", step.update, params, batch, gated,
                                   BF16_GRAD_TOL),
                      check_update(f"{tag}, clip-binding batch", step.update, params, clipped,
                                   ("pg",) + gated, BF16_GRAD_TOL))
            got, _ = step.update(params, *clipped)
            near = max(leaf_errors(got, step.update.plain(params, *clipped)[0]).values())
            far = max(leaf_errors(got, s32.update.plain(params, *clipped)[0]).values())
            print(f"{tag}, clip-binding batch: the largest leaf error against the plain bf16 "
                  f"version {near:.3g}, against the plain float32 version {far:.3g}")
            hp = dict(clip=TRAIN["clip"], vf_coef=TRAIN["vf_coef"], ent_coef=TRAIN["ent_coef"],
                      speak=kernel_scenario(name).speak)
            bf16_fn, f32_fn = ((fused_update.ppo_update_bf16_cuda, fused_update.ppo_update_cuda)
                               if kind == "ppo" else (fused_update.mappo_update_bf16_cuda,
                                                      fused_update.mappo_update_cuda))
            ratio = epoch0_ratio_dev(bf16_fn, params, batch, hp)
            ratio32 = epoch0_ratio_dev(f32_fn, params, batch, hp)
            print(f"{tag}: epoch-0 max |ratio - 1| over {BF16_PROBE_ENVS} envs x every agent "
                  f"(t = 0): {ratio:.3g}; the float32 kernel's on the same batch {ratio32:.3g}")
            ms, _ = cuda_time(lambda: step.update(params, *batch), REPEATS)
            plain_ms, _ = cuda_time(lambda: step.update.plain(params, *batch), REPEATS)
            lib_ms, _ = cuda_time(lambda: library_ppo_grads(step, params, lib_batch), REPEATS)
            ms32, _ = cuda_time(lambda: s32.update(params, *batch), REPEATS)
            passes = 2 if kind == "ppo" else 4                # K6: pass, reduce; K7: two of each
            dev = update_device_ms(lambda: step.update(params, *batch), passes)
            dev32 = update_device_ms(lambda: s32.update(params, *batch), passes)
            bound = update_bound(f"{kind}_update_bf16_kernel", name, batch)
            print(f"{tag} {ms:.4f} ms a call (device {fmt_ms(dev)}), the float32 kernel "
                  f"{ms32:.4f} ms (device {fmt_ms(dev32)}); plain {plain_ms:.3f} ms, autograd of "
                  f"the plain bf16 loss {lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
                  f"({ms / bound[0]:.2f}x); issue floor {bound[2]:.4f} ms")
            rows[kind][name] = {"max_abs_err": err, "ms": ms, "device_ms": dev,
                                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound[0],
                                "bound_by": bound[1], "float32_kernel_ms": ms32,
                                "float32_kernel_device_ms": dev32, "epoch0_max_ratio_dev": ratio,
                                "float32_kernel_epoch0_max_ratio_dev": ratio32,
                                "leaf_err_vs_plain_float32": far}
            del batch, clipped, lib_batch, s32
    return rows


def policy_bounds(name: str, n_envs: int, n_steps: int, horizon: int,
                  h: int = 64) -> tuple[tuple, tuple]:
    """(K5's, K4's) bound on ``name`` at n_envs x n_steps with an actor of
    hidden width ``h``: K5 writes obs [T,A,OW], act (and cact) [T,A] and rew
    [T,R] per env and last_obs; K4 writes ret [R], pos [E,2] and episodes
    per env; both read the weights once."""
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    a, ow, c, _, r = widths(name)
    e = kernel_scenario(name).spec.n_entities
    w_bytes = (h * (ow + h + 5 + c) + 2 * h + 5 + c) * 4
    env_steps, resets = n_envs * n_steps, n_envs * (n_steps // horizon + 1)
    out_floats = n_steps * (a * ow + a * (2 if c else 1) + r) + a * ow
    k5, k4 = ((OPS[f"policy_traj_kernel[{name}]"], OPS[f"policy_rollout_kernel[{name}]"])
              if h == 64 else policy_ops(name, h))
    return (bound_ms(k5, env_steps, resets, n_envs, n_envs * out_floats * 4 + w_bytes),
            bound_ms(k4, env_steps, resets, n_envs, n_envs * (r + 2 * e + 1) * 4 + w_bytes))


def check_main_policy_shapes(k4_runs: dict, evals: dict, trainer_actors: dict):
    """K4 at path c's shape on each actor it evaluated (``k4_runs`` and
    ``evals`` of evaluation_path), its outputs held against the plain
    version on the same actor and seed; K5 at the training shape (TRAIN,
    horizon 32) with the actor of each trainer of ``trainer_actors``
    ({scenario: actor}); kernels and plain versions timed -> ({scenario:
    (K4 err, ms, plain ms, bound)}, {scenario: (K5 err, ms, plain ms,
    bound)})."""
    from mpe_tpu_torch.ops.fused_policy import (POLICY_TILES, _kernel_weights,
                                                fused_policy_trajectory, policy_rollout_cuda,
                                                policy_tile, policy_traj_cuda)
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    k4, k5 = {}, {}
    for name, (run, ms, got) in k4_runs.items():
        kscn = kernel_scenario(name)
        tile = policy_tile(kscn, N_ENVS, "rollout")
        alt = other_tile(POLICY_TILES, tile)
        same_bits(f"K4 ({name}) at the evaluation shape, tile {alt} against tile {tile}",
                  policy_rollout_cuda(kscn, _kernel_weights(evals[name], "cuda"), N_ENVS,
                                      EVAL_STEPS, EVAL_HORIZON, BLOCK_ENVS, 0, 0, "cuda",
                                      tile=alt), got)
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
        kscn = kernel_scenario(name)
        tile = policy_tile(kscn, TRAIN["n_envs"], "traj")
        alt = other_tile(POLICY_TILES, tile)
        same_bits(f"K5 ({name}) at the training shape, tile {alt} against tile {tile}",
                  policy_traj_cuda(kscn, _kernel_weights(actor, "cuda"), TRAIN["n_envs"],
                                   TRAIN["n_steps"], TRAIN["horizon"], TRAIN["block_envs"],
                                   TRAIN["t_chunk"], 1, 0, "cuda", tile=alt), got)
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


def check_policy_kernels(actors: dict) -> tuple[dict, dict, dict]:
    """K5 on every scenario at N_ENVS x POLICY_GATE and K4 on the eight other
    than simple_spread at N_ENVS x EVAL_GATE_STEPS (horizon EVAL_HORIZON),
    each with the actor of ``actors`` (the main paths' where they exist)
    or an init_policy actor (He-scaled head, O(1) logits): moves and comm
    indices equal, values within 1e-5, and at another tile than the rule's
    every output equal bit for bit; kernel and plain version timed ->
    ({scenario: (K5 err, ms, plain ms, bound)}, {scenario: (K4 err, ms,
    plain ms, bound)} without simple_spread, whose K4 is gated at path c's
    shape, {(kernel, scenario): the rule's tile})."""
    import torch

    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.ops.fused_policy import (POLICY_TILES, _kernel_weights,
                                                fused_policy_rollout, fused_policy_trajectory,
                                                policy_rollout_cuda, policy_tile,
                                                policy_traj_cuda)
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    k5, k4, tiles = {}, {}, {}
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
        kscn, weights = kernel_scenario(name), _kernel_weights(actor, "cuda")
        tiles["K5", name] = policy_tile(kscn, N_ENVS, "traj")
        alt = other_tile(POLICY_TILES, tiles["K5", name])
        same_bits(f"K5 ({name}) at tile {alt} against tile {tiles['K5', name]}",
                  policy_traj_cuda(kscn, weights, N_ENVS, steps, POLICY_GATE["horizon"],
                                   POLICY_GATE["block_envs"], POLICY_GATE["t_chunk"], 4, 0,
                                   "cuda", tile=alt), got)
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
        tiles["K4", name] = policy_tile(kscn, N_ENVS, "rollout")
        alt = other_tile(POLICY_TILES, tiles["K4", name])
        same_bits(f"K4 ({name}) at tile {alt} against tile {tiles['K4', name]}",
                  policy_rollout_cuda(kscn, weights, N_ENVS, EVAL_GATE_STEPS, EVAL_HORIZON,
                                      BLOCK_ENVS, 6, 0, "cuda", tile=alt), got)
    return k5, k4, tiles


def ptxas_registers(logs: dict) -> dict:
    """{mangled kernel name: [registers, spill store bytes]} from the
    compiler's -Xptxas -v report; the spills are the largest of the kernel's
    and of the functions it calls (a function that is not inlined has its
    own frame)."""
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
    C>, in the compiler's order, K9-bf16 (``maddpg_update_bf16``) on
    MaddpgBf16Dims; K6-bf16, K7-bf16: ``ppo_bf16``,
    ``mappo_bf16``, as K6's and K7's), or []; K1, K2 and K3 (``det_rollout_kernel``,
    ``scenario_rollout_kernel``, ``trajectory_kernel``): {group G: [registers,
    spill bytes]} of their <XScn, G> instantiations."""
    import re

    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    if kernel in ("scenario_rollout_kernel", "det_rollout_kernel", "trajectory_kernel"):
        key = type(kernel_scenario(name)).__name__.removeprefix("Kernel") + "ScnELi"
        return {int(re.search(key + r"(\d+)E", k).group(1)): v for k, v in regs.items()
                if kernel in k and key in k}
    if kernel in ("maddpg_update", "maddpg_update_bf16"):
        a, ow, c, _, _ = widths(name)
        dims = "MaddpgBf16Dims" if kernel.endswith("bf16") else "MaddpgDims"
        key = f"{len(dims)}{dims}ILi{a}ELi{ow}ELi{c}EE"
        return [v for k, v in regs.items() if key in k]
    if kernel in ("ppo", "mappo", "ppo_bf16", "mappo_bf16"):
        a, ow, c, _, _ = widths(name)
        kind, _, dtype = kernel.partition("_")
        # hidden 128 and 256 compile the wide kernels in place of ppo_update_kernel and
        # ppo_update_bf16_kernel
        entries = (("ppo_update_bf16_kernel", "ppo_update_bf16_wide_kernel") if dtype else
                   ("ppo_update_kernel", "ppo_update_wide_kernel"))
        flags = {"ppo": "ELb1ELb0E", "mappo": "ELb0ELb1E"}[kind]
        heads = [f"ILi{ow}ELi5ELi{c}{flags}"]
        if kind == "mappo":
            heads.append(f"ILi{a * ow}ELi0ELi0ELb1ELb0E")
        return [v for head in heads for entry in entries for k, v in regs.items()
                if entry + head in k]
    key = type(kernel_scenario(name)).__name__.removeprefix("Kernel") + "ScnE"
    return [v for k, v in regs.items() if kernel in k and key in k]


def hmma_counts(widths_: tuple, source: str = "mpe_update_bf16.cu") -> dict:
    """{hidden: {"HMMA": n, "LDSM": n, "HMMA.TF32": n}}: the tensor-core mma,
    ldmatrix and tf32 mma instructions in the SASS of a library at each width
    (``cuobjdump -sass``): a bf16 library (K6-bf16 and K7-bf16's
    ``mpe_update_bf16.cu``, K9-bf16's ``mpe_maddpg_bf16.cu``) must hold some
    HMMA and LDSM, the float32 ``mpe_update.cu`` at 128 and 256 (K6 and K7 in
    3xTF32) some tf32 HMMA."""
    from mpe_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    procs = {h: subprocess.Popen([cuobjdump, "-sass", str(_build._target(source, h))],
                                 stdout=subprocess.PIPE, text=True) for h in widths_}
    out = {}
    for h, proc in procs.items():                    # the widths' disassemblies run side by side
        sass = proc.communicate()[0].splitlines()
        assert proc.returncode == 0, f"cuobjdump failed on {source} at hidden {h}"
        out[h] = {op: sum(op in line for line in sass) for op in ("HMMA", "LDSM")}
        out[h]["HMMA.TF32"] = sum("HMMA" in line and "TF32" in line for line in sass)
    print(f"HMMA, LDSM and tf32 HMMA instructions in the SASS of {source} by hidden width: {out}")
    if source == "mpe_update.cu":
        assert all(n["HMMA.TF32"] > 0 for n in out.values()), \
            f"a library of {source} lacks tf32 HMMA: {out}"
    else:
        assert all(n["HMMA"] > 0 and n["LDSM"] > 0 for n in out.values()), \
            f"a bf16 library of {source} lacks HMMA or LDSM: {out}"
    return out


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
    actor of ``actors`` ({label: actor}), both output forms, and at another
    tile than the rule's equal bit for bit; the eps coins' share; then K8 in
    the rows form and its plain version timed with the first actor -> (max
    abs err, ms, plain ms, bound, the rows of the first actor at block offset
    0, the rule's tile)."""
    import torch

    from mpe_tpu_torch.learner.maddpg import collect_t_chunk
    from mpe_tpu_torch.ops.fused_maddpg import (MADDPG_TILES, _kernel_weights,
                                                fused_maddpg_trajectory, maddpg_tile,
                                                maddpg_traj_cuda)
    from mpe_tpu_torch.ops.fused_rollout import make_uniform
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    n, hor = MADDPG["n_envs"], MADDPG["horizon"]
    t_chunk = collect_t_chunk(hor)
    a, _, k, width, nw, _ = maddpg_widths(name)
    heads = 2 if k > 5 else 1
    first = next(iter(actors.values()))
    kw = dict(horizon=hor, eps_greedy=0.1, block_envs=BLOCK_ENVS, t_chunk=t_chunk)
    tens = fused_maddpg_trajectory(name, first, n, hor, **kw)
    rows = fused_maddpg_trajectory(name, first, n, hor, emit_rows=True, **kw)
    kscn = kernel_scenario(name)
    tile = maddpg_tile(kscn, n)
    alt = other_tile(MADDPG_TILES, tile)
    errs, coins = {}, []
    for label, actor in actors.items():
        for offset in (0, 1):
            got, ref = tens(3, actor, offset), tens.plain(3, actor, offset)
            report_actions(f"K8 ({name}, {label} actor, block offset {offset})", got[1], ref[1])
            for key, x, y in zip(("obs", "act", "rew", "obs2"), got, ref):
                errs[key] = max(errs.get(key, 0.0), max_err(x, y))
            got_rows = rows(3, actor, offset)
            errs["rows"] = max(errs.get("rows", 0.0), max_err(got_rows, replay_rows(*got)))
            weights = _kernel_weights(actor, "cuda")
            for emit, want in ((False, got), (True, got_rows)):
                same_bits(f"K8 ({name}, {label} actor, block offset {offset}, rows {emit}) at "
                          f"tile {alt} against tile {tile}",
                          maddpg_traj_cuda(kscn, weights, n, hor, hor, BLOCK_ENVS, t_chunk, 0.1,
                                           3, offset, emit, "cuda", tile=alt), want)
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
    return err, ms, plain_ms, bound, rows(3, first).reshape(n * hor, width), tile


def gate_maddpg_update(name: str, params: dict, rows_all, label: str):
    """K9 on ``name`` against its plain version on MADDPG["batch"] rows drawn
    from ``rows_all``, with ``params`` (of any compiled hidden width) and
    targets = params + 0.1 N(0, 1): target actions per head equal (the
    smallest gap between a head's best and second target logit printed),
    each gradient leaf within GRAD_TOL of its largest entry, the metrics
    within METRIC_RTOL -> (max abs err, rows, targets, the builder)."""
    import torch

    from mpe_tpu_torch.ops.fused_maddpg_update import (fused_maddpg_update, maddpg_update_cuda,
                                                       target_indices, target_logits)

    a, ow, c, _, _ = widths(name)
    k, b, cw = 5 + c, MADDPG["batch"], c
    hidden = params["actor"]["l1"]["w"].shape[-1]
    gen = torch.Generator("cuda").manual_seed(5)
    rows = rows_all[torch.randint(0, rows_all.shape[0], (b,), generator=gen,
                                  device="cuda")].contiguous()
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda")
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    grads_fn = fused_maddpg_update(a, ow, k, 5, hidden, b)
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
    return worst, rows, targets, grads_fn


def check_maddpg_update(name: str, params: dict, rows_all, label: str):
    """K9 on ``name`` against its plain version on MADDPG["batch"] rows drawn
    from ``rows_all``, with ``params`` (of any compiled hidden width) and
    targets = params + 0.1 N(0, 1): target actions per head equal (the
    smallest gap between a head's best and second target logit printed),
    each gradient leaf within GRAD_TOL of its largest entry, the metrics
    within METRIC_RTOL; then K9, its plain version and autograd of the losses
    timed -> (max abs err, ms, plain ms, library ms, bound, ms from trees): ms
    is the trainer's call, K9's launcher on the packed weight buffer."""
    import torch

    from mpe_tpu_torch.learner.maddpg import maddpg_xla_grads
    from mpe_tpu_torch.ops.fused_maddpg_update import MaddpgUpdateLauncher, _split_rows

    hidden = params["actor"]["l1"]["w"].shape[-1]
    a, ow, k, width, nw, nc = maddpg_widths(name, hidden)
    b, cw = MADDPG["batch"], k - 5
    worst, rows, targets, grads_fn = gate_maddpg_update(name, params, rows_all, label)

    # the trainer's call: K9's launcher on the packed buffers; from_rows packs
    # the trees on every call
    k9 = MaddpgUpdateLauncher(a, ow, k, 5, hidden, b, "cuda", gamma=0.95, ent_coef=0.01)
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
    bound = bound_ms(maddpg_update_ops(name, hidden), b * a, 0, 0,
                     4 * (b * width + 2 * a * (nw + nc) + a * (nw + nc + 3)))
    print(f"K9 ({name}, {label}) {ms:.4f} ms per call on the packed buffers (batch {b}; "
          f"{tree_ms:.4f} ms from trees), plain {plain_ms:.3f} ms, autograd of the losses "
          f"{lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x); issue "
          f"floor {bound[2]:.4f} ms")
    return worst, ms, plain_ms, lib_ms, bound, tree_ms


def tree_leaf_errors(got, ref) -> dict:
    """Each leaf of a MADDPG gradient tree: its largest abs error over its
    largest entry."""
    return {f"{n}.{q}.{w}": max_err(got[n][q][w], ref[n][q][w]) / float(ref[n][q][w].abs().max())
            for n in ref for q in ref[n] for w in ref[n][q]}


def actor_flip_model(params, rows, name: str, ref) -> dict:
    """The error model of the expected-Q gradient on a trained batch, printed
    beside the actor leaves' errors (the gate holds every leaf to
    BF16_GRAD_TOL, which is tighter: the model adds worst cases): a bf16
    activation of a candidate's critic that the kernel and the plain version
    round one ulp apart (BF16_GRAD_TOL's note) moves that candidate's Q by at
    most dQ = 2^-8 max(max_g |w3c_g|, max_h sum_g |w3c_g| |w2c_gh|) (an h2
    unit, or an h1 unit through layer 2), so qbar and E by at most dQ and
    the sample's logit gradient p (qbar - E) / (A B) by at most 2 dQ / (A B);
    a trained critic makes qbar - E small, so this is no longer small beside
    the leaf. A float32 value lies within its sum-order discrepancy (2^-24
    sqrt(H) of it) of a bf16 rounding boundary (2^-8 of it) with odds about
    2^-15 sqrt(H) each: over the batch's B x 2 H x candidates rounded
    activations that is N flips, whose moves add with random signs, so a leaf
    may move by 3 sqrt(N) x 2 dQ / (A B) times its chain to the logits (out:
    1; l2: max_g sum_c |w3a|; l1: max_h sum_g |w2a| sum_c |w3a|, times max
    |obs| for l1.w) -> {actor leaf: that over its largest entry}."""
    import torch

    a, ow, c, _, _ = widths(name)
    n_cand, b = 5 * max(c, 1), rows.shape[0]
    cr, ac = params["critic"], params["actor"]
    h = cr["l2"]["w"].shape[-1]
    w3c, w2c = cr["out"]["w"][..., 0].abs(), cr["l2"]["w"].abs()          # [A, H], [A, H, H]
    dq = 2.0 ** -8 * torch.maximum(w3c.amax(1), (w2c * w3c[:, None, :]).sum(2).amax(1))  # [A]
    n_flips = b * 2 * h * n_cand * 2.0 ** -15 * math.sqrt(h)
    scale = 3.0 * math.sqrt(n_flips) * 2.0 * dq / (a * b)                   # [A]
    c2 = ac["out"]["w"].abs().sum(2)                                        # [A, H]
    c1 = (ac["l2"]["w"].abs() * c2[:, None, :]).sum(2)                      # [A, H(in)]
    obs_max = rows[:, :a * ow].reshape(b, a, ow).abs().amax((0, 2))
    chain = {"out": scale, "l2": scale * c2.amax(1), "l1": scale * c1.amax(1)}
    tol = {}
    for q, layer in ref["actor"].items():
        for w, x in layer.items():
            move = chain[q] * (obs_max if (q, w) == ("l1", "w") else 1.0)
            tol[f"actor.{q}.{w}"] = float(move.max()) / float(x.abs().max())
    return tol


def plain_maddpg_reordered(*args, seed: int | None = None, **kw):
    """``plain_maddpg_update(*args, **kw)`` with each of its ordered sums (a
    forward layer's over its inputs, the sums over candidates, heads and
    logits) taken in another order: from the last term to the first, or with
    ``seed`` in a random order drawn for each sum. Beside the plain version it
    shows how far the order of the sums alone moves the result."""
    import torch

    from mpe_tpu_torch.ops import fused_maddpg_update as fmu

    gen = None if seed is None else torch.Generator().manual_seed(seed)

    def order(n: int) -> list:
        if gen is None:
            return list(range(n - 1, -1, -1))
        return torch.randperm(n, generator=gen).tolist()

    def dense(w, b, x):
        q0, *rest = order(w.shape[1])
        acc = x[..., q0:q0 + 1] * w[:, q0]
        for q in rest:
            acc = acc + x[..., q:q + 1] * w[:, q]
        return acc + b

    def seq_sum(terms):
        m0, *rest = order(terms.shape[-1])
        acc = terms[..., m0]
        for m in rest:
            acc = acc + terms[..., m]
        return acc

    kept = fmu._seq_dense_agents, fmu._seq_sum
    fmu._seq_dense_agents, fmu._seq_sum = dense, seq_sum
    try:
        return fmu.plain_maddpg_update(*args, **kw)
    finally:
        fmu._seq_dense_agents, fmu._seq_sum = kept


def gate_maddpg_bf16(name: str, params: dict, targets: dict, rows, label: str,
                     trained: bool = False, draws: int = 0) -> dict:
    """K9-bf16 on ``name`` against its plain bf16 version on ``rows``: the
    target actions equal wherever a head's two best target logits lie further
    apart than ``target_logit_tolerance`` (the flips below it counted and
    printed with their gaps); the gradient, with the kernel's own target
    actions fed to the plain version, each leaf within BF16_GRAD_TOL of its
    largest entry (on a ``trained`` batch ``actor_flip_model``'s bound printed
    beside the actor leaves, and, before the gate, the plain bf16 version's
    leaf distances to itself with its sums reversed, ``plain_maddpg_reordered``:
    what the order of the sums alone moves on this batch, and with ``draws``
    the largest and the median of that many random orders); the metrics within
    BF16_METRIC_RTOL; the distance to the plain float32 version (the same
    target actions) printed -> {max_abs_err, leaf errors, float32 distance,
    flips, ...}."""
    import torch

    from mpe_tpu_torch.ops.fused_maddpg_update import (maddpg_update_bf16_cuda, plain_maddpg_update,
                                                       target_indices, target_logit_tolerance,
                                                       target_logits)

    a, ow, c, _, _ = widths(name)
    k, b = 5 + c, rows.shape[0]
    hp = dict(mw=5, gamma=0.95, ent_coef=0.01)
    act2 = torch.empty((a, 2 if c else 1, b), dtype=torch.int32, device="cuda")
    got, got_m = maddpg_update_bf16_cuda(params, targets, rows, target_actions=act2, **hp)
    logits = target_logits(targets["actor"], rows[:, a * (ow + k + 1):].reshape(b, a, ow),
                           torch.bfloat16)
    want = target_indices(logits, 5).permute(1, 2, 0)                      # [A, heads, B]
    bound = target_logit_tolerance(targets["actor"])                       # [A]
    heads = ((0, 5), (5, k)) if c else ((0, 5),)
    gaps = torch.stack([logits[..., lo:hi].topk(2, dim=-1).values.diff(dim=-1)[..., 0].neg()
                        for lo, hi in heads], -1).permute(1, 2, 0)
    clear = gaps > bound[:, None, None]
    flips = act2.long() != want
    below = sorted(float(g) for g in gaps[flips])
    print(f"K9-bf16 ({name}, {label}) target actions: {float(clear.double().mean()):.4f} of the "
          f"heads clear of the bound (per agent {[f'{float(x):.3g}' for x in bound]}), "
          f"{int(flips.sum())} flips, at gaps {[f'{g:.3g}' for g in below[:8]]}")
    assert not bool((flips & clear).any()), f"K9-bf16 ({name}, {label}): a clear head flipped"
    ref, ref_m = plain_maddpg_update(params, targets, rows, compute_dtype=torch.bfloat16,
                                     target_actions=act2, **hp)
    f32, _ = plain_maddpg_update(params, targets, rows, target_actions=act2, **hp)
    errs = tree_leaf_errors(got, ref)
    model = actor_flip_model(params, rows, name, ref) if trained else {}
    reordered = {}
    if trained:
        rev = plain_maddpg_reordered(params, targets, rows, compute_dtype=torch.bfloat16,
                                     target_actions=act2, **hp)[0]
        reordered = tree_leaf_errors(rev, ref)
        print(f"K9-bf16 ({name}, {label}) the plain bf16 version with its sums reversed "
              "against itself: " + ", ".join(f"{key} {v:.3g}" for key, v in reordered.items()))
        if draws:
            runs = [tree_leaf_errors(plain_maddpg_reordered(
                params, targets, rows, compute_dtype=torch.bfloat16, target_actions=act2,
                seed=d, **hp)[0], ref) for d in range(draws)]
            reordered = {"reversed": reordered,
                         "random_max": {key: max(r[key] for r in runs) for key in errs},
                         "random_median": {key: statistics.median(r[key] for r in runs)
                                           for key in errs}}
            print(f"K9-bf16 ({name}, {label}) ... in {draws} random orders, largest (median): "
                  + ", ".join(f"{key} {reordered['random_max'][key]:.3g} "
                              f"({reordered['random_median'][key]:.3g})" for key in errs))
    far = max(tree_leaf_errors(got, f32).values())
    m_err = [abs(float(x) - float(y)) / abs(float(y)) for x, y in zip(got_m, ref_m)]
    print(f"K9-bf16 ({name}, {label}) leaf errors against the plain bf16 version: "
          + ", ".join(f"{key} {v:.3g}" + (f" (error model {model[key]:.3g})" if key in model
                                          else "") for key, v in errs.items())
          + f"; against the plain float32 version {far:.3g}; metrics relative "
          + ", ".join(f"{v:.3g}" for v in m_err))
    bad = {key: v for key, v in errs.items() if not v <= BF16_GRAD_TOL}
    assert not bad, f"K9-bf16 ({name}, {label}): the gradient disagrees with plain bf16: {bad}"
    assert max(m_err) <= BF16_METRIC_RTOL, f"K9-bf16 ({name}, {label}): the metrics disagree"
    worst = max(max_err(got[n][q][w], ref[n][q][w]) for n in ref for q in ref[n] for w in ref[n][q])
    return {"max_abs_err": worst, "leaf_err": max(errs.values()), "leaf_errors": errs,
            "leaf_err_vs_plain_float32": far, "target_flips": int(flips.sum()),
            "target_flip_gaps": below[:8], "clear_share": float(clear.double().mean()),
            "actor_error_model": model, "plain_reversed_leaf_errors": reordered}


def check_maddpg_bf16(name: str, trained: dict, rows_all, h: int = 64, draws: int = 0) -> dict:
    """K9-bf16 on ``name`` at hidden ``h`` on two batches of MADDPG["batch"]
    rows of ``rows_all`` (the main path's ring; phase 3d: K8's rows): fresh
    init_maddpg params of that width and ``trained`` params (the main path's;
    phase 3d: the float32 runner's at that width), targets = params + 0.1
    N(0, 1) in both
    (``gate_maddpg_bf16``; on the fresh batch K9-bf16 lies at least 10x
    nearer the plain bf16 version than the plain float32 version); then on
    the trained batch K9-bf16 per call on the packed buffers beside K9 on the
    same buffers, the plain bf16 version and autograd of the losses in
    float32 (no bf16 library computation exists), and the bound -> the
    kernels line's by_scenario row. ``draws``: the trained gate's random-order
    witnesses (``gate_maddpg_bf16``)."""
    import torch

    from mpe_tpu_torch.learner.maddpg import init_maddpg, maddpg_xla_grads
    from mpe_tpu_torch.ops.fused_maddpg_update import (MaddpgUpdateLauncher, _split_rows,
                                                       plain_maddpg_update)

    a, ow, k, width, nw, nc = maddpg_widths(name, h)
    b = MADDPG["batch"]
    gen = torch.Generator("cuda").manual_seed(8)
    rows = rows_all[torch.randint(0, rows_all.shape[0], (b,), generator=gen,
                                  device="cuda")].contiguous()

    def perturbed(p):
        return {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda")
                        for w, x in layer.items()} for q, layer in net.items()}
                for n, net in p.items()}

    fresh = {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
             for n, net in init_maddpg(torch.Generator().manual_seed(80), ow, k, a,
                                       hidden=h).items()}
    tag = "" if h == 64 else f", hidden {h}"
    row = {"fresh": gate_maddpg_bf16(name, fresh, perturbed(fresh), rows, f"fresh params{tag}")}
    near, far = row["fresh"]["leaf_err"], row["fresh"]["leaf_err_vs_plain_float32"]
    assert 10 * near <= far, f"K9-bf16 ({name}): {near:.3g} from plain bf16, {far:.3g} from float32"
    targets = perturbed(trained)
    row["trained"] = gate_maddpg_bf16(name, trained, targets, rows, f"trained params{tag}",
                                      trained=True, draws=draws)

    hp = dict(gamma=0.95, ent_coef=0.01)
    lay_bf16 = MaddpgUpdateLauncher(a, ow, k, 5, h, b, "cuda", compute_dtype=torch.bfloat16, **hp)
    lay_f32 = MaddpgUpdateLauncher(a, ow, k, 5, h, b, "cuda", **hp)
    weights = lay_bf16.layout.pack(trained, targets).cuda()
    grads = torch.empty(lay_bf16.layout.off_ta, device="cuda")
    metrics = torch.empty(3, device="cuda")
    ms, _ = cuda_time(lambda: lay_bf16.launch(weights, rows, grads, metrics), REPEATS)
    ms32, _ = cuda_time(lambda: lay_f32.launch(weights, rows, grads, metrics), REPEATS)
    plain_ms, _ = cuda_time(lambda: plain_maddpg_update(trained, targets, rows, mw=5,
                                                        compute_dtype=torch.bfloat16, **hp),
                            REPEATS)
    split = _split_rows(rows, a, ow, k)
    lib_ms, _ = cuda_time(lambda: maddpg_xla_grads(trained, targets, *split, mw=5, cw=k - 5, **hp),
                          REPEATS)
    bound = bound_ms(OPS[f"maddpg_update_bf16_kernel[{name}{tag}]"], b * a, 0, 1,
                     4 * (b * width + 2 * a * (nw + nc) + a * (nw + nc + 3)))
    print(f"K9-bf16 ({name}{tag}, trained params) {ms:.4f} ms per call on the packed buffers "
          f"(batch {b}), K9 {ms32:.4f} ms on the same buffers; plain bf16 {plain_ms:.3f} ms, "
          f"autograd of the losses in float32 {lib_ms:.3f} ms; bound {bound[0]:.5f} ms by "
          f"{bound[1]} ({ms / bound[0]:.2f}x); issue floor {bound[2]:.5f} ms")
    return {"max_abs_err": max(r["max_abs_err"] for r in row.values()), "ms": ms,
            "float32_kernel_ms": ms32, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "gates": row}


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


K9_KERNELS = ("maddpg_target_actions_kernel", "maddpg_td_kernel", "maddpg_update_kernel",
              "maddpg_reduce_kernel")
K9_BF16_KERNELS = ("maddpg_round_bf16_kernel", "maddpg_target_td_bf16_kernel",
                   "maddpg_grad_bf16_kernel", "maddpg_reduce_bf16_kernel")


def profile_maddpg_update(name: str, run, params, info, kernels=K9_KERNELS):
    """One MADDPG update chunk (25 updates) of path d, d2 or d3 (``name``),
    or of path d4 with ``kernels`` K9_BF16_KERNELS, as the runner runs it
    (``packed_step`` on the packed state) under torch.profiler: the device
    time per update of the four ``kernels`` (K9's by default), the
    device's busy share of the chunk's CUDA-event time, the kernel launches
    per update, each of the four ``kernels``' device records per update (a
    call launches each once; a record the profiler dropped shows below 1)
    and the kernels that take the most device time. It gates nothing;
    without device events it says so. -> {device_ms_per_update,
    device_split_ms, launches_per_update, launches_per_call_by_kernel,
    idle_share}, or {} unmeasured."""
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

    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not device:
        print(f"MADDPG update chunk on {name} under torch.profiler: device time not measured "
              "(no device events)")
        return {}
    busy_ms = sum(device_us(e) for e in device) / 1e3
    k9_ms = {n: sum(device_us(e) for e in device if n in e.key) / 1e3 / h for n in kernels}
    per_update = sum(e.count for e in device) / h
    k9_launches = {n: sum(e.count for e in device if n in e.key) / h for n in kernels}
    print(f"MADDPG update chunk on {name} under torch.profiler ({h} updates of the packed "
          f"state, {wall_ms:.3f} ms by CUDA events): device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.4f} of the time, idle {1 - busy_ms / wall_ms:.4f}); the update "
          f"kernels' device time per update {sum(k9_ms.values()):.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in k9_ms.items())
          + f"); {per_update:.1f} kernel launches per update; the update kernels' device records "
            "per update (a call launches each once): "
          + ", ".join(f"{k} {v:.2f}" for k, v in k9_launches.items()))
    top = sorted(device, key=device_us, reverse=True)[:6]
    print("  most device time: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms in {e.count}" for e in top))
    return {"device_ms_per_update": sum(k9_ms.values()), "device_split_ms": k9_ms,
            "launches_per_update": per_update, "launches_per_call_by_kernel": k9_launches,
            "idle_share": 1 - busy_ms / wall_ms}


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


def template_rows_k3(k3_ms, k3_device_ms, k3_by, k3_err, plain_k3_ms, k3_group_ms,
                     regs) -> dict:
    """K3's bound at each shape of path e, printed beside its time by CUDA
    events and in device time -> {scenario: the kernels line's by_scenario
    entry (the wide shape's numbers suffixed with its env count; the rule's
    G, device time over the bound, the times at every G by
    CUDA events at N_ENVS, the registers and spills of each <S, G>)}."""
    from mpe_tpu_torch.ops.fused_trajectory import traj_group
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

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
        row = k3_rows.setdefault(name, {
            "launches": k3_by[name], "max_abs_err": k3_err[name], "plain_ms": plain_k3_ms[name],
            "ms_by_group": k3_group_ms[name],
            "registers_spill_bytes": registers_of(regs, "trajectory_kernel", name)})
        suffix = "" if n == N_ENVS else f"_{n}"
        row.update({f"ms{suffix}": ms, f"device_ms{suffix}": dev, f"bound_ms{suffix}": b,
                    f"bound_by{suffix}": by, f"ratio{suffix}": dev / b if dev else None,
                    f"group{suffix}": traj_group(kernel_scenario(name), n)})
    return k3_rows


def check_trajectory_groups() -> dict:
    """K3 (``trajectory_cuda``) at every G of ``GROUPS`` against G = 1, every
    output equal bit for bit, on all nine scenarios at TRAJ_CHECK (two block
    offsets) and at N_ENVS x TRAJ, where each G is also timed by CUDA events
    around the call (median of REPEATS) -> {scenario: {G: ms}}."""
    import torch

    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_trajectory import GROUPS, trajectory_cuda
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    shapes = (((TRAJ_CHECK["n_envs"], TRAJ_CHECK["n_steps"], TRAJ_CHECK["horizon"],
                TRAJ_CHECK["block_envs"], TRAJ_CHECK["t_chunk"]), (0, 1)),
              ((N_ENVS, TRAJ["n_steps"], TRAJ["horizon"], TRAJ["block_envs"], TRAJ["t_chunk"]),
               (0,)))
    times = {}
    for name in ALL_SCENARIOS:
        kscn = kernel_scenario(name)
        consts = _build.kernel_params(kscn)
        times[name] = {}
        for args, offsets in shapes:
            for offset in offsets:
                def call(group):
                    return trajectory_cuda(kscn, *args, 9, offset, "cuda", group=group,
                                           consts=consts)

                one = call(1)
                for group in GROUPS:
                    if group > 1:
                        got = call(group)
                        bad = [k for k, a, b in zip(("obs", "act", "rew", "pos", "vel"), got,
                                                    one) if not torch.equal(a, b)]
                        assert not bad, (f"K3 ({name}, {args[0]} envs, block offset {offset}) "
                                         f"at G {group}: {bad} differ from G = 1")
                        del got
                    if args[0] == N_ENVS:
                        times[name][group] = cuda_time(lambda: call(group), REPEATS)[0]
                del one
        print(f"K3 ({name}) at every G equal to G = 1 bit for bit at "
              f"{TRAJ_CHECK['n_envs']} x {TRAJ_CHECK['n_steps']} (two block offsets) and "
              f"{N_ENVS} x {TRAJ['n_steps']}; ms at {N_ENVS} x {TRAJ['n_steps']} by CUDA events "
              "around the call, by G: " + ", ".join(f"{k} {v:.4f}"
                                                   for k, v in times[name].items()))
    return times


def check_iteration(label: str, stp, st0) -> float:
    """One trainer iteration with the kernels against the same iteration with
    the plain versions: params within TOL["params"], metrics within
    METRIC_RTOL -> the largest abs error of a param."""
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
    return it_err


def gate_policy_at(name: str, h: int, seed: int) -> tuple[float, float]:
    """K5 and K4 at HIDDEN_GATE's shape on ``name`` with an init_policy actor
    of hidden width ``h`` (O(1) logits): actions equal and values within
    TOL of the plain versions, another tile equal bit for bit -> (K5's,
    K4's max abs err)."""
    import torch

    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.ops.fused_policy import (POLICY_TILES, _kernel_weights,
                                                fused_policy_rollout, fused_policy_trajectory,
                                                policy_rollout_cuda, policy_tile,
                                                policy_traj_cuda)
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    g = HIDDEN_GATE
    n, steps, hor = g["n_envs"], g["n_steps"], g["horizon"]
    kscn = kernel_scenario(name)
    _, ow, c, _, _ = widths(name)
    tag = f"{name}, hidden {h}"
    actor = {k: {q: x.cuda() for q, x in layer.items()} for k, layer in
             init_policy(torch.Generator().manual_seed(seed), ow, 5 + c, hidden=h).items()}
    weights = _kernel_weights(actor, "cuda")
    traj = fused_policy_trajectory(name, actor, n, steps, horizon=hor,
                                   block_envs=g["block_envs"], t_chunk=g["t_chunk"])
    got, ref = traj(4, actor), traj.plain(4, actor)
    labels = ("obs", "act", "cact", "rew", "last_obs") if c else ("obs", "act", "rew", "last_obs")
    report_actions(f"K5 ({tag}, moves)", got[1], ref[1])
    k5 = check(f"K5 ({tag}, {n} envs x {steps} steps)",
               {k: max_err(x, y) for k, x, y in zip(labels, got, ref)})
    tile = policy_tile(kscn, n, "traj", hidden=h)
    alt = other_tile(POLICY_TILES, tile)
    same_bits(f"K5 ({tag}) at tile {alt} against tile {tile}",
              policy_traj_cuda(kscn, weights, n, steps, hor, g["block_envs"], g["t_chunk"], 4, 0,
                               "cuda", tile=alt), got)
    run = fused_policy_rollout(name, actor, n, steps, horizon=hor, block_envs=g["block_envs"])
    got, ref = run(6, actor), run.plain(6, actor)
    k4 = check(f"K4 ({tag}, {n} envs x {steps} steps)",
               {k: max_err(x, y) for k, x, y in zip(("ret", "pos", "episodes"), got, ref)})
    tile = policy_tile(kscn, n, "rollout", hidden=h)
    alt = other_tile(POLICY_TILES, tile)
    same_bits(f"K4 ({tag}) at tile {alt} against tile {tile}",
              policy_rollout_cuda(kscn, weights, n, steps, hor, g["block_envs"], 6, 0, "cuda",
                                  tile=alt), got)
    return k5, k4


def gate_update_at(label: str, build, name: str, h: int, seed: int, compute_dtype=None,
                   tol: float = GRAD_TOL) -> float:
    """K6 or K7 (or a bf16 twin: ``build`` and ``compute_dtype``) on the
    epoch-0 batch of a trainer of hidden width ``h`` at HIDDEN_GATE's envs
    and on it with both clips binding, each leaf within ``tol`` of its
    largest entry -> the max abs err."""
    import torch

    g = HIDDEN_GATE
    tag = f"{name}, hidden {h}"
    step = build(name, compute_dtype=compute_dtype,
                 **dict(TRAIN, n_envs=g["n_envs"], horizon=g["horizon"], hidden=h))
    params = step.init_params(torch.Generator().manual_seed(seed))
    batch, clipped, _ = update_batches(step, params, f"{label} ({tag})")
    gated = ("vloss", "entropy")
    return max(check_update(f"{label} ({tag}, trainer batch)", step.update, params, batch, gated,
                            tol),
               check_update(f"{label} ({tag}, clip-binding batch)", step.update, params, clipped,
                            ("pg",) + gated, tol))


def hidden_widths_phase(wrappers) -> dict:
    """Phase 3b (the module docstring): K4-K9, K6-bf16, K7-bf16 and K9-bf16 at
    each width of HIDDEN_PHASE on HIDDEN_NAMES against their plain versions,
    then the trainers of
    HIDDEN_TRAINERS and the MADDPG runner at HIDDEN_MADDPG, their launches
    read -> {kernel: {hidden: {scenario: max abs err}}, "launches": {...},
    "trainer_max_abs_err": {...}, "seconds": s}."""
    import torch

    from mpe_tpu_torch.learner import (build_fused_maddpg_runner, build_fused_mappo_step,
                                       build_fused_ppo_step)
    from mpe_tpu_torch.learner.maddpg import collect_t_chunk, init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    t0 = time.perf_counter()
    kernels = ("policy_traj_kernel", "policy_rollout_kernel", "ppo_update_kernel",
               "mappo_update_kernel", "maddpg_traj_kernel", "maddpg_update_kernel",
               "ppo_update_bf16_kernel", "mappo_update_bf16_kernel", "maddpg_update_bf16_kernel")
    out = {k: {} for k in kernels}
    bf16 = torch.bfloat16
    for h in HIDDEN_PHASE:
        errs = {k: out[k].setdefault(h, {}) for k in kernels}
        for i, name in enumerate(HIDDEN_NAMES):
            kscn = kernel_scenario(name)
            a, ow, c, _, _ = widths(name)
            tag = f"{name}, hidden {h}"
            # K5 and K4: an init_policy actor of this width (O(1) logits)
            errs["policy_traj_kernel"][name], errs["policy_rollout_kernel"][name] = \
                gate_policy_at(name, h, 40 + h + i)
            # K6 and K7, and their bf16 twins, on the batch of a trainer of this width
            for kernel, label, build, cd, tol in (
                    ("ppo_update_kernel", "K6", build_fused_ppo_step, None, GRAD_TOL),
                    ("mappo_update_kernel", "K7", build_fused_mappo_step, None, GRAD_TOL),
                    ("ppo_update_bf16_kernel", "K6-bf16", build_fused_ppo_step, bf16,
                     BF16_GRAD_TOL),
                    ("mappo_update_bf16_kernel", "K7-bf16", build_fused_mappo_step, bf16,
                     BF16_GRAD_TOL)):
                errs[kernel][name] = gate_update_at(label, build, name, h, 50 + h + i, cd, tol)
            # K8 and K9: MADDPG nets of this width, the actor's head at O(1)
            mp = {k: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
                  for k, net in init_maddpg(torch.Generator().manual_seed(60 + h + i), ow, 5 + c,
                                            a, hidden=h).items()}
            mp["actor"]["out"]["w"] = mp["actor"]["out"]["w"] * 100.0
            mn, mh = MADDPG["n_envs"], MADDPG["horizon"]
            t_chunk = collect_t_chunk(mh)
            tens = fused_maddpg.fused_maddpg_trajectory(name, mp["actor"], mn, mh, horizon=mh,
                                                        eps_greedy=0.1, block_envs=BLOCK_ENVS,
                                                        t_chunk=t_chunk)
            got, ref = tens(3, mp["actor"]), tens.plain(3, mp["actor"])
            report_actions(f"K8 ({tag})", got[1], ref[1])
            errs["maddpg_traj_kernel"][name] = check(
                f"K8 ({tag}, {mn} envs x {mh} steps)",
                {k: max_err(x, y) for k, x, y in zip(("obs", "act", "rew", "obs2"), got, ref)})
            tile = fused_maddpg.maddpg_tile(kscn, mn, hidden=h)
            alt = other_tile(fused_maddpg.MADDPG_TILES, tile)
            same_bits(f"K8 ({tag}) at tile {alt} against tile {tile}",
                      fused_maddpg.maddpg_traj_cuda(
                          kscn, fused_maddpg._kernel_weights(mp["actor"], "cuda"), mn, mh, mh,
                          BLOCK_ENVS, t_chunk, 0.1, 3, 0, False, "cuda", tile=alt), got)
            rows = replay_rows(*got).reshape(mn * mh, -1)
            del got, ref
            errs["maddpg_update_kernel"][name] = gate_maddpg_update(name, mp, rows, tag)[0]
            # K9-bf16 on MADDPG["batch"] of the same rows, targets = params + 0.1 N(0, 1)
            gen = torch.Generator("cuda").manual_seed(9)
            sel = rows[torch.randint(0, rows.shape[0], (MADDPG["batch"],), generator=gen,
                                     device="cuda")].contiguous()
            tgt = {k: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen, device="cuda")
                           for w, x in layer.items()} for q, layer in net.items()}
                   for k, net in mp.items()}
            errs["maddpg_update_bf16_kernel"][name] = gate_maddpg_bf16(name, mp, tgt, sel,
                                                                       tag)["max_abs_err"]
            del rows, sel
    # the trainers at the widths the repo runs them, launches read after each
    out["launches"], out["trainer_max_abs_err"] = {}, {}
    for label, h in HIDDEN_TRAINERS:
        build = build_fused_ppo_step if label == "PPO" else build_fused_mappo_step
        kernel = "ppo_update_kernel" if label == "PPO" else "mappo_update_kernel"
        tag = f"{label} on simple_spread at hidden {h}"
        step = build("simple_spread", **dict(TRAIN, hidden=h))
        st0 = step.init_state(step.init_params(torch.Generator().manual_seed(70 + h)))
        zero_launches(wrappers)
        _, metrics = step(st0, 0)
        torch.cuda.synchronize()
        out["launches"][tag] = read_launches(wrappers, ["policy_traj_kernel", kernel], tag)
        assert all(math.isfinite(float(v)) for v in metrics.values()), f"{tag}: {metrics}"
        out["trainer_max_abs_err"][tag] = check_iteration(tag, step, st0)
    tag = f"MADDPG on simple_spread at hidden {HIDDEN_MADDPG}"
    run = build_fused_maddpg_runner("simple_spread", hidden=HIDDEN_MADDPG, **MADDPG)
    zero_launches(wrappers)
    params, info = run(HIDDEN_MADDPG_CHUNKS * MADDPG["horizon"], seed=0, actor_start=0)
    torch.cuda.synchronize()
    out["launches"][tag] = read_launches(wrappers, ["maddpg_traj_kernel", "maddpg_update_kernel"],
                                         tag)
    assert bool(torch.isfinite(info["mean_reward"]).all() and
                torch.isfinite(info["critic_loss"]).all()), info
    out["trainer_max_abs_err"][tag] = check_update_chunk("simple_spread", run, params, info)
    del run, params, info
    out["seconds"] = time.perf_counter() - t0
    print(f"hidden widths {HIDDEN_PHASE}: every gate passed in {out['seconds']:.1f} s")
    return out


def wide_widths_phase(wrappers, regs_at: dict) -> dict:
    """Phase 3c (the module docstring): K4-K7, K6-bf16 and K7-bf16 at each
    width of WIDE_PHASE -> {kernel: {hidden: row}} (each row as the kernels
    line's: launches on the wide paths, max abs err over the gates, ms, plain
    ms, bound, library ms, registers by scenario of WIDE_NAMES; K4 and K5
    their tile; the bf16 kernels the float32 kernel's ms beside), "paths":
    {path: transitions/s and ms by phase}, "seconds": s."""
    import functools

    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops.fused_policy import (fused_policy_rollout, fused_policy_trajectory,
                                                policy_tile)
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    t0 = time.perf_counter()
    name = "simple_spread"
    kscn = kernel_scenario(name)
    kernels = {"policy_traj_kernel": "policy_traj_kernel",
               "policy_rollout_kernel": "policy_rollout_kernel", "ppo_update_kernel": "ppo",
               "mappo_update_kernel": "mappo", "ppo_update_bf16_kernel": "ppo_bf16",
               "mappo_update_bf16_kernel": "mappo_bf16"}
    out = {k: {} for k in kernels}
    out["paths"] = {}
    bf16 = torch.bfloat16
    for h in WIDE_PHASE:
        errs = {k: {} for k in kernels}
        for i, gname in enumerate(WIDE_NAMES):
            errs["policy_traj_kernel"][gname], errs["policy_rollout_kernel"][gname] = \
                gate_policy_at(gname, h, 80 + h + i)
            errs["ppo_update_kernel"][gname] = gate_update_at("K6", build_fused_ppo_step, gname,
                                                              h, 90 + h + i)
            errs["mappo_update_kernel"][gname] = gate_update_at("K7", build_fused_mappo_step,
                                                                gname, h, 90 + h + i)
            errs["ppo_update_bf16_kernel"][gname] = gate_update_at(
                "K6-bf16", build_fused_ppo_step, gname, h, 90 + h + i, bf16, BF16_GRAD_TOL)
            errs["mappo_update_bf16_kernel"][gname] = gate_update_at(
                "K7-bf16", build_fused_mappo_step, gname, h, 90 + h + i, bf16, BF16_GRAD_TOL)
        rows = {k: {"max_abs_err": max(e.values()), "registers_spill_bytes": {
            n: registers_of(regs_at[h], kernels[k], n) for n in WIDE_NAMES}}
            for k, e in errs.items()}
        # paths b and b2 at this width; K6 and K7 timed and gated on the last
        # iteration's params at the path's shape
        for label, build, kind in (("PPO", build_fused_ppo_step, "ppo"),
                                   ("MAPPO", build_fused_mappo_step, "mappo")):
            kernel, key = f"{kind}_update_kernel", f"{label} on {name} at hidden {h}"
            launches, step, _, state, phases, last = training_path(
                wrappers, kscn, build, key, ["policy_traj_kernel", kernel], WIDE_ITERS, h)
            total = sum(phases.values())
            out["paths"][key] = {"transitions_per_s": step.n_transitions / (total * 1e-3),
                                 "ms_per_iteration_by_phase": phases, "iterations": WIDE_ITERS,
                                 "launches": launches, "last_iteration": last}
            rows["policy_traj_kernel"]["launches"] = (
                rows["policy_traj_kernel"].get("launches", 0) + launches["policy_traj_kernel"])
            params = state[0]
            batch, clipped, lib_batch = update_batches(step, params, key)
            gated = ("vloss", "entropy")
            err = max(check_update(f"K{6 if kind == 'ppo' else 7} ({key}, trainer batch)",
                                   step.update, params, batch, gated),
                      check_update(f"K{6 if kind == 'ppo' else 7} ({key}, clip-binding batch)",
                                   step.update, params, clipped, ("pg",) + gated))
            ms, _ = cuda_time(lambda: step.update(params, *batch), REPEATS)
            plain_ms, _ = cuda_time(lambda: step.update.plain(params, *batch), REPEATS)
            lib_ms, _ = cuda_time(lambda: library_ppo_grads(step, params, lib_batch), REPEATS)
            device = update_device_ms(lambda: step.update(params, *batch),
                                      2 if kind == "ppo" else 4)
            # the 3xTF32 kernel's own bound, and the fp32 CUDA cores' beside it
            bound = update_bound(kernel, name, batch, h, tf32=True)
            bound32 = update_bound(kernel, name, batch, h)
            print(f"{key}: K{6 if kind == 'ppo' else 7} {ms:.4f} ms a call (device "
                  f"{fmt_ms(device)}), plain {plain_ms:.3f} ms, autograd of the trainer's loss "
                  f"{lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} in 3xTF32 "
                  f"({ms / bound[0]:.2f}x), {bound32[0]:.4f} ms on the fp32 cores "
                  f"({ms / bound32[0]:.2f}x)")
            assert ms > bound[0], f"{key}: the kernel reads faster than its bound"
            rows[kernel].update(launches=launches[kernel],
                                max_abs_err=max(rows[kernel]["max_abs_err"], err), ms=ms,
                                device_ms=device, plain_ms=plain_ms, bound_ms=bound[0],
                                bound_by=bound[1], bound_fp32_ms=bound32[0],
                                bound_fp32_by=bound32[1], library_ms=lib_ms,
                                timed_on=f"{name}, path {'b' if kind == 'ppo' else 'b2'}'s "
                                         f"last batch at hidden {h}")
            del batch, clipped, lib_batch
            if kind == "ppo":
                actor = {"l1": params["l1"], "l2": params["l2"], "out": params["pi"]}
        # path b5 at this width: the bf16 trainers; K6-bf16 and K7-bf16 gated
        # and timed on the last iteration's batch beside the float32 wide
        # kernel on the same batch
        for label, kind in BF16_TRAINERS:
            build = build_fused_ppo_step if kind == "ppo" else build_fused_mappo_step
            kernel, key = f"{kind}_update_bf16_kernel", f"{label} on {name} at hidden {h}"
            tag = "K6-bf16" if kind == "ppo" else "K7-bf16"
            launches, step, _, state, phases, last = training_path(
                wrappers, kscn, functools.partial(build, compute_dtype=bf16), key,
                ["policy_traj_kernel", kernel], WIDE_ITERS, h)
            assert wrappers[f"{kind}_update_kernel"].launches == 0, \
                f"{key}: the float32 kernel launched on the bf16 path"
            total = sum(phases.values())
            out["paths"][key] = {"transitions_per_s": step.n_transitions / (total * 1e-3),
                                 "ms_per_iteration_by_phase": phases, "iterations": WIDE_ITERS,
                                 "launches": launches, "last_iteration": last}
            rows["policy_traj_kernel"]["launches"] += launches["policy_traj_kernel"]
            params = state[0]
            s32 = build(kscn, **dict(TRAIN, hidden=h))
            batch, clipped, lib_batch = update_batches(step, params, key)
            gated = ("vloss", "entropy")
            err = max(check_update(f"{tag} ({key}, trainer batch)", step.update, params, batch,
                                   gated, BF16_GRAD_TOL),
                      check_update(f"{tag} ({key}, clip-binding batch)", step.update, params,
                                   clipped, ("pg",) + gated, BF16_GRAD_TOL))
            ms, _ = cuda_time(lambda: step.update(params, *batch), REPEATS)
            ms32, _ = cuda_time(lambda: s32.update(params, *batch), REPEATS)
            plain_ms, _ = cuda_time(lambda: step.update.plain(params, *batch), REPEATS)
            lib_ms, _ = cuda_time(lambda: library_ppo_grads(step, params, lib_batch), REPEATS)
            # a pass: the weights' rounding, the gradient kernel, the reduce
            device = update_device_ms(lambda: step.update(params, *batch),
                                      3 if kind == "ppo" else 6)
            bound = update_bound(kernel, name, batch, h)
            print(f"{key}: {tag} {ms:.4f} ms a call (device {fmt_ms(device)}), the float32 "
                  f"kernel {ms32:.4f} ms, plain {plain_ms:.3f} ms, autograd of the plain bf16 "
                  f"loss {lib_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
                  f"({ms / bound[0]:.2f}x)")
            rows[kernel].update(launches=launches[kernel],
                                max_abs_err=max(rows[kernel]["max_abs_err"], err), ms=ms,
                                device_ms=device, float32_kernel_ms=ms32, plain_ms=plain_ms,
                                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
                                timed_on=f"{name}, path b5's {label} last batch at hidden {h}")
            del batch, clipped, lib_batch, s32, step, state
        # K5 at the training shape and K4 at path c's on path b's actor
        n, t = TRAIN["n_envs"], TRAIN["n_steps"]
        traj = fused_policy_trajectory(name, actor, n, t, horizon=TRAIN["horizon"],
                                       block_envs=TRAIN["block_envs"], t_chunk=TRAIN["t_chunk"])
        k5_ms, got = cuda_time(lambda: traj(5, actor), REPEATS)
        plain_ms, ref = cuda_time(lambda: traj.plain(5, actor), 1, warm_up=False)
        report_actions(f"K5 (path b's actor at hidden {h}, {n} x {t})", got[1], ref[1])
        err = check(f"K5 (path b's actor at hidden {h}, {n} x {t})",
                    {k: max_err(x, y) for k, x, y in zip(("obs", "act", "rew", "last_obs"), got,
                                                         ref)})
        b5, b4 = policy_bounds(name, n, t, TRAIN["horizon"], h)
        rows["policy_traj_kernel"].update(
            max_abs_err=max(rows["policy_traj_kernel"]["max_abs_err"], err), ms=k5_ms,
            plain_ms=plain_ms, bound_ms=b5[0], bound_by=b5[1], library_ms=None,
            tile=policy_tile(kscn, n, "traj", hidden=h),
            timed_on=f"{name}, path b's actor at {n} envs x {t} steps")
        zero_launches(wrappers)
        k4 = fused_policy_rollout(name, actor, N_ENVS, EVAL_STEPS, horizon=EVAL_HORIZON,
                                  block_envs=BLOCK_ENVS)
        k4_ms, got = cuda_time(lambda: k4(0, actor), REPEATS)
        k4_launches = read_launches(wrappers, ["policy_rollout_kernel"],
                                    f"evaluation at hidden {h}")["policy_rollout_kernel"]
        per_ep_mean, per_ep_se = mean_se(got[0].mean(0) / got[2][0])
        # held to the plain version at EVAL_GATE_STEPS (its 1000-step loop
        # alone took 16-20 s at these widths)
        gate = fused_policy_rollout(name, actor, N_ENVS, EVAL_GATE_STEPS, horizon=EVAL_HORIZON,
                                    block_envs=BLOCK_ENVS)
        got = gate(0, actor)
        plain_ms, ref = cuda_time(lambda: gate.plain(0, actor), 1, warm_up=False)
        err = check(f"K4 (path b's actor at hidden {h}, {N_ENVS} x {EVAL_GATE_STEPS})",
                    {k: max_err(x, y) for k, x, y in zip(("ret", "pos", "episodes"), got, ref)})
        b4 = policy_bounds(name, N_ENVS, EVAL_STEPS, EVAL_HORIZON, h)[1]
        rows["policy_rollout_kernel"].update(
            launches=k4_launches, max_abs_err=max(rows["policy_rollout_kernel"]["max_abs_err"],
                                                  err),
            ms=k4_ms, plain_ms=plain_ms, bound_ms=b4[0], bound_by=b4[1], library_ms=None,
            tile=policy_tile(kscn, N_ENVS, "rollout", hidden=h),
            timed_on=f"{name}, path b's actor at {N_ENVS} envs x {EVAL_STEPS} steps",
            plain_and_gate_on=f"{N_ENVS} envs x {EVAL_GATE_STEPS} steps",
            mean_return_per_episode=[per_ep_mean, per_ep_se])
        print(f"hidden {h}: K5 {k5_ms:.4f} ms ({n} x {t}, bound {b5[0]:.4f} ms by {b5[1]}), K4 "
              f"{k4_ms:.4f} ms ({N_ENVS} x {EVAL_STEPS}, bound {b4[0]:.4f} ms by {b4[1]}; mean "
              f"return per episode {per_ep_mean:.5f} +- {per_ep_se:.5f})")
        del got, ref
        # the examples that take --hidden, at this width (K4 only)
        out["examples"] = out.get("examples", {})
        for module, argv in WIDE_EXAMPLES:
            label = f"{module} --hidden {h}"
            _, seconds, launched = run_example(wrappers, label, module,
                                               argv + ["--hidden", str(h)],
                                               ("policy_rollout_kernel",))
            out["examples"][label] = {"seconds": seconds, "launches": launched}
        for k, row in rows.items():
            out[k][h] = row
    out["seconds"] = time.perf_counter() - t0
    print(f"hidden widths {WIDE_PHASE}: every gate passed in {out['seconds']:.1f} s")
    return out


def wide_maddpg_phase(wrappers, regs_at: dict) -> dict:
    """Phase 3d (the module docstring): K8 and K9 at each width of WIDE_PHASE
    on WIDE_MADDPG_NAMES at path d's shape against their plain versions and
    timed, then the MADDPG runner at that width on each for
    WIDE_MADDPG_CHUNKS chunks (K8, K9; actor_start 0), K9 gated again on its
    ring with the trained params; then K9-bf16 on K8's rows with fresh params
    and the runner's trained params (``check_maddpg_bf16``: gated against
    the plain bf16 version, timed beside K9 on the same buffers, the plain
    bf16 version, autograd of the losses and its bound) and its update chunk
    with K8's collection for WIDE_MADDPG_CHUNKS chunks (``bf16_maddpg_path``,
    actor_start 0: K9-bf16 once an update, K9 never) -> {kernel: {hidden:
    row}} (each row as the kernels line's: launches on the runs, max abs err
    over the gates, ms, plain ms, bound, library ms (K9, K9-bf16: autograd of
    the losses), registers by scenario; K8 its tile, K9 its device ms an
    update in the runner's profiled chunk, K9-bf16 K9's ms on the same
    buffers and its gates), "paths": {path: transitions/s and ms by phase},
    "seconds": s."""
    import torch

    from mpe_tpu_torch.learner.maddpg import collect_t_chunk, init_maddpg
    from mpe_tpu_torch.ops import _build, fused_maddpg
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    t0 = time.perf_counter()
    kernels = ("maddpg_traj_kernel", "maddpg_update_kernel", "maddpg_update_bf16_kernel")
    regs_key = {"maddpg_traj_kernel": "maddpg_traj_kernel",
                "maddpg_update_kernel": "maddpg_update",
                "maddpg_update_bf16_kernel": "maddpg_update_bf16"}
    out = {k: {} for k in kernels}
    out["paths"] = {}
    mn, mh, mb = MADDPG["n_envs"], MADDPG["horizon"], MADDPG["batch"]
    t_chunk = collect_t_chunk(mh)
    for h in WIDE_PHASE:
        rows = {k: {"launches": 0, "max_abs_err": 0.0, "by_scenario": {},
                    "registers_spill_bytes": {n: registers_of(regs_at[h], regs_key[k], n)
                                              for n in WIDE_MADDPG_NAMES}} for k in kernels}
        for i, name in enumerate(WIDE_MADDPG_NAMES):
            kscn = kernel_scenario(name)
            a, ow, k, width, nw, _ = maddpg_widths(name, h)
            tag = f"{name}, hidden {h}"
            # K8: MADDPG nets of this width, the actor's head at O(1), both
            # forms against the plain version, another tile bit for bit
            mp = {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
                  for n, net in init_maddpg(torch.Generator().manual_seed(110 + h + i), ow, k,
                                            a, hidden=h).items()}
            mp["actor"]["out"]["w"] = mp["actor"]["out"]["w"] * 100.0
            kw = dict(horizon=mh, eps_greedy=0.1, block_envs=BLOCK_ENVS, t_chunk=t_chunk)
            tens = fused_maddpg.fused_maddpg_trajectory(name, mp["actor"], mn, mh, **kw)
            emit = fused_maddpg.fused_maddpg_trajectory(name, mp["actor"], mn, mh,
                                                        emit_rows=True, **kw)
            got, ref = tens(3, mp["actor"]), tens.plain(3, mp["actor"])
            report_actions(f"K8 ({tag})", got[1], ref[1])
            errs = {key: max_err(x, y) for key, x, y in zip(("obs", "act", "rew", "obs2"), got,
                                                            ref)}
            got_rows = emit(3, mp["actor"])
            errs["rows"] = max_err(got_rows, replay_rows(*got))
            err8 = check(f"K8 ({tag}, {mn} envs x {mh} steps, both forms)", errs)
            tile = fused_maddpg.maddpg_tile(kscn, mn, hidden=h)
            alt = other_tile(fused_maddpg.MADDPG_TILES, tile)
            weights = fused_maddpg._kernel_weights(mp["actor"], "cuda")
            for rows_form, want in ((False, got), (True, got_rows)):
                same_bits(f"K8 ({tag}, rows {rows_form}) at tile {alt} against tile {tile}",
                          fused_maddpg.maddpg_traj_cuda(kscn, weights, mn, mh, mh, BLOCK_ENVS,
                                                        t_chunk, 0.1, 3, 0, rows_form, "cuda",
                                                        tile=alt), want)
            ms8, _ = cuda_time(lambda: emit(1, mp["actor"]), REPEATS)
            plain8, _ = cuda_time(lambda: emit.plain(1, mp["actor"]), 1)
            b8 = bound_ms(maddpg_ops(name, h), mn * mh, mn * 2, mn,
                          4 * (mn * mh * width + a * nw))
            print(f"K8 ({tag}) {ms8:.4f} ms ({mn} envs x {mh} steps, rows form, tile {tile}), "
                  f"plain {plain8:.1f} ms; bound {b8[0]:.4f} ms by {b8[1]} "
                  f"({ms8 / b8[0]:.2f}x); issue floor {b8[2]:.4f} ms")
            # K9 on MADDPG["batch"] of the rows K8 collected, then timed beside its
            # plain version and autograd of the losses, its device time a call
            flat = got_rows.reshape(mn * mh, width)
            err9, ms9, plain9, lib9, b9, tree9 = check_maddpg_update(name, mp, flat, tag)
            del got, ref, got_rows, tens, emit
            # the runner at this width: WIDE_MADDPG_CHUNKS chunks by phase, its
            # launches read, each of K9's kernels counted by the library where
            # it launched it; K9 gated on its ring with the trained params
            k9_so = _build.library("mpe_maddpg.cu", h)
            k9_so.mpe_maddpg_update_launched(-1)
            (launches, by, run, params, info, rate, collect_ms,
             update_ms) = maddpg_path(wrappers, name, WIDE_MADDPG_CHUNKS, hidden=h, actor_start=0)
            by_kernel = {q: k9_so.mpe_maddpg_update_launched(j)
                         for j, q in enumerate(K9_WIDE_KERNELS)}
            calls9 = by["maddpg_update_kernel"][name]
            assert all(n == calls9 for n in by_kernel.values()), \
                f"K9 ({tag}): the runner's {calls9} calls launched {by_kernel}"
            ring = info["buffer"]
            err_ring = check_maddpg_update(name, params, ring.data[:ring.size],
                                           f"{tag}, the runner's ring and params")[0]
            prof = profile_maddpg_update(name, run, params, info, K9_WIDE_KERNELS)
            key = f"MADDPG on {name} at hidden {h}"
            out["paths"][key] = {"transitions_per_s": rate, "chunks": WIDE_MADDPG_CHUNKS,
                                 "ms_per_chunk_by_phase": {"collect": collect_ms,
                                                           "update": update_ms},
                                 "launches": launches, **prof}
            # K9-bf16 at this width: on K8's rows with fresh and the runner's
            # trained params, then its update chunk with K8's collection
            bf16_row = check_maddpg_bf16(name, params, flat, h)
            d4w = bf16_maddpg_path(wrappers, {name: (run, params, info, rate)}, (name,),
                                   WIDE_MADDPG_CHUNKS, h, 0)[name]
            prof_b = profile_maddpg_update(
                name, types.SimpleNamespace(update_chunk=d4w["chunk"]), d4w["params"],
                {q: d4w[q] for q in ("targets", "opt_states", "buffer")}, K9_BF16_WIDE_KERNELS)
            out["paths"][f"MADDPG-bf16 on {name} at hidden {h}"] = {
                "transitions_per_s": d4w["transitions_per_s"], "chunks": WIDE_MADDPG_CHUNKS,
                "ms_per_chunk_by_phase": {"collect": d4w["collect_ms"],
                                          "update": d4w["update_ms"]},
                "launches": d4w["launches"], "last_critic_loss": d4w["last_critic_loss"],
                "float32_last_critic_loss": d4w["float32_last_critic_loss"], **prof_b}
            del run, params, info, ring, flat, d4w
            scn = {"maddpg_traj_kernel": dict(
                       launches=by["maddpg_traj_kernel"][name], max_abs_err=err8, ms=ms8,
                       plain_ms=plain8, bound_ms=b8[0], bound_by=b8[1], library_ms=None,
                       tile=tile, timed_on=f"{mn} envs x {mh} steps, rows form"),
                   "maddpg_update_kernel": dict(
                       launches=by["maddpg_update_kernel"][name],
                       max_abs_err=max(err9, err_ring), ms=ms9,
                       device_ms_per_update=prof.get("device_ms_per_update", "not measured"),
                       plain_ms=plain9, bound_ms=b9[0], bound_by=b9[1], library_ms=lib9,
                       from_trees_ms=tree9, timed_on=f"batch {mb} of K8's rows",
                       launches_by_kernel=by_kernel,
                       device_split_ms=prof.get("device_split_ms", "not measured")),
                   "maddpg_update_bf16_kernel": dict(
                       launches=out["paths"][f"MADDPG-bf16 on {name} at hidden {h}"]["launches"][
                           "maddpg_update_bf16_kernel"],
                       timed_on=f"batch {mb} of K8's rows, the runner's trained params",
                       device_ms_per_update=prof_b.get("device_ms_per_update", "not measured"),
                       **{q: bf16_row[q] for q in ("max_abs_err", "ms", "float32_kernel_ms",
                                                   "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by", "gates")})}
            for kname, r in scn.items():
                rows[kname]["by_scenario"][name] = r
                rows[kname]["launches"] += r["launches"]
                rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], r["max_abs_err"])
        for kname in kernels:             # the top-level numbers: simple_spread's
            top = rows[kname]["by_scenario"][WIDE_MADDPG_NAMES[0]]
            rows[kname].update({q: top[q] for q in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                               timed_on=f"{WIDE_MADDPG_NAMES[0]}, {top['timed_on']}")
            out[kname][h] = rows[kname]
    out["seconds"] = time.perf_counter() - t0
    print(f"MADDPG at hidden widths {WIDE_PHASE}: every gate passed in {out['seconds']:.1f} s")
    return out


def reference_actions(spaces_n, rng):
    """Reference-format actions made with numpy: a one-hot per Discrete
    (sub-)space, uniform values in a Box."""
    from mpe_tpu_torch.envs import spaces

    def one(space):
        if isinstance(space, spaces.Discrete):
            return np.eye(space.n)[rng.integers(space.n)]
        if isinstance(space, spaces.MultiDiscrete):
            return np.concatenate([np.eye(w)[rng.integers(w)] for w in space.sizes])
        if isinstance(space, spaces.Tuple):
            return np.concatenate([one(x) for x in space.spaces])
        return rng.uniform(space.low, space.high, space.shape)

    return [one(space) for space in spaces_n]


def timed_sync(fn):
    """(seconds, output) of ``fn()`` on the host clock, the device synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def env_api_path(wrappers, maddpg_params, generic_rate: float, fused_iter_ms: dict):
    """Main path f: the env API and the non-fused learners on the card. Only
    ES launches a kernel (K4, one launch per member); the rest runs on the
    generic engine. -> (launches, K4 launches by scenario, ES builder, its
    first params, its ms per generation)."""
    import torch

    from mpe_tpu_torch import make_env, registry, scenarios
    from mpe_tpu_torch.envs import MpeEnv, VecMultiAgentEnv, aec_env, parallel_env
    from mpe_tpu_torch.learner import (build_es_step, build_mappo_step, build_ppo_step,
                                       build_train_step, init_ac, init_mappo, init_policy)
    from mpe_tpu_torch.learner.eval import greedy_state_rollout
    from mpe_tpu_torch.ops.fused_policy import policy_rollout_cuda
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario
    from mpe_tpu_torch.parallel.mesh import _uniform_actions

    zero_launches(wrappers)
    t_path = time.perf_counter()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # 1. make_env: the reference's stateful API, one host round trip a step
    env = make_env("simple_spread", benchmark=True, seed=42)
    assert env.env.device.type == "cuda"
    env.reset()
    env.step(reference_actions(env.action_space, rng))               # warm-up
    t0 = time.perf_counter()
    for _ in range(F_STEPS):
        obs_n, rew_n, done_n, info_n = env.step(reference_actions(env.action_space, rng))
    make_env_ms = (time.perf_counter() - t0) * 1e3 / F_STEPS
    assert [o.shape for o in obs_n] == [(18,)] * 3, [o.shape for o in obs_n]
    assert rew_n[0] == rew_n[1] == rew_n[2] and math.isfinite(rew_n[0]), rew_n
    assert all(np.shape(info_n["n"][i][k]) == () for i in range(3) for k in ("rew", "collisions"))
    print(f"path f, make_env(simple_spread, benchmark=True): {make_env_ms:.4f} ms per step "
          f"(host round trip, mean of {F_STEPS}); reward {rew_n[0]:.5f}, info keys "
          f"{sorted(info_n['n'][0])}")

    # 2. the registry: one reset and one step of every id; the legacy
    # speaker-listener id to its horizon
    for env_id in registry.ids():
        e = registry.make(env_id, seed=1)
        e.reset()
        _, r, _, _ = e.step(reference_actions(e.action_space, rng))
        assert all(math.isfinite(x) for x in r), (env_id, r)
    e = registry.make("MultiagentSimpleSpeakerListener-v0", seed=2)
    e.reset()
    for t in range(1, 101):
        _, _, done_n, _ = e.step(reference_actions(e.action_space, rng))
        assert all(done_n) == (t == 100) and any(done_n) == (t == 100), (t, done_n)
    print(f"path f, registry: {len(registry.ids())} ids made, reset and stepped; "
          f"MultiagentSimpleSpeakerListener-v0 done at t = 100")

    # 3. VecMultiAgentEnv: the batched generic engine behind the wrapper
    mpe = MpeEnv(scenarios.load("simple_spread"))
    vec = VecMultiAgentEnv(mpe, F_VEC["n_envs"], seed=0)
    vec.reset()
    states0 = vec.states
    acts = _uniform_actions(mpe, gen, F_VEC["n_envs"])
    obs, rew, done, _ = vec.step(acts)
    _, obs7, rew7, done7, _ = mpe.step(states0.map(lambda x: x[7:8]), acts[7:8])
    env7_err = max(max_err(obs[7:8], obs7), max_err(rew[7:8], rew7))
    assert env7_err <= 1e-6 and torch.equal(done[7:8], done7), env7_err

    def vec_run():
        for _ in range(F_VEC["n_steps"]):
            out = vec.step(_uniform_actions(mpe, gen, F_VEC["n_envs"]))
        return out

    vec_s, out = timed_sync(vec_run)
    assert bool(torch.isfinite(out[0]).all())
    vec_rate = F_VEC["n_envs"] * F_VEC["n_steps"] / vec_s
    print(f"path f, VecMultiAgentEnv(simple_spread, {F_VEC['n_envs']}): {vec_rate:.6g} env-steps/s "
          f"({F_VEC['n_steps']} steps with uniform actions in {vec_s * 1e3:.1f} ms; path a's "
          f"generic engine {generic_rate:.6g}); env 7 against its own step: max abs err "
          f"{env7_err:.3g}, dones equal")

    # 4. the PettingZoo adapters, with samples drawn on the card
    par = parallel_env("simple_tag", max_cycles=F_CYCLES)
    par.reset(seed=3)
    cycles = 0

    def par_run():
        nonlocal cycles
        while par.agents:
            out = par.step({a: par.action_space(a).sample(gen) for a in par.agents})
            cycles += 1
        return out

    par_s, (_, rewards, terms, truncs, _) = timed_sync(par_run)
    assert cycles == F_CYCLES and all(truncs.values()) and not any(terms.values())
    assert set(truncs) == set(par.possible_agents)
    aec = aec_env("simple_world_comm", max_cycles=F_CYCLES)
    aec.reset(seed=4)
    acted = 0
    t0 = time.perf_counter()
    for agent in aec.agent_iter():
        _, reward, term, trunc, _ = aec.last()
        assert math.isfinite(reward)
        if term or trunc:
            aec.step(None)
            continue
        aec.step(aec.action_space(agent).sample(gen))
        acted += 1
    aec_s = time.perf_counter() - t0
    assert acted == F_CYCLES * len(aec.possible_agents) and not aec.agents
    print(f"path f, parallel_env(simple_tag, max_cycles={F_CYCLES}): every agent truncated at "
          f"{cycles} ({par_s * 1e3 / cycles:.3f} ms per cycle); aec_env(simple_world_comm): "
          f"{acted} actions over {F_CYCLES} cycles ({aec_s * 1e3 / F_CYCLES:.3f} ms per cycle)")

    # 5. REINFORCE on the generic engine
    spread = MpeEnv(scenarios.load("simple_spread"))
    pg_params = init_policy(gen, 18, spread.action_width, hidden=F_PG["hidden"])
    train_step = build_train_step(spread, F_PG["n_envs"], F_PG["n_steps"])
    pg_ms = []
    for i in range(F_PG_STEPS):
        s, (pg_params, loss) = timed_sync(lambda: train_step(pg_params, gen))
        assert math.isfinite(float(loss)), (i, float(loss))
        pg_ms.append(s * 1e3)
    print(f"path f, REINFORCE build_train_step(simple_spread, {F_PG['n_envs']} envs x "
          f"{F_PG['n_steps']} steps, hidden {F_PG['hidden']}): {statistics.mean(pg_ms[1:]):.3f} ms "
          f"per step (steps 1-{F_PG_STEPS - 1}); loss {float(loss):.5f}")

    # 6. PPO and MAPPO on the generic engine at path b's width
    horizon_env = MpeEnv(scenarios.load("simple_spread"), max_steps=TRAIN["horizon"],
                         auto_reset=True)
    kw = {k: TRAIN[k] for k in ("n_envs", "n_steps", "lr", "gamma", "lam", "clip", "vf_coef",
                                "ent_coef", "ppo_epochs")}
    nonfused = {}
    for label, build, init in (
            ("PPO", build_ppo_step, lambda: init_ac(gen, 18, 5, TRAIN["hidden"])),
            ("MAPPO", build_mappo_step, lambda: init_mappo(gen, 18, 5, 3, TRAIN["hidden"]))):
        step = build(horizon_env, **kw)
        state, ms = step.init_state(init()), []
        for i in range(F_PPO_ITERS):
            s, (state, metrics) = timed_sync(lambda: step(state, gen))
            m = {k: float(v) for k, v in metrics.items()}
            assert all(math.isfinite(v) for v in m.values()), (label, i, m)
            ms.append(s * 1e3)
        mean_ms = statistics.mean(ms[1:])
        nonfused[label] = mean_ms
        fused = fused_iter_ms[label]
        print(f"path f, {label} on the generic engine (simple_spread, {TRAIN['n_envs']} envs x "
              f"{TRAIN['n_steps']} steps, hidden {TRAIN['hidden']}, {TRAIN['ppo_epochs']} "
              f"epochs): {mean_ms:.3f} ms per iteration, "
              f"{TRAIN['n_envs'] * TRAIN['n_steps'] / (mean_ms * 1e-3):.6g} transitions/s "
              f"(iterations 1-{F_PPO_ITERS - 1}); the fused trainer (path "
              f"{'b' if label == 'PPO' else 'b2'}) {fused:.3f} ms, "
              f"{TRAIN['n_envs'] * TRAIN['n_steps'] / (fused * 1e-3):.6g} transitions/s "
              f"(generic / fused {mean_ms / fused:.2f}); last metrics "
              + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))

    # 7. greedy evaluation with path d's MADDPG actor, and uniform-random
    scn = scenarios.load("simple_spread")
    for label, params in (("path d's MADDPG actor", maddpg_params), ("random", None)):
        states, rew = greedy_state_rollout(scn, params, **F_EVAL)
        t_, n_ = F_EVAL["n_steps"], F_EVAL["n_envs"]
        assert states.pos.shape == (t_, n_, 6, 2) and states.comm.shape == (t_, n_, 3, 2)
        assert states.goal.shape == (t_, n_, 0) and rew.shape == (t_, n_, 3)
        assert np.isfinite(rew).all()
        print(f"path f, greedy_state_rollout(simple_spread, {label}, {n_} envs x {t_} steps): "
              f"mean reward per agent-step {float(rew.mean()):.5f}")

    # 8. ES on K4: one launch per member per generation
    kscn = kernel_scenario(F_ES_NAME)
    es_params = init_policy(gen, kscn.obs_w, kscn.n_logits, hidden=F_ES_HIDDEN)
    es_step = build_es_step(kscn, es_params, **F_ES)
    params0, params, scores, gen_ms = es_params, es_params, [], []
    for g in range(F_ES_GENS):
        s, (params, score) = timed_sync(lambda: es_step(params, g))
        scores.append(float(score))
        gen_ms.append(s * 1e3)
    assert all(math.isfinite(x) for x in scores), scores
    k4_es = policy_rollout_cuda.launches_by[F_ES_NAME]
    assert k4_es == F_ES["pop"] * F_ES_GENS, (k4_es, F_ES["pop"] * F_ES_GENS)
    wide = kernel_scenario("simple_spread")
    wide_params = init_policy(gen, wide.obs_w, wide.n_logits, hidden=64)
    wide_step = build_es_step(wide, wide_params, **F_ES)
    s, (_, wide_score) = timed_sync(lambda: wide_step(wide_params, 0))
    assert math.isfinite(float(wide_score))
    es_ms = statistics.mean(gen_ms[1:])
    print(f"path f, ES on K4 ({F_ES_NAME}, hidden {F_ES_HIDDEN}, pop {F_ES['pop']}, "
          f"{F_ES['n_envs']} envs x {F_ES['n_steps']} steps, horizon {F_ES['horizon']}): "
          f"{es_ms:.3f} ms per generation (generations 1-{F_ES_GENS - 1}); mean score of the "
          f"first five {statistics.mean(scores[:5]):.5f}, of the last five "
          f"{statistics.mean(scores[-5:]):.5f}; one generation on simple_spread at hidden 64 "
          f"{s * 1e3:.3f} ms, mean score {float(wide_score):.5f}")
    launches = read_launches(wrappers, ["policy_rollout_kernel"], "env API path")
    by = read_instantiations(policy_rollout_cuda, [F_ES_NAME, "simple_spread"],
                             "env API path's K4")
    assert launches["policy_rollout_kernel"] == F_ES["pop"] * (F_ES_GENS + 1)
    print(f"path f: {time.perf_counter() - t_path:.1f} s")
    return launches, by, es_step, params0, es_ms


def check_es_generation(es_step, params0, es_ms: float) -> tuple[float, dict]:
    """Generation 0 of path f's ES: the kernel's member scores against the
    plain K4's on the same perturbed weights; then one generation under
    torch.profiler: K4's device time and the device's busy time beside the
    generation's host-clock time from path f -> (the largest abs error, the
    generation's figures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    got, ref = es_step.scores(params0, 0), es_step.plain.scores(params0, 0)
    err = check("K4 in ES generation 0 (member scores)", {"ret": max_err(got, ref)})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        es_step(params0, 1)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    k4_us = sum(device_us(e) for e in device if "policy_rollout_kernel" in e.key)
    busy_us = sum(device_us(e) for e in device)
    if k4_us <= 0:
        print("ES generation under torch.profiler: device time not measured (no device events)")
        return err, {"ms": es_ms, "k4_device_ms": "not measured"}
    figures = {"ms": es_ms, "k4_device_ms": k4_us / 1e3,
               "k4_device_ms_per_launch": k4_us / 1e3 / F_ES["pop"],
               "k4_share": k4_us / 1e3 / es_ms, "device_busy_share": busy_us / 1e3 / es_ms}
    print(f"ES generation: {es_ms:.3f} ms by the host clock; under torch.profiler K4's device "
          f"time {k4_us / 1e3:.4f} ms over {F_ES['pop']} launches "
          f"({figures['k4_device_ms_per_launch']:.4f} ms each), {figures['k4_share']:.3f} of the "
          f"generation; the device busy {figures['device_busy_share']:.3f} of it")
    return err, figures


def finite_tree(label: str, tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            finite_tree(f"{label}.{k}", v)
        else:
            assert bool(v.isfinite().all()), f"{label}.{k} is not finite"


def variant_run(wrappers, label: str, run, n_chunks: int, **kw) -> tuple:
    """One MADDPG-variant runner for ``n_chunks`` chunks, the launches zeroed
    before and read after: K8 launched, K9 never -> (params, info, figures:
    K8 launches, mean collect and update ms per chunk over chunks 1..n-1 by
    CUDA events, the first and last chunk's metrics)."""
    import torch

    zero_launches(wrappers)
    events = []
    seconds, (params, info) = timed_sync(lambda: run(n_chunks * 25, seed=0, actor_start=0,
                                                     events=events, **kw))
    k8 = wrappers["maddpg_traj_kernel"].launches
    k9 = wrappers["maddpg_update_kernel"].launches
    print(f"{label} launches: K8 {k8}, K9 {k9}")
    assert k8 > 0 and k9 == 0, f"{label}: K8 must collect and K9 must not run ({k8}, {k9})"
    steady = chunk_phase_ms(events, n_chunks)[1:]
    collect_ms, update_ms = (statistics.mean(x[q] for x in steady) for q in (0, 1))
    mr, cl = info["mean_reward"].double(), info["critic_loss"].double()
    assert bool(torch.isfinite(mr).all()) and bool(torch.isfinite(cl).all()), (mr, cl)
    finite_tree(label, params)
    profiled = profile_variant(label, run, **kw)
    print(f"{label}, chunks 1-{n_chunks - 1}: {collect_ms + update_ms:.3f} ms per chunk "
          f"(collect {collect_ms:.3f}, update {update_ms:.3f}: {update_ms / 25:.3f} ms per "
          f"update); {run.transitions_per_chunk * len(steady) / (sum(map(sum, steady)) * 1e-3):.6g}"
          f" transitions/s; chunk 0 mean reward {float(mr[0]):.5f}, critic loss "
          f"{float(cl[0]):.5f}; chunk {n_chunks - 1} {float(mr[-1]):.5f}, {float(cl[-1]):.5f}; "
          f"{seconds:.2f} s with the warm-up (host clock)")
    return params, info, {"launches": {"maddpg_traj_kernel": k8, "maddpg_update_kernel": k9},
                          "chunks": n_chunks, "collect_ms": collect_ms, "update_ms": update_ms,
                          "chunk_ms": collect_ms + update_ms,
                          "mean_reward": [float(mr[0]), float(mr[-1])],
                          "critic_loss": [float(cl[0]), float(cl[-1])], **profiled}


def profile_variant(label: str, run, **kw) -> dict:
    """One more one-chunk run of a variant (the warm-up's collections and 25
    updates) under torch.profiler, after its launches were read: CUDA
    kernels per update (all the call's kernels over its 25 updates) and the
    device's idle share of the call's CUDA-event time. Gates nothing; ->
    {} without device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run(25, seed=1, actor_start=0, **kw)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not kernels:
        print(f"{label} under torch.profiler: device time not measured (no device events)")
        return {}
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    per_update = sum(e.count for e in kernels) / 25
    print(f"{label} under torch.profiler (one chunk with the warm-up, {wall_ms:.3f} ms by CUDA "
          f"events): {per_update:.1f} CUDA kernels per update, the device idle "
          f"{1 - busy_ms / wall_ms:.4f} of the time")
    return {"profiled_kernels_per_update": per_update, "profiled_idle_share": 1 - busy_ms / wall_ms}


def variants_path(wrappers) -> tuple[dict, float]:
    """Path g, the MADDPG variants on the card: g1 independent DDPG, g2 the
    ensemble and its best-response probe (K8 on sub-sliced actors, the pair
    physics), g3 the approximate other-agent policies, g4 build_maddpg on
    the generic engine (no kernel) -> (figures by phase, the K8 gate's
    largest abs error: K8 on g2's first sub-sliced actor stack against the
    plain K8, which must be 0)."""
    import torch

    from mpe_tpu_torch import make_generator, scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.learner import (build_approx_runner, build_ensemble_runner,
                                       build_fused_maddpg_runner, build_maddpg, init_buffer,
                                       init_ensemble, init_maddpg)
    from mpe_tpu_torch.learner.ensemble import draw_k_vec, sub_slice
    from mpe_tpu_torch.learner.maddpg import _dims

    t_path = time.perf_counter()
    figures = {}
    # g1: independent DDPG (local critics, autograd gradient on the packed state)
    run = build_fused_maddpg_runner("simple_spread", local_critic=True)
    _, _, figures["g1"] = variant_run(wrappers, "g1 independent DDPG (simple_spread)", run,
                                      G_CHUNKS)

    # g2: the ensemble, then the best-response probe against its frozen team
    run = build_ensemble_runner(G_ENSEMBLE, G_K_ENS)
    label = f"g2 ensemble ({G_ENSEMBLE}, K = {G_K_ENS})"
    params, _, figures["g2"] = variant_run(wrappers, label, run, G_CHUNKS)
    figures["g2"]["launches_by"] = dict(wrappers["maddpg_traj_kernel"].launches_by)
    frozen = {k: v.clone() for k, v in
              ((f"{q}.{w}", params["actor"][q][w]) for q in params["actor"]
               for w in params["actor"][q])}
    probe = build_ensemble_runner(G_ENSEMBLE, G_K_ENS, **G_PROBE)
    probe_params, _, figures["g2_probe"] = variant_run(
        wrappers, f"g2 best-response probe ({G_PROBE})", probe, G_PROBE_CHUNKS,
        init_params=params)
    mask = torch.tensor(G_PROBE["train_mask"])
    for key, x in frozen.items():
        q, w = key.split(".")
        got = probe_params["actor"][q][w]
        assert torch.equal(got[~mask], x[~mask]), f"g2 probe moved a frozen {key}"
        assert not torch.equal(got[mask], x[mask]), f"g2 probe: the trained {key} did not move"
    print(f"g2 probe: the frozen agents' actors equal bit for bit, the trained agents' moved "
          f"(train_mask {G_PROBE['train_mask']})")

    # the K8 gate: the first sub-sliced stack of g2 (its warm-up chunk 0)
    env = run.env
    _, obs_w, aw, _, _ = _dims(env)
    init = init_ensemble(torch.Generator().manual_seed(0), obs_w, aw, env.n_agents, G_K_ENS)
    stack = sub_slice({q: {w: x.cuda() for w, x in layer.items()}
                       for q, layer in init["actor"].items()},
                      draw_k_vec(run.k_active, 13, 0))
    got, ref = run.collect.traj(0, stack), run.collect.traj.plain(0, stack)
    gate_err = max_err(got, ref)
    same_bits(f"K8 on g2's first sub-sliced actor stack ({G_ENSEMBLE}, rows form)", got, ref)

    # g3: approximations of the other agents' policies
    run = build_approx_runner("simple_spread")
    _, _, figures["g3"] = variant_run(wrappers, "g3 approx (simple_spread)", run, G_CHUNKS)

    # g4: the per-step learner on the generic engine
    zero_launches(wrappers)
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=25, auto_reset=True)
    reset_fn, collect_fn, update_fn, init_opt = build_maddpg(env, **G4)
    _, obs_w, aw, _, _ = _dims(env)
    params = {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
              for n, net in init_maddpg(torch.Generator().manual_seed(0), obs_w, aw,
                                        env.n_agents).items()}
    targets = {n: {q: {w: x.clone() for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    opt = init_opt(params)
    buffer = init_buffer(G4["capacity"], env.n_agents, obs_w, aw)
    gen = make_generator(0)
    states, obs = reset_fn(gen)

    def collect_all():
        nonlocal states, obs, buffer
        rewards = []
        for _ in range(G4_COLLECTS):
            states, obs, buffer, r = collect_fn(params, states, obs, buffer, gen)
            rewards.append(r)
        return torch.stack(rewards)

    def update_all():
        nonlocal params, targets, opt
        losses = []
        for u in range(G4_UPDATES):
            params, targets, opt, m = update_fn(params, targets, opt, buffer, gen,
                                                do_actor=u % 2 == 0)
            losses.append(m["critic_loss"])
        return torch.stack(losses)

    s_col, rewards = timed_sync(collect_all)
    s_upd, losses = timed_sync(update_all)
    assert bool(rewards.isfinite().all()) and bool(losses.isfinite().all())
    finite_tree("g4 params", params)
    assert buffer.size == G4_COLLECTS * G4["n_envs"] and buffer.ptr == buffer.size
    k8, k9 = (wrappers[k].launches for k in ("maddpg_traj_kernel", "maddpg_update_kernel"))
    assert k8 == 0 and k9 == 0, f"g4 runs the generic engine: K8 {k8}, K9 {k9} launches"
    figures["g4"] = {"collect_step_ms": s_col * 1e3 / G4_COLLECTS,
                     "update_ms": s_upd * 1e3 / G4_UPDATES, **G4,
                     "collects": G4_COLLECTS, "updates": G4_UPDATES,
                     "mean_reward": float(rewards.mean()), "critic_loss": float(losses[-1])}
    print(f"g4 build_maddpg (simple_spread, {G4}): {figures['g4']['collect_step_ms']:.3f} ms per "
          f"collect step ({G4_COLLECTS} steps of {G4['n_envs']} envs), "
          f"{figures['g4']['update_ms']:.3f} ms per update ({G4_UPDATES}, batch {G4['batch']}; "
          f"host clock, the device synchronised); mean reward {figures['g4']['mean_reward']:.5f}, "
          f"last critic loss {figures['g4']['critic_loss']:.5f}; no kernel launched")
    print(f"path g: {time.perf_counter() - t_path:.1f} s")
    return figures, gate_err


def maddpg_learns_phase(wrappers) -> dict:
    """Phase g5: does the port's MADDPG learn? ``run_fused_maddpg`` at
    examples/maddpg_run.py's recipe (G5; K8 and K9), then greedy evaluation
    (``greedy_state_rollout``, 128 envs x 25 steps) of the trained actor, of
    uniform-random moves and, as a control of the evaluation itself, of the
    committed checkpoint the JAX package trained at that recipe. Gate: the
    trained actor's reward per agent-step above random's -> the figures."""
    import torch

    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.learner import build_fused_maddpg_runner
    from mpe_tpu_torch.learner.eval import greedy_state_rollout

    blocks, events = [], []

    def progress(done, total, mr, cl):
        blocks.append((done, mr, cl))

    run = build_fused_maddpg_runner("simple_spread", **G5)
    zero_launches(wrappers)
    seconds, (params, info) = timed_sync(lambda: run(
        G5_UPDATES, seed=0, actor_start=G5_ACTOR_START, progress=progress, events=events))
    launches = read_launches(wrappers, ["maddpg_traj_kernel", "maddpg_update_kernel"],
                             "g5 (MADDPG at examples/maddpg_run.py's recipe)")
    steady = chunk_phase_ms(events, len(events) // 2)[1:]
    collect_ms, update_ms = (statistics.mean(x[q] for x in steady) for q in (0, 1))
    mr = info["mean_reward"].double()
    assert bool(torch.isfinite(mr).all()) and bool(torch.isfinite(info["critic_loss"]).all())
    print("g5 collection mean reward per agent-step and critic loss, every 120 chunks: "
          + "; ".join(f"chunk {d} {r:.4f} {c:.4f}" for d, r, c in blocks[2::3]))
    scn = scenarios.load("simple_spread")
    scores = {}
    for label, p in (("trained", params), ("random", None),
                     ("JAX checkpoint", checkpoint_params("simple_spread"))):
        _, rew = greedy_state_rollout(scn, p, **F_EVAL)
        assert np.isfinite(rew).all()
        scores[label] = float(rew.mean())
        per = rew.sum(axis=(0, 1)) / (F_EVAL["n_envs"] * F_EVAL["n_steps"])
        print(f"g5 greedy_state_rollout(simple_spread, {label}, {F_EVAL['n_envs']} envs x "
              f"{F_EVAL['n_steps']} steps): mean reward per agent-step {scores[label]:.5f} "
              f"(per agent {', '.join(f'{x:.4f}' for x in per)})")
    print(f"g5: {info['updates']} updates in {seconds:.2f} s (host clock, the warm-up "
          f"collection included); per chunk (CUDA events, chunks 1-{len(steady)}) collect "
          f"{collect_ms:.3f} ms, update {update_ms:.3f} ms; greedy {scores['trained']:.5f} "
          f"against random "
          f"{scores['random']:.5f}; the JAX package records {G5_JAX_GREEDY} at this recipe "
          f"(tools/ddpg_vs_maddpg_report.json, three seeds on a TPU: a record, not a target)")
    assert scores["trained"] > scores["random"], \
        f"g5: the trained MADDPG actor scores {scores['trained']} <= random {scores['random']}"
    return {"seconds": seconds, "updates": info["updates"], "launches": launches,
            "collect_ms": collect_ms, "update_ms": update_ms,
            "greedy": scores["trained"], "random": scores["random"],
            "jax_checkpoint_greedy": scores["JAX checkpoint"],
            "first_block_reward": blocks[0][1], "last_block_reward": blocks[-1][1]}


# ---- path i: the side layers (renderer, policies, CLI, examples) -----------

def expect_launches(wrappers: dict, label: str, kernels: tuple) -> dict:
    """The launches of every kernel since the counts were zeroed: exactly
    ``kernels`` launched, each at least once (none where it is empty)."""
    counts = {name: w.launches for name, w in wrappers.items()}
    launched = {k: n for k, n in counts.items() if n}
    print(f"{label} launches: {launched or 'none'}")
    assert set(launched) == set(kernels), \
        f"{label}: launched {sorted(launched)}, expected {sorted(kernels)}"
    return launched


def check_frame(label: str, frame) -> None:
    assert frame.shape == (700, 700, 3) and frame.dtype == np.uint8, \
        f"{label}: a frame of {frame.shape} {frame.dtype}"
    assert bool((frame < 250).any()), f"{label}: a blank frame"


def alpha_invariant(frames, positions, color, size) -> float:
    """Largest |pixel - (0.5 colour + 0.5 white)| at agent 0's centre, over
    the frames where agent 0 lies inside the shared camera and no other
    entity reaches its centre (positions [E, 2], sizes [E])."""
    errs = []
    expect = 0.5 * np.asarray(color, np.float64) * 255 + 0.5 * 255
    for frame, pos in zip(frames, positions):
        others = np.hypot(*(pos[1:] - pos[0]).T) - size[1:]
        if np.abs(pos[0]).max() >= 0.99 or (others <= 3 / 350).any():
            continue
        cx, cy = int((pos[0, 0] + 1.0) / 2.0 * 700), int((1.0 - pos[0, 1]) / 2.0 * 700)
        errs.append(float(np.abs(frame[cy, cx] - expect).max()))
    assert errs, "no frame with agent 0 alone inside the camera"
    return max(errs)


def rendering_phase(wrappers) -> dict:
    """i1: ``render("rgb_array")`` on the card after each of I_STEPS steps
    of ``RandomPolicy`` actions on the nine scenarios (and after the reset),
    every frame (700, 700, 3) uint8 and not blank; the last frame equal bit
    for bit to the frame the same state draws on the CPU; agent 0 at alpha
    0.5 on simple_spread; one per-agent-viewer env; the gymnasium adapter's
    ``render`` -> ms per frame and per step by scenario (host clock)."""
    import torch

    from mpe_tpu_torch import make_env
    from mpe_tpu_torch.policy import RandomPolicy

    zero_launches(wrappers)
    figures = {}
    for name in ALL_SCENARIOS:
        env = make_env(name, seed=0)
        pols = [RandomPolicy(env, i, seed=0) for i in range(env.n)]
        obs_n = env.reset()
        frames, positions, frame_s, step_s = [], [], [], []
        for t in range(I_STEPS + 1):
            if t:
                acts = [p.action(obs_n[i]) for i, p in enumerate(pols)]
                t0 = time.perf_counter()
                obs_n, rew_n, _, _ = env.step(acts)
                step_s.append(time.perf_counter() - t0)
                assert np.isfinite(rew_n).all(), f"i1 {name}: a reward is not finite"
            t0 = time.perf_counter()
            got = env.render("rgb_array")
            frame_s.append(time.perf_counter() - t0)
            assert len(got) == 1, f"i1 {name}: {len(got)} frames from a shared viewer"
            check_frame(f"i1 {name} step {t}", got[0])
            frames.append(got[0])
            if name == "simple_spread":
                positions.append(env.state.pos[0].cpu().numpy())
        cpu = make_env(name, seed=0, device="cpu")
        cpu.state = env.state.map(lambda x: x.cpu())
        assert np.array_equal(cpu.render("rgb_array")[0], frames[-1]), \
            f"i1 {name}: the frame of the state on the card differs from the frame on the CPU"
        figures[name] = {"frame_ms": statistics.median(frame_s) * 1e3,
                         "step_ms": statistics.median(step_s) * 1e3, "frames": len(frames)}
        if name == "simple_spread":
            color = env.scenario.entity_colors(env.state)[0, 0].cpu().numpy()
            size = np.asarray(env.world_spec.size)
            figures[name]["alpha_err"] = alpha_invariant(frames, positions, color, size)
            assert figures[name]["alpha_err"] <= 1.0, \
                f"i1 simple_spread: agent 0's centre {figures[name]['alpha_err']} off 0.5 alpha"
        env.close()
        print(f"i1 {name}: {len(frames)} frames equal on the card and the CPU at the last; "
              f"{figures[name]['frame_ms']:.2f} ms per frame, {figures[name]['step_ms']:.3f} ms "
              f"per step (medians, host clock)"
              + (f"; agent 0 at alpha 0.5 within {figures[name]['alpha_err']:.1f}"
                 if "alpha_err" in figures[name] else ""))

    env = make_env(I_PER_AGENT, seed=0, shared_viewer=False)
    env.reset()
    got = env.render("rgb_array")
    assert len(got) == env.n, f"i1 {I_PER_AGENT}: {len(got)} frames for {env.n} viewers"
    for i, f in enumerate(got):
        check_frame(f"i1 {I_PER_AGENT} viewer {i}", f)
    assert any((got[0] != f).any() for f in got[1:]), "i1: the per-agent frames are all equal"
    env.close()
    print(f"i1 {I_PER_AGENT} (shared_viewer=False): one frame per agent ({len(got)}), "
          "centred on each")

    from mpe_tpu_torch.envs import gym_compat

    if gym_compat.gymnasium is not None:
        gym_env = gym_compat.GymnasiumMultiAgentEnv("simple_spread", render_mode="rgb_array")
        gym_env.reset(seed=0)
        how = "gymnasium installed"
    else:
        # gymnasium is not on this machine: the adapter's own render method
        # on an instance given the env its constructor would make
        gym_env = object.__new__(gym_compat.GymnasiumMultiAgentEnv)
        gym_env._env, gym_env.render_mode = make_env("simple_spread", seed=0), "rgb_array"
        gym_env._env.reset()
        how = "gymnasium not installed: the adapter's render on an instance made without it"
    check_frame("i1 GymnasiumMultiAgentEnv.render", gym_env.render())
    print(f"i1 GymnasiumMultiAgentEnv(simple_spread, render_mode='rgb_array').render(): a "
          f"(700, 700, 3) frame ({how})")
    torch.cuda.synchronize()
    expect_launches(wrappers, "i1 (rendering)", ())
    return figures


def policies_cli_phase(wrappers) -> dict:
    """i2: ``InteractivePolicy`` under a key script steps simple_spread on the
    card; ``python -m mpe_tpu_torch.interactive_cli`` as a subprocess on the
    card -> its seconds."""
    import os

    from mpe_tpu_torch import make_env
    from mpe_tpu_torch.policy import InteractivePolicy, ScriptedKeySource

    zero_launches(wrappers)
    env = make_env("simple_spread", seed=0)
    pols = [InteractivePolicy(env, i, ScriptedKeySource(I_KEYS)) for i in range(env.n)]
    obs_n = env.reset()
    for keys in I_KEYS:
        acts = [p.action(obs_n[i]) for i, p in enumerate(pols)]
        want = np.zeros(5)
        for k, j in (("left", 1), ("right", 2), ("down", 3), ("up", 4)):
            want[j] += k in keys
        want[0] = not want.any()
        assert all(np.array_equal(a, want) for a in acts), f"i2: keys {keys} gave {acts[0]}"
        obs_n, rew_n, _, _ = env.step(acts)
        assert np.isfinite(rew_n).all()
    print(f"i2 InteractivePolicy (ScriptedKeySource {list(I_KEYS)}) stepped simple_spread on "
          f"the card: actions as the reference's key map, rewards {[round(r, 3) for r in rew_n]}")
    cmd = [sys.executable, "-m", "mpe_tpu_torch.interactive_cli", *I_CLI]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                         text=True, timeout=I_CLI_TIMEOUT, env={**os.environ, "MPE_WINDOW": "0"})
    seconds = time.perf_counter() - t0
    assert out.returncode == 0, f"i2: the CLI exited {out.returncode}: {out.stderr[-2000:]}"
    assert "t=4 rewards=" in out.stdout, f"i2: the CLI printed {out.stdout[-500:]!r}"
    print(f"i2 python -m mpe_tpu_torch.interactive_cli {' '.join(I_CLI)}: exit 0 in "
          f"{seconds:.2f} s (its start-up included); last line {out.stdout.splitlines()[-1]!r}")
    expect_launches(wrappers, "i2 (policies, CLI)", ())
    return {"cli_seconds": seconds}


def figure_numbers(x) -> list:
    """Every number in an example's figures, nested containers included."""
    if isinstance(x, dict):
        return [n for v in x.values() for n in figure_numbers(v)]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in figure_numbers(v)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def run_example(wrappers, label: str, module: str, argv: list, kernels: tuple):
    """One example's ``main(argv)`` in this process, its output kept and
    printed indented (so no line of it starts like a JSON line of this
    script) -> (figures, seconds, launches)."""
    import contextlib
    import importlib
    import io

    main_ = importlib.import_module(f"mpe_tpu_torch.examples.{module}").main
    zero_launches(wrappers)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        seconds, figures = timed_sync(lambda: main_(argv))
    for line in buf.getvalue().splitlines():
        print(f"    | {line}")
    numbers = figure_numbers(figures)
    assert numbers and all(math.isfinite(n) for n in numbers), \
        f"i3 {label}: figures not finite: {figures}"
    launched = expect_launches(wrappers, f"i3 {label}", kernels)
    print(f"i3 {label}: {seconds:.2f} s (host clock)")
    return figures, seconds, launched


def examples_phase(wrappers, generic_rate: float, k2_rate: float) -> dict:
    """i3: every example of I_EXAMPLES in this process on the card, each
    with the kernels it must launch; es_train's K4 launches at its defaults;
    the crypto codebook on the card equal to the one on the CPU -> the
    figures, seconds and launches by example."""
    out = {}
    for label, module, argv, kernels in I_EXAMPLES:
        figures, seconds, launched = run_example(wrappers, label, module, argv, kernels)
        out[label] = {"seconds": seconds, "launches": launched}
        if module == "rollout":
            rate = figures["env_steps_per_s"]
            out[label]["env_steps_per_s"] = rate
            print(f"i3 {label}: {rate / 1e6:.4f} M env-steps/s at {figures['env_steps']} "
                  f"env-steps (host clock); path a: generic {generic_rate / 1e6:.4f}, K2 "
                  f"{k2_rate / 1e6:.4f} M env-steps/s ({N_ENVS} envs x {N_STEPS} steps)")
        elif module == "es_train":
            n = launched["policy_rollout_kernel"]
            assert n == I_ES_LAUNCHES, f"i3 es_train: {n} K4 launches, not {I_ES_LAUNCHES}"
        elif module == "render_policy":
            assert figures["frames"] == 75, f"i3 render_policy: {figures['frames']} frames"
            out[label]["ms_per_frame"] = seconds / figures["frames"] * 1e3
        elif module == "crypto_demo":
            cpu, cpu_s, _ = run_example(wrappers, "crypto_demo --device cpu", module,
                                        argv + ["--device", "cpu"], ())
            assert figures["alice_codebook"] == cpu["alice_codebook"], \
                f"i3 crypto_demo: codebook {figures['alice_codebook']} on the card, " \
                f"{cpu['alice_codebook']} on the CPU"
            out[label].update(codebook=figures["alice_codebook"],
                              alice_logit_gap=figures["alice_logit_gap"], cpu_seconds=cpu_s)
            print(f"i3 crypto_demo: Alice's codebook on the card equals the CPU's "
                  f"({figures['alice_codebook']}); smallest gap between her top two message "
                  f"logits {figures['alice_logit_gap']:.4g}")
        if module in ("evaluate_policy", "maddpg_run", "train", "es_train"):
            keep = {k: figures[k] for k in ("mean_return", "greedy", "greedy_per_agent",
                                            "random_per_agent", "mean_return_by_generation",
                                            "last") if k in figures}
            out[label].update(keep)
    return out


def side_layers_path(wrappers, generic_rate: float, k2_rate: float) -> dict:
    """Path i: the renderer, the keyboard and random policies, the
    interactive CLI and the examples, on the card (i1-i3) -> figures by
    phase, ``launches`` by sub-phase, the path's seconds."""
    t_path = time.perf_counter()
    figures = {"i1": rendering_phase(wrappers), "i2": policies_cli_phase(wrappers),
               "i3": examples_phase(wrappers, generic_rate, k2_rate)}
    for lib in ("PIL", "matplotlib"):
        assert lib not in sys.modules, f"path i imported {lib}"
    figures["seconds"] = time.perf_counter() - t_path
    figures["launches"] = {f"i3 {k}": v["launches"] for k, v in figures["i3"].items()
                           if v["launches"]}
    print(f"path i (side layers): {figures['seconds']:.1f} s; kernel launches by example "
          f"{figures['launches']}")
    return figures


# ---- path h: multi-device (torch.distributed) and checkpoint/trace ----------

def kernel_wrappers() -> dict:
    """The nine kernels' wrappers and K6-bf16's, K7-bf16's and K9-bf16's,
    whose counters the paths read."""
    from mpe_tpu_torch.ops.fused_maddpg import maddpg_traj_cuda
    from mpe_tpu_torch.ops.fused_maddpg_update import maddpg_update_bf16_cuda, maddpg_update_cuda
    from mpe_tpu_torch.ops.fused_parity import det_rollout_cuda
    from mpe_tpu_torch.ops.fused_policy import policy_rollout_cuda, policy_traj_cuda
    from mpe_tpu_torch.ops.fused_rollout import rollout_cuda
    from mpe_tpu_torch.ops.fused_trajectory import trajectory_cuda
    from mpe_tpu_torch.ops.fused_update import (mappo_update_bf16_cuda, mappo_update_cuda,
                                                ppo_update_bf16_cuda, ppo_update_cuda)

    return {"scenario_rollout_kernel": rollout_cuda, "trajectory_kernel": trajectory_cuda,
            "det_rollout_kernel": det_rollout_cuda, "policy_traj_kernel": policy_traj_cuda,
            "policy_rollout_kernel": policy_rollout_cuda, "ppo_update_kernel": ppo_update_cuda,
            "mappo_update_kernel": mappo_update_cuda, "maddpg_traj_kernel": maddpg_traj_cuda,
            "maddpg_update_kernel": maddpg_update_cuda,
            "ppo_update_bf16_kernel": ppo_update_bf16_cuda,
            "mappo_update_bf16_kernel": mappo_update_bf16_cuda,
            "maddpg_update_bf16_kernel": maddpg_update_bf16_cuda}


def h_maddpg_init(seed: int = 0):
    """(env, params, targets) of path h's MADDPG on simple_spread, hidden 64."""
    import torch

    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.learner.maddpg import init_maddpg

    env = MpeEnv(scenarios.load("simple_spread"), max_steps=MADDPG["horizon"], auto_reset=True)
    params = init_maddpg(torch.Generator().manual_seed(seed), env.scenario.obs_width, 5,
                         env.n_agents, hidden=TRAIN["hidden"])
    params = {n: {k: {q: v.cuda() for q, v in l.items()} for k, l in t.items()}
              for n, t in params.items()}
    targets = {n: {k: {q: v.clone() for q, v in l.items()} for k, l in t.items()}
               for n, t in params.items()}
    return env, params, targets


def flat_leaves(tree) -> list:
    """The tensors of a nested dict in sorted-key order."""
    return [x for k in sorted(tree) for x in (flat_leaves(tree[k]) if isinstance(tree[k], dict)
                                              else [tree[k]])]


def trees_equal(label: str, got, want) -> float:
    """Largest abs difference of two trees' leaves; prints whether they are
    equal bit for bit."""
    import torch

    a, b = flat_leaves(got), flat_leaves(want)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    err = max(max_err(x, y) for x, y in zip(a, b))
    print(f"{label}: {'equal bit for bit' if same else f'max abs difference {err:.3g}'}")
    return 0.0 if same else err


def all_reduce_ms(mesh, numel: int, repeats: int = 50) -> float:
    """Host-clock ms of one ``mesh.mean_`` of ``numel`` floats on the card,
    the device synchronized before and after the run of ``repeats``."""
    import torch

    x = torch.ones(numel, device=mesh.device)
    reduces = mesh.reduces
    mesh.mean_([x])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        mesh.mean_([x])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    mesh.reduces = reduces                      # the timing is no update
    return ms


def numel(tree) -> int:
    return sum(x.numel() for x in flat_leaves(tree))


def multidevice_h1(wrappers) -> dict:
    """Path h1: one rank on nccl in this process (the production backend at
    world size 1): one data-parallel PPO iteration at path b's width and two
    data-parallel MADDPG chunks at path d's row, each equal to its non-DP
    builder bit for bit; NCCL's all_reduce timed."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from mpe_tpu_torch.learner import (build_fused_collect, build_fused_maddpg_dp,
                                       build_fused_ppo_step, build_fused_update_chunk,
                                       init_buffer)
    from mpe_tpu_torch.parallel.mesh import init_multihost

    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_multihost(init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            assert mesh.backend == "nccl", mesh
            env, md, targets = h_maddpg_init()
            kw = dict(horizon=MADDPG["horizon"], batch=MADDPG["batch"], cap_chunks=H_CAP_CHUNKS,
                      block_envs=H_MADDPG_BLOCK)
            zero_launches(wrappers)
            dp = build_fused_ppo_step("simple_spread", mesh=mesh, **TRAIN)
            params = dp.init_params(torch.Generator().manual_seed(5))
            (p_dp, _), m_dp = dp(dp.init_state(params), 0)
            dpm = build_fused_maddpg_dp(env, MADDPG["n_envs"], mesh=mesh, **kw)
            state = (md, targets, dpm.init_opt(md), dpm.init_buffer())
            for seed in range(H1_CHUNKS):
                state, mm_dp = dpm(state, seed)
            torch.cuda.synchronize()
            launches = read_launches(wrappers, ["policy_traj_kernel", "ppo_update_kernel",
                                                "maddpg_traj_kernel", "maddpg_update_kernel"],
                                     "path h1 (nccl, one rank)")
            reduces = mesh.reduces
            # the non-DP builders on the same inputs
            single = build_fused_ppo_step("simple_spread", **TRAIN)
            (p1, _), m1 = single(single.init_state(params), 0)
            errs = {"ppo_params": trees_equal("h1 DP PPO params against the non-DP step", p_dp,
                                              p1),
                    "ppo_metrics": trees_equal("h1 DP PPO metrics", m_dp, m1)}
            collect = build_fused_collect(env, MADDPG["n_envs"], MADDPG["horizon"],
                                          block_envs=H_MADDPG_BLOCK)
            chunk = build_fused_update_chunk(env, MADDPG["horizon"], batch=MADDPG["batch"])
            buffer = init_buffer(H_CAP_CHUNKS * MADDPG["horizon"] * MADDPG["n_envs"],
                                 env.n_agents, env.scenario.obs_width, 5)
            p, t, o = md, targets, chunk.init_opt(md)
            for seed in range(H1_CHUNKS):
                buffer, _ = collect(p["actor"], buffer, seed)
                p, t, o, m = chunk(p, t, o, buffer, seed, np.ones(MADDPG["horizon"], bool))
            errs["maddpg_params"] = trees_equal("h1 DP MADDPG params against the non-DP chunk",
                                                state[0], p)
            errs["maddpg_targets"] = trees_equal("h1 DP MADDPG targets", state[1], t)
            errs["maddpg_critic_loss"] = max_err(mm_dp["critic_loss"], m["critic_loss"])
            errs["maddpg_ring"] = max_err(state[3].data, buffer.data)
            del state, buffer
            ar = {"ppo_gradient": all_reduce_ms(mesh, numel(params)),
                  "maddpg_gradient": all_reduce_ms(mesh, dpm.update_chunk.layout.off_ta)}
        finally:
            dist.destroy_process_group()
    print(f"h1 all_reduce on nccl, one rank: {ar['ppo_gradient']:.4f} ms for the PPO gradient "
          f"({numel(params)} floats), {ar['maddpg_gradient']:.4f} ms for the "
          f"MADDPG packed gradient ({dpm.update_chunk.layout.off_ta} floats); {reduces} reduces "
          f"in the DP steps")
    bad = {k: v for k, v in errs.items() if v != 0.0}
    assert not bad, f"path h1: the DP steps differ from the non-DP builders: {bad}"
    return {"launches": launches, "all_reduce_ms": ar, "backend": "nccl", "reduces": reduces}


def h2_rank(mesh, out_dir: str) -> None:
    """One of path h2's ranks (launched by ``multidevice_h2``): the sharded
    kernels and the data-parallel trainers at full width, on the rank's card.
    Writes ``h2_rank<r>.json``."""
    import torch

    from mpe_tpu_torch.learner import (build_fused_maddpg_dp, build_fused_mappo_step,
                                       build_fused_ppo_step, init_policy)
    from mpe_tpu_torch.learner.maddpg import collect_t_chunk
    from mpe_tpu_torch.ops.fused_maddpg import (fused_maddpg_trajectory,
                                                sharded_fused_maddpg_trajectory)
    from mpe_tpu_torch.ops.fused_policy import fused_policy_trajectory
    from mpe_tpu_torch.ops.fused_rollout import fused_rollout, sharded_fused_rollout
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    wrappers = kernel_wrappers()
    kscn = kernel_scenario("simple_spread")
    to_cuda = lambda tree: {k: {q: v.cuda() for q, v in l.items()} for k, l in tree.items()}
    actor = to_cuda(init_policy(torch.Generator().manual_seed(2), kscn.obs_w, 5,
                                hidden=TRAIN["hidden"]))
    env, md, targets = h_maddpg_init()
    kw_md = dict(horizon=MADDPG["horizon"], batch=MADDPG["batch"], cap_chunks=H_CAP_CHUNKS,
                 block_envs=H_MADDPG_BLOCK)
    t_chunk = collect_t_chunk(MADDPG["horizon"])
    zero_launches(wrappers)
    t_path = time.perf_counter()
    # the main path: the sharded kernels, then the DP trainers
    k2 = sharded_fused_rollout("simple_spread", N_ENVS, N_STEPS, mesh=mesh, horizon=HORIZON,
                               block_envs=BLOCK_ENVS)(1)
    local, block, offset = mesh.shard_envs(TRAIN["n_envs"], TRAIN["block_envs"])
    k5 = fused_policy_trajectory(kscn, actor, local, TRAIN["n_steps"], horizon=TRAIN["horizon"],
                                 block_envs=block, t_chunk=TRAIN["t_chunk"])(3, actor, offset)
    k8 = sharded_fused_maddpg_trajectory(kscn, md["actor"], MADDPG["n_envs"], MADDPG["horizon"],
                                         mesh=mesh, horizon=MADDPG["horizon"],
                                         block_envs=H_MADDPG_BLOCK, t_chunk=t_chunk,
                                         emit_rows=True)(2, md["actor"])
    step_ms, states = {}, {}
    for kind, build in (("PPO", build_fused_ppo_step), ("MAPPO", build_fused_mappo_step)):
        step = build("simple_spread", mesh=mesh, **TRAIN)
        state = step.init_state(step.init_params(torch.Generator().manual_seed(5)))
        times = []
        for it in range(H_PPO_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, it)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        assert all(bool(torch.isfinite(v)) for v in metrics.values()), (kind, metrics)
        states[kind] = state
        step_ms[kind] = statistics.mean(times[1:])
    dp = build_fused_maddpg_dp(env, MADDPG["n_envs"], mesh=mesh, **kw_md)
    dstate = (md, targets, dp.init_opt(md), dp.init_buffer())
    times = []
    for seed in range(H2_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dstate, dmetrics = dp(dstate, seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    assert all(bool(torch.isfinite(v)) for v in dmetrics.values()), dmetrics
    step_ms["MADDPG"] = statistics.mean(times[1:])
    path_s = time.perf_counter() - t_path
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    for k in ("scenario_rollout_kernel", "policy_traj_kernel", "ppo_update_kernel",
              "mappo_update_kernel", "maddpg_traj_kernel", "maddpg_update_kernel"):
        assert launches.get(k, 0) > 0, f"path h2 rank {mesh.rank}: {k} never launched"
    reduces = mesh.reduces
    ar = {"ppo_gradient": all_reduce_ms(mesh, numel(states["PPO"][0])),
          "mappo_gradient": all_reduce_ms(mesh, numel(states["MAPPO"][0])),
          "maddpg_gradient": all_reduce_ms(mesh, dp.update_chunk.layout.off_ta)}
    # the checks: every rank's params the same, the gathered shards equal to
    # the one-process runs, the DP steps equal to one-process twins
    errs = {}
    for kind in ("PPO", "MAPPO"):
        flat = torch.cat([x.reshape(1, -1) for x in flat_leaves(states[kind][0])], 1)
        every = mesh.gather(flat, axis=0)
        errs[f"{kind}_across_ranks"] = max_err(every[0], every[1])
    flat = torch.cat([x.reshape(1, -1) for x in flat_leaves(dstate[0])], 1)
    every = mesh.gather(flat, axis=0)
    errs["MADDPG_across_ranks"] = max_err(every[0], every[1])
    # the env axis is the last of K2's and K5's outputs, axis 1 of K8's rows
    gathered = {"K2": tuple(mesh.gather(x, axis=-1) for x in k2),
                "K5": tuple(mesh.gather(x, axis=-1) for x in k5),
                "K8": mesh.gather(k8, axis=1)}
    if mesh.rank == 0:
        same_bits("h2 K2 gathered over 2 ranks against one process", gathered["K2"],
                  fused_rollout("simple_spread", N_ENVS, N_STEPS, horizon=HORIZON,
                                block_envs=BLOCK_ENVS)(1))
        same_bits("h2 K5 gathered over 2 ranks against one process", gathered["K5"],
                  fused_policy_trajectory(kscn, actor, TRAIN["n_envs"], TRAIN["n_steps"],
                                          horizon=TRAIN["horizon"],
                                          block_envs=TRAIN["block_envs"],
                                          t_chunk=TRAIN["t_chunk"])(3, actor))
        same_bits("h2 K8 rows gathered over 2 ranks against one process", gathered["K8"],
                  fused_maddpg_trajectory(kscn, md["actor"], MADDPG["n_envs"],
                                          MADDPG["horizon"], horizon=MADDPG["horizon"],
                                          block_envs=H_MADDPG_BLOCK, t_chunk=t_chunk,
                                          emit_rows=True)(2, md["actor"]))
        for kind in ("PPO", "MAPPO"):
            errs[f"{kind}_vs_twin"] = trees_equal(
                f"h2 DP {kind} params after {H_PPO_ITERS} iterations against the one-process "
                "twin", states[kind][0], ppo_twin(kind, mesh.device))
        errs["MADDPG_vs_twin"] = trees_equal(
            f"h2 DP MADDPG params after {H2_CHUNKS} chunks against the one-process twin",
            dstate[0], maddpg_twin(kw_md, mesh.device))
    with open(f"{out_dir}/h2_rank{mesh.rank}.json", "w") as f:
        json.dump({"rank": mesh.rank, "backend": mesh.backend, "launches": launches,
                   "step_ms": step_ms, "all_reduce_ms": ar, "reduces": reduces,
                   "path_s": path_s, "errors": errs}, f)


def ppo_twin(kind: str, device):
    """Path h2's DP PPO (MAPPO) in one process: both halves collected at
    their block offsets, each epoch's K6 (K7) gradients averaged into the
    first half's storage, as the ranks' in-place all_reduce leaves them."""
    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.learner.optim import apply_updates, tree_map
    from mpe_tpu_torch.parallel.mesh import EnvMesh

    build = build_fused_ppo_step if kind == "PPO" else build_fused_mappo_step
    steps = [build("simple_spread", mesh=EnvMesh(r, 2, device), **TRAIN) for r in (0, 1)]
    params = steps[0].init_params(torch.Generator().manual_seed(5))
    opt_state = steps[0].opt.init(params)
    with torch.no_grad():
        for it in range(H_PPO_ITERS):
            batches = [s.collect(params, it) for s in steps]
            for _ in range(TRAIN["ppo_epochs"]):
                grads = [s.update(params, obs, mv, cm, lp, adv_n, ret, value)[0]
                         for s, (obs, mv, cm, lp, value, adv_n, ret) in zip(steps, batches)]
                g = tree_map(lambda a, b: a.copy_((a + b) / 2), *grads)
                updates, opt_state = steps[0].opt.update(g, opt_state)
                params = apply_updates(params, updates)
    return params


def maddpg_twin(kw_md: dict, device):
    """Path h2's DP MADDPG in one process: both halves' rings filled at
    their block offsets and drawn with each rank's key, each update's K9
    gradients (from trees) averaged, then Adam and Polyak on the trees."""
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_dp
    from mpe_tpu_torch.learner.maddpg import _apply_maddpg_update, sample_rows
    from mpe_tpu_torch.learner.optim import adam, tree_map
    from mpe_tpu_torch.parallel.mesh import EnvMesh, fold_host_key

    env, params, targets = h_maddpg_init()
    dps = [build_fused_maddpg_dp(env, MADDPG["n_envs"], mesh=EnvMesh(r, 2, device), **kw_md)
           for r in (0, 1)]
    grads_fn = dps[0].update_chunk.grads_fn
    opt = dps[0].init_opt(params)
    rings = [d.init_buffer() for d in dps]
    n_up = dps[0].updates_per_chunk
    with torch.no_grad():
        for seed in range(H2_CHUNKS):
            rows = []
            for r, d in enumerate(dps):
                rings[r], _ = d.collect(params["actor"], rings[r], seed)
                rows.append(sample_rows(rings[r], fold_host_key(seed, r), n_up,
                                        MADDPG["batch"])[0])
            for u in range(n_up):
                gs = [grads_fn.from_rows(params, targets, rows[r][u])[0] for r in (0, 1)]
                g = {net: tree_map(lambda a, b: (a + b) / 2, gs[0][net], gs[1][net])
                     for net in gs[0]}
                params, targets, opt = _apply_maddpg_update(
                    params, targets, opt, g, True, actor_opt=adam(1e-3), critic_opt=adam(1e-3),
                    tau_polyak=0.05)
    return params


def multidevice_h2(wrappers, one_process_ms: dict, card: str) -> dict:
    """Path h2: ``H_RANKS`` ranks on the backend ``init_multihost`` picks for
    the cards visible (gloo on one card: NCCL refuses two ranks on one
    device), launched as processes that load the kernels built here (the
    build directory must not change). Each rank's launches, ms per DP step,
    all_reduce ms and backend; every check of ``h2_rank`` passes on rank 0."""
    import os
    import tempfile
    from pathlib import Path

    import torch

    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.parallel.launch import launch
    from mpe_tpu_torch.parallel.mesh import pick_backend

    backend = pick_backend("cuda", H_RANKS)
    shared = H_RANKS > torch.cuda.device_count()

    built = sorted(p.name for p in Path(_build.BUILD_DIR).glob("*.so"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = launch(f"{os.path.abspath(__file__)}:h2_rank", H_RANKS, tmp, timeout=H2_TIMEOUT)
        wall_s = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{tmp}/h2_rank{r}.json").read_text()) for r in range(H_RANKS)]
    for out in outs:
        for line in out.splitlines():
            print(f"  {line}")
    assert sorted(p.name for p in Path(_build.BUILD_DIR).glob("*.so")) == built, \
        "the ranks built kernels of their own"
    for r in ranks:
        assert r["backend"] == backend, (r["backend"], backend)
        print(f"h2 rank {r['rank']} of {H_RANKS} ({backend}"
              + (", the ranks sharing one card: the mechanism's cost, not scale-out" if shared
                 else ", a card each") + f"): launches {r['launches']}; ms per DP step "
              + ", ".join(f"{k} {v:.3f} (one process at the same total width: "
                          f"{one_process_ms[k]:.3f})" for k, v in r["step_ms"].items())
              + "; all_reduce ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["all_reduce_ms"].items())
              + f"; {r['reduces']} reduces; the path {r['path_s']:.1f} s; {card}")
    errs = ranks[0]["errors"]
    print("h2 errors: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    exact = {k: v for k, v in errs.items() if not k.endswith("_vs_twin")}
    assert all(v == 0.0 for v in exact.values()), f"path h2: shards or ranks differ: {exact}"
    twins = {k: v for k, v in errs.items() if k.endswith("_vs_twin")}
    assert all(v <= 1e-6 for v in twins.values()), f"path h2: DP steps off their twins: {twins}"
    print(f"path h2: {H_RANKS} ranks in {wall_s:.1f} s with their start-up")
    return {"ranks": ranks, "seconds": wall_s}


def checkpoint_trace_h3(wrappers) -> dict:
    """Path h3: a fused MADDPG train state (params, targets, Adam states, the
    ring) saved mid-run, loaded into a fresh template and continued bit for
    bit; then ``utils.trace`` over one K2 call in a ``step_phase``, in a
    launched rank (``h3_trace_rank``): the ``mpe/`` range and K2's kernel
    must be in the written trace."""
    import os
    import tempfile

    import numpy as np

    from mpe_tpu_torch.learner import build_fused_collect, build_fused_update_chunk, init_buffer
    from mpe_tpu_torch.parallel.launch import launch
    from mpe_tpu_torch.utils import load_train_state, save_train_state

    gates = np.ones(MADDPG["horizon"], bool)
    env, md, targets = h_maddpg_init()
    collect = build_fused_collect(env, MADDPG["n_envs"], MADDPG["horizon"])
    chunk = build_fused_update_chunk(env, MADDPG["horizon"], batch=MADDPG["batch"])
    cap = H3_RING_CHUNKS * collect.rows_per_chunk

    def fresh(seed):
        _, p, t = h_maddpg_init(seed)
        return {"params": p, "targets": t, "opt_states": chunk.init_opt(p),
                "buffer": init_buffer(cap, env.n_agents, env.scenario.obs_width, 5)}

    def iterate(s, seed):
        buffer, _ = collect(s["params"]["actor"], s["buffer"], seed)
        p, t, o, m = chunk(s["params"], s["targets"], s["opt_states"], buffer, 100 + seed, gates)
        return {"params": p, "targets": t, "opt_states": o, "buffer": buffer}, m

    zero_launches(wrappers)
    state = fresh(0)
    for seed in range(2):
        state, _ = iterate(state, seed)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_train_state(f"{tmp}/maddpg", state, step=2)
        save_s = time.perf_counter() - t0
        run_a, ms_a = state, []
        for seed in range(2, 4):
            run_a, m = iterate(run_a, seed)
            ms_a.append(float(m["critic_loss"]))
        t0 = time.perf_counter()
        run_b, step, _ = load_train_state(f"{tmp}/maddpg", fresh(7))
        load_s = time.perf_counter() - t0
        size_mb = Path(f"{tmp}/maddpg.npz").stat().st_size / 1e6
    ms_b = []
    for seed in range(2, 4):
        run_b, m = iterate(run_b, seed)
        ms_b.append(float(m["critic_loss"]))
    launches = read_launches(wrappers, ["maddpg_traj_kernel", "maddpg_update_kernel"],
                             "path h3 (checkpoint and resume)")
    assert step == 2 and ms_a == ms_b, (step, ms_a, ms_b)
    err = trees_equal("h3 resumed MADDPG params", run_a["params"], run_b["params"])
    err = max(err, trees_equal("h3 resumed targets", run_a["targets"], run_b["targets"]))
    err = max(err, max_err(run_a["buffer"].data, run_b["buffer"].data))
    assert err == 0.0, f"path h3: the resumed run differs ({err})"
    print(f"h3 checkpoint of {size_mb:.1f} MB ({cap} ring rows): saved in {save_s:.2f} s, "
          f"loaded in {load_s:.2f} s; two chunks after it equal bit for bit")
    del run_a, run_b, state
    with tempfile.TemporaryDirectory() as tmp:
        launch(f"{os.path.abspath(__file__)}:h3_trace_rank", 1, tmp, timeout=H3_TIMEOUT)
        tr = json.loads(Path(f"{tmp}/h3_trace.json").read_text())
    launches["scenario_rollout_kernel"] = tr["launches"]
    print(f"path h3 (trace, a launched rank) launches: {{'scenario_rollout_kernel': "
          f"{tr['launches']}}}; the trace ({tr['trace_kb']:.1f} kB): mpe/fused_rollout in the "
          f"profiler's events {tr['range_in_events']}, in the file {tr['range_in_file']}; "
          f"K2's kernel in the file {tr['k2_in_file']}, {tr['k2_device_ms']:.4f} ms on the "
          f"device; the range {tr['range_host_ms']:.3f} ms (host)")
    assert tr["launches"] > 0, "path h3 (trace): K2 was never launched"
    assert tr["range_in_events"] and tr["range_in_file"], "path h3: no mpe/ range in the trace"
    assert tr["k2_in_file"] and tr["k2_device_ms"] > 0, "path h3: K2's kernel is not in the trace"
    return {"launches": launches, "checkpoint_mb": size_mb, "save_s": save_s, "load_s": load_s,
            "k2_device_ms": tr["k2_device_ms"]}


def h3_trace_rank(mesh, out_dir: str) -> None:
    """Path h3's trace (launched by ``checkpoint_trace_h3`` as one rank, a
    fresh process): ``utils.trace`` over one K2 call in a ``step_phase``,
    after a warm call. In the script's own process, after the earlier
    paths' profiler passes, torch.profiler kept no device record of K2, and
    none of most K3 calls; a fresh process keeps them. Writes
    ``h3_trace.json``."""
    import tempfile

    import torch

    from mpe_tpu_torch.ops.fused_rollout import fused_rollout
    from mpe_tpu_torch.utils import step_phase, trace

    wrappers = kernel_wrappers()
    run = fused_rollout("simple_spread", N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS,
                        device=mesh.device)
    run(0)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            with step_phase("fused_rollout"):
                run(1)
                torch.cuda.synchronize()
        files = list(Path(tmp).glob("trace.*.json"))
        assert len(files) == 1, files
        text = files[0].read_text()
    events = prof.key_averages()
    phase = [e for e in events if e.key == "mpe/fused_rollout"]
    k2 = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
          and "scenario_rollout_kernel" in e.key]
    with open(f"{out_dir}/h3_trace.json", "w") as f:
        json.dump({"launches": wrappers["scenario_rollout_kernel"].launches,
                   "range_in_events": bool(phase), "range_in_file": "mpe/fused_rollout" in text,
                   "k2_in_file": "scenario_rollout_kernel" in text,
                   "k2_device_ms": sum(device_us(e) for e in k2) / 1e3,
                   "range_host_ms": max((e.cpu_time_total for e in phase), default=0.0) / 1e3,
                   "trace_kb": len(text) / 1e3}, f)


def multidevice_path(wrappers, one_process_ms: dict, card: str) -> dict:
    """Path h: h1, h2 and h3, the counts zeroed before each and read after;
    ``card`` is the nvidia-smi name and power limit its times are taken on."""
    print(f"path h on {card}")
    t0 = time.perf_counter()
    h = {"h1": multidevice_h1(wrappers), "h2": multidevice_h2(wrappers, one_process_ms, card),
         "h3": checkpoint_trace_h3(wrappers)}
    h["seconds"] = time.perf_counter() - t0
    print(f"path h: {h['seconds']:.1f} s on {card}")
    return h


class Laps:
    """The seconds of main's phases: each call records the time since the
    last under the label of the phase that just ended (summed where a label
    comes again)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.seconds[label] = self.seconds.get(label, 0.0) + now - self.t
        self.t = now


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
    from mpe_tpu_torch.ops.fused_parity import det_group, plain_det_rollout_blocked
    from mpe_tpu_torch.ops.fused_policy import (fused_policy_rollout, fused_policy_trajectory,
                                                policy_tile, policy_traj_cuda)
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    add_policy_ops()
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off (plain versions)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t_start = t0 = time.perf_counter()
    lap = Laps()
    logs = _build.build_all(HIDDEN_PHASE + WIDE_PHASE)
    compile_s = {f"{src} at {h}": round(v, 1) for (src, h), v in _build.COMPILE_SECONDS.items()}
    for source in _build.SOURCES:
        _build.library(source)
    for h in HIDDEN_PHASE + WIDE_PHASE:
        for source in _build.HIDDEN_SOURCES:
            if h in _build.HIDDEN_WIDTHS[source]:
                _build.library(source, h)
    build_s = time.perf_counter() - t0
    lap("1: build")
    print(f"kernel build: {build_s:.1f} s ({len(logs)} libraries: every source "
          f"at hidden 64, {', '.join(_build.HIDDEN_SOURCES)} also at {HIDDEN_PHASE}, "
          + ", ".join(s for s in _build.HIDDEN_SOURCES if WIDE_PHASE[0] in _build.HIDDEN_WIDTHS[s])
          + f" also at {WIDE_PHASE})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}")
    regs = ptxas_registers({k: v for k, v in logs.items() if isinstance(k, str)})
    regs_at = {h: ptxas_registers({k: v for k, v in logs.items() if k[1:] == (h,)})
               for h in HIDDEN_PHASE + WIDE_PHASE}
    hmma = hmma_counts((_build.DEFAULT_HIDDEN,) + HIDDEN_PHASE + WIDE_PHASE)
    hmma9 = hmma_counts((_build.DEFAULT_HIDDEN,) + HIDDEN_PHASE + WIDE_PHASE, "mpe_maddpg_bf16.cu")
    hmma32 = hmma_counts(WIDE_PHASE, "mpe_update.cu")

    spec = scenarios.load("simple_spread").spec
    kscn = kernel_scenario("simple_spread")
    wrappers = kernel_wrappers()
    lap("1: registers and SASS")

    # ---- main paths ----------------------------------------------------------
    launches, k2_by, k1_by, k2, k2_ms_at, k1_ms, det_inputs, generic_rate = rollout_path(
        wrappers, spec, torch.device("cuda"))
    lap("2a: rollouts")
    # K5 runs in paths b, b2, b3 and b4; K6 in b and b3; K7 in b2 and b4. Each
    # path's launches are read just after it, by instantiation where the
    # kernel is a template over the scenarios
    k5_by, k6_by, k7_by = {}, {}, {}
    trainers, collect_ms, iter_ms, last_metrics = {}, {}, {}, {}
    for label, name, build, update in (("train", "simple_spread", build_fused_ppo_step, "ppo"),
                                       ("MAPPO", "simple_spread", build_fused_mappo_step, "mappo"),
                                       ("comm PPO", COMM_PPO, build_fused_ppo_step, "ppo"),
                                       ("comm MAPPO", COMM_MAPPO, build_fused_mappo_step, "mappo")):
        path_launches, step_, state0_, state_, phases_, last_metrics[label] = training_path(
            wrappers, kernel_scenario(name), build, f"{label} ({name})",
            ["policy_traj_kernel", f"{update}_update_kernel"])
        by = read_instantiations(policy_traj_cuda, [name], f"{label} path's K5")
        k5_by[name] = k5_by.get(name, 0) + by[name]
        kb = k6_by if update == "ppo" else k7_by
        kb[name] = kb.get(name, 0) + path_launches[f"{update}_update_kernel"]
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v
        trainers[label] = (step_, state0_, state_)
        collect_ms[f"{label} ({name})"] = phases_["collect"]
        iter_ms[label] = sum(phases_.values())
    lap("2b-b4: trainers")
    # path b5: the bf16 trainers on simple_spread (K5, K6-bf16; K5, K7-bf16)
    bf16 = bf16_path(wrappers, {"ppo": last_metrics["train"], "mappo": last_metrics["MAPPO"]})
    for kind, (path_launches, _, _, _, phases_, _) in bf16.items():
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v
        k5_by["simple_spread"] += path_launches["policy_traj_kernel"]
        iter_ms[f"{kind}-bf16"] = sum(phases_.values())
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
    lap("2b5: bf16 trainers")
    eval_launches, k4_by, k4_runs = evaluation_path(wrappers, evals)
    launches.update(eval_launches)
    lap("2c: evaluation")
    actor = evals["simple_spread"]
    # MADDPG: path d (simple_spread), then d2 and d3 with comm heads; K8 and K9
    # launches summed over the three paths, by scenario
    maddpg_runs, k8_by, k9_by = {}, {}, {}
    for name, n_chunks in (("simple_spread", MADDPG_CHUNKS),) + MADDPG_COMM:
        path_launches, by, *maddpg_runs[name] = maddpg_path(wrappers, name, n_chunks)
        collect_ms[f"MADDPG ({name})"] = maddpg_runs[name][4]
        for k, v in path_launches.items():
            launches[k] = launches.get(k, 0) + v
        k8_by.update(by["maddpg_traj_kernel"])
        k9_by.update(by["maddpg_update_kernel"])
    run, mparams, minfo, *_ = maddpg_runs["simple_spread"]
    lap("2d-d3: MADDPG")
    # path d4: the bf16 MADDPG update (K8, K9-bf16) on D4_NAMES
    d4 = bf16_maddpg_path(wrappers, maddpg_runs)
    launches["maddpg_update_bf16_kernel"] = 0
    k9b_by = {}
    for name, r in d4.items():
        for k, v in r["launches"].items():
            launches[k] += v
        k8_by[name] += r["launches"]["maddpg_traj_kernel"]
        k9b_by[name] = r["launches"]["maddpg_update_bf16_kernel"]
    lap("2d4: bf16 MADDPG")
    scn_launches, scn_by, k1_scn_ms, k2_scn_ms, k3_ms = scenarios_path(wrappers,
                                                                       torch.device("cuda"))
    lap("2e: scenarios and trajectories")
    # K1 and K2 ran in path a (simple_spread) and path e (the eight others)
    launches["det_rollout_kernel"] += scn_launches["det_rollout_kernel"]
    launches["scenario_rollout_kernel"] += scn_launches["scenario_rollout_kernel"]
    launches["trajectory_kernel"] = scn_launches["trajectory_kernel"]
    k1_by.update(scn_by["det_rollout_kernel"])
    k2_by.update(scn_by["scenario_rollout_kernel"])
    k3_by = scn_by["trajectory_kernel"]
    # path f: the env API and the non-fused learners; K4 runs in paths c and f
    f_launches, f_by, es_step, es_params0, es_ms = env_api_path(
        wrappers, mparams, generic_rate, {"PPO": iter_ms["train"], "MAPPO": iter_ms["MAPPO"]})
    launches["policy_rollout_kernel"] += f_launches["policy_rollout_kernel"]
    for name, n in f_by.items():
        k4_by[name] = k4_by.get(name, 0) + n
    es_err, es_figures = check_es_generation(es_step, es_params0, es_ms)
    lap("2f: env API and learners")
    # path g: the MADDPG variants (K8 collects in g1-g3, K9 runs in none, g4
    # runs no kernel), then g5: does the port's MADDPG learn (K8, K9)
    g_figures, k8_sub_err = variants_path(wrappers)
    g_figures["g5"] = maddpg_learns_phase(wrappers)
    lap("2g: MADDPG variants")
    for phase, f in g_figures.items():
        for k, n in f.get("launches", {}).items():
            launches[k] += n
    k8_g = {"simple_spread": sum(g_figures[p]["launches"]["maddpg_traj_kernel"]
                                 for p in ("g1", "g3", "g5")),
            G_ENSEMBLE: sum(g_figures[p]["launches"]["maddpg_traj_kernel"]
                            for p in ("g2", "g2_probe"))}
    for name, n in k8_g.items():
        k8_by[name] = k8_by.get(name, 0) + n
    k9_by["simple_spread"] += g_figures["g5"]["launches"]["maddpg_update_kernel"]
    d_chunk = MADDPG["n_envs"] * MADDPG["horizon"] / maddpg_runs["simple_spread"][3] * 1e3
    print("path g beside the vanilla chunk (ms per chunk, collect + update): "
          + "; ".join(f"{p} {g_figures[p]['chunk_ms']:.3f} ({g_figures[p]['collect_ms']:.3f} + "
                      f"{g_figures[p]['update_ms']:.3f})" for p in ("g1", "g2", "g2_probe", "g3"))
          + f"; g5 (vanilla, 64 envs) {g_figures['g5']['collect_ms'] + g_figures['g5']['update_ms']:.3f}"
          f" ({g_figures['g5']['collect_ms']:.3f} + {g_figures['g5']['update_ms']:.3f}); path d "
          f"(vanilla, {MADDPG['n_envs']} envs) {d_chunk:.3f}")
    # path i: the side layers (renderer, policies, CLI, examples), before path
    # h starts a process group; its launches go into the totals by sub-phase
    i_figures = side_layers_path(wrappers, generic_rate,
                                 N_ENVS * N_STEPS / (k2_ms_at[N_ENVS] * 1e-3))
    for counts in i_figures["launches"].values():
        for k, n in counts.items():
            launches[k] += n
    zero_launches(wrappers)
    lap("2i: side layers")

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
        check_iteration(label, stp, st0)

    # K6 and K7 on every scenario (epoch 0: the ratio is 1 and the value clip
    # idle, so the pg mean is 0 up to rounding and is not gated there; then
    # with both clips binding), the main paths' trainers where they ran
    k6_rows = check_update_kernels("ppo", {"simple_spread": (step, state[0]),
                                           COMM_PPO: (cstep, cstate[0])})
    k7_rows = check_update_kernels("mappo", {"simple_spread": (mstep, mstate[0]),
                                             COMM_MAPPO: (lstep, lstate[0])})
    # K6-bf16 and K7-bf16 on spread (path b5's trainers) and a comm head each
    bf16_rows = check_bf16_kernels({(kind, "simple_spread"): (r[1], r[3][0])
                                    for kind, r in bf16.items()})
    # K5 and K4 on every scenario, the main paths' actors where they ran
    trainer_actors = {"simple_spread": actor, COMM_PPO: evals[COMM_PPO],
                      COMM_MAPPO: actor_of(lstate[0], ("a1", "a2"))}
    k5_rows, k4_rows, policy_tiles = check_policy_kernels(trainer_actors)

    # ---- the main paths' shapes: K4 on every actor path c evaluated, K5 with
    # every trainer's actor at the training shape; checked and timed there
    k4_main, k5_main = check_main_policy_shapes(k4_runs, evals, trainer_actors)
    k4_ms, plain_k4_ms = k4_main["simple_spread"][1:3]
    k5_ms, plain_k5_ms = k5_main["simple_spread"][1:3]
    # the plain K2 and K1 of simple_spread timed once at K1_PLAIN_STEPS steps,
    # as the other scenarios' plain K1: their outputs are compared nowhere
    plain_k2 = fused_spread_rollout(spec, N_ENVS, K1_PLAIN_STEPS, horizon=HORIZON,
                                    block_envs=BLOCK_ENVS)
    plain_k2_ms, _ = cuda_time(lambda: plain_k2.plain(1), 1, warm_up=False)
    plain_k1 = plain_det_rollout_blocked("simple_spread", K1_PLAIN_STEPS, BLOCK_ENVS)
    plain_k1_ms, _ = cuda_time(lambda: plain_k1(*det_inputs), 1, warm_up=False)
    print(f"kernels at the main paths' shapes: K5 {k5_ms:.4f} ms ({TRAIN['n_envs']} envs x "
          f"{TRAIN['n_steps']} steps), K4 {k4_ms:.4f} ms; medians of {REPEATS}")
    print(f"plain versions on the card: K2 {plain_k2_ms:.1f} ms, K1 {plain_k1_ms:.1f} ms "
          f"({N_ENVS} envs x {K1_PLAIN_STEPS} steps); K5 {plain_k5_ms:.1f} ms, K4 "
          f"{plain_k4_ms:.1f} ms")
    lap("3: K1, K4-K7 against their plain versions")

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
        err, ms, plain_ms, bound, rows8, tile8 = check_maddpg_collect(name, actors)
        k8_rows[name] = scenario_row(k8_by, "maddpg_traj_kernel", name, err, ms, plain_ms, bound,
                                     tile=tile8)
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
    # K9-bf16 on three scenarios (fresh and the main path's trained params on
    # its ring), then one d4 update chunk under torch.profiler
    k9b_rows = {}
    for name in K9_BF16_NAMES:
        ring_b = maddpg_runs[name][2]["buffer"]
        k9b_rows[name] = check_maddpg_bf16(name, maddpg_runs[name][1],
                                           ring_b.data[:ring_b.size])
        k9b_rows[name]["launches"] = k9b_by.get(name, 0)
        k9b_rows[name]["registers_spill_bytes"] = registers_of(regs, "maddpg_update_bf16", name)
    for name, r in d4.items():
        k9b_rows[name]["path_d4"] = {k: v for k, v in r.items()
                                     if k not in ("params", "chunk", "buffer", "targets",
                                                  "opt_states")}
        k9b_rows[name].update(profile_maddpg_update(
            name, types.SimpleNamespace(update_chunk=r["chunk"]), r["params"],
            {k: r[k] for k in ("targets", "opt_states", "buffer")}, K9_BF16_KERNELS))
    del d4
    lap("3: K8, K9, K9-bf16 against their plain versions")
    k5_by_trainer = {"train (simple_spread)": "simple_spread",
                     "MAPPO (simple_spread)": "simple_spread", f"comm PPO ({COMM_PPO})": COMM_PPO,
                     f"comm MAPPO ({COMM_MAPPO})": COMM_MAPPO}
    print("collect phases beside their kernels (mean ms per iteration or chunk; the kernel's "
          "median at the same shape): " + "; ".join(
              f"{k} {v:.3f} (K5 {k5_main[k5_by_trainer[k]][1]:.4f})" if k in k5_by_trainer else
              f"{k} {v:.3f} (K8 {k8_rows[k[8:-1]]['ms']:.4f})" for k, v in collect_ms.items()))
    k3_device_ms = profile_trajectories(k3_ms)
    k2_err, k2_check_ms, plain_k2_long_ms, k3_err, plain_k3_ms = check_scenario_kernels()
    k3_group_ms = check_trajectory_groups()
    lap("3: K2, K3 against their plain versions")
    hidden = hidden_widths_phase(wrappers)
    lap("3b: hidden 8-32")
    wide = wide_widths_phase(wrappers, regs_at)
    lap("3c: hidden 128 and 256 (K4-K7)")
    wide_m = wide_maddpg_phase(wrappers, regs_at)
    lap("3d: hidden 128 and 256 (K8, K9, K9-bf16)")
    # path h, the multi-device path and checkpoint/trace, runs after every other
    # phase: it starts a process group (nccl) and launches ranks, and the
    # profiler passes above then run in a process that has done neither. Its DP
    # steps are printed beside one process at the same total width (paths b, b2, d)
    h = multidevice_path(wrappers, {"PPO": iter_ms["train"], "MAPPO": iter_ms["MAPPO"],
                                    "MADDPG": d_chunk}, smi)
    h_launches = {"h1": h["h1"]["launches"], "h3": h["h3"]["launches"],
                  **{f"h2_rank{r['rank']}": r["launches"] for r in h["h2"]["ranks"]}}
    for counts in h_launches.values():
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    zero_launches(wrappers)
    lap("2h: multi-device and checkpoint")

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
            plain_steps=K1_PLAIN_STEPS,
            group=det_group(kernel_scenario(name), N_ENVS))
    b1 = (k1_rows["simple_spread"]["bound_ms"], k1_rows["simple_spread"]["bound_by"])
    b5, by5, issue5 = k5_main["simple_spread"][3]
    b4, by4, issue4 = k4_main["simple_spread"][3]
    k3_rows = template_rows_k3(k3_ms, k3_device_ms, k3_by, k3_err, plain_k3_ms, k3_group_ms,
                               regs)
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
    k5_scn = {n: policy_row(n, "policy_traj_kernel", *k5_rows[n], k5_by,
                            tile=policy_tiles["K5", n]) for n in ALL_SCENARIOS}
    k4_scn = {n: policy_row(n, "policy_rollout_kernel", *k4_rows[n], k4_by,
                            tile=policy_tiles["K4", n]) for n in SCENARIOS}
    k4_scn["simple_spread"] = policy_row("simple_spread", "policy_rollout_kernel", k4_err,
                                         *k4_main["simple_spread"][1:], k4_by,
                                         tile=policy_tile(kscn, N_ENVS, "rollout"))
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
    k4_err = max([es_err] + [r["max_abs_err"] for r in k4_scn.values()])

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
        # envs x 10000 steps (path a), the plain version's at plain_steps;
        # by_scenario holds every instantiation at 4096 envs x 10000 steps,
        # with kernel and plain version also at the check shape (4096 envs x
        # 20 steps)
        record("scenario_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_rollout.py:359",
               max(k2_err.values()), k2_ms_at[N_ENVS], plain_k2_ms, b2,
               plain_steps=K1_PLAIN_STEPS, scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k2_rows,
               pair_physics=pair_physics, group=k2_rows["simple_spread"]["group"],
               group_rule=GROUP_RULE),
        # K3's top-level numbers are simple_spread's at 4096 envs x 64 steps
        record("trajectory_kernel", "mpe_trajectory.cu", "mpe_tpu/ops/fused_trajectory.py:40",
               max(k3_err.values()), k3_ms["simple_spread", N_ENVS], plain_k3_ms["simple_spread"],
               b3, scenarios=list(ALL_SCENARIOS), timed_on="simple_spread", by_scenario=k3_rows,
               pair_physics=pair_physics, group=k3_rows["simple_spread"]["group"],
               group_rule=TRAJ_GROUP_RULE),
        # K1's top-level numbers are simple_spread's at 4096 envs x 10000 steps,
        # the plain version's at plain_steps
        record("det_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_parity.py:99",
               max(k1_err.values()), k1_ms, plain_k1_ms, b1, plain_steps=K1_PLAIN_STEPS,
               scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k1_rows, pair_physics=pair_physics,
               group=k1_rows["simple_spread"]["group"], group_rule=DET_GROUP_RULE),
        # K5's top-level numbers are simple_spread's at the training shape
        # (horizon 32); by_scenario at the gate's (horizon 25)
        record("policy_traj_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:245",
               k5_err, k5_ms, plain_k5_ms, (b5, by5), scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k5_scn,
               tile=k5_scn["simple_spread"]["tile"], tile_rule=POLICY_TILE_RULE,
               collect_phase_ms={k: v for k, v in collect_ms.items() if "MADDPG" not in k}),
        # K4's top-level numbers are simple_spread's at the evaluation shape
        record("policy_rollout_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:90",
               k4_err, k4_ms, plain_k4_ms, (b4, by4), scenarios=list(ALL_SCENARIOS),
               timed_on="simple_spread", by_scenario=k4_scn,
               tile=k4_scn["simple_spread"]["tile"], tile_rule=POLICY_TILE_RULE,
               path_f_launches=f_by,
               es_generation={"scenario": F_ES_NAME, "hidden": F_ES_HIDDEN, **F_ES,
                              **es_figures, "max_abs_err": es_err}),
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
               max([k8_sub_err] + [r["max_abs_err"] for r in k8_rows.values()]),
               k8_rows["simple_spread"]["ms"],
               k8_rows["simple_spread"]["plain_ms"],
               (k8_rows["simple_spread"]["bound_ms"], k8_rows["simple_spread"]["bound_by"]),
               scenarios=list(ALL_SCENARIOS), timed_on="simple_spread", by_scenario=k8_rows,
               pair_physics=pair_physics, tile=k8_rows["simple_spread"]["tile"],
               tile_rule=POLICY_TILE_RULE,
               collect_phase_ms={k: v for k, v in collect_ms.items() if "MADDPG" in k},
               path_g=g_figures, path_g_launches_by=k8_g,
               sub_sliced_gate={"scenario": G_ENSEMBLE, "max_abs_err": k8_sub_err}),
        record("maddpg_update_kernel", "mpe_maddpg.cu",
               "mpe_tpu/ops/fused_maddpg_update.py:142", k9_err, k9_ms, plain_k9_ms, b9,
               lib_k9_ms, scenarios=list(ALL_SCENARIOS), timed_on="simple_spread",
               by_scenario=k9_rows, update_chunk_max_abs_err=chunk_err,
               transitions_per_s={n: r[3] for n, r in maddpg_runs.items()},
               from_trees_ms=k9_tree_ms, tile=K9_TILE,
               launches_per_update={n: k9_rows[n].get("launches_per_update")
                                    for n in maddpg_runs},
               path_g_launches={p: f.get("launches", {}).get("maddpg_update_kernel", 0)
                                for p, f in g_figures.items()}),
    ]
    # K6-bf16 and K7-bf16 (path b5): their top-level numbers are simple_spread's
    # at TRAIN's width; by_scenario holds spread's and the comm head's
    for kind, replaces in (("ppo", "mpe_tpu/ops/fused_update.py:188"),
                           ("mappo", "mpe_tpu/ops/fused_update.py:245")):
        name = f"{kind}_update_bf16_kernel"
        by = {n: dict(r, launches=bf16[kind][0][name] if n == "simple_spread" else 0,
                      registers_spill_bytes=registers_of(regs, f"{kind}_bf16", n))
              for n, r in bf16_rows[kind].items()}
        top = by["simple_spread"]
        _, _, _, _, phases_, last = bf16[kind]
        kernels.append(record(
            name, "mpe_update_bf16.cu", f"{replaces} (compute_dtype=bfloat16)",
            max(r["max_abs_err"] for r in by.values()), top["ms"], top["plain_ms"],
            (top["bound_ms"], top["bound_by"]), top["library_ms"], compute_dtype="bfloat16",
            scenarios=list(BF16_NAMES[kind]), timed_on="simple_spread", by_scenario=by,
            tile=BF16_TILE, sass_instructions=hmma, grad_tol=BF16_GRAD_TOL,
            path_b5={"ms_per_iteration_by_phase": phases_, "last_iteration": last,
                     "float32_last_iteration": last_metrics["train" if kind == "ppo" else
                                                            "MAPPO"]}))
    # K9-bf16 (path d4): its top-level numbers are simple_spread's on path d's
    # ring with path d's params; by_scenario holds the three gated scenarios
    top9 = k9b_rows["simple_spread"]
    kernels.append(record(
        "maddpg_update_bf16_kernel", "mpe_maddpg_bf16.cu",
        "mpe_tpu/ops/fused_maddpg_update.py:142 (compute_dtype=bfloat16)",
        max(r["max_abs_err"] for r in k9b_rows.values()), top9["ms"], top9["plain_ms"],
        (top9["bound_ms"], top9["bound_by"]), top9["library_ms"], compute_dtype="bfloat16",
        library="autograd of the losses in float32 (maddpg_xla_grads); no bf16 library "
                "computation exists",
        scenarios=list(K9_BF16_NAMES), timed_on="simple_spread", by_scenario=k9b_rows,
        tile=K9_BF16_TILE, sass_instructions=hmma9, grad_tol=BF16_GRAD_TOL,
        metric_rtol=BF16_METRIC_RTOL))
    # K4-K9 and K6-bf16, K7-bf16, K9-bf16 at the other hidden widths (phase 3b): errors
    # and registers by width
    reg_keys = {"policy_traj_kernel": "policy_traj_kernel",
                "policy_rollout_kernel": "policy_rollout_kernel", "ppo_update_kernel": "ppo",
                "mappo_update_kernel": "mappo", "maddpg_traj_kernel": "maddpg_traj_kernel",
                "maddpg_update_kernel": "maddpg_update", "ppo_update_bf16_kernel": "ppo_bf16",
                "mappo_update_bf16_kernel": "mappo_bf16",
                "maddpg_update_bf16_kernel": "maddpg_update_bf16"}
    for row in kernels:
        if row["name"] in reg_keys:
            row["hidden_widths"] = {
                h: {"max_abs_err": hidden[row["name"]][h],
                    "registers_spill_bytes": {n: registers_of(regs_at[h], reg_keys[row["name"]], n)
                                              for n in HIDDEN_NAMES}}
                for h in HIDDEN_PHASE}
            row["hidden_widths_phase"] = {"seconds": hidden["seconds"],
                                          "launches": hidden["launches"],
                                          "trainer_max_abs_err": hidden["trainer_max_abs_err"]}
            row["hidden_widths_compiled"] = list(
                _build.HIDDEN_WIDTHS[row["source"].rsplit("/", 1)[1]])
        # K4-K7 at 128 and 256 (phase 3c): by width the row's own figures
        if row["name"] in wide:
            row["wide_widths"] = wide[row["name"]]
            if row["name"] in ("ppo_update_kernel", "mappo_update_kernel"):
                for width, n in hmma32.items():
                    row["wide_widths"][width]["sass_instructions"] = n
            row["wide_widths_phase"] = {"seconds": wide["seconds"], "paths": wide["paths"],
                                        "examples": wide["examples"]}
        # K8 and K9 at 128 and 256 (phase 3d)
        if row["name"] in wide_m:
            row["wide_widths"] = wide_m[row["name"]]
            row["wide_widths_phase"] = {"seconds": wide_m["seconds"], "paths": wide_m["paths"]}
    # paths h and i per kernel: its launches by phase and rank (h) and by the
    # example that launched it (i); for the gradient kernels the DP step's ms
    # and the all_reduce of their gradient
    for row in kernels:
        row["path_h_launches"] = {p: c.get(row["name"], 0) for p, c in h_launches.items()}
        row["path_i_launches"] = {p: c[row["name"]] for p, c in i_figures["launches"].items()
                                  if row["name"] in c}
    dp_rows = {"ppo_update_kernel": ("PPO", "ppo_gradient"),
               "mappo_update_kernel": ("MAPPO", "mappo_gradient"),
               "maddpg_update_kernel": ("MADDPG", "maddpg_gradient")}
    for row in kernels:
        if row["name"] in dp_rows:
            kind, grad = dp_rows[row["name"]]
            row["path_h"] = {
                "h1_nccl_all_reduce_ms": h["h1"]["all_reduce_ms"].get(grad),
                **{f"h2_rank{r['rank']}": {"dp_step_ms": r["step_ms"][kind],
                                           "all_reduce_ms": r["all_reduce_ms"][grad],
                                           "backend": r["backend"]}
                   for r in h["h2"]["ranks"]}}
    lap("4-5: bounds and the kernels line")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"phase_seconds": {k: round(v, 1) for k, v in lap.seconds.items()},
                      "compile_seconds": compile_s, "build_wall_seconds": round(build_s, 1)}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

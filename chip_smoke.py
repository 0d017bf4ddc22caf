#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, then runs these phases; any
failure ends the run with a non-zero exit code:

  1. environment: card name and power limit, torch and CUDA versions,
     kernel build time and the compiler's register report;
  2. three main paths, each with every kernel's launch count set to 0 just
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
       c. evaluation: fused_policy_rollout of the trained actor (kernel K4),
          4096 envs x 1000 steps, horizon 25; mean return per episode;
  3. every kernel held against its plain PyTorch version on the card: K1
     and K2 over 20 steps (K2 with horizon 10, so resets happen); K5 and K4
     over 16 steps with horizon 8, two block offsets, and at the main paths'
     shapes; K6 on a batch of the trainer and on the same batch with both
     clips binding; one whole trainer iteration (params and metrics)
     against the same iteration with the plain K5 and K6;
  4. the plain versions timed at the main paths' shapes, each kernel's bound
     from the operations its function needs (OPS below), and for K6 the
     same gradient by autograd of the trainer's loss (the library yardstick);
  5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
     line, and ``{"ok": true, "device": {...}}`` as the last line.

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

# Kernel against plain version on the card, 20 steps. The library is built
# with -fmad=false, so the dynamics round op for op as PyTorch's
# elementwise ops do; what is left is the order of the obs-checksum sum.
TOL = {"pos": 1e-5, "vel": 1e-5, "rew_sum": 1e-4, "rew": 1e-5, "obs": 1e-5, "obs_sum": 1e-3,
       "ret": 1e-5, "last_obs": 1e-5, "act": 0.0, "episodes": 0.0, "params": 1e-5}
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


def cuda_time(fn, repeats: int):
    """(median ms, last output) of ``fn()`` over ``repeats`` runs after one
    warm-up, by CUDA events on the current stream."""
    import torch

    out = fn()
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
    is torch.einsum, so torch.matmul): the library yardstick for K6, timed
    here only and never on the port's path. The loss normalizes the
    advantages again, a near-identity on the normalized ones."""
    import torch

    leaves = {k: {q: x.detach().requires_grad_(True) for q, x in layer.items()}
              for k, layer in params.items()}
    loss, _ = step.loss_fn(leaves, batch)
    return torch.autograd.grad(loss, [x for layer in leaves.values() for x in layer.values()])


def rollout_path(wrappers, spec, dev):
    """Main path a: generic engine, K2 at three widths, K1."""
    import torch

    from mpe_tpu_torch import scenarios
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.ops.fused_parity import fused_det_rollout, make_det_inputs
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout
    from mpe_tpu_torch.parallel.mesh import build_rollout

    zero_launches(wrappers)
    env = MpeEnv(scenarios.load("simple_spread"), max_steps=HORIZON, auto_reset=True)
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
    assert rew.shape == (GENERIC_STEPS, 3, N_ENVS) and bool(torch.isfinite(rew).all())
    assert traj["obs"].shape == (GENERIC_STEPS, 3, 18, N_ENVS)
    assert bool(torch.isfinite(states.pos).all())
    g_mean, g_se = mean_se(rew[:, 0, :].mean(0))
    print(f"generic engine: {N_ENVS * GENERIC_STEPS / generic_s:.6g} env-steps/s "
          f"({N_ENVS} envs x {GENERIC_STEPS} steps in {generic_s * 1e3:.1f} ms); "
          f"mean reward per env-step {g_mean:.5f} +- {g_se:.5f}")

    k2 = fused_spread_rollout(spec, N_ENVS, N_STEPS, horizon=HORIZON, block_envs=BLOCK_ENVS)
    k2_ms, out = cuda_time(lambda: k2(1), REPEATS)
    pos, vel, rew_sum, obs_sum = out
    assert pos.shape == (6, 2, N_ENVS) and rew_sum.shape == (1, N_ENVS)
    for x in out:
        assert bool(torch.isfinite(x).all())
    f_mean, f_se = mean_se(rew_sum[0] / N_STEPS)
    print(f"fused engine (K2): {N_ENVS * N_STEPS / (k2_ms * 1e-3):.6g} env-steps/s "
          f"({N_ENVS} envs x {N_STEPS} steps, kernel {k2_ms:.4f} ms, median of {REPEATS}); "
          f"mean reward per env-step {f_mean:.5f} +- {f_se:.5f}")
    z = abs(f_mean - g_mean) / math.hypot(f_se, g_se)
    print(f"fused vs generic mean reward: {z:.2f} standard errors apart")
    assert z < 5, f"fused and generic engines disagree in mean reward ({z:.2f} SE)"

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


def training_path(wrappers, kscn):
    """Main path b: TRAIN_ITERS iterations of the fused PPO trainer (K5, K6),
    timed by phase with CUDA events."""
    import torch

    from mpe_tpu_torch.learner import build_fused_ppo_step

    step = build_fused_ppo_step(kscn, **TRAIN)
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
        assert all(math.isfinite(v) for v in m.values()), f"iteration {i}: metrics {m}"
        iters.append((total, phases, m))
        print(f"train iter {i:2d}: {total:8.3f} ms ({step.n_transitions / (total * 1e-3):.6g} "
              f"transitions/s); " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
              + f" ms; mean_reward {m['mean_reward']:.5f}, entropy {m['entropy']:.5f}, "
              f"loss {m['loss']:.5f}")
    launches = read_launches(wrappers, ["spread_policy_traj_kernel", "ppo_update_kernel"],
                             "training path")
    steady = iters[1:]          # iteration 0 sets up the batched forward
    total_ms = sum(t for t, _, _ in steady)
    phase_ms = {k: sum(p[k] for _, p, _ in steady) for k in steady[0][1]}
    print(f"training, iterations 1-{TRAIN_ITERS - 1}: "
          f"{step.n_transitions * len(steady) / (total_ms * 1e-3):.6g} transitions/s "
          f"({len(steady)} x {step.n_transitions} transitions in {total_ms:.3f} ms); mean per "
          f"iteration {total_ms / len(steady):.3f} ms: "
          + ", ".join(f"{k} {v / len(steady):.3f} ms" for k, v in phase_ms.items())
          + f"; median per iteration {statistics.median(t for t, _, _ in steady):.3f} ms")
    for i in (0, 9, 19):
        m = iters[i][2]
        print(f"train iter {i}: mean_reward {m['mean_reward']:.6f}, entropy {m['entropy']:.6f}, "
              f"loss {m['loss']:.6f}, pg_loss {m['pg_loss']:.6f}, v_loss {m['v_loss']:.6f}")
    return launches, step, state0, state


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
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_parity import (fused_det_rollout, plain_det_rollout_blocked,
                                                spread_det_rollout_cuda)
    from mpe_tpu_torch.ops.fused_policy import (fused_policy_rollout, fused_policy_trajectory,
                                                spread_policy_rollout_cuda,
                                                spread_policy_traj_cuda)
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout, spread_rollout_cuda
    from mpe_tpu_torch.ops.fused_update import clip_binding_inputs, ppo_update_cuda
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
                "spread_det_rollout_kernel": spread_det_rollout_cuda,
                "spread_policy_traj_kernel": spread_policy_traj_cuda,
                "spread_policy_rollout_kernel": spread_policy_rollout_cuda,
                "ppo_update_kernel": ppo_update_cuda}

    # ---- main paths ----------------------------------------------------------
    launches, k2, k2_ms_at, k1_ms, det_inputs = rollout_path(wrappers, spec, torch.device("cuda"))
    train_launches, step, state0, state = training_path(wrappers, kscn)
    launches.update(train_launches)
    eval_launches, k4, actor, k4_ms, k4_out = evaluation_path(wrappers, kscn, state[0])
    launches.update(eval_launches)
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
    plain_k2_ms, _ = cuda_time(lambda: k2.plain(1), 1)
    plain_k1 = plain_det_rollout_blocked("simple_spread", N_STEPS, BLOCK_ENVS)
    plain_k1_ms, _ = cuda_time(lambda: plain_k1(*det_inputs), 1)
    samples = obs.shape[0] * obs.shape[1] * obs.shape[3]
    print(f"kernels at the main paths' shapes: K5 {k5_ms:.4f} ms ({TRAIN['n_envs']} envs x "
          f"{TRAIN['n_steps']} steps), K6 {k6_ms:.4f} ms (one epoch, {samples} samples), "
          f"K4 {k4_ms:.4f} ms; medians of {REPEATS}")
    print(f"plain versions on the card: K2 {plain_k2_ms:.1f} ms, K1 {plain_k1_ms:.1f} ms "
          f"({N_ENVS} envs x {N_STEPS} steps); K5 {plain_k5_ms:.1f} ms, K6 {plain_k6_ms:.3f} ms, "
          f"K4 {plain_k4_ms:.1f} ms; K6 by autograd of the trainer's loss {lib_k6_ms:.3f} ms")

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
    for label, ms, (b, by, issue) in (("K5", k5_ms, (b5, by5, issue5)),
                                      ("K4", k4_ms, (b4, by4, issue4)),
                                      ("K6", k6_ms, (b6, by6, issue6))):
        print(f"{label} bound: {b:.4f} ms by {by} ({ms / b:.2f}x); issue floor {issue:.4f} ms "
              f"({ms / issue:.2f}x)")

    def record(name, source, replaces, err, ms, plain_ms, bound, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"mpe_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    kernels = [
        record("spread_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_rollout.py:359",
               k2_err, k2_ms_at[N_ENVS], plain_k2_ms, (b2, by2)),
        record("spread_det_rollout_kernel", "mpe_kernels.cu", "mpe_tpu/ops/fused_parity.py:99",
               k1_err, k1_ms, plain_k1_ms, (b1, by1)),
        record("spread_policy_traj_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:245",
               k5_err, k5_ms, plain_k5_ms, (b5, by5)),
        record("spread_policy_rollout_kernel", "mpe_policy.cu", "mpe_tpu/ops/fused_policy.py:90",
               k4_err, k4_ms, plain_k4_ms, (b4, by4)),
        record("ppo_update_kernel", "mpe_update.cu", "mpe_tpu/ops/fused_update.py:188",
               k6_err, k6_ms, plain_k6_ms, (b6, by6), lib_k6_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

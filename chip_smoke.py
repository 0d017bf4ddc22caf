#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, then runs these phases; any
failure ends the run with a non-zero exit code:

  1. environment: card name and power limit, torch and CUDA versions,
     kernel build time and the compiler's register report;
  2. main path, with every kernel's launch count set to 0 before it and
     read after it:
       - generic engine: build_rollout over MpeEnv, simple_spread,
         4096 envs x 200 steps, horizon 100, env-minor;
       - fused engine (kernel K2): fused_spread_rollout at 4096 envs x 10000
         steps, horizon 100, block_envs 1024 (the bench's headline config),
         and at 16384 and 65536 envs;
       - deterministic rollout (kernel K1): fused_det_rollout on
         make_det_inputs, 4096 envs x 10000 steps;
     the fused mean reward per env-step must agree with the generic
     engine's within 5 standard errors;
  3. K1 and K2 held against their plain PyTorch versions on the card over
     short rollouts (20 steps; K2 with horizon 10, so resets happen);
  4. the plain versions timed at the main path's shapes, and each kernel's
     bound from the operations its function needs (OPS below);
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

# Kernel against plain version on the card, 20 steps. The library is built
# with -fmad=false, so the dynamics round op for op as PyTorch's
# elementwise ops do; what is left is the order of the obs-checksum sum.
TOL = {"pos": 1e-5, "vel": 1e-5, "rew_sum": 1e-4, "rew": 1e-5, "obs": 1e-5, "obs_sum": 1e-3}

# H100 SXM at its 700 W limit: 3.35 TB/s of HBM; 132 SMs at a 1.98 GHz boost
# clock, each completing per clock 128 fp32 operations (the 67 TFLOP/s of
# the data sheet counts an FMA as 2 flops), 16 special-function operations
# (rsqrt, rcp, ex2, lg2), 64 int32 operations and 16 int->float conversions
# (the CUDA C++ Programming Guide's throughput table, compute capability 9.0).
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
# csrc/mpe_kernels.cu (simple_spread: 3 agents, 3 landmarks, 3 pairs). Each
# multiply, add, min, max, compare and select is one operation; a negation
# or an absolute value is an operand modifier and free; a special function
# is one SFU operation plus the fp32 operations that scale its argument or
# result (exp: x log2e; log1p: 1 + y and x ln2; sqrt: x rsqrt(x)). The
# divide by the loop-invariant contact margin is a product with its
# reciprocal, computed once, and the correction of a correctly rounded
# quotient: 3 fp32. Control flow and data movement are not operations.
# Loop-invariant index arithmetic is hoisted.
HASH = {"int": 10, "cvt": 1, "fp32": 1}     # + salt, fmix32 (3 shifts, 3 xors, 2 multiplies),
#                                             >> 8; to float; x 2^-24
DECODE = {"fp32": 4}                        # per agent: 2 differences, 2 products with accel
PAIR_FORCE = {"fp32": 24, "sfu": 3}         # dx, dy; d2 (3); max; d2 inv; - dmin; / margin (3);
#                                             logaddexp (max, exp 1, log1p 2, add); x margin,
#                                             x contact_force, x inv, x dx, x dy; 4 accumulations
INTEGRATE = {"fp32": 10}                    # per agent and axis: v keep + f dt (3), p + v dt (2)
LANDMARK_DIST = {"fp32": 6, "sfu": 1}       # 2 differences, 2 squares, add, sqrt
PAIR_COLLISION = {"fp32": 8}                # dx, dy, d2 (3), compare, select, add
REWARD_REST = {"fp32": 13}                  # 6 mins over agents, 3 sums over landmarks,
#                                             A base - coll - A (3), accumulate
OBS_SUM = {"fp32": 78}                      # 30 relative coordinates, 16 nonzero rows x 2 adds
#                                             over agents, 15 adds over rows, accumulate
SPREAD_STEP = ((12, HASH), (3, DECODE), (3, PAIR_FORCE), (3, INTEGRATE), (9, LANDMARK_DIST),
               (3, PAIR_COLLISION), (1, REWARD_REST))  # 12 hashes: the no-op column is unread
OPS = {
    # step: + the move salt (1 int), the horizon counter and test (2 int);
    # a reset (and the initial draw) hashes 12 coordinates, scales and shifts
    # each (2 fp32) and salts twice
    "spread_rollout_kernel": {
        "step": _ops(*SPREAD_STEP, (1, OBS_SUM), (3, {"int": 1})),
        "reset": _ops((12, HASH), (12, {"fp32": 2}), (2, {"int": 1})),
        "env": {},
    },
    # step: + the per-step salt (1 int) and one add per agent (3 int); once per
    # env: the final obs, 30 relative coordinates
    "spread_det_rollout_kernel": {
        "step": _ops(*SPREAD_STEP, (4, {"int": 1})),
        "reset": {},
        "env": {"fp32": 30},
    },
}


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
    from mpe_tpu_torch.envs.functional import MpeEnv
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_parity import (fused_det_rollout, make_det_inputs,
                                                plain_det_rollout_blocked,
                                                spread_det_rollout_cuda)
    from mpe_tpu_torch.ops.fused_rollout import fused_spread_rollout, spread_rollout_cuda
    from mpe_tpu_torch.parallel.mesh import build_rollout

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {src}: {line.strip()}")

    spec = scenarios.load("simple_spread").spec
    wrappers = {"spread_rollout_kernel": spread_rollout_cuda,
                "spread_det_rollout_kernel": spread_det_rollout_cuda}

    # ---- main path ---------------------------------------------------------
    for w in wrappers.values():
        w.launches = 0

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

    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"main-path launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel of the path was never launched"

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

    # ---- plain versions at the main path's shapes ---------------------------
    plain_k2_ms, _ = cuda_time(lambda: k2.plain(1), 1)
    plain_k1 = plain_det_rollout_blocked("simple_spread", N_STEPS, BLOCK_ENVS)
    plain_k1_ms, _ = cuda_time(lambda: plain_k1(*det_inputs), 1)
    print(f"plain versions on the card: K2 {plain_k2_ms:.1f} ms, K1 {plain_k1_ms:.1f} ms "
          f"({N_ENVS} envs x {N_STEPS} steps)")

    # bytes: K2 writes pos, vel (2 x 6 x 2 floats), rew_sum and obs_sum per
    # env; K1 reads pos0, vel0 and writes pos, vel, rew_sum, rew and obs [3,18]
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
    kernels = [
        {"name": "spread_rollout_kernel", "route": "cuda",
         "source": "mpe_tpu_torch/csrc/mpe_kernels.cu",
         "replaces": "mpe_tpu/ops/fused_rollout.py:359",
         "launches": launches["spread_rollout_kernel"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": plain_k2_ms, "bound_ms": b2, "bound_by": by2,
         "library_ms": None},
        {"name": "spread_det_rollout_kernel", "route": "cuda",
         "source": "mpe_tpu_torch/csrc/mpe_kernels.cu",
         "replaces": "mpe_tpu/ops/fused_parity.py:99",
         "launches": launches["spread_det_rollout_kernel"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": plain_k1_ms, "bound_ms": b1, "bound_by": by1,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

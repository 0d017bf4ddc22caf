#!/usr/bin/env python3
"""Time the port's update kernels of one or more checkouts on one NVIDIA
card, one checkout after another.

    python3 tools/torch_update_ab.py [--maddpg | --rollout | --det] ROOT [ROOT ...]

Each ROOT is a checkout holding ``mpe_tpu_torch/``. Each runs in a process
of its own, which imports that checkout's package and builds its kernels,
in the order given: pass ``parent change change parent`` to compare two
versions on one card within one call. Each process prints one JSON line:
the root, the card's name and power limit as ``nvidia-smi`` gives them, and
the times below.

Without a mode (K6, K7): the trainers of chip_smoke.py's paths b (PPO on
simple_spread), b2 (MAPPO on simple_spread), b3 (PPO on simple_reference)
and b4 (MAPPO on simple_speaker_listener) at tools/train_bench.py's learner
batch (4096 envs x 64 steps, horizon 32, hidden 64) collect one batch from
a seeded init, and ``step.update`` (one epoch's gradient: K6, or K7's actor
and critic passes) is timed by CUDA events, the median of 20 calls after 3
warm-ups; then one more call under torch.profiler gives its device time by
kernel (each instantiation of ``ppo_update_kernel`` and the reduces, by
their demangled names) and the device's busy share of the call; beside
them, the registers and spill bytes of each ``ppo_update_kernel``
instantiation from the compiler's ``-Xptxas -v`` report (empty where the
kernels were already built).

With ``--maddpg`` (K8, K9): ``build_fused_maddpg_runner(name, n_envs=1024,
horizon=25, batch=1024)`` (tools/train_bench.py's fused_maddpg row) on
simple_spread (path d, 40 chunks), simple_speaker_listener (d2, 40) and
simple_world_comm (d3, 8), actor_start 250, each chunk timed by CUDA
events and split into collect and update; then one more update chunk of
the runner's own loop (``packed_step`` on a packed state) under
torch.profiler: K9's device time per update split by its four kernels,
the device's busy share and the kernel launches per update; then K9 as the
trainer calls it (``MaddpgUpdateLauncher.launch`` on the packed buffers
where the checkout has it, else ``grads_fn.from_rows`` on trees) and
``grads_fn.from_rows`` on 1024 rows of the final ring, each the median of
20 calls after 3 warm-ups. Per path it prints transitions/s over the
chunks after the first, the mean and median collect and update ms per
chunk, and those K9 numbers.

With ``--rollout`` (K2): ``fused_rollout`` on the nine scenarios at 4096
envs x 10,000 steps (horizon 100, block_envs 1024: bench.py's headline
shape) and on simple_spread at 16,384 and 65,536 envs, each the median of
3 CUDA-event timed calls after one warm-up; where the checkout's K2 takes a
group size (threads per env lane), the group ``rollout_group`` picks and
the time at every group 1, 2, 4 and 8 too; and the registers and spill
bytes of each ``scenario_rollout_kernel`` instantiation (empty where the
kernels were already built).

With ``--det`` (K1): ``fused_det_rollout`` on ``make_det_inputs(name,
n_envs, seed=0)`` for the nine scenarios at 4096 envs x 10,000 steps
(block_envs 1024, chip_smoke.py's path a and e shape) and on simple_spread
at 16,384 and 65,536 envs, each the median of 3 CUDA-event timed calls
after one warm-up; where the checkout's K1 takes a group size
(``fused_parity.det_group``), that group and the time at every group 1, 2,
4 and 8 too (``det_rollout_cuda(..., group=g)``); and the registers and
spill bytes of each ``det_rollout_kernel`` instantiation.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

TRAIN = dict(n_envs=4096, n_steps=64, horizon=32, hidden=64, block_envs=1024, t_chunk=8)
MADDPG = dict(n_envs=1024, horizon=25, batch=1024)
CHUNKS, ACTOR_START = 40, 250
WARM_UP, CALLS = 3, 20


ROLLOUT = dict(n_envs=4096, n_steps=10_000, horizon=100, block_envs=1024)
ROLLOUT_WIDE = (16_384, 65_536)
ROLLOUT_REPEATS = 3
SCENARIOS = ("simple_spread", "simple", "simple_reference", "simple_speaker_listener",
             "simple_adversary", "simple_push", "simple_crypto", "simple_tag", "simple_world_comm")
MADDPG_PATHS = (("simple_spread", 40), ("simple_speaker_listener", 40), ("simple_world_comm", 8))
K9_KERNELS = ("maddpg_target_actions_kernel", "maddpg_td_kernel", "maddpg_update_kernel",
              "maddpg_reduce_kernel")


def registers(logs: dict, source: str = "mpe_update.cu", kernel: str = "ppo_update_kernel"
              ) -> dict:
    """{mangled ``kernel`` name: [registers, spill store bytes]} from the
    compiler's report on ``source``."""
    out, current = {}, None
    for line in logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
            if current:
                out[current] = [None, 0]
        elif current:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[current][1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[current][0] = int(m.group(1))
    return out


def median_ms(fn) -> float:
    """The median CUDA-event time of ``fn()`` over CALLS calls after WARM_UP."""
    import torch

    for _ in range(WARM_UP):
        fn()
    times = []
    for _ in range(CALLS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_call(fn) -> dict:
    """One call of ``fn`` under torch.profiler after a warm-up: device ms by
    kernel name and launches, and the device's busy share of the call's
    CUDA-event time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and us(e) > 0]
    if not dev:
        return {"profiled": "not measured (no device events)"}
    split = {e.key: [us(e) / 1e3, e.count] for e in dev}
    wall = start.elapsed_time(end)
    return {"device_ms_by_kernel": split, "device_ms": sum(v for v, _ in split.values()),
            "call_event_ms": wall, "device_busy_share": sum(v for v, _ in split.values()) / wall}


def time_ppo(result: dict, logs: dict) -> None:
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    import torch

    for path, name, build in (("b", "simple_spread", build_fused_ppo_step),
                              ("b2", "simple_spread", build_fused_mappo_step),
                              ("b3", "simple_reference", build_fused_ppo_step),
                              ("b4", "simple_speaker_listener", build_fused_mappo_step)):
        step = build(name, **TRAIN)
        params = step.init_params(torch.Generator().manual_seed(0))
        obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
        args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        row = {"scenario": name, "ms": median_ms(lambda: step.update(*args))}
        row.update(profile_call(lambda: step.update(*args)))
        result[path] = row
        del step, args, obs, mv_oh, cm_oh, logp_old, value, adv_n, ret
        torch.cuda.empty_cache()
    result["registers_spill_bytes"] = registers(logs)


def profile_update_chunk(run, params, info) -> dict:
    """One more update chunk of the runner's own loop (``packed_step`` on a
    packed state) under torch.profiler: K9's device ms per update by kernel,
    the device's busy share of the chunk and its kernel launches per update."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mpe_tpu_torch.learner.fused_loop import actor_gates

    h = MADDPG["horizon"]
    chunk = run.update_chunk
    gates = actor_gates(CHUNKS, h, ACTOR_START)
    state = chunk.pack_state(params, info["targets"], info["opt_states"])
    state, _ = chunk.packed_step(state, info["buffer"], 1, gates)        # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        chunk.packed_step(state, info["buffer"], 2, gates)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    dev = [e for e in dev if us(e) > 0]
    if not dev:
        return {"profiled": "not measured (no device events)"}
    split = {k: sum(us(e) for e in dev if k in e.key) / 1e3 / h for k in K9_KERNELS}
    busy = sum(us(e) for e in dev) / 1e3
    return {"k9_device_ms": sum(split.values()), "k9_device_split_ms": split,
            "chunk_event_ms": wall_ms, "device_busy_share": busy / wall_ms,
            "launches_per_update": sum(e.count for e in dev) / h}


def time_k9_calls(run, params, info) -> dict:
    """K9 as the trainer calls it and ``grads_fn.from_rows`` on trees, on
    1024 rows of the final ring, each the median of CALLS calls."""
    import torch

    buf = info["buffer"]
    gen = torch.Generator("cuda").manual_seed(5)
    rows = buf.data[torch.randint(0, buf.size, (MADDPG["batch"],), generator=gen,
                                  device="cuda")].contiguous()
    chunk = run.update_chunk
    out = {"k9_from_rows_ms": median_ms(
        lambda: chunk.grads_fn.from_rows(params, info["targets"], rows))}
    if hasattr(chunk, "layout"):          # the packed chunk: K9's launcher on the flat buffers
        from mpe_tpu_torch.ops.fused_maddpg_update import MaddpgUpdateLauncher

        lay = chunk.layout
        k9 = MaddpgUpdateLauncher(lay.a, lay.o, lay.k, 5, lay.hidden, MADDPG["batch"], "cuda",
                                  gamma=0.95, ent_coef=0.01)
        weights = lay.pack(params, info["targets"]).cuda()
        grads = torch.empty(lay.off_ta, device="cuda")
        metrics = torch.empty(3, device="cuda")
        out["k9_trainer_call_ms"] = median_ms(lambda: k9.launch(weights, rows, grads, metrics))
    else:
        out["k9_trainer_call_ms"] = out["k9_from_rows_ms"]
    return out


def time_maddpg(result: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner

    for name, n_chunks in MADDPG_PATHS:
        run = build_fused_maddpg_runner(name, **MADDPG)
        events = []
        params, info = run(n_chunks * MADDPG["horizon"], seed=0, actor_start=ACTOR_START,
                           events=events)
        torch.cuda.synchronize()
        chunks = [(events[2 * c][1].elapsed_time(events[2 * c + 1][1]),
                   events[2 * c + 1][1].elapsed_time(events[2 * c + 2][1]))
                  for c in range(n_chunks)]
        steady = chunks[1:]              # chunk 0 sets up the update's first allocations
        row = dict(
            transitions_per_s=run.transitions_per_chunk * len(steady)
            / (sum(a + b for a, b in steady) * 1e-3),
            collect_ms=sum(a for a, _ in steady) / len(steady),
            update_ms=sum(b for _, b in steady) / len(steady),
            collect_median_ms=statistics.median(a for a, _ in steady),
            update_median_ms=statistics.median(b for _, b in steady))
        row.update(profile_update_chunk(run, params, info))
        row.update(time_k9_calls(run, params, info))
        result[name] = row
        del run, info
        torch.cuda.empty_cache()


def time_rollout(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.ops import fused_rollout as fr

    def median_of(run) -> float:
        run(0)
        times = []
        for r in range(ROLLOUT_REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(r + 1)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    grouped = hasattr(fr, "rollout_group")
    shapes = [(name, ROLLOUT["n_envs"]) for name in SCENARIOS]
    shapes += [("simple_spread", n) for n in ROLLOUT_WIDE]
    for name, n in shapes:
        kw = dict(ROLLOUT, n_envs=n)
        row = {"ms": median_of(fr.fused_rollout(name, **kw))}
        if grouped:
            from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

            kscn = kernel_scenario(name)
            row["group"] = fr.rollout_group(kscn, n)
            for g in fr.GROUPS:
                row[f"ms_group_{g}"] = median_of(
                    lambda seed, g=g: fr.rollout_cuda(kscn, n, kw["n_steps"], kw["horizon"],
                                                      kw["block_envs"], seed, 0, "cuda", group=g))
        result[f"{name}@{n}"] = row
    result["registers_spill_bytes"] = registers(logs, "mpe_kernels.cu", "scenario_rollout_kernel")


DET = dict(n_envs=4096, n_steps=10_000, block_envs=1024)


def time_det(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.ops import fused_parity as fp
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    def median_of(fn) -> float:
        fn()
        times = []
        for _ in range(ROLLOUT_REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    grouped = hasattr(fp, "det_group")
    shapes = [(name, DET["n_envs"]) for name in SCENARIOS]
    shapes += [("simple_spread", n) for n in ROLLOUT_WIDE]
    for name, n in shapes:
        inputs = fp.make_det_inputs(name, n, seed=0)
        run = fp.fused_det_rollout(name, n, DET["n_steps"], block_envs=DET["block_envs"])
        row = {"ms": median_of(lambda: run(*inputs))}
        if grouped:
            kscn = kernel_scenario(name)
            row["group"] = fp.det_group(kscn, n)
            for g in (1, 2, 4, 8):
                row[f"ms_group_{g}"] = median_of(
                    lambda g=g: fp.det_rollout_cuda(kscn, DET["n_steps"], DET["block_envs"],
                                                    *inputs, group=g))
        result[f"{name}@{n}"] = row
        del inputs
    result["registers_spill_bytes"] = registers(logs, "mpe_kernels.cu", "det_rollout_kernel")


def child(mode: str, root: str) -> None:
    sys.path.insert(0, root)
    import mpe_tpu_torch
    from mpe_tpu_torch.ops import _build

    assert mpe_tpu_torch.__file__.startswith(root), mpe_tpu_torch.__file__
    logs = _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"root": root, "card": smi.splitlines()[0]}
    if mode == "maddpg":
        time_maddpg(result)
    elif mode == "rollout":
        time_rollout(result, logs)
    elif mode == "det":
        time_det(result, logs)
    else:
        time_ppo(result, logs)
    print(json.dumps(result), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--child":
        child(args[1], args[2])
        return 0
    mode = {"--maddpg": "maddpg", "--rollout": "rollout", "--det": "det"}.get(
        args[0] if args else "", "ppo")
    roots = args if mode == "ppo" else args[1:]
    if not roots or any(r.startswith("-") for r in roots):
        print(__doc__, file=sys.stderr)
        return 2
    import os

    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", mode, os.path.abspath(root)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

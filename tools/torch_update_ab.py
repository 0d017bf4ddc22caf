#!/usr/bin/env python3
"""Time the port's update kernels of one or more checkouts on one NVIDIA
card, one checkout after another.

    python3 tools/torch_update_ab.py [--maddpg | --maddpg-bf16 | --rollout | --det | --policy |
        --trajectory | --bf16 | --bf16-stages | --maddpg-bf16-phases | --wide | --bf16-wide |
        --bf16-wide-stages | --maddpg-bf16-wide] ROOT [ROOT ...]

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

With ``--bf16`` (K6-bf16, K7-bf16): the same four paths' batches, each
epoch gradient timed with the float32 trainer's ``step.update`` (K6, K7)
and with the ``compute_dtype=torch.bfloat16`` trainer's (K6-bf16, K7-bf16)
on that same batch, each as above (CUDA events, then torch.profiler); the
registers and spill bytes of each ``ppo_update_bf16_kernel``
instantiation.

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

With ``--maddpg-bf16`` (K9, K9-bf16): the runner of each of paths d, d2
and d3 as with ``--maddpg`` (its chunks not timed), then on 1024 rows of its
final ring with its final params and targets, K9 and K9-bf16 as the trainer
calls them (``MaddpgUpdateLauncher.launch`` on the packed buffers, float32
and ``compute_dtype=torch.bfloat16``), each the median of CALLS CUDA-event
timed calls after WARM_UP, then one call each under torch.profiler: the
device time of every kernel the call launched, summed, their launches a
call and each kernel's share by name (whatever kernels the checkout's
K9-bf16 launches), or "not measured", and the device's busy share of the
call; the registers and spill bytes of each K9-bf16 kernel instantiation
(every kernel on ``MaddpgBf16Dims``).

With ``--bf16-stages`` (K6-bf16, K7-bf16, where their time goes): copies
of the checkout's ``csrc/mpe_update_bf16.cu`` with one stage cut at a time
(the tanh of the forward, the head, the weight-gradient pass, the backward
products; the cut copies compute a wrong gradient and are only timed), each
built with the library's flags at hidden 64 into ``build/variants/``, and
the bf16 trainer's ``step.update`` on paths b's and b2's batches with each:
the device time of its ``ppo_update_bf16_kernel`` records by torch.profiler.

With ``--bf16-wide-stages`` (K6-bf16, K7-bf16 at hidden 128 and 256, where
their time goes): the same, on ``ppo_update_bf16_wide_kernel`` at each
width, with ``csrc/bf16_wide.cuh`` inlined into each copy so that its parts
can be cut too: the streamed weights' copies into the rings (the products
run on what the rings hold), the partial's reads and writes in the
weight-gradient adds (their products kept), the two weight-gradient adds
whole, the head, the forward's tanh; each copy's ``update_round_bf16_kernel``
and ``ppo_update_bf16_wide_kernel`` records summed.

With ``--maddpg-bf16-phases`` (K9-bf16's phases): a copy of the checkout's
``csrc/mpe_maddpg_bf16.cu`` whose gradient and target/TD kernels stamp
``clock64`` at each phase boundary and ``%globaltimer`` at each CTA's start
and end, built as above, and launched on 1024 random rows of paths d, d2,
d3's widths (init_maddpg params from seed 1, targets + 0.1 N(0, 1)): the
median cycles of each phase over the CTAs and the largest, each warp's
cycles in phase 2, the CTAs' start and end spread in ns, and the SM clock by
``nvidia-smi``.

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

With ``--policy`` (K4, K5, K8), on the nine scenarios, each with a fixed
seeded actor (``init_policy``, and ``init_maddpg``'s actors with the head
scaled by 100 for O(1) logits, from seed 40 + the scenario's index): K4
(``policy_rollout_cuda``) at path c's shape, 4096 envs x 1000 steps,
horizon 25; K5 (``policy_traj_cuda``) at the learner batch, 4096 x 64,
horizon 32, t_chunk 8; K8 (``maddpg_traj_cuda``, the rows form) at the
MADDPG paths' shape, 1024 envs x 25 steps, horizon 25, eps 0.1, the chunk
``collect_t_chunk`` gives; all with block_envs 1024, seed 1. Each the
median of POLICY_CALLS CUDA-event timed calls after one warm-up; where the
checkout's kernels take a tile size (``policy_tile``, ``maddpg_tile``),
the tile the rule picks and the time at every tile offered; a SHA-256 of
each output tensor's bytes, so that two checkouts can be compared bit for
bit within one call; and the registers and spill bytes of each
``policy_traj_kernel``, ``policy_rollout_kernel`` and ``maddpg_traj_kernel``
instantiation (the largest spill of the kernel and the functions it calls).

With ``--wide`` (K4-K9 at hidden 128 and 256): at each width, K6 and K7 on
paths b's and b2's batches (simple_spread at the learner batch, a trainer of
that width from a seeded init) as without a mode (CUDA events, then
torch.profiler) and a SHA-256 of the gradient and metrics, and K5 (4096 x 64) and K4 (4096 x 1000) with a seeded
``init_policy`` actor of that width as with ``--policy`` (the rule's tile, a
SHA-256 of each output); the registers and spill bytes of each
``ppo_update_wide_kernel``, ``policy_traj_kernel`` and
``policy_rollout_kernel`` instantiation at that width; then K8 (the rows form
at 1024 envs x 25 steps) and K9 (its launcher on 1024 of those rows) on
simple_spread and simple_world_comm with a seeded ``init_maddpg`` of that
width: ms by CUDA events (K9 also over 100 back-to-back calls), K9's device
ms a call (the mean of 5 calls under torch.profiler), a SHA-256 of K8's rows
and of K9's gradient, and the
registers and spill bytes of every ``mpe_maddpg.cu`` kernel. At hidden 8, 16,
32 and 64 the same K8 and K9 figures on simple_spread (at 64 also on
simple_speaker_listener and simple_world_comm, paths d2's and d3's comm
heads), so that two checkouts
show those widths' outputs bit for bit and K9's device time side by side. A
checkout whose kernels refuse a width records the refusal.

With ``--bf16-wide`` (K6, K7, K6-bf16, K7-bf16 at every hidden width): at
each of 8, 16, 32, 64, 128 and 256, the float32 and the
``compute_dtype=torch.bfloat16`` trainers of paths b and b2 (simple_spread
at the learner batch, a seeded init of that width) on one batch of the
float32 trainer's: each ``step.update`` timed by CUDA events (the median of
CALLS calls after WARM_UP), one call under torch.profiler (device ms by
kernel), and a SHA-256 of its gradient and metrics, so that two checkouts
show each kernel's outputs bit for bit where both take the width; the
registers and spill bytes of each ``ppo_update_bf16_kernel`` and
``ppo_update_bf16_wide_kernel`` instantiation at 64, 128 and 256. A
checkout whose kernels refuse a width records the refusal.

With ``--maddpg-bf16-wide`` (K9-bf16 at every hidden width): on seeded
``init_maddpg`` params of that width (the actors' head scaled to O(1)
logits, targets = params + 0.1 N(0, 1)) and 1024 seeded replay rows with
one-hot actions, K9-bf16's launcher (``MaddpgUpdateLauncher(...,
compute_dtype=torch.bfloat16)`` on the packed buffers) at 8, 16, 32 and 64 on
simple_spread (at 64 also on simple_speaker_listener and simple_world_comm)
and at 128 and 256 on simple_spread and simple_world_comm: the median
CUDA-event ms of CALLS calls after WARM_UP, the ms of 100 back-to-back calls,
one call under torch.profiler (the device ms of every kernel it launched, by
name, and their launches) and a SHA-256 of its gradient, metrics and target
actions, so that two checkouts show the widths both take bit for bit; at 128
and 256 also K9 (float32) on the same buffers the same way; the registers
and spill bytes of every ``mpe_maddpg_bf16.cu`` kernel at 128 and 256. A
checkout whose K9-bf16 refuses a width records the refusal. Only
``mpe_maddpg_bf16.cu`` and ``mpe_maddpg.cu`` are built at the widths other
than 64.

With ``--trajectory`` (K3): ``fused_trajectory`` on the nine scenarios at
4096 envs x 64 steps and on simple_spread, simple_reference and
simple_world_comm (chip_smoke.py's TRAJ_WIDE) at 65,536 envs x 64 steps
(horizon 32, block_envs 1024, t_chunk 8: chip_smoke.py's path e), seed 1:
the median of TRAJ_CALLS calls through the builder, host work included, by
CUDA events around the call and by the host clock to its synchronize; the
median device time of ``trajectory_kernel`` over TRAJ_CALLS calls under
torch.profiler; a SHA-256 of each output; where the checkout's K3 takes a
group (``traj_group``), the rule's G and, at every G of 1, 2, 4, 8
(``trajectory_cuda(..., group=g)``), the device time and whether every
output equals the rule's bit for bit; and the registers and spill bytes of each
``trajectory_kernel`` instantiation.
"""

from __future__ import annotations

import hashlib
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


def registers(logs: dict, source: str = "mpe_update.cu",
              kernel: str | tuple[str, ...] = "ppo_update_kernel") -> dict:
    """{mangled ``kernel`` name (or any of several): [registers, spill store
    bytes]} from the compiler's report on ``source``; the spills are the
    largest of the entry's and of the functions reported after it."""
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    out, current = {}, None
    for line in logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if any(k in m.group(1) for k in kernels) else None
            if current:
                out[current] = [None, 0]
        elif current:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[current][1] = max(out[current][1], int(m.group(1)))
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


def time_bf16(result: dict, logs: dict) -> None:
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    import torch

    for path, name, build in (("b", "simple_spread", build_fused_ppo_step),
                              ("b2", "simple_spread", build_fused_mappo_step),
                              ("b3", "simple_reference", build_fused_ppo_step),
                              ("b4", "simple_speaker_listener", build_fused_mappo_step)):
        steps = {"float32": build(name, **TRAIN),
                 "bf16": build(name, compute_dtype=torch.bfloat16, **TRAIN)}
        params = steps["float32"].init_params(torch.Generator().manual_seed(0))
        obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = steps["float32"].collect(params, 3)
        args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        row = {"scenario": name}
        for label, step in steps.items():
            row[label] = {"ms": median_ms(lambda: step.update(*args)),
                          **profile_call(lambda: step.update(*args))}
        result[path] = row
        del steps, args, obs, mv_oh, cm_oh, logp_old, value, adv_n, ret
        torch.cuda.empty_cache()
    result["registers_spill_bytes"] = registers(logs, "mpe_update_bf16.cu",
                                                "ppo_update_bf16_kernel")


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


def call_device_ms(fn) -> dict:
    """One call of ``fn`` under torch.profiler (``profile_call``): the device
    ms of every kernel the call launched, summed, their launches (the
    records), each kernel's ms and launches by its name, and the device's
    busy share of the call; "not measured" without device records."""
    prof = profile_call(fn)
    split = prof.get("device_ms_by_kernel")
    if not split:
        return {"device_ms": "not measured", "launches_per_call": "not measured"}
    by_name = {}
    for key, (ms, count) in split.items():
        m = re.search(r"(\w+_kernel)", key)
        name = m.group(1) if m else key[:60]
        old_ms, old_count = by_name.get(name, (0.0, 0))
        by_name[name] = (old_ms + ms, old_count + count)
    return {"device_ms": sum(v for v, _ in split.values()),
            "launches_per_call": sum(c for _, c in split.values()),
            "device_ms_by_kernel": {k: list(v) for k, v in by_name.items()},
            "device_busy_share": prof.get("device_busy_share", "not measured")}


def time_maddpg_bf16(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner
    from mpe_tpu_torch.ops.fused_maddpg_update import MaddpgUpdateLauncher

    for path, (name, n_chunks) in zip(("d", "d2", "d3"), MADDPG_PATHS):
        run = build_fused_maddpg_runner(name, **MADDPG)
        params, info = run(n_chunks * MADDPG["horizon"], seed=0, actor_start=ACTOR_START)
        buf = info["buffer"]
        gen = torch.Generator("cuda").manual_seed(5)
        rows = buf.data[torch.randint(0, buf.size, (MADDPG["batch"],), generator=gen,
                                      device="cuda")].contiguous()
        lay = run.update_chunk.layout
        weights = lay.pack(params, info["targets"]).cuda()
        grads = torch.empty(lay.off_ta, device="cuda")
        metrics = torch.empty(3, device="cuda")
        row = {"scenario": name}
        for label, cd in (("K9", torch.float32), ("K9-bf16", torch.bfloat16)):
            k9 = MaddpgUpdateLauncher(lay.a, lay.o, lay.k, 5, lay.hidden, MADDPG["batch"], "cuda",
                                      gamma=0.95, ent_coef=0.01, compute_dtype=cd)

            def call(k9=k9):
                k9.launch(weights, rows, grads, metrics)

            row[label] = {"ms": median_ms(call), **call_device_ms(call)}
        result[path] = row
        del run, info, buf
        torch.cuda.empty_cache()
    result["registers_spill_bytes"] = registers(logs, "mpe_maddpg_bf16.cu", "MaddpgBf16Dims")


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


POLICY_K4 = dict(n_envs=4096, n_steps=1000, horizon=25, block_envs=1024)
POLICY_K5 = dict(n_envs=4096, n_steps=64, horizon=32, block_envs=1024, t_chunk=8)
POLICY_K8 = dict(n_envs=1024, n_steps=25, horizon=25, block_envs=1024, eps_greedy=0.1)
POLICY_CALLS = 5


def sha256s(outs) -> list[str]:
    """The SHA-256 of each output tensor's bytes (the first 16 hex digits)."""
    return [hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
            for x in outs]


def leaves(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples, dicts by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree] if hasattr(tree, "contiguous") else []


def time_policy(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import init_policy
    from mpe_tpu_torch.learner.maddpg import collect_t_chunk, init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg as fm
    from mpe_tpu_torch.ops import fused_policy as fp
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    def median_of(fn):
        out = fn()
        times = []
        for _ in range(POLICY_CALLS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), out

    def timed(fn, rule, tiles) -> dict:
        """fn(tile) at the rule's tile (None: the checkout has no tiles) and at
        every tile offered; the rule's outputs hashed."""
        ms, out = median_of(lambda: fn(None))
        row = {"ms": ms, "sha256": sha256s(out if isinstance(out, tuple) else (out,))}
        if rule is not None:
            row["tile"] = rule
            for t in tiles:
                row[f"ms_tile_{t}"] = median_of(lambda: fn(t))[0]
        return row

    tiled = hasattr(fp, "policy_tile")
    k8_t_chunk = collect_t_chunk(POLICY_K8["n_steps"])
    for i, name in enumerate(SCENARIOS):
        kscn = kernel_scenario(name)
        gen = torch.Generator().manual_seed(40 + i)
        actor = {k: {q: x.cuda() for q, x in layer.items()}
                 for k, layer in init_policy(gen, kscn.obs_w, kscn.n_logits).items()}
        weights = fp._kernel_weights(actor, "cuda")
        mactor = init_maddpg(torch.Generator().manual_seed(40 + i), kscn.obs_w, kscn.n_logits,
                             kscn.spec.n_agents)["actor"]
        mactor["out"]["w"] = mactor["out"]["w"] * 100.0
        mweights = fm._kernel_weights(mactor, "cuda")
        kw = lambda t: {} if t is None else {"tile": t}
        k4, k5, k8 = POLICY_K4, POLICY_K5, POLICY_K8
        rows = {
            "K4": timed(lambda t: fp.policy_rollout_cuda(
                kscn, weights, k4["n_envs"], k4["n_steps"], k4["horizon"], k4["block_envs"], 1,
                0, "cuda", **kw(t)),
                fp.policy_tile(kscn, k4["n_envs"], "rollout") if tiled else None,
                getattr(fp, "POLICY_TILES", ())),
            "K5": timed(lambda t: fp.policy_traj_cuda(
                kscn, weights, k5["n_envs"], k5["n_steps"], k5["horizon"], k5["block_envs"],
                k5["t_chunk"], 1, 0, "cuda", **kw(t)),
                fp.policy_tile(kscn, k5["n_envs"], "traj") if tiled else None,
                getattr(fp, "POLICY_TILES", ())),
            "K8": timed(lambda t: fm.maddpg_traj_cuda(
                kscn, mweights, k8["n_envs"], k8["n_steps"], k8["horizon"], k8["block_envs"],
                k8_t_chunk, k8["eps_greedy"], 1, 0, True, "cuda", **kw(t)),
                fm.maddpg_tile(kscn, k8["n_envs"]) if tiled else None,
                getattr(fm, "MADDPG_TILES", ())),
        }
        result[name] = rows
        torch.cuda.empty_cache()
    result["registers_spill_bytes"] = {
        **registers(logs, "mpe_policy.cu", ("policy_traj_kernel", "policy_rollout_kernel")),
        **registers(logs, "mpe_maddpg.cu", "maddpg_traj_kernel")}


WIDE = (128, 256)
NARROW = (8, 16, 32, 64)
WIDE_MADDPG_NAMES = ("simple_spread", "simple_world_comm")
# at hidden 64 K8 and K9 also on paths d2's and d3's scenarios (the comm heads)
NARROW_MADDPG_NAMES = {64: ("simple_spread", "simple_speaker_listener", "simple_world_comm")}
K9_PROFILED_CALLS = 5


def k9_device_ms(fn) -> float | None:
    """The device ms of one call of ``fn`` (a K9 launch: four kernels whose
    names hold "maddpg_"), the mean over K9_PROFILED_CALLS calls under
    torch.profiler after one; None without device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(K9_PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    dev = [us(e) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and "maddpg_" in e.key]
    return sum(dev) / 1e3 / K9_PROFILED_CALLS if sum(dev) > 0 else None


def loop_ms(fn, n: int = 100) -> float:
    """The CUDA-event time of ``n`` back-to-back calls of ``fn`` over ``n``,
    after a warm-up: where a call's device work outlasts its launches, its
    device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_maddpg_at(name: str, h: int) -> dict:
    """K8 (the rows form, 1024 envs x 25 steps, a seeded init_maddpg actor of
    width ``h`` with O(1) logits) and K9 (its launcher on the first 1024 of
    those rows, targets = params + 0.1) on ``name``: ms by CUDA events (K9
    also a call of 100 back to back), K9's device ms a call, a SHA-256 of K8's
    rows and of K9's gradient."""
    import torch

    from mpe_tpu_torch.learner.maddpg import collect_t_chunk, init_maddpg
    from mpe_tpu_torch.ops import fused_maddpg as fm
    from mpe_tpu_torch.ops.fused_maddpg_update import MaddpgUpdateLauncher
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    a, ow, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
    k8 = POLICY_K8
    params = {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
              for n, net in init_maddpg(torch.Generator().manual_seed(90 + h), ow, k, a,
                                        hidden=h).items()}
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    weights = fm._kernel_weights(params["actor"], "cuda")
    t_chunk = collect_t_chunk(k8["n_steps"])

    def collect():
        return fm.maddpg_traj_cuda(kscn, weights, k8["n_envs"], k8["n_steps"], k8["horizon"],
                                   k8["block_envs"], t_chunk, k8["eps_greedy"], 1, 0, True,
                                   "cuda")

    rows = collect()
    row = {"K8": {"ms": median_ms(collect), "sha256": sha256s((rows,)),
                  "tile": fm.maddpg_tile(kscn, k8["n_envs"], hidden=h)}}
    batch = MADDPG["batch"]
    rows_b = rows.reshape(-1, rows.shape[-1])[:batch].contiguous()
    k9 = MaddpgUpdateLauncher(a, ow, k, 5, h, batch, "cuda", gamma=0.95, ent_coef=0.01)
    targets = {n: {q: {w: x + 0.1 for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    wbuf = k9.layout.pack(params, targets).cuda()
    grads = torch.empty(k9.layout.off_ta, device="cuda")
    metrics = torch.empty(3, device="cuda")
    launch = lambda: k9.launch(wbuf, rows_b, grads, metrics)
    launch()
    row["K9"] = {"ms": median_ms(launch), "loop_ms": loop_ms(launch),
                 "device_ms": k9_device_ms(launch), "sha256": sha256s((grads, metrics))}
    return row


def time_wide(result: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step, init_policy
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops import fused_policy as fp
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario("simple_spread")
    # every library the checkout takes, built at once (one nvcc each, in parallel)
    pairs = [(s, h) for h in WIDE for s in ("mpe_policy.cu", "mpe_update.cu")] + [
        ("mpe_maddpg.cu", h) for h in WIDE + NARROW]
    built = _build.build([(s, h) for s, h in pairs if h in _build.HIDDEN_WIDTHS.get(s, ())])
    for h in WIDE:
        row = result[f"hidden_{h}"] = {}
        try:
            logs = _build.build([(s, h) for s in ("mpe_policy.cu", "mpe_update.cu")])
        except (NotImplementedError, ValueError) as e:
            row["refused"] = str(e)
            continue
        logs = {pair: built.get(pair, "") for pair in logs}
        for path, build in (("b", build_fused_ppo_step), ("b2", build_fused_mappo_step)):
            step = build("simple_spread", **dict(TRAIN, hidden=h))
            params = step.init_params(torch.Generator().manual_seed(0))
            obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
            args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
            row[path] = {"ms": median_ms(lambda: step.update(*args)),
                         **profile_call(lambda: step.update(*args)),
                         "sha256": sha256s(leaves(step.update(*args)))}
            del step, args, obs, mv_oh, cm_oh, logp_old, value, adv_n, ret
            torch.cuda.empty_cache()
        actor = {k: {q: x.cuda() for q, x in layer.items()} for k, layer in
                 init_policy(torch.Generator().manual_seed(40), kscn.obs_w, kscn.n_logits,
                             hidden=h).items()}
        weights = fp._kernel_weights(actor, "cuda")
        k4, k5 = POLICY_K4, POLICY_K5
        for kernel, fn, tile in (
                ("K4", lambda: fp.policy_rollout_cuda(
                    kscn, weights, k4["n_envs"], k4["n_steps"], k4["horizon"], k4["block_envs"],
                    1, 0, "cuda"), fp.policy_tile(kscn, k4["n_envs"], "rollout", hidden=h)),
                ("K5", lambda: fp.policy_traj_cuda(
                    kscn, weights, k5["n_envs"], k5["n_steps"], k5["horizon"],
                    k5["block_envs"], k5["t_chunk"], 1, 0, "cuda"),
                 fp.policy_tile(kscn, k5["n_envs"], "traj", hidden=h))):
            out = fn()
            row[kernel] = {"ms": median_ms(fn), "tile": tile, "sha256": sha256s(out)}
        row["registers_spill_bytes"] = {
            **registers({s: logs[s, h] for s in ("mpe_update.cu",)}, "mpe_update.cu",
                        "ppo_update_wide_kernel"),
            **registers({s: logs[s, h] for s in ("mpe_policy.cu",)}, "mpe_policy.cu",
                        ("policy_traj_kernel", "policy_rollout_kernel"))}
    # K8 and K9 at the wide widths (a checkout whose mpe_maddpg.cu refuses
    # them records the refusal), and at 8-64, where both trees run the same
    # kernels: the outputs' hashes and K9's device time, to compare
    for h in WIDE + NARROW:
        row = result.setdefault(f"hidden_{h}", {})
        try:
            logs = _build.build([("mpe_maddpg.cu", h)])
        except (NotImplementedError, ValueError) as e:
            row["maddpg_refused"] = str(e)
            continue
        logs = {pair: built.get(pair, "") for pair in logs}
        names = WIDE_MADDPG_NAMES if h in WIDE else NARROW_MADDPG_NAMES.get(h, ("simple_spread",))
        for name in names:
            row[f"maddpg {name}"] = time_maddpg_at(name, h)
            torch.cuda.empty_cache()
        row["maddpg_registers_spill_bytes"] = registers(
            {"mpe_maddpg.cu": logs["mpe_maddpg.cu", h]}, "mpe_maddpg.cu",
            ("maddpg_traj_kernel", "maddpg_target_actions", "maddpg_td", "maddpg_update",
             "maddpg_reduce"))


BF16_WIDE = (8, 16, 32, 64, 128, 256)


def time_bf16_wide(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build

    # every library of the two update sources the checkout takes, built at once
    built = _build.build([(s, h) for h in BF16_WIDE for s in ("mpe_update.cu", "mpe_update_bf16.cu")
                          if h in _build.HIDDEN_WIDTHS.get(s, (64,))])
    built["mpe_update_bf16.cu", 64] = logs.get("mpe_update_bf16.cu", "")
    for h in BF16_WIDE:
        row = result[f"hidden_{h}"] = {}
        for path, build in (("b", build_fused_ppo_step), ("b2", build_fused_mappo_step)):
            steps = {"float32": build("simple_spread", **dict(TRAIN, hidden=h)),
                     "bf16": build("simple_spread", compute_dtype=torch.bfloat16,
                                   **dict(TRAIN, hidden=h))}
            params = steps["float32"].init_params(torch.Generator().manual_seed(0))
            obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = steps["float32"].collect(params, 3)
            args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
            row[path] = {}
            for label, step in steps.items():
                try:
                    out = step.update(*args)
                except NotImplementedError as e:
                    row[path][label] = {"refused": str(e)}
                    continue
                row[path][label] = {"ms": median_ms(lambda: step.update(*args)),
                                    **profile_call(lambda: step.update(*args)),
                                    "sha256": sha256s(leaves(out))}
            del steps, args, obs, mv_oh, cm_oh, logp_old, value, adv_n, ret
            torch.cuda.empty_cache()
        if h >= 64 and ("mpe_update_bf16.cu", h) in built:
            row["registers_spill_bytes"] = registers(
                {"mpe_update_bf16.cu": built["mpe_update_bf16.cu", h]}, "mpe_update_bf16.cu",
                ("ppo_update_bf16_kernel", "ppo_update_bf16_wide_kernel"))


BF16_MADDPG_NAMES = {64: ("simple_spread", "simple_speaker_listener", "simple_world_comm"),
                     128: WIDE_MADDPG_NAMES, 256: WIDE_MADDPG_NAMES}


def maddpg_case(name: str, h: int):
    """Seeded init_maddpg params of width ``h`` (the actors' head scaled to
    O(1) logits), targets = params + 0.1 N(0, 1) and MADDPG["batch"] replay
    rows with one-hot actions, on the card -> (agents, obs width, head width,
    params, targets, rows)."""
    import torch

    from mpe_tpu_torch.learner.maddpg import init_maddpg
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    kscn = kernel_scenario(name)
    a, ow, k, b = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits, MADDPG["batch"]
    gen = torch.Generator().manual_seed(60 + h)
    params = init_maddpg(gen, ow, k, a, hidden=h)
    params["actor"]["out"]["w"] = params["actor"]["out"]["w"] * 100.0
    targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen)
                       for w, x in layer.items()} for q, layer in net.items()}
               for n, net in params.items()}
    act = torch.nn.functional.one_hot(torch.randint(0, 5, (b, a), generator=gen), 5).float()
    if k > 5:
        act = torch.cat([act, torch.nn.functional.one_hot(
            torch.randint(0, k - 5, (b, a), generator=gen), k - 5).float()], -1)
    rows = torch.cat([torch.randn((b, a * ow), generator=gen), act.reshape(b, -1),
                      torch.randn((b, a), generator=gen) - 2.0,
                      torch.randn((b, a * ow), generator=gen)], 1)
    cuda = lambda t: {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
                      for n, net in t.items()}
    return a, ow, k, cuda(params), cuda(targets), rows.cuda().contiguous()


def time_maddpg_bf16_wide(result: dict, logs: dict) -> None:
    import torch

    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops.fused_maddpg_update import MaddpgUpdateLauncher

    # the two MADDPG update sources at every width each takes, built at once;
    # a launcher loads only those (the other MLP sources are not needed here)
    _build.HIDDEN_SOURCES = ("mpe_maddpg.cu", "mpe_maddpg_bf16.cu")
    pairs = [("mpe_maddpg_bf16.cu", h) for h in BF16_WIDE] + [("mpe_maddpg.cu", h) for h in WIDE]
    built = _build.build([(s, h) for s, h in pairs if h in _build.HIDDEN_WIDTHS[s]])
    for h in BF16_WIDE:
        row = result[f"hidden_{h}"] = {}
        for name in BF16_MADDPG_NAMES.get(h, ("simple_spread",)):
            a, ow, k, params, targets, rows = maddpg_case(name, h)
            cell = row[name] = {}
            kinds = (("K9-bf16", torch.bfloat16),) + ((("K9", torch.float32),) if h in WIDE else ())
            for label, cd in kinds:
                try:
                    k9 = MaddpgUpdateLauncher(a, ow, k, 5, h, MADDPG["batch"], "cuda",
                                              gamma=0.95, ent_coef=0.01, compute_dtype=cd)
                except NotImplementedError as e:
                    cell[label] = {"refused": str(e)}
                    continue
                weights = k9.layout.pack(params, targets).cuda()
                grads = torch.empty(k9.layout.off_ta, device="cuda")
                metrics = torch.empty(3, device="cuda")

                def call(k9=k9, weights=weights, grads=grads, metrics=metrics):
                    k9.launch(weights, rows, grads, metrics)

                call()
                cell[label] = {"sha256": sha256s((grads, metrics, k9.act2)),
                               "ms": median_ms(call), "loop_ms": loop_ms(call),
                               **call_device_ms(call)}
            torch.cuda.empty_cache()
        if h in WIDE and ("mpe_maddpg_bf16.cu", h) in built:
            row["registers_spill_bytes"] = registers(
                {"mpe_maddpg_bf16.cu": built["mpe_maddpg_bf16.cu", h]}, "mpe_maddpg_bf16.cu",
                "MaddpgBf16Dims")


TRAJ_AB = dict(n_steps=64, horizon=32, block_envs=1024, t_chunk=8)
TRAJ_AB_SHAPES = tuple((name, 4096) for name in SCENARIOS) + tuple(
    (name, 65_536) for name in ("simple_spread", "simple_reference", "simple_world_comm"))
TRAJ_CALLS = 5


def kernel_device_ms(fn, kernel: str) -> float | None:
    """The median device time of ``kernel``'s launches over TRAJ_CALLS calls
    of ``fn`` under torch.profiler, after one call; None without device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAJ_CALLS):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time if hasattr(e, "device_time") else e.cuda_time for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    us = [x for x in us if x > 0]
    return statistics.median(us) / 1e3 if us else None


def time_trajectory(result: dict, logs: dict) -> None:
    import time

    import torch

    from mpe_tpu_torch.ops import fused_trajectory as ft
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    grouped = hasattr(ft, "traj_group")
    for name, n in TRAJ_AB_SHAPES:
        run = ft.fused_trajectory(name, n, **TRAJ_AB)
        out = run(1)
        torch.cuda.synchronize()
        event_ms, wall_ms = [], []
        for _ in range(TRAJ_CALLS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run(1)
            end.record()
            end.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(start.elapsed_time(end))
        row = {"call_event_ms": statistics.median(event_ms),
               "call_wall_ms": statistics.median(wall_ms),
               "device_ms": kernel_device_ms(lambda: run(1), "trajectory_kernel"),
               "sha256": sha256s(out)}
        if grouped:
            kscn = kernel_scenario(name)
            row["group"] = ft.traj_group(kscn, n)
            for g in ft.GROUPS:
                call = (lambda g=g: ft.trajectory_cuda(
                    kscn, n, TRAJ_AB["n_steps"], TRAJ_AB["horizon"], TRAJ_AB["block_envs"],
                    TRAJ_AB["t_chunk"], 1, 0, "cuda", group=g))
                row[f"device_ms_group_{g}"] = kernel_device_ms(call, "trajectory_kernel")
                row[f"same_bits_group_{g}"] = sha256s(call()) == row["sha256"]
        result[f"{name}@{n}"] = row
        del out
        torch.cuda.empty_cache()
    result["registers_spill_bytes"] = registers(logs, "mpe_trajectory.cu", "trajectory_kernel")


# ---- where the bf16 kernels' time goes (--bf16-stages, --maddpg-bf16-phases) ---

STAGE_CUTS = {
    "tanh": [("tanhf(", "(")],
    "head": [("head<D>(st, zt + lane * ZLD, s0 + lane, m < n_samples, m / N, k, ms, ab3);", "")],
    "weight_gradients": [
        ("outer_row<2, false>(G3s, D::L3, 0, H2s, D::LH, 16 * warp, lane, a3);", ""),
        ("outer_row<H / 8, false>(GH2s, D::LH, 16 * warp, H1s, D::LH, 0, lane, a2);", ""),
        ("outer_row<D::NC1, true>(GH1s, D::LH, 16 * warp, Xf, D::LX, 0, lane, a1);", "")],
    "backward": [("warp_dense<NBH, 1, true>(a3g, W3, D::LH, lane, gh);", "zero(gh);"),
                 ("warp_dense<NBH, KTH, true>(ah, W2, D::LH, lane, gh);", "zero(gh);")],
}


def variant_libs(source: str, texts: dict, hidden: int = 64) -> dict:
    """{name: ctypes library} of each source text of ``texts``, built beside
    the checkout's headers with the library's flags at ``hidden``."""
    import ctypes
    from pathlib import Path

    from mpe_tpu_torch.ops import _build

    out = Path(_build.BUILD_DIR).parent / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.HEADERS:
        (out / h).write_text((_build.CSRC / h).read_text())
    procs = {}
    for name, text in texts.items():
        stem = f"{name}_h{hidden}"          # a path a width: dlopen keeps a loaded path's library
        (out / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build._flags(source, hidden), "-o", str(out / f"{stem}.so"),
             str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the {name} copy of {source} did not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}_h{hidden}.so"))
        for fn, argtypes in _build.SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def cut(text: str, subs) -> str:
    """``text`` with every occurrence of each ``old`` of ``subs`` replaced;
    raises where one is missing."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"the checkout's source has no {old!r} to cut")
        text = text.replace(old, new)
    return text


def time_bf16_stages(result: dict) -> None:
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build
    import torch

    src = (_build.CSRC / "mpe_update_bf16.cu").read_text()
    texts = {"whole": src}
    texts.update({f"no_{k}": cut(src, subs) for k, subs in STAGE_CUTS.items()})
    libs = variant_libs("mpe_update_bf16.cu", texts)
    library = _build.library
    try:
        for path, build in (("b", build_fused_ppo_step), ("b2", build_fused_mappo_step)):
            step = build("simple_spread", compute_dtype=torch.bfloat16, **TRAIN)
            params = step.init_params(torch.Generator().manual_seed(0))
            obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
            args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
            row = {}
            for name, lib in libs.items():
                _build.library = (lambda source, hidden=64, lib=lib: lib
                                  if source == "mpe_update_bf16.cu" else library(source, hidden))
                step.update(*args)
                prof = call_device_ms(lambda: step.update(*args))
                row[name] = prof.get("device_ms_by_kernel", {}).get(
                    "ppo_update_bf16_kernel", ["not measured"])[0]
            _build.library = library
            result[path] = row
            del step, args
            torch.cuda.empty_cache()
    finally:
        _build.library = library


# cuts of the wide kernel (hidden 128, 256): (file, old, new); the header's
# cuts apply to the copy inlined into each variant
WIDE_STAGE_CUTS = {
    "weight_stream": [("bf16_wide.cuh", "copy16_async(ring + (",
                       "if (src == nullptr) copy16_async(ring + (")],
    "partial_rmw": [
        ("bf16_wide.cuh", "old[mt][nb][i] = n < n_cols ? part[m * ldp + n] : 0.0f;",
         "old[mt][nb][i] = 0.0f;"),
        ("bf16_wide.cuh", "if (n < n_cols) part[m * ldp + n] = old[mt][nb][i] + acc[mt][nb][i];",
         "if (part == nullptr) part[m * ldp + n] = old[mt][nb][i] + acc[mt][nb][i];")],
    "weight_gradients": [("mpe_update_bf16.cu", "add_outer<MTW, MTS, H / 8, NGW>(",
                          "if (part == nullptr) add_outer<MTW, MTS, H / 8, NGW>("),
                         ("mpe_update_bf16.cu", "add_outer<MTW, MTS, D::NC1, NGW>(",
                          "if (part == nullptr) add_outer<MTW, MTS, D::NC1, NGW>(")],
    "head": [("mpe_update_bf16.cu", "head<D>(st, zr, tid, m < n_samples, m / N, k, ms, ab3);", "")],
    "tanh": [("mpe_update_bf16.cu", "tanhf(", "(")],
}
WIDE_STAGE_WIDTHS = (128, 256)


def time_bf16_wide_stages(result: dict) -> None:
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build
    import torch

    src = (_build.CSRC / "mpe_update_bf16.cu").read_text()
    header = (_build.CSRC / "bf16_wide.cuh").read_text()
    include = '#include "bf16_wide.cuh"'

    def variant(subs) -> str:
        text, head = src, header
        for where, old, new in subs:
            text, head = (text, cut(head, [(old, new)])) if where == "bf16_wide.cuh" else (
                cut(text, [(old, new)]), head)
        return cut(text, [(include, head)])

    texts = {"whole": variant([])}
    texts.update({f"no_{k}": variant(subs) for k, subs in WIDE_STAGE_CUTS.items()})
    library = _build.library
    try:
        for h in WIDE_STAGE_WIDTHS:
            libs = variant_libs("mpe_update_bf16.cu", texts, h)
            for path, build in (("b", build_fused_ppo_step), ("b2", build_fused_mappo_step)):
                step = build("simple_spread", compute_dtype=torch.bfloat16,
                             **dict(TRAIN, hidden=h))
                params = step.init_params(torch.Generator().manual_seed(0))
                obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = step.collect(params, 3)
                args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
                row = {}
                for name, lib in libs.items():
                    _build.library = (lambda source, hidden=64, lib=lib: lib if source ==
                                      "mpe_update_bf16.cu" else library(source, hidden))
                    step.update(*args)
                    split = call_device_ms(lambda: step.update(*args)).get("device_ms_by_kernel")
                    row[name] = (sum(split.get(k, [0.0])[0] for k in (
                        "update_round_bf16_kernel", "ppo_update_bf16_wide_kernel"))
                        if split else "not measured")
                _build.library = library
                result[f"{path} at hidden {h}"] = row
                del step, args
                torch.cuda.empty_cache()
    finally:
        _build.library = library


PHASE_STAMPS = r"""
__device__ unsigned long long mpe_stamps[16384];
__device__ __forceinline__ unsigned long long stamp_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned long long stamp_time() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_CTA (blockIdx.y * gridDim.x + blockIdx.x)
#define STAMP(k) \
  if (threadIdx.x == 0) mpe_stamps[STAMP_CTA * 8 + (k)] = stamp_clock();
#define STAMP_TD(k) \
  if (threadIdx.x == 0) mpe_stamps[8192 + STAMP_CTA * 4 + (k)] = stamp_clock();
#define STAMP_WARP() \
  if ((threadIdx.x & 31) == 0) \
    mpe_stamps[4096 + STAMP_CTA * 8 + (threadIdx.x >> 5)] = stamp_clock();
"""
TD_CRITIC = "  if (warp == 0) {                                  // agent i's target critic"
Y_STORE = ("          y[(size_t)i * batch + b] = r + gamma * (z[0][2 * half] + bc[FB3]);\n"
           "        }\n      }\n    }\n  }\n")
PHASE_SUBS = [
    ('#include "bf16_mma.cuh"\n', '#include "bf16_mma.cuh"\n' + PHASE_STAMPS),
    ("  const float* cw = weights + D::OFF_C + i * D::NCP;\n",
     "  const float* cw = weights + D::OFF_C + i * D::NCP;\n"
     "  if (threadIdx.x == 0) mpe_stamps[STAMP_CTA * 8 + 7] = stamp_time();\n  STAMP(0)\n"),
    ("  copy_wait();\n  __syncthreads();\n\n  // ---- phase 1",
     "  copy_wait();\n  __syncthreads();\n  STAMP(1)\n\n  // ---- phase 1"),
    ("  __syncthreads();\n\n  // ---- phase 2",
     "  __syncthreads();\n  STAMP(2)\n\n  // ---- phase 2"),
    ("  __syncthreads();\n\n  // ---- phase 3",
     "  STAMP_WARP()\n  __syncthreads();\n  STAMP(3)\n\n  // ---- phase 3"),
    ("  __syncthreads();\n\n  // ---- phase 4",
     "  __syncthreads();\n  STAMP(4)\n\n  // ---- phase 4"),
    ("    part[D::G_MS + tid] = total;\n  }\n}\n",
     "    part[D::G_MS + tid] = total;\n  }\n  STAMP(5)\n"
     "  if (threadIdx.x == 0) mpe_stamps[STAMP_CTA * 8 + 6] = stamp_time();\n}\n"),
    ("  const int i = blockIdx.y, b0 = blockIdx.x * TS;\n  copy_async(w16 + L::S_TA",
     "  const int i = blockIdx.y, b0 = blockIdx.x * TS;\n  STAMP_TD(0)\n"
     "  copy_async(w16 + L::S_TA"),
    ("  copy_wait();\n  __syncthreads();\n\n  float* zt = smem + L::F_Z + warp * TS * ZLD;",
     "  copy_wait();\n  __syncthreads();\n  STAMP_TD(1)\n\n"
     "  float* zt = smem + L::F_Z + warp * TS * ZLD;"),
    ("  __syncthreads();\n" + TD_CRITIC, "  __syncthreads();\n  STAMP_TD(2)\n" + TD_CRITIC),
    (Y_STORE + "}\n", Y_STORE + "  STAMP_TD(3)\n}\n"),
]


def time_maddpg_bf16_phases(result: dict) -> None:
    import ctypes

    import numpy as np
    import torch

    from mpe_tpu_torch.learner.maddpg import init_maddpg
    from mpe_tpu_torch.ops import _build
    from mpe_tpu_torch.ops import fused_maddpg_update as fmu
    from mpe_tpu_torch.ops.kernel_scenarios import kernel_scenario

    text = cut((_build.CSRC / "mpe_maddpg_bf16.cu").read_text(), PHASE_SUBS)
    text += ('\nextern "C" int mpe_read_stamps(unsigned long long* out) {\n  return (int)cudaMemcpy'
             'FromSymbol(out, mpe_stamps, sizeof(unsigned long long) * 16384);\n}\n')
    lib = variant_libs("mpe_maddpg_bf16.cu", {"k9_bf16_stamped": text})["k9_bf16_stamped"]
    lib.mpe_read_stamps.argtypes = [ctypes.c_void_p]
    result["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    library = _build.library
    _build.library = (lambda source, hidden=64:
                      lib if source == "mpe_maddpg_bf16.cu" else library(source, hidden))
    try:
        for path, (name, _) in zip(("d", "d2", "d3"), MADDPG_PATHS):
            kscn = kernel_scenario(name)
            a, ow, k = kscn.spec.n_agents, kscn.obs_w, kscn.n_logits
            b = MADDPG["batch"]
            params = init_maddpg(torch.Generator().manual_seed(1), ow, k, a)
            gen = torch.Generator().manual_seed(2)
            targets = {n: {q: {w: x + 0.1 * torch.randn(x.shape, generator=gen)
                               for w, x in layer.items()} for q, layer in net.items()}
                       for n, net in params.items()}
            rows = torch.randn((b, a * (2 * ow + k + 1)), generator=gen).cuda()
            lay = fmu.PackedLayout(a, ow, k, 64)
            launcher = fmu.MaddpgUpdateLauncher(a, ow, k, 5, 64, b, "cuda",
                                                compute_dtype=torch.bfloat16, gamma=0.95,
                                                ent_coef=0.01)
            weights = lay.pack(params, targets).cuda()
            grads = torch.empty(lay.off_ta, device="cuda")
            metrics = torch.empty(3, device="cuda")
            for _ in range(WARM_UP + 1):
                launcher.launch(weights, rows, grads, metrics)
            torch.cuda.synchronize()
            st = np.zeros(16384, dtype=np.uint64)
            if lib.mpe_read_stamps(st.ctypes.data) != 0:
                raise RuntimeError("reading the stamps failed")
            n = a * (-(-b // 16))
            grad = st[:n * 8].reshape(n, 8).astype(np.int64)
            phases = np.diff(grad[:, :6], axis=1)
            start, end = grad[:, 7], grad[:, 6]
            warps = st[4096:4096 + n * 8].reshape(n, 8).astype(np.int64) - grad[:, 2:3]
            td = np.diff(st[8192:8192 + n * 4].reshape(n, 4).astype(np.int64), axis=1)
            result[path] = {
                "scenario": name, "grad_ctas": n,
                "grad_phase_cycles_median": dict(zip(
                    ("staging", "phase1", "phase2", "phase3", "phase4"),
                    np.median(phases, axis=0).tolist())),
                "grad_phase_cycles_max": np.max(phases, axis=0).tolist(),
                "grad_phase2_cycles_by_warp": np.median(warps, axis=0).tolist(),
                "grad_cta_start_spread_ns": int(start.max() - start.min()),
                "grad_cta_span_median_ns": int(np.median(end - start)),
                "grad_kernel_span_ns": int(end.max() - start.min()),
                "td_phase_cycles_median": dict(zip(("staging", "actors", "critic"),
                                                   np.median(td, axis=0).tolist()))}
    finally:
        _build.library = library


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
    elif mode == "policy":
        time_policy(result, logs)
    elif mode == "trajectory":
        time_trajectory(result, logs)
    elif mode == "bf16":
        time_bf16(result, logs)
    elif mode == "maddpg-bf16":
        time_maddpg_bf16(result, logs)
    elif mode == "bf16-stages":
        time_bf16_stages(result)
    elif mode == "maddpg-bf16-phases":
        time_maddpg_bf16_phases(result)
    elif mode == "wide":
        time_wide(result)
    elif mode == "bf16-wide":
        time_bf16_wide(result, logs)
    elif mode == "bf16-wide-stages":
        time_bf16_wide_stages(result)
    elif mode == "maddpg-bf16-wide":
        time_maddpg_bf16_wide(result, logs)
    else:
        time_ppo(result, logs)
    print(json.dumps(result), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--child":
        child(args[1], args[2])
        return 0
    mode = {"--maddpg": "maddpg", "--maddpg-bf16": "maddpg-bf16", "--rollout": "rollout",
            "--det": "det", "--policy": "policy", "--trajectory": "trajectory",
            "--bf16": "bf16", "--bf16-stages": "bf16-stages",
            "--maddpg-bf16-phases": "maddpg-bf16-phases", "--wide": "wide",
            "--bf16-wide": "bf16-wide", "--bf16-wide-stages": "bf16-wide-stages",
            "--maddpg-bf16-wide": "maddpg-bf16-wide"}.get(
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

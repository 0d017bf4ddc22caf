#!/usr/bin/env python3
"""Time the port's update kernels of one or more checkouts on one NVIDIA
card, one checkout after another.

    python3 tools/torch_update_ab.py [--maddpg] ROOT [ROOT ...]

Each ROOT is a checkout holding ``mpe_tpu_torch/``. Each runs in a process
of its own, which imports that checkout's package and builds its kernels,
in the order given: pass ``parent change change parent`` to compare two
versions on one card within one call. Each process prints one JSON line:
the root, the card's name and power limit as ``nvidia-smi`` gives them, and
the times below.

Without ``--maddpg`` (K6, K7): the simple_spread PPO and MAPPO trainers at
tools/train_bench.py's learner batch (4096 envs x 64 steps, horizon 32,
hidden 64) collect one batch from a seeded init, and ``step.update`` (one
epoch's gradient: K6, or K7's actor and critic passes) is timed by CUDA
events, the median of 20 calls after 3 warm-ups; beside both medians in ms,
the registers and spill bytes of each ``ppo_update_kernel`` instantiation
from the compiler's ``-Xptxas -v`` report (empty where the kernels were
already built).

With ``--maddpg`` (K8, K9): ``build_fused_maddpg_runner("simple_spread",
n_envs=1024, horizon=25, batch=1024)`` (tools/train_bench.py's fused_maddpg
row) runs 40 chunks with actor_start 250, each chunk timed by CUDA events
and split into collect and update; then ``grads_fn.from_rows`` (K9) is
timed on 1024 rows of the final ring, the median of 20 calls after 3
warm-ups. It prints transitions/s over chunks 1 to 39, the mean collect
and update ms per chunk, their medians, and K9's median ms.
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


def registers(logs: dict) -> dict:
    """{mangled ppo_update_kernel name: [registers, spill store bytes]}."""
    out, current = {}, None
    for line in logs.get("mpe_update.cu", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if "ppo_update_kernel" in m.group(1) else None
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


def time_ppo(result: dict, logs: dict) -> None:
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    import torch

    for key, build in (("ppo_ms", build_fused_ppo_step), ("mappo_ms", build_fused_mappo_step)):
        step = build("simple_spread", **TRAIN)
        params = step.init_params(torch.Generator().manual_seed(0))
        batch = step.collect(params, 3)
        if len(batch) == 6:         # a checkout from before the comm factor: no cm_oh
            batch = batch[:2] + (None,) + batch[2:]
        obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = batch
        args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        result[key] = median_ms(lambda: step.update(*args))
    result["registers_spill_bytes"] = registers(logs)


def time_maddpg(result: dict) -> None:
    import torch

    from mpe_tpu_torch.learner import build_fused_maddpg_runner

    run = build_fused_maddpg_runner("simple_spread", **MADDPG)
    events = []
    params, info = run(CHUNKS * MADDPG["horizon"], seed=0, actor_start=ACTOR_START,
                       events=events)
    torch.cuda.synchronize()
    chunks = [(events[2 * c][1].elapsed_time(events[2 * c + 1][1]),
               events[2 * c + 1][1].elapsed_time(events[2 * c + 2][1])) for c in range(CHUNKS)]
    steady = chunks[1:]                  # chunk 0 sets up the update's first allocations
    buf = info["buffer"]
    gen = torch.Generator("cuda").manual_seed(5)
    rows = buf.data[torch.randint(0, buf.size, (MADDPG["batch"],), generator=gen,
                                  device="cuda")].contiguous()
    grads_fn = run.update_chunk.grads_fn
    result.update(
        transitions_per_s=run.transitions_per_chunk * len(steady)
        / (sum(a + b for a, b in steady) * 1e-3),
        collect_ms=sum(a for a, _ in steady) / len(steady),
        update_ms=sum(b for _, b in steady) / len(steady),
        collect_median_ms=statistics.median(a for a, _ in steady),
        update_median_ms=statistics.median(b for _, b in steady),
        k9_ms=median_ms(lambda: grads_fn.from_rows(params, info["targets"], rows)))


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
    else:
        time_ppo(result, logs)
    print(json.dumps(result), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--child":
        child(args[1], args[2])
        return 0
    mode = "maddpg" if args[:1] == ["--maddpg"] else "ppo"
    roots = args[1:] if mode == "maddpg" else args
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

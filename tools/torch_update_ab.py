#!/usr/bin/env python3
"""Time the port's PPO and MAPPO update kernels (K6, K7) of one or more
checkouts on one NVIDIA card, one checkout after another.

    python3 tools/torch_update_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``mpe_tpu_torch/``. Each runs in a process
of its own, which imports that checkout's package and builds its kernels,
in the order given: pass ``parent change change parent`` to compare two
versions on one card within one call. A process builds the simple_spread
PPO and MAPPO trainers at tools/train_bench.py's learner batch (4096 envs x
64 steps, horizon 32, hidden 64), collects one batch from a seeded init and
times ``step.update`` (one epoch's gradient: K6, or K7's actor and critic
passes) by CUDA events, the median of 20 calls after 3 warm-ups. It prints
one JSON line per ROOT: the root, the card's name and power limit as
``nvidia-smi`` gives them, both medians in ms, and the registers and spill
bytes of each ``ppo_update_kernel`` instantiation from the compiler's
``-Xptxas -v`` report (empty where the kernels were already built).
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

TRAIN = dict(n_envs=4096, n_steps=64, horizon=32, hidden=64, block_envs=1024, t_chunk=8)
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


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import mpe_tpu_torch
    from mpe_tpu_torch.learner import build_fused_mappo_step, build_fused_ppo_step
    from mpe_tpu_torch.ops import _build

    assert mpe_tpu_torch.__file__.startswith(root), mpe_tpu_torch.__file__
    logs = _build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"root": root, "card": smi.splitlines()[0]}
    for key, build in (("ppo_ms", build_fused_ppo_step), ("mappo_ms", build_fused_mappo_step)):
        step = build("simple_spread", **TRAIN)
        params = step.init_params(torch.Generator().manual_seed(0))
        batch = step.collect(params, 3)
        if len(batch) == 6:         # a checkout from before the comm factor: no cm_oh
            batch = batch[:2] + (None,) + batch[2:]
        obs, mv_oh, cm_oh, logp_old, value, adv_n, ret = batch
        args = (params, obs, mv_oh, cm_oh, logp_old, adv_n, ret, value)
        for _ in range(WARM_UP):
            step.update(*args)
        times = []
        for _ in range(CALLS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step.update(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        result[key] = statistics.median(times)
    result["registers_spill_bytes"] = registers(logs)
    print(json.dumps(result), flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import os

    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--child", os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

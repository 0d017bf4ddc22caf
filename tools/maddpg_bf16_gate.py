#!/usr/bin/env python3
"""K9-bf16's gates of chip_smoke.py's phase 3d on their own, on one NVIDIA card.

    python3 tools/maddpg_bf16_gate.py [--hidden 128 256] [--names simple_spread simple_world_comm]
        [--draws 8]

For each width and scenario asked, in phase 3d's order and with its seeds:
K8's rows (the actor of ``init_maddpg`` seeded 110 + width + the scenario's
index in WIDE_MADDPG_NAMES, its head scaled by 100), the float32 MADDPG
runner (seed 0, WIDE_MADDPG_CHUNKS chunks, actor_start 0: K8 and K9), then
``check_maddpg_bf16`` on those rows with fresh and with the runner's trained
params, which prints K9-bf16's leaf errors against the plain bf16 version
beside the plain bf16 version's own distance with its sums reversed and, on
the trained batch, in ``--draws`` random orders (the largest and the median)
and asserts the gates. Prints the card's name and power limit first and one JSON
line last: {"ok", "failed", "rows": {"<scenario>, hidden <h>": gate row}}.
Exits 1 if a gate failed (every case still runs), 2 without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--names", nargs="+", default=None)
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("maddpg_bf16_gate: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mpe_tpu_torch.learner.maddpg import collect_t_chunk, init_maddpg
    from mpe_tpu_torch.ops import _build, fused_maddpg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _build.build([(s, h) for h in args.hidden for s in _build.HIDDEN_SOURCES
                  if h in _build.HIDDEN_WIDTHS[s]])         # all at once, as library() would
    cs.add_policy_ops()                                       # the bounds' operation counts
    wrappers = cs.kernel_wrappers()
    names = args.names or list(cs.WIDE_MADDPG_NAMES)
    mn, mh = cs.MADDPG["n_envs"], cs.MADDPG["horizon"]
    rows, failed = {}, []
    for h in args.hidden:
        for name in names:
            i = cs.WIDE_MADDPG_NAMES.index(name)
            a, ow, k, width, _, _ = cs.maddpg_widths(name, h)
            mp = {n: {q: {w: x.cuda() for w, x in layer.items()} for q, layer in net.items()}
                  for n, net in init_maddpg(torch.Generator().manual_seed(110 + h + i), ow, k,
                                            a, hidden=h).items()}
            mp["actor"]["out"]["w"] = mp["actor"]["out"]["w"] * 100.0
            emit = fused_maddpg.fused_maddpg_trajectory(
                name, mp["actor"], mn, mh, horizon=mh, eps_greedy=0.1,
                block_envs=cs.BLOCK_ENVS, t_chunk=collect_t_chunk(mh), emit_rows=True)
            flat = emit(3, mp["actor"]).reshape(mn * mh, width)
            params = cs.maddpg_path(wrappers, name, cs.WIDE_MADDPG_CHUNKS, hidden=h,
                                    actor_start=0)[3]
            key = f"{name}, hidden {h}"
            try:
                rows[key] = cs.check_maddpg_bf16(name, params, flat, h, args.draws)["gates"]
            except AssertionError as e:
                print(f"FAILED: {e}", flush=True)
                failed.append(f"{key}: {e}")
            del emit, flat, params
            torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"ok": not failed, "failed": failed, "rows": rows}, default=float))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

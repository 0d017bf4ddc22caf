"""Run one function on N ranks, one interpreter per rank.

    launch("tests/_torch_dist_worker.py:run_all", 2, in_path, out_dir, device="cpu")

Each rank is a fresh ``python`` process (never a fork: CUDA cannot be
forked, and a caller may have JAX or threads loaded) that joins the others
on a ``FileStore`` in a temporary directory (no port to race for), starts
its rank with ``init_multihost`` and calls ``function(mesh, *args)``. Ranks
load the kernels from ``build/kernels/`` by hash, so build them before a
launch on the card (``ops._build.build_all``) or each rank builds its own.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_GRACE_S = 2.0        # how long the other ranks get to report after one fails


def _stderr_tail(path: Path, n: int = 4000) -> str:
    text = path.read_text(errors="replace")
    return text if len(text) <= n else "..." + text[-n:]


def launch(target: str, n_ranks: int, *args: str, device=None,
           timeout: float = 600.0) -> list[str]:
    """Run ``target`` (``"path/file.py:function"`` or ``"package.module:
    function"``) on ``n_ranks`` ranks with string ``args``; ``device`` is each
    rank's (``None``: the card). Returns the ranks' standard outputs.

    A rank that exits non-zero, or runs past ``timeout`` seconds, fails the
    launch: the ranks still running are killed and ``RuntimeError`` names
    each failed rank with the end of its standard error."""
    with tempfile.TemporaryDirectory(prefix="mpe_ranks_") as tmp:
        tmp = Path(tmp)
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        child_env["LOCAL_WORLD_SIZE"] = str(n_ranks)
        procs, outs, errs = [], [], []
        for rank in range(n_ranks):
            outs.append(tmp / f"rank{rank}.out")
            errs.append(tmp / f"rank{rank}.err")
            argv = [sys.executable, "-c",
                    "from mpe_tpu_torch.parallel.launch import _rank_main; _rank_main()",
                    target, str(rank), str(n_ranks), str(tmp / "store"),
                    "none" if device is None else str(device), *map(str, args)]
            with open(outs[-1], "w") as out, open(errs[-1], "w") as err:
                procs.append(subprocess.Popen(argv, stdout=out, stderr=err,
                                              env=dict(child_env, LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + timeout
        killed, order = set(), []         # order: the failed ranks as they were seen to fail
        try:
            while True:
                codes = [p.poll() for p in procs]
                for rank, c in enumerate(codes):
                    if c not in (None, 0) and rank not in order:
                        order.append(rank)
                        deadline = min(deadline, time.monotonic() + _GRACE_S)
                if None not in codes or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for rank, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.add(rank)
                p.wait()
        failed = [f"rank {r} of {n_ranks} failed ("
                  + ("killed while still running" if r in killed
                     else f"exit code {procs[r].returncode}")
                  + f"); its stderr:\n{_stderr_tail(errs[r])}" for r in order + sorted(killed)]
        if failed:
            raise RuntimeError(f"launch of {target} failed:\n" + "\n".join(failed))
        return [o.read_text() for o in outs]


def _load(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main() -> None:
    """A rank's process: ``target rank n_ranks store device *args``."""
    target, rank, n_ranks, store, device, *args = sys.argv[1:]
    import torch.distributed as dist

    from mpe_tpu_torch.parallel.mesh import init_multihost

    fn = _load(target)
    mesh = init_multihost(init_method=f"file://{store}", world_size=int(n_ranks),
                          rank=int(rank), device=None if device == "none" else device)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()

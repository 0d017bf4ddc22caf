"""Tracing and profiling hooks (counterpart of ``mpe_tpu/utils/profiling.py``).

  - ``step_phase(name)``: a range named ``mpe/<name>`` that
    ``torch.profiler`` records (``record_function``), and an NVTX range too
    where a card is visible, so traces show the phases by name;
  - ``trace(log_dir)``: ``torch.profiler.profile`` over the CPU, and the
    card where there is one, writing a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def step_phase(name: str):
    """``with step_phase("collect"): ...``: a named range in profiles."""
    label = f"mpe/{name}"
    with torch.profiler.record_function(label):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/mpe-trace') as prof: run()``.
    Yields the profiler (``prof.key_averages()``); on exit the trace is
    written to ``log_dir/trace.<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{os.getpid()}.json"))

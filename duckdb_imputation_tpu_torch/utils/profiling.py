"""Phase timing: per-phase wall-clock totals for the MICE drivers.

Counterpart of `duckdb_imputation_tpu.utils.profiling`, the structured
replacement for the reference's cout/clog chrono pairs around every MICE
phase (imputation_base.cpp:8-12, 32-38, 102-118, 136-142). `device_trace`
wraps `torch.profiler` and writes a Chrome trace.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time


class PhaseTimer:
    """Accumulates the wall-clock seconds and the call count of each named
    phase. A phase's time is the host clock around its body. `sync` (e.g.
    `torch.cuda.synchronize`) is called before each clock read, so that a
    phase's time holds the device work it queued; without it, work a body
    queued and did not wait for counts in a later phase."""

    def __init__(self, verbose: bool = False, sync=None):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.verbose = verbose
        self.sync = sync or (lambda: None)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if self.verbose:
                print(f"[{name}] {dt * 1e3:.1f} ms")

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        lines = [f"{k}: {v * 1e3:.1f} ms ({self.counts[k]}x)"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({k: {"total_s": v, "count": self.counts[k]}
                           for k, v in self.totals.items()})


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile everything inside the context with `torch.profiler` (CPU,
    and CUDA where a card is present) and write a Chrome trace,
    `trace.json`, into `log_dir`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Tracing and profiling hooks (torch port of
`lseg_tpu/utils/profiling.py`): a `torch.profiler` trace of any code
region written as a Chrome trace (Perfetto, chrome://tracing), a step
timer that synchronises the card before it reads the clock, and the
device memory statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (the host, and the card where there is
    one) and write `<logdir>/trace_<pid>_<ns>.json`:

        with profiling.trace("/tmp/trace"):
            train_step(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _cuda_devices(outputs, found):
    if torch.is_tensor(outputs):
        if outputs.is_cuda:
            found.add(outputs.device)
    elif isinstance(outputs, dict):
        for v in outputs.values():
            _cuda_devices(v, found)
    elif isinstance(outputs, (list, tuple)):
        for v in outputs:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock per-step timing that waits for the step's outputs first
    (the clock around an asynchronous launch reads only the enqueue)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._n = 0

    def step(self, outputs) -> Optional[float]:
        for dev in _cuda_devices(outputs, set()):
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self._n += 1
        if self._n <= self.warmup:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def throughput(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self._times else 0.0


def device_memory_stats() -> dict:
    """Per-card bytes in use and their peak, from
    `torch.cuda.memory_stats` (the caching allocator's counts); empty
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out

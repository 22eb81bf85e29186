"""Metrics and tracing (SURVEY.md §5.1/§5.5).

The port's counterpart of the JAX package's utils/metrics.py: wall-clock
phase timers and a process-wide registry, with torch_trace, a
torch.profiler trace written as a Chrome trace, in place of the
reference's jax.profiler hook.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class MetricsRegistry:
    timings_ms: dict[str, list[float]] = field(
        default_factory=lambda: defaultdict(list)
    )
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def record(self, name: str, ms: float):
        self.timings_ms[name].append(ms)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def summary(self) -> dict:
        return {
            "timings_ms": {
                k: {
                    "n": len(v),
                    "total": round(sum(v), 3),
                    "mean": round(sum(v) / len(v), 3),
                    "min": round(min(v), 3),
                }
                for k, v in self.timings_ms.items() if v
            },
            "counters": dict(self.counters),
        }

    def reset(self):
        self.timings_ms.clear()
        self.counters.clear()


metrics = MetricsRegistry()


class Timer(contextlib.AbstractContextManager):
    """with Timer("prove"): ... — records into the global registry."""

    def __init__(self, name: str, registry: MetricsRegistry | None = None):
        self.name = name
        self.registry = registry or metrics

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.record(self.name, (time.perf_counter() - self.t0) * 1e3)
        return False


@contextlib.contextmanager
def torch_trace(dirname: str):
    """torch.profiler over the block, host activity and, where a CUDA
    device is present, the card's; written to dirname/trace.json (Chrome
    trace format).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))

"""Tracing and step-timing hooks (counterpart of
``fira_tpu/utils/profiling.py``).

- ``trace(log_dir)``: context manager around ``torch.profiler.profile``
  that writes a Chrome/TensorBoard trace (``*.pt.trace.json``) of
  everything inside it under ``log_dir``: CPU and CUDA activities when
  the card is there, CPU alone on a CPU-only build;
- ``step_annotation(step)``: names each training step in the trace
  (``train_step#12``, a ``torch.profiler.record_function`` range), so the
  device timeline lines up with host steps, as JAX's
  ``StepTraceAnnotation("train_step", step_num=step)``;
- ``Meter``: windowed wall-clock meter for steady-state throughput
  (items/sec) and step latency percentiles, excluding warm-up steps.

Open a trace in ``chrome://tracing`` or Perfetto (ui.perfetto.dev), or
with TensorBoard's profiler plugin pointed at ``log_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional

STEP_ANNOTATION = "train_step"


def annotation_name(step: int) -> str:
    """The trace range name of training step ``step``."""
    return f"{STEP_ANNOTATION}#{step}"


def activities():
    """The profiler activities to record: CPU, and CUDA when a card is
    visible. A card whose CUDA activity the profiler build lacks is an
    error, never a CPU-only trace of a device run."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler has no CUDA activity on a "
                               "build with a visible card")
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile everything inside the block to ``log_dir`` (no-op, touching
    no profiler state, if None)."""
    if not log_dir:
        yield
        return
    prof = begin_trace(log_dir)
    try:
        yield
    finally:
        end_trace(prof)


def begin_trace(log_dir: str):
    """Start a ``torch.profiler.profile`` whose trace :func:`end_trace`
    writes under ``log_dir`` (the train loop's window spans loop
    iterations, so it is not a ``with`` block)."""
    from torch.profiler import profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities(),
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def end_trace(prof) -> None:
    """Wait for the card (the window's kernels end inside it), stop the
    profiler and write its trace."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


def step_annotation(step: int):
    """Label the current host step on the trace's timeline."""
    from torch.profiler import record_function

    return record_function(annotation_name(step))


@dataclasses.dataclass
class Meter:
    """Steady-state throughput/latency meter with feed-stall attribution.

    ``warmup`` leading intervals are discarded (they hold the kernels'
    build and first launch). Call ``tick(n_items, stall_s=...)`` once per
    completed step after syncing with the device — ``stall_s`` is how much
    of the interval the host spent blocked waiting on the input feed
    (data/feeder.py hands it per batch); read ``summary()`` at the end.
    ``feed_stall_frac`` is the share of steady-state wall clock that was
    feed, not device compute.
    """

    warmup: int = 1
    _intervals: List[float] = dataclasses.field(default_factory=list)
    _items: List[int] = dataclasses.field(default_factory=list)
    _stalls: List[float] = dataclasses.field(default_factory=list)
    _last: Optional[float] = None
    _seen: int = 0

    def start(self) -> None:
        self._last = time.perf_counter()

    def pause(self) -> None:
        """Exclude the time until the next start() (e.g. a dev-eval pass)."""
        self._last = None

    def tick(self, n_items: int = 1, stall_s: float = 0.0) -> bool:
        """Close the interval since the last tick or start; returns True
        when it was measured (past the warmup, not paused)."""
        now = time.perf_counter()
        measured = False
        if self._last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self._intervals.append(now - self._last)
                self._items.append(n_items)
                self._stalls.append(stall_s)
                measured = True
        self._last = now
        return measured

    @property
    def seconds(self) -> float:
        """Wall clock of the measured intervals."""
        return sum(self._intervals)

    def summary(self) -> Dict[str, float]:
        if not self._intervals:
            return {"steps": 0, "items_per_sec": 0.0,
                    "mean_step_ms": 0.0, "p50_step_ms": 0.0,
                    "p99_step_ms": 0.0, "feed_stall_frac": 0.0,
                    "feed_stall_ms_per_step": 0.0}
        total_t = sum(self._intervals)
        xs = sorted(self._intervals)

        def pct(p: float) -> float:
            return xs[min(len(xs) - 1, int(p * len(xs)))]

        total_stall = sum(self._stalls)
        return {
            "steps": float(len(xs)),
            "items_per_sec": sum(self._items) / total_t,
            "mean_step_ms": 1e3 * total_t / len(xs),
            "p50_step_ms": 1e3 * pct(0.50),
            "p99_step_ms": 1e3 * pct(0.99),
            # share of measured wall clock the host spent blocked on the
            # input feed (assembly + transfer not hidden behind compute)
            "feed_stall_frac": min(1.0, total_stall / total_t),
            "feed_stall_ms_per_step": 1e3 * total_stall / len(xs),
        }

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
  (items/sec) and step latency percentiles, excluding warm-up steps;
- ``span(name)`` / ``count(name, n)``: the program's own spans and
  counters, always on (``Recorder``): a count, total seconds and a bounded
  record of recent durations a span name, a total a counter name, read as
  snapshots by ``spans()`` / ``counters()``. ``capture()`` also keeps each
  span's interval while it is open, and inside a ``trace`` /
  ``begin_trace`` window each span is a ``record_function`` range too.

The spans (s) and counters (c) the port records, where, and what reads
each (the loop's line is ``train/loop.py``'s closing ``throughput:``):

- ``train.forward`` (s), train/step.py, each forward:
  ``fwd_issue_ms.train``, the loop's line;
- ``train.backward`` (s), each backward (and ``sync_grads`` under a
  mesh): ``bwd_issue_ms.train``, the loop's line;
- ``train.optimizer`` (s), Adam's step (and accum's gradient division):
  ``opt_issue_ms.train``, the loop's line;
- ``train.steps`` (c), an optimizer step on a CUDA device after another
  one there, and ``train.issue_bound`` (c), such a step whose previous
  step's work had all run on the card when the host began its issue:
  ``issue_bound_step_frac.train``;
- ``feeder.wait`` (s), data/feeder.py, the consumer's arrival until the
  in-order batch is in hand: the loop's line;
- ``feeder.put`` (s), the copies' enqueue: ``feed_put_ms.train``, the
  loop's line;
- ``feeder.assemble`` (s), the successful attempt's task, on the thread
  that ran it: the loop's line (pool use);
- ``feeder.not_ready`` (c), a batch not ready on the consumer's arrival:
  the loop's line.

Open a trace in ``chrome://tracing`` or Perfetto (ui.perfetto.dev), or
with TensorBoard's profiler plugin pointed at ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import statistics
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

STEP_ANNOTATION = "train_step"


def annotation_name(step: int) -> str:
    """The trace range name of training step ``step``."""
    return f"{STEP_ANNOTATION}#{step}"


RECENT = 2048            # durations a span name keeps for its median
CAPTURE_LIMIT = 65536    # intervals a capture keeps (the first ones)

Interval = Tuple[float, float, str, str]   # start, end, name, thread name


class Capture:
    """The intervals of the spans that ended while it was open, on
    ``time.perf_counter`` (the first ``limit``; later ones are counted in
    ``dropped``)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.intervals: List[Interval] = []
        self.dropped = 0


class Span:
    """One use of ``span(name)``: two clock reads, and the aggregate
    update on a normal exit (a block that raises is not recorded). Inside
    a trace window it is also a ``record_function`` range. ``start``,
    ``end`` and ``seconds`` stay readable after the block."""

    __slots__ = ("_rec", "name", "start", "end", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self._rec = rec
        self.name = name
        self._range = None

    def __enter__(self) -> "Span":
        if self._rec.windows:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self._rec.record(self.name, self.start, self.end)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """Span aggregates and counters, safe to record from any thread (one
    lock around each update). Memory is O(names): a span name keeps its
    count, its total seconds and its last ``RECENT`` durations."""

    def __init__(self, recent: int = RECENT):
        self._recent = recent
        self._lock = threading.Lock()
        self._spans: Dict[str, list] = {}     # name -> [count, total, deque]
        self._counters: Dict[str, int] = {}
        self._capture: Optional[Capture] = None
        self.windows = 0   # open trace windows (spans enter record_function)

    def span(self, name: str) -> Span:
        """``with rec.span(name):`` records the block's duration."""
        return Span(self, name)

    def record(self, name: str, start: float, end: float) -> None:
        """One occurrence of span ``name`` from ``start`` to ``end``."""
        cap = self._capture
        thread = threading.current_thread().name if cap is not None else ""
        seconds = end - start
        with self._lock:
            agg = self._spans.get(name)
            if agg is None:
                agg = self._spans[name] = [
                    0, 0.0, collections.deque(maxlen=self._recent)]
            agg[0] += 1
            agg[1] += seconds
            agg[2].append(seconds)
            cap = self._capture
            if cap is not None:
                if len(cap.intervals) < cap.limit:
                    cap.intervals.append((start, end, name, thread))
                else:
                    cap.dropped += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def mark(self) -> Dict[str, Dict[str, tuple]]:
        """Where every span and counter stands now, for ``since``."""
        with self._lock:
            return {"spans": {n: (a[0], a[1]) for n, a in self._spans.items()},
                    "counters": dict(self._counters)}

    def spans(self, since: Optional[Dict] = None
              ) -> Dict[str, Dict[str, float]]:
        """``{name: {"count", "total_s", "median_s"}}``; with ``since`` (a
        ``mark()``), over what was recorded after it, the median over the
        last ``RECENT`` of those durations."""
        base = since["spans"] if since else {}
        with self._lock:
            snap = {n: (a[0], a[1], list(a[2])) for n, a in self._spans.items()}
        out = {}
        for name, (n, total, recent) in snap.items():
            n0, t0 = base.get(name, (0, 0.0))
            if n > n0:
                recent = recent[-min(n - n0, len(recent)):]
                out[name] = {"count": n - n0, "total_s": total - t0,
                             "median_s": statistics.median(recent)}
        return out

    def counters(self, since: Optional[Dict] = None) -> Dict[str, int]:
        """``{name: total}``; with ``since``, the increase after it."""
        base = since["counters"] if since else {}
        with self._lock:
            snap = dict(self._counters)
        return {n: c - base.get(n, 0) for n, c in snap.items()
                if c > base.get(n, 0)}

    def open_windows(self, n: int) -> None:
        """A trace window opened (1) or closed (-1)."""
        with self._lock:
            self.windows += n

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()

    @contextlib.contextmanager
    def capture(self, limit: int = CAPTURE_LIMIT) -> Iterator[Capture]:
        """Keep the intervals of the spans that end inside the block (one
        capture at a time)."""
        cap = Capture(limit)
        with self._lock:
            if self._capture is not None:
                raise RuntimeError("a span capture is already open")
            self._capture = cap
        try:
            yield cap
        finally:
            with self._lock:
                self._capture = None


RECORDER = Recorder()   # the program's: every span and counter below


def span(name: str) -> Span:
    """``with span("train.forward"):`` records the block's duration in the
    program's recorder."""
    return RECORDER.span(name)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def mark() -> Dict[str, Dict[str, tuple]]:
    return RECORDER.mark()


def spans(since: Optional[Dict] = None) -> Dict[str, Dict[str, float]]:
    return RECORDER.spans(since)


def counters(since: Optional[Dict] = None) -> Dict[str, int]:
    return RECORDER.counters(since)


def reset() -> None:
    RECORDER.reset()


def capture(limit: int = CAPTURE_LIMIT):
    return RECORDER.capture(limit)


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
    RECORDER.open_windows(1)
    return prof


def end_trace(prof) -> None:
    """Wait for the card (the window's kernels end inside it), stop the
    profiler and write its trace."""
    import torch

    RECORDER.open_windows(-1)
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

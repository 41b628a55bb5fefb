"""A bounded ``torch.profiler`` window inside the measured one, and
what the per-layer readers take from it: device busy seconds (the union
of kernel, memcpy and memset intervals), the traced window's length,
device time and launches by kernel name, and the device's idle gaps
named by the benchmark span the host was in.

Only the device's activity is traced (CUPTI), so the host is not slowed
by per-operator records and the idle share is the untraced run's. The
host's spans come from the benchmark's own clock (``program.Spans``):
a marker kernel launched on an idle device right after a host timestamp
aligns the two clocks to within a launch's latency. The trace is read
after the window has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

# profiler activity types that are work on the device
DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


class Tracer:
    """``start()`` / ``stop()`` around a bounded part of the window (both
    synchronise the device); ``summary(spans)`` once the window is over."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = self.t_mark = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        mark = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        mark.add_(1.0)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Idempotent: only the first call ends the traced part."""
        if self.t1:
            return
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, spans: List[Tuple[float, float, str]]) -> Dict:
        """``spans``: (start, end, name) on the host's perf_counter."""
        torch = self.torch
        dev = []
        for e in self.prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", False):
                continue
            act = str(getattr(e, "activity_type", "") or "").lower()
            if act and not any(a in act for a in DEVICE_ACTIVITIES):
                continue
            dev.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        # the marker is the first device work after t_mark
        offset = dev[0][0] - 1e6 * self.t_mark if dev else 0.0
        lo, hi = 1e6 * self.t0 + offset, 1e6 * self.t1 + offset
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev[1:]
               if b > lo and a < hi]
        host = [(1e6 * a + offset, 1e6 * b + offset, n) for a, b, n in spans
                if a <= self.t1 and b >= self.t0]
        return summarize(dev, host, self.t1 - self.t0, lo, hi)


def summarize(dev, spans, window_s: float, lo: float, hi: float) -> Dict:
    """``dev``: (start_us, end_us, name) of device work inside [lo, hi];
    ``spans``: the host's spans on the same clock. Busy is the union of
    the device intervals; each idle gap is named by the innermost host
    span around its midpoint."""
    kernels: Dict[str, List[float]] = {}
    for a, b, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy, gaps, end = 0.0, [], lo
    for a, b, _n in dev:
        if a > end:
            gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    if hi > end:
        gaps.append((end, hi))
    by_span: Dict[str, float] = {}
    spans = sorted(spans, key=lambda s: s[1] - s[0])   # innermost first
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = next((n for s0, s1, n in spans if s0 <= mid <= s1), "other")
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-6
    top_ops = sorted(((n, v[0]) for n, v in kernels.items()),
                     key=lambda r: -r[1])[:10]
    top_gaps = sorted(by_span.items(), key=lambda r: -r[1])[:10]
    return dict(busy_s=busy * 1e-6, window_s=window_s, kernels=kernels,
                device_ops=[[n, s] for n, s in top_ops],
                idle_gaps=[[n, s] for n, s in top_gaps])


def kernel_time(trace: Optional[Dict], pattern: str
                ) -> Optional[Tuple[float, int]]:
    """(seconds, launches) summed over kernels whose name holds
    ``pattern``; None when the trace has none."""
    if not trace:
        return None
    hits = [v for n, v in trace["kernels"].items() if pattern in n]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)

"""Open-loop arrival schedules for the serving loop (counterpart of
``fira_tpu/serve/arrivals.py``; numpy only, so the same seed gives the
JAX package's times bit for bit).

An open-loop load generator decides every request's arrival time up
front, independent of how fast the server answers: a slow server does
not throttle its own offered load, it accumulates queue and the tail
latencies show it. Two sources:

- :func:`poisson_times`: Poisson arrivals at an offered rate (seeded
  i.i.d. exponential gaps);
- an arrival-trace file (:func:`write_trace` / :func:`read_trace`): one
  non-decreasing arrival time a line, line ``i`` belonging to split
  position ``i``. Traces make serving runs replayable.

Times are seconds on whatever clock the serving loop runs (wall, or
virtual for deterministic replay: serve/server.py).
"""

from __future__ import annotations

import numpy as np


def poisson_times(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """Arrival times (seconds, float64, non-decreasing, starting at the
    first gap) of ``n`` Poisson arrivals at ``rate`` requests/second:
    the cumulative sum of seeded i.i.d. Exp(rate) inter-arrival gaps."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if rate <= 0:
        raise ValueError(f"offered rate must be > 0 requests/s, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def write_trace(path: str, times: np.ndarray) -> str:
    """Write an arrival trace: one ``%.9f`` time per line, split order."""
    arr = np.asarray(times, dtype=np.float64)
    _validate(arr, where=path)
    with open(path, "w") as f:
        for t in arr:
            f.write(f"{t:.9f}\n")
    return path


def read_trace(path: str) -> np.ndarray:
    """Read an arrival trace written by :func:`write_trace` (or by hand:
    one float per line; blank lines and ``#`` comments skipped).
    Validates non-negative, non-decreasing times — a shuffled or
    negative trace is a malformed input, not a schedule — citing the
    REAL file line (comments and blanks do not shift the blame)."""
    times = []   # (file line, value) — errors cite the actual line
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            s = raw.strip()
            if not s or s.startswith("#"):
                continue
            try:
                t = float(s)
            except ValueError:
                raise ValueError(
                    f"{path}:{ln}: {s!r} is not a float arrival time")
            if t < 0:
                raise ValueError(
                    f"{path}:{ln}: arrival times must be >= 0, got {t}")
            if times and t < times[-1][1]:
                raise ValueError(
                    f"{path}: arrival times must be non-decreasing "
                    f"(line {ln} goes backwards)")
            times.append((ln, t))
    return np.asarray([t for _ln, t in times], dtype=np.float64)


def _validate(times: np.ndarray, *, where: str) -> None:
    if times.ndim != 1:
        raise ValueError(f"{where}: arrival times must be 1-D")
    if len(times) and float(times[0]) < 0:
        raise ValueError(f"{where}: arrival times must be >= 0")
    if len(times) > 1 and np.any(np.diff(times) < 0):
        i = int(np.argmax(np.diff(times) < 0)) + 1
        raise ValueError(
            f"{where}: arrival times must be non-decreasing "
            f"(line {i + 1} goes backwards)")

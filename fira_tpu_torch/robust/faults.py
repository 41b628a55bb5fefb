"""Seeded, site-addressed fault-injection registry (counterpart of
``fira_tpu/robust/faults.py``).

The serving stack's degradation contracts (poison-request quarantine,
engine retirement, the dispatch watchdog) are only real if a test can
trigger the failure deterministically. This module is the trigger: named
injection points ("sites") on the request path, armed by a spec string
checked at parse time

    site:kind:rate:seed[,site:kind:rate:seed...]

with kinds ``raise`` (the site throws :class:`InjectedFault`), ``hang``
(the site sleeps ``fault_hang_s`` wall seconds: the watchdog's prey) and
``corrupt`` (the site's host payload is scrambled in place, same shapes
and dtypes; only the ``CORRUPT_SITES`` own a host payload). Whether an
event fires is a pure function of ``(seed, site, event key)`` through a
keyed blake2b digest: no process-global RNG, no dependence on call order,
so every chaos run replays exactly, thread pools included (feeder sites
key by task sequence number, the single-threaded scheduler's sites by a
counter a site). The draws are the JAX package's, so one spec fires at
the same events in both.

Off by default: with no spec armed the injector is ``None`` and every site
check is one ``is not None`` branch. Faults act on the host only (raise
before a dispatch, sleep, scramble a numpy batch), never inside a launch.

The port wires all twelve sites of the JAX package, the prefill tier's
``disagg.transport`` (a delivery lost, or a row scrambled and caught by
its checksum) and ``disagg.worker`` (a worker process dies) included, so
``UNWIRED_SITES`` is empty.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from fira_tpu_torch.analysis.sanitizer import guard_structures
from fira_tpu_torch.config import FiraConfig

SITES = (
    "feeder.assemble",    # host batch assembly on a feeder worker
    "feeder.device_put",  # the worker-side hand-off to the transfer
    "ingest.parse",       # raw-diff ingest on a feeder worker
    "ingest.cache",       # a whole-diff result-cache lookup
    "engine.prefill",     # the engine's prefill dispatch (admit)
    "engine.step",        # the engine's step dispatch
    "engine.harvest",     # the done-mask read and the settled rows' read
    "fleet.replica",      # one replica's whole service round
    "serve.admit",        # a request's admission into the serve queue
    "cache.lookup",       # a prefix-cache lookup (decode/prefix_cache.py):
    #                       raise => absorbed as a miss (re-prefill, never
    #                       a wrong answer); corrupt => the read payload is
    #                       scrambled, the entry's content checksum catches
    #                       it, and the entry is dropped
    "disagg.transport",   # a prefill-tier artifact delivery
    "disagg.worker",      # one prefill-worker work item
)
KINDS = ("raise", "hang", "corrupt")
CORRUPT_SITES = ("feeder.assemble", "ingest.parse", "ingest.cache",
                 "cache.lookup", "disagg.transport")

# sites of the JAX package the port does not wire yet, and the ROADMAP
# item that brings each one's code path: none, every site is wired
UNWIRED_SITES: Dict[str, str] = {}


class InjectedFault(RuntimeError):
    """A fault fired by the injection registry: the exception the
    degradation machinery must absorb (quarantine or retirement), never
    a bug in itself."""

    def __init__(self, site: str, key) -> None:
        super().__init__(f"injected fault at {site} (event {key})")
        self.site = site
        self.key = key


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site: fire ``kind`` with probability ``rate`` an event,
    deterministically under ``seed``."""

    site: str
    kind: str
    rate: float
    seed: int


def parse_fault_specs(spec: str) -> List[FaultSpec]:
    """Parse ``site:kind:rate:seed[,...]``; raises ValueError naming the
    knob on any malformed entry (the JAX package's words), or on a site
    the port does not wire yet (naming the ROADMAP item that brings it).
    The CLI turns it into exit 2 via :func:`robust_errors`."""
    specs: List[FaultSpec] = []
    seen: set = set()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        fields = entry.split(":")
        if len(fields) != 4:
            raise ValueError(
                f"inject_faults entry {entry!r} is not site:kind:rate:seed "
                f"(four ':'-separated fields); see docs/FAULTS.md")
        site, kind, rate_s, seed_s = fields
        if site not in SITES:
            raise ValueError(
                f"inject_faults site {site!r} is not a registered fault "
                f"site; choose from {', '.join(SITES)}")
        if kind not in KINDS:
            raise ValueError(
                f"inject_faults kind {kind!r} at site {site} is not one of "
                f"{', '.join(KINDS)}")
        if kind == "corrupt" and site not in CORRUPT_SITES:
            raise ValueError(
                f"inject_faults kind 'corrupt' is only meaningful at "
                f"{', '.join(CORRUPT_SITES)} (the site that owns a host "
                f"payload to scramble); {site} is a dispatch boundary")
        try:
            # firacheck: allow[HOST-SYNC] rate_s is a parse-time CLI spec string field, not a device value
            rate = float(rate_s)
        except ValueError:
            raise ValueError(
                f"inject_faults rate {rate_s!r} at site {site} is not a "
                f"float")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"inject_faults rate {rate} at site {site} must be in "
                f"[0, 1] (a per-event fire probability)")
        try:
            # firacheck: allow[HOST-SYNC] seed_s is a parse-time CLI spec string field, not a device value
            seed = int(seed_s)
        except ValueError:
            raise ValueError(
                f"inject_faults seed {seed_s!r} at site {site} is not an "
                f"integer")
        if site in seen:
            raise ValueError(
                f"inject_faults arms site {site} twice; one spec per site "
                f"(the event-key stream is per site)")
        if site in UNWIRED_SITES:
            raise ValueError(
                f"inject_faults site {site} is not wired in the port yet; "
                f"it comes with {UNWIRED_SITES[site]}")
        seen.add(site)
        specs.append(FaultSpec(site=site, kind=kind, rate=rate, seed=seed))
    return specs


def robust_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time robustness-knob check, one named-knob message a
    violation (CLI exit 2): the fault-spec grammar, the watchdog timeout
    (0 = off, else > 0), the quarantine retry count (>= 0) and the
    injected-hang duration (> 0)."""
    errs: List[str] = []
    if cfg.inject_faults:
        try:
            parse_fault_specs(cfg.inject_faults)
        except ValueError as e:
            errs.append(str(e))
    if cfg.dispatch_watchdog_s < 0:
        errs.append(
            f"dispatch_watchdog_s {cfg.dispatch_watchdog_s} must be 0 "
            f"(watchdog off) or > 0 wall seconds per dispatch")
    if cfg.robust_retries < 0:
        errs.append(
            f"robust_retries {cfg.robust_retries} must be >= 0 (retries "
            f"granted to a poisoned request before it is shed)")
    if cfg.fault_hang_s <= 0:
        errs.append(
            f"fault_hang_s {cfg.fault_hang_s} must be > 0 wall seconds "
            f"(the duration an injected 'hang' fault sleeps)")
    return errs


def backoff_s(attempt: int) -> float:
    """The quarantine retry backoff curve, shared by every retry site
    (feeder assembly, serve admission, serve prefill): linear in the
    attempt number, capped at 50 ms."""
    return min(0.01 * max(1, attempt), 0.05)


class FaultInjector:
    """The armed registry: one :class:`FaultSpec` a site, a keyed
    deterministic draw an event, and a count of what fired (``summary()``
    lands in the serve metrics)."""

    def __init__(self, specs: List[FaultSpec], *, hang_s: float = 2.0):
        self._by_site: Dict[str, FaultSpec] = {s.site: s for s in specs}
        self._counters: Dict[str, int] = {}
        self.hang_s = float(hang_s)
        self.fired: "collections.Counter" = collections.Counter()
        # per-site event keys that fired: for a serve request stream (one
        # single-row feeder task a split position) these are the affected
        # positions
        self.fired_keys: Dict[str, List] = collections.defaultdict(list)
        # feeder workers record fires concurrently
        self._lock = threading.Lock()
        # lock-discipline sanitizer: armed, a ``fired[site] += 1`` outside
        # ``with self._lock`` raises at the line
        self._lock, (self.fired,) = guard_structures(
            self, self._lock, [(self.fired, "fired")])

    def _record_fire(self, site: str, key) -> None:
        with self._lock:
            self.fired[site] += 1
            self.fired_keys[site].append(key)

    def armed(self, site: str) -> bool:
        return site in self._by_site

    @staticmethod
    def _draw(spec: FaultSpec, key) -> bool:
        """One uniform in [0, 1) a (seed, site, key), through a keyed
        blake2b digest: the same across processes, thread schedules and
        the two packages (tuple ``hash()`` is salted per process)."""
        msg = f"{spec.seed}:{spec.site}:{key}".encode()
        u = int.from_bytes(hashlib.blake2b(msg, digest_size=8).digest(),
                           "big") / 2.0 ** 64
        return u < spec.rate

    def check(self, site: str, key=None) -> None:
        """Fire the site's raise/hang fault for this event if the draw
        says so. ``key`` names the event (feeder sites pass the task
        sequence number, so thread scheduling cannot reorder draws);
        ``None`` uses a per-site counter, right for the single-threaded
        scheduler's sites. Every call is a fresh draw, so a retried event
        may succeed (rate < 1)."""
        spec = self._by_site.get(site)
        if spec is None or spec.kind == "corrupt":
            return
        if key is None:
            key = self._counters[site] = self._counters.get(site, 0) + 1
        if not self._draw(spec, key):
            return
        self._record_fire(site, key)
        if spec.kind == "hang":
            # a bounded stall, not an exception: the watchdog (or the
            # caller's patience) decides whether it retires anything
            time.sleep(self.hang_s)
            return
        raise InjectedFault(site, key)

    def corrupt(self, site: str, key, batch: Dict) -> Dict:
        """Scramble ONE host batch deterministically: the integer content
        fields roll one position, same shapes and dtypes; a different
        (garbage) sample the downstream must degrade on, never crash on,
        whose blast radius is its own output row."""
        spec = self._by_site.get(site)
        if spec is None or spec.kind != "corrupt" \
                or not self._draw(spec, key):
            return batch
        self._record_fire(site, key)
        out = dict(batch)
        for f in ("diff", "sub_token"):
            if f in out:
                out[f] = np.roll(out[f], 1, axis=-1)
        return out

    def summary(self) -> Dict[str, int]:
        """Fired-event counts a site (the record serve_metrics.json
        carries)."""
        with self._lock:
            return {site: int(n) for site, n in sorted(self.fired.items())}


def injector_from(cfg: FiraConfig) -> Optional[FaultInjector]:
    """The armed injector for ``cfg.inject_faults``, or None when no spec
    is armed (the zero-overhead default every caller branches on)."""
    if not cfg.inject_faults:
        return None
    return FaultInjector(parse_fault_specs(cfg.inject_faults),
                         hang_s=cfg.fault_hang_s)

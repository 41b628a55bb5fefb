"""Runtime sanitizer (counterpart of ``fira_tpu/analysis/sanitizer.py``).

``--sanitize`` on the CLI arms four checks for the whole run:

- NaN/Inf checks, in place of JAX's ``jax_debug_nans``/``jax_debug_infs``:
  a global module forward hook checks every floating output of every
  module call with ``torch.isnan``/``torch.isinf`` and raises
  ``FloatingPointError`` naming the module's qualified name (the first
  module whose output is non-finite: hooks fire inner modules first), and
  :func:`backward` runs the training backward under
  ``torch.autograd.set_detect_anomaly``, its NaN report re-raised as
  ``FloatingPointError``. That covers the copy score's forward (a
  ``CopyNet`` output) and its gradients (the backward of its
  ``torch.autograd.Function``). Each check reads a flag back from the
  device, so this is a debugging mode, not a training mode.
- :class:`CompileGuard`: the fixed-geometry contract. Eager torch compiles
  nothing, so the guard holds what a JAX recompile stands for: a
  program's input signature (each tensor's shape, dtype and device).
  Call ``guard.step(label, *inputs)`` at each dispatch; a label's first
  step records its signature (the warmup), a later step with another
  signature raises :class:`RetraceError` naming the label and both
  signatures. After :meth:`CompileGuard.declare` a dispatch under an
  undeclared label raises too.
- :class:`ThreadGuard`: the lock-discipline sanitizer. While armed, the
  threaded shared structures (the ingest result cache and memos,
  ingest/cache.py; the fault injector's ``fired`` counts,
  robust/faults.py; the feeder's ordered-ready channel, data/feeder.py)
  are built as guarded proxies: a mutation by a thread that does not hold
  the structure's owning lock raises :class:`LockDisciplineError` at the
  mutating line, and every lock acquisition records its ordering edges so
  an inversion (A->B observed after B->A) is listed in
  ``ThreadGuard.inversions``. Unarmed, nothing is wrapped: the structures
  are plain dicts/Counters, one is-None branch at construction.
- :class:`LeakGuard`: the resource-lifecycle sanitizer. While armed, the
  acquire/release pairs are ledgered: paged-block grants
  (decode/engine.py), pipeline threads (data/feeder.py, and the
  watchdog's deliberately abandoned dispatch thread, robust/watchdog.py),
  the ingest process pool (ingest/cache.py) and the prefill tier's worker
  processes (serve/disagg.py). ``assert_clean()`` at serve teardown
  raises :class:`LeakError` naming the acquire site of every resource
  still held; an abandoned thread is sanctioned through
  :meth:`LeakGuard.abandon_thread`. Unarmed, ``leak_guard()`` is None and
  every call site is one is-None branch.

The guard is per label, not global: a fused-steps run dispatches the
grouped program and, at the epoch tail, the per-step program; each label
gets its own warmup dispatch.

This module imports no torch at module level: the ingest pool's spawned
workers import the guarded classes, and must not load the device
runtime.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple


class RetraceError(RuntimeError):
    """A post-warmup dispatch of a program changed its input signature
    (the port's counterpart of a fresh XLA compilation)."""


class LockDisciplineError(RuntimeError):
    """A guarded shared structure was mutated by a thread that does not
    hold its owning lock (ThreadGuard; static twin: SHARED-MUT)."""


class LeakError(RuntimeError):
    """A tracked resource was still held at a teardown assert_clean()
    (LeakGuard; static twin: RES-LEAK). The message names every leaked
    resource's ACQUIRE site — the line that owes the release."""


def program_label(kind: str, tag: Optional[str] = None, group: int = 1) -> str:
    """Canonical label for one member of the (geometry x entrypoint x
    group-size) program family — the single format every dispatch site
    labels and declares with, so the declared-family check can close over
    grouped programs too:

    ``program_label('train_step')``                    -> ``train_step``
    ``program_label('train_step', 'a16.e256.t8')``     -> ``train_step[a16.e256.t8]``
    ``program_label('grouped_step', 'a16.e256.t8', 8)``-> ``grouped_step[a16.e256.t8.g8]``
    ``program_label('grouped_step', None, 8)``         -> ``grouped_step[g8]``

    ``tag`` is a bucket geometry tag (data.buckets.geom_tag) or None;
    ``group`` > 1 is the stacked leading dim (fused K / accum A), so a
    grouped program at an undeclared (geom, K) raises at the dispatch that
    produced it, not as a mystery recompile."""
    mods = ".".join(m for m in (tag, f"g{group}" if group > 1 else None) if m)
    return f"{kind}[{mods}]" if mods else kind


def signature(*inputs) -> Tuple:
    """The input signature of one dispatch: each tensor's (shape, dtype,
    device), through dicts (by sorted key), lists and tuples; an array
    without a device gives (shape, dtype); anything else its type name."""
    out = []
    for x in inputs:
        if isinstance(x, dict):
            out.append(tuple((k, signature(x[k])[0]) for k in sorted(x)))
        elif isinstance(x, (list, tuple)):
            out.append(signature(*x))
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            dev = getattr(x, "device", None)
            out.append((tuple(x.shape), str(x.dtype))
                       + ((str(dev),) if dev is not None else ()))
        else:
            out.append(type(x).__name__)
    return tuple(out)


@dataclasses.dataclass
class CompileGuard:
    """Per-program-label signature budget: 1 warmup dispatch records the
    signature, then zero changes.

    With a bucketed geometry family (data/buckets.py) every bucket's
    program gets its own label (``train_step[a16.e256.t8]``), and grouped
    dispatch (data/grouping.py) widens the family along the group-size
    axis (``grouped_step[a16.e256.t8.g8]`` — see :func:`program_label`).
    Callers additionally :meth:`declare` the family after pre-warming —
    from then on a dispatch under an UNDECLARED label raises, so a
    geometry or group size outside the declared (geom, K) table is caught
    at the step that produced it."""

    _extra: int = 0
    _seen: Dict[str, int] = dataclasses.field(default_factory=dict)
    _signatures: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    _declared: Optional[set] = None

    def declare(self, labels) -> None:
        """Close the program family: after this, ``step()`` on a label not
        in the (cumulative) declared set raises RetraceError. Idempotent
        and additive — train and decode each declare their own labels."""
        self._declared = (self._declared or set()) | set(labels)

    @property
    def family_closed(self) -> bool:
        """True once declare() has closed the program family. Mid-run
        label additions (a respawned replica's fresh program set —
        robust/recovery.py) must declare ADDITIVELY into a closed family
        and must never be the FIRST declare: closing an open family
        around only the replacement's labels would outlaw every
        already-serving program."""
        return self._declared is not None

    def step_counting(self, label: str, *inputs) -> int:
        """Record one dispatch of ``label`` with ``inputs``; returns 1 when
        a post-warmup dispatch's signature differs from the warmup's,
        else 0."""
        sig = signature(*inputs)
        steps = self._seen.get(label, 0)
        self._seen[label] = steps + 1
        if steps == 0:
            self._signatures[label] = sig
            return 0
        extra = int(sig != self._signatures[label])
        self._extra += extra
        return extra

    def step(self, label: str, *inputs) -> None:
        """step_counting + raise: the per-dispatch check."""
        if self._declared is not None and label not in self._declared:
            raise RetraceError(
                f"sanitizer: program '{label}' is not in the declared "
                f"program family {sorted(self._declared)} — a geometry "
                f"outside the declared bucket table reached a dispatch "
                f"site (shape drift or a mis-packed batch)")
        if self.step_counting(label, *inputs):
            raise RetraceError(
                f"sanitizer: the input signature changed at step "
                f"{self._seen[label]} of program '{label}' — the "
                f"fixed-geometry invariant is broken (shape drift). "
                f"Warmup: {self._signatures[label]}; now: "
                f"{signature(*inputs)}")

    def compiles_after_warmup(self) -> int:
        """Post-warmup dispatches whose signature changed — 0 on a healthy
        run (the regression tests pin this without the raise path)."""
        return self._extra

    def summary(self) -> str:
        """One line: dispatches, labels and signature changes (the CLI
        prints it at the end of a sanitized run)."""
        labels = ", ".join(f"{k} x{n}" for k, n in sorted(self._seen.items()))
        return (f"sanitizer: {sum(self._seen.values())} dispatches under "
                f"{len(self._seen)} labels ({labels}), {self._extra} "
                f"signature changes after warmup")


# --------------------------------------------------------------------------
# NaN/Inf checks: the counterpart of jax_debug_nans / jax_debug_infs
# --------------------------------------------------------------------------

class NanCheck:
    """The armed NaN/Inf checks: a global module forward hook over every
    floating output (``nans``: NaN, ``infs``: ±Inf), and the NaN check of
    :func:`backward`. Module names are qualified from the outermost module
    called: a module first seen outside any indexed module indexes its
    own submodules under its class name (``FiraModel.copy_net``)."""

    def __init__(self, nans: bool = True, infs: bool = True):
        self.nans, self.infs = nans, infs
        self._names: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._handles: list = []

    def install(self) -> None:
        from torch.nn.modules import module as nn_module

        self._handles = [
            nn_module.register_module_forward_pre_hook(self._pre_hook),
            nn_module.register_module_forward_hook(self._hook)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def name(self, module) -> str:
        return self._names.get(module, type(module).__name__)

    def _pre_hook(self, module, args) -> None:
        if module not in self._names:
            root = type(module).__name__
            for name, sub in module.named_modules():
                self._names[sub] = f"{root}.{name}" if name else root

    def _hook(self, module, args, output) -> None:
        for i, t in enumerate(_floating_tensors(output)):
            bad = self._nonfinite(t)
            if bad:
                raise FloatingPointError(
                    f"sanitizer: module '{self.name(module)}' "
                    f"({type(module).__name__}) produced {bad} in its "
                    f"output {i} (shape {tuple(t.shape)}, {t.dtype}) — the "
                    f"first module whose output is non-finite")

    def _nonfinite(self, t) -> str:
        import torch

        if self.nans and self.infs:
            if bool(torch.isfinite(t).all()):
                return ""
            return "NaN" if bool(torch.isnan(t).any()) else "Inf"
        if self.nans and bool(torch.isnan(t).any()):
            return "NaN"
        if self.infs and bool(torch.isinf(t).any()):
            return "Inf"
        return ""


def _floating_tensors(x) -> Iterator:
    """Floating tensors of a module output, through tuples, lists and
    dicts."""
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _floating_tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _floating_tensors(v)
    elif getattr(x, "is_floating_point", None) is not None \
            and x.is_floating_point():
        yield x


def backward(loss) -> None:
    """``loss.backward()``. With the NaN check armed it runs under
    ``torch.autograd.set_detect_anomaly`` (check_nan), and the anomaly
    report of a backward function that returned NaN is re-raised as
    ``FloatingPointError``, naming that function."""
    check = _NAN_CHECK
    if check is None or not check.nans:
        loss.backward()
        return
    import torch

    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            loss.backward()
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(
            f"sanitizer: the backward produced NaN: {e}") from e


# --------------------------------------------------------------------------
# ThreadGuard: the runtime lock-discipline sanitizer (static twin:
# SHARED-MUT)
# --------------------------------------------------------------------------

class _GuardedLock:
    """A lock (or Condition) wrapper that records held-set membership in
    the owning ThreadGuard's thread-local state and lock-order edges on
    every acquisition. All other attributes (``wait``, ``notify_all``,
    ...) pass through, so a Condition keeps working as a Condition."""

    def __init__(self, guard: "ThreadGuard", lock, name: str):
        self._tg_guard = guard
        self._tg_lock = lock
        self.name = name

    def acquire(self, *args, **kwargs):
        got = self._tg_lock.acquire(*args, **kwargs)
        if got:
            self._tg_guard._note_acquire(self.name)
        return got

    def release(self):
        self._tg_guard._note_release(self.name)
        self._tg_lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __getattr__(self, attr):
        # Condition.wait/notify/notify_all pass through; wait() releases
        # and reacquires the UNDERLYING lock internally — the held-set
        # entry stays put, which is correct: from this thread's point of
        # view the critical section never closed
        return getattr(self._tg_lock, attr)


class _GuardedMutations:
    """The mutation-check machinery the guarded containers mix in (before
    their base in the MRO, so ``super()`` resolves to the real container).
    Reads are unchecked — the sanitizer targets unsynchronized WRITES.
    During base-class ``__init__`` (which may call ``update``/
    ``__setitem__``) the class-level ``_tg_guard = None`` default makes
    every check a no-op; ThreadGuard.wrap binds the instance attrs
    afterwards."""

    _tg_guard: "ThreadGuard" = None  # set by ThreadGuard.wrap
    _tg_lock: str = ""
    _tg_label: str = ""

    def _tg_check(self):
        if self._tg_guard is not None:
            self._tg_guard._check_mutation(self._tg_lock, self._tg_label)

    def __setitem__(self, k, v):
        self._tg_check()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._tg_check()
        super().__delitem__(k)

    def pop(self, *a, **kw):
        self._tg_check()
        return super().pop(*a, **kw)

    def popitem(self, *a, **kw):
        self._tg_check()
        return super().popitem(*a, **kw)

    def clear(self):
        self._tg_check()
        super().clear()

    def update(self, *a, **kw):
        self._tg_check()
        super().update(*a, **kw)

    def setdefault(self, *a, **kw):
        self._tg_check()
        return super().setdefault(*a, **kw)


class _GuardedDict(_GuardedMutations, collections.OrderedDict):
    """Mutation-checked mapping proxy (order-preserving, so it stands in
    for both plain dicts and OrderedDicts)."""

    def move_to_end(self, *a, **kw):
        self._tg_check()
        super().move_to_end(*a, **kw)


class _GuardedCounter(_GuardedMutations, collections.Counter):
    """Mutation-checked Counter (``c[k] += 1`` routes through
    ``__setitem__``, exactly the unlocked-increment bug class)."""

    def subtract(self, *a, **kw):
        self._tg_check()
        super().subtract(*a, **kw)


class ThreadGuard:
    """Runtime lock-discipline sanitizer: declared shared structures
    mutate only under their owning lock, and lock-acquisition order is
    recorded to flag inversions.

    Usage (the pattern ingest/cache.py, robust/faults.py and
    data/feeder.py follow, through :func:`guard_structures`)::

        tg = thread_guard()           # None when unarmed
        if tg is not None:
            self._lock = tg.lock(self._lock, "IngestCache._lock")
            self._lru = tg.wrap(self._lru, self._lock, "IngestCache._lru")

    A ``wrap``-ped structure raises :class:`LockDisciplineError` on any
    mutation by a thread not currently holding the named lock. ``lock``
    additionally records ordering edges: whenever B is acquired while A
    is held the edge A->B is added, and if B->A was ever observed the
    inversion is recorded in :attr:`inversions` (recorded, not raised —
    a single observed inversion is a deadlock precondition, and the
    post-mortem wants the full pair list).
    """

    def __init__(self):
        self._tls = threading.local()
        self._meta = threading.Lock()   # guards the order/violation books
        self._edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.inversions: List[Dict] = []
        self.violations: List[Dict] = []

    # --- held-set bookkeeping (per thread) ---

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            with self._meta:
                for h in held:
                    if h == name:
                        continue
                    edge = (h, name)
                    if edge not in self._edges:
                        self._edges[edge] = (threading.current_thread().name,
                                             "")
                        if (name, h) in self._edges:
                            self.inversions.append({
                                "first": f"{name} -> {h}",
                                "then": f"{h} -> {name}",
                                "thread": threading.current_thread().name,
                            })
        held.append(name)

    def _note_release(self, name: str) -> None:
        held = self._held()
        # remove the LAST occurrence: locks nest, releases unwind
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break

    def _check_mutation(self, lock_name: str, label: str) -> None:
        held = self._held()
        if lock_name in held:
            return
        record = {"structure": label, "lock": lock_name,
                  "thread": threading.current_thread().name,
                  "held": list(held)}
        with self._meta:
            self.violations.append(record)
        raise LockDisciplineError(
            f"sanitizer: `{label}` mutated without holding its owning "
            f"lock `{lock_name}` (thread {record['thread']}, held locks: "
            f"{record['held'] or 'none'}) — the SHARED-MUT discipline: "
            f"every write site takes the lock, or the lock protects "
            f"nothing")

    # --- declaration surface ---

    def lock(self, lock, name: str) -> _GuardedLock:
        """Wrap a threading.Lock/RLock/Condition so acquisitions are
        tracked. ``name`` should be unique per instance (the callers
        suffix ``@{id(self):x}``)."""
        return _GuardedLock(self, lock, name)

    def wrap(self, obj, lock, label: str):
        """Wrap a shared structure so mutations require holding ``lock``
        (a :meth:`lock`-wrapped GuardedLock, or its name). Supports the
        mapping/Counter shapes the armed structures actually are;
        anything else is returned unwrapped (never break a run over an
        unguardable type)."""
        lock_name = lock.name if isinstance(lock, _GuardedLock) else str(lock)
        if isinstance(obj, collections.Counter):
            new: object = _GuardedCounter(obj)
        elif isinstance(obj, dict):
            new = _GuardedDict(obj)
        else:
            return obj
        new._tg_guard = self
        new._tg_lock = lock_name
        new._tg_label = label
        return new

    def summary(self) -> Dict:
        with self._meta:
            return {"violations": len(self.violations),
                    "lock_order_edges": len(self._edges),
                    "inversions": list(self.inversions)}


# --------------------------------------------------------------------------
# LeakGuard: the runtime resource-lifecycle sanitizer (static twin:
# RES-LEAK)
# --------------------------------------------------------------------------

class LeakGuard:
    """Runtime acquire/release ledger: every tracked acquire records its
    acquire site, every release retires the record, and
    :meth:`assert_clean` at teardown raises :class:`LeakError` naming the
    acquire site of whatever is still held.

    Usage (the pattern decode/engine.py, data/feeder.py and
    ingest/cache.py follow)::

        self._leaks = leak_guard()    # None when unarmed
        ...
        if self._leaks is not None:
            self._leaks.note_acquire("block", key, what="paged block 3")

    Resources are keyed ``(kind, key)`` where the caller's key embeds
    ``@{id(owner):x}`` so two engines never alias each other's blocks.
    Threads get dedicated helpers (:meth:`track_thread` /
    :meth:`note_joined` / :meth:`abandon_thread`) keyed by the thread
    object. ``abandon_thread`` is the watchdog's sanction: a deliberately
    abandoned dispatch thread moves to the :attr:`abandoned` book with its
    reason instead of counting as a leak.
    """

    def __init__(self) -> None:
        self._meta = threading.Lock()
        self._open: Dict[Tuple[str, str], Dict] = {}
        self.abandoned: List[Dict] = []
        self.acquires = 0
        self.releases = 0
        # releases with no matching acquire: 0 on a healthy run — a
        # nonzero count means a double-release or an untracked acquire
        self.unmatched_releases = 0

    @staticmethod
    def _site(skip: int) -> str:
        """``file.py:line in func`` for the frame ``skip`` levels above
        the caller of this method — the acquire site a LeakError names."""
        f = sys._getframe(skip + 1)
        return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
                f"in {f.f_code.co_name}")

    @staticmethod
    def _thread_key(thread: threading.Thread) -> str:
        return f"{thread.name}@{id(thread):x}"

    # --- the ledger ---

    def note_acquire(self, kind: str, key: str, what: str = "",
                     site: Optional[str] = None) -> None:
        site = site if site is not None else self._site(1)
        record = {"kind": kind, "key": str(key), "what": what or kind,
                  "site": site,
                  "thread": threading.current_thread().name}
        with self._meta:
            self.acquires += 1
            self._open[(kind, str(key))] = record

    def note_release(self, kind: str, key: str) -> None:
        with self._meta:
            self.releases += 1
            if self._open.pop((kind, str(key)), None) is None:
                self.unmatched_releases += 1

    def track_thread(self, thread: threading.Thread,
                     what: str = "") -> None:
        self.note_acquire("thread", self._thread_key(thread),
                          what=what or f"thread '{thread.name}'",
                          site=self._site(1))

    def note_joined(self, thread: threading.Thread) -> None:
        self.note_release("thread", self._thread_key(thread))

    def abandon_thread(self, thread: threading.Thread,
                       reason: str) -> None:
        """Sanction a deliberately unjoined thread (the watchdog's
        abandoned dispatch): the record moves to :attr:`abandoned` with
        its reason and no longer counts as held."""
        with self._meta:
            rec = self._open.pop(("thread", self._thread_key(thread)),
                                 None)
            if rec is not None:
                rec["reason"] = reason
                self.abandoned.append(rec)

    # --- the teardown oracle ---

    def open_resources(self) -> List[Dict]:
        with self._meta:
            return list(self._open.values())

    def assert_clean(self, scope: str = "teardown") -> None:
        """Raise :class:`LeakError` naming the acquire site of every
        resource still held (sanctioned abandons excluded). The serve
        teardown call — the dynamic twin of a RES-LEAK finding."""
        leaks = self.open_resources()
        if not leaks:
            return
        sites = "; ".join(
            f"{r['what']} ({r['kind']} '{r['key']}') acquired at "
            f"{r['site']}" for r in leaks[:5])
        more = f" (+{len(leaks) - 5} more)" if len(leaks) > 5 else ""
        raise LeakError(
            f"sanitizer: {len(leaks)} resource(s) still held at {scope}: "
            f"{sites}{more} — every acquire owes a release on every exit "
            f"path (RES-LEAK discipline)")

    def summary(self) -> Dict:
        with self._meta:
            return {"acquires": self.acquires,
                    "releases": self.releases,
                    "open": len(self._open),
                    "abandoned": len(self.abandoned),
                    "unmatched_releases": self.unmatched_releases}


# process-global arming points: the threaded structures and resource
# owners are constructed deep inside worker machinery, so they look the
# guards up here instead of threading them through every constructor.
# None = unarmed = nothing is wrapped, nothing recorded, no hook installed.
_THREAD_GUARD: Optional[ThreadGuard] = None
_LEAK_GUARD: Optional[LeakGuard] = None
_NAN_CHECK: Optional[NanCheck] = None


def leak_guard() -> Optional[LeakGuard]:
    """The armed LeakGuard, or None. Captured at construction time by
    the tracked owners (SlotEngine, Feeder, IngestExecutor, PrefillTier)
    so an owner's whole lifecycle reports to ONE ledger even if arming
    flips mid-run."""
    return _LEAK_GUARD


@contextlib.contextmanager
def leak_guarding(guard: Optional[LeakGuard] = None
                  ) -> Iterator[LeakGuard]:
    """Arm a LeakGuard for the block (tests). Owners constructed INSIDE
    the block are tracked; pre-existing ones are not (arming is a
    construction-time choice, like ThreadGuard)."""
    global _LEAK_GUARD
    prev = _LEAK_GUARD
    lg = guard if guard is not None else LeakGuard()
    _LEAK_GUARD = lg
    try:
        yield lg
    finally:
        _LEAK_GUARD = prev


def thread_guard() -> Optional[ThreadGuard]:
    """The armed ThreadGuard, or None. Called at construction time by
    the guarded classes (IngestCache, FaultInjector, Feeder)."""
    return _THREAD_GUARD


def nan_check() -> Optional[NanCheck]:
    """The armed NaN/Inf check, or None."""
    return _NAN_CHECK


def guard_structures(owner, lock, structures, lock_label: str = "_lock"):
    """Construction-time arming hook for the guarded classes
    (IngestCache/LexMemo/HunkMemo, FaultInjector, Feeder): returns
    ``(lock, [structures...])`` untouched when no ThreadGuard is armed
    (one is-None branch, zero steady-state overhead), else the guarded
    lock plus mutation-checked proxies. ``structures`` is a list of
    ``(structure, label)`` pairs; ``lock_label`` is the owner's REAL
    attribute name for the lock (Feeder's is ``_cond``) so a violation
    message points at an attribute that exists; names are suffixed
    ``@id`` so two instances never alias each other's held-lock
    authority."""
    tg = thread_guard()
    if tg is None:
        return lock, [s for s, _label in structures]
    name = f"{type(owner).__name__}.{lock_label}@{id(owner):x}"
    glock = tg.lock(lock, name)
    return glock, [tg.wrap(s, glock,
                           f"{type(owner).__name__}.{label}@{id(owner):x}")
                   for s, label in structures]


@contextlib.contextmanager
def thread_guarding(guard: Optional[ThreadGuard] = None
                    ) -> Iterator[ThreadGuard]:
    """Arm a ThreadGuard for the block (tests). Structures constructed
    INSIDE the block are guarded; pre-existing ones are not (arming is a
    construction-time choice)."""
    global _THREAD_GUARD
    prev = _THREAD_GUARD
    tg = guard if guard is not None else ThreadGuard()
    _THREAD_GUARD = tg
    try:
        yield tg
    finally:
        _THREAD_GUARD = prev


@contextlib.contextmanager
def nan_checking(nans: bool = True, infs: bool = True
                 ) -> Iterator[Optional[NanCheck]]:
    """Install the NaN/Inf checks for the block (None, and nothing
    installed, when both are off); the hooks and the previous check are
    restored on exit."""
    global _NAN_CHECK
    if not (nans or infs):
        yield None
        return
    prev = _NAN_CHECK
    check = NanCheck(nans=nans, infs=infs)
    check.install()
    _NAN_CHECK = check
    try:
        yield check
    finally:
        check.remove()
        _NAN_CHECK = prev


def arm(enabled: bool = True, *, nans: bool = True, infs: bool = True,
        ) -> Optional[CompileGuard]:
    """Process-lifetime arming — CLI-ONLY (fira_tpu_torch/cli.py). Installs
    the NaN/Inf hooks and the thread and leak guards with no teardown,
    which is fine exactly when the process dies with the run. Library
    callers and tests use the :func:`sanitize` context manager and pass
    the resulting guard into train()/run_test() instead."""
    if not enabled:
        return None
    global _THREAD_GUARD, _LEAK_GUARD, _NAN_CHECK
    if nans or infs:
        _NAN_CHECK = NanCheck(nans=nans, infs=infs)
        _NAN_CHECK.install()
    _THREAD_GUARD = ThreadGuard()
    _LEAK_GUARD = LeakGuard()
    return CompileGuard()


@contextlib.contextmanager
def sanitize(enabled: bool = True, *, nans: bool = True, infs: bool = True,
             ) -> Iterator[Optional[CompileGuard]]:
    """Arm the full sanitizer for the block; yields a CompileGuard (None
    when disabled). Every global it sets (the module hooks, the NaN check
    of :func:`backward`, the thread and leak guards) is restored on exit.

    The entry points thread the guard through their dispatch sites:
    ``train/loop.py`` labels the per-step/grouped/dev programs,
    ``decode/runner.py`` the beam and the engine's dispatches.
    """
    if not enabled:
        yield None
        return
    with nan_checking(nans, infs), thread_guarding(), leak_guarding():
        yield CompileGuard()

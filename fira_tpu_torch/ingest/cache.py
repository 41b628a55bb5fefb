"""The ingest fast path (the port's copy of the JAX package's
``ingest/cache.py``, docs/INGEST.md "Fast path"): the whole-diff result
cache, hunk-level AST memoization and the parse-stage process executor.

The prefill cache (decode/prefix_cache.py) digests the assembled payload,
so a repeated diff still pays the whole lex -> AST -> assemble pipeline
before it hits. This module content-addresses the request at intake
instead, memoizes the AST stage below the request, and gives the
GIL-bound parse stage a process pool:

- :class:`IngestCache`: requests are content-addressed by a keyed blake2b
  digest of the raw diff text (:func:`text_digest`, the JAX package's
  hex strings) before any lexing. A byte-identical repeat skips the
  pipeline and seats from an entry- and byte-bounded LRU of assembled
  payloads, its ``_ingest`` stamps replayed with ``cached: True``. The
  prefix cache and dedup then fire on the same payload digest too. A
  concurrent taker of a digest in flight waits for its leader instead of
  re-ingesting. While the ``ingest.cache`` fault site is armed every
  entry carries a content checksum checked at lookup: an injected raise
  is a miss (re-ingest, same bytes), an injected corrupt read is caught
  and dropped (re-ingest, never a wrong answer).
- :class:`HunkMemo`: the per-chunk extraction
  (``preprocess.extract.update_chunk_edges`` / ``normal_chunk_edges``) is
  a pure function of the typed chunk tokens on the index-free ingest
  path, so near-identical diffs (one file changed out of many) reuse
  parsed and diffed chunks while ``extract_commit``'s rebase re-runs per
  request; ``memo_hits``/``memo_misses`` a request meter it.
  :class:`LexMemo` is the same for the native lexer: each distinct line
  text lexes once a process.
- :class:`IngestExecutor` runs the heavy stages per ``cfg.ingest_exec``:
  inline on the feeder worker thread ("thread"), or on a spawned process
  pool ("process") while the submitting thread waits on the future with
  the GIL released. Each pool process keeps its own memos; the output is
  bit-exact either way, the stages being pure functions of their inputs.

Under the runtime sanitizer (analysis/sanitizer.py) the LRUs and the
in-flight map are lock-checked proxies and the process pool is ledgered
from its start to its shutdown.

This module imports no torch: it is the spawn entry of the process pool,
and a pool worker must not load the device runtime (the parent holds a
CUDA context) just to parse Java.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from fira_tpu_torch.analysis.sanitizer import guard_structures, leak_guard

_DIGEST_KEY = b"fira-ingest-cache-v1"

# "thread": the AST parse stage runs inline on the ingest worker;
# "process": it runs on a spawned process pool
EXEC_MODES = ("thread", "process")

# hunk-memo capacity in cached chunks (a few hundred bytes of tokens and
# its ChunkGraph each), lexer-memo capacity in distinct line texts
HUNK_MEMO_ENTRIES = 4096
LEX_MEMO_ENTRIES = 8192


def text_digest(text: str) -> str:
    """Content address of one raw request: keyed blake2b over the diff
    text's bytes, computed at intake, before any lexing."""
    h = hashlib.blake2b(key=_DIGEST_KEY, digest_size=16)
    h.update(text.encode("utf-8"))
    return h.hexdigest()


def _payload_checksum(host: Dict) -> str:
    """Keyed digest of a cached payload's wire content (name, dtype, shape
    and bytes of each array): what an ``ingest.cache`` corrupt read is
    caught against. Host-only "_" keys are replayed metadata, left out."""
    h = hashlib.blake2b(key=_DIGEST_KEY, digest_size=16)
    for name in sorted(k for k in host if not k.startswith("_")):
        # firacheck: allow[HOST-SYNC] ingest payloads are host numpy by construction (assembled worker-side, put=False); no device value exists here
        a = np.ascontiguousarray(np.asarray(host[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def payload_nbytes(host: Dict) -> int:
    return sum(int(np.asarray(v).nbytes)
               for k, v in host.items() if not k.startswith("_"))


@dataclasses.dataclass
class _Entry:
    host: Dict            # assembled payload (+ _bucket/_var/_ingest stamps)
    checksum: Optional[str]  # wire-content digest, kept only while the
    #                          ingest.cache site is armed (its corrupt
    #                          injection is the one writer between put and
    #                          take; unarmed, hashing every hit would tax
    #                          the workers the cache relieves)
    nbytes: int


class IngestCache:
    """Entry- and byte-bounded LRU of assembled wire payloads, keyed by the
    raw diff's :func:`text_digest`. Shared by the feeder worker threads, so
    takes and puts hold a lock, which never covers an ingest computation.
    A digest in flight coalesces concurrent takers onto its leader (see
    :meth:`take`), so a repeated diff is ingested once under any thread
    schedule.

    ``entries`` 0 = unbounded entry count; ``max_bytes`` 0 = unbounded
    bytes. Both bounds hold together when set, and an over-budget entry
    alone still lives (capacity one, never a refusal to serve).
    """

    def __init__(self, entries: int = 512, *, max_bytes: int = 0,
                 faults=None):
        if int(entries) < 0:
            raise ValueError(
                f"ingest cache entries must be >= 0 (0 = unbounded), "
                f"got {entries}")
        if int(max_bytes) < 0:
            raise ValueError(
                f"ingest cache byte budget must be >= 0 (0 = unbounded), "
                f"got {max_bytes}")
        self.capacity = int(entries)
        self.max_bytes = int(max_bytes)
        self._lru: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._faults = faults
        self._nbytes = 0
        self._lookups = 0
        # in-flight leadership: digest -> Event set when its leader
        # publishes or abandons; a taker of a digest in flight waits on it
        self._pending: Dict[str, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.fault_misses = 0
        self.integrity_drops = 0
        self.evictions = 0
        # lock-discipline sanitizer: the LRU and the in-flight map are
        # mutated from every feeder worker; armed, a mutation outside
        # ``with self._lock`` raises at the line
        self._lock, (self._lru, self._pending) = guard_structures(
            self, self._lock, [(self._lru, "_lru"),
                               (self._pending, "_pending")])

    def _integrity(self) -> bool:
        return self._faults is not None and self._faults.armed(
            "ingest.cache")

    def take(self, digest: str, *, fault_key=None,
             wait_s: float = 15.0) -> Tuple[Optional[Dict], str]:
        """(payload, outcome), outcome one of ``hit``, ``miss``,
        ``fault_miss`` (an injected lookup raise, absorbed: the caller
        re-ingests, never sheds) and ``integrity_drop`` (the checksum
        caught an injected corrupt read: the entry is evicted and the
        caller re-ingests). A hit returns a shallow copy whose ``_ingest``
        stamps are replayed with ``cached: True``; the arrays are shared
        read-only (the serve loop copies rows into packed batches).

        A ``miss`` makes the caller the digest's in-flight leader: it must
        follow with :meth:`put` (success) or :meth:`abandon` (failure) so
        that waiting takers wake. A taker of a digest in flight waits for
        the leader (``coalesced``, then the hit path); a leader that
        outlives ``wait_s`` makes the waiter a co-leader: duplicate
        compute, the same result, never a deadlock.

        ``fault_key``: the ``ingest.cache`` event key. Callers pass a
        schedule-independent request identity (the task generator passes
        the request position), so chaos runs replay exactly; the lookup
        counter is the fallback for keyless use."""
        parked = False
        while True:
            with self._lock:
                entry = self._lru.get(digest)
                if entry is None:
                    ev = self._pending.get(digest)
                    if ev is None:
                        self._pending[digest] = threading.Event()
                        self.misses += 1
                        return None, "miss"
                else:
                    self._lookups += 1
                    key = (fault_key if fault_key is not None
                           else self._lookups)
            if entry is None:
                published = ev.wait(wait_s)
                with self._lock:
                    if published:
                        # coalesced only if the re-lookup yields the
                        # entry: an abandon() wake re-leads as a miss
                        parked = True
                    elif self._pending.get(digest) is ev:
                        # leader presumed wedged: co-lead (its eventual
                        # put pops the same event, so stragglers wake)
                        self.misses += 1
                        return None, "miss"
                continue
            break
        if parked:
            with self._lock:
                self.coalesced += 1
        host = entry.host
        if self._integrity():
            try:
                self._faults.check("ingest.cache", key=key)
            except Exception:
                with self._lock:
                    self.fault_misses += 1
                return None, "fault_miss"
            host = self._faults.corrupt("ingest.cache", key, host)
            if (entry.checksum is not None
                    and _payload_checksum(host) != entry.checksum):
                with self._lock:
                    if self._lru.get(digest) is entry:
                        del self._lru[digest]
                        self._nbytes -= entry.nbytes
                    self.integrity_drops += 1
                return None, "integrity_drop"
        with self._lock:
            if digest in self._lru:
                self._lru.move_to_end(digest)
            self.hits += 1
        out = dict(host)
        # replay the original stage stamps with the `cached` flag; the memo
        # counters are zeroed: they meter hunk reuse inside whole-diff
        # misses, and no memo work ran on this hit
        stamps = dict(host.get("_ingest") or {}, cached=True)
        if "memo_hits" in stamps:
            stamps["memo_hits"] = stamps["memo_misses"] = 0
        out["_ingest"] = stamps
        return out, "hit"

    def put(self, digest: str, host: Dict) -> int:
        """Insert or refresh one assembled payload; returns the entries
        evicted to make room. The stored dict is a shallow copy taken
        before any fault-site corruption or digest stamping downstream, so
        a replay is the clean computation. Publishing pops the digest's
        in-flight registration and wakes its waiting takers."""
        entry = _Entry(host=dict(host),
                       checksum=(_payload_checksum(host)
                                 if self._integrity() else None),
                       nbytes=payload_nbytes(host))
        evicted = 0
        with self._lock:
            old = self._lru.get(digest)
            if old is not None:
                self._nbytes -= old.nbytes
            self._lru[digest] = entry
            self._lru.move_to_end(digest)
            self._nbytes += entry.nbytes
            while (self.capacity and len(self._lru) > self.capacity) or (
                    self.max_bytes and self._nbytes > self.max_bytes
                    and len(self._lru) > 1):
                _d, e = self._lru.popitem(last=False)
                self._nbytes -= e.nbytes
                evicted += 1
            self.evictions += evicted
            ev = self._pending.pop(digest, None)
        if ev is not None:
            ev.set()
        return evicted

    def abandon(self, digest: str) -> None:
        """The leader's failure path: wake the waiting takers without an
        entry; the first to look up again leads and re-ingests (a failing
        request never wedges its duplicates)."""
        with self._lock:
            ev = self._pending.pop(digest, None)
        if ev is not None:
            ev.set()

    def summary(self) -> Dict[str, int]:
        with self._lock:
            total = self.hits + self.misses + self.fault_misses \
                + self.integrity_drops
            return {
                "entries": len(self._lru),
                "nbytes": self._nbytes,
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
                "fault_misses": self.fault_misses,
                "integrity_drops": self.integrity_drops,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
            }


class LexMemo:
    """A bounded text -> tokens map over the native lexer, shared by the
    ingest workers of a process: each distinct line lexes once."""

    def __init__(self, entries: int = LEX_MEMO_ENTRIES):
        self.capacity = max(1, int(entries))
        self._lru: "collections.OrderedDict[str, Optional[tuple]]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._lock, (self._lru,) = guard_structures(
            self, self._lock, [(self._lru, "_lru")])

    def __call__(self, text: str):
        with self._lock:
            if text in self._lru:
                self._lru.move_to_end(text)
                self.hits += 1
                cached = self._lru[text]
                return None if cached is None else list(cached)
        from fira_tpu_torch.preprocess import astdiff_binding as astdiff

        toks = astdiff.tokenize(text)
        with self._lock:
            self.misses += 1
            self._lru[text] = None if toks is None else tuple(toks)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
        return toks


class HunkMemo:
    """Per-chunk extraction results keyed by a keyed digest of (chunk
    type, tokens). ``extract_commit`` only reads a cached ChunkGraph while
    rebasing it into commit coordinates. The extraction runs outside the
    lock (a native parse must not serialize the workers); two racing
    computations insert equal values."""

    def __init__(self, entries: int = HUNK_MEMO_ENTRIES):
        self.capacity = max(1, int(entries))
        self._lru: "collections.OrderedDict[str, object]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._lock, (self._lru,) = guard_structures(
            self, self._lock, [(self._lru, "_lru")])

    @staticmethod
    def _key(chunk, typ: int) -> str:
        h = hashlib.blake2b(key=_DIGEST_KEY, digest_size=16)
        h.update(str(typ).encode())
        if typ == 100:
            old, new = chunk
            h.update("\x00".join(old).encode())
            h.update(b"\x01")
            h.update("\x00".join(new).encode())
        else:
            h.update("\x00".join(chunk).encode())
        return h.hexdigest()

    def chunk_graph(self, chunk, typ: int, commit_index=None):
        """The memoized per-chunk extraction of
        ``preprocess.extract.extract_commit``. ``commit_index`` joins the
        key when set (the reference's corpus hack makes extraction
        index-dependent; the ingest path passes None)."""
        return self.get_or_compute(chunk, typ, commit_index)[0]

    def get_or_compute(self, chunk, typ: int, commit_index=None):
        """(graph, hit). The hit flag is per call, so a per-request tally
        (:class:`MemoTally`) stays exact when requests share this memo."""
        key = self._key(chunk, typ)
        if commit_index is not None:
            key = f"{key}:{commit_index}"
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                self.hits += 1
                return self._lru[key], True
        from fira_tpu_torch.preprocess import extract

        if typ == 100:
            g = extract.update_chunk_edges(chunk[0], chunk[1],
                                           commit_index=commit_index)
        else:
            g = extract.normal_chunk_edges(list(chunk),
                                           commit_index=commit_index)
        with self._lock:
            self.misses += 1
            self._lru[key] = g
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
        return g, False


class MemoTally:
    """One request's view of a shared :class:`HunkMemo`: ``chunk_graph``
    (what ``extract_commit(memo=)`` calls) delegates and counts this
    request's hits and misses, the ``_ingest`` stamps' meter."""

    __slots__ = ("_memo", "hits", "misses")

    def __init__(self, memo: HunkMemo):
        self._memo = memo
        self.hits = 0
        self.misses = 0

    def chunk_graph(self, chunk, typ: int, commit_index=None):
        g, hit = self._memo.get_or_compute(chunk, typ, commit_index)
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return g


# --------------------------------------------------------------------------
# the parse-stage executor (cfg.ingest_exec)
# --------------------------------------------------------------------------

# the state of a spawned pool worker, set by the pool initializer: its own
# hunk and lexer memos (spawned processes share no memory) and, for whole-
# request offload, its copy of the frozen vocabularies, config and bucket
# table, shipped once at spawn
_PROC_MEMO: Optional[HunkMemo] = None
_PROC_LEX: Optional[LexMemo] = None
_PROC_CONTEXT: Optional[tuple] = None   # (word_vocab, ast_change_vocab,
#                                          cfg, table)
_PROC_EXEC: Optional["IngestExecutor"] = None  # the worker's own thread-
#                                          mode executor carrying _PROC_MEMO


def _proc_init(context=None) -> None:
    global _PROC_MEMO, _PROC_LEX, _PROC_CONTEXT, _PROC_EXEC
    # the memos arm only when the fast path's cache knob is on (context
    # carries the cfg): with ingest_cache off, process mode is fan-out
    # without memoization. Stage-only mode (no context) keeps its memo
    arm = context is None or context[2].ingest_cache
    _PROC_MEMO = HunkMemo() if arm else None
    _PROC_LEX = LexMemo() if arm else None
    _PROC_CONTEXT = context
    _PROC_EXEC = (IngestExecutor("thread", memo=_PROC_MEMO)
                  if _PROC_MEMO is not None else None)


def _parse_with_memo(req, cfg, truncate, memo: Optional[HunkMemo]):
    """The parse stage both modes run: FSM, AST extraction and the
    truncation policy, this request's memo reuse counted by a
    :class:`MemoTally`. Returns (record, info, memo_hits, memo_misses)."""
    from fira_tpu_torch.ingest.service import ingest_record

    tally = MemoTally(memo) if memo is not None else None
    record, info = ingest_record(req, cfg, truncate=truncate, memo=tally)
    return (record, info,
            tally.hits if tally is not None else 0,
            tally.misses if tally is not None else 0)


def _proc_parse(req, cfg, truncate):
    """Pool-worker entry, the parse stage of one parsed request. Policy
    rejections (IngestError) reach the submitting thread as inline."""
    return _parse_with_memo(req, cfg, truncate, _PROC_MEMO)


def _proc_ingest(text: str):
    """Pool-worker entry, the whole request: raw diff text -> assembled
    single-row wire payload, in the worker (its LexMemo, its HunkMemo,
    the vocabularies, config and table shipped at spawn). The parent
    thread only pickles a string out and numpy arrays back.
    DiffParseError and IngestError reach the submitting thread
    unchanged."""
    from fira_tpu_torch.ingest.service import ingest_request

    wv, acv, cfg, table = _PROC_CONTEXT
    return ingest_request(text, wv, acv, cfg, table=table, lex=_PROC_LEX,
                          executor=_PROC_EXEC)


class IngestExecutor:
    """Runs the ingest pipeline's heavy stages per ``cfg.ingest_exec``:
    inline on the calling thread ("thread") or on a spawned process pool
    of ``workers`` processes ("process"). With ``context=(word_vocab,
    ast_change_vocab, cfg, table)`` the pool takes whole requests
    (:meth:`ingest`, the serve path), the context shipped once at spawn;
    without it only the parse stage (:meth:`parse`). :meth:`close` joins
    the pool; the context manager calls it."""

    def __init__(self, mode: str = "thread", *, workers: int = 2,
                 memo: Optional[HunkMemo] = None, context=None):
        if mode not in EXEC_MODES:
            raise ValueError(f"ingest_exec {mode!r} not in {EXEC_MODES}")
        self._memo = memo
        self._pool = None
        self._has_context = context is not None
        # resource-lifecycle sanitizer: armed, the process pool is
        # ledgered at construction and retired at close(), so a serve path
        # that drops the executor without a shutdown is named at teardown
        self._leaks = leak_guard()
        if mode == "process":
            import concurrent.futures
            import multiprocessing

            # spawn, not fork: the parent runs feeder and engine threads
            # and may hold a CUDA context, neither of which survives a
            # fork; a spawned worker imports only the host-side ingest
            # modules (no torch)
            ctx = multiprocessing.get_context("spawn")
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=max(1, int(workers)), mp_context=ctx,
                initializer=_proc_init, initargs=(context,))
            if self._leaks is not None:
                self._leaks.note_acquire(
                    "pool", f"IngestExecutor@{id(self):x}",
                    what=f"process pool ({max(1, int(workers))} workers)")

    @property
    def offloads_requests(self) -> bool:
        """True when :meth:`ingest` ships whole requests to the pool (the
        serve path's process mode)."""
        return self._pool is not None and self._has_context

    def ingest(self, text: str):
        """Raw diff text -> assembled payload in a pool worker. Only with
        ``context``."""
        if not self.offloads_requests:
            raise RuntimeError(
                "IngestExecutor.ingest needs process mode with context=")
        # .result() waits with the GIL released; sibling workers go on
        return self._pool.submit(_proc_ingest, text).result()

    def parse(self, req, cfg, truncate):
        """(record, info, memo_hits, memo_misses) of one parsed request,
        bit-exact in both modes."""
        if self._pool is not None:
            return self._pool.submit(_proc_parse, req, cfg,
                                     truncate).result()
        return _parse_with_memo(req, cfg, truncate, self._memo)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            if self._leaks is not None:
                self._leaks.note_release("pool",
                                         f"IngestExecutor@{id(self):x}")

    def __enter__(self) -> "IngestExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

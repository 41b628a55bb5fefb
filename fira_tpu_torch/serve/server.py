"""Arrival-timed serving loop over the slot engine (counterpart of
``fira_tpu/serve/server.py``).

The drain decode (decode/runner.py) hands the engine a pre-packed corpus
stream and measures commits/s. This module is the long-lived server under
open-loop load: requests arrive over time (serve/arrivals.py), the
scheduler refills slots from live arrivals, and the numbers that matter
are p50/p99 time to first token (TTFT) and end-to-end latency against the
offered rate.

One scheduler round:

1. **poll arrivals**: every request whose arrival time has passed moves
   into the admission queue (bounded by ``cfg.serve_queue_cap``; an
   arrival that finds it full is shed on the spot, recorded). Payloads are
   assembled ahead of time by the Feeder (one single-row ``make_batch``
   task a request, split order), so admission never waits on assembly.
   With ``cfg.prefix_cache``, an arrival byte-identical to a request in
   flight (the same worker-stamped digest, decode/prefix_cache.py)
   coalesces onto that leader instead of taking a queue slot: one decode,
   N output positions, each request keeping its own stamps. A shed
   follower detaches without killing the leader; a shed leader hands its
   group to the oldest surviving follower.
2. **shed deadlines**: queued requests older than
   ``cfg.serve_deadline_steps`` step dispatches are shed (seated requests
   always run to harvest; a late completion is flagged, not killed).
3. **admit**: up to ``cfg.serve_prefill_budget`` prefill dispatches: the
   head request's bucket is flushed into one packed batch (up to
   ``test_batch_size`` same-bucket requests in arrival order, padded with
   invalid rows) and prefilled. Each prefill stalls the seated slots' next
   step, so a small budget bounds the stall a new admission costs them.
4. **refill / step / harvest**: the engine's own pieces; harvested samples
   are cooked and written through the position-keyed ordered writer.

Equivalence (tests/test_torch_serve.py): on a replayed trace with nothing
shed, the output file's bytes equal the drain decode's (every op of the
beam is row-wise, and the writer keys by split position), and under the
virtual clock the request records equal the JAX package's field for field.

Replicas (``cfg.engine_replicas``, parallel/fleet.py): the loop walks
every live engine a round, the starting replica rotating round to round,
so admission spreads over the fleet; which replica serves a request never
changes its bytes. The in-flight dedup above is fleet-wide, each
replica's prefix cache its own.

Degradation (robust/): an assembly, admission or prefill fault is retried
``cfg.robust_retries`` times and then sheds its requests with the error
recorded; a step or harvest that raises, a ``fleet.replica`` fault, or
any dispatch that outlives ``cfg.dispatch_watchdog_s``, retires the
replica and requeues what it owed onto the survivors. With
``cfg.max_respawns`` a retired lineage is respawned after its backoff
(robust/recovery.py: a warm spare attached or a fresh engine built), and
while every replica is down with budget left admission pauses instead of
shedding; with no replica and no budget left the rest is shed with the
reason recorded. The output file stays position-complete (a shed request
writes an empty line), and ``serve_metrics.json`` is kept through the run
as an atomic ``.partial`` snapshot.

Crash-resume: with a ``journal_path`` each round's admits, completions
and sheds are appended to a request journal (one fsync a batch), and
``serve_split(resume=True)`` after a kill recovers the finished lines
from the ordered writer's crash pair and serves only the rest, at their
original positions: the final file is the uninterrupted run's.

Clocks: ``wall`` (arrivals paced in real time, idle waits sleep) or
``virtual`` (time advances a fixed cost a prefill or step dispatch and
jumps idle gaps). Both observe latencies only at dispatch and harvest
boundaries, which is what the host can see.

Raw-diff requests (``cli serve --input diffs``) run this loop through
``ingest/service.serve_diffs``: their payloads carry their own decode
bucket (``_bucket``), anonymization map (``_var``) and ingest stamps
(``_ingest``, each request's ``RequestRecord.ingest``).

Disaggregated tiers (``cfg.serve_tiers="prefill-pool"``, serve/disagg.py):
a pool of prefill worker processes computes each request's prefill
artifacts and seeds every replica's prefix cache; the loop ticks the tier
(``service``) each round before admission and holds a request the tier
owns in the queue until its artifacts land and it admits as a cache hit,
so the decode replica dispatches no prefill. With nothing dispatchable
and only the tier holding work, the loop waits on the workers' pipes
(``idle_wait``) instead of spinning. Every request's record carries the
tier's stamps (``prefill_queue_s``, ``transport_s``, ``artifact_bytes``)
and the summary the tier's meters (``tiers``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from fira_tpu_torch.analysis import sanitizer
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import buckets as buckets_lib
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder
from fira_tpu_torch.decode import paging
from fira_tpu_torch.decode.engine import SlotEngine
from fira_tpu_torch.decode.runner import output_name, sample_emitter
from fira_tpu_torch.decode.stream import OrderedStreamWriter
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import faults as faults_lib
from fira_tpu_torch.robust import recovery as recovery_lib
from fira_tpu_torch.robust.watchdog import WatchdogTimeout, run_with_watchdog
from fira_tpu_torch.serve import disagg as disagg_lib

# the partial metrics snapshot refreshes every this many rounds (and once
# at the start and once on an abort), so a kill leaves a recent, valid one
SNAPSHOT_EVERY_ROUNDS = 16

# the longest a serve waits for its prefill tier's workers to start
# before it takes arrivals
TIER_START_S = 300.0

# with the cache serving hits, a partial miss group waits (back at the
# queue head) until it fills, its head has waited this many step rounds,
# or the engine would otherwise idle: misses pack into fuller prefill
# batches. Cache off: never holds
MISS_HOLD_ROUNDS = 16

def serve_errors(cfg: FiraConfig, *, trace: bool = False) -> List[str]:
    """Named-knob serving checks (CLI exit 2), in the JAX package's words.
    ``trace``: an arrival-trace file was given (the rate is then unused)."""
    errs: List[str] = []
    if cfg.serve_rate < 0:
        errs.append(f"serve_rate {cfg.serve_rate} must be >= 0 requests/s")
    elif not trace and cfg.serve_rate == 0:
        errs.append(
            "serve_rate must be > 0 requests/s when no arrival trace is "
            "given (the open-loop Poisson generator needs an offered rate)")
    slots, _reps = paging.resolved_slots(cfg)
    if not 1 <= cfg.serve_prefill_budget <= slots:
        errs.append(
            f"serve_prefill_budget {cfg.serve_prefill_budget} must be >= 1 "
            f"and <= the per-replica engine slots ({slots}): it caps "
            f"prefill dispatches interleaved between step dispatches, and "
            f"a budget past the slot count can never seat more rows")
    if cfg.serve_deadline_steps < 0:
        errs.append(
            f"serve_deadline_steps {cfg.serve_deadline_steps} must be 0 "
            f"(no deadline) or >= 1: a request cannot complete in less "
            f"than one step dispatch")
    if cfg.serve_queue_cap < 0:
        errs.append(
            f"serve_queue_cap {cfg.serve_queue_cap} must be 0 (unbounded) "
            f"or >= 1 queued request")
    return errs


# --------------------------------------------------------------------------
# clocks
# --------------------------------------------------------------------------

class VirtualClock:
    """Deterministic replay clock: one second a prefill or step dispatch,
    idle gaps jumped. A replayed trace's schedule, and with it its
    latency records, is a function of the trace and the knobs."""

    def __init__(self):
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        self._now = max(self._now, float(t))

    def on_prefill(self) -> None:
        self._now += 1.0

    def on_step(self) -> None:
        self._now += 1.0


class WallClock:
    """Real time: arrivals are paced against the monotonic clock and an
    idle server sleeps until the next arrival (open loop: the generator
    never waits for the server)."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance_to(self, t: float) -> None:
        dt = float(t) - self.now()
        if dt > 0:
            time.sleep(dt)

    def on_prefill(self) -> None:
        pass

    def on_step(self) -> None:
        pass


# --------------------------------------------------------------------------
# per-request metering
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle stamps (clock units: wall seconds or
    virtual units), each observed at a dispatch or harvest boundary. The
    JAX package's fields; ``ingest`` holds a raw-diff request's ingest
    stamps. The prefill tier's (serve/disagg.py; None without it): wall
    seconds from the tier's first sight of the request to its submission
    to a worker (``prefill_queue_s``), from submission to the
    checksum-verified delivery (``transport_s``, the worker's prefill
    included), and the delivered artifact's host bytes."""

    position: int            # split-local sample position
    arrival_t: float         # scheduled (open-loop) arrival time
    status: str = "pending"  # queued|staged|seated|done|shed_queue_full|
                             # shed_deadline|shed_error
    arrival_round: int = -1  # step-dispatch counter at arrival
    admit_t: float = math.nan       # prefill dispatched (chunk staged)
    seat_t: float = math.nan        # inserted into a slot
    first_step_t: float = math.nan  # end of its first step dispatch's
                                    # harvest: the TTFT stamp
    done_t: float = math.nan        # harvested (all beams settled)
    done_round: int = -1
    deadline_missed: bool = False   # completed, but past its deadline
    error: Optional[str] = None     # the recorded failure (shed_error)
    retries: int = 0                # assembly/admission/prefill retries
    requeues: int = 0               # times handed back by a retirement
    coalesced_into: Optional[int] = None  # the leader it was delivered
    #                                       with (in-flight dedup)
    ingest: Optional[Dict] = None
    prefill_queue_s: Optional[float] = None
    transport_s: Optional[float] = None
    artifact_bytes: Optional[int] = None

    @property
    def queue_wait_s(self) -> float:
        return self.seat_t - self.arrival_t

    @property
    def ttft_s(self) -> float:
        return self.first_step_t - self.arrival_t

    @property
    def e2e_s(self) -> float:
        return self.done_t - self.arrival_t


def _pct(values: List[float], q: float) -> Optional[float]:
    return round(float(np.percentile(np.asarray(values), q)), 6) \
        if values else None


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving accounting: the request records and the
    scheduler's counters, with the JAX package's fields. The health
    record (the alive trace, heartbeats, respawns) is kept whether
    recovery is armed or not."""

    records: List[RequestRecord]
    completions: List[int] = dataclasses.field(default_factory=list)
    rounds: int = 0
    admits: int = 0                 # prefill batches formed from arrivals
    max_admits_per_round: int = 0   # <= serve_prefill_budget
    peak_queue_depth: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    shed_error: int = 0
    retirements: List[Dict] = dataclasses.field(default_factory=list)
    requeues: int = 0
    # one entry a change in the live set (start, retirement, respawn), and
    # each replica's last dispatch round and rounds served
    replicas_alive_over_time: List[Dict] = dataclasses.field(
        default_factory=list)
    respawns: List[Dict] = dataclasses.field(default_factory=list)
    heartbeats: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # rounds admission paused with every replica down and respawn budget
    # left, and the positions a resume recovered from the journaled run
    admission_paused_rounds: int = 0
    resumed: int = 0
    # in-flight dedup: requests coalesced onto a leader, groups delivered,
    # the largest group (leader + followers)
    dedup_coalesced: int = 0
    dedup_groups: int = 0
    dedup_fanout_max: int = 0
    # seconds the scheduler waited at arrival for a payload still on the
    # Feeder's workers, and the loop's real elapsed seconds
    assembly_stall_s: float = 0.0
    wall_s: float = 0.0
    # meters of raw-diff ingest (serve_diffs sets them) and of the
    # prefill tier (a zero-argument callable that serve_split binds to
    # the tier's end-of-run summary; None without the tier)
    ingest_cache: Optional[object] = None
    ingest_pipeline: Optional[tuple] = None
    tiers: Optional[object] = None

    def summary(self) -> Dict:
        done = [r for r in self.records if r.status == "done"]
        ttft = [r.ttft_s for r in done if not math.isnan(r.first_step_t)]
        e2e = [r.e2e_s for r in done]
        qw = [r.queue_wait_s for r in done]
        last_done = max((r.done_t for r in done), default=0.0)
        last_arr = max((r.arrival_t for r in self.records), default=0.0)
        n = len(self.records)
        return {
            "offered": n,
            "completed": len(done),
            "completion_order": list(self.completions),
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "shed_error": self.shed_error,
            "replica_retirements": len(self.retirements),
            "retired_replicas": [r["replica"] for r in self.retirements],
            "requeued_requests": self.requeues,
            "respawns": len(self.respawns),
            "respawned_replicas": [r["replica"] for r in self.respawns],
            "spare_attaches": sum(1 for r in self.respawns if r["spare"]),
            "replicas_alive_over_time": list(self.replicas_alive_over_time),
            "heartbeats": {t: dict(h)
                           for t, h in sorted(self.heartbeats.items())},
            "admission_paused_rounds": self.admission_paused_rounds,
            "resumed": self.resumed,
            "request_retries": sum(r.retries for r in self.records),
            "deadline_missed": sum(r.deadline_missed for r in done),
            "dedup_coalesced": self.dedup_coalesced,
            "dedup_groups": self.dedup_groups,
            "dedup_fanout_max": self.dedup_fanout_max,
            "rounds": self.rounds,
            "admits": self.admits,
            "max_admits_per_round": self.max_admits_per_round,
            "peak_queue_depth": self.peak_queue_depth,
            "offered_rate_rps": round(n / last_arr, 4) if last_arr else None,
            "makespan_s": round(last_done, 6),
            "throughput_rps": round(len(done) / last_done, 4)
            if last_done else None,
            "p50_ttft_s": _pct(ttft, 50), "p99_ttft_s": _pct(ttft, 99),
            "p50_e2e_s": _pct(e2e, 50), "p99_e2e_s": _pct(e2e, 99),
            "mean_e2e_s": round(float(np.mean(e2e)), 6) if e2e else None,
            "p50_queue_wait_s": _pct(qw, 50), "p99_queue_wait_s": _pct(qw, 99),
            **self._ingest_summary(),
            **({"tiers": dict(self.tiers()
                              if callable(self.tiers) else self.tiers)}
               if self.tiers is not None else {}),
        }

    def _ingest_summary(self) -> Dict:
        """The raw-diff ingest aggregates, present only when a request ran
        ingest (``RequestRecord.ingest``, ``serve_diffs``), as in the JAX
        package."""
        ing = [r.ingest for r in self.records if r.ingest]
        if not ing:
            return {}
        stage = {s: [i[s] for i in ing if s in i]
                 for s in ("lex_s", "parse_s", "assemble_s")}
        totals = [sum(i.get(s, 0.0) for s in
                      ("lex_s", "parse_s", "assemble_s")) for i in ing]
        out = {"requests_ingested": len(ing),
               "truncated": sum(1 for i in ing if i.get("truncated")),
               "degraded": sum(1 for i in ing if i.get("degraded")),
               "oov_word_fallbacks": sum(int(i.get("oov_words", 0))
                                         for i in ing),
               "oov_ast_fallbacks": sum(int(i.get("oov_ast", 0))
                                        for i in ing),
               "cache_hits": sum(1 for i in ing if i.get("cached")),
               "memo_hits": sum(int(i.get("memo_hits", 0)) for i in ing),
               "memo_misses": sum(int(i.get("memo_misses", 0))
                                  for i in ing)}
        if self.ingest_cache is not None:
            out["cache"] = dict(self.ingest_cache()
                                if callable(self.ingest_cache)
                                else self.ingest_cache)
        if self.ingest_pipeline is not None:
            out["workers"], out["pipeline_depth"] = self.ingest_pipeline
        for s, vals in stage.items():
            out[f"mean_{s}"] = (round(float(np.mean(vals)), 9)
                                if vals else None)
        out["p50_total_s"] = _pct(totals, 50)
        out["p99_total_s"] = _pct(totals, 99)
        # the scheduler's wait for payloads at arrival, and its share of
        # the run's real wall time
        out["stall_s"] = round(self.assembly_stall_s, 6)
        out["stall_frac"] = (round(self.assembly_stall_s / self.wall_s, 4)
                             if self.wall_s else None)
        return {"ingest": out}


@dataclasses.dataclass
class _Queued:
    record: RequestRecord
    host: Dict      # the request's single-row assembled batch
    bucket: int     # decode-table index (0 when unbucketed)
    digest: Optional[str] = None  # content digest (cfg.prefix_cache)


# --------------------------------------------------------------------------
# the serving loop
# --------------------------------------------------------------------------

class ServeLoop:
    """Drives N engine replicas under arrival-timed admission. ``emit`` /
    ``shed`` are callbacks into the output layer (serve_split wires them
    to the ordered writer). ``positions``: each request's output position
    (identity when None; a resume serves a sparse suffix). ``journal``: a
    ``recovery.Journal`` (None = off); ``recovery``: a
    ``recovery.RecoveryManager`` (None = retire and degrade); ``tier``: a
    ``disagg.PrefillTier`` (None = prefill in process)."""

    def __init__(self, engines: Sequence[SlotEngine], cfg: FiraConfig, *,
                 arrival_times: np.ndarray, feed, table, assignment,
                 templates: Dict[int, Dict], clock, emit, shed,
                 faults=None, snapshot=None, positions=None, journal=None,
                 recovery=None, tier=None):
        self.engines = list(engines)
        self.cfg = cfg
        self.clock = clock
        self.emit = emit
        self.shed_cb = shed
        self._table = table
        self._assignment = assignment
        self._templates = templates
        self._bs = int(cfg.test_batch_size)
        self._budget = max(1, int(cfg.serve_prefill_budget))
        self._deadline = max(0, int(cfg.serve_deadline_steps))
        self._cap = max(0, int(cfg.serve_queue_cap))
        # degradation: the poison-request retry budget, the per-dispatch
        # watchdog (0 = off), the armed injector (None = off) and the
        # partial-metrics snapshot hook
        self._retries = max(0, int(cfg.robust_retries))
        self._watchdog = float(cfg.dispatch_watchdog_s)
        self._faults = faults
        self._snapshot = snapshot
        self._times = np.asarray(arrival_times, dtype=np.float64)
        self._feed_iter = iter(feed)
        self._arr_idx = 0
        self._rr = 0   # the replica admission starts from this round
        self._queue: "collections.deque[_Queued]" = collections.deque()
        # in-flight dedup (cfg.prefix_cache): digest -> leader position of
        # every non-final queued request, its reverse, leader -> coalesced
        # followers, and followers promoted when their leader shed
        self._dedup_on = bool(cfg.prefix_cache)
        self._leaders: Dict[str, int] = {}
        self._leader_digest: Dict[int, str] = {}
        self._followers: Dict[int, List[_Queued]] = {}
        self._promoted: List[_Queued] = []
        # single-row payloads of every taken, unfinished request, by
        # position: what a retirement hands back to the queue
        self._payloads: Dict[int, _Queued] = {}
        self._awaiting_first_step: List[RequestRecord] = []
        self._final = 0
        # each request's output position: a resume serves the unfinished
        # suffix of a run at its original positions, so every
        # position-keyed lookup goes through _rec_by_pos
        pos_arr = (np.asarray(positions, dtype=np.int64)
                   if positions is not None
                   else np.arange(len(self._times), dtype=np.int64))
        self.stats = ServeStats(records=[
            RequestRecord(position=int(p), arrival_t=float(t))
            for p, t in zip(pos_arr, self._times)])
        self._rec_by_pos: Dict[int, RequestRecord] = {
            r.position: r for r in self.stats.records}
        self._journal = journal
        self._recovery = recovery
        # the disaggregated prefill tier: the queue walk holds the misses
        # it owns until their artifacts land (never a decode-side prefill)
        self._tier = tier
        self._shed_log: List[Dict] = []   # a round's shed records
        self._alive_changed()

    # --- pieces ---------------------------------------------------------

    def _bucket_of(self, i: int, item) -> int:
        """A request's decode bucket: the split's assignment for corpus
        requests, the worker-stamped ``_bucket`` of a raw-diff request
        (assigned by its measured extents, ingest/service.py), 0 when
        unbucketed."""
        if self._assignment is not None:
            # firacheck: allow[HOST-SYNC] host numpy bucket-assignment array — bucket lookup is pure host-side planning
            return int(self._assignment[i])
        if item.host is not None and "_bucket" in item.host:
            # firacheck: allow[HOST-SYNC] _bucket is a host int the feeder stamps on the host batch; no device value exists here
            return int(item.host["_bucket"])
        return 0

    def _poll_arrivals(self, now: float) -> None:
        """Move every due request into the admission queue. An arrival is
        shed on the spot when the queue is full, when its payload arrived
        poisoned (assembly failed after the Feeder's retries: recorded,
        never re-raised), or when the serve.admit fault site rejects it
        past the retry budget."""
        while self._arr_idx < len(self._times) \
                and self._times[self._arr_idx] <= now:
            item = next(self._feed_iter)   # pre-assembled, split order
            i = self._arr_idx
            rec = self.stats.records[i]
            rec.arrival_round = self.stats.rounds
            # firacheck: allow[HOST-SYNC] FedBatch.retries is a host int counter stamped by the feeder worker; no device value exists here
            rec.retries += int(item.retries)
            if item.host is not None:
                rec.ingest = item.host.get("_ingest")
            # firacheck: allow[HOST-SYNC] FedBatch.stall_s is a host perf_counter float stamped by the feeder; no device value exists here
            self.stats.assembly_stall_s += float(item.stall_s)
            digest = None
            if self._dedup_on and item.host is not None:
                dl = item.host.get("_digests")
                digest = dl[0] if dl else None
            if item.error is not None:
                # poison-request quarantine: shed with the error recorded;
                # its output position holds an empty line
                rec.error = str(item.error)
                self._shed(rec, "shed_error")
            elif digest is not None and digest in self._leaders:
                # in-flight dedup: coalesce onto the leader's seat. The
                # follower takes no seat, but its payload is host memory
                # held until the leader harvests, so the queue cap bounds
                # each group too
                leader = self._leaders[digest]
                if self._cap and len(self._followers.get(leader, [])) \
                        >= self._cap:
                    self._shed(rec, "shed_queue_full")
                else:
                    lrec = self._rec_by_pos[leader]
                    e = _Queued(rec, item.host, self._bucket_of(i, item),
                                digest=digest)
                    self._followers.setdefault(leader, []).append(e)
                    rec.coalesced_into = leader
                    rec.status = "queued"
                    if lrec.status in ("staged", "seated"):
                        # the leader's prefill (and seat) happened already:
                        # the follower takes those milestones now
                        rec.admit_t = now
                        rec.status = "staged"
                    if lrec.status == "seated":
                        rec.seat_t = now
                        rec.status = "seated"
                        self._awaiting_first_step.append(rec)
                    self.stats.dedup_coalesced += 1
            elif self._cap and len(self._queue) >= self._cap:
                self._shed(rec, "shed_queue_full")
            elif not self._admit_gate(rec):
                pass  # serve.admit fault past the retry budget: shed inside
            else:
                rec.status = "queued"
                if digest is not None:
                    self._leaders[digest] = rec.position
                    self._leader_digest[rec.position] = digest
                self._queue.append(_Queued(rec, item.host,
                                           self._bucket_of(i, item),
                                           digest=digest))
            self._arr_idx += 1
        self.stats.peak_queue_depth = max(self.stats.peak_queue_depth,
                                          len(self._queue))

    def _backoff(self, attempt: int) -> None:
        """Quarantine retry backoff: a real sleep on the wall clock only (a
        virtual replay draws every retry afresh and needs no wait)."""
        if isinstance(self.clock, WallClock):
            # firacheck: allow[SCHED-BLOCK] wall-clock serves only (the branch above): a feeder-retry backoff on the shared docs/FAULTS.md curve, bounded per attempt; virtual replays draw every retry afresh and never sleep
            time.sleep(faults_lib.backoff_s(attempt))

    def _admit_gate(self, rec: RequestRecord) -> bool:
        """The serve.admit fault site under the retry policy: a transient
        fault is absorbed by the retry budget, a persistent one sheds the
        request with its error recorded."""
        if self._faults is None or not self._faults.armed("serve.admit"):
            return True
        attempt = 0
        while True:
            try:
                self._faults.check("serve.admit")
                return True
            except Exception as e:
                if attempt < self._retries:
                    attempt += 1
                    rec.retries += 1
                    self._backoff(attempt)
                    continue
                rec.error = (f"admission rejected after {attempt + 1} "
                             f"attempt(s): {e}")
                self._shed(rec, "shed_error")
                return False

    def _shed(self, rec: RequestRecord, status: str) -> None:
        rec.status = status
        if status == "shed_queue_full":
            self.stats.shed_queue_full += 1
        elif status == "shed_deadline":
            self.stats.shed_deadline += 1
        else:
            self.stats.shed_error += 1
        self._final += 1
        self._payloads.pop(rec.position, None)
        # a shed follower detaches; the leader's seat is untouched
        if rec.coalesced_into is not None:
            fl = self._followers.get(rec.coalesced_into)
            if fl:
                self._followers[rec.coalesced_into] = [
                    e for e in fl if e.record is not rec]
        # a shed leader hands its group to the oldest surviving follower,
        # who re-enters the queue (through _drain_promotions, never in the
        # middle of a walk of it) with its own stamps and payload
        d = self._leader_digest.pop(rec.position, None)
        if d is not None:
            self._leaders.pop(d, None)
            fl = self._followers.pop(rec.position, [])
            if fl:
                head, rest = fl[0], fl[1:]
                head.record.coalesced_into = None
                self._leaders[d] = head.record.position
                self._leader_digest[head.record.position] = d
                for e in rest:
                    e.record.coalesced_into = head.record.position
                if rest:
                    self._followers[head.record.position] = rest
                self._promoted.append(head)
        self.shed_cb(rec)
        # the journal's record after the writer took the empty line, kept
        # for the round's one fsync (a mass shed costs one, not one each)
        if self._journal is not None:
            self._shed_log.append({"kind": "shed", "pos": rec.position,
                                   "status": status, "error": rec.error})

    def _drain_promotions(self) -> None:
        """Queue followers promoted by a leader's shed. A promotee whose
        own deadline lapsed is shed here, which may promote the next; the
        loop runs until the chain settles."""
        while self._promoted:
            e = self._promoted.pop(0)
            rec = e.record
            if self._deadline and (self.stats.rounds - rec.arrival_round
                                   >= self._deadline):
                self._shed(rec, "shed_deadline")
                continue
            rec.status = "queued"
            rec.admit_t = rec.seat_t = rec.first_step_t = math.nan
            self._queue.append(e)

    def _shed_deadlines(self) -> None:
        """Drop queued requests whose whole deadline elapsed unseated.
        Followers of a leader not yet seated are held to their own
        deadlines (they detach; the leader lives); once the leader is
        seated the group rides to harvest."""
        if not self._deadline:
            return
        keep: "collections.deque[_Queued]" = collections.deque()
        for e in self._queue:
            if self.stats.rounds - e.record.arrival_round >= self._deadline:
                self._shed(e.record, "shed_deadline")
            else:
                keep.append(e)
        self._queue = keep
        self._drain_promotions()
        for leader, fl in list(self._followers.items()):
            lrec = self._rec_by_pos[leader]
            if lrec.status not in ("queued", "staged"):
                continue
            for e in list(fl):
                if (self.stats.rounds - e.record.arrival_round
                        >= self._deadline):
                    self._shed(e.record, "shed_deadline")
        self._drain_promotions()

    def _take_chunk(self, eng: SlotEngine):
        """Same-bucket requests off the queue head, arrival order kept for
        the taken and the left; returns (bucket, groups). Cache off: one
        group of up to ``test_batch_size``. Cache on: the walk splits into
        a hit group (artifacts in the engine's cache: admitted with no
        prefill) and a miss group, each up to a full batch, so repeats
        cannot fragment the misses' prefill batches."""
        bucket = self._queue[0].bucket
        hits: List[_Queued] = []
        misses: List[_Queued] = []
        rest: "collections.deque[_Queued]" = collections.deque()
        probe = self._dedup_on
        while self._queue and len(hits) < self._bs \
                and len(misses) < self._bs:
            e = self._queue.popleft()
            if e.bucket != bucket:
                rest.append(e)
                continue
            if probe and eng.cache_contains(e.digest):
                hits.append(e)
            elif self._tier is not None and self._tier.holds(e.digest):
                # the prefill tier owns this miss: it stays queued until
                # its artifacts land and it walks again as a hit; a dead
                # tier or a digest it gave up flips holds() to False
                rest.append(e)
            else:
                misses.append(e)
        held: List[_Queued] = []
        if probe and 0 < len(misses) < self._bs:
            # a partial miss group waits at the queue head to pack with
            # later misses, bounded by MISS_HOLD_ROUNDS and by the engine
            # having other work (rounds advance only while work is in
            # flight, so the hold cannot deadlock)
            busy = eng.in_flight() > 0 or eng.staged_rows > 0
            # firacheck: allow[HOST-SYNC] hits is the host list of prefix-cache hits; no device value exists here
            warm = bool(hits) or eng.stats.cache_hits > 0
            head_wait = self.stats.rounds - min(
                e.record.arrival_round for e in misses)
            if busy and warm and head_wait < MISS_HOLD_ROUNDS:
                held, misses = misses, []
        rest.extend(self._queue)
        self._queue = rest
        for e in reversed(held):
            self._queue.appendleft(e)
        for e in hits + misses:
            # kept until the request finishes: what a retirement requeues
            self._payloads[e.record.position] = e
        return bucket, [g for g in (hits, misses) if g]

    def _form_batch(self, bucket: int, take: List[_Queued]) -> Dict:
        """Pack the taken requests' rows into one batch at the bucket's
        geometry (pad rows from the all-pad template): a drain batch whose
        members the server chose."""
        tmpl = self._templates[bucket]
        # firacheck: allow[HOST-SYNC] host-side wire assembly from the host template; no device value exists here
        batch = {k: np.array(v) for k, v in tmpl.items()}
        positions = np.full(self._bs, -1, dtype=np.int64)
        for j, e in enumerate(take):
            for k in batch:
                batch[k][j] = e.host[k][0]
            positions[j] = e.record.position
        batch["_positions"] = positions
        if self._table is not None:
            batch["_tag"] = buckets_lib.geom_tag(self._table[bucket])
        if any(e.host is not None and "_var" in e.host for e in take):
            # raw-diff requests' own anonymization maps, a host-only
            # column the emitter de-anonymizes each row's output with
            vm = [(e.host.get("_var") or [None])[0] if e.host else None
                  for e in take]
            batch["_var"] = vm + [None] * (self._bs - len(take))
        if self._dedup_on:
            # the worker-stamped digests, so the engine never re-hashes
            batch["_digests"] = ([e.digest for e in take]
                                 + [None] * (self._bs - len(take)))
        return batch

    def _prefill_quarantined(self, eng: SlotEngine, batch: Dict,
                             take: List[_Queued]) -> Optional[bool]:
        """One prefill under the quarantine policy: a raise is the
        request's problem (retried with backoff, each attempt a fresh
        draw, then the chunk is shed with its error); a watchdog expiry is
        the engine's (retired, the chunk handed back). Returns True
        (staged), False (chunk shed) or None (engine retired)."""
        attempt = 0
        while True:
            try:
                run_with_watchdog(lambda: eng.admit(batch, 0),
                                  self._watchdog,
                                  label=f"serve_prefill[{eng.tag or 'r0'}]")
                return True
            except WatchdogTimeout as e:
                self._retire_replica(eng, e, requeue=take)
                return None
            except Exception as e:
                if attempt < self._retries:
                    attempt += 1
                    for el in take:
                        el.record.retries += 1
                    self._backoff(attempt)
                    continue
                for el in take:
                    el.record.error = (f"prefill failed after "
                                       f"{attempt + 1} attempt(s): {e}")
                    self._shed(el.record, "shed_error")
                return False

    def _retire_replica(self, eng: SlotEngine, err: BaseException, *,
                        requeue: Optional[List[_Queued]] = None) -> None:
        """Retire one replica (a dispatch raised or outlived the watchdog):
        drop it from the rotation and put every request it owed (seated,
        staged, and the caller's unstaged ``requeue`` chunk) back at the
        queue's front in position order, stamps reset to queued (the
        deadline clock does not reset). Its heartbeat goes cold and, with
        recovery armed, its lineage's backoff starts."""
        if eng not in self.engines:
            return
        owed = set(eng.pending_positions())
        eng.retire()
        self.engines.remove(eng)
        self.stats.retirements.append(
            {"replica": eng.tag or "r0",
             "error": f"{type(err).__name__}: {err}"})
        hb = self.stats.heartbeats.get(eng.tag or "r0")
        if hb is not None:
            hb["alive"] = False
        if self._recovery is not None:
            self._recovery.note_retirement(
                eng, self.stats.rounds,
                error=f"{type(err).__name__}: {err}")
        self._alive_changed()
        entries: List[_Queued] = []
        seen: set = set()
        for pos in owed:
            e = self._payloads.get(pos)
            if e is not None and pos not in seen:
                seen.add(pos)
                entries.append(e)
        for e in (requeue or []):
            if e.record.position not in seen:
                seen.add(e.record.position)
                entries.append(e)
        entries.sort(key=lambda e: e.record.position)
        for e in entries:
            rec = e.record
            rec.requeues += 1
            rec.status = "queued"
            rec.admit_t = rec.seat_t = rec.first_step_t = math.nan
            # a requeued leader takes its followers back to queued
            for f in self._followers.get(rec.position, []):
                f.record.status = "queued"
                f.record.admit_t = f.record.seat_t = math.nan
                f.record.first_step_t = math.nan
        self.stats.requeues += len(entries)
        for e in reversed(entries):
            self._queue.appendleft(e)
        self._awaiting_first_step = [
            r for r in self._awaiting_first_step if r.status == "seated"]
        self._rr = self._rr % len(self.engines) if self.engines else 0

    def _shed_all_remaining(self, reason: str) -> None:
        """No live engine: every request not yet final is shed with the
        reason recorded; the run ends with a position-complete output file
        and honest metrics, never a hang."""
        while self._queue or self._promoted:
            e = (self._promoted.pop(0) if self._promoted
                 else self._queue.popleft())
            e.record.error = e.record.error or reason
            self._shed(e.record, "shed_error")
        # followers whose leader is neither queued nor promoted
        for _leader, fl in list(self._followers.items()):
            for e in list(fl):
                if e.record.status not in _TERMINAL_STATUSES:
                    e.record.error = e.record.error or reason
                    self._shed(e.record, "shed_error")
        self._followers.clear()
        while self._arr_idx < len(self._times):
            item = next(self._feed_iter)
            rec = self.stats.records[self._arr_idx]
            # firacheck: allow[HOST-SYNC] FedBatch.retries is a host int counter stamped by the feeder worker; no device value exists here
            rec.retries += int(item.retries)
            if item.host is not None:
                rec.ingest = item.host.get("_ingest")
            rec.error = rec.error or (str(item.error) if item.error
                                      else reason)
            self._shed(rec, "shed_error")
            self._arr_idx += 1

    def _admit(self) -> None:
        """Budgeted admission over the replicas: at most
        ``serve_prefill_budget`` prefill dispatches a replica between step
        dispatches; a cache-served or fully coalesced admission runs no
        prefill and is not charged. The starting replica rotates each
        round, so a lightly loaded fleet spreads its admissions."""
        admitted = 0
        admitted_pos: List[int] = []
        order = (self.engines[self._rr:] + self.engines[:self._rr])
        self._rr = (self._rr + 1) % len(self.engines) if self.engines else 0
        for eng in order:
            if eng not in self.engines:
                continue  # retired earlier this round
            n = 0
            retired = False
            while n < self._budget and self._queue and eng.wants_input():
                bucket, groups = self._take_chunk(eng)
                if not groups:
                    break  # a held miss group
                for gi, group in enumerate(groups):
                    before = eng.stats.prefills
                    staged = self._prefill_quarantined(
                        eng, self._form_batch(bucket, group), group)
                    if staged is None:
                        retired = True
                        # groups taken but not yet dispatched go back too
                        for g in reversed(groups[gi + 1:]):
                            for e in reversed(g):
                                self._queue.appendleft(e)
                        break
                    if not staged:
                        self._drain_promotions()
                        continue
                    # the clock and the budget charge a prefill dispatch
                    if eng.stats.prefills > before:
                        self.clock.on_prefill()
                        n += 1
                    t = self.clock.now()
                    for e in group:
                        e.record.admit_t = t
                        e.record.status = "staged"
                        admitted_pos.append(e.record.position)
                        for f in self._followers.get(e.record.position, []):
                            f.record.admit_t = t
                            f.record.status = "staged"
                            admitted_pos.append(f.record.position)
                if retired:
                    break
            admitted += n
            if eng not in self.engines:
                continue
            try:
                run_with_watchdog(eng.refill,
                                  self._watchdog,
                                  label=f"serve_refill[{eng.tag or 'r0'}]")
            except Exception as e:
                self._retire_replica(eng, e)
        if self._journal is not None and admitted_pos:
            # one admit record a request, one fsync a round
            self._journal.admit(admitted_pos)
        self.stats.admits += admitted
        self.stats.max_admits_per_round = max(
            self.stats.max_admits_per_round, admitted)
        t = self.clock.now()
        for eng in self.engines:
            for pid in eng.in_flight_positions():
                rec = self._rec_by_pos[pid]
                if math.isnan(rec.seat_t):
                    rec.seat_t = t
                    rec.status = "seated"
                    self._awaiting_first_step.append(rec)
                    # a seated leader seats its whole group
                    for f in self._followers.get(pid, []):
                        if math.isnan(f.record.seat_t):
                            f.record.seat_t = t
                            f.record.status = "seated"
                            self._awaiting_first_step.append(f.record)

    # --- health signals ---------------------------------------------------

    def _deadline_pressure(self) -> float:
        """Share of queued requests past half their deadline (0.0 with no
        deadline or an empty queue)."""
        if not self._deadline or not self._queue:
            return 0.0
        tight = sum(1 for e in self._queue
                    if self.stats.rounds - e.record.arrival_round
                    >= self._deadline / 2)
        return round(tight / len(self._queue), 4)

    def _alive_changed(self) -> None:
        """One entry of the alive trace: at the start, at a retirement and
        at a respawn (the capacity-over-time curve)."""
        self.stats.replicas_alive_over_time.append({
            "round": self.stats.rounds,
            "alive": len(self.engines),
            "queue_depth": len(self._queue),
            "deadline_pressure": self._deadline_pressure(),
        })

    def _stamp_heartbeats(self) -> None:
        """Each live replica's last dispatch round and rounds served (a
        retired replica's goes cold)."""
        for eng in self.engines:
            hb = self.stats.heartbeats.setdefault(
                eng.tag or "r0",
                {"last_dispatch_round": -1, "rounds": 0, "alive": True})
            hb["last_dispatch_round"] = self.stats.rounds
            hb["rounds"] += 1
            hb["alive"] = True

    def _flush_shed_log(self) -> None:
        """The round's shed records, in one journal write and fsync."""
        if self._journal is not None and self._shed_log:
            self._journal.append_many(self._shed_log)
            self._shed_log = []

    def _heal(self) -> None:
        """Respawn every dead lineage whose backoff elapsed and whose
        budget is not spent: the replacement (a warm spare or a fresh
        build, ``EngineFleet.replace_slot``) joins the rotation and
        admits from next round; recorded in ``stats.respawns`` and the
        alive trace."""
        if self._recovery is None:
            return
        for slot in self._recovery.due(self.stats.rounds):
            attempt = slot.respawns + 1
            eng, from_spare = self._recovery.respawn(slot,
                                                     self.stats.rounds)
            if eng is None:
                continue   # the build failed: budget spent, backoff anew
            eng.begin_stream()
            self.engines.append(eng)
            self.stats.respawns.append({
                "replica": eng.tag or "r0", "origin": slot.origin,
                "round": self.stats.rounds, "attempt": attempt,
                "spare": from_spare})
            self._alive_changed()

    # --- the loop -------------------------------------------------------

    def run(self) -> ServeStats:
        # firacheck: allow[WALL-CLOCK] ServeStats.wall_s is DEFINED as real elapsed seconds (the stall-fraction denominator must be wall over wall); it never feeds the scheduling clock
        t0 = time.perf_counter()
        n = len(self._times)
        for eng in self.engines:
            # fresh scheduling state for this stream (a warm engine may
            # have served another)
            eng.begin_stream()
        if self._snapshot is not None:
            self._snapshot(self)   # a valid partial artifact from the start
        while self._final < n:
            self._heal()
            if not self.engines:
                if (self._recovery is not None
                        and self._recovery.can_recover()):
                    # every replica lost, respawn budget left: admission
                    # pauses (nothing dispatches) while arrivals queue and
                    # deadlines tick; the budget is finite, so a
                    # replacement attaches or can_recover turns False
                    self._poll_arrivals(self.clock.now())
                    self._shed_deadlines()
                    self._flush_shed_log()
                    self.stats.admission_paused_rounds += 1
                    if isinstance(self.clock, WallClock):
                        # the respawn gate is wall time there, and rounds
                        # are step dispatches: wait a beat, no spin
                        # firacheck: allow[SCHED-BLOCK] bounded 10ms beat on the ALL-REPLICAS-LOST pause branch: nothing can dispatch, arrivals are polled each beat, and the alternative is a busy-spin
                        time.sleep(0.01)
                    else:
                        # virtual: the round clock is the backoff gate
                        self.clock.on_step()
                        self.stats.rounds += 1
                    continue
                # no replica and no budget: shed the rest with the reason
                last = (self.stats.retirements[-1]["error"]
                        if self.stats.retirements else "unknown")
                self._shed_all_remaining(
                    f"no live replicas (all retired; last error: {last})")
                self._flush_shed_log()
                break
            self._poll_arrivals(self.clock.now())
            if self._tier is not None:
                # the prefill tier's tick: sweep dead workers, seed the
                # delivered artifacts into every replica's cache, submit
                # fresh misses; host work only, before admission, so this
                # round can seat what just landed
                self._tier.service(self._queue, self.engines)
            self._shed_deadlines()
            self._admit()
            live = [e for e in self.engines if e.in_flight()]
            if not live:
                if self._queue or self._promoted \
                        or any(e.staged_rows for e in self.engines):
                    if self._tier is not None and not any(
                            e.staged_rows for e in self.engines):
                        # nothing dispatchable, the queue waits on the
                        # tier: block briefly on the workers' pipes
                        self._tier.idle_wait(0.05)
                    continue    # seats free up / budget admits next round
                if self._arr_idx < n:
                    # idle: jump (virtual) or sleep (wall) to the next
                    # arrival
                    self.clock.advance_to(self._times[self._arr_idx])
                    continue
                if self._final < n:   # pragma: no cover - loop invariant
                    raise RuntimeError(
                        "serve loop stalled with requests unaccounted for")
                break
            if self._dedup_on:
                # the seats serving a coalesced group, for the engine's
                # shared-block meter
                leaders = {p for p, fl in self._followers.items() if fl}
                for eng in live:
                    eng.shared_positions = leaders
            for eng in live:
                try:
                    if self._faults is not None:
                        self._faults.check("fleet.replica")
                    run_with_watchdog(eng.step_dispatch, self._watchdog,
                                      label=f"serve_step[{eng.tag or 'r0'}]")
                except Exception as e:
                    self._retire_replica(eng, e)
            self.clock.on_step()
            self.stats.rounds += 1
            self._stamp_heartbeats()
            items = []
            for eng in live:
                if eng.retired:
                    continue
                try:
                    items.extend(run_with_watchdog(
                        eng.harvest, self._watchdog,
                        label=f"serve_harvest[{eng.tag or 'r0'}]"))
                except Exception as e:
                    self._retire_replica(eng, e)
            t = self.clock.now()   # after the harvest: what the host sees
            for rec in self._awaiting_first_step:
                if rec.status == "seated":   # not requeued this round
                    rec.first_step_t = t
            self._awaiting_first_step = []
            done_now: List[int] = []
            for it in items:
                rec = self._rec_by_pos[it.position]
                rec.done_t = t
                rec.done_round = self.stats.rounds
                rec.status = "done"
                if self._deadline and (rec.done_round - rec.arrival_round
                                       > self._deadline):
                    rec.deadline_missed = True
                self._final += 1
                self._payloads.pop(it.position, None)
                self.stats.completions.append(it.position)
                done_now.append(it.position)
                self.emit(it.position, it.host, it.row, it.tokens, it.probs)
                # fan-out: the leader's beams are what each follower's own
                # decode would give (same digest, same payload), emitted at
                # the follower's position with its own stamps
                d = self._leader_digest.pop(it.position, None)
                if d is not None:
                    self._leaders.pop(d, None)
                group = self._followers.pop(it.position, [])
                if group:
                    self.stats.dedup_groups += 1
                    self.stats.dedup_fanout_max = max(
                        self.stats.dedup_fanout_max, 1 + len(group))
                for f in group:
                    fr = f.record
                    if math.isnan(fr.first_step_t):
                        # coalesced after the leader's first step: its
                        # first observable progress is this harvest
                        fr.first_step_t = t
                    fr.done_t = t
                    fr.done_round = self.stats.rounds
                    fr.status = "done"
                    if self._deadline and (fr.done_round - fr.arrival_round
                                           > self._deadline):
                        fr.deadline_missed = True
                    self._final += 1
                    self.stats.completions.append(fr.position)
                    done_now.append(fr.position)
                    self.emit(fr.position, f.host, 0, it.tokens, it.probs)
            if self._journal is not None and done_now:
                # after the writer took the lines (line-buffered, so on
                # disk): one done record a request, one fsync a round
                self._journal.done(done_now)
            self._flush_shed_log()
            if (self._snapshot is not None
                    and self.stats.rounds % SNAPSHOT_EVERY_ROUNDS == 0):
                self._snapshot(self)
        self._flush_shed_log()   # sheds after the last harvest
        # firacheck: allow[WALL-CLOCK] the wall_s meter's closing read — same real-wall stall-denominator contract as the t0 stamp above
        self.stats.wall_s = time.perf_counter() - t0
        return self.stats


# --------------------------------------------------------------------------
# the serving entry point (the twin of decode.runner.run_test)
# --------------------------------------------------------------------------

def make_clock(clock: str):
    """The clock of a serve run: ``wall`` or ``virtual``."""
    if clock == "wall":
        return WallClock()
    if clock == "virtual":
        return VirtualClock()
    raise ValueError(f"clock {clock!r} not in {{'wall', 'virtual'}}")


def build_engines(model: FiraModel, cfg: FiraConfig, *, engine=None,
                  faults=None, guard=None):
    """(owner, engines, built): the caller's (presumably warm) ``engine``
    (a ``SlotEngine``, or an ``EngineFleet`` served through its
    ``engines``), built False so its prewarm does not rerun; else an
    ``EngineFleet`` when ``cfg.engine_replicas`` > 1 or respawn is armed
    (``cfg.max_respawns`` > 0: respawn needs the fleet's ``replace_slot``
    and spare pool; a fleet of one writes the lone engine's bytes), or one
    new ``SlotEngine``."""
    if engine is not None:
        return engine, (getattr(engine, "engines", None) or [engine]), False
    n_rep = max(1, int(cfg.engine_replicas))
    if n_rep > 1 or cfg.max_respawns > 0:
        from fira_tpu_torch.parallel import fleet as fleet_lib

        owner = fleet_lib.EngineFleet(model, cfg, replicas=n_rep,
                                      faults=faults, guard=guard)
        return owner, owner.engines, True
    owner = SlotEngine(model, cfg, faults=faults, guard=guard)
    return owner, [owner], True


def prepare_templates(owner, split, cfg: FiraConfig, table, *,
                      prewarm: bool = True, guard=None) -> Dict[int, Dict]:
    """An all-pad batch a decode bucket (the rows a packed batch is padded
    from), and the engine's (each replica's) prewarm on them when
    serve_split built the engines itself (so no kernel builds or first
    launch inside a timed dispatch, and the watchdog never reads one as a
    hang). With a ``guard`` and a bucket table the prewarm is preceded by
    the family's declare."""
    from fira_tpu_torch.data.batching import make_batch

    bs = int(cfg.test_batch_size)
    if table is not None:
        templates = {b: make_batch(split, np.arange(0), cfg, batch_size=bs,
                                   geom=g)
                     for b, g in enumerate(table)}
    else:
        templates = {0: make_batch(split, np.arange(0), cfg,
                                   batch_size=bs)}
    if prewarm:
        warm = list(templates.values())
        if table is not None:
            if guard is not None:
                guard.declare(owner.labels(table))
            # each prefill's label carries its bucket's tag
            warm = [dict(templates[b], _tag=buckets_lib.geom_tag(g))
                    for b, g in enumerate(table)]
        owner.prewarm(warm)
    return templates


def run_loop_guarded(loop: "ServeLoop", snapshot) -> ServeStats:
    """Run the loop; on any failure the freshest partial metrics snapshot
    survives beside the ordered writer's ``.partial`` prefix."""
    try:
        return loop.run()
    except BaseException:
        if snapshot is not None:
            try:
                snapshot(loop)
            except Exception:
                pass
        raise


def finalize_serve_result(stats: ServeStats, owner, faults, *,
                          out_path: str, bleu_by_pos: Dict[int, float],
                          metrics_path: Optional[str]) -> Dict:
    """BLEU summed in split order, the result dict, and the final metrics
    artifact written atomically (its ``.partial`` removed)."""
    n_done = len(bleu_by_pos)
    total_bleu = sum(bleu_by_pos[p] for p in sorted(bleu_by_pos))
    result = {
        "sentence_bleu": total_bleu / max(n_done, 1),
        "n": float(n_done),
        "output_path": out_path,
        "serve": stats.summary(),
        "engine": owner.stats.summary(),
        **({"faults": faults.summary()} if faults else {}),
        "request_records": [dataclasses.asdict(r) for r in stats.records],
    }
    if metrics_path:
        write_metrics_atomic(metrics_path, {
            "serve": result["serve"],
            "engine": result["engine"],
            **({"faults": faults.summary()} if faults else {}),
            "request_records": _json_safe_records(stats.records),
        })
        if os.path.exists(metrics_path + ".partial"):
            os.remove(metrics_path + ".partial")
        result["metrics_path"] = metrics_path
    return result


def metrics_snapshotter(metrics_path: Optional[str], owner, faults):
    """The partial-metrics hook of ServeLoop (None without an artifact):
    ``<metrics_path>.partial``, rewritten atomically."""
    if not metrics_path:
        return None
    partial_path = metrics_path + ".partial"
    # a terminal record never changes: serialized once across snapshots
    done_cache: Dict[int, Dict] = {}

    def snapshot(loop):
        write_metrics_atomic(partial_path, {
            "in_progress": True,
            "serve": loop.stats.summary(),
            "engine": owner.stats.summary(),
            **({"faults": faults.summary()} if faults else {}),
            "request_records": _json_safe_records(loop.stats.records,
                                                  done_cache),
        })

    return snapshot


def _request_tasks(data, cfg: FiraConfig, n: int, table, assignment,
                   mix=None):
    """One single-row ``make_batch`` task a request, request order: the
    Feeder assembles payloads ahead of their arrival (an open-loop
    generator knows its requests up front). Each task's ``note`` names the
    request's sample and bucket, so a poisoned payload's error names them.

    ``mix``: request -> split position (identity when None): repeated
    entries are byte-identical requests at distinct output positions, the
    traffic the prefix cache and dedup exist for. With
    ``cfg.prefix_cache`` each task stamps its payload's digest on the
    worker (prefix_cache.stamp_digests), so the scheduler never hashes."""
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import task_note
    from fira_tpu_torch.decode.prefix_cache import stamp_digests
    from fira_tpu_torch.decode.quant import tier_namespace

    stamp = cfg.prefix_cache
    tier_ns = tier_namespace(cfg)
    for i in range(n):
        # firacheck: allow[HOST-SYNC] mix is a host request->sample index map; task generation is pure host-side planning
        j = int(mix[i]) if mix is not None else i
        # firacheck: allow[HOST-SYNC] host numpy bucket-assignment array — task generation is pure host-side planning
        geom = table[int(assignment[i])] if table is not None else None

        def task(j=j, geom=geom):
            # firacheck: allow[HOST-SYNC] np.asarray of a host int list builds the make_batch index chunk; no device value exists here
            b = make_batch(data, np.asarray([j]), cfg, batch_size=1,
                           geom=geom)
            return stamp_digests(b, tier_ns) if stamp else b
        task.note = task_note(
            [j], geom_tag=buckets_lib.geom_tag(geom) if geom else None,
            site="serve request")
        yield task


_TERMINAL_STATUSES = ("done", "shed_queue_full", "shed_deadline",
                      "shed_error")


def _json_safe_records(records: List[RequestRecord],
                       cache: Optional[Dict[int, Dict]] = None
                       ) -> List[Dict]:
    """Request-record dicts with NaN stamps (a shed request was never
    seated) as null: the metrics artifact is strict JSON. ``cache``:
    id(record) -> its dict, for records in a terminal status (they never
    change again), so each snapshot serializes only the active ones."""
    out = []
    for r in records:
        if cache is not None:
            hit = cache.get(id(r))
            if hit is not None:
                out.append(hit)
                continue
        d = dataclasses.asdict(r)
        d = {k: (None if isinstance(v, float) and v != v else v)
             for k, v in d.items()}
        if cache is not None and r.status in _TERMINAL_STATUSES:
            cache[id(r)] = d
        out.append(d)
    return out


def write_metrics_atomic(path: str, payload: Dict) -> str:
    """Write a metrics artifact atomically: the whole dump to ``path +
    ".tmp"``, flushed and fsynced, then one ``os.replace``, so a kill
    leaves the previous complete file or the new one, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, allow_nan=False)
        f.flush()
        # firacheck: allow[SCHED-BLOCK] the atomic-artifact crash contract REQUIRES the fsync before the rename (docs/FAULTS.md); it runs once per snapshot cadence (16 rounds), not per dispatch, and the cost is metered in the journal-overhead rows
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def serve_split(model: FiraModel, dataset: FiraDataset,
                cfg: Optional[FiraConfig] = None, *,
                arrival_times: np.ndarray,
                out_dir: str = "OUTPUT",
                ablation: Optional[str] = None,
                var_maps: Optional[List[Dict[str, str]]] = None,
                split: str = "test",
                clock: str = "wall",
                engine=None,
                metrics_path: Optional[str] = None,
                request_mix=None,
                journal_path: Optional[str] = None,
                resume: bool = False,
                tier=None, guard=None) -> Dict:
    """Serve the first ``len(arrival_times)`` samples of ``split`` as an
    open-loop request stream (request ``i`` is split position ``i``,
    arriving at ``arrival_times[i]``) on the model's device. Writes the
    drain decode's position-ordered output file (a shed request writes an
    empty line; with nothing shed the bytes are the drain's) and returns
    its metrics with ``serve`` (ServeStats.summary), ``engine`` (the
    engine's stats) and ``request_records``.

    ``engine``: an engine already built (and warmed) to serve on: a bench
    reuses one across rates, so the rows measure serving, not cold
    starts; the caller owns its config and its stats resets. The faults
    armed are ``cfg.inject_faults``'s. ``metrics_path``: the metrics
    artifact, kept through the run as an atomic ``<path>.partial``
    snapshot and written atomically at the end. ``request_mix``: request
    -> split position (identity when None), for repeated traffic.

    ``journal_path``: the request journal (robust/recovery.py) kept beside
    the output, which makes the run resumable after a kill. ``resume``:
    recover a killed run: its finished lines are read back from the
    ordered writer's crash pair, the journal's stream identity is checked
    (a mismatch raises ``recovery.ResumeError``), and only the rest is
    served; the final file is the uninterrupted run's. With
    ``cfg.max_respawns`` the engines are a fleet that respawns retired
    replicas (``cfg.engine_spares`` warm spares built up front).

    ``tier``: a started ``disagg.PrefillTier`` to serve with when
    ``cfg.serve_tiers`` is on (a bench reuses one across runs, as it does
    an engine, so the rows measure serving, not the pool's start); the
    caller owns it and closes it. Without one a tier is spawned here and
    closed on every exit path.

    ``guard``: an armed ``analysis.sanitizer.CompileGuard`` for the
    engines' dispatches (see ``decode.runner.run_test``). With the leak
    guard armed, the run ends with every paged-block grant released and
    every pipeline thread joined or sanctioned, or raises ``LeakError``
    naming the acquire site (on the success path only: a serve error
    surfaces as itself)."""
    cfg = cfg or dataset.cfg
    faults = faults_lib.injector_from(cfg)
    data = dataset.splits[split]
    vocab = dataset.word_vocab
    indices = dataset.split_indices[split]
    times = np.asarray(arrival_times, dtype=np.float64)
    n_req = len(times)
    mix = None
    if request_mix is not None:
        mix = np.asarray(request_mix, dtype=np.int64)
        if len(mix) != n_req:
            raise ValueError(
                f"request_mix has {len(mix)} entries for {n_req} arrivals")
        if len(mix) and (mix.min() < 0 or mix.max() >= len(data)):
            raise ValueError(
                f"request_mix references split position "
                f"{int(mix.min()) if mix.min() < 0 else int(mix.max())} "
                f"outside split {split!r} (size {len(data)})")
        indices = np.asarray(indices)[mix]
    elif n_req > len(data):
        raise ValueError(
            f"arrival trace has {n_req} requests but split {split!r} holds "
            f"only {len(data)} samples")
    errs = serve_errors(cfg, trace=True) + disagg_lib.disagg_errors(cfg)
    if errs:
        raise ValueError("; ".join(errs))
    clk = make_clock(clock)

    if cfg.buckets:
        table = buckets_lib.decode_table(cfg)
        ext = buckets_lib.sample_extents(data, cfg)
        assignment = buckets_lib.assign_buckets(
            ext, table, use_msg=cfg.decode_tar_buckets)
        if mix is not None:
            assignment = np.asarray(assignment)[mix]
    else:
        table = assignment = None

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, output_name(ablation))

    # crash-resume: the killed run's finished lines, read from the
    # writer's crash pair before the writer opens (which truncates the
    # .partial prefix); the rest is served again at its positions
    recovered: Dict[int, str] = {}
    remaining: Optional[np.ndarray] = None
    if resume:
        if not journal_path:
            raise recovery_lib.ResumeError(
                "resume=True requires journal_path (the write-ahead "
                "request journal of the interrupted run)")
        res_errs = recovery_lib.resume_errors(journal_path, n_req, times,
                                              mix=mix)
        if res_errs:
            raise recovery_lib.ResumeError("; ".join(res_errs))
        recovered = recovery_lib.recover_output(out_path, n_req)
        remaining = np.asarray(
            [i for i in range(n_req) if i not in recovered],
            dtype=np.int64)
        if not len(remaining):
            # everything finished: rebuild the final file from the
            # recovered lines, with no engine and no serving
            with OrderedStreamWriter(out_path, expected=n_req) as w:
                for p in sorted(recovered):
                    w.add(p, recovered[p])
            stats = ServeStats(records=[])
            stats.resumed = n_req
            result = {"sentence_bleu": 0.0, "n": 0.0,
                      "output_path": out_path, "serve": stats.summary(),
                      "engine": {}, "request_records": []}
            if metrics_path:
                write_metrics_atomic(metrics_path, {
                    "serve": result["serve"], "engine": {},
                    "request_records": []})
                if os.path.exists(metrics_path + ".partial"):
                    os.remove(metrics_path + ".partial")
                result["metrics_path"] = metrics_path
            return result

    # the loop's view of the stream: all of it on a fresh run, the
    # unfinished suffix (original positions kept) on a resume
    times_loop, positions, task_mix, loop_assignment = \
        times, None, mix, assignment
    if remaining is not None:
        times_loop = times[remaining]
        positions = remaining
        task_mix = mix[remaining] if mix is not None else remaining
        loop_assignment = (np.asarray(assignment)[remaining]
                           if assignment is not None else None)

    model.eval()
    # with a respawn budget the engines are always a fleet (it owns
    # replace_slot and the spare pool)
    respawn_armed = cfg.max_respawns > 0
    owner, engines, built = build_engines(model, cfg, engine=engine,
                                          faults=faults, guard=guard)
    templates = prepare_templates(owner, data, cfg, table, prewarm=built,
                                  guard=guard)
    recovery = None
    if respawn_armed and hasattr(owner, "replace_slot"):
        if cfg.engine_spares:
            owner.build_spares(cfg.engine_spares)
        recovery = recovery_lib.RecoveryManager(
            owner, cfg, wall_clock=(clock == "wall"))
    bleu_by_pos: Dict[int, float] = {}
    snapshot = metrics_snapshotter(metrics_path, owner, faults)
    journal = (recovery_lib.Journal(journal_path, n=n_req, times=times,
                                    mix=mix, resume=resume)
               if journal_path else None)
    # the disaggregated prefill tier, spawned once the templates exist
    # (its workers warm the same per-bucket prefills), with the model's
    # original f32 weights as host numpy (prefill runs them whatever the
    # decode tier's precision), on the model's device
    own_tier = tier is None and cfg.serve_tiers != "off"
    if cfg.serve_tiers == "off":
        tier = None
    try:
        if own_tier:
            params_host = {k: v.detach().cpu().numpy()
                           for k, v in model.state_dict().items()}
            tier = disagg_lib.PrefillTier(
                params_host, cfg, templates=templates,
                device=str(next(model.parameters()).device),
                dtype=str(model.dtype).replace("torch.", ""), faults=faults)
        elif tier is not None:
            tier.begin_stream()
        if tier is not None:
            # the server takes arrivals once its pool is up (a worker
            # lost meanwhile is the loop's to handle), so the first
            # groups go round the whole pool in worker order, and a
            # wall clock starts there: the workers' start is start-up
            # time, not the first requests' latency
            tier.wait_ready(TIER_START_S)
            if clock == "wall":
                clk = make_clock(clock)
        with OrderedStreamWriter(out_path, expected=n_req) as writer, \
                Feeder(_request_tasks(data, cfg, len(times_loop), table,
                                      loop_assignment, task_mix),
                       num_workers=cfg.feeder_workers,
                       depth=cfg.feeder_depth, put=False,
                       # the per-task error channel: a poisoned payload is
                       # retried on the worker, then delivered with its
                       # error for the loop to shed
                       on_error="record", retries=max(0, cfg.robust_retries),
                       faults=faults) as feed:
            # a resume's recovered lines enter the writer first, once each
            for p in sorted(recovered):
                writer.add(p, recovered[p])
            emit = sample_emitter(writer, vocab=vocab, cfg=cfg,
                                  bleu_by_pos=bleu_by_pos, n_total=n_req,
                                  var_maps=var_maps, indices=indices)
            loop = ServeLoop(
                engines, cfg, arrival_times=times_loop, feed=feed,
                table=table, assignment=loop_assignment,
                templates=templates, clock=clk, emit=emit,
                # a shed request keeps its output position: an empty line
                shed=lambda rec: writer.add(rec.position, "\n"),
                faults=faults, snapshot=snapshot, positions=positions,
                journal=journal, recovery=recovery, tier=tier)
            loop.stats.resumed = len(recovered)
            if tier is not None:
                # the summary reads the tier's end-of-run meters
                loop.stats.tiers = tier.stats.summary
            stats = run_loop_guarded(loop, snapshot)
    finally:
        if own_tier and tier is not None:
            tier.close()
        if journal is not None:
            journal.close()
    lg = sanitizer.leak_guard()
    if lg is not None:
        lg.assert_clean("serve teardown")
    return finalize_serve_result(stats, owner, faults, out_path=out_path,
                                 bleu_by_pos=bleu_by_pos,
                                 metrics_path=metrics_path)

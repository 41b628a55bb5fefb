"""Disaggregated prefill/decode serving tiers (counterpart of
``fira_tpu/serve/disagg.py``).

DistServe-style process split (OSDI '24): prefill and decode interfere
when they share one runtime, since every prefill admitted mid-stream
stalls the seated slots' next step (the ``serve_prefill_budget`` trade of
the in-process loop). Here a pool of **prefill worker processes** (spawned,
never forked: the parent has CUDA initialised and live feeder threads),
each with its own model on the parent's device and its own CUDA context
there, computes each request's prefill artifacts, exactly the prefix
cache's payload (the row's cross-attention K/V and copy-head source
projection, or its encoder states, with a content checksum, under the
tier-namespaced digest), and ships them to the decode tier: pipe messages
for control and small results, one shared-memory segment for a large
result. The decode side seeds every replica's prefix cache
(``SlotEngine.cache_put``), so the requests admit through the all-hit
cache path: one copy to the device and no prefill dispatch on the decode
replica after its warm-up.

Contract (tests/test_torch_disagg.py): a replayed trace through the tiers
writes the in-process serve's bytes, for any worker count and transport
interleaving; every shipped row is checksum-verified at seat (a
``disagg.transport`` corrupt re-prefills, never a wrong answer). A dead
worker is retired and its work resubmitted to the survivors; losing every
worker falls back to in-process prefill on the same device, recorded in
``TierStats.fallback``, never a hang.

A worker's prefill is a real ``SlotEngine._prefill`` (encoder, cross
K/V, source projection): it launches no copy-score kernel, so a worker
never builds one. It runs the parent's device, thread count and TF32
settings, so its artifacts are the bits the parent's own prefill would
make. Weights cross once, at spawn, as host numpy (the original f32
weights, whatever the decode tier's precision); artifacts come back as
host numpy, bf16 as its int16 bits (the prefix cache's host form).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fira_tpu_torch.analysis.sanitizer import leak_guard
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.decode import prefix_cache as prefix_cache_lib
from fira_tpu_torch.robust import faults as faults_lib

TIERS = ("off", "prefill-pool")

# a result whose packed artifacts reach this many bytes ships through one
# shared-memory segment (the parent attaches, copies and unlinks it);
# smaller ones ride the pipe. Module-level so tests can pin either
# transport (both are checksum-verified alike): a tier reads it when it
# is built and hands it to its workers.
SHM_MIN_BYTES = 1 << 18

# a digest goes to the pool at most this many times on top of
# cfg.robust_retries before the tier gives it up to the decode replica's
# own prefill (bounded: a transport that keeps corrupting degrades, never
# livelocks)
_BASE_ATTEMPTS = 1


def disagg_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time validation of the disaggregated-tier knobs (exit 2 in
    the CLI), in the JAX package's words."""
    errs: List[str] = []
    if cfg.serve_tiers not in TIERS:
        errs.append(
            f"serve_tiers {cfg.serve_tiers!r} is not one of {TIERS}; "
            f"see docs/SERVING.md 'Disaggregated tiers'")
    if cfg.serve_tiers != "off":
        if not cfg.decode_engine:
            errs.append(
                "serve_tiers=prefill-pool requires decode_engine: the "
                "decode tier seats shipped artifacts through the slot "
                "engine's cache-admission path")
        if not cfg.prefix_cache:
            errs.append(
                "serve_tiers=prefill-pool requires prefix_cache: shipped "
                "artifacts enter decode replicas through the prefix "
                "cache (the all-hit admission path)")
    if cfg.prefill_workers < 1:
        errs.append(
            f"prefill_workers must be >= 1, got {cfg.prefill_workers}")
    if cfg.serve_artifact_budget_mb < 0:
        errs.append(
            f"serve_artifact_budget_mb must be >= 0 (0 = unbounded), "
            f"got {cfg.serve_artifact_budget_mb}")
    return errs


# --------------------------------------------------------------------------
# the worker child
# --------------------------------------------------------------------------

def _ship_result(conn, seq: int, rows, shm_min: int = SHM_MIN_BYTES
                 ) -> None:
    """Ship one computed group back; ``rows``: [(digest, checksum,
    payload), ...]. A small group rides the pipe; a large one packs every
    array into one shared-memory segment and sends (name, dtype, shape,
    offset, bytes) metadata. A group larger than the shared-memory file
    system's free space rides the pipe too (a segment past it would fault
    on its first write). The checksum covers the payload's content either
    way."""
    total = sum(prefix_cache_lib.payload_nbytes(p) for _d, _c, p in rows)
    if total < shm_min or total > _shm_free():
        conn.send(("result", seq, rows, None))
        return
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(create=True, size=max(1, total))
    try:
        # the parent owns the unlink (it outlives this copy): take the
        # segment off this process's resource tracker, so the child's
        # exit neither unlinks it nor reports it leaked
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    off = 0
    meta = []
    for d, c, p in rows:
        fields = []
        for name in sorted(p):
            a = np.ascontiguousarray(p[name])
            # firacheck: allow[HOST-SYNC] host numpy payload being packed into the shm segment — no device value in the child's ship path
            nb = int(a.nbytes)
            shm.buf[off:off + nb] = a.tobytes()
            fields.append((name, str(a.dtype), tuple(a.shape), off, nb))
            off += nb
        meta.append((d, c, fields))
    name = shm.name
    shm.close()
    conn.send(("result", seq, meta, name))


def _shm_free() -> int:
    """Free bytes of the shared-memory file system (0 where there is
    none)."""
    import shutil

    try:
        return shutil.disk_usage("/dev/shm").free
    except OSError:
        return 0


def _worker_main(conn) -> None:
    """The prefill worker (a spawned child). Receives its ``init`` (the
    config, the weights, the templates, the parent's device, thread count
    and TF32 settings) as the pipe's first message, builds the model,
    loads the weights, builds a real ``SlotEngine`` (its ``_prefill`` is
    the decode engine's), warms the prefill once a bucket and reports
    each bucket's artifact bytes a row (``ready``), then serves ``work``
    messages until ``stop``. An injected ``disagg.worker`` fault ends the
    process: worker death is the failure under test, and the parent's
    sweep retires it and resubmits."""
    import torch

    from fira_tpu_torch.data.feeder import batch_to_device
    from fira_tpu_torch.decode.engine import SlotEngine
    from fira_tpu_torch.model.model import FiraModel

    init: Dict = conn.recv()
    cfg: FiraConfig = init["cfg"]
    wid: int = init["worker_id"]
    templates: Dict[int, Dict] = init["templates"]
    device = torch.device(init["device"])
    torch.set_num_threads(init["threads"])
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = init["tf32"]
        torch.backends.cudnn.allow_tf32 = init["tf32"]
    inj = faults_lib.injector_from(cfg)
    model = FiraModel(cfg, device=device, dtype=init["dtype"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in init["params"].items()})
    model.eval()
    eng = SlotEngine(model, cfg, slots=max(1, cfg.test_batch_size))

    @torch.inference_mode()
    def prefill_rows(batch, n: int) -> Dict[int, Dict]:
        """The payloads of rows 0..n-1 of one packed batch."""
        chunk = eng._prefill(batch_to_device(batch, device))
        lanes = eng._fill_copies(chunk, list(range(n)))
        if device.type == "cuda":
            # firacheck: allow[HOST-SYNC] the worker child's whole job is materializing prefill artifacts on host for transport; this wait for the queued D2H copies is the product, not a stall
            torch.cuda.synchronize(device)
        compact = {f: eng._to_numpy(t) for f, t in lanes.items()}
        return prefix_cache_lib.extract_payloads(compact, list(range(n)), 1)

    def prefill_group(bucket: int, rows) -> List[Tuple]:
        # firacheck: allow[HOST-SYNC] host-side wire assembly from the host template — the single H2D copy below is the boundary
        batch = {k: np.array(v) for k, v in templates[bucket].items()
                 if not k.startswith("_")}
        for j, (_d, rh) in enumerate(rows):
            for k in batch:
                batch[k][j] = rh[k][0]
        entries = prefill_rows(batch, len(rows))
        return [(rows[j][0], prefix_cache_lib.payload_checksum(entries[j]),
                 entries[j]) for j in range(len(rows))]

    # warm the prefill a bucket and report a row's artifact bytes there:
    # the parent's unit of backpressure
    est: Dict[int, int] = {}
    for b in sorted(templates):
        # firacheck: allow[HOST-SYNC] prewarm-time host wire assembly, once per bucket before any request exists
        wire = {k: np.array(v) for k, v in templates[b].items()
                if not k.startswith("_")}
        est[b] = prefix_cache_lib.payload_nbytes(prefill_rows(wire, 1)[0])
    conn.send(("ready", wid, est))

    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            break
        _kind, seq, bucket, rows = msg
        if inj is not None:
            try:
                inj.check("disagg.worker", key=f"w{wid}:{seq}")
            except faults_lib.InjectedFault:
                # worker death, quietly: the parent sees the pipe close
                conn.close()
                os._exit(17)
        _ship_result(conn, seq, prefill_group(bucket, rows),
                     init["shm_min_bytes"])
    conn.close()


def _unpack_rows(rows, shm_name: Optional[str]) -> List[Tuple]:
    """Parent side: inline rows pass through; shared-memory rows are
    copied out of the segment, which is then closed and unlinked."""
    if shm_name is None:
        return list(rows)
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        out = []
        for d, c, fields in rows:
            p = {}
            for name, dt, shape, off, nb in fields:
                dtype = np.dtype(dt)
                p[name] = np.frombuffer(
                    shm.buf, dtype=dtype, count=nb // dtype.itemsize,
                    offset=off).reshape(shape).copy()
            out.append((d, c, p))
        return out
    finally:
        shm.close()
        shm.unlink()


def _discard_shm(shm_name: Optional[str]) -> None:
    """Unlink the segment of a message dropped unread (a transport fault,
    the tier's shutdown): the no-leak path."""
    if shm_name is None:
        return
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=shm_name)
        shm.close()
        shm.unlink()
    except Exception:
        pass


# --------------------------------------------------------------------------
# the parent-side tier
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TierStats:
    """The prefill tier's meters (``serve_metrics.json``'s ``tiers``
    block, present only when the tiers ran); every field is in
    :meth:`summary`."""

    workers: int = 0
    workers_lost: int = 0
    fallback: bool = False
    fallback_reason: str = ""
    groups_submitted: int = 0
    rows_submitted: int = 0
    rows_delivered: int = 0
    rows_resubmitted: int = 0
    rows_given_up: int = 0
    transport_msgs_lost: int = 0
    transport_integrity_drops: int = 0
    shm_segments: int = 0
    artifact_bytes: int = 0
    inflight_bytes: int = 0
    peak_inflight_bytes: int = 0
    peak_backlog: int = 0
    prefill_busy_s: float = 0.0
    rows_by_worker: Dict[int, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict:
        return {
            "workers": self.workers,
            "workers_lost": self.workers_lost,
            "fallback": self.fallback,
            "fallback_reason": self.fallback_reason,
            "groups_submitted": self.groups_submitted,
            "rows_submitted": self.rows_submitted,
            "rows_delivered": self.rows_delivered,
            "rows_resubmitted": self.rows_resubmitted,
            "rows_given_up": self.rows_given_up,
            "transport_msgs_lost": self.transport_msgs_lost,
            "transport_integrity_drops": self.transport_integrity_drops,
            "shm_segments": self.shm_segments,
            "artifact_bytes": self.artifact_bytes,
            "inflight_bytes": self.inflight_bytes,
            "peak_inflight_bytes": self.peak_inflight_bytes,
            "peak_backlog": self.peak_backlog,
            "prefill_busy_s": self.prefill_busy_s,
            "rows_by_worker": {str(k): v
                               for k, v in sorted(self.rows_by_worker.items())},
        }


@dataclasses.dataclass
class _Group:
    """One submitted work item: a same-bucket batch of queue entries."""

    seq: int
    bucket: int
    entries: List[object]      # serve/server._Queued
    bytes_est: int
    submit_t: float


class _Worker:
    """One prefill worker process and its pipe end, parent side."""

    def __init__(self, wid: int, proc, conn) -> None:
        self.wid = wid
        self.proc = proc
        self.conn = conn
        self.ready = False
        self.retired = False
        self.row_bytes: Dict[int, int] = {}
        self.inflight: Dict[int, _Group] = {}

    @property
    def live(self) -> bool:
        return not self.retired and self.proc.is_alive()


class PrefillTier:
    """The parent side of the prefill pool: submission (:meth:`service`
    pumps the serve queue's misses into worker batches under the
    in-flight byte budget), delivery (results drained, checksum-verified,
    seeded into every decode replica's cache) and lifecycle (a dead worker
    is retired and its work resubmitted; all lost is a recorded
    in-process fallback). Requests stay in the serve loop's queue (held
    by :meth:`holds`) until their artifacts land, so sheds, promotions and
    retirements keep their semantics.

    ``params_host``: the model's original weights as host numpy, by
    state-dict name; ``device``, ``dtype``: the decode model's device and
    compute dtype, which every worker takes (a worker never runs on
    another device)."""

    def __init__(self, params_host: Dict[str, np.ndarray], cfg: FiraConfig,
                 *, templates: Dict[int, Dict], device: str, dtype: str,
                 faults=None) -> None:
        import multiprocessing

        import torch

        self.cfg = cfg
        self._bs = max(1, int(cfg.test_batch_size))
        self._budget = int(cfg.serve_artifact_budget_mb) * (1 << 20)
        self._max_attempts = _BASE_ATTEMPTS + max(0, int(cfg.robust_retries))
        self._watchdog_s = float(cfg.dispatch_watchdog_s or 0.0)
        self._faults = faults
        self.stats = TierStats(workers=int(cfg.prefill_workers))
        self._pending: Dict[str, int] = {}     # digest -> owning seq
        self._attempts: Dict[str, int] = {}    # digest -> submit count
        self._given_up: set = set()
        self._first_seen: Dict[str, float] = {}
        self._inflight_bytes = 0
        self._seq = 0
        self._rr = 0
        self._dead = False
        self._closed = False
        # resource-lifecycle sanitizer: armed, the worker pool is ledgered
        # from its spawn to close(), so a serve path that drops the tier
        # without closing it is named at teardown
        self._leaks = leak_guard()
        if self._leaks is not None:
            self._leaks.note_acquire(
                "pool", f"PrefillTier@{id(self):x}",
                what=f"prefill worker pool ({cfg.prefill_workers} procs)")
        # spawn, never fork: the parent runs live threads and has its CUDA
        # context; each child makes its own on the same device
        ctx = multiprocessing.get_context("spawn")
        self._workers: List[_Worker] = []
        for wid in range(cfg.prefill_workers):
            parent_conn, child_conn = ctx.Pipe()
            proc = ctx.Process(target=_worker_main, args=(child_conn,),
                               daemon=True, name=f"fira-prefill-w{wid}")
            proc.start()
            child_conn.close()
            self._workers.append(_Worker(wid, proc, parent_conn))
        # the init (the weights are ~100 MB at fira-full) goes down each
        # pipe once every worker has started: a child reads it after its
        # own imports, so the workers import in parallel and no start
        # waits on another worker's imports (a worker that died in them is
        # the sweep's)
        for w in self._workers:
            init = {"cfg": cfg, "params": params_host,
                    "templates": templates, "device": device,
                    "dtype": dtype, "worker_id": w.wid,
                    "threads": torch.get_num_threads(),
                    "shm_min_bytes": SHM_MIN_BYTES,
                    # firacheck: allow[HOST-SYNC] a host flag of torch's matmul settings, reported once in the worker's ready handshake; no device value exists here
                    "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
            try:
                w.conn.send(init)
            except (OSError, BrokenPipeError):
                pass

    # --- the serve loop's surface ----------------------------------------

    @property
    def alive(self) -> bool:
        return not self._dead and not self._closed

    def begin_stream(self) -> None:
        """Reset the per-stream state (the digests' attempts and
        sightings, the rotation, the meters) for another serve run on the
        same workers; nothing is in flight between two runs."""
        self._pending.clear()
        self._attempts.clear()
        self._given_up.clear()
        self._first_seen.clear()
        self._rr = 0
        self.stats = TierStats(workers=int(self.cfg.prefill_workers))

    def wait_ready(self, timeout: float) -> bool:
        """Block until every live worker has sent its ``ready`` (or none
        is left), up to ``timeout`` seconds: a server on the wall clock
        takes arrivals once its pool is up, so the workers' start is not
        charged to the first requests' latency. True if all are ready."""
        from multiprocessing import connection

        deadline = time.perf_counter() + timeout
        while True:
            self._sweep(())
            waiting = [w for w in self._workers if w.live and not w.ready]
            if not waiting:
                return not self._dead
            left = deadline - time.perf_counter()
            if left <= 0:
                return False
            connection.wait([w.conn for w in waiting], left)
            self._drain(())

    def holds(self, digest) -> bool:
        """True when the tier owns this digest's prefill: the serve loop
        keeps such a miss queued (never dispatching a decode-tier
        prefill) until delivery makes it a cache hit. False once the tier
        is dead or the digest spent its attempts: the recorded in-process
        fallback."""
        return self.alive and digest is not None \
            and digest not in self._given_up

    def service(self, queue, engines) -> None:
        """One scheduler round's tick: sweep dead workers, drain every
        result that arrived, pump fresh queue misses to the workers. Host
        work only, nothing dispatched on the decode device."""
        if not self.alive:
            return
        self._sweep(engines)
        self._drain(engines)
        self._pump(queue, engines)

    def idle_wait(self, timeout: float) -> None:
        """A bounded wait for tier progress while the serve loop has
        nothing it can dispatch (every queued request is held here):
        block on the worker pipes up to ``timeout`` instead of spinning;
        any message or a worker's death wakes it."""
        if not self.alive:
            return
        busy = any(w.inflight for w in self._workers) \
            or bool(self._pending) or not all(
                w.ready for w in self._workers if w.live)
        conns = [w.conn for w in self._workers if not w.retired]
        if not busy or not conns:
            return
        from multiprocessing import connection
        connection.wait(conns, timeout)

    # --- internals --------------------------------------------------------

    def _sweep(self, engines) -> None:
        now = time.perf_counter()
        for w in self._workers:
            if w.retired:
                continue
            if not w.proc.is_alive():
                self._retire_worker(w, "process died")
            elif self._watchdog_s and w.inflight:
                oldest = min(g.submit_t for g in w.inflight.values())
                if now - oldest > self._watchdog_s:
                    self._retire_worker(
                        w, f"work item exceeded the "
                           f"{self._watchdog_s:.1f}s dispatch watchdog")
        if not any(w.live for w in self._workers) and not self._dead:
            self._dead = True
            self.stats.fallback = True
            self.stats.fallback_reason = (
                "all prefill workers lost; decode tier resumed "
                "in-process prefill")

    def _requeue(self, group: Optional[_Group]) -> None:
        """A group's digests leave the pending set: the entries never left
        the serve queue, so the next pump resubmits them."""
        if group is None:
            return
        for e in group.entries:
            if self._pending.pop(e.digest, None) is not None:
                self.stats.rows_resubmitted += 1

    def _retire_worker(self, w: _Worker, reason: str) -> None:
        if w.retired:
            return
        w.retired = True
        self.stats.workers_lost += 1
        for group in w.inflight.values():
            self._inflight_bytes -= group.bytes_est
            self._requeue(group)
        w.inflight.clear()
        try:
            w.conn.close()
        except Exception:
            pass
        if w.proc.is_alive():
            w.proc.terminate()
        self.stats.inflight_bytes = self._inflight_bytes

    def _drain(self, engines) -> None:
        for w in self._workers:
            if w.retired:
                continue
            while True:
                try:
                    if not w.conn.poll(0):
                        break
                    msg = w.conn.recv()
                except (EOFError, OSError, BrokenPipeError):
                    self._retire_worker(w, "transport connection lost")
                    break
                self._handle(w, msg, engines)

    def _handle(self, w: _Worker, msg, engines) -> None:
        if msg[0] == "ready":
            _kind, _wid, est = msg
            w.ready = True
            w.row_bytes = dict(est)
            return
        if msg[0] != "result":
            return
        _kind, seq, rows, shm_name = msg
        recv_t = time.perf_counter()
        group = w.inflight.pop(seq, None)
        if group is not None:
            self._inflight_bytes -= group.bytes_est
            self.stats.inflight_bytes = self._inflight_bytes
            self.stats.prefill_busy_s += recv_t - group.submit_t
        if self._faults is not None \
                and self._faults.armed("disagg.transport"):
            try:
                self._faults.check("disagg.transport", key=seq)
            except faults_lib.InjectedFault:
                # the message is lost in transport: drop it and its
                # segment, the next pump resubmits (same bytes, later)
                _discard_shm(shm_name)
                self.stats.transport_msgs_lost += 1
                self._requeue(group)
                return
        try:
            unpacked = _unpack_rows(rows, shm_name)
        except (OSError, ValueError):
            # the segment is gone (its producer died mid-ship): as lost
            self.stats.transport_msgs_lost += 1
            self._requeue(group)
            return
        if shm_name is not None:
            self.stats.shm_segments += 1
        for i, (digest, checksum, payload) in enumerate(unpacked):
            if self._faults is not None:
                payload = self._faults.corrupt("disagg.transport",
                                               f"{seq}:{i}", payload)
            if prefix_cache_lib.payload_checksum(payload) != checksum:
                # a scrambled row caught at the seat: drop it and prefill
                # again, never a wrong answer
                self.stats.transport_integrity_drops += 1
                if self._pending.pop(digest, None) is not None:
                    self.stats.rows_resubmitted += 1
                continue
            nb = prefix_cache_lib.payload_nbytes(payload)
            for eng in engines:
                eng.cache_put(digest, payload)
            self._pending.pop(digest, None)
            self.stats.rows_delivered += 1
            self.stats.artifact_bytes += nb
            self.stats.rows_by_worker[w.wid] = \
                self.stats.rows_by_worker.get(w.wid, 0) + 1
            if group is not None and i < len(group.entries):
                rec = group.entries[i].record
                if rec.status == "queued":
                    rec.transport_s = recv_t - group.submit_t
                    rec.artifact_bytes = nb

    def _pump(self, queue, engines) -> None:
        now = time.perf_counter()
        cand = []
        for e in queue:
            d = e.digest
            if d is None or d in self._pending or d in self._given_up \
                    or e.record.status != "queued":
                continue
            if d not in self._first_seen:
                self._first_seen[d] = now
            if engines and all(eng.cache_contains(d) for eng in engines):
                continue
            if self._attempts.get(d, 0) >= self._max_attempts:
                self._given_up.add(d)
                self.stats.rows_given_up += 1
                continue
            cand.append(e)
        self.stats.peak_backlog = max(self.stats.peak_backlog, len(cand))
        ready = [w for w in self._workers if w.ready and w.live]
        if not ready:
            return
        while cand:
            bucket = cand[0].bucket
            take, rest = [], []
            for e in cand:
                if e.bucket == bucket and len(take) < self._bs:
                    take.append(e)
                else:
                    rest.append(e)
            cand = rest
            est = len(take) * max(
                1, ready[0].row_bytes.get(bucket, SHM_MIN_BYTES))
            if self._budget and self._inflight_bytes \
                    and self._inflight_bytes + est > self._budget:
                # backpressure: the in-flight budget is spent, wait for
                # deliveries (a group alone still ships)
                break
            w = ready[self._rr % len(ready)]
            self._rr += 1
            seq = self._seq
            self._seq += 1
            rows = [(e.digest,
                     {k: v for k, v in e.host.items()
                      if not k.startswith("_")}) for e in take]
            try:
                w.conn.send(("work", seq, bucket, rows))
            except (OSError, BrokenPipeError, ValueError):
                self._retire_worker(w, "submit failed")
                ready = [x for x in self._workers if x.ready and x.live]
                if not ready:
                    return
                cand = take + cand
                continue
            group = _Group(seq, bucket, take, est, now)
            w.inflight[seq] = group
            self._inflight_bytes += est
            self.stats.inflight_bytes = self._inflight_bytes
            self.stats.peak_inflight_bytes = max(
                self.stats.peak_inflight_bytes, self._inflight_bytes)
            self.stats.groups_submitted += 1
            self.stats.rows_submitted += len(take)
            for e in take:
                self._pending[e.digest] = seq
                self._attempts[e.digest] = \
                    self._attempts.get(e.digest, 0) + 1
                e.record.prefill_queue_s = now - self._first_seen[e.digest]

    def close(self) -> None:
        """Tear the pool down: drain the results already shipped (their
        segments must be unlinked), then stop and join every worker,
        terminating stragglers."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.retired:
                continue
            try:
                while w.conn.poll(0):
                    msg = w.conn.recv()
                    if msg and msg[0] == "result":
                        _discard_shm(msg[3])
            except Exception:
                pass
            try:
                w.conn.send(("stop",))
            except Exception:
                pass
        # the workers stop together: one shared deadline for all of them
        deadline = time.perf_counter() + 5.0
        for w in self._workers:
            w.proc.join(timeout=max(0.0, deadline - time.perf_counter()))
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=1.0)
            try:
                w.conn.close()
            except Exception:
                pass
        if self._leaks is not None:
            self._leaks.note_release("pool", f"PrefillTier@{id(self):x}")

    def __enter__(self) -> "PrefillTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Replicated slot-engine decode fleet: N engines, one admission queue
(counterpart of ``fira_tpu/parallel/fleet.py``).

N :class:`~fira_tpu_torch.decode.engine.SlotEngine` replicas, each with
its own slot arena, paged pool and prefix cache, pull packed chunks from
one shared admission queue (the Feeder stream every decode driver uses),
and harvest and refill interleave across the replicas. Scheduling is the
single engine's own, taken round-robin:

- **admission**: replicas claim chunks from the shared queue in replica
  order whenever their prefill-ahead policy wants input. The Feeder runs
  ``put=False``: which replica a chunk lands on is a scheduling decision,
  so the copy to the device happens at admission, onto the claiming
  replica's device;
- **step interleave**: every live replica's step is dispatched before any
  replica's harvest reads back, so replicas on different cards overlap
  while the host walks the fleet;
- **harvest and refill**: each replica harvests its settled slots and
  refills from its staged chunks on the next round.

Per sample the results do not depend on which replica or slot computes
them (the same weights, the same prefill batches, since a chunk is always
prefilled whole, the same per-slot step), so the output file's bytes are
the single engine's for any replica count and interleaving
(tests/test_torch_fleet.py).

Devices: by default one a replica, round-robin over the visible cards
(on one card every replica shares it; on the CPU every replica is on the
CPU). A replica on the model's own device uses the model as it is (its
weights are only read, under ``torch.inference_mode``); a replica on
another device gets a copy of the model moved there, the counterpart of
the JAX package's ``device_put`` of the parameters.

Cross-request reuse (``cfg.prefix_cache``): each replica owns its prefix
cache and in-flight dedup map. Retirement releases a dead replica's block
grants through its refcounted allocator and folds its coalesced followers
into the re-admission payloads, so a requeued request is decoded once.

Graceful degradation: a replica whose dispatch raises, or outlives
``cfg.dispatch_watchdog_s`` and is abandoned on its watchdog thread, is
retired: it leaves the rotation, its in-flight and staged requests go back
to the head of the queue for the survivors, and the drain goes on. A
requeued request decodes to the same bytes wherever it lands, so the
output of a run that lost a replica is the no-fault run's. With
``cfg.max_respawns`` a retired lineage is replaced (robust/recovery.py):
a warm spare is attached, or a fresh engine is built and prewarmed.
Retirements, requeues and respawns are recorded in :class:`FleetStats`.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.decode.engine import EngineItem, EngineStats, SlotEngine
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import recovery as recovery_lib
from fira_tpu_torch.robust.watchdog import run_with_watchdog


def fleet_divisibility_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time fleet check: a nonzero ``engine_slots`` is the
    fleet-total arena, split evenly across replicas, so a non-divisor is
    refused up front. The paged pool (``kv_pool_blocks``, also a fleet
    total) is checked by ``decode/paging.paging_errors``."""
    reps = max(1, int(cfg.engine_replicas))
    if reps > 1 and cfg.engine_slots and cfg.engine_slots % reps:
        return [_split_error("engine_slots", cfg.engine_slots, reps,
                             "slot arena")]
    return []


def _split_error(knob: str, total: int, reps: int, what: str) -> str:
    """The refusal of a fleet total that does not split evenly."""
    return (f"{knob} {total} is not divisible by engine_replicas {reps} "
            f"(the fleet splits the total {what} evenly across replicas)")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` are one card."""
    return a.type == b.type and (a.index or 0) == (b.index or 0)


@dataclasses.dataclass
class FleetStats:
    """Aggregate and per-replica accounting of one fleet run."""

    replicas: List[EngineStats]
    # degradation: one entry a retired replica ({"replica": tag, "error":
    # str}) and the requests requeued onto survivors over all retirements
    retirements: List[Dict] = dataclasses.field(default_factory=list)
    requeues: int = 0
    # recovery: one entry a replacement ({"replica": new tag, "origin":
    # lineage, "spare": bool})
    respawns: List[Dict] = dataclasses.field(default_factory=list)
    # the spare pool's idle engines (built and prewarmed, never attached)
    idle_spares: List[EngineStats] = dataclasses.field(default_factory=list)

    @property
    def commits(self) -> int:
        return sum(r.commits for r in self.replicas)

    def summary(self) -> Dict:
        """The JAX package's keys, then the port's ``host_syncs`` and
        ``warm_step_dispatches`` (prewarm step dispatches of every engine
        the fleet built, idle spares included)."""
        tot = lambda f: sum(getattr(r, f) for r in self.replicas)  # noqa: E731
        steps_x_slots = sum(r.steps * r.slots for r in self.replicas)
        # pools are per replica: blocks total across replicas, and the
        # utilization weights each pool by its replica's dispatches
        pool_capacity = sum(r.step_dispatches * r.pool_blocks
                            for r in self.replicas)
        if pool_capacity:
            pool_util = round(tot("block_steps") / pool_capacity, 4)
        else:
            pool_util = (1.0 if any(r.kv_bytes_per_slot
                                    for r in self.replicas) else 0.0)
        return {
            "pool_blocks": tot("pool_blocks"),
            "kv_block_size": max((r.kv_block_size for r in self.replicas),
                                 default=0),
            "kv_bytes_per_slot": max((r.kv_bytes_per_slot
                                      for r in self.replicas), default=0),
            "kv_dtype": next((r.kv_dtype for r in self.replicas
                              if r.step_dispatches), "f32"),
            "serve_precision": next((r.serve_precision
                                     for r in self.replicas
                                     if r.step_dispatches), "f32"),
            "peak_blocks": tot("peak_blocks"),
            "pool_utilization": pool_util,
            "replicas": len(self.replicas),
            "slots": tot("slots"),
            "prefills": tot("prefills"),
            "refills": tot("refills"),
            "slots_refilled": tot("slots_refilled"),
            "steps_run": tot("steps"),
            "step_dispatches": tot("step_dispatches"),
            "commits": self.commits,
            "dispatches": sum(r.dispatches for r in self.replicas),
            "harvest_row_reads": tot("harvest_row_reads"),
            "harvest_bytes_read": tot("harvest_bytes_read"),
            "harvest_bytes_saved": tot("harvest_bytes_saved"),
            # caches are per replica: counts total across the fleet and
            # the hit rate is the fleet-wide share served from a cache
            "cache_hits": tot("cache_hits"),
            "cache_misses": tot("cache_misses"),
            "cache_hit_rate": round(
                tot("cache_hits") / (tot("cache_hits")
                                     + tot("cache_misses")), 4)
            if tot("cache_hits") + tot("cache_misses") else 0.0,
            "cache_evictions": tot("cache_evictions"),
            "cache_integrity_drops": tot("cache_integrity_drops"),
            "prefills_saved": tot("prefills_saved"),
            "cache_hbm_bytes_saved": tot("cache_hbm_bytes_saved"),
            "dedup_fanout": tot("dedup_fanout"),
            "shared_block_peak": tot("shared_block_peak"),
            # speculative decode: counts total across the fleet and
            # the acceptance rate is the fleet-wide accepted share
            "drafted": tot("drafted"),
            "accepted": tot("accepted"),
            "acceptance_rate": round(tot("accepted") / tot("drafted"), 4)
            if tot("drafted") else 0.0,
            "verify_dispatches": tot("verify_dispatches"),
            "steps_saved": tot("steps_saved"),
            "spec_frames": tot("spec_frames"),
            "per_replica_acceptance": [
                round(r.acceptance_rate, 4) for r in self.replicas],
            "slot_occupancy": round(
                tot("occupied_slot_steps") / steps_x_slots, 4
            ) if steps_x_slots else 0.0,
            "per_replica_occupancy": [
                round(r.slot_occupancy, 4) for r in self.replicas],
            "per_replica_commits": [r.commits for r in self.replicas],
            "retirements": len(self.retirements),
            "retired_replicas": [r["replica"] for r in self.retirements],
            "requeues": self.requeues,
            "respawns": len(self.respawns),
            "respawned_replicas": [r["replica"] for r in self.respawns],
            "spare_attaches": sum(1 for r in self.respawns if r["spare"]),
            "host_syncs": tot("host_syncs"),
            "warm_step_dispatches": tot("warm_step_dispatches") + sum(
                s.warm_step_dispatches for s in self.idle_spares),
        }


class EngineFleet:
    """N-replica slot-engine decode over one shared admission queue.

    ``replicas``: engine count. ``slots``: the fleet-total arena (must
    divide by ``replicas``); 0/None leaves each replica its own default
    (``cfg.engine_slots`` in total when nonzero, else
    ``cfg.test_batch_size`` slots a replica). The replicas go round-robin
    over the visible cards (all on the CPU when the model is there)."""

    def __init__(self, model: FiraModel, cfg: FiraConfig, *,
                 replicas: int, slots: Optional[int] = None, faults=None,
                 guard=None):
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        total = int(slots or cfg.engine_slots or 0)
        if total and total % replicas:
            raise ValueError(_split_error("engine_slots", total, replicas,
                                          "slot arena"))
        per_replica = total // replicas if total else None
        # kv_pool_blocks is a fleet total like engine_slots (0 keeps each
        # engine's own full-residency size)
        pool_total = int(cfg.kv_pool_blocks)
        if pool_total and pool_total % replicas:
            raise ValueError(_split_error("kv_pool_blocks", pool_total,
                                          replicas, "KV block pool"))
        per_replica_pool = pool_total // replicas if pool_total else None
        home = next(model.parameters()).device
        if home.type == "cuda":
            n_dev = torch.cuda.device_count()
            devices = [torch.device("cuda", i % n_dev)
                       for i in range(replicas)]
        else:
            devices = [home] * replicas
        self.cfg = cfg
        self.faults = faults
        self._guard = guard
        # the degradation record; ``engines`` stays the full roster (the
        # stats keep counting a retired replica's commits), the run loop
        # keeps its own live list
        self.retirements: List[Dict] = []
        self.requeues: int = 0
        # what a respawn builds from: the model, the stored warm batches,
        # each lineage's respawn ordinal, the warm-spare pool
        self._model = model
        self._home = home
        self._per_replica = per_replica
        self._per_replica_pool = per_replica_pool
        self._devices = devices
        self._warm: Optional[List] = None
        self._respawn_counts: Dict[str, int] = {}
        self._spare_seq = 0
        self.respawns: List[Dict] = []
        self.spares: List[SlotEngine] = []
        self.engines = [self._engine(self._devices[i], f"r{i}")
                        for i in range(replicas)]

    def _engine(self, device: torch.device, tag: str) -> SlotEngine:
        """One engine on ``device``: the model itself on its own device,
        a copy moved there on another."""
        model = self._model
        if not _same_device(device, self._home):
            model = copy.deepcopy(self._model).to(device).eval()
        return SlotEngine(model, self.cfg, slots=self._per_replica,
                          pool_blocks=self._per_replica_pool,
                          faults=self.faults, tag=tag, guard=self._guard)

    def labels(self, table=None) -> List[str]:
        """The fleet's declared dispatch family: the union of every
        replica's labels, each suffixed with its tag."""
        return [lbl for e in self.engines for lbl in e.labels(table)]

    @property
    def stats(self) -> FleetStats:
        return FleetStats([e.stats for e in self.engines],
                          retirements=list(self.retirements),
                          requeues=self.requeues,
                          respawns=list(self.respawns),
                          idle_spares=[s.stats for s in self.spares])

    def cache_put(self, digest, payload) -> None:
        """Seed one artifact payload prefilled elsewhere into every
        replica's prefix cache: whichever replica claims the request seats
        it from the cache."""
        for eng in self.engines:
            eng.cache_put(digest, payload)

    def prewarm(self, warm_batches) -> None:
        """Prewarm every replica on the same batches (kernels built and
        first launched outside any timed or watched dispatch). The batches
        are kept: a replacement prewarms on them too."""
        batches = list(warm_batches)
        self._warm = batches
        for eng in self.engines:
            eng.prewarm(batches)

    # --- self-healing (robust/recovery.py) ------------------------------

    def _build_replacement(self, device, tag: str) -> SlotEngine:
        """One fresh engine on ``device``, its paged pool allocated anew
        and prewarmed on the stored warm batches, so its first serving
        dispatch pays no kernel build or first launch."""
        eng = self._engine(device, tag)
        if self._guard is not None and self._guard.family_closed:
            # additive declare into an already closed family only: a first
            # declare here would close an open family (unbucketed runs
            # never declare) around the replacement's labels alone and
            # outlaw every serving replica's
            tags = [h.get("_tag") if self.cfg.buckets else None
                    for h in (self._warm or [])] or [None]
            self._guard.declare(eng.labels_for_tags(tags))
        if self._warm:
            eng.prewarm(self._warm)
        return eng

    def build_spares(self, count: int) -> None:
        """Fill the warm-spare pool up to ``count`` prewarmed standby
        engines (tags ``sp<i>`` from a sequence never reused, devices
        round-robin like the fleet's), idle until a retirement attaches
        one."""
        # firacheck: allow[HOST-SYNC] count is the engine_spares config int; no device value exists here
        while len(self.spares) < int(count):
            i = self._spare_seq
            self._spare_seq += 1
            self.spares.append(self._build_replacement(
                self._devices[i % len(self._devices)], f"sp{i}"))

    def take_spare(self, device) -> Optional[SlotEngine]:
        """Pop a spare, one on ``device`` first; any spare otherwise
        (capacity restored beats placement)."""
        for i, sp in enumerate(self.spares):
            if device is not None and _same_device(sp.device, device):
                return self.spares.pop(i)
        return self.spares.pop(0) if self.spares else None

    def replace_slot(self, origin: str, device):
        """Replace one retired lineage: a warm spare when the pool has one
        (an attach), else a fresh build on the lineage's device. The
        replacement joins the roster here (its commits count in the
        stats); the caller adds it to the live rotation. Returns (engine,
        from_spare)."""
        spare = self.take_spare(device)
        if spare is not None:
            self.engines.append(spare)
            self.respawns.append({"replica": spare.tag or "r0",
                                  "origin": origin, "spare": True})
            return spare, True
        k = self._respawn_counts.get(origin, 0) + 1
        self._respawn_counts[origin] = k
        tag = f"{origin}{recovery_lib.RESPAWN_TAG_SEP}{k}"
        eng = self._build_replacement(
            device if device is not None else self._home, tag)
        self.engines.append(eng)
        self.respawns.append({"replica": tag, "origin": origin,
                              "spare": False})
        return eng, False

    @staticmethod
    def _as_payload(item) -> Dict:
        """A Feeder item as a requeue-able admission payload: positions
        pinned in ``_positions`` (from the item index when the stream has
        none, as ``SlotEngine.admit`` derives them), so the same host
        batch can be admitted on any replica, also after the first
        replica died mid-prefill."""
        host = dict(item.host)
        if host.get("_positions") is None:
            C = host["valid"].shape[0]
            host["_positions"] = (item.index * C
                                  + np.arange(C, dtype=np.int64))
        return host

    def _retire(self, eng: SlotEngine, alive: List[SlotEngine],
                pending: "collections.deque", err: BaseException,
                recovery=None) -> None:
        """Retire one replica: drop it from the rotation, requeue every
        request it still owed at the front of the shared queue (they
        arrived first) and record it. With ``recovery`` armed, dead
        lineages with budget left are respawned here at once, after their
        wall backoff (a drain has no scheduler rounds), and join the
        rotation. With no survivor and no budget a drain fails loudly,
        never hangs."""
        alive.remove(eng)
        payloads = eng.retire()
        # an admit the watchdog abandoned can finish staging between the
        # timeout and retire() setting the flag: its chunk then comes back
        # in ``payloads`` while still at pending[0] (never popped, the
        # admit raised). Rows a queued payload already owes are masked
        # here, so no position is decoded twice
        pending_pos = set()
        for b in pending:
            # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
            v = np.asarray(b["valid"], dtype=bool)
            # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
            pending_pos.update(int(p) for p in np.asarray(b["_positions"])[v])
        n_req = 0
        kept = []
        for p in payloads:
            # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
            v = np.asarray(p["valid"], dtype=bool).copy()
            # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
            pos = np.asarray(p["_positions"])
            for r in range(v.shape[0]):
                # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
                if v[r] and int(pos[r]) in pending_pos:
                    v[r] = False
            # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
            if v.any():
                # firacheck: allow[HOST-SYNC] requeue payloads are host numpy batches (SlotEngine.retire / _as_payload); no device value exists in this dedup
                p["valid"] = v.astype(np.asarray(p["valid"]).dtype)
                kept.append(p)
                n_req += int(v.sum())
        for p in reversed(kept):
            pending.appendleft(p)
        self.requeues += n_req
        self.retirements.append({"replica": eng.tag or "r0",
                                 "error": f"{type(err).__name__}: {err}"})
        if recovery is not None:
            recovery.note_retirement(eng, -1,
                                     error=f"{type(err).__name__}: {err}")
            for new in recovery.heal_all():
                new.begin_stream()
                alive.append(new)
        if not alive:
            raise RuntimeError(
                f"all {len(self.engines)} fleet replicas retired; last "
                f"error on {eng.tag or 'r0'}: {err}") from err

    def run(self, feed, *, refill_order: str = "fifo"
            ) -> Iterator[EngineItem]:
        """Drive the fleet over ``feed`` (``data.feeder.FedBatch`` items of
        a ``put=False`` Feeder: the shared admission queue). Yields one
        EngineItem a sample as it settles, across all replicas; each is
        keyed by split position, so the ordered writer downstream does not
        care which replica served it.

        Each replica's admission, refill, step and harvest run under
        ``cfg.dispatch_watchdog_s`` (0 = off); a raise or an expiry retires
        the replica and requeues its requests (:meth:`_retire`), which are
        admitted before fresh feed items on whichever survivor wants input
        next. ``fleet.replica`` is checked once a replica a round."""
        if refill_order not in ("fifo", "lifo"):
            raise ValueError(f"refill_order {refill_order!r} not in "
                             f"{{'fifo', 'lifo'}}")
        for eng in self.engines:
            eng.begin_stream()
        feed_iter = iter(feed)
        exhausted = False
        wd = float(self.cfg.dispatch_watchdog_s)
        # with a respawn budget, a retirement is followed by a replacement
        # (after its wall backoff) instead of a lasting capacity loss
        recovery = (recovery_lib.RecoveryManager(self, self.cfg,
                                                 wall_clock=True)
                    if self.cfg.max_respawns > 0 else None)
        if recovery is not None and self.cfg.engine_spares:
            # the drain arms its own spare pool (serve_split builds the
            # serve path's)
            self.build_spares(self.cfg.engine_spares)
        # re-admission payloads of retired replicas, served first
        pending: "collections.deque" = collections.deque()
        alive = [eng for eng in self.engines if not eng.retired]
        while True:
            # admission and refill in replica order (which replica takes a
            # chunk never changes the chunk's results)
            for eng in list(alive):
                try:
                    if self.faults is not None:
                        self.faults.check("fleet.replica")
                    while eng.wants_input():
                        if not pending:
                            if exhausted:
                                break
                            try:
                                item = next(feed_iter)
                            except StopIteration:
                                exhausted = True
                                break
                            # every item becomes a requeue-able payload
                            # first: if this replica dies mid-prefill the
                            # chunk stays at the head of pending
                            pending.append(self._as_payload(item))
                        payload = pending[0]   # peek: a failed admit leaves
                        #                        it for the next survivor
                        run_with_watchdog(
                            lambda p=payload: eng.admit(p, 0), wd,
                            label=f"prefill[{eng.tag}]")
                        pending.popleft()
                    run_with_watchdog(lambda: eng.refill(refill_order), wd,
                                      label=f"refill[{eng.tag}]")
                except Exception as e:
                    self._retire(eng, alive, pending, e, recovery)
            live = [eng for eng in alive if eng.in_flight()]
            if not live:
                if exhausted and not pending:
                    return
                continue  # nothing in flight yet: pull more input
            # every live replica's step before any harvest reads back
            for eng in live:
                try:
                    run_with_watchdog(eng.step_dispatch, wd,
                                      label=f"step[{eng.tag}]")
                except Exception as e:
                    self._retire(eng, alive, pending, e, recovery)
            for eng in live:
                if eng.retired:
                    continue
                try:
                    items = run_with_watchdog(eng.harvest, wd,
                                              label=f"harvest[{eng.tag}]")
                except Exception as e:
                    self._retire(eng, alive, pending, e, recovery)
                    continue
                yield from items

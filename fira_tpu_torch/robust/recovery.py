"""Self-healing fleet: replica respawn, warm spares, crash-resume
(counterpart of ``fira_tpu/robust/recovery.py``).

Retirement (parallel/fleet.py, serve/server.py) takes a faulted replica
out of the rotation and hands its requests to the survivors, but the
capacity is gone for good, and losing every replica sheds the rest of the
stream. This module closes the loop from a failure back to full capacity,
with the output bytes a function of the request stream alone under any
failure and recovery trace:

- **Replica respawn**: :class:`RecoveryManager` keeps one
  :class:`ReplicaSlot` a replica lineage (``r1`` and every engine that
  ever replaced it share one respawn budget), gates each respawn on the
  shared backoff curve (:func:`respawn_backoff_s`, the
  ``robust.faults.backoff_s`` shape rescaled to ``cfg.respawn_backoff_s``)
  and leaves construction to ``EngineFleet.replace_slot``: a fresh
  ``SlotEngine`` on the dead replica's device, its paged pool allocated
  anew and prewarmed on the stored warm batches, or an engine of the
  warm-spare pool (``cfg.engine_spares`` engines built and prewarmed up
  front, so a replacement costs an attach instead of a build). A lineage
  that keeps crashing exhausts ``cfg.max_respawns`` and stays retired.
  Under the sanitizer's guard a replacement declares its own labels into
  the already closed family before its prewarm (additively, never as the
  first declare: ``EngineFleet._build_replacement``).

- **Crash-resume**: :class:`Journal` is an append-only request journal
  beside the output file, one JSON line a request at admit and at done or
  shed, each round's batch fsync'd. After a kill, :func:`recover_output`
  reads the ``OrderedStreamWriter`` crash pair (the ``.partial`` prefix
  and the position-tagged ``.partial.tail``, torn trailing lines dropped)
  and ``cli serve --resume`` serves again exactly the positions with no
  finished line on disk: every position is written once, and a run whose
  requests all complete writes the bytes of an uninterrupted run. A line
  that reached the disk (a prediction, or a recorded shed's empty line)
  is final across a resume: a shed depends on load timing that the
  resumed run does not reproduce.

Which bytes land at which position never depends on the failure and
recovery trace (each beam row is independent of the others, and the
writer keys by position); recovery changes only when capacity comes back.
On the virtual clock that schedule is deterministic (the backoff counts
scheduler rounds); on the wall clock it is gated in wall seconds, never
slept on the serve loop's thread, so the surviving replicas keep stepping
through a lineage's backoff.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.robust import faults as faults_lib

# the shared curve caps at 5x its base (faults.backoff_s is linear in the
# attempt, capped); the same cap bounds the round-gated backoff below
_BACKOFF_CAP_ATTEMPTS = 5
# respawn tags: lineage origin + "~" + respawn ordinal ("r1" dies ->
# "r1~1" -> "r1~2"); "~" never appears in a fleet ("r<i>") or spare
# ("sp<i>") tag, so the origin is one split away
RESPAWN_TAG_SEP = "~"


# --------------------------------------------------------------------------
# parse-time knob validation (CLI exit 2)
# --------------------------------------------------------------------------

def recovery_errors(cfg: FiraConfig) -> List[str]:
    """Named-knob recovery checks, in the JAX package's words: spare
    count, respawn budget, backoff base; one message a violation."""
    errs: List[str] = []
    if cfg.engine_spares < 0:
        errs.append(
            f"engine_spares {cfg.engine_spares} must be >= 0 pre-built "
            f"prewarmed standby engines")
    if cfg.max_respawns < 0:
        errs.append(
            f"max_respawns {cfg.max_respawns} must be >= 0 (0 = replica "
            f"respawn off — the PR-9 retire-and-degrade behavior)")
    if cfg.respawn_backoff_s <= 0:
        errs.append(
            f"respawn_backoff_s {cfg.respawn_backoff_s} must be > 0 wall "
            f"seconds (the per-lineage respawn backoff base; the shared "
            f"robust.faults.backoff_s curve scales from it)")
    if cfg.engine_spares > 0 and cfg.max_respawns == 0:
        errs.append(
            f"engine_spares {cfg.engine_spares} builds a standby pool "
            f"nothing can attach: max_respawns is 0 (respawn disabled); "
            f"set max_respawns >= 1 to let spares replace dead replicas")
    return errs


def respawn_backoff_s(attempt: int, base: float) -> float:
    """A lineage's respawn backoff in wall seconds: the quarantine curve
    (``robust.faults.backoff_s``, linear in the attempt, capped at 5x)
    rescaled from its 0.01 s base to ``base``, one curve for every retry
    and respawn site."""
    # firacheck: allow[HOST-SYNC] base is the respawn_backoff_s config float; no device value exists here
    return faults_lib.backoff_s(attempt) * (float(base) / 0.01)


def origin_of(tag: Optional[str]) -> str:
    """A replica tag's lineage origin: ``r1~2`` -> ``r1`` (every respawn
    of a slot shares the original replica's budget)."""
    return (tag or "r0").split(RESPAWN_TAG_SEP)[0]


# --------------------------------------------------------------------------
# the request journal (crash-resume)
# --------------------------------------------------------------------------

def times_digest(times) -> str:
    """Content digest of an arrival schedule (rounded to the nanosecond),
    the resume admission check: a journal written for another request
    stream is refused, never half replayed. The JAX package's digest, so
    a journal's ``begin`` record is the same in both."""
    t = np.asarray(times, dtype=np.float64)
    msg = ",".join(f"{x:.9f}" for x in t).encode()
    return hashlib.blake2b(msg, digest_size=8).hexdigest()


class Journal:
    """Append-only JSONL request journal.

    One record a request at admit and at done or shed, each batch written
    and fsync'd in one call, so a kill at any instant leaves a parseable
    prefix whose torn trailing line :func:`read_journal` drops. The
    ``begin`` record pins the stream (request count, arrival digest,
    request-mix digest), so ``--resume`` can refuse a journal of another
    run."""

    def __init__(self, path: str, *, n: int, times, mix=None,
                 resume: bool = False):
        self.path = path
        # a resume appends a new generation (the earlier records are what
        # it recovers from); a fresh run truncates
        self._f = open(path, "a" if resume else "w")
        try:
            self.append({"kind": "begin", "n": int(n),
                         "times_digest": times_digest(times),
                         "mix_digest": (times_digest(mix) if mix is not None
                                        else None),
                         "resume": bool(resume)})
        except BaseException:
            # the begin record's fsync can fail (a full or failing disk);
            # no caller holds the half-built Journal, so close here
            self._f.close()
            raise

    def append(self, rec: Dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def append_many(self, recs: List[Dict]) -> None:
        """One write and one fsync for a batch of records (a round's
        admits or completions; still one record a request)."""
        if not recs:
            return
        self._f.write("".join(json.dumps(r) + "\n" for r in recs))
        self._f.flush()
        os.fsync(self._f.fileno())

    def admit(self, positions: List[int]) -> None:
        self.append_many([{"kind": "admit", "pos": int(p)}
                          for p in positions])

    def done(self, positions: List[int]) -> None:
        self.append_many([{"kind": "done", "pos": int(p)}
                          for p in positions])

    def shed(self, pos: int, status: str, error: Optional[str]) -> None:
        self.append({"kind": "shed", "pos": int(pos), "status": status,
                     "error": error})

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def read_journal(path: str) -> Tuple[Optional[Dict], Dict[int, Dict]]:
    """Parse a journal: (the first begin record, the terminal record of
    each position). A torn trailing line (no newline, or a partial JSON
    document: a kill mid-write) is dropped, never an error; of a done and
    a shed for one position the later is kept (a resumed run may complete
    a request the killed run shed)."""
    meta: Optional[Dict] = None
    terminal: Dict[int, Dict] = {}
    if not os.path.exists(path):
        return None, {}
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\n")
    if lines and lines[-1] != b"":
        lines = lines[:-1]   # torn tail: the kill landed mid-write
    for line in lines:
        if not line:
            continue
        try:
            rec = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            continue   # a torn interior line: the last one of a killed
            #            generation, followed by a resume's
        kind = rec.get("kind")
        if kind == "begin" and meta is None:
            meta = rec
        elif kind in ("done", "shed") and "pos" in rec:
            # firacheck: allow[HOST-SYNC] rec is a parsed JSON journal record (host dict); no device value exists here
            terminal[int(rec["pos"])] = rec
    return meta, terminal


class ResumeError(ValueError):
    """A ``--resume`` admission failure (a missing or mismatched journal):
    the CLI turns exactly this, never another ValueError of the run, into
    its exit 2."""


def missing_journal_error(path: str) -> str:
    """The no-earlier-run message (the CLI's check before the dataset
    loads and :func:`resume_errors` both print it)."""
    return (f"--resume requires an existing serve journal at {path} "
            f"(no prior `cli serve` run to resume)")


def resume_errors(path: str, n: int, times, mix=None) -> List[str]:
    """Admission check of ``--resume``: the journal must exist, parse and
    pin the same request stream (count, arrival digest, request-mix
    digest). Named messages, CLI exit 2."""
    if not os.path.exists(path):
        return [missing_journal_error(path)]
    meta, _ = read_journal(path)
    if meta is None:
        return [f"--resume: journal {path} holds no begin record (the "
                f"prior run died before its first fsync — rerun without "
                f"--resume)"]
    errs: List[str] = []
    if int(meta.get("n", -1)) != int(n):
        errs.append(
            f"--resume: journal {path} was written for {meta.get('n')} "
            f"requests but this run offers {n} (a different request "
            f"stream cannot be resumed)")
    elif meta.get("times_digest") != times_digest(times):
        errs.append(
            f"--resume: journal {path} was written for a different "
            f"arrival schedule (digest mismatch — same trace/seed/rate "
            f"required)")
    elif meta.get("mix_digest") != (times_digest(mix)
                                    if mix is not None else None):
        errs.append(
            f"--resume: journal {path} was written for a different "
            f"request->sample mix (mix digest mismatch — recovered lines "
            f"and the re-served suffix would mix two request identities)")
    return errs


def _complete_lines(path: str) -> List[str]:
    """Every complete (newline-terminated) line of ``path``, split on
    b"\\n" alone: ``str.splitlines`` also splits at \\x0b, \\u2028 and
    others, which would shift positions inside a prediction line. A torn
    trailing fragment (a kill) is dropped."""
    with open(path, "rb") as f:
        raw = f.read()
    pieces = raw.split(b"\n")[:-1]   # what follows the last \n (torn or
    #                                  empty) is no complete line
    return [(p + b"\n").decode("utf-8") for p in pieces]


def recover_output(out_path: str, expected: int) -> Dict[int, str]:
    """Every finished line of an interrupted (or completed) run: the
    contiguous ``.partial`` prefix and the position-tagged
    ``.partial.tail`` (the ordered writer's crash pair), torn trailing
    lines dropped; a completed run recovers from its final file. Returns
    {position: line with its newline}, what the resumed writer writes
    again verbatim."""
    recovered: Dict[int, str] = {}
    partial = out_path + ".partial"
    tail = out_path + ".partial.tail"
    if os.path.exists(out_path) and not os.path.exists(partial):
        for pos, line in enumerate(_complete_lines(out_path)):
            if pos < expected:
                recovered[pos] = line
        return recovered
    if os.path.exists(partial):
        for pos, line in enumerate(_complete_lines(partial)):
            if pos < expected:
                recovered[pos] = line
    if os.path.exists(tail):
        for raw in _complete_lines(tail):
            if "\t" not in raw:
                continue   # a malformed tail record
            pos_s, line = raw.split("\t", 1)
            try:
                # firacheck: allow[HOST-SYNC] pos_s is a position tag parsed from the writer's on-disk tail spill; no device value exists here
                pos = int(pos_s)
            except ValueError:
                continue
            if 0 <= pos < expected:
                recovered[pos] = line
    return recovered


# --------------------------------------------------------------------------
# respawn policy
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicaSlot:
    """One replica lineage's health record: the original replica and every
    engine that replaced it share this budget and backoff."""

    origin: str
    device: Any = None
    respawns: int = 0            # replacement attempts spent (a spare
    #                              attach counts: the budget bounds
    #                              replacements)
    alive: bool = True
    retired_round: int = -1      # scheduler round of the last retirement
    retired_wall: float = -1.0   # its monotonic stamp (wall-clock gate)
    last_error: str = ""


class RecoveryManager:
    """The respawn policy over one engine fleet.

    It decides; ``fleet.replace_slot`` builds (it owns the spare pool, the
    device and the prewarm). Backoff is gated in scheduler rounds
    (``retired_round + min(attempt, 5)``, deterministic on the virtual
    clock) or, on the wall clock, in wall seconds on the shared curve
    (:func:`respawn_backoff_s`): gated, never slept, so the serve loop
    keeps stepping the survivors."""

    def __init__(self, fleet, cfg: FiraConfig, *, wall_clock: bool = False):
        self.fleet = fleet
        self.max_respawns = int(cfg.max_respawns)
        self.backoff_base = float(cfg.respawn_backoff_s)
        self.wall_clock = bool(wall_clock)
        self.slots: Dict[str, ReplicaSlot] = {}
        # a spare attached to a lineage keeps its own tag; this map folds
        # its later death back onto the lineage's budget
        self._lineage: Dict[str, str] = {}
        for eng in fleet.engines:
            o = origin_of(eng.tag)
            self.slots[o] = ReplicaSlot(origin=o, device=eng.device)

    def _slot_of(self, eng) -> ReplicaSlot:
        o = self._lineage.get(eng.tag or "r0", origin_of(eng.tag))
        if o not in self.slots:
            self.slots[o] = ReplicaSlot(origin=o, device=eng.device)
        return self.slots[o]

    def note_retirement(self, eng, round_: int, error: str = "") -> None:
        """Record one retirement against the engine's lineage (its respawn
        clock starts here)."""
        s = self._slot_of(eng)
        s.alive = False
        s.retired_round = int(round_)
        # firacheck: allow[WALL-CLOCK] the respawn backoff is wall-gated BY DESIGN on wall-clock serves (crash-looping hardware backs off in real seconds); virtual replays gate on rounds instead (due() round branch), so no wall time reaches the virtual schedule
        s.retired_wall = time.monotonic()
        s.last_error = error

    def can_recover(self) -> bool:
        """True while a dead lineage has respawn budget left: the serve
        loop pauses admission on it instead of shedding the rest."""
        return any(not s.alive and s.respawns < self.max_respawns
                   for s in self.slots.values())

    def due(self, round_: int) -> List[ReplicaSlot]:
        """Dead lineages whose backoff has elapsed and whose budget is not
        spent, in origin order. On the virtual clock the gate is rounds
        (``min(attempt, 5)``); on the wall clock it is wall seconds alone,
        since rounds are step dispatches and stop while every replica is
        down."""
        out = []
        for o in sorted(self.slots):
            s = self.slots[o]
            if s.alive or s.respawns >= self.max_respawns:
                continue
            if self.wall_clock:
                # firacheck: allow[WALL-CLOCK] wall-gate branch runs ONLY under self.wall_clock (the wall-serve mode); the virtual-clock path below gates on rounds, so replay determinism is untouched
                age = time.monotonic() - s.retired_wall
                if (s.retired_wall >= 0
                        and age < respawn_backoff_s(s.respawns + 1,
                                                    self.backoff_base)):
                    continue
            else:
                wait = min(s.respawns + 1, _BACKOFF_CAP_ATTEMPTS)
                if round_ - s.retired_round < wait:
                    continue
            out.append(s)
        return out

    def respawn(self, slot: ReplicaSlot, round_: int):
        """One replacement attempt for ``slot``: a spare when the pool has
        one, else a fresh build on the lineage's device. Every attempt
        (success, spare or a build that raises) spends budget, so a
        builder that keeps failing exhausts it. Returns (engine,
        from_spare), or (None, False) on failure."""
        slot.respawns += 1
        try:
            eng, from_spare = self.fleet.replace_slot(slot.origin,
                                                      slot.device)
        except Exception as e:
            # firacheck: allow[HOST-SYNC] round_ is the serve loop's host round counter; no device value exists here
            slot.retired_round = int(round_)   # the backoff starts again
            # firacheck: allow[WALL-CLOCK] same wall-gated respawn backoff stamp as note_retirement (round-gated on virtual replays)
            slot.retired_wall = time.monotonic()
            slot.last_error = f"respawn failed: {type(e).__name__}: {e}"
            return None, False
        slot.alive = True
        if from_spare:
            self._lineage[eng.tag or "r0"] = slot.origin
        return eng, from_spare

    def heal_all(self) -> List:
        """Drain-mode healing (no scheduler rounds): respawn every dead
        lineage with budget left, at once, after its wall backoff. The
        sleep is fine here: the drain is batch work on one thread with no
        arrivals to starve. Returns the new engines (the fleet's loop adds
        them to its live list)."""
        new = []
        for o in sorted(self.slots):
            s = self.slots[o]
            while not s.alive and s.respawns < self.max_respawns:
                # firacheck: allow[SCHED-BLOCK] drain-mode heal: single-threaded batch work with no open-loop arrivals to starve (docstring above); the serve loop's _heal never sleeps — it gates in due()
                time.sleep(respawn_backoff_s(s.respawns + 1,
                                             self.backoff_base))
                eng, _sp = self.respawn(s, s.retired_round)
                if eng is not None:
                    new.append(eng)
        return new

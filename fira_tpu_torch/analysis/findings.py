"""Finding/severity types and the one output format (counterpart of
``fira_tpu/analysis/findings.py``).

Every rule reports through :class:`Finding`; the CLI renders
``file:line [RULE-ID] severity: message`` so editors, grep-based
baselines and the tests all parse one shape. The rule ids are the JAX
package's, none added: a waiver in the port must also parse under the
JAX analyzer, which rejects an id it does not know.
"""

from __future__ import annotations

import dataclasses
import enum


class Severity(enum.Enum):
    ERROR = "error"      # breaks a performance/correctness invariant
    WARNING = "warning"  # suspicious; heuristic or advisory

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str        # as given to the checker (kept relative for stable output)
    line: int        # 1-based
    rule: str        # e.g. "HOST-SYNC"
    severity: Severity
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line} [{self.rule}] "
                f"{self.severity}: {self.message}")


# Rules with no torch form: registered (a waiver naming one still parses)
# but never run; ``cli list-rules`` prints the reason.
NOT_CHECKED = {
    "DONATION": (
        "torch donates no buffers: a tensor passed to a step stays valid "
        "after it, so there is no donated-then-read hazard to find"),
}

# Rule registry: id -> one-line contract in its torch form
# (docs/ANALYSIS_TORCH.md holds the long form). Kept here so
# ``cli list-rules``, the engine's suppression validation and the docs
# cannot drift apart on the id set.
RULES = {
    "HOST-SYNC": (
        "host/device sync primitive (.item()/.cpu()/.numpy()/.tolist()/"
        ".to('cpu')/synchronize()/np.asarray/float()/int()/bool(), or an "
        ".any()/.all()/torch.equal result used as a truth value) inside a "
        "hot-loop region"),
    "RETRACE": (
        "a program (torch.cuda.CUDAGraph, torch.cuda.graph, torch.compile) "
        "built inside a loop body or a hot region: one capture or compile "
        "per iteration instead of one per run"),
    "DONATION": "not checked in the port: " + NOT_CHECKED["DONATION"],
    "PRNG-REUSE": (
        "a random draw from the global generator (torch.rand*/randint/"
        "randperm/bernoulli/multinomial/normal_ or np.random.<fn>) with "
        "no explicit generator= or Generator object"),
    "DISCARDED-AT": (
        "an out-of-place tensor update (index_put/scatter/masked_fill/"
        "index_fill/clamp ...) whose result is discarded as a bare "
        "statement, where the in-place `_` form was meant"),
    "GEOMETRY-DRIFT": (
        "a literal shape constant shadows the named geometry in config.py "
        "(210/30/25/280/160/650 must be referenced, not re-typed)"),
    "BAD-SUPPRESS": (
        "malformed or reason-less firacheck suppression comment (every "
        "waiver must name the invariant it waives)"),
    "PARSE-ERROR": (
        "file could not be read or parsed, so NONE of its invariants were "
        "checked — a gating error, not a skip"),
    # --- concurrency-race rules (rules_concurrency.py) ---
    "SHARED-MUT": (
        "a self._x attribute written under a lock in some methods but "
        "bare in others, or mutated bare from both a thread-entry method "
        "and a scheduler method — an unsynchronized cross-thread write"),
    "RETIRED-RECHECK": (
        "shared scheduling/guard state mutated after a dispatch/readback "
        "boundary without re-checking `retired` — an abandoned watchdog "
        "thread races the survivors (docs/FAULTS.md)"),
    "SCHED-BLOCK": (
        "uncancellable blocking primitive (time.sleep, .wait()/.result()/"
        ".join() without timeout, os.fsync) on a driver hot path outside "
        "the sanctioned clock/backoff/lifecycle helpers"),
    "WALL-CLOCK": (
        "raw wall-clock read (time.time/perf_counter/monotonic) in a "
        "module that schedules under make_clock, outside the *Clock "
        "classes — wall time leaking into virtual-clock replay"),
    "FLOAT-ORDER": (
        "float += accumulation iterating a settle-ordered dict/set in a "
        "threaded driver module — the aggregate depends on thread "
        "interleaving in the last ulp (sum in sorted order instead)"),
    # --- serving-contract lints (rules_contracts.py) ---
    "KNOB-VALIDATE": (
        "a config knob set from a CLI flag with no *_errors parse-time "
        "validator reading it and no constraining choices/type on the "
        "flag — a bad value becomes a mid-run traceback, not exit 2"),
    "FAULT-SITE": (
        "a fault-injection site string not registered in robust.faults."
        "SITES (or corrupt() on a site outside CORRUPT_SITES) — the spec "
        "parser rejects it, so the injection point can never be armed"),
    "DRIVER-REG": (
        "a module dispatching step programs (program_label, CUDA graphs, "
        "torch.compile) or driving engine/fleet steppables that is not "
        "registered in astutil._DRIVER_FILES, or a registered driver "
        "module not named in tests/test_torch_analysis.py"),
    # --- interprocedural rules (callgraph.py + dataflow.py) ---
    "RES-LEAK": (
        "a tracked resource (KV block grant, started Thread, executor "
        "pool, open() handle, Event wakeup) whose release a raising path "
        "can skip — no finally/with covers the window between acquire "
        "and release, traced through calls via the module call graph"),
    "DET-TAINT": (
        "a value carrying nondeterministic order (settle-order dict/set "
        "iteration, unsorted os.listdir, as_completed) flows into a "
        "byte-contract sink (OrderedStreamWriter, metrics/journal "
        "serialization, keyed digests, BLEU) — traced across calls"),
    "STATS-SCHEMA": (
        "a *Stats field the metrics summary() never serializes, a "
        "summary() read of undeclared state, or an EngineStats/"
        "FleetStats/ServeStats field not named under docs/ — the "
        "observability schema and its consumers drifting apart"),
}

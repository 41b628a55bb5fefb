"""Command-line entry point of the port (counterpart of ``fira_tpu/cli.py``):

- ``train`` fits the model with Adam, runs the dev gate, and writes
  ``<ckpt-dir>/best.pt`` (on a dev-BLEU improvement) and
  ``<ckpt-dir>/latest.pt`` (each epoch; a later call resumes from it).
  ``--mesh DPxTP`` trains over a (data, model) mesh of ranks, one a GPU
  (``parallel/mesh.py``; ``--device cpu`` runs gloo ranks on the CPU);
  the default puts every visible GPU on the data axis, so one card trains
  without a mesh. ``--seq-shards N`` runs the decoder's cross-attention as
  ring attention over groups of N consecutive ranks
  (``parallel/ring.py``), beside tensor parallelism too. A batch that
  does not divide the data axis, a mesh larger than the devices, or a
  ``seq_shards`` that does not divide the ranks exits 2;
- ``test`` beam-decodes the test split with ``<ckpt-dir>/best.pt`` (or,
  when dev BLEU never improved, the model in ``latest.pt``) and writes
  OUTPUT/output_fira;
- ``message <diff-file>`` prints the commit message of one unified diff:
  the diff is lexed, split into hunks and its AST graph extracted (the
  native astdiff library, built from source at first use into
  ``build/astdiff/``), then decoded with the batched beam on the same
  checkpoint ``test`` reads (ingest/service.py ``one_shot_message``); a
  missing target exits 2, a diff the ingest rejects exits 1;
- ``preprocess`` turns the raw ``difftoken.json``/``diffmark.json``
  streams of ``--data-dir`` into the corpus files (the six graph streams,
  ``diffatt.json``, both vocabularies) over ``--num-procs`` spawned
  workers, ``--shard-size`` commits a shard; it touches no device;
- ``serve`` serves the test split's samples as an open-loop request
  stream on the slot engine (serve/server.py), or on a fleet of
  ``--engine-replicas`` engines (parallel/fleet.py): Poisson arrivals at
  ``--serve-rate`` requests/s (seeded by the config's seed) or a replayed
  ``--serve-trace`` file, on the wall clock or ``--serve-clock virtual``
  (a deterministic unit a dispatch). It writes OUTPUT/output_fira (a shed
  request leaves an empty line; with nothing shed the bytes of ``test
  --engine``) and ``serve_metrics.json`` (p50/p99 TTFT and end-to-end
  latency, shed counts, the engine's stats, every request's record),
  atomically, with a ``.partial`` snapshot kept through the run. The
  prefix cache and in-flight dedup are on unless ``--prefix-cache off``.
  ``--input diffs --diff-trace PATH`` serves raw unified diffs instead
  (ingest/service.py ``serve_diffs``): each request is lexed, split into
  hunks, its AST graph extracted and encoded on the feeder workers
  (``--ingest-workers``), behind the whole-diff result cache and the hunk
  and lexer memos (``--ingest-cache``), the parse stage inline or on a
  spawned process pool (``--ingest-exec``); a malformed diff is shed with
  its error recorded. ``--inject-faults`` arms seeded faults at the ten
  wired sites, ``--dispatch-watchdog-s`` retires a replica whose dispatch
  outlives it (its requests go to the survivors; with none left the rest
  are shed with the reason), ``--robust-retries`` is the poisoned
  request's retry budget. ``--max-respawns`` replaces a retired replica
  (``--engine-spares`` prewarmed standbys attach first, after a backoff
  of ``--respawn-backoff-s``). ``serve --input graphs`` keeps a request
  journal, ``<out-dir>/output_fira.journal``: after a kill, ``--resume``
  serves only what the killed run did not finish and the file ends as
  the uninterrupted run's. ``--serve-tiers prefill-pool`` runs the
  prefills in ``--prefill-workers`` spawned processes on the same device
  (serve/disagg.py), which ship each request's artifacts into the
  engines' prefix caches (``--serve-artifact-budget-mb`` bounds the bytes
  in flight), with the same bytes.

``best.pt`` is a ``torch.save``d state_dict of ``FiraModel``
(``fira_tpu_torch.convert`` also makes one from a flax tree). The run is on
the CUDA card unless ``--device cpu`` is given; with no card it raises
instead of carrying on on the CPU. ``--dtype bfloat16`` computes in bf16
(training and decoding; parameters, Adam and checkpoints stay f32, so an
f32 ``best.pt`` decodes in bf16). ``--buckets auto`` pads each batch to
the smallest of a few geometries chosen from the split the command reads
(``train``: the train split; ``test``: the test split); ``--fused-steps
K`` runs K training steps from one stacked copy to the card and
``--accum-steps A`` makes one optimizer step from A batches. The beam
flags (``--beam-factored-topk``, ``--beam-early-exit``,
``--beam-log-space``) and the encoder flags (``--encoder-buffer``,
``--adjacency``, ``--typed-edges``, ``--sort-edges``) mean what the JAX
package's do. ``test --engine`` decodes through the slot-refill engine
(``--engine-slots``, ``--engine-prefill-depth``, ``--engine-harvest-every``;
its paged KV arena: ``--kv-paged``, ``--kv-block-size``,
``--kv-pool-blocks``; ``--engine-replicas N``, a fleet of N engines over
the fleet-total slots), per sample bitwise equal to the batched beam;
``--decode-tar-buckets`` lets decode buckets keep their own tar_len as a
generation budget; the serving tiers of ``test --engine`` and ``serve``:
``--spec-decode copy|draft`` with ``--spec-k K`` (speculative
draft-and-verify, decode/spec.py: the same bytes in fewer positions a
dispatch's worth of steps), ``--kv-dtype bf16`` (the KV arena in bf16)
and ``--serve-precision bf16|int8w`` (the decode weights quantized,
decode/quant.py), each refused without ``--engine`` and on ``train``; ``--perf production`` applies the JAX package's
production knob sets (``config.PRODUCTION_PERF_KNOBS`` and
``DECODE_PERF_KNOBS``: the engine with the cached, factored, early-exit
beam). A config the port does not run, or a bad knob, exits 2 with the
knob named. ``--seq-shards N`` on ``test``, ``message`` and ``serve``
builds the model with a one-process ring over the visible devices (every
card; one device under ``--device cpu``), as the JAX model builds its
ring mesh over its devices, and exits 2 when N does not divide them; a
cross-attention rides the ring where JAX's would (the full-prefix beam
and arena), and the cached beam's one-position queries stay dense, as in
JAX.

The tooling: ``--sanitize`` arms the runtime sanitizer
(analysis/sanitizer.py) for the process: NaN/Inf checks on every module
output and in the training backward (a hit raises ``FloatingPointError``
naming the module or backward function), the guard that raises
``RetraceError`` when a dispatch's input signature drifts after its
label's first, and the lock-discipline and leak checks. ``train
--profile-dir D`` writes a ``torch.profiler`` trace of steps 2-11 under D
(``*.pt.trace.json``). ``--synthetic N`` writes an N-commit synthetic
corpus into ``--data-dir`` first. ``--copy-head xla|pallas``,
``--rng-impl threefry|rbg`` and ``--backend torch`` take the JAX
package's choices: the card launches K1/K2 for either copy head, and the
rng impl is recorded in ``latest.pt`` (a resume under another is
refused). ``--sanitize`` and ``--profile-dir`` refuse a spawned mesh.

Example:
    python -m fira_tpu_torch.cli train --config fira-full --data-dir DataSet
    python -m fira_tpu_torch.cli test --config fira-full --data-dir DataSet
    python -m fira_tpu_torch.cli train --dtype bfloat16 --feeder-workers 2
    python -m fira_tpu_torch.cli train --buckets auto --fused-steps 2
    python -m fira_tpu_torch.cli test --beam-factored-topk --beam-early-exit
    python -m fira_tpu_torch.cli train --adjacency segment --typed-edges
    python -m fira_tpu_torch.cli test --engine --engine-slots 64
    python -m fira_tpu_torch.cli test --engine --engine-replicas 2
    python -m fira_tpu_torch.cli test --perf production
    python -m fira_tpu_torch.cli preprocess --data-dir DataSet --num-procs 8
    python -m fira_tpu_torch.cli message change.diff --config fira-full
    python -m fira_tpu_torch.cli serve --config fira-full --serve-rate 20
    python -m fira_tpu_torch.cli serve --input diffs --diff-trace reqs.trace
    python -m fira_tpu_torch.cli serve --engine-replicas 2 --max-respawns 1
    python -m fira_tpu_torch.cli serve --serve-rate 20 --resume
    python -m fira_tpu_torch.cli test --engine --spec-decode copy --spec-k 4
    python -m fira_tpu_torch.cli test --engine --kv-dtype bf16
    python -m fira_tpu_torch.cli serve --serve-rate 20 --serve-tiers prefill-pool
    python -m fira_tpu_torch.cli train --synthetic 512 --sanitize --profile-dir P
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

# torch is imported where it is used: ``preprocess``'s spawned workers
# import this module (the main module of ``python -m fira_tpu_torch.cli``)
# and need none of it


def _positive(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fira_tpu_torch", description=__doc__)
    p.add_argument("command", choices=["train", "test", "serve", "message",
                                       "preprocess"],
                   help="train: fit + dev-gate; test: beam-decode the test "
                        "split; serve: a long-lived server under open-loop "
                        "load on the test split; message: one-shot "
                        "diff-in/message-out on a single diff file; "
                        "preprocess: raw diffs -> DataSet/ corpus")
    p.add_argument("target", nargs="?", default=None,
                   help="message: the unified-diff file to generate a "
                        "commit message for (unused by other commands)")
    p.add_argument("--backend", default="torch", choices=["torch"],
                   help="compute backend (this package is the PyTorch/CUDA "
                        "port; the flag exists for CLI parity with the JAX "
                        "package's --backend jax)")
    p.add_argument("--config", default="fira-full",
                   help="named config: fira-tiny | fira-full | fira-large")
    p.add_argument("--ablation", default=None,
                   choices=["no_edit", "no_subtoken", "nothing"],
                   help="paper Table 3 ablations")
    p.add_argument("--data-dir", default="DataSet",
                   help="corpus directory (reference DataSet/ layout)")
    p.add_argument("--out-dir", default="OUTPUT")
    p.add_argument("--ckpt-dir", default=None,
                   help="default: <out-dir>/ckpt[_<ablation>]")
    p.add_argument("--epochs", type=int, default=None,
                   help="override config epoch count")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--test-batch-size", type=_positive, default=None)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore an existing latest checkpoint")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="generate an N-commit synthetic corpus into "
                        "--data-dir first (fixture / smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mesh", default=None, metavar="DPxTP",
                   help="train: device mesh, e.g. 4x1 (data x model); "
                        "default: all GPUs on the data axis (one card: no "
                        "mesh); with --device cpu, gloo ranks on the CPU")
    p.add_argument("--seq-shards", type=int, default=None, metavar="N",
                   help="ring-attention sequence parallelism: shard "
                        "decoder cross-attention K/V over N ranks of the "
                        "mesh (train) or N of the visible devices, driven "
                        "by one process (test/message/serve); 0/1 = "
                        "dense attention")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype override (params stay f32)")
    p.add_argument("--feeder-workers", type=int, default=None, metavar="N",
                   help="threads assembling batches ahead of the loop "
                        "(0: on the loop's thread); must be >= 0")
    p.add_argument("--fused-steps", type=int, default=None, metavar="K",
                   help="train: K steps from one stacked copy of K "
                        "same-geometry batches (1 = a step a batch); the "
                        "dev gate and the log line round to group edges")
    p.add_argument("--accum-steps", type=int, default=None, metavar="A",
                   help="train: one optimizer step from A micro-batches, "
                        "normalised over their summed token count (A=4 at "
                        "batch 170 is the reference's 4-GPU batch 680)")
    p.add_argument("--buckets", default=None, metavar="SPEC",
                   help="padding geometries: 'off' (default: every batch "
                        "at the full geometry), 'auto' (3 chosen from the "
                        "split's length histograms) or "
                        "'AST:EDGES:TAR[,AST:EDGES:TAR...]', each at most "
                        "the config's full values; each sample packs into "
                        "its smallest admissible bucket")
    p.add_argument("--beam-factored-topk", action="store_true",
                   help="test: beam candidates from per-side top-ks "
                        "(generation vocab + copy positions, gate-scaled) "
                        "instead of the assembled 25,020-way fused tensor "
                        "— token-exact")
    p.add_argument("--beam-early-exit", action="store_true",
                   help="test: stop the decode loop once every beam has "
                        "emitted EOS (+1 settling step) — bit-exact vs the "
                        "full tar_len scan")
    p.add_argument("--beam-log-space", action="store_true",
                   help="log-space beam accumulation instead of the "
                        "reference-compat probability space")
    p.add_argument("--encoder-buffer", default=None,
                   choices=["single", "split"],
                   help="encoder node buffer: one tensor (single, default) "
                        "or [diff] and [sub||ast] as two with column-slab "
                        "A.x bmms (split; dense adjacency only, equal up "
                        "to matmul reassociation)")
    p.add_argument("--adjacency", default=None, choices=["dense", "segment"],
                   help="GCN message passing: dense bmm (default) or "
                        "O(edges) COO gather/scatter-add")
    p.add_argument("--typed-edges", action="store_true",
                   help="learn one gain per edge family instead of the "
                        "reference's flattened untyped adjacency "
                        "(identical at init)")
    p.add_argument("--sort-edges", action="store_true",
                   help="sort each sample's COO edges by (sender, "
                        "receiver) on the host (the same results)")
    p.add_argument("--copy-head", default=None, choices=["xla", "pallas"],
                   help="pointer-score impl, the JAX package's choices "
                        "(recorded as copy_head_impl): either way the card "
                        "launches the hand-written CUDA kernels (K1 forward, "
                        "K2 backward) and the CPU runs their plain version")
    p.add_argument("--rng-impl", default=None, choices=["threefry", "rbg"],
                   help="dropout PRNG of the JAX package, recorded in the "
                        "checkpoint (a resume under another one is "
                        "refused); torch draws dropout from its own "
                        "generator either way")
    p.add_argument("--profile-dir", default=None,
                   help="train: write a torch.profiler trace of a "
                        "steady-state step window (steps 2-11) here: "
                        "*.pt.trace.json, for chrome://tracing, Perfetto or "
                        "TensorBoard")
    p.add_argument("--sanitize", action="store_true",
                   help="arm the runtime sanitizer (analysis.sanitizer): "
                        "NaN/Inf checks on every module output and in the "
                        "training backward, a guard that raises if a "
                        "program's input signature changes after its "
                        "warmup dispatch, and the lock-discipline and leak "
                        "checks. Debugging mode: each check syncs, so "
                        "throughput numbers are not meaningful")
    p.add_argument("--engine", action="store_true",
                   help="test: decode through the slot-refill engine "
                        "(decode/engine.py): settled slots are harvested "
                        "and refilled mid-flight; per sample bitwise equal "
                        "to the batched beam in every beam mode")
    p.add_argument("--engine-slots", type=_positive, default=None,
                   metavar="S",
                   help="test: engine slots (default --test-batch-size, "
                        "the batched beam's shapes)")
    p.add_argument("--engine-prefill-depth", type=_positive, default=None,
                   metavar="D",
                   help="test: prefilled chunks staged ahead of the "
                        "engine's refills (default 2)")
    p.add_argument("--engine-harvest-every", type=_positive, default=None,
                   metavar="R",
                   help="test: positions advanced a step dispatch before "
                        "the host harvests settled slots (default 4; the "
                        "output is the same for any R)")
    p.add_argument("--engine-replicas", type=_positive, default=None,
                   metavar="N",
                   help="test/serve: replicated slot-engine decode fleet "
                        "(parallel/fleet.py): N engine replicas, one a "
                        "device round-robin (on one card all share it), "
                        "pull chunks from one shared admission queue. "
                        "Output file bytes are invariant to N. A nonzero "
                        "--engine-slots is the fleet total and must "
                        "divide by N")
    p.add_argument("--spec-decode", default=None,
                   choices=["off", "copy", "draft"],
                   help="test/serve: speculative draft-and-verify decode "
                        "on the slot engine (decode/spec.py): a cheap "
                        "drafter proposes --spec-k tokens per live slot and "
                        "one verify dispatch scores them with the engine's "
                        "own step, accepting the longest matching prefix. "
                        "'copy' drafts from the copy-head distribution "
                        "alone (no decoder stack); 'draft' greedy-rolls the "
                        "full step. Output stays bit-exact vs plain engine "
                        "decode; default off. Requires --engine")
    p.add_argument("--spec-k", type=_positive, default=None, metavar="K",
                   help="test/serve: speculative draft length, tokens "
                        "proposed per slot per verify dispatch (default "
                        "4). Must leave room in the smallest declared "
                        "decode tar budget (validated at parse time, "
                        "exit 2). Output bytes do not depend on K")
    p.add_argument("--kv-dtype", default=None, choices=["f32", "bf16"],
                   help="test/serve: engine KV arena storage dtype "
                        "(decode/quant.py): 'bf16' stores the slot arena "
                        "(paged pool blocks and the unpaged arena alike) "
                        "in bfloat16, half the kv_bytes_per_slot, while "
                        "every read upcasts so attention math stays f32. "
                        "Output bytes within a tier stay a pure function "
                        "of the stream; quality vs f32 is measured, never "
                        "assumed. Default 'f32' is byte-identical to the "
                        "engine without tiers. Requires --engine")
    p.add_argument("--serve-precision", default=None,
                   choices=["f32", "bf16", "int8w"],
                   help="test/serve: decode weight tier (decode/quant.py): "
                        "the decode-only dispatches (step/draft/verify) run "
                        "on a quantized copy of the decoder, vocabulary "
                        "projection and copy-head weights: 'int8w' "
                        "per-channel symmetric int8 with f32 accumulate, "
                        "dequantized once a dispatch, 'bf16' a bfloat16 "
                        "cast; quantized once at engine build (and per "
                        "respawn/spare). Prefill and the f32 default stay "
                        "full precision. Requires --engine")
    p.add_argument("--kv-paged", default=None, choices=["on", "off"],
                   help="test: the engine's KV arena: a pool of blocks "
                        "behind per-slot block tables (on, default) or "
                        "whole-sequence stripes (off); bitwise equal")
    p.add_argument("--kv-block-size", type=int, default=None, metavar="B",
                   help="test: positions a paged block; must divide every "
                        "declared decode tar budget (0/unset: auto, the "
                        "largest common divisor <= 16)")
    p.add_argument("--kv-pool-blocks", type=int, default=None, metavar="P",
                   help="test: paged pool size in blocks; at least slots "
                        "x ceil(tar/block) on the smallest decode tar and "
                        "one largest-budget sample (0/unset: full "
                        "residency)")
    p.add_argument("--decode-tar-buckets", action="store_true",
                   help="test: decode buckets keep their own tar_len; a "
                        "sample packs into the smallest that fits its "
                        "reference message, and the engine caps its "
                        "generation (and its block reservation) there")
    p.add_argument("--perf", default=None, choices=["parity", "production"],
                   help="knob preset: 'production' applies the JAX "
                        "package's production sets (fused steps 8, sorted "
                        "edges, bf16 residual streams when computing in "
                        "bf16; the engine with the cached, factored, "
                        "early-exit beam); 'parity' (default) keeps the "
                        "reference's. Flags given override the preset")
    p.add_argument("--prefix-cache", default=None, choices=["on", "off"],
                   help="test/serve: the cross-request prefix cache and "
                        "in-flight dedup (decode/prefix_cache.py): a "
                        "byte-identical repeat seats from cached prefill "
                        "artifacts, one in flight coalesces onto the "
                        "existing seat; bitwise equal to 'off'. Default: "
                        "on for serve, off for test (engine path required)")
    p.add_argument("--prefix-cache-entries", type=int, default=None,
                   metavar="N",
                   help="prefix-cache LRU capacity in entries (default "
                        "256; >= 1 when the cache is on)")
    p.add_argument("--prefix-cache-bytes", type=int, default=None,
                   metavar="B",
                   help="prefix-cache host-memory budget in bytes (0: "
                        "unbounded, the entry cap the only bound; >= 0)")
    p.add_argument("--input", default="graphs", choices=["graphs", "diffs"],
                   help="serve: the request source: 'graphs' (default), "
                        "the test split's graph requests; 'diffs', raw "
                        "unified diffs from --diff-trace, each parsed, "
                        "lexed, split into hunks, its AST graph extracted "
                        "and encoded on the feeder workers (a malformed "
                        "one is shed with its error recorded); a "
                        "reconstructed corpus diff serves the graphs "
                        "path's line")
    p.add_argument("--diff-trace", default=None, metavar="PATH",
                   help="serve --input diffs: the requests, a file of "
                        "'#! request'-separated unified diffs or a "
                        "directory of .diff files served in sorted name "
                        "order (checked at parse time, exit 2); arrival "
                        "times still come from --serve-rate or "
                        "--serve-trace")
    p.add_argument("--ingest-workers", type=int, default=None, metavar="N",
                   help="serve --input diffs: feeder workers of the "
                        "ingest tasks (0/unset: --feeder-workers; >= 0)")
    p.add_argument("--ingest-truncate", default=None,
                   choices=["clip", "shed"],
                   help="serve --input diffs: an over-budget diff is "
                        "truncated to the config geometry, what was "
                        "dropped recorded ('clip', default), or shed with "
                        "its error recorded ('shed')")
    p.add_argument("--ingest-cache", default=None, choices=["on", "off"],
                   help="serve --input diffs: the ingest fast path "
                        "(default on): a byte-identical repeat of a raw "
                        "diff seats from an LRU of assembled payloads "
                        "(its ingest stamps replayed with `cached`), and "
                        "the AST stage is memoized per hunk; bitwise "
                        "equal to 'off'")
    p.add_argument("--ingest-cache-entries", type=int, default=None,
                   metavar="N",
                   help="whole-diff result-cache LRU capacity in payloads "
                        "(default 512; 0 = unbounded; >= 0)")
    p.add_argument("--ingest-cache-bytes", type=int, default=None,
                   metavar="B",
                   help="whole-diff result-cache host-memory budget in "
                        "bytes (0/unset: unbounded; >= 0)")
    p.add_argument("--ingest-exec", default=None,
                   choices=["thread", "process"],
                   help="serve --input diffs: the AST parse stage runs "
                        "inline on the feeder workers ('thread', default) "
                        "or on a spawned process pool of --ingest-workers "
                        "processes that import no torch ('process'); "
                        "bitwise equal either way")
    p.add_argument("--serve-rate", type=float, default=None, metavar="RPS",
                   help="serve: offered load in requests/s of the "
                        "open-loop Poisson generator; needed (> 0) unless "
                        "--serve-trace replays a schedule")
    p.add_argument("--serve-trace", default=None, metavar="PATH",
                   help="serve: replay this arrival-trace file (one "
                        "non-decreasing time a line, line i = test-split "
                        "position i; serve/arrivals.py)")
    p.add_argument("--serve-prefill-budget", type=int, default=None,
                   metavar="P",
                   help="serve: most prefill dispatches between two step "
                        "dispatches (default 1; >= 1 and <= the engine's "
                        "slots); more trades seated requests' tail latency "
                        "for admission throughput")
    p.add_argument("--serve-deadline-steps", type=int, default=None,
                   metavar="D",
                   help="serve: a request still queued after D step "
                        "dispatches is shed (recorded); 0 = none (default)")
    p.add_argument("--serve-queue-cap", type=int, default=None, metavar="Q",
                   help="serve: admission-queue bound; an arrival past Q "
                        "queued requests is shed on the spot (recorded); "
                        "0 = unbounded (default)")
    p.add_argument("--serve-tiers", default=None,
                   choices=["off", "prefill-pool"],
                   help="serve: tier topology (serve/disagg.py): 'off' "
                        "(default) is in-process serve; 'prefill-pool' "
                        "runs a pool of prefill worker processes on the "
                        "same device shipping seat-ready artifacts, so "
                        "decode replicas never dispatch a prefill. "
                        "Requires --prefix-cache on and the decode engine; "
                        "validated at parse time, exit 2")
    p.add_argument("--prefill-workers", type=int, default=None,
                   metavar="W",
                   help="serve: prefill-pool width, worker processes in "
                        "the prefill tier (each with its own model and "
                        "device context; output bytes do not depend on "
                        "W). Must be >= 1 (validated at parse time, "
                        "exit 2)")
    p.add_argument("--serve-artifact-budget-mb", type=int, default=None,
                   metavar="MB",
                   help="serve: prefill-tier backpressure: total artifact "
                        "bytes in flight stays under this budget, so a "
                        "fast prefill tier cannot exhaust host memory. "
                        "0 = unbounded; must be >= 0 (validated at parse "
                        "time, exit 2)")
    p.add_argument("--serve-clock", default="wall",
                   choices=["wall", "virtual"],
                   help="serve: 'wall' (default) paces arrivals in real "
                        "time, the latency measurement; 'virtual' advances "
                        "a deterministic unit a dispatch, the replay mode")
    p.add_argument("--resume", action="store_true",
                   help="serve: resume a killed run from its request "
                        "journal (<out>/output_fira*.journal) and the "
                        "ordered writer's crash pair: only the positions "
                        "not finished are served again, and the final "
                        "file is the uninterrupted run's. Needs the "
                        "journal of an earlier serve with the same "
                        "trace/seed/rate (checked at parse time, exit 2)")
    p.add_argument("--inject-faults", default=None, metavar="SPEC",
                   help="seeded fault injection: 'site:kind:rate:seed[,...]'"
                        " (sites wired: feeder.assemble, feeder.device_put, "
                        "ingest.parse, ingest.cache, engine.prefill, "
                        "engine.step, engine.harvest, fleet.replica, "
                        "serve.admit, cache.lookup, disagg.transport, "
                        "disagg.worker; kinds: raise | hang | "
                        "corrupt); "
                        "deterministic given the seed; off by default")
    p.add_argument("--dispatch-watchdog-s", type=float, default=None,
                   metavar="S",
                   help="per-dispatch wall-clock watchdog: a serve dispatch "
                        "outliving S seconds is abandoned and the replica "
                        "retired; a train dev gate outliving it is skipped "
                        "with a recorded warning. 0 = off (default)")
    p.add_argument("--robust-retries", type=int, default=None, metavar="N",
                   help="retries (with backoff) a request gets when its "
                        "assembly, admission or prefill raises, before it "
                        "is shed with its error (default 1; >= 0)")
    p.add_argument("--max-respawns", type=int, default=None, metavar="N",
                   help="self-healing fleet: replacement budget of each "
                        "replica lineage; a retired replica is respawned "
                        "(a fresh prewarmed engine on its device, or a "
                        "warm spare attached) up to N times before the "
                        "lineage stays retired. 0 = off (default, retire "
                        "and degrade); >= 0, exit 2 otherwise")
    p.add_argument("--engine-spares", type=int, default=None, metavar="N",
                   help="warm-spare pool: N engines built and prewarmed "
                        "up front, attached by a retirement instead of a "
                        "build mid-run; an attach counts against "
                        "--max-respawns (which must be >= 1); >= 0, exit "
                        "2 otherwise")
    p.add_argument("--respawn-backoff-s", type=float, default=None,
                   metavar="S",
                   help="respawn backoff base in wall seconds: a lineage "
                        "that keeps crashing waits the shared backoff "
                        "curve (linear in the attempt, capped at 5x) "
                        "scaled to S between replacements (default 0.25; "
                        "> 0, exit 2 otherwise)")
    p.add_argument("--shard-size", type=int, default=100,
                   help="preprocess: commits per worker shard (reference "
                        "each_num=100)")
    p.add_argument("--num-procs", type=int, default=None,
                   help="preprocess: worker processes (default: cpu count)")
    return p


def resolve_device(name: str) -> "torch.device":
    """The run's device. ``cuda`` without a card raises. On the card, f32
    matmuls and convolutions run in full f32 (no TF32), so results match
    the f32 reference."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def resolve_mesh(args):
    """``train``'s mesh: ``--mesh DPxTP`` over the GPUs (or ``DP * TP``
    CPU ranks under ``--device cpu``), by default every visible GPU on the
    data axis when there are several, else None. A bad spec or a mesh
    larger than the devices returns the message (the JAX package's
    words)."""
    import torch

    from fira_tpu_torch.parallel.mesh import make_mesh

    if args.mesh is None:
        n = torch.cuda.device_count() if args.device == "cuda" else 0
        return make_mesh(n_data=n) if n > 1 else None
    try:
        dp, tp = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        return f"--mesh {args.mesh!r} is not DPxTP (two integers)"
    devices = ["cpu"] * (dp * tp) if args.device == "cpu" else None
    try:
        return make_mesh(n_data=dp, n_model=tp, devices=devices)
    except ValueError as e:
        return f"--mesh {args.mesh}: {e}"


def _load_var_maps(data_dir: str) -> Optional[List[dict]]:
    path = os.path.join(data_dir, "variable.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def resolve_buckets(spec: str, cfg, split):
    """``--buckets`` for ``cfg`` (with its vocabulary sizes) and the split
    the command reads: a table of (ast, edges, tar) tuples, () for 'off',
    or a message naming the bad entry."""
    from fira_tpu_torch.data import buckets as buckets_lib

    if spec == "off":
        return ()
    if spec == "auto":
        return buckets_lib.choose_buckets(split, cfg)
    entries = []
    for entry in spec.split(","):
        fields = entry.split(":")
        if len(fields) != 3 or not all(f.strip().isdigit() for f in fields):
            return (f"--buckets entry {entry!r} is not AST:EDGES:TAR "
                    f"(three integers)")
        entries.append(tuple(int(f) for f in fields))
    table = tuple(entries)
    try:
        buckets_lib.bucket_table(cfg.replace(buckets=table))
    except ValueError as e:
        return f"--buckets invalid: {e}"
    return table


def resolve_config(args):
    """The run's config from the parsed flags: the named config and
    ablation, the ``--perf`` preset, then each flag given (a flag not
    given leaves the config's value)."""
    from fira_tpu_torch.config import (DECODE_PERF_KNOBS,
                                       PRODUCTION_PERF_KNOBS, apply_ablation,
                                       get_config)

    cfg = apply_ablation(get_config(args.config.replace("_", "-")),
                         args.ablation)
    if args.perf == "production":
        cfg = cfg.replace(**PRODUCTION_PERF_KNOBS, **DECODE_PERF_KNOBS)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.test_batch_size:
        cfg = cfg.replace(test_batch_size=args.test_batch_size)
    if args.dtype:
        cfg = cfg.replace(compute_dtype=args.dtype)
    if args.feeder_workers is not None:
        cfg = cfg.replace(feeder_workers=args.feeder_workers)
    if args.copy_head:
        cfg = cfg.replace(copy_head_impl=args.copy_head)
    if args.rng_impl is not None:
        cfg = cfg.replace(rng_impl=args.rng_impl)
    if args.fused_steps is not None:
        cfg = cfg.replace(fused_steps=args.fused_steps)
    if args.accum_steps is not None:
        cfg = cfg.replace(accum_steps=args.accum_steps)
    if args.seq_shards is not None:
        cfg = cfg.replace(seq_shards=args.seq_shards)
    for given, knob, value in (
            (args.beam_log_space, "beam_compat_prob_space", False),
            (args.beam_factored_topk, "beam_factored_topk", True),
            (args.beam_early_exit, "beam_early_exit", True),
            (args.typed_edges, "typed_edges", True),
            (args.sort_edges, "sort_edges", True),
            (args.encoder_buffer, "encoder_buffer", args.encoder_buffer),
            (args.adjacency, "adjacency_impl", args.adjacency),
            (args.engine, "decode_engine", True),
            (args.decode_tar_buckets, "decode_tar_buckets", True),
            (args.kv_paged, "engine_paged_kv", args.kv_paged == "on")):
        if given:
            cfg = cfg.replace(**{knob: value})
    for knob in ("engine_slots", "engine_prefill_depth",
                 "engine_harvest_every", "kv_block_size", "kv_pool_blocks",
                 "prefix_cache_entries", "prefix_cache_bytes", "serve_rate",
                 "serve_prefill_budget", "serve_deadline_steps",
                 "serve_queue_cap", "inject_faults",
                 "dispatch_watchdog_s", "robust_retries", "ingest_workers",
                 "ingest_truncate", "ingest_cache_entries",
                 "ingest_cache_bytes", "ingest_exec", "engine_replicas",
                 "max_respawns", "engine_spares", "respawn_backoff_s",
                 "spec_decode", "kv_dtype", "serve_precision",
                 "serve_tiers", "prefill_workers",
                 "serve_artifact_budget_mb"):
        if getattr(args, knob) is not None:
            cfg = cfg.replace(**{knob: getattr(args, knob)})
    if args.spec_k is not None:
        cfg = cfg.replace(engine_spec_k=args.spec_k)
    if args.ingest_cache is not None:
        cfg = cfg.replace(ingest_cache=args.ingest_cache == "on")
    # serve runs on the slot engine, with the prefix cache and in-flight
    # dedup on unless --prefix-cache off (the JAX CLI's defaults)
    if args.command == "serve":
        cfg = cfg.replace(decode_engine=True)
    if args.prefix_cache is not None or args.command == "serve":
        cfg = cfg.replace(prefix_cache=args.prefix_cache != "off")
    # an accum request drops a fused value the config carries, unless
    # --fused-steps pinned it (then the two conflict and exit 2 below)
    if (cfg.accum_steps > 1 and cfg.fused_steps > 1
            and args.fused_steps is None):
        cfg = cfg.replace(fused_steps=1)
    return cfg


def message_errors(cfg, target: Optional[str]) -> List[str]:
    """``cli message``'s parse-time refusals, in the JAX package's words:
    the ingest knobs, a missing target, one that is not a file."""
    from fira_tpu_torch.ingest.service import ingest_errors

    errs = ingest_errors(cfg, command="message")
    if not target:
        errs.append("message needs a diff file: cli message <diff-file>")
    elif not os.path.isfile(target):
        errs.append(f"message target {target}: not a readable file")
    return errs


def journal_path(args) -> str:
    """``cli serve``'s request journal, beside its output file."""
    from fira_tpu_torch.decode.runner import output_name

    return os.path.join(args.out_dir, output_name(args.ablation) + ".journal")


def serve_input_errors(args, cfg) -> List[str]:
    """``cli serve``'s parse-time refusals, before the dataset loads, in
    the JAX package's words: the request source and the ingest knobs; the
    respawn knobs and ``--resume`` on the raw-diff path (which keeps no
    journal and has no respawn wiring, in the JAX package too); a
    ``--resume`` with no journal of an earlier run."""
    from fira_tpu_torch.ingest.service import ingest_errors
    from fira_tpu_torch.robust.recovery import missing_journal_error

    errs = ingest_errors(cfg, input_mode=args.input,
                         diff_trace=args.diff_trace, command="serve")
    if args.input == "diffs" and (cfg.max_respawns > 0
                                  or cfg.engine_spares > 0):
        errs.append(
            "max_respawns/engine_spares support --input graphs only "
            "(the raw-diff serve path has no respawn wiring yet)")
    if args.resume:
        if args.input == "diffs":
            errs.append(
                "--resume supports --input graphs only (the raw-diff "
                "serve path keeps no request journal yet)")
        elif not os.path.exists(journal_path(args)):
            errs.append(missing_journal_error(journal_path(args)))
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.synthetic:
        from fira_tpu_torch.data.synthetic import write_corpus_dir

        os.makedirs(args.data_dir, exist_ok=True)
        write_corpus_dir(args.data_dir, n_commits=args.synthetic)
        print(f"synthetic corpus: {args.synthetic} commits -> {args.data_dir}")

    if args.command == "preprocess":
        # host work only: no config, no device
        from fira_tpu_torch.preprocess.pipeline import main as preprocess

        return preprocess(args)

    import torch

    from fira_tpu_torch.config import unsupported
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.decode.paging import paging_errors
    from fira_tpu_torch.decode.runner import output_name, run_test
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.train.state import CheckpointManager

    cfg = resolve_config(args)

    def refused(c) -> bool:
        """Print one line naming the knob a refusal; True if any."""
        from fira_tpu_torch.decode.quant import quant_errors
        from fira_tpu_torch.parallel.fleet import fleet_divisibility_errors
        from fira_tpu_torch.robust.recovery import recovery_errors

        errs = unsupported(c)
        if args.command == "train":
            # the training path refuses any serving tier outright
            errs += quant_errors(c, train=True)
        if c.decode_engine:
            errs += fleet_divisibility_errors(c)
        errs += paging_errors(c) + recovery_errors(c)
        if args.command != "train":
            # the decode commands' one-process ring spans the visible
            # devices (train checks its mesh's ranks)
            from fira_tpu_torch.parallel.mesh import seq_shards_errors
            from fira_tpu_torch.parallel.ring import visible_device_count

            errs += seq_shards_errors(c, visible_device_count(args.device))
        if args.command == "serve":
            from fira_tpu_torch.serve.disagg import disagg_errors
            from fira_tpu_torch.serve.server import serve_errors

            errs += serve_errors(c, trace=args.serve_trace is not None)
            errs += disagg_errors(c)
        errs = list(dict.fromkeys(errs))   # a check run twice prints once
        for e in errs:
            print(f"fira_tpu_torch: config error: {e}", file=sys.stderr)
        return bool(errs)

    if args.command == "serve":
        errs = serve_input_errors(args, cfg)
        for e in errs:
            print(f"parse-time validation: {e}", file=sys.stderr)
        if errs:
            return 2
    if refused(cfg):
        return 2
    if args.command == "message":
        # before the device and the dataset, as the JAX CLI checks them
        errs = message_errors(cfg, args.target)
        for e in errs:
            print(f"parse-time validation: {e}", file=sys.stderr)
        if errs:
            return 2
    mesh = None
    if args.command == "train":
        mesh = resolve_mesh(args)
        if isinstance(mesh, str):
            print(f"fira_tpu_torch: config error: {mesh}", file=sys.stderr)
            return 2
        if mesh is not None and mesh.world > 1 and (args.sanitize
                                                    or args.profile_dir):
            from fira_tpu_torch.train.loop import mesh_tooling_error

            print(f"fira_tpu_torch: config error: {mesh_tooling_error()}",
                  file=sys.stderr)
            return 2
    device = resolve_device(args.device)
    suffix = f"_{args.ablation}" if args.ablation else ""
    ckpt_dir = args.ckpt_dir or os.path.join(args.out_dir, f"ckpt{suffix}")
    # --sanitize: process-lifetime arming is right here and only here, the
    # process ending with the run (library callers use the restoring
    # sanitizer.sanitize() context manager)
    from fira_tpu_torch.analysis import sanitizer

    guard = sanitizer.arm(args.sanitize)

    def load_data():
        """The corpus, and the config with its vocabulary sizes and
        ``--buckets`` resolved (from the split the command reads: auto
        reads its length histograms), or an exit code."""
        dataset = FiraDataset(args.data_dir, cfg)
        if not args.buckets:
            return dataset, dataset.cfg
        split = dataset.splits["train" if args.command == "train" else "test"]
        table = resolve_buckets(args.buckets, dataset.cfg, split)
        if isinstance(table, str):
            print(f"fira_tpu_torch: config error: {table}", file=sys.stderr)
            return 2
        if table:
            print(f"buckets: {', '.join(f'{a}:{e}:{t}' for a, e, t in table)}"
                  f" (+ full fallback)")
        bcfg = dataset.cfg.replace(buckets=table)
        # the tar budgets the paged blocks must tile are known only now
        if refused(bcfg):
            return 2
        return dataset, bcfg

    if args.command == "train":
        from fira_tpu_torch.train.loop import train

        loaded = load_data()
        if not isinstance(loaded, tuple):
            return loaded
        dataset, cfg = loaded
        # mesh admission at parse time (exit 2, named-bucket messages),
        # not mid-epoch (the JAX CLI's contract)
        from fira_tpu_torch.parallel.mesh import layout_errors

        errs = layout_errors(cfg, mesh.n_data if mesh else 1,
                             mesh.n_model if mesh else 1)
        for e in errs:
            print(f"fira_tpu_torch: config error: {e}", file=sys.stderr)
        if errs:
            return 2
        result = train(dataset, cfg, device=device, mesh=mesh,
                       out_dir=args.out_dir, ckpt_dir=ckpt_dir,
                       epochs=args.epochs,
                       var_maps=_load_var_maps(args.data_dir),
                       resume=not args.no_resume,
                       profile_dir=args.profile_dir, guard=guard)
        print(f"best dev bleu: {result.best_bleu:.4f}  "
              f"throughput: {result.commits_per_sec:.1f} "
              f"commits/sec/chip  "
              f"feed_stall_frac: {result.feed_stall_frac:.3f}")
        if guard is not None:
            print(guard.summary())
        return 0

    ckpt = CheckpointManager(ckpt_dir)
    use_best = ckpt.has(CheckpointManager.BEST)
    if not use_best and not ckpt.has(CheckpointManager.LATEST):
        print(f"no checkpoint under {ckpt_dir}; train first", file=sys.stderr)
        return 1
    if use_best:
        state_dict = torch.load(ckpt.path(CheckpointManager.BEST),
                                map_location=device, weights_only=True)
    else:
        # the dev gate saves best only on strict improvement (reference
        # run_model.py:94-96), so a short run whose dev BLEU never left
        # 0.0 has no best yet: decode the latest state instead of refusing
        print("no best checkpoint (dev BLEU never improved); "
              "decoding the LATEST training state", file=sys.stderr)
        state_dict = ckpt.load_latest()["model"]

    loaded = load_data()
    if not isinstance(loaded, tuple):
        return loaded
    dataset, cfg = loaded
    model = FiraModel(cfg, device=device, dtype=cfg.compute_dtype)
    model.load_state_dict(state_dict)
    if args.command == "message":
        from fira_tpu_torch.ingest.difftext import DiffParseError
        from fira_tpu_torch.ingest.service import IngestError, one_shot_message

        try:
            with open(args.target) as f:
                text = f.read()
            print(one_shot_message(model, dataset.word_vocab,
                                   dataset.ast_change_vocab, cfg, text))
        except (DiffParseError, IngestError, UnicodeDecodeError,
                OSError) as e:
            # a request-content failure, named like every rejected input
            print(f"message: {args.target} rejected: {e}", file=sys.stderr)
            return 1
        return 0
    if args.command == "serve":
        return serve(args, model, dataset, cfg, guard)
    if cfg.decode_tar_buckets and cfg.buckets:
        from fira_tpu_torch.data.buckets import decode_table, geom_tag

        print(f"decode table: {', '.join(map(geom_tag, decode_table(cfg)))}")
    metrics = run_test(model, dataset, cfg, out_dir=args.out_dir,
                       ablation=args.ablation,
                       var_maps=_load_var_maps(args.data_dir), guard=guard)
    print(f"test sentence-bleu: {metrics['sentence_bleu']:.4f} "
          f"({int(metrics['n'])} commits) -> "
          f"{os.path.join(args.out_dir, output_name(args.ablation))}")
    if "engine" in metrics:
        print(f"engine: {json.dumps(metrics['engine'])}")
    if guard is not None:
        print(guard.summary())
    return 0


def serve(args, model, dataset, cfg, guard=None) -> int:
    """``cli serve`` after the checkpoint is loaded: the requests (the
    test split, or the ``--diff-trace`` diffs), the arrival times, the
    serving run, the summary lines."""
    from fira_tpu_torch.serve import poisson_times, read_trace, serve_split

    if args.input == "diffs":
        from fira_tpu_torch.ingest.difftext import read_diff_trace

        requests = read_diff_trace(args.diff_trace)
        n_req = len(requests)
    else:
        n_req = len(dataset.splits["test"])
    if args.serve_trace:
        times = read_trace(args.serve_trace)
        if len(times) > n_req:
            print(f"parse-time validation: --serve-trace has {len(times)} "
                  f"arrivals but the request source holds only {n_req} "
                  f"{'diffs' if args.input == 'diffs' else 'samples'}",
                  file=sys.stderr)
            return 2
    else:
        times = poisson_times(n_req, cfg.serve_rate, seed=cfg.seed)
    metrics_path = os.path.join(args.out_dir, "serve_metrics.json")
    if args.input == "diffs":
        from fira_tpu_torch.ingest.service import serve_diffs

        metrics = serve_diffs(model, dataset.word_vocab,
                              dataset.ast_change_vocab, cfg,
                              requests=requests[: len(times)],
                              arrival_times=times, out_dir=args.out_dir,
                              ablation=args.ablation,
                              clock=args.serve_clock,
                              metrics_path=metrics_path, guard=guard)
    else:
        from fira_tpu_torch.robust.recovery import ResumeError

        # every graphs run keeps a journal, so any run can be resumed
        try:
            metrics = serve_split(model, dataset, cfg, arrival_times=times,
                                  out_dir=args.out_dir,
                                  ablation=args.ablation,
                                  var_maps=_load_var_maps(args.data_dir),
                                  clock=args.serve_clock,
                                  metrics_path=metrics_path,
                                  journal_path=journal_path(args),
                                  resume=args.resume, guard=guard)
        except ResumeError as e:
            # the journal pins another request stream: exit 2, named
            print(f"parse-time validation: {e}", file=sys.stderr)
            return 2
    sv = metrics["serve"]
    resumed = (f", {sv['resumed']} resumed from journal"
               if sv.get("resumed") else "")
    print(f"serve: {sv['completed']}/{sv['offered']} completed "
          f"(shed {sv['shed_queue_full']} queue-full, "
          f"{sv['shed_deadline']} deadline, "
          f"{sv['shed_error']} error; "
          f"{sv['replica_retirements']} replica retirements, "
          f"{sv['respawns']} respawns{resumed})  "
          f"p50/p99 ttft {sv['p50_ttft_s']}/{sv['p99_ttft_s']} s  "
          f"p50/p99 e2e {sv['p50_e2e_s']}/{sv['p99_e2e_s']} s  "
          f"-> {metrics_path}")
    if "ingest" in sv:
        ing = sv["ingest"]
        print(f"ingest: {ing['requests_ingested']} requests "
              f"({ing['truncated']} truncated, {ing['degraded']} "
              f"degraded)  p50 ingest {ing['p50_total_s']} s  "
              f"ingest_stall_frac {ing['stall_frac']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

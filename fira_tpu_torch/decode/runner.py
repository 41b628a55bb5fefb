"""Test-split decoding loop (the reference's ``test()``,
run_model.py:187-380; counterpart of the JAX package's
``decode/runner.py``): decode every sample, pick the argmax-probability
beam, cook text, score in-loop sentence BLEU, and write one prediction
per line to OUTPUT/output_fira (ablations write their own suffixed
files).

The batches of ``buckets.output_plan`` (the decode table's sort-by-length
plan, data/buckets.py; with ``cfg.buckets = ()`` the split's sequential
chunks at the full geometry) come from a ``data.feeder.Feeder``
(``cfg.feeder_workers`` threads assemble them and queue their copies to
the device ahead of the beam, ``cfg.feeder_depth`` at most in flight).
Two decode paths, in the model's compute dtype, per sample bitwise equal:

- the batched beam the config selects (``beam.make_beam_search``), one
  call a batch;
- under ``cfg.decode_engine`` the slot-refill engine (decode/engine.py),
  which prefills the same batches and yields each sample as it settles;
  with ``cfg.engine_replicas`` > 1 the replicated fleet
  (parallel/fleet.py), whose Feeder leaves the batches on the host
  (``put=False``) for the claiming replica to copy at admission.
  The fault injector of ``cfg.inject_faults`` (robust/faults.py) goes to
  the engine and to its Feeder, whose retry budget is
  ``cfg.robust_retries``: transient assembly faults are absorbed, a fleet
  replica whose dispatch raises or outlives ``cfg.dispatch_watchdog_s``
  retires with its requests requeued onto the survivors (and is
  respawned under ``cfg.max_respawns``), and a fault nothing absorbs
  fails loudly, naming the sample.

Tokens come back to the host to be cooked into text, and lines stream to
disk in split order through the ordered writer (decode/stream.py), each
row at its ``_positions`` place.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from fira_tpu_torch.analysis.sanitizer import program_label
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import buckets as buckets_lib
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder, batch_to_device
from fira_tpu_torch.decode import engine as engine_lib
from fira_tpu_torch.decode import prefix_cache as prefix_cache_lib
from fira_tpu_torch.decode import quant
from fira_tpu_torch.decode.beam import make_beam_search
from fira_tpu_torch.decode.stream import OrderedStreamWriter
from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                        reference_words)
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust.faults import injector_from

def output_name(ablation: Optional[str]) -> str:
    """OUTPUT file naming per paper ablation (BASELINE.md rows)."""
    if ablation in (None, "", "none", "full"):
        return "output_fira"
    return f"output_fira_{ablation}"


def sample_emitter(writer, *, vocab, cfg: FiraConfig, bleu_by_pos: Dict,
                   n_total: int, var_maps=None, indices=None):
    """The per-sample tail: pick the argmax beam, cook text, score BLEU,
    de-anonymize, write at the sample's split position."""

    def emit(pos, host, row, tokens, probs):
        best = int(np.argmax(probs))             # run_model.py:351
        # firacheck: allow[HOST-SYNC] tokens is a host numpy row (the decode output boundary's copy); no device value exists here
        ids = tokens[best].tolist()
        # beam output ids are already copy-resolved at extension time
        hyp = cook_prediction(ids[1:], host["diff"][row],
                              host["sub_token"][row], vocab, cfg,
                              resolve=False)
        ref = reference_words(host["msg"][row], vocab)
        # keyed by position, summed in split order at the end
        bleu_by_pos[pos] = nltk_sentence_bleu([ref], hyp)
        n = len(bleu_by_pos)
        var_map = (var_maps[indices[pos]]
                   if var_maps is not None else None)
        writer.add(pos, " ".join(deanonymize(hyp, var_map)) + "\n")
        if n % 1000 == 0:
            writer.flush()
            print(f"decode: {n}/{n_total}", flush=True)

    return emit


def _stamped(task, namespace: bytes):
    """``task`` with its batch's ``_digests`` stamped (on the worker that
    runs it), its ``note`` kept."""
    def build():
        return prefix_cache_lib.stamp_digests(task(), namespace)
    if hasattr(task, "note"):
        build.note = task.note
    return build


def warm_batch(data, cfg: FiraConfig, geom) -> Dict:
    """An all-pad test batch at ``geom``, carrying its bucket tag under
    ``cfg.buckets`` (the prewarm's batch and each label's first
    signature)."""
    batch = make_batch(data, np.arange(0), cfg,
                       batch_size=cfg.test_batch_size, geom=geom)
    if cfg.buckets:
        batch["_tag"] = buckets_lib.geom_tag(geom)
    return batch


def run_test(model: FiraModel, dataset: FiraDataset,
             cfg: Optional[FiraConfig] = None, *,
             out_dir: str = "OUTPUT",
             ablation: Optional[str] = None,
             var_maps: Optional[List[Dict[str, str]]] = None,
             split: str = "test",
             engine_slots: Optional[int] = None,
             refill_order: str = "fifo", faults=None,
             guard=None) -> Dict[str, float]:
    """Decode ``split`` on the model's device, in the model's compute
    dtype, with the batched beam ``cfg`` selects or, under
    ``cfg.decode_engine``, the slot engine (``engine_slots`` slots,
    default the config's; ``refill_order`` "fifo" or "lifo"). Returns mean
    sentence BLEU, the sample count and the path, and with the engine its
    ``stats.summary()`` under "engine". ``faults``: an armed
    ``robust.faults.FaultInjector`` (None resolves from
    ``cfg.inject_faults``; "" keeps it off). ``guard``: an armed
    ``analysis.sanitizer.CompileGuard``: every beam call (``beam_search``)
    or engine dispatch is stepped under its label, and under
    ``cfg.buckets`` the family is declared and each member's signature
    taken from an all-pad batch at its geometry first (the JAX package's
    pre-warm), so a later batch outside it raises."""
    cfg = cfg or dataset.cfg
    if faults is None:
        faults = injector_from(cfg)
    device = next(model.parameters()).device
    data = dataset.splits[split]
    vocab = dataset.word_vocab
    indices = dataset.split_indices[split]

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, output_name(ablation))
    bleu_by_pos: Dict[int, float] = {}
    n_total = len(data)
    model.eval()
    plan = buckets_lib.output_plan(data, cfg)
    tasks = buckets_lib.bucketed_assembly_tasks(
        data, plan, cfg, batch_size=cfg.test_batch_size)
    if cfg.decode_engine and cfg.prefix_cache:
        # content digests stamped on the feeder workers, in the serving
        # tier's namespace, so a cached f32 artifact never seats a bf16
        # slot (decode/quant.py)
        tasks = (_stamped(t, quant.tier_namespace(cfg)) for t in tasks)
    eng = None
    n_rep = max(1, int(cfg.engine_replicas))
    if cfg.decode_engine:
        if n_rep > 1:
            from fira_tpu_torch.parallel import fleet as fleet_lib

            eng = fleet_lib.EngineFleet(model, cfg, replicas=n_rep,
                                        slots=engine_slots, faults=faults,
                                        guard=guard)
        else:
            eng = engine_lib.SlotEngine(model, cfg, slots=engine_slots,
                                        faults=faults, guard=guard)
        # one all-pad batch a geometry of the plan: the kernels' build and
        # first launch, outside the decode
        geoms = list(dict.fromkeys(g for _, g in plan))
        if cfg.buckets and guard is not None:
            guard.declare(eng.labels(geoms))
        eng.prewarm([warm_batch(data, cfg, g) for g in geoms])
        if cfg.buckets:
            print(f"decode buckets: {len(geoms)} engine prefill programs "
                  f"pre-warmed"
                  f"{f' x {n_rep} replicas' if n_rep > 1 else ''} "
                  f"({', '.join(buckets_lib.geom_tag(g) for g in geoms)})",
                  flush=True)
    # the fleet's Feeder leaves batches on the host: admission copies each
    # to the device of the replica that claims it
    robust = (dict(retries=max(0, cfg.robust_retries), faults=faults,
                   put=n_rep == 1)
              if eng is not None else {})
    with OrderedStreamWriter(out_path, expected=n_total) as writer, \
            Feeder(tasks, num_workers=cfg.feeder_workers,
                   depth=cfg.feeder_depth, device=device, **robust) as feed:
        emit = sample_emitter(writer, vocab=vocab, cfg=cfg,
                              bleu_by_pos=bleu_by_pos, n_total=n_total,
                              var_maps=var_maps, indices=indices)
        if eng is not None:
            for it in eng.run(feed, refill_order=refill_order):
                emit(it.position, it.host, it.row, it.tokens, it.probs)
        else:
            search = make_beam_search(model, cfg)
            if cfg.buckets and guard is not None:
                geoms = list(dict.fromkeys(g for _, g in plan))
                guard.declare(program_label(
                    "beam_search", buckets_lib.geom_tag(g)) for g in geoms)
                for g in geoms:
                    guard.step(program_label("beam_search",
                                             buckets_lib.geom_tag(g)),
                               batch_to_device(warm_batch(data, cfg, g),
                                               device))
            for item in feed:
                tokens, probs = search(item.device)
                if guard is not None:
                    guard.step(program_label(
                        "beam_search",
                        item.host["_tag"] if cfg.buckets else None),
                        item.device)
                # firacheck: allow[HOST-SYNC] per-batch output collection IS the decode boundary: beams must reach the host to be cooked into text
                tokens, probs = tokens.cpu().numpy(), probs.cpu().numpy()
                positions = item.host["_positions"]
                for i in np.flatnonzero(item.host["valid"]):
                    # firacheck: allow[HOST-SYNC] _positions is a host-only numpy field (feeder strips it from the wire); no device value exists here
                    emit(int(positions[i]), item.host, i, tokens[i],
                         probs[i])
    n = len(bleu_by_pos)
    total_bleu = sum(bleu_by_pos[p] for p in sorted(bleu_by_pos))
    out = {"sentence_bleu": total_bleu / max(n, 1), "n": float(n),
           "output_path": out_path}
    if eng is not None:
        out["engine"] = eng.stats.summary()
    return out  # type: ignore[return-value]

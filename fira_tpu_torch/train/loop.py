"""Training driver: epochs, the dev gate, checkpoints, throughput
(counterpart of ``fira_tpu/train/loop.py`` on its per-step path).

Reference semantics kept, as in the JAX package:

- the gate cadence ``epoch >= dev_start_epoch and batch_idx %
  dev_every_batches == 0``, checked before the batch's step
  (run_model.py:89);
- the gating metric is NLTK method-2 sentence BLEU on teacher-forced greedy
  output (run_model.py:171);
- ``best.pt`` on strict improvement (run_model.py:94-96), and one
  ``train_process`` line per gate (run_model.py:92);
- ``latest.pt`` at every epoch's end, and resume from it.

Each epoch walks the JAX loop's batch order through one scheduler,
``data.grouping.grouped_plan`` (``seed=cfg.seed``, the epoch's
permutation): one step a batch by default; under ``cfg.buckets`` each
batch at its bucket's geometry (data/buckets.py); under ``fused_steps=K``
groups of K same-geometry batches run as K steps from one stacked copy
(``step.multi_step``; tails a step at a time); under ``accum_steps=A``
groups of A micro-batches make one optimizer step (``step.accum_step``;
tails padded with all-invalid micro-batches). The gate and the log line
count real batches, as the JAX loop: an item of k real batches starting at
batch ``idx`` is due a gate when ``[idx, idx + k)`` holds a multiple of
``dev_every_batches``, and the gate runs before the item. The dev gate
packs with the decode table (``tar_len`` full) and restores split order.

The batches come from a ``data.feeder.Feeder`` with ``cfg.feeder_workers``
threads, which assemble them and queue their copies to the device ahead
of the step (``feeder_workers=0``: on the loop's own thread); the dev gate
takes its batches the same way. The model computes in
``cfg.compute_dtype``; parameters, Adam and checkpoints stay f32. The host
waits for the device only at the 10-batch loss line, at a dev gate and at
an epoch's end; throughput is measured between those points, with the dev
gates and the checkpoint writes excluded, and the first interval (the
kernels' first build and launch) dropped, as the JAX loop's
``Meter(warmup=1)``. The feed share is the time the loop waited for the
Feeder, over the measured wall.

With ``cfg.dispatch_watchdog_s`` > 0 each dev gate runs under the dispatch
watchdog (robust/watchdog.py), as the JAX loop's does: a gate that
outlives it is abandoned (its cancel event set, which ``run_dev`` polls a
batch) and skipped with a recorded warning, and training goes on without
that gate's checkpoint decision.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import buckets as buckets_lib
from fira_tpu_torch.data import grouping
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, Feeder
from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                        reference_words)
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
from fira_tpu_torch.robust.watchdog import WatchdogTimeout, run_with_watchdog
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.state import (CheckpointManager, TrainState,
                                        init_state)


@dataclasses.dataclass
class TrainLog:
    """Per-gate and per-interval console/file logging (run_model.py:92,114)."""

    out_dir: str

    def __post_init__(self):
        os.makedirs(self.out_dir, exist_ok=True)

    def gate(self, epoch: int, batch: int, bleu: float, better: bool) -> None:
        line = (f"epoch: {epoch} batch: {batch} dev bleu: {bleu} "
                f"is better: {better}\n")
        with open(os.path.join(self.out_dir, "train_process"), "a") as f:
            f.write(line)

    def dev_output(self, text: str) -> None:
        with open(os.path.join(self.out_dir, "dev_output"), "w") as f:
            f.write(text)

    def console(self, msg: str) -> None:
        print(msg, flush=True)


def run_dev(model, dataset: FiraDataset, cfg: FiraConfig,
            var_maps: Optional[List[Dict[str, str]]] = None,
            split: str = "valid", plan=None, cancel=None) -> tuple:
    """Greedy teacher-forced validation (run_model.py:118-184). Returns
    (mean sentence BLEU over the split, dev_output text in split order,
    number of dev batches). The batches follow ``plan`` (default
    ``buckets.decode_plan``; it never changes, so ``train`` computes it
    once) and each line goes to its ``_positions`` place. ``cancel``: a
    zero-arg callable polled a batch, the watchdog's cooperative kill
    switch: a gate the watchdog abandoned stops launching instead of
    racing the training it was abandoned for."""
    data = dataset.splits[split]
    vocab = dataset.word_vocab
    indices = dataset.split_indices[split]
    device = next(model.parameters()).device
    bs = cfg.test_batch_size
    total_bleu = 0.0
    lines: List[tuple] = []   # (split position, line)
    if plan is None:
        plan = buckets_lib.decode_plan(data, cfg)
    tasks = buckets_lib.bucketed_assembly_tasks(data, plan, cfg,
                                                batch_size=bs)
    with Feeder(tasks, num_workers=cfg.feeder_workers,
                depth=cfg.feeder_depth, device=device,
                fields=TRAIN_FIELDS) as feed:
        for item in feed:
            if cancel is not None and cancel():
                raise WatchdogTimeout(
                    "dev gate abandoned by the dispatch watchdog")
            host = item.host
            ids = step_lib.dev_step(model, item.device).cpu().numpy()
            for i in np.flatnonzero(host["valid"]):
                hyp = cook_prediction(ids[i].tolist(), host["diff"][i],
                                      host["sub_token"][i], vocab, cfg)
                ref = reference_words(host["msg"][i], vocab)
                b = nltk_sentence_bleu([ref], hyp)
                total_bleu += b
                pos = int(host["_positions"][i])
                var_map = (var_maps[indices[pos]]
                           if var_maps is not None else None)
                lines.append(
                    (pos, " ".join(deanonymize(hyp, var_map)) + f",{b}"))
    lines.sort(key=lambda r: r[0])
    return (total_bleu / max(len(data), 1),
            "\n".join(line for _, line in lines) + "\n", len(plan))


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_bleu: float
    epochs_run: int
    # over the measured train intervals (dev gates, checkpoint writes and
    # the first interval out)
    commits_per_sec: float
    steps_per_sec: float
    # share of the measured train wall clock the loop waited for the
    # Feeder's next batch (with feeder_workers=0: assembling it and
    # queueing its copies)
    feed_stall_frac: float
    steps: int          # optimizer steps taken by this call
    gates: int          # dev gates run
    dev_batches: int    # dev_predict calls over all gates
    dev_seconds: float  # wall clock of the gates
    # one loss an optimizer step (a fused group gives one a step, an
    # accumulated group one for the group)
    losses: List[float] = dataclasses.field(default_factory=list)
    # the training Feeders' stats summed over the epochs: batches,
    # feed_stall_s, queue_depth_mean/min, num_workers, depth
    feeder: Dict[str, float] = dataclasses.field(default_factory=dict)
    # forward and backward passes (a step each; under accum_steps every
    # micro-batch, the tails' all-invalid ones too) and stacked groups run
    batches: int = 0
    groups: int = 0
    # conditions a reader of this run's numbers must know (printed too)
    warnings: List[str] = dataclasses.field(default_factory=list)


class _Meter:
    """Train throughput between sync points; ``warmup`` leading intervals
    are dropped, and time between ``pause`` and ``start`` is not counted."""

    def __init__(self, warmup: int = 1):
        self.warmup, self.seen = warmup, 0
        self.seconds = self.feed_seconds = 0.0
        self.commits = self.steps = 0
        self.last: Optional[float] = None

    def start(self) -> None:
        self.last = time.perf_counter()

    def pause(self) -> None:
        self.last = None

    def tick(self, commits: int, steps: int, feed_s: float) -> None:
        now = time.perf_counter()
        if self.last is not None and steps:
            self.seen += 1
            if self.seen > self.warmup:
                self.seconds += now - self.last
                self.commits += commits
                self.steps += steps
                self.feed_seconds += feed_s
        self.last = now


def train(dataset: FiraDataset, cfg: Optional[FiraConfig] = None, *,
          device="cuda",
          out_dir: str = "OUTPUT",
          ckpt_dir: Optional[str] = None,
          epochs: Optional[int] = None,
          var_maps: Optional[List[Dict[str, str]]] = None,
          resume: bool = True,
          state: Optional[TrainState] = None) -> TrainResult:
    """Full training run on ``device`` (``cuda`` by default, which raises
    without a card; ``cpu`` on request). ``state``: a prepared
    ``TrainState`` to train (default: ``init_state(cfg, device)``, the
    model at ``cfg.compute_dtype``)."""
    from fira_tpu_torch.cli import resolve_device

    cfg = cfg or dataset.cfg   # dataset.cfg has the vocabulary sizes
    fused, accum = cfg.fused_steps, cfg.accum_steps
    if fused > 1 and accum > 1:
        raise ValueError("fused_steps and accum_steps are mutually "
                         "exclusive (one stacks steps, one accumulates "
                         "gradients); set at most one > 1")
    device = resolve_device(device) if isinstance(device, str) else device
    log = TrainLog(out_dir)
    if state is None:
        state = init_state(cfg, device)
    model, optimizer, gen = state.model, state.optimizer, state.generator

    ckpt = CheckpointManager(ckpt_dir or os.path.join(out_dir, "ckpt"))
    best_bleu, start_epoch = 0.0, 0
    if resume and ckpt.has(CheckpointManager.LATEST):
        meta = ckpt.restore_latest(state)
        best_bleu, start_epoch = meta["best_bleu"], meta["epoch"]
        log.console(f"resumed at epoch {start_epoch}, best dev bleu "
                    f"{best_bleu:.4f}")

    n_epochs = epochs if epochs is not None else cfg.epochs
    train_split = dataset.splits["train"]
    bs = cfg.batch_size
    warnings: List[str] = []
    if fused > 1 and cfg.dev_every_batches % fused:
        # gates due inside a group collapse to one, run before the group
        w = (f"fused_steps={fused} does not divide dev_every_batches="
             f"{cfg.dev_every_batches}: dev gates due inside a fused group "
             f"collapse to one gate run before the group (weights up to "
             f"{fused - 1} steps stale); pick K dividing the cadence")
        log.console(f"WARNING: {w}")
        warnings.append(w)
    group_size = fused if fused > 1 else accum
    # the bucket table (the full geometry alone when cfg.buckets = ()),
    # the train split's assignment and the dev plan are the same every
    # epoch: computed once
    table = buckets_lib.bucket_table(cfg)
    assignment = (buckets_lib.assign_buckets(
        buckets_lib.sample_extents(train_split, cfg), table)
        if len(table) > 1 else None)
    eval_plan = buckets_lib.decode_plan(dataset.splits["valid"], cfg)

    meter = _Meter(warmup=1)
    pending = {"commits": 0, "steps": 0, "feed_s": 0.0}
    losses: List[torch.Tensor] = []
    gates = dev_batches = steps = batches = groups = 0
    dev_seconds = 0.0
    feed_totals = {"batches": 0.0, "feed_stall_s": 0.0,
                   "queue_depth_sum": 0.0, "queue_depth_min": float("inf")}

    def sync_tick(loss: Optional[torch.Tensor]) -> None:
        if loss is not None:
            loss.item()   # waits for the queued steps
        meter.tick(pending["commits"], pending["steps"], pending["feed_s"])
        pending.update(commits=0, steps=0, feed_s=0.0)

    meter.start()
    for epoch in range(start_epoch, n_epochs):
        last = None
        idx = 0   # batch index of the next item's first batch
        plan = grouping.grouped_plan(
            train_split, cfg, batch_size=bs, group_size=group_size,
            accum=accum > 1, shuffle=True, seed=cfg.seed, epoch=epoch,
            table=table, assignment=assignment)
        with Feeder(grouping.grouped_assembly_tasks(
                        train_split, plan, cfg, batch_size=bs),
                    num_workers=cfg.feeder_workers, depth=cfg.feeder_depth,
                    device=device, fields=TRAIN_FIELDS) as feed:
            for entry in plan:
                # real batches in the item: only a group's last chunk can
                # be partial, and the accum tail's pad micro-batches are
                # not batches of the split
                k = len(entry.chunks)
                if (epoch >= cfg.dev_start_epoch
                        and (-idx) % cfg.dev_every_batches < k):
                    sync_tick(last)
                    meter.pause()   # dev time is not train time
                    t0 = time.perf_counter()
                    gate_cancel = threading.Event()
                    try:
                        bleu, text, n_batches = run_with_watchdog(
                            lambda: run_dev(model, dataset, cfg, var_maps,
                                            plan=eval_plan,
                                            cancel=gate_cancel.is_set),
                            float(cfg.dispatch_watchdog_s),
                            label=f"dev_gate[e{epoch}b{idx}]",
                            cancel_event=gate_cancel)
                    except WatchdogTimeout as e:
                        w = (f"dev gate at epoch {epoch} batch {idx} "
                             f"skipped: {e}; training continues without "
                             f"this gate's checkpoint decision")
                        log.console(f"WARNING: {w}")
                        warnings.append(w)
                    else:
                        better = bleu > best_bleu
                        log.gate(epoch, idx, bleu, better)
                        if better:
                            best_bleu = bleu
                            ckpt.save_best(model)
                            log.dev_output(text)
                        gates += 1
                        dev_batches += n_batches
                    dev_seconds += time.perf_counter() - t0
                    meter.start()

                # fetched after the gate, inside the measured interval (the
                # workers keep assembling while a gate runs)
                item = next(feed)
                pending["feed_s"] += item.stall_s
                if entry.pad_to == 1:
                    loss = step_lib.train_step(model, optimizer, item.device,
                                               gen)[None]
                elif accum > 1:
                    loss = step_lib.accum_step(model, optimizer, item.device,
                                               gen)[None]
                else:
                    loss = step_lib.multi_step(model, optimizer, item.device,
                                               gen)
                n_steps = len(loss)
                state.step += n_steps
                steps += n_steps
                batches += entry.pad_to
                groups += entry.pad_to > 1
                losses.append(loss)
                last = loss[-1]
                pending["commits"] += item.n_valid
                pending["steps"] += n_steps
                if (-idx) % 10 < k:
                    sync_tick(last)
                    log.console(f"epoch: {epoch} batch: {idx} loss: "
                                f"{last.item():.4f}")
                idx += k
            fs = feed.stats()
        feed_totals["batches"] += fs["batches"]
        feed_totals["feed_stall_s"] += fs["feed_stall_s"]
        feed_totals["queue_depth_sum"] += fs["queue_depth_sum"]
        if fs["batches"]:
            feed_totals["queue_depth_min"] = min(
                feed_totals["queue_depth_min"], fs["queue_depth_min"])
        if last is not None:
            sync_tick(last)
        ckpt.save_latest(state, best_bleu=best_bleu, epoch=epoch + 1)
        meter.start()   # the checkpoint write is not train time

    secs = meter.seconds
    cps = meter.commits / secs if secs else 0.0
    n_fed = feed_totals["batches"]
    feeder = {
        "batches": n_fed,
        "feed_stall_s": feed_totals["feed_stall_s"],
        "queue_depth_mean": (feed_totals["queue_depth_sum"] / n_fed
                             if n_fed else 0.0),
        "queue_depth_min": feed_totals["queue_depth_min"] if n_fed else 0.0,
        "num_workers": float(cfg.feeder_workers),
        "depth": float(cfg.feeder_depth),
    }
    if meter.steps:
        log.console(f"throughput: {cps:.2f} commits/sec over {meter.steps} "
                    f"measured steps ({1e3 * secs / meter.steps:.1f} "
                    f"ms/step), dev gates {dev_seconds:.2f} s | feeder "
                    f"queue depth mean {feeder['queue_depth_mean']:.1f} min "
                    f"{feeder['queue_depth_min']:.0f} (workers "
                    f"{cfg.feeder_workers}, depth {cfg.feeder_depth})")
    return TrainResult(
        state=state, best_bleu=best_bleu,
        epochs_run=max(0, n_epochs - start_epoch),
        commits_per_sec=cps,
        steps_per_sec=meter.steps / secs if secs else 0.0,
        feed_stall_frac=min(1.0, meter.feed_seconds / secs) if secs else 0.0,
        steps=steps, gates=gates, dev_batches=dev_batches,
        dev_seconds=dev_seconds,
        losses=(torch.cat(losses).cpu().tolist() if losses else []),
        feeder=feeder, batches=batches, groups=groups, warnings=warnings)

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

Each epoch walks the JAX loop's batch order with buckets off and one step
per batch: ``epoch_index_chunks(n, shuffle=True, seed=cfg.seed,
epoch=epoch)``. A plain loop: the host assembles each batch and copies it
from pinned memory without blocking, then queues the step. The host waits
for the device only at the 10-batch loss line, at a dev gate and at an
epoch's end; throughput is measured between those points, with the dev
gates and the checkpoint writes excluded, and the first interval (the
kernels' first build and launch) dropped, as the JAX loop's
``Meter(warmup=1)``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.batching import epoch_index_chunks, make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.decode.runner import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                        reference_words)
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
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
            split: str = "valid") -> tuple:
    """Greedy teacher-forced validation (run_model.py:118-184). Returns
    (mean sentence BLEU over the split, dev_output text in split order,
    number of dev batches)."""
    data = dataset.splits[split]
    vocab = dataset.word_vocab
    indices = dataset.split_indices[split]
    device = next(model.parameters()).device
    bs = cfg.test_batch_size
    total_bleu = 0.0
    lines: List[str] = []
    chunks = epoch_index_chunks(len(data), cfg, batch_size=bs)
    for chunk in chunks:
        host = make_batch(data, chunk, cfg, batch_size=bs)
        ids = step_lib.dev_step(
            model, batch_to_device(host, device, TRAIN_FIELDS)).cpu().numpy()
        for i in np.flatnonzero(host["valid"]):
            hyp = cook_prediction(ids[i].tolist(), host["diff"][i],
                                  host["sub_token"][i], vocab, cfg)
            ref = reference_words(host["msg"][i], vocab)
            b = nltk_sentence_bleu([ref], hyp)
            total_bleu += b
            pos = len(lines)
            var_map = (var_maps[indices[pos]]
                       if var_maps is not None else None)
            lines.append(" ".join(deanonymize(hyp, var_map)) + f",{b}")
    return (total_bleu / max(len(data), 1), "\n".join(lines) + "\n",
            len(chunks))


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    best_bleu: float
    epochs_run: int
    # over the measured train intervals (dev gates, checkpoint writes and
    # the first interval out)
    commits_per_sec: float
    steps_per_sec: float
    # share of the measured train wall clock the host spent assembling
    # batches and queueing their copies to the device
    feed_stall_frac: float
    steps: int          # optimizer steps taken by this call
    gates: int          # dev gates run
    dev_batches: int    # dev_predict calls over all gates
    dev_seconds: float  # wall clock of the gates
    losses: List[float] = dataclasses.field(default_factory=list)


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
    ``TrainState`` to train (default: ``init_state(cfg, device)``)."""
    from fira_tpu_torch.cli import resolve_device

    cfg = cfg or dataset.cfg   # dataset.cfg has the vocabulary sizes
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
    meter = _Meter(warmup=1)
    pending = {"commits": 0, "steps": 0, "feed_s": 0.0}
    losses: List[torch.Tensor] = []
    gates = dev_batches = steps = 0
    dev_seconds = 0.0

    def sync_tick(loss: Optional[torch.Tensor]) -> None:
        if loss is not None:
            loss.item()   # waits for the queued steps
        meter.tick(pending["commits"], pending["steps"], pending["feed_s"])
        pending.update(commits=0, steps=0, feed_s=0.0)

    meter.start()
    for epoch in range(start_epoch, n_epochs):
        last = None
        chunks = epoch_index_chunks(len(train_split), cfg, shuffle=True,
                                    seed=cfg.seed, epoch=epoch)
        for idx, chunk in enumerate(chunks):
            if (epoch >= cfg.dev_start_epoch
                    and idx % cfg.dev_every_batches == 0):
                sync_tick(last)
                meter.pause()   # dev time is not train time
                t0 = time.perf_counter()
                bleu, text, n_batches = run_dev(model, dataset, cfg, var_maps)
                better = bleu > best_bleu
                log.gate(epoch, idx, bleu, better)
                if better:
                    best_bleu = bleu
                    ckpt.save_best(model)
                    log.dev_output(text)
                dev_seconds += time.perf_counter() - t0
                gates += 1
                dev_batches += n_batches
                meter.start()

            t0 = time.perf_counter()
            host = make_batch(train_split, chunk, cfg,
                              batch_size=cfg.batch_size)
            batch = batch_to_device(host, device, TRAIN_FIELDS)
            pending["feed_s"] += time.perf_counter() - t0
            last = step_lib.train_step(model, optimizer, batch, gen)
            state.step += 1
            steps += 1
            losses.append(last)
            pending["commits"] += len(chunk)
            pending["steps"] += 1
            if idx % 10 == 0:
                sync_tick(last)
                log.console(f"epoch: {epoch} batch: {idx} loss: "
                            f"{last.item():.4f}")
        if last is not None:
            sync_tick(last)
        ckpt.save_latest(state, best_bleu=best_bleu, epoch=epoch + 1)
        meter.start()   # the checkpoint write is not train time

    secs = meter.seconds
    cps = meter.commits / secs if secs else 0.0
    if meter.steps:
        log.console(f"throughput: {cps:.2f} commits/sec over {meter.steps} "
                    f"measured steps ({1e3 * secs / meter.steps:.1f} "
                    f"ms/step), dev gates {dev_seconds:.2f} s")
    return TrainResult(
        state=state, best_bleu=best_bleu,
        epochs_run=max(0, n_epochs - start_epoch),
        commits_per_sec=cps,
        steps_per_sec=meter.steps / secs if secs else 0.0,
        feed_stall_frac=min(1.0, meter.feed_seconds / secs) if secs else 0.0,
        steps=steps, gates=gates, dev_batches=dev_batches,
        dev_seconds=dev_seconds,
        losses=(torch.stack(losses).cpu().tolist() if losses else []))

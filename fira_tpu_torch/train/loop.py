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
Feeder, over the measured wall. The closing ``throughput:`` line adds the
run's readings of the program's spans and counters (utils/profiling.py;
the dev gates' Feeder records into a recorder of its own): the median
host issue of a forward, a backward and an optimizer step, the Feeder's
median wait and put, the pool's use (assembly seconds over the workers,
or the loop's own thread, times the run's whole wall from before its
first Feeder to after its last, dev gates and checkpoint writes
included, since the workers assemble through them) and the share of
batches not ready when the loop asked (``TrainResult.step_ms`` and
``TrainResult.feeder``).

With ``cfg.dispatch_watchdog_s`` > 0 each dev gate runs under the dispatch
watchdog (robust/watchdog.py), as the JAX loop's does: a gate that
outlives it is abandoned (its cancel event set, which ``run_dev`` polls a
batch) and skipped with a recorded warning, and training goes on without
that gate's checkpoint decision.

``train(..., mesh=...)`` trains over a (data, model) mesh
(``parallel/mesh.py``). ``mesh.layout_errors`` raises ValueError before
anything is built. An unbound mesh of one rank joins a one-rank process
group in this process; one of more ranks spawns them (``RankPool``), each
running this loop on its device with its rows of every batch, and returns
rank 0's result with the whole state gathered onto ``mesh.devices[0]``.
Under a mesh the log lines, checkpoints and the dev gate come from rank 0:
rank 0 decodes on the gathered weights (on the training model itself when
it is whole, with dense attention otherwise: a ring needs every rank in
step), the others wait for the gate's decision, which rank 0 broadcasts,
and commits/s is divided by the ranks, as the JAX loop divides by its
chips.

The tooling, as the JAX loop's: ``profile_dir`` traces a window of steps
with ``torch.profiler`` (utils/profiling.py), and ``guard`` (the runtime
sanitizer's, analysis/sanitizer.py) is stepped at every dispatch under
the JAX package's labels. Without them the step runs as it would.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fira_tpu_torch.analysis.sanitizer import program_label
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import buckets as buckets_lib
from fira_tpu_torch.data import grouping
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, Feeder, batch_to_device
from fira_tpu_torch.parallel.mesh import feed_shardings
from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                        reference_words)
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
from fira_tpu_torch.robust.watchdog import WatchdogTimeout, run_with_watchdog
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.state import (CheckpointManager, TrainState,
                                        init_state)
from fira_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainLog:
    """Per-gate and per-interval console/file logging (run_model.py:92,114).
    Silent where ``writes`` is False (a mesh rank other than 0)."""

    out_dir: str
    writes: bool = True

    def __post_init__(self):
        if self.writes:
            os.makedirs(self.out_dir, exist_ok=True)

    def gate(self, epoch: int, batch: int, bleu: float, better: bool) -> None:
        if not self.writes:
            return
        line = (f"epoch: {epoch} batch: {batch} dev bleu: {bleu} "
                f"is better: {better}\n")
        with open(os.path.join(self.out_dir, "train_process"), "a") as f:
            f.write(line)

    def dev_output(self, text: str) -> None:
        if self.writes:
            with open(os.path.join(self.out_dir, "dev_output"), "w") as f:
                f.write(text)

    def console(self, msg: str) -> None:
        if self.writes:
            print(msg, flush=True)


def run_dev(model, dataset: FiraDataset, cfg: FiraConfig,
            var_maps: Optional[List[Dict[str, str]]] = None,
            split: str = "valid", plan=None, cancel=None,
            guard=None) -> tuple:
    """Greedy teacher-forced validation (run_model.py:118-184). Returns
    (mean sentence BLEU over the split, dev_output text in split order,
    number of dev batches). The batches follow ``plan`` (default
    ``buckets.decode_plan``; it never changes, so ``train`` computes it
    once) and each line goes to its ``_positions`` place. ``cancel``: a
    zero-arg callable polled a batch, the watchdog's cooperative kill
    switch: a gate the watchdog abandoned stops launching instead of
    racing the training it was abandoned for. ``guard``: an armed
    ``analysis.sanitizer.CompileGuard``, stepped a batch under
    ``dev_step`` (with its bucket tag under ``cfg.buckets``)."""
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
    # a recorder of its own: the gate's batches stay out of the training
    # path's spans, which the train loop reads over its run
    with Feeder(tasks, num_workers=cfg.feeder_workers,
                depth=cfg.feeder_depth, device=device,
                fields=TRAIN_FIELDS, recorder=profiling.Recorder()) as feed:
        for item in feed:
            if cancel is not None and cancel():
                raise WatchdogTimeout(
                    "dev gate abandoned by the dispatch watchdog")
            host = item.host
            # firacheck: allow[HOST-SYNC] dev gate IS a designated sync boundary: teacher-forced ids must reach the host for BLEU scoring (README Design notes)
            ids = step_lib.dev_step(model, item.device).cpu().numpy()
            if guard is not None:
                guard.step(program_label("dev_step", _tag(host, cfg)),
                           item.device)
            for i in np.flatnonzero(host["valid"]):
                # firacheck: allow[HOST-SYNC] ids is the host copy the dev gate boundary above made; no device value exists here
                hyp = cook_prediction(ids[i].tolist(), host["diff"][i],
                                      host["sub_token"][i], vocab, cfg)
                ref = reference_words(host["msg"][i], vocab)
                b = nltk_sentence_bleu([ref], hyp)
                total_bleu += b
                # firacheck: allow[HOST-SYNC] _positions is a host-only numpy field (feeder strips it from the wire); no device value exists here
                pos = int(host["_positions"][i])
                var_map = (var_maps[indices[pos]]
                           if var_maps is not None else None)
                lines.append(
                    (pos, " ".join(deanonymize(hyp, var_map)) + f",{b}"))
    lines.sort(key=lambda r: r[0])
    return (total_bleu / max(len(data), 1),
            "\n".join(line for _, line in lines) + "\n", len(plan))


def _tag(host: Dict, cfg: FiraConfig) -> Optional[str]:
    """A batch's label tag: its bucket's under ``cfg.buckets``, none at the
    single full geometry (the JAX package's labels)."""
    return host.get("_tag") if cfg.buckets else None


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
    # feed_stall_s, queue_depth_mean/min, num_workers, depth; and from the
    # spans and counters of this run: wait_ms and put_ms (medians),
    # pool_use and not_ready_frac
    feeder: Dict[str, float] = dataclasses.field(default_factory=dict)
    # median host issue of a forward, a backward and an optimizer step
    # (ms; "forward", "backward", "optimizer"), from this run's spans
    step_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # forward and backward passes (a step each; under accum_steps every
    # micro-batch, the tails' all-invalid ones too) and stacked groups run
    batches: int = 0
    groups: int = 0
    # conditions a reader of this run's numbers must know (printed too)
    warnings: List[str] = dataclasses.field(default_factory=list)


def _cpu(x):
    """Tensors of a nested state (dicts, lists) moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_cpu(v) for v in x]
    return x


def train_rank(mesh, dataset: FiraDataset, cfg: FiraConfig,
               kw: Dict) -> Optional[Dict]:
    """One spawned rank of a mesh run (``RankPool``): :func:`train` on the
    bound ``mesh``, then the state gathered; rank 0 returns the result's
    fields and the whole state on the CPU."""
    from fira_tpu_torch.train.state import full_state

    result = train(dataset, cfg, mesh=mesh, **kw)
    full = full_state(result.state, mesh)
    if mesh.rank != 0:
        return None
    out = {f.name: getattr(result, f.name)
           for f in dataclasses.fields(result) if f.name != "state"}
    out.update(_cpu(full), generator=result.state.generator.get_state(),
               step=result.state.step)
    return out


def _launch(dataset: FiraDataset, cfg: FiraConfig, mesh, kw: Dict
            ) -> TrainResult:
    """Run :func:`train` on the ranks of an unbound ``mesh``: in this
    process for one rank, else spawned (a ``FileStore`` under the run's
    ``out_dir``), rank 0's state rebuilt on ``mesh.devices[0]``."""
    import torch.distributed as dist

    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.parallel.mesh import RankPool, init_single
    from fira_tpu_torch.train.state import make_optimizer

    store_dir = os.path.join(kw["out_dir"], ".mesh")
    if mesh.world == 1:
        bound = init_single(mesh, store_dir)
        try:
            return train(dataset, cfg, mesh=bound, **kw)
        finally:
            dist.destroy_process_group()
    with RankPool(mesh, store_dir) as pool:
        res = pool.run(train_rank, dataset, cfg, kw)[0]
    dev = torch.device(mesh.devices[0])
    model = FiraModel(cfg.replace(seq_shards=0), device=dev)
    model.load_state_dict(res.pop("model"))
    optimizer = make_optimizer(model, cfg)
    optimizer.load_state_dict(res.pop("optimizer"))
    gen = torch.Generator(device=dev)
    gen.set_state(res.pop("generator"))
    state = TrainState(model=model, optimizer=optimizer, generator=gen,
                       step=res.pop("step"))
    return TrainResult(state=state, **res)


def train(dataset: FiraDataset, cfg: Optional[FiraConfig] = None, *,
          device="cuda",
          mesh=None,
          out_dir: str = "OUTPUT",
          ckpt_dir: Optional[str] = None,
          epochs: Optional[int] = None,
          var_maps: Optional[List[Dict[str, str]]] = None,
          resume: bool = True,
          state: Optional[TrainState] = None,
          profile_dir: Optional[str] = None,
          profile_steps: int = 10,
          guard=None) -> TrainResult:
    """Full training run on ``device`` (``cuda`` by default, which raises
    without a card; ``cpu`` on request). ``state``: a prepared
    ``TrainState`` to train (default: ``init_state(cfg, device)``, the
    model at ``cfg.compute_dtype``). ``mesh``: a ``parallel.mesh.Mesh``
    (``make_mesh``) to train over, on its own devices (module docstring).

    ``profile_dir``: a ``torch.profiler`` trace of the steps
    ``range(2, 2 + profile_steps)`` (the first steps build and first launch
    the kernels) is written there (utils/profiling.py), each step named
    ``train_step#<step>``; the real program is profiled, a grouped
    dispatch's range spanning its whole group. ``guard``: an armed
    ``analysis.sanitizer.CompileGuard``: each dispatch is stepped under its
    label (``train_step``, ``grouped_step`` with its group size,
    ``dev_step``; bucket tags under ``cfg.buckets``, whose family is then
    declared and each member's signature taken from an all-pad batch first,
    as the JAX loop's pre-warm). The CLI arms it with ``--sanitize``;
    library callers use ``with sanitizer.sanitize() as guard:``. Neither
    crosses to spawned mesh ranks."""
    from fira_tpu_torch.cli import resolve_device

    cfg = cfg or dataset.cfg   # dataset.cfg has the vocabulary sizes
    fused, accum = cfg.fused_steps, cfg.accum_steps
    if fused > 1 and accum > 1:
        raise ValueError("fused_steps and accum_steps are mutually "
                         "exclusive (one stacks steps, one accumulates "
                         "gradients); set at most one > 1")
    if mesh is not None:
        from fira_tpu_torch.parallel.mesh import ALL, layout_errors

        # before anything is built, as the JAX loop (the CLI runs the same
        # check at parse time and exits 2)
        errs = layout_errors(cfg, mesh.n_data, mesh.n_model)
        if errs:
            raise ValueError("mesh divisibility: " + "; ".join(errs))
        if not mesh.bound:
            if state is not None:
                raise ValueError("train(mesh=...) builds each rank's state; "
                                 "a prepared state cannot cross to the ranks")
            if mesh.world > 1 and (guard is not None or profile_dir):
                raise ValueError(mesh_tooling_error())
            return _launch(dataset, cfg, dataclasses.replace(
                mesh, seq_shards=cfg.seq_shards), dict(
                    out_dir=out_dir, ckpt_dir=ckpt_dir, epochs=epochs,
                    var_maps=var_maps, resume=resume))
        device = mesh.device
    device = resolve_device(device) if isinstance(device, str) else device
    lead = mesh is None or mesh.rank == 0
    log = TrainLog(out_dir, writes=lead)
    if state is None:
        state = init_state(cfg, device, mesh=mesh)
    model, optimizer, gen = state.model, state.optimizer, state.generator
    gate_model = None   # rank 0's dense decoder of the gathered weights

    ckpt = CheckpointManager(ckpt_dir or os.path.join(out_dir, "ckpt"), mesh)
    best_bleu, start_epoch = 0.0, 0
    if resume and ckpt.has(CheckpointManager.LATEST):
        meta = ckpt.restore_latest(state, expect_rng_impl=cfg.rng_impl)
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

    if (fused > 1 or accum > 1) and profile_dir:
        # the real grouped program is profiled (profiled numbers must be
        # the production path's); each step range then spans one dispatch
        w = (f"profiling the grouped program: each step annotation spans "
             f"one {'fused' if fused > 1 else 'accum'} dispatch of "
             f"{fused if fused > 1 else accum} stacked batches")
        log.console(w)
        warnings.append(w)
    if cfg.buckets and guard is not None:
        _prewarm_guard(guard, dataset, cfg, table, group_size,
                       warm_per_step=group_size == 1 or fused > 1,
                       device=device, sharding=feed_shardings(mesh))

    # the JAX loop's Meter(warmup=1); the optimizer steps of its measured
    # intervals are counted beside it
    meter = profiling.Meter(warmup=1)
    spans_mark = profiling.mark()   # this run's spans and counters: since
    run_t0 = time.perf_counter()    # the pool's use is over the whole run
    measured_steps = 0
    pending = {"commits": 0, "steps": 0, "feed_s": 0.0}
    losses: List[torch.Tensor] = []
    gates = dev_batches = steps = batches = groups = 0
    dev_seconds = 0.0
    feed_totals = {"batches": 0.0, "feed_stall_s": 0.0,
                   "queue_depth_sum": 0.0, "queue_depth_min": float("inf")}

    def sync_tick(loss: Optional[torch.Tensor]) -> None:
        """Close the interval since the last sync; an empty interval just
        restarts the clock."""
        nonlocal measured_steps
        if loss is not None:
            # firacheck: allow[HOST-SYNC] THE designated sync helper: every hot-loop sync funnels through here so the boundaries stay enumerable (called only at meter/log/epoch edges)
            loss.item()   # waits for the queued steps
        if pending["steps"]:
            if meter.tick(pending["commits"], stall_s=pending["feed_s"]):
                measured_steps += pending["steps"]
        else:
            meter.start()
        pending.update(commits=0, steps=0, feed_s=0.0)

    profile_window = range(2, 2 + profile_steps) if profile_dir else range(0)
    prof = None   # the torch.profiler of the window, while it runs
    profile_done = False
    global_step = 0

    meter.start()
    try:
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
                        device=device, fields=TRAIN_FIELDS,
                        sharding=feed_shardings(mesh)) as feed:
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
                        # rank 0 decodes; under a mesh the others wait for its
                        # decision: (ran, bleu, dev batches)
                        decision = None
                        eval_model = model
                        if mesh is not None and (mesh.n_model > 1
                                                 or cfg.seq_shards > 1):
                            from fira_tpu_torch.parallel.mesh import gather_state

                            whole = gather_state(model.state_dict(), mesh)
                            if lead:
                                if gate_model is None:
                                    from fira_tpu_torch.model.model import (
                                        FiraModel)

                                    gate_model = FiraModel(
                                        cfg.replace(seq_shards=0), device=device)
                                gate_model.load_state_dict(whole)
                                eval_model = gate_model
                        if lead:
                            try:
                                bleu, text, n_batches = run_with_watchdog(
                                    lambda: run_dev(eval_model, dataset, cfg,
                                                    var_maps, plan=eval_plan,
                                                    cancel=gate_cancel.is_set,
                                                    guard=guard),
                                    # firacheck: allow[HOST-SYNC] config scalar, not a device value; the gate is already a designated sync boundary
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
                                decision = (bleu, n_batches)
                        if mesh is not None:
                            from fira_tpu_torch.parallel.mesh import broadcast_

                            sent = torch.tensor(
                                [decision is not None] + list(decision or (0, 0)),
                                dtype=torch.float64, device=device)
                            broadcast_(sent, mesh.group(ALL), 0)
                            # firacheck: allow[HOST-SYNC] the dev gate's decision, broadcast from the lead rank: a designated sync boundary once a gate (every mesh rank must take the same checkpoint decision)
                            if sent[0].item():
                                # firacheck: allow[HOST-SYNC] same dev-gate decision broadcast as the line above
                                decision = (sent[1].item(), int(sent[2].item()))
                        if decision is not None:
                            bleu, n_batches = decision
                            better = bleu > best_bleu
                            log.gate(epoch, idx, bleu, better)
                            if better:
                                best_bleu = bleu
                                ckpt.save_best(model)
                                log.dev_output(text if lead else "")
                            gates += 1
                            dev_batches += n_batches
                        dev_seconds += time.perf_counter() - t0
                        meter.start()

                    # fetched after the gate, inside the measured interval (the
                    # workers keep assembling while a gate runs)
                    item = next(feed)
                    pending["feed_s"] += item.stall_s
                    if (profile_window and prof is None and not profile_done
                            and global_step >= profile_window[0]):
                        prof = profiling.begin_trace(profile_dir)
                    if prof is None:
                        loss = _dispatch(entry, accum, model, optimizer,
                                         item.device, gen, mesh)
                    else:
                        with profiling.step_annotation(global_step):
                            loss = _dispatch(entry, accum, model, optimizer,
                                             item.device, gen, mesh)
                    stacked = entry.pad_to > 1
                    if guard is not None:
                        guard.step(program_label(
                            "grouped_step" if stacked else "train_step",
                            _tag(item.host, cfg),
                            group_size if stacked else 1), item.device)
                    n_steps = len(loss)
                    global_step += n_steps
                    state.step += n_steps
                    steps += n_steps
                    batches += entry.pad_to
                    groups += entry.pad_to > 1
                    losses.append(loss)
                    last = loss[-1]
                    pending["commits"] += item.n_valid
                    pending["steps"] += n_steps
                    if prof is not None and global_step > profile_window[-1]:
                        sync_tick(last)
                        profiling.end_trace(prof)
                        prof = None
                        profile_done = True
                        log.console(f"profile trace written to {profile_dir}")
                        meter.start()   # the trace's write is not train time
                    if (-idx) % 10 < k:
                        sync_tick(last)
                        log.console(f"epoch: {epoch} batch: {idx} loss: "
                                    # firacheck: allow[HOST-SYNC] the 10-batch console-log cadence is a designated sync boundary (README Design notes); steps in between stay async-dispatched
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
            ckpt.save_latest(state, best_bleu=best_bleu, epoch=epoch + 1,
                             rng_impl=cfg.rng_impl)
            meter.start()   # the checkpoint write is not train time
    except BaseException:
        if prof is not None:   # a run that raises inside the window
            profiling.end_trace(prof)
        raise
    if prof is not None:   # the run ended inside the profile window
        profiling.end_trace(prof)
        log.console(f"profile trace written to {profile_dir}")
    elif profile_dir and not profile_window:
        log.console("profile trace NOT written: profile_steps=0")
    elif profile_dir and not profile_done:
        log.console(f"profile trace NOT written: run ended after "
                    f"{global_step} steps, before the profile window "
                    f"(starts at step {profile_window[0]})")

    msum = meter.summary()
    secs = meter.seconds
    # commits of the global batch, over the ranks (the JAX loop's chips)
    cps = msum["items_per_sec"] / (1 if mesh is None else mesh.world)
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
    step_ms, host = _host_readings(spans_mark, cfg.feeder_workers,
                                   time.perf_counter() - run_t0)
    feeder.update(host)
    if measured_steps:
        log.console(f"throughput: {cps:.2f} commits/sec over "
                    f"{measured_steps} measured steps "
                    f"({1e3 * secs / measured_steps:.1f} "
                    f"ms/step), dev gates {dev_seconds:.2f} s | feeder "
                    f"queue depth mean {feeder['queue_depth_mean']:.1f} min "
                    f"{feeder['queue_depth_min']:.0f} (workers "
                    f"{cfg.feeder_workers}, depth {cfg.feeder_depth}) | "
                    f"host issue ms: forward {step_ms['forward']:.2f} "
                    f"backward {step_ms['backward']:.2f} optimizer "
                    f"{step_ms['optimizer']:.2f} | feeder ms: "
                    f"wait {host['wait_ms']:.2f} put {host['put_ms']:.2f}, "
                    f"pool use {100 * host['pool_use']:.1f} %, not ready "
                    f"{100 * host['not_ready_frac']:.1f} %")
    return TrainResult(
        state=state, best_bleu=best_bleu,
        epochs_run=max(0, n_epochs - start_epoch),
        commits_per_sec=cps,
        steps_per_sec=measured_steps / secs if secs else 0.0,
        feed_stall_frac=msum["feed_stall_frac"],
        steps=steps, gates=gates, dev_batches=dev_batches,
        dev_seconds=dev_seconds,
        losses=(torch.cat(losses).cpu().tolist() if losses else []),
        feeder=feeder, step_ms=step_ms, batches=batches, groups=groups,
        warnings=warnings)


def _host_readings(since: Dict, workers: int, wall_s: float):
    """This run's readings of the program's spans and counters (recorded
    after ``since``, a ``profiling.mark()``): the median issue ms of the
    step's parts, and the Feeder's median wait and put ms, the pool's use
    (``feeder.assemble`` seconds over the workers, or the loop's own
    thread at 0, times ``wall_s``, the run's wall since ``since``: every
    assembly lies inside it, so the use is at most 1) and the share of
    batches not ready on arrival."""
    spans = profiling.spans(since)
    counts = profiling.counters(since)

    def median_ms(name: str) -> float:
        return 1e3 * spans[name]["median_s"] if name in spans else 0.0

    step_ms = {part: median_ms(f"train.{part}")
               for part in ("forward", "backward", "optimizer")}
    assemble_s = spans.get("feeder.assemble", {}).get("total_s", 0.0)
    waits = spans.get("feeder.wait", {}).get("count", 0)
    return step_ms, {
        "wait_ms": median_ms("feeder.wait"),
        "put_ms": median_ms("feeder.put"),
        "pool_use": (assemble_s / (max(workers, 1) * wall_s)
                     if wall_s else 0.0),
        "not_ready_frac": (counts.get("feeder.not_ready", 0) / waits
                           if waits else 0.0),
    }


def _dispatch(entry, accum: int, model, optimizer, batch, gen, mesh
              ) -> torch.Tensor:
    """The optimizer steps of one plan entry: a step for a lone batch, one
    accumulated step or K fused steps for a stacked group. Returns their
    losses, (n_steps,) on the device."""
    if entry.pad_to == 1:
        return step_lib.train_step(model, optimizer, batch, gen, mesh)[None]
    if accum > 1:
        return step_lib.accum_step(model, optimizer, batch, gen, mesh)[None]
    return step_lib.multi_step(model, optimizer, batch, gen, mesh)


def _prewarm_guard(guard, dataset: FiraDataset, cfg: FiraConfig, table,
                   group_size: int, *, warm_per_step: bool, device,
                   sharding) -> None:
    """The JAX loop's bucketed pre-warm, for the guard: declare the
    (geometry x entrypoint x group-size) family, then step each member
    once with an all-pad batch at its geometry, copied to the device as
    the Feeder copies its batches, so each label's signature is fixed
    before the first real dispatch. Eager torch has nothing to compile, so
    no step runs."""
    from fira_tpu_torch.data.batching import make_batch

    train_split = dataset.splits["train"]
    dev_geoms = buckets_lib.decode_table(cfg.replace(decode_tar_buckets=False))
    labels = [program_label("dev_step", buckets_lib.geom_tag(g))
              for g in dev_geoms]
    for g in table:
        tag = buckets_lib.geom_tag(g)
        if warm_per_step:
            labels.append(program_label("train_step", tag))
        if group_size > 1:
            labels.append(program_label("grouped_step", tag, group_size))
    guard.declare(labels)

    def wire(host):
        return batch_to_device(host if sharding is None else sharding(host),
                               device, TRAIN_FIELDS)

    for g in table:
        tag = buckets_lib.geom_tag(g)
        wb = make_batch(train_split, np.arange(0), cfg,
                        batch_size=cfg.batch_size, geom=g)
        if warm_per_step:
            guard.step(program_label("train_step", tag), wire(wb))
        if group_size > 1:
            guard.step(program_label("grouped_step", tag, group_size),
                       wire(grouping.stack_group([wb] * group_size)))
    for g in dev_geoms:
        wb = make_batch(train_split, np.arange(0), cfg,
                        batch_size=cfg.test_batch_size, geom=g)
        guard.step(program_label("dev_step", buckets_lib.geom_tag(g)),
                   batch_to_device(wb, device, TRAIN_FIELDS))


def mesh_tooling_error() -> str:
    """Why ``--sanitize``/``--profile-dir`` refuse a spawned mesh."""
    return ("--sanitize and --profile-dir run in one process: the guard, "
            "the module hooks and the profiler do not cross to spawned "
            "mesh ranks (use one rank, or no mesh)")

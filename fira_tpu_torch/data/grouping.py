"""Bucket-homogeneous grouped steps: the one epoch scheduler (counterpart
of ``fira_tpu/data/grouping.py``).

``fused_steps=K`` runs K steps from one stacked copy to the card and
``accum_steps=A`` accumulates A micro-batches into one optimizer step;
both stack batches on a leading axis, and batches of different bucket
geometries cannot stack. So after bucket assignment over the same
``epoch_order`` permutation, runs of K (or A) same-geometry batches pack
into one group.

One plan shape serves every train epoch:

- ``group_size == 1``: one step a batch. With a bucket table this is
  exactly ``buckets.packed_plan(shuffle=True)``; with ``cfg.buckets = ()``
  it is ``epoch_index_chunks``'s sequential slicing.
- ``group_size > 1``, fused: each bucket's chunks collect until K are
  ready and leave as one :class:`GroupEntry` the moment the K-th fills;
  leftovers of fewer than K run a step at a time (the fused-tail rule,
  per bucket).
- ``group_size > 1``, accum: tails pad to A with all-invalid
  micro-batches (zero rows add nothing to the summed (nll, count)), so
  every accumulation is one A-stacked group.

Chunk formation depends only on the permutation walk: the sample-to-chunk
assignment is the same for every group size; grouping only packages
chunks into dispatches. The plan is a pure function of ``(seed, epoch,
bucket table, group size, accum)``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.buckets import (BucketGeom, assign_buckets,
                                         bucket_table, geom_cost, geom_tag,
                                         ideal_cost, positions_of,
                                         sample_extents)
from fira_tpu_torch.data.dataset import ProcessedSplit


class GroupEntry(NamedTuple):
    """One dispatch of an epoch plan.

    ``pad_to == 1``: one step on ``chunks[0]`` (exactly one chunk).
    ``pad_to > 1``: a stacked group: ``chunks`` (one geometry, each a full
    or tail index chunk) stack on a leading axis; when ``len(chunks) <
    pad_to`` (accum tails) assembly pads with all-invalid micro-batches up
    to ``pad_to``.
    """

    chunks: tuple          # of np.ndarray index chunks, len >= 1
    geom: BucketGeom
    pad_to: int


Plan = List[GroupEntry]


def grouped_plan(split: ProcessedSplit, cfg: FiraConfig, *,
                 batch_size: Optional[int] = None,
                 group_size: int = 1,
                 accum: bool = False,
                 shuffle: bool = False,
                 seed: int = 0,
                 epoch: int = 0,
                 table: Optional[Sequence[BucketGeom]] = None,
                 extents=None,
                 assignment: Optional[np.ndarray] = None,
                 use_msg: bool = True) -> Plan:
    """The deterministic grouped batch order of one train epoch.

    Walks the ``epoch_order(seed, epoch)`` permutation, appending each
    sample to its bucket's open chunk; a chunk joins its bucket's pending
    group when it fills, and a group leaves the moment its
    ``group_size``-th chunk lands. Tails flush in table order: fused
    leftovers (fewer than ``group_size`` chunks, plus each bucket's partial
    chunk) leave one step at a time; with ``accum=True`` they leave as one
    short group that assembly pads to ``group_size``.
    """
    from fira_tpu_torch.data.batching import epoch_order

    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    bs = batch_size or cfg.batch_size
    table = tuple(table) if table is not None else bucket_table(cfg)
    if assignment is None:
        if len(table) == 1:  # single geometry: everything is the fallback
            assignment = np.zeros(len(split), dtype=np.int64)
        else:
            extents = extents or sample_extents(split, cfg)
            assignment = assign_buckets(extents, table, use_msg=use_msg)
    order = epoch_order(len(split), shuffle=shuffle, seed=seed, epoch=epoch)

    plan: Plan = []
    open_rows: List[List[int]] = [[] for _ in table]
    pending: List[List[np.ndarray]] = [[] for _ in table]
    for i in order:
        # firacheck: allow[HOST-SYNC] host numpy assignment array — the scheduler runs on host index data only, never device values
        b = int(assignment[i])
        # firacheck: allow[HOST-SYNC] host numpy permutation entry, same scheduler-side data
        open_rows[b].append(int(i))
        if len(open_rows[b]) < bs:
            continue
        # firacheck: allow[HOST-SYNC] list-of-host-ints to numpy chunk; no device round-trip
        pending[b].append(np.asarray(open_rows[b]))
        open_rows[b] = []
        if group_size == 1:
            plan.append(GroupEntry((pending[b].pop(),), table[b], 1))
        elif len(pending[b]) == group_size:
            plan.append(GroupEntry(tuple(pending[b]), table[b], group_size))
            pending[b] = []
    for b, geom in enumerate(table):
        if open_rows[b]:
            # firacheck: allow[HOST-SYNC] same host-side tail flush as above
            pending[b].append(np.asarray(open_rows[b]))
        if not pending[b]:
            continue
        if group_size > 1 and accum:
            # accum tail: one short group, padded to the stacked shape with
            # all-invalid micro-batches at assembly
            plan.append(GroupEntry(tuple(pending[b]), geom, group_size))
        else:
            # fused tail (or one step a batch): leftovers run a step each
            plan.extend(GroupEntry((c,), geom, 1) for c in pending[b])
        pending[b] = []
    return plan


def stack_group(batches: Sequence[Dict[str, np.ndarray]], *,
                pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack same-geometry host batches on a new leading axis; with
    ``pad_to`` larger than the group, pad with all-zero micro-batches
    (every row invalid, label 0 everywhere: they add nothing to the
    accumulated (nll, count)). ``train.step.multi_step`` and
    ``accum_step`` take this layout on the device."""
    group = list(batches)
    if pad_to is not None and len(group) < pad_to:
        pad = {k: np.zeros_like(v) for k, v in group[0].items()}
        group.extend([pad] * (pad_to - len(group)))
    return {k: np.stack([b[k] for b in group]) for k in group[0]}


def grouped_assembly_tasks(split: ProcessedSplit, plan: Plan,
                           cfg: FiraConfig, *,
                           batch_size: Optional[int] = None) -> Iterator:
    """One zero-arg assembly task per plan entry, for the Feeder: a
    one-step entry builds one ``make_batch`` batch at its entry's geometry;
    a stacked entry builds its member batches and stacks them, so the
    group goes to the card as one copy per field. Each item carries the
    host-only ``_tag``; one-step entries also carry ``_positions``, as
    ``buckets.bucketed_assembly_tasks``."""
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import task_note

    bs = batch_size or cfg.batch_size

    def task(entry: GroupEntry):
        def build():
            group = [make_batch(split, c, cfg, batch_size=bs,
                                geom=entry.geom) for c in entry.chunks]
            if entry.pad_to == 1:
                batch = group[0]
                batch["_positions"] = positions_of(entry.chunks[0], bs)
            else:
                batch = stack_group(group, pad_to=entry.pad_to)
            batch["_tag"] = geom_tag(entry.geom)
            return batch
        build.note = task_note(np.concatenate(entry.chunks),
                               geom_tag=geom_tag(entry.geom),
                               site="grouped_assembly_tasks")
        return build

    for entry in plan:
        yield task(entry)


def plan_report(split: ProcessedSplit, cfg: FiraConfig, plan: Plan, *,
                batch_size: Optional[int] = None,
                extents=None) -> Dict:
    """Dispatch counts and padded-cost accounting for one epoch plan.

    ``padding_frac_dispatched`` extends ``buckets.padding_report`` to the
    dispatched stream: the denominator prices every dispatched row (bucket
    pad inside chunks, invalid pad rows of partial chunks, and the
    all-invalid accum pad micro-batches) at its dispatch geometry."""
    bs = batch_size or cfg.batch_size
    ext = extents or sample_extents(split, cfg)
    ideal = 0.0
    dispatched = 0.0
    n_commits = 0
    n_grouped = n_per_step = steps = real_batches = 0
    for entry in plan:
        cost = geom_cost(cfg, entry.geom)
        k = max(1, entry.pad_to)
        dispatched += k * bs * cost
        steps += k
        real_batches += len(entry.chunks)
        if entry.pad_to > 1:
            n_grouped += 1
        else:
            n_per_step += 1
        for chunk in entry.chunks:
            n_commits += len(chunk)
            for i in chunk:
                # firacheck: allow[HOST-SYNC] host numpy index chunk; the accounting never holds device values
                ideal += ideal_cost(cfg, ext, int(i))
    return {
        "dispatches": len(plan),
        "grouped_dispatches": n_grouped,
        "per_step_dispatches": n_per_step,
        "steps_dispatched": steps,
        "real_batches": real_batches,
        "commits": n_commits,
        "padding_frac_dispatched": round(
            1.0 - ideal / dispatched, 4) if dispatched else 0.0,
    }

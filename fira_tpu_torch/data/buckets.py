"""Bucketed padding geometry and length-aware batch packing (counterpart
of ``fira_tpu/data/buckets.py``).

Padding every batch to the worst-case geometry (the full
``ast_change_len`` node tail, ``max_edges`` COO slots, ``tar_len`` message
positions) spends most of the device's work on pad, because most commits
are small. This module declares a small fixed family of padding
geometries ("buckets"), assigns each sample to the smallest admissible
one, and packs same-bucket samples into batches.

Which axes are bucketable
-------------------------
A bucket is ``(ast_len, max_edges, tar_len)``:

- ``ast_len`` truncates the AST+change node region, the only node region
  that can shrink: ``sou_len`` and ``sub_token_len`` are baked into the
  copy-label id space (``vocab + diff_pos`` / ``vocab + sou_len +
  sub_pos``) and into the fused output width, so the copy span S stays
  ``sou_len + sub_token_len``. Truncating the ast tail is exact for every
  real node: pad ast nodes connect only to themselves (the reference's
  unconditional self-loops, Dataset.py:271-275), so dropping them removes
  zero rows and columns of the adjacency.
- ``max_edges`` shrinks the COO pad; pad edges scatter zeros.
- ``tar_len`` truncates decoder positions past the sample's message; the
  loss masks them out and causal attention keeps real positions' outputs
  unchanged. Decode does not bucket this axis (the model decides the
  output length): decode buckets are ``(ast_len, max_edges, full
  tar_len)``, unless ``cfg.decode_tar_buckets``, where each keeps its own
  tar as a generation budget that the slot engine enforces
  (:func:`output_plan`).

``build_adjacency`` appends one self-loop per node of the full geometry,
ascending, after all family edges, so the edges of the truncated node tail
are the last ``graph_len - bucket_graph_len`` entries of each sample's
ragged edge slice, and ``make_batch(geom=...)`` drops them by shortening
the slice.

Determinism: the packed batch order is a pure function of ``(seed,
epoch, bucket table)``. The packer walks the permutation
``data.batching.epoch_order`` draws, appending each sample to its
bucket's open chunk and emitting a chunk the moment it fills (tails flush
in table order). With ``shuffle=False`` (dev, decode) packing is a stable
partition by bucket; callers restore split order from the host-only
``_positions`` field each batch carries. With ``cfg.buckets = ()`` the
table is the full geometry alone, and the plans are the split's plain
order in ``batch_size`` chunks, every batch at the full geometry.

Grouped steps (``fused_steps``, ``accum_steps``) pack bucket-homogeneous
groups over the same walk in data/grouping.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.dataset import ProcessedSplit


class BucketGeom(NamedTuple):
    """One padding geometry: the bucketable axes of a batch."""

    ast_len: int     # AST+change node region length (<= cfg.ast_change_len)
    max_edges: int   # per-sample COO pad length (<= cfg.max_edges)
    tar_len: int     # message positions (<= cfg.tar_len)


def geom_tag(geom: BucketGeom) -> str:
    """Stable label fragment for reports: 'a16.e256.t8'."""
    return f"a{geom.ast_len}.e{geom.max_edges}.t{geom.tar_len}"


def full_geom(cfg: FiraConfig) -> BucketGeom:
    return BucketGeom(cfg.ast_change_len, cfg.max_edges, cfg.tar_len)


def geom_cost(cfg: FiraConfig, geom: BucketGeom) -> float:
    """Per-sample operation proxy at a geometry: the packer's and the
    padding metric's unit of account. The geometry-dependent matrix terms
    (GCN fc and dense A.x, decoder attention and FFN, fused head) plus a
    small per-edge scatter term; constant terms (Combination, source-side
    projections) are included so padding shares are not overstated."""
    d, L = cfg.embedding_dim, cfg.num_layers
    s = cfg.sou_len + cfg.sub_token_len          # copy span: not bucketable
    g = s + geom.ast_len                          # bucketed node count
    t = geom.tar_len
    v = cfg.vocab_size + s
    enc = L * (2 * g * g * d                      # dense A.x bmm
               + 2 * g * d * d * 2                # GCN fc1/fc2
               + 4 * cfg.sou_len * d * d * 2)     # Combination projections
    dec = L * ((6 * t + 2 * s) * d * d * 2
               + 2 * (t * t + t * s) * d * 2
               + 2 * t * d * cfg.ffn_mult * d * 2)
    head = (t * d * v * 2 + s * d * d * 2 + t * d * d * 2 + t * s * d * 2)
    return float(enc + dec + head + 8.0 * geom.max_edges)


def _validated(cfg: FiraConfig, geom: BucketGeom) -> BucketGeom:
    full = full_geom(cfg)
    # firacheck: allow[HOST-SYNC] config ints from the declared bucket table; no device value exists in the packer
    g = BucketGeom(*(int(x) for x in geom))
    if not (1 <= g.ast_len <= full.ast_len):
        raise ValueError(f"bucket ast_len {g.ast_len} outside "
                         f"[1, {full.ast_len}]")
    if not (1 <= g.tar_len <= full.tar_len):
        raise ValueError(f"bucket tar_len {g.tar_len} outside "
                         f"[1, {full.tar_len}]")
    min_edges = cfg.sou_len + cfg.sub_token_len + g.ast_len
    if not (min_edges <= g.max_edges <= full.max_edges):
        # every sample carries one self-loop per node of its geometry, so a
        # bucket with fewer edge slots than nodes can never admit anything
        raise ValueError(
            f"bucket max_edges {g.max_edges} outside "
            f"[{min_edges} (= nodes at ast_len {g.ast_len}, the self-loop "
            f"floor), {full.max_edges}]")
    return g


def bucket_table(cfg: FiraConfig) -> Tuple[BucketGeom, ...]:
    """The effective bucket family: cfg.buckets validated, sorted by cost
    ascending, with the full geometry appended as the always-admissible
    fallback. ``cfg.buckets = ()`` yields just the full geometry."""
    full = full_geom(cfg)
    geoms = []
    for entry in cfg.buckets:
        g = _validated(cfg, BucketGeom(*entry))
        if g != full and g not in geoms:
            geoms.append(g)
    geoms.sort(key=lambda g: geom_cost(cfg, g))
    return tuple(geoms) + (full,)


@dataclasses.dataclass(frozen=True)
class SampleExtents:
    """Per-sample used lengths along the bucketable axes (edge counts at
    the full geometry; :meth:`edges_at` gives them for a truncated node
    region)."""

    ast: np.ndarray    # used AST+change nodes (labels or family edges)
    edges: np.ndarray  # ragged edge count at the full geometry (all
                       # self-loops included; the truncated tail subtracts)
    msg: np.ndarray    # used msg/msg_tar positions (START..EOS inclusive)
    ast_change_len: int  # the full region length the counts were taken at

    def edges_at(self, ast_len: int) -> np.ndarray:
        """Edge counts once the node tail is truncated to ``ast_len``: each
        dropped pad node carried exactly one self-loop."""
        return self.edges - (self.ast_change_len - ast_len)

    def admissible(self, geom: BucketGeom, *, use_msg: bool = True
                   ) -> np.ndarray:
        ok = (self.ast <= geom.ast_len) \
            & (self.edges_at(geom.ast_len) <= geom.max_edges)
        if use_msg:
            ok = ok & (self.msg <= geom.tar_len)
        return ok


def _last_nonzero_extent(a: np.ndarray) -> np.ndarray:
    """Per-row index past the last nonzero (0 for all-zero rows)."""
    nz = a != 0
    return np.where(nz.any(axis=1),
                    a.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)


def sample_extents(split: ProcessedSplit, cfg: FiraConfig) -> SampleExtents:
    from fira_tpu_torch.data.graph_build import EDGE_KIND_SELF_LOOP

    arr = split.arrays
    n = len(split)
    counts = np.diff(arr["edge_offsets"]).astype(np.int64)

    # used ast nodes: nonzero labels, and where family (non-self-loop)
    # edges point, whichever reaches further
    ast_ext = _last_nonzero_extent(arr["ast_change"]).astype(np.int64)
    ast_base = cfg.sou_len + cfg.sub_token_len
    hi_node = np.maximum(arr["edge_senders"], arr["edge_receivers"]
                         ).astype(np.int64)
    fam = (arr["edge_kinds"] != EDGE_KIND_SELF_LOOP) & (hi_node >= ast_base)
    if fam.any():
        owner = np.repeat(np.arange(n), counts)
        edge_ext = np.zeros(n, dtype=np.int64)
        np.maximum.at(edge_ext, owner[fam], hi_node[fam] - ast_base + 1)
        ast_ext = np.maximum(ast_ext, edge_ext)

    msg_ext = np.maximum(_last_nonzero_extent(arr["msg"]),
                         _last_nonzero_extent(arr["msg_tar"])).astype(np.int64)
    return SampleExtents(ast=ast_ext, edges=counts, msg=msg_ext,
                         ast_change_len=cfg.ast_change_len)


def assign_buckets(extents: SampleExtents, table: Sequence[BucketGeom], *,
                   use_msg: bool = True) -> np.ndarray:
    """Smallest admissible bucket per sample (table sorted cost-ascending;
    the trailing full geometry admits everything)."""
    n = len(extents.ast)
    out = np.full(n, len(table) - 1, dtype=np.int64)
    unassigned = np.ones(n, dtype=bool)
    for b, geom in enumerate(table[:-1]):
        fit = unassigned & extents.admissible(geom, use_msg=use_msg)
        out[fit] = b
        unassigned &= ~fit
    return out


def _round_up(x: int, unit: int) -> int:
    # firacheck: allow[HOST-SYNC] host numpy quantile scalar; the packer never holds device values
    return ((int(x) + unit - 1) // unit) * unit


def choose_buckets(split: ProcessedSplit, cfg: FiraConfig,
                   n_buckets: int = 3) -> Tuple[Tuple[int, int, int], ...]:
    """Bucket table from the split's length histograms: per-axis quantiles
    at evenly spaced levels, rounded up (ast to 8, edges to 64, msg to 4)
    and capped at the full geometry. Deterministic for a given split. The
    tuples go into ``cfg.buckets``; the full geometry stays the implicit
    fallback and is never declared."""
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
    ext = sample_extents(split, cfg)
    full = full_geom(cfg)
    out: List[Tuple[int, int, int]] = []
    for i in range(n_buckets):
        q = (i + 1) / n_buckets
        ast = min(full.ast_len,
                  max(1, _round_up(np.quantile(ext.ast, q), 8)))
        tar = min(full.tar_len,
                  max(2, _round_up(np.quantile(ext.msg, q), 4)))
        edges = min(full.max_edges,
                    _round_up(np.quantile(ext.edges_at(ast), q), 64))
        edges = max(edges, cfg.sou_len + cfg.sub_token_len + ast)
        geom = (ast, edges, tar)
        if geom != tuple(full) and geom not in out:
            out.append(geom)
    return tuple(out)


Plan = List[Tuple[np.ndarray, BucketGeom]]


def packed_plan(split: ProcessedSplit, cfg: FiraConfig, *,
                batch_size: Optional[int] = None,
                shuffle: bool = False,
                seed: int = 0,
                epoch: int = 0,
                table: Optional[Sequence[BucketGeom]] = None,
                extents: Optional[SampleExtents] = None,
                assignment: Optional[np.ndarray] = None,
                use_msg: bool = True) -> Plan:
    """The deterministic bucketed batch order of one epoch: a list of
    (index chunk, bucket geometry) pairs.

    shuffle=True (train): the ``epoch_order(seed, epoch)`` permutation is
    walked greedily; each sample joins its bucket's open chunk, which is
    emitted the moment it fills; tails flush in table order.
    shuffle=False (dev, decode): a stable partition by bucket (in-bucket
    split order kept), that is sort-by-length packing.
    """
    from fira_tpu_torch.data.batching import epoch_order

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
    if shuffle:
        open_chunks: List[List[int]] = [[] for _ in table]
        for i in order:
            # firacheck: allow[HOST-SYNC] host numpy assignment array — the packer runs on host index data only, never device values
            b = int(assignment[i])
            # firacheck: allow[HOST-SYNC] host numpy permutation entry, same packer-side data
            open_chunks[b].append(int(i))
            if len(open_chunks[b]) == bs:
                # firacheck: allow[HOST-SYNC] list-of-host-ints to numpy chunk; no device round-trip
                plan.append((np.asarray(open_chunks[b]), table[b]))
                open_chunks[b] = []
        for b, chunk in enumerate(open_chunks):
            if chunk:
                # firacheck: allow[HOST-SYNC] same host-side tail flush as above
                plan.append((np.asarray(chunk), table[b]))
        return plan
    for b, geom in enumerate(table):
        members = order[assignment[order] == b]
        for start in range(0, len(members), bs):
            plan.append((members[start : start + bs], geom))
    return plan


def positions_of(chunk: np.ndarray, batch_size: int) -> np.ndarray:
    """The host-only ``_positions`` field: each row's split position, -1
    on pad rows."""
    positions = np.full(batch_size, -1, dtype=np.int64)
    positions[: len(chunk)] = chunk
    return positions


def bucketed_assembly_tasks(split: ProcessedSplit, plan: Plan,
                            cfg: FiraConfig, *,
                            batch_size: Optional[int] = None) -> Iterator:
    """One ``make_batch(geom=...)`` task per plan entry, for the Feeder.
    Each batch carries two host-only fields (never copied to the device,
    data/feeder.py): ``_positions``, each row's split position (-1 on pad
    rows), so callers restore split order after packing reordered the
    stream, and ``_tag``, the bucket's geometry tag."""
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import task_note

    bs = batch_size or cfg.batch_size

    def task(chunk: np.ndarray, geom: BucketGeom):
        def build():
            batch = make_batch(split, chunk, cfg, batch_size=bs, geom=geom)
            batch["_positions"] = positions_of(chunk, bs)
            batch["_tag"] = geom_tag(geom)
            return batch
        # a failing worker's FeederTaskError names the chunk and geometry
        build.note = task_note(chunk, geom_tag=geom_tag(geom),
                               site="bucketed_assembly_tasks")
        return build

    for chunk, geom in plan:
        yield task(chunk, geom)


def decode_table(cfg: FiraConfig) -> Tuple[BucketGeom, ...]:
    """The decode-side bucket family, deduplicated, cost-sorted, full
    fallback last: each bucket with ``tar_len`` pinned to the full value
    (the beam's output length is the model's to decide and must not be
    clipped), or under ``cfg.decode_tar_buckets`` with its own tar_len:
    then samples pack by their reference message's extent too, and the
    slot engine caps each sample's generation at its bucket's tar, which
    is also its paged block reservation. The batched beam ignores the
    cap (its scan always runs the full budget)."""
    full = full_geom(cfg)
    geoms: List[BucketGeom] = []
    for g in bucket_table(cfg)[:-1]:
        d = (g if cfg.decode_tar_buckets
             else BucketGeom(g.ast_len, g.max_edges, cfg.tar_len))
        if d != full and d not in geoms:
            geoms.append(d)
    geoms.sort(key=lambda g: geom_cost(cfg, g))
    return tuple(geoms) + (full,)


def decode_plan(split: ProcessedSplit, cfg: FiraConfig, *,
                batch_size: Optional[int] = None) -> Plan:
    """The bucketed batch order of the dev gate and the tar-pinned test
    decode: ``packed_plan`` over the decode table with ``tar_len`` full
    (``decode_tar_buckets`` is a test-decode knob and ignored here), split
    order within each bucket, admissibility on nodes and edges only (the
    gate scores teacher-forced predictions at every position, and the
    beam decides the output length)."""
    return packed_plan(split, cfg, batch_size=batch_size or
                       cfg.test_batch_size,
                       table=decode_table(cfg.replace(
                           decode_tar_buckets=False)),
                       use_msg=False)


def output_plan(split: ProcessedSplit, cfg: FiraConfig) -> Plan:
    """The batch order of the test decode (the one that writes
    ``output_fira``): :func:`decode_plan`, or under
    ``cfg.decode_tar_buckets`` the tar-bucketed table with each sample
    in the smallest bucket its reference message fits."""
    if not cfg.decode_tar_buckets:
        return decode_plan(split, cfg)
    return packed_plan(split, cfg, batch_size=cfg.test_batch_size,
                       table=decode_table(cfg), use_msg=True)


def ideal_cost(cfg: FiraConfig, ext: SampleExtents, i: int) -> float:
    """Sample ``i``'s cost at its own extents: its edge count at its ast
    extent is the full count less its truncated self-loop tail."""
    ast = int(ext.ast[i])
    return geom_cost(cfg, BucketGeom(
        ast, int(ext.edges[i]) - (ext.ast_change_len - ast),
        max(2, int(ext.msg[i]))))


def padding_report(split: ProcessedSplit, cfg: FiraConfig,
                   table: Optional[Sequence[BucketGeom]] = None, *,
                   use_msg: bool = True) -> Dict:
    """Split-level padded-cost accounting, single geometry vs bucketed.

    ``padding_frac`` = 1 - (sum of each sample's cost at its own extents) /
    (sum of cost at the geometry actually dispatched): the share of the
    device's matrix work spent on pad. Per-bucket rows show the table's
    coverage."""
    table = tuple(table) if table is not None else bucket_table(cfg)
    ext = sample_extents(split, cfg)
    assignment = assign_buckets(ext, table, use_msg=use_msg)
    ideal = np.asarray([ideal_cost(cfg, ext, i) for i in range(len(split))])
    full_cost = geom_cost(cfg, full_geom(cfg))
    bucket_costs = np.asarray([geom_cost(cfg, g) for g in table])
    assigned = bucket_costs[assignment]
    per_bucket = []
    for b, geom in enumerate(table):
        members = assignment == b
        n = int(members.sum())
        row = {"geom": geom_tag(geom), "n": n}
        if n:
            row["padding_frac"] = round(
                1.0 - float(ideal[members].sum())
                / float(assigned[members].sum()), 4)
        per_bucket.append(row)
    return {
        "n_samples": len(split),
        "padding_frac_single": round(
            1.0 - float(ideal.sum()) / (full_cost * len(split)), 4),
        "padding_frac_bucketed": round(
            1.0 - float(ideal.sum()) / float(assigned.sum()), 4),
        "flops_ratio_bucketed_vs_single": round(
            float(assigned.sum()) / (full_cost * len(split)), 4),
        "buckets": per_bucket,
    }

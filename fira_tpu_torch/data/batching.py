"""Fixed-shape batch assembly (the JAX package's ``data/batching.py``).

Every batch has the single full config geometry. The final partial batch of
a split is padded with zeroed samples whose labels are all <pad>; a
``valid`` bool array marks real rows for eval bookkeeping. COO edges are
padded per-sample to cfg.max_edges (pad entries scatter zero, a no-op on
the device). Ids travel int16/int8 and edge indices int16 to keep the
host->device copy small; the model upcasts them on the device.

The reference instead ships a dense 650^2 float adjacency per sample through
a torch DataLoader (Dataset.py:336-343).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.dataset import ProcessedSplit, ARRAY_FIELDS

Batch = Dict[str, np.ndarray]


def sort_edge_rows(senders, receivers, values, kinds, graph_len: int):
    """Row-wise sort of padded COO fields by linear cell index -> the
    device scatter's index stream is globally sorted (rows ascend, cells
    ascend within a row); pads (0,0,value 0) land first and still add
    nothing. ALL per-edge fields must ride the same permutation — kinds
    included when the typed-edge extension ships them."""
    order = np.argsort(
        senders.astype(np.int32) * graph_len + receivers, axis=1,
        kind="stable")
    senders = np.take_along_axis(senders, order, axis=1)
    receivers = np.take_along_axis(receivers, order, axis=1)
    values = np.take_along_axis(values, order, axis=1)
    if kinds is not None:
        kinds = np.take_along_axis(kinds, order, axis=1)
    return senders, receivers, values, kinds


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns as uint16: round to nearest, ties to even,
    on the uint32 view, then keep the high 16 bits (the rounding of
    ``ml_dtypes.bfloat16`` and of the device cast); NaN stays a quiet
    NaN of its sign."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    quiet = (u >> 16) | np.uint32(0x40)
    return np.where(nan, quiet, rounded).astype(np.uint16)


# Mean-edges-per-row crossover between the two vectorized-gather regimes,
# measured with numpy on a CPU host: a numpy fancy
# gather/scatter costs a few ns/ELEMENT plus ~10 bytes/element of
# temporary traffic, while a per-row contiguous slice copy costs a few
# us/ROW of interpreter overhead plus a near-free memcpy. Below the
# crossover (many rows, few edges — sparse-graph corpora, stacked-group
# assembly) the flat cumsum/np.repeat gather wins ~3-5x; above it (the
# flagship 650-node graphs at ~700+ edges/sample) per-row memcpy beats
# per-element fancy indexing and the temporaries' memory traffic, so the
# addressing stays vectorized but the copies stay slices. Conservative on
# purpose: a host with faster fancy indexing only leaves a little on the
# table, never regresses.
_VEC_EDGE_CROSSOVER = 64


def _gather_edges_vectorized(split: ProcessedSplit, indices: np.ndarray,
                             cfg: FiraConfig, bs: int):
    """Vectorized COO gather of each sample's ragged edge slice into the
    padded (bs, max_edges) wire arrays.

    Addressing (offsets, counts, the overflow check) is always vectorized.
    The copies pick a regime by mean edges per row (see
    ``_VEC_EDGE_CROSSOVER``): the flat cumsum/np.repeat gather — one
    address computation and four fancy-indexed copies replacing ~bs
    interpreter iterations — below it, per-row contiguous slice copies
    above it."""
    idx = np.asarray(indices, dtype=np.intp)
    offsets = split.arrays["edge_offsets"]
    lo = offsets[idx]
    counts = (offsets[idx + 1] - lo).astype(np.intp)
    if counts.size and counts.max() > cfg.max_edges:
        row = int(np.argmax(counts > cfg.max_edges))  # first offender
        raise ValueError(
            f"sample {idx[row]}: {counts[row]} edges > max_edges={cfg.max_edges}")

    senders = np.zeros((bs, cfg.max_edges), dtype=np.int16)
    receivers = np.zeros((bs, cfg.max_edges), dtype=np.int16)
    values = np.zeros((bs, cfg.max_edges), dtype=np.float32)
    kinds = (np.zeros((bs, cfg.max_edges), dtype=np.int8)
             if cfg.typed_edges else None)
    if not counts.size:
        return senders, receivers, values, kinds

    arrays = split.arrays
    if counts.mean() > _VEC_EDGE_CROSSOVER:
        hi = lo + counts
        for row in range(len(idx)):  # copies only; addressing is above
            a, b = lo[row], hi[row]
            n = b - a
            senders[row, :n] = arrays["edge_senders"][a:b]
            receivers[row, :n] = arrays["edge_receivers"][a:b]
            values[row, :n] = arrays["edge_values"][a:b]
            if kinds is not None:
                kinds[row, :n] = arrays["edge_kinds"][a:b]
        return senders, receivers, values, kinds

    # flat regime: every real edge's flat source slot and flat destination
    # slot — col counts 0..n_row-1 within each row, src = lo + col,
    # dst = row*max_edges + col (strictly ascending, the cache-friendly
    # scatter order). 1-D raveled indexing with pre-cast right-hand sides:
    # 2-D advanced indexing and in-assignment dtype casts both fall off
    # numpy's fast path (each measured ~4x slower here).
    total = int(counts.sum())
    rows = np.repeat(np.arange(len(idx), dtype=np.intp), counts)
    cols = np.arange(total, dtype=np.intp) - np.repeat(
        np.cumsum(counts) - counts, counts)
    src = np.repeat(lo, counts) + cols
    dst = rows * cfg.max_edges + cols
    senders.ravel()[dst] = arrays["edge_senders"][src].astype(np.int16)
    receivers.ravel()[dst] = arrays["edge_receivers"][src].astype(np.int16)
    values.ravel()[dst] = arrays["edge_values"][src]
    if kinds is not None:
        kinds.ravel()[dst] = arrays["edge_kinds"][src].astype(np.int8)
    return senders, receivers, values, kinds


def make_batch(split: ProcessedSplit, indices: np.ndarray, cfg: FiraConfig,
               batch_size: Optional[int] = None) -> Batch:
    """Gather + pad a batch. ``indices`` may be shorter than batch_size."""
    bs = batch_size or len(indices)
    n_real = len(indices)
    if n_real > bs:
        raise ValueError(f"{n_real} indices exceed batch_size={bs}")
    batch: Batch = {}
    for f in ARRAY_FIELDS:
        src = split.arrays[f][indices]
        if n_real < bs:
            pad = np.zeros((bs - n_real,) + src.shape[1:], dtype=src.dtype)
            src = np.concatenate([src, pad])
        batch[f] = src

    # --- narrow wire dtypes: ids ship int16/int8 and are upcast to int64 on
    # the device (decode/runner.batch_to_device). The host->device copy is
    # a per-batch cost; ids are ~7% and edge arrays ~93% of the batch
    # bytes. Preconditions are enforced loudly: a config scaled past a
    # narrow dtype's range must fail here, not wrap silently on device.
    if cfg.output_vocab_size - 1 > np.iinfo(np.int16).max:
        raise ValueError(
            f"output_vocab_size={cfg.output_vocab_size} exceeds int16 wire "
            f"range (max id {np.iinfo(np.int16).max}); widen the id dtype")
    for f in ("diff", "msg", "msg_tar", "sub_token"):
        batch[f] = batch[f].astype(np.int16)
    # mark vocabulary is 0..3 today; guard like the int16 fields so a future
    # mark-vocabulary change fails loudly instead of wrapping on the wire
    if batch["diff_mark"].size and batch["diff_mark"].max() > np.iinfo(np.int8).max:
        raise ValueError(
            f"diff_mark max {batch['diff_mark'].max()} exceeds int8 wire "
            f"range (max {np.iinfo(np.int8).max}); widen the mark dtype")
    batch["diff_mark"] = batch["diff_mark"].astype(np.int8)
    if cfg.ast_change_vocab_size - 1 > np.iinfo(np.int16).max:
        raise ValueError(
            f"ast_change_vocab_size={cfg.ast_change_vocab_size} exceeds "
            f"int16 wire range; widen the id dtype")
    ast_dt = (np.int8 if cfg.ast_change_vocab_size - 1 <= np.iinfo(np.int8).max
              else np.int16)
    batch["ast_change"] = batch["ast_change"].astype(ast_dt)

    # int16 indices: graph_len caps at 650 << 32767, and edge arrays dominate
    # the per-step host->device transfer (the model upcasts on device).
    # Enforce the dtype's precondition: a config scaled past int16 range
    # must fail loudly here, not wrap around silently in the scatter.
    if cfg.graph_len - 1 > np.iinfo(np.int16).max:  # indices are 0..len-1
        raise ValueError(
            f"graph_len={cfg.graph_len} exceeds int16 edge-index range "
            f"(max index {np.iinfo(np.int16).max}); widen the edge dtype")
    senders, receivers, values, kinds = _gather_edges_vectorized(
        split, indices, cfg, bs)
    if cfg.sort_edges:
        senders, receivers, values, kinds = sort_edge_rows(
            senders, receivers, values, kinds, cfg.graph_len)

    batch["senders"] = senders
    batch["receivers"] = receivers
    if (cfg.compute_dtype == "bfloat16" and cfg.adjacency_impl == "dense"
            and not cfg.typed_edges):
        # Ship edge values in the compute dtype, as the JAX package does
        # under exactly these conditions: the dense path scatters them
        # straight into a bf16 adjacency, and rounding on the host is the
        # rounding the device cast performs, so the adjacency is
        # bit-identical while the largest wire field halves. The bits
        # travel as uint16 (numpy has no bf16); the copy to the device
        # views them as torch.bfloat16 (data/feeder.batch_to_device).
        values = bf16_bits(values)
    batch["values"] = values
    if kinds is not None:
        # only shipped when the typed-edge extension is on — the flattened
        # default keeps the reference's exact wire format
        batch["edge_kinds"] = kinds

    valid = np.zeros(bs, dtype=bool)
    valid[:n_real] = True
    batch["valid"] = valid
    return batch


def epoch_order(n: int, *, shuffle: bool = False, seed: int = 0,
                epoch: int = 0) -> np.ndarray:
    """The deterministic sample PERMUTATION of an epoch — the single
    source ``epoch_index_chunks`` slices into fixed-size chunks. Seed and
    epoch fold together so each epoch draws a fresh but fully reproducible
    permutation (the reference's DataLoader
    shuffle=True, run_model.py:387)."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState((seed * 1_000_003 + epoch) % (2**31)).shuffle(order)
    return order


def epoch_index_chunks(n: int, cfg: FiraConfig, *,
                       batch_size: Optional[int] = None,
                       shuffle: bool = False,
                       seed: int = 0,
                       epoch: int = 0,
                       drop_remainder: bool = False) -> List[np.ndarray]:
    """The deterministic batch ORDER of an epoch, as a list of index chunks
    (see ``epoch_order`` for the permutation contract). This is the single
    source of truth for batch order: the decode runner walks these
    chunks."""
    bs = batch_size or cfg.batch_size
    order = epoch_order(n, shuffle=shuffle, seed=seed, epoch=epoch)
    chunks = [order[start : start + bs] for start in range(0, n, bs)]
    if drop_remainder and chunks and len(chunks[-1]) < bs:
        chunks.pop()
    return chunks

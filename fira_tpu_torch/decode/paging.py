"""Paged KV arena: host-side geometry, validation and byte accounting
(counterpart of ``fira_tpu/decode/paging.py``).

Under ``cfg.engine_paged_kv`` (the default) the slot engine's
self-attention caches live in a fixed pool of KV blocks addressed through
per-slot block tables (vLLM's PagedAttention, SOSP '23), instead of one
whole-sequence stripe a slot. A slot is handed exactly the blocks its
decode bucket's tar budget reserves when it is seated and returns them
whole at harvest; freed blocks are unmapped, never zeroed (the step's
validity mask multiplies unwritten positions by an exact 0.0,
``beam.step_valid_mask``).

This module is the host half: block size and pool resolution, the
parse-time knob checks the CLI turns into exit 2 (one message naming the
knob each, in the JAX package's words), and the per-slot byte accounting
the engine's stats record. The device half is ``gather_block_kv`` /
``append_block_kv`` (model/layers.py) and ``Decoder.decode_step_paged``;
the allocator is the engine's (decode/engine.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

from fira_tpu_torch.config import FiraConfig


def declared_decode_tars(cfg: FiraConfig) -> Tuple[int, ...]:
    """Every tar budget a decode slot can be seated at, ascending:
    ``cfg.tar_len`` alone, or under ``decode_tar_buckets`` each declared
    bucket's own tar too."""
    tars = {int(cfg.tar_len)}
    if cfg.decode_tar_buckets:
        for _ast, _edges, tar in cfg.buckets:
            # firacheck: allow[HOST-SYNC] cfg.buckets entries are parse-time host ints, not device values; this runs once at engine construction
            tars.add(int(tar))
    return tuple(sorted(tars))


def auto_block_size(tars: Tuple[int, ...]) -> int:
    """The largest common divisor of every declared tar budget that is at
    most min(16, smallest tar // 2): two blocks a sequence where the
    geometry allows it, capped at 16. Always valid (1 divides all)."""
    g = 0
    for t in tars:
        # firacheck: allow[HOST-SYNC] tar budgets are host ints from the config table; knob resolution happens once, before any dispatch
        g = math.gcd(g, int(t))
    cap = max(1, min(16, min(tars) // 2))
    best = 1
    for d in range(1, g + 1):
        if g % d == 0 and d <= cap:
            best = d
    return best


def resolve_block_size(cfg: FiraConfig) -> int:
    return int(cfg.kv_block_size) or auto_block_size(declared_decode_tars(cfg))


def blocks_per_seq(tar: int, block_size: int) -> int:
    """Blocks one slot reserves for a ``tar``-budget sequence (all K beams
    share a block, so no beam factor)."""
    return -(-int(tar) // int(block_size))


def resolved_slots(cfg: FiraConfig) -> Tuple[int, int]:
    """(slots a replica, replica count): a nonzero ``engine_slots`` is the
    total over replicas; 0 gives each replica ``test_batch_size``."""
    reps = max(1, int(cfg.engine_replicas))
    total = int(cfg.engine_slots)
    if total:
        return max(1, total // reps), reps
    return int(cfg.test_batch_size), reps


def auto_pool_blocks(cfg: FiraConfig, slots: int) -> int:
    """Full residency: every slot can hold a full ``tar_len`` sequence at
    once, so admission never waits on blocks and the paged scheduler
    steps exactly as the unpaged arena."""
    return int(slots) * blocks_per_seq(cfg.tar_len, resolve_block_size(cfg))


def paging_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time paging-knob checks, one message naming the knob each
    (CLI exit 2): ``kv_block_size`` divides every declared decode tar
    budget; ``kv_pool_blocks`` splits evenly over ``engine_replicas``;
    per replica the pool holds slots x ceil(smallest tar / block) blocks
    (every slot servable) and ceil(largest tar / block) (one worst-case
    sample fits an empty pool, or admission livelocks)."""
    if not (cfg.decode_engine and cfg.beam_kv_cache and cfg.engine_paged_kv):
        return []
    errs: List[str] = []
    tars = declared_decode_tars(cfg)
    bs = resolve_block_size(cfg)
    if bs < 1:
        return [f"kv_block_size {cfg.kv_block_size} must be >= 1"]
    for t in tars:
        if t % bs:
            errs.append(
                f"kv_block_size {bs} does not divide decode tar budget {t} "
                f"(declared tars: {list(tars)}); block tables must tile "
                f"every budget exactly")
    slots, reps = resolved_slots(cfg)
    pool_total = int(cfg.kv_pool_blocks)
    if not pool_total:
        return errs  # auto pool: full residency, floors hold by construction
    if pool_total % reps:
        errs.append(
            f"kv_pool_blocks {pool_total} is not divisible by "
            f"engine_replicas {reps} (the fleet splits the total block "
            f"pool evenly across replicas, like engine_slots)")
        return errs
    pool = pool_total // reps
    if not errs:  # floors only meaningful once bs tiles the tars
        floor = slots * blocks_per_seq(tars[0], bs)
        if pool < floor:
            errs.append(
                f"kv_pool_blocks {pool} per replica < engine slots {slots} "
                f"x ceil(tar {tars[0]} / kv_block_size {bs}) = {floor}; "
                f"the pool must keep every slot servable on the smallest "
                f"decode tar budget")
        worst = blocks_per_seq(tars[-1], bs)
        if pool < worst:
            errs.append(
                f"kv_pool_blocks {pool} per replica < "
                f"ceil(tar {tars[-1]} / kv_block_size {bs}) = {worst}; one "
                f"largest-budget sample must fit an empty pool or the "
                f"scheduler can never admit it (livelock)")
    return errs


def prefix_cache_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time prefix-cache knob checks (the JAX package's words;
    ``config.unsupported`` runs them): the cache needs the engine, at
    least one entry, and a byte budget >= 0."""
    if not cfg.prefix_cache:
        return []
    errs: List[str] = []
    if not cfg.decode_engine:
        errs.append(
            "prefix_cache requires the decode engine (--engine, --perf "
            "production, or cli serve): cached prefill artifacts are "
            "seated into engine slots — the batched beam has no seat to "
            "map them into")
    if cfg.prefix_cache_entries < 1:
        errs.append(
            f"prefix_cache_entries {cfg.prefix_cache_entries} must be "
            f">= 1 cached prefill entry when prefix_cache is on (the LRU "
            f"needs capacity to hold at least one artifact set)")
    if cfg.prefix_cache_bytes < 0:
        errs.append(
            f"prefix_cache_bytes {cfg.prefix_cache_bytes} must be >= 0 "
            f"(0 = unbounded host bytes; otherwise the per-replica LRU "
            f"evicts until its payload bytes fit the budget)")
    return errs


def kv_itemsize(cfg: FiraConfig) -> int:
    """Bytes of one K/V arena element under ``cfg.kv_dtype``: 2 for
    ``bf16``, else 4. The engine itself takes the itemsize from the
    arena's dtype (the encoder states'); callers that predict its bytes
    use this."""
    return 2 if cfg.kv_dtype == "bf16" else 4


def block_bytes(cfg: FiraConfig, block_size: int, itemsize: int) -> int:
    """Bytes of one pool block pair (K and V): layers x beams x heads x
    block positions x head dim."""
    d_head = cfg.embedding_dim // cfg.num_head
    return (2 * cfg.num_layers * cfg.beam_size * cfg.num_head
            * int(block_size) * d_head * int(itemsize))


def kv_bytes_per_slot(cfg: FiraConfig, *, paged: bool, block_size: int,
                      pool_blocks: int, slots: int, itemsize: int) -> int:
    """Committed K+V self-attention cache bytes a slot. Unpaged: each slot
    owns a whole-sequence stripe. Paged: the pool is the commitment,
    spread over the slots it serves."""
    if paged:
        return block_bytes(cfg, block_size, itemsize) * int(pool_blocks) \
            // max(1, int(slots))
    return block_bytes(cfg, 1, itemsize) * int(cfg.tar_len)

"""Slot-refill continuous-batching decode engine (counterpart of
``fira_tpu/decode/engine.py``).

The batched beam (decode/beam.py) decodes whole batches: even with
``beam_early_exit`` a batch runs until its longest message settles, so
most rows of a late step are finished beams. The engine keeps a fixed
arena of S slots, each holding one sample's beam at its own depth
(iteration-level continuous batching, Orca OSDI '22, over a fixed-shape
arena, vLLM SOSP '23): every step dispatch advances each live slot
``cfg.engine_harvest_every`` (R) positions; settled slots are harvested
and refilled with freshly prefilled samples, so the work follows the
tokens emitted, not each batch's longest message.

Pieces (all on the model's device, the arena a dict of tensors updated
in place under ``torch.inference_mode()``):

- **prefill**: encoder forward, then per-beam cross-attention K/V and the
  copy head's source projection (or, without the KV cache, the per-beam
  encoder states) for one packed batch: the batched beam's preamble, on
  the batches the decode plan gives it (``buckets.output_plan``);
- **step**: R positions of every active slot (``Decoder.decode_step_multi``
  / ``decode_step_paged``, or the full prefix re-decoded; then
  ``beam._select`` / ``_select_factored`` at the per-slot position
  vector), with a per-slot done predicate in place of the batch's
  early-exit test. Idle and settled slots compute garbage that is blended
  away. Each micro-step calls the copy head once, so K1
  (``ops/copy_score``) launches R times a dispatch;
- **insert**: copies chosen rows of a prefilled chunk into free slots.
  The rows and slots are picked on the host, so no out-of-range sentinel
  reaches a device index (where the JAX package scatters with
  ``mode="drop"``);
- **harvest**: one read of the dispatch's ``done`` mask and occupancy,
  then one read of the settled slots' token and score rows. These two
  are the only host syncs of a dispatch (``EngineStats.host_syncs``); the
  step itself reads nothing back.

Contract (the JAX package's, tests/test_torch_engine.py): per sample the
engine's tokens and scores are bitwise equal to the batched beam's in
every kv-cache x factored-top-k mode, the paged arena to the unpaged one,
for any slot count and either refill order. The legs: every op of the
beam acts row-wise; the step runs the same selection at a per-row
position; the done predicate is the early-exit one (all beams finished
before and after the step, or the slot's budget spent), and stopping
there equals running on (tests/test_beam_early_exit.py). On the card a
slot count other than the batch size gives the GEMMs another M, where
cuBLAS may pick another algorithm and the last bits may differ.

Paged KV arena (``cfg.engine_paged_kv``, default on; decode/paging.py):
the self-attention caches live in a pool of blocks, ``k_pool``/``v_pool``
(L, P + 1, K, H, block, d_head), addressed by a per-slot block table
(S, W). Block P is a scratch block: table entries past a slot's
reservation, and every entry of an idle or settled slot during a step,
hold the sentinel P, whose reads land there (masked to an exact 0 weight)
and whose writes land there (never on a block harvest has handed to
another slot). Only finite values are ever written there. Insert grants a
slot the blocks its tar budget reserves; harvest releases them whole,
unzeroed. When the pool is smaller than full residency, the head staged
row waits for harvests to free blocks (head-of-line, so the order of
admission, and with it the output, stays a function of the stream). The
block allocator is refcounted and checks itself
(:meth:`SlotEngine.allocator_invariants`).

Cross-request reuse (``cfg.prefix_cache``; decode/prefix_cache.py):
``admit`` content-addresses each valid row by a keyed blake2b digest of
its packed payload and runs two host-side passes before any prefill. (a)
In-flight dedup: a row byte-identical to one already admitted on this
engine coalesces onto that seat as a follower (no seat, no blocks, no
prefill); ``harvest`` delivers the leader's (tokens, probs) to every
follower's own position. (b) The prefill-result cache: when every
remaining row's artifacts are cached, the staged chunk is built from them
on the host and copied to the device, with no prefill (``prefills_saved``).
A chunk that does prefill fills the cache: its rows' artifacts (one beam
lane a row) are copied to the host without blocking at admit (into pinned
buffers on the card) and stored at the next harvest, whose done-mask read
has already waited for those copies, so filling adds no host sync. Both
passes are bitwise: a hit decodes from the same artifact bits as its cold
prefill (tests/test_torch_prefix_cache.py).

Degradation (robust/faults.py, robust/watchdog.py): ``faults`` (an armed
injector) is checked at the ``engine.prefill``, ``engine.step`` and
``engine.harvest`` sites before each piece touches the device. ``retire()``
marks the engine dead and hands back a re-admission batch for every
request it still owed; each piece checks ``retired`` right after its fault
check and after its device work, so a call the watchdog abandoned (an
injected hang sleeps before any launch) queues nothing on the card and
touches no scheduling state once it wakes.

Replicas (parallel/fleet.py) are engines with a ``tag`` (``r<i>``, a
spare's ``sp<i>``, a respawn's ``r<i>~<k>``) that names them in the
retirement, respawn and heartbeat records; each keeps the device of the
model it is given, and each builds its own serving tiers.

Serving tiers (decode/quant.py): ``cfg.kv_dtype="bf16"`` allocates the
arena (pool blocks or stripes) in bf16 through the prefill's
``cache_seed``; writes cast, reads upcast. ``cfg.serve_precision`` runs
every step, draft and verify on a decode-side module of bf16 or int8
weights (int8 dequantized once a dispatch); prefill keeps the original
weights. Both are identities on the f32 path.

Speculative decode (decode/spec.py, ``cfg.spec_decode``): a step dispatch
becomes a draft (k tokens a slot from the ``copy`` or ``draft`` tier)
and a verify (up to k gated exact steps, ``_one_step(gate=...)``, one
host read of the loop's predicate a frame), with ``STALL_COOLDOWN`` plain
dispatches after a verify whose drafts all missed. The output does not
depend on it. The verify's device counters ride back with the harvest's
done-mask read.

Sanitizer (analysis/sanitizer.py): with a ``guard`` every dispatch is
stepped under its label (:meth:`SlotEngine.labels`, the JAX package's
names): a prefill with its batch, the insert, step (or draft and verify)
and harvest with the arena, so a signature that drifts after the first
dispatch raises; the prewarm is each label's first. An armed leak guard
ledgers every paged-block grant until its release.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fira_tpu_torch.analysis.sanitizer import leak_guard, program_label
from fira_tpu_torch.config import FiraConfig, unsupported
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.decode import paging
from fira_tpu_torch.decode import prefix_cache as prefix_cache_lib
from fira_tpu_torch.decode import quant
from fira_tpu_torch.decode import spec as spec_lib
from fira_tpu_torch.decode.beam import (_init_beam, _select, _select_factored,
                                        step_valid_mask)
from fira_tpu_torch.model.model import FiraModel

PREFILL_KIND = "engine_prefill"
STEP_LABEL = "engine_step"
INSERT_LABEL = "engine_insert"
HARVEST_LABEL = "engine_harvest"


@dataclasses.dataclass
class EngineStats:
    """Dispatch and occupancy accounting of one engine (the JAX
    package's fields). Under spec decode ``steps`` counts a verify
    dispatch as one step; the frames it ran are ``spec_frames``."""

    slots: int
    prefills: int = 0            # prefill dispatches (chunks)
    refills: int = 0             # insert dispatches
    slots_refilled: int = 0      # slot fills over all inserts
    steps: int = 0               # micro-steps (R a dispatch)
    step_dispatches: int = 0     # step dispatches
    occupied_slot_steps: int = 0  # (slot, micro-step) pairs of real work
    commits: int = 0             # samples harvested
    # paged-KV accounting, stamped by every step dispatch
    pool_blocks: int = 0         # pool size P (paged only)
    kv_block_size: int = 0       # positions a block (paged only)
    kv_bytes_per_slot: int = 0   # committed K+V cache bytes a slot
    block_steps: int = 0         # blocks in use, summed a step dispatch
    peak_blocks: int = 0         # most blocks in use at once
    # harvest reads only the settled slots' rows
    harvest_row_reads: int = 0   # settled rows read back
    harvest_bytes_read: int = 0  # bytes those reads copied
    harvest_bytes_saved: int = 0  # against reading the whole arena
    # cross-request reuse (cfg.prefix_cache; all 0 with it off)
    cache_hits: int = 0          # seated rows served from the cache
    cache_misses: int = 0        # seated rows that paid a prefill with
    #                              the cache on
    cache_evictions: int = 0     # LRU entries evicted for capacity
    cache_integrity_drops: int = 0  # entries dropped on checksum mismatch
    prefills_saved: int = 0      # admitted chunks that ran no prefill
    #                              (every row a hit or coalesced)
    cache_hbm_bytes_saved: int = 0  # artifact bytes served from the cache
    dedup_fanout: int = 0        # requests coalesced onto an existing
    #                              seat (delivered at its harvest)
    shared_block_peak: int = 0   # most paged blocks at once whose seat
    #                              serves a coalesced group
    # speculative decode (cfg.spec_decode; all 0 with it off)
    drafted: int = 0             # tokens drafted (k x live slots at a
    #                              verify's entry)
    accepted: int = 0            # drafted tokens the verify matched
    verify_dispatches: int = 0   # draft + verify dispatches
    steps_saved: int = 0         # row-frames a verify advanced beyond its
    #                              frame-0 obligation
    spec_frames: int = 0         # verify frames run
    # the serving tiers, stamped by every step dispatch
    kv_dtype: str = "f32"        # K/V arena storage type (f32|bf16)
    serve_precision: str = "f32"  # decode weight tier (f32|bf16|int8w)
    # the port's own: blocking device-to-host reads (harvest's), and the
    # step dispatches prewarm ran outside these counts
    host_syncs: int = 0
    warm_step_dispatches: int = 0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def slot_occupancy(self) -> float:
        """Mean share of slots doing real beam work a micro-step."""
        total = self.steps * self.slots
        return self.occupied_slot_steps / total if total else 0.0

    @property
    def steps_per_commit(self) -> float:
        return self.steps / self.commits if self.commits else 0.0

    @property
    def pool_utilization(self) -> float:
        """Mean share of the pool mapped to live slots a step dispatch;
        1.0 for the unpaged arena (its stripes are committed whether a
        slot is live or not), 0.0 with no KV cache."""
        if self.pool_blocks and self.step_dispatches:
            return self.block_steps / (self.step_dispatches
                                       * self.pool_blocks)
        return 1.0 if self.kv_bytes_per_slot else 0.0

    @property
    def dispatches(self) -> int:
        return self.prefills + self.refills + self.step_dispatches

    def summary(self) -> Dict[str, float]:
        """The JAX package's keys, then the port's ``host_syncs`` and
        ``warm_step_dispatches``."""
        return {
            "slots": self.slots,
            "prefills": self.prefills,
            "refills": self.refills,
            "slots_refilled": self.slots_refilled,
            "steps_run": self.steps,
            "step_dispatches": self.step_dispatches,
            "commits": self.commits,
            "dispatches": self.dispatches,
            "slot_occupancy": round(self.slot_occupancy, 4),
            "steps_per_commit": round(self.steps_per_commit, 3),
            "pool_blocks": self.pool_blocks,
            "kv_block_size": self.kv_block_size,
            "kv_bytes_per_slot": self.kv_bytes_per_slot,
            "peak_blocks": self.peak_blocks,
            "pool_utilization": round(self.pool_utilization, 4),
            "harvest_row_reads": self.harvest_row_reads,
            "harvest_bytes_read": self.harvest_bytes_read,
            "harvest_bytes_saved": self.harvest_bytes_saved,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "cache_evictions": self.cache_evictions,
            "cache_integrity_drops": self.cache_integrity_drops,
            "prefills_saved": self.prefills_saved,
            "cache_hbm_bytes_saved": self.cache_hbm_bytes_saved,
            "dedup_fanout": self.dedup_fanout,
            "shared_block_peak": self.shared_block_peak,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "verify_dispatches": self.verify_dispatches,
            "steps_saved": self.steps_saved,
            "spec_frames": self.spec_frames,
            "kv_dtype": self.kv_dtype,
            "serve_precision": self.serve_precision,
            "host_syncs": self.host_syncs,
            "warm_step_dispatches": self.warm_step_dispatches,
        }


@dataclasses.dataclass
class EngineItem:
    """One settled sample: ``tokens[argmax(probs)]`` is the prediction,
    copy ids already resolved (the batched beam's contract)."""

    position: int        # split position (the output order key)
    host: Dict           # the host batch the sample came in
    row: int             # its row in that batch
    tokens: np.ndarray   # (beam, tar_len) int64
    probs: np.ndarray    # (beam,) float32


@dataclasses.dataclass
class _Staged:
    """A prefilled chunk whose rows are not all seated yet."""

    chunk: Dict                  # device tensors from the prefill
    host: Dict                   # the host batch (text fields, positions)
    rows: "collections.deque[Tuple[int, int]]"  # (row, split position)
    limit: int                   # the rows' tar budget (the bucket's tar
                                 # under decode_tar_buckets, else tar_len):
                                 # caps generation, sizes the reservation


class SlotEngine:
    """S-slot continuous-batching beam decoder over ``model`` (its weights
    and its device). ``slots``: the arena size (default
    ``cfg.engine_slots`` or, when that is 0, ``cfg.test_batch_size``: the
    batched beam's shapes). ``pool_blocks``: the paged pool (default
    ``cfg.kv_pool_blocks``; 0 = full residency). ``tag``: the replica's
    name in a fleet (None: a lone engine, recorded as ``r0``). The serving
    tiers and spec decode are built here, from ``model``'s weights, so a
    respawned replica or a spare re-quantizes by construction."""

    def __init__(self, model: FiraModel, cfg: FiraConfig, *,
                 slots: Optional[int] = None,
                 pool_blocks: Optional[int] = None, faults=None,
                 tag: Optional[str] = None, guard=None):
        errs = unsupported(cfg)
        if errs:
            raise ValueError("config selects paths the port does not run: "
                             + "; ".join(errs))
        self.model, self.cfg, self.tag = model, cfg, tag
        # robust.faults.FaultInjector or None; ``retired`` is set by
        # retire(): every piece returns early on a retired engine
        self._faults = faults
        self.retired = False
        # an armed analysis.sanitizer.CompileGuard (None: off): every
        # dispatch is labelled, its input signature fixed at its first
        self.guard = guard
        # the resource-lifecycle sanitizer: armed, every paged-block grant
        # is ledgered until its release; unarmed, one is-None branch
        self._leaks = leak_guard()
        self.device = next(model.parameters()).device
        self.slots = int(slots or cfg.engine_slots or cfg.test_batch_size)
        if self.slots < 1:
            raise ValueError(f"engine needs >= 1 slot, got {self.slots}")
        self._neg = -1.0 if cfg.beam_compat_prob_space else -float("inf")
        self._paged = bool(cfg.beam_kv_cache and cfg.engine_paged_kv)
        self._block_size = self._table_width = self._pool_blocks = 0
        self._kv_bytes_per_slot = 0
        if self._paged:
            self._block_size = paging.resolve_block_size(cfg)
            if cfg.tar_len % self._block_size:
                raise ValueError(
                    f"kv_block_size {self._block_size} does not divide "
                    f"tar_len {cfg.tar_len}; the block table must tile "
                    f"the arena budget exactly (decode/paging.py)")
            self._table_width = cfg.tar_len // self._block_size
            self._pool_blocks = int(
                pool_blocks if pool_blocks is not None
                else cfg.kv_pool_blocks) or paging.auto_pool_blocks(
                    cfg, self.slots)
            if self._pool_blocks < self._table_width:
                raise ValueError(
                    f"kv_pool_blocks {self._pool_blocks} < table width "
                    f"{self._table_width}: one full-tar sample must fit "
                    f"an empty pool or admission livelocks")
        # the cross-request prefill cache (None = off)
        self._cache = None
        if cfg.prefix_cache:
            self._cache = prefix_cache_lib.PrefixCache(
                cfg.prefix_cache_entries, max_bytes=cfg.prefix_cache_bytes,
                faults=faults)
        # the torch dtype of each artifact field, from the first prefill:
        # the cache holds numpy (bf16 as int16 bits)
        self._artifact_dtypes: Dict[str, torch.dtype] = {}
        self.stats = EngineStats(slots=self.slots)
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._pending_occ = torch.zeros((), dtype=torch.long,
                                        device=self.device)
        # the serving tiers (decode/quant.py): the label fragment, the
        # digest namespace and the decode-side module (``model`` itself
        # on the f32 path) with its int8 scales (None but for int8w)
        self._tier_tag = quant.tier_tag(cfg)
        self._tier_ns = quant.tier_namespace(cfg)
        self._dmodel, self._wq_scales = quant.quantize_decode_params(
            model, cfg)
        # speculative decode (decode/spec.py): the drafter over the
        # decode-side module; _spec_cd counts the plain dispatches left
        # in a stall cooldown; _pending_spec holds the last verify's
        # device counters [tested, matched] and its frames, drained at
        # harvest
        self._spec_tier = (cfg.spec_decode
                           if cfg.spec_decode not in (None, "off") else None)
        self._spec_k = int(cfg.engine_spec_k)
        self._spec_cd = 0
        self._pending_spec = None
        self._drafter = None
        if self._spec_tier is not None:
            self._drafter = spec_lib.make_drafter(self._dmodel, cfg,
                                                  self.slots, self._paged)
        self.begin_stream()

    # --- the declared program family ---------------------------------------

    def label(self, kind: str, geom_tag: Optional[str] = None) -> str:
        """The name of one of this engine's dispatches: the geometry tag
        (prefill), the serving tier's tag and the replica tag compose as
        in the JAX package, ``engine_prefill[a16.e256.t12.r1]``,
        ``engine_step[bf16kv.int8w.r1]``; with no tags the lone f32
        engine's names are the bare kinds."""
        mods = ".".join(t for t in (geom_tag, self._tier_tag, self.tag) if t)
        return program_label(kind, mods or None)

    def labels(self, table=None) -> List[str]:
        """This engine's declared dispatch family: a prefill a decode
        bucket geometry (or the untagged one), step, insert, harvest, and
        the (S, k) draft and verify when spec is on."""
        from fira_tpu_torch.data.buckets import geom_tag

        return self.labels_for_tags(
            [geom_tag(g) for g in table] if table is not None else [None])

    def labels_for_tags(self, geom_tags) -> List[str]:
        """:meth:`labels` from the prefill geometry tags directly (None:
        the untagged prefill), the form a respawned replica declares
        with."""
        return ([self.label(PREFILL_KIND, t) for t in geom_tags]
                + [self.label(STEP_LABEL), self.label(INSERT_LABEL),
                   self.label(HARVEST_LABEL)] + self._spec_labels())

    def _prefill_label(self, host: Dict) -> str:
        """A prefill's label: its batch's bucket tag under ``cfg.buckets``,
        untagged at the single full geometry (as the JAX package's)."""
        return self.label(PREFILL_KIND,
                          host.get("_tag") if self.cfg.buckets else None)

    def _guard_step(self, label: str, *inputs) -> None:
        if self.guard is not None:
            self.guard.step(label, *inputs)

    def _guard_dispatch(self, spec: bool) -> None:
        """The guard's step of one step dispatch over the arena: the draft
        and verify pair with spec decode, else the step."""
        if self.guard is None:
            return
        if spec:
            km = f"k{self._spec_k}"
            self.guard.step(self.label(spec_lib.DRAFT_LABEL, km), self._state)
            self.guard.step(self.label(spec_lib.VERIFY_LABEL, km),
                            self._state)
        else:
            self.guard.step(self.label(STEP_LABEL), self._state)

    def _spec_labels(self) -> List[str]:
        """The draft and verify names when spec is on (``k<k>`` composes
        with the other tags: ``engine_verify[k4.r1]``), else none."""
        if self._spec_tier is None:
            return []
        km = f"k{self._spec_k}"
        return [self.label(spec_lib.DRAFT_LABEL, km),
                self.label(spec_lib.VERIFY_LABEL, km)]

    # --- device pieces ---------------------------------------------------

    def _index(self, values) -> torch.Tensor:
        """Host ints to an int64 tensor on the device. On the card the
        copy comes from pinned memory and does not block (a pageable copy
        would wait for the whole queue: a host sync)."""
        # firacheck: allow[HOST-SYNC] values are host slot/row ids; the index tensor is built on the host and copied from pinned memory, no device value exists here
        t = torch.as_tensor(np.asarray(values, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _prefill(self, batch) -> Dict[str, torch.Tensor]:
        """The batched beam's per-batch preamble: encode once, then (KV
        cache) per-layer cross K/V and the copy head's source projection
        repeated per beam, or (full prefix) the per-beam encoder states."""
        cfg, model, K = self.cfg, self.model, self.cfg.beam_size
        states, mask = model.encode(batch)
        out = {"src_mask": mask, "diff": batch["diff"],
               "sub_token": batch["sub_token"]}
        if cfg.beam_kv_cache:
            cross_k, cross_v, src_proj = model.decode_init(states)
            out["cross_k"] = cross_k.repeat_interleave(K, dim=1)
            out["cross_v"] = cross_v.repeat_interleave(K, dim=1)
            out["src_proj"] = src_proj.repeat_interleave(K, dim=0)
            # the self-attention caches hold the ENCODER STATES' type, as
            # the batched beam's (f32 under bf16 compute with
            # stable_residual), unless the bf16 KV tier pins them to bf16
            out["cache_seed"] = torch.zeros(
                (), dtype=quant.kv_seed_dtype(self.cfg, states.dtype))
        else:
            out["states"] = states.repeat_interleave(K, dim=0)
        if not self._artifact_dtypes:
            self._artifact_dtypes = {f: out[f].dtype
                                     for f in self._artifact_fields()}
        return out

    def _ensure_state(self, chunk) -> None:
        """Allocate the arena, every slot dead, from the first chunk's
        shapes and types."""
        if self._state is not None:
            return
        cfg, dev = self.cfg, self.device
        S, K, T = self.slots, cfg.beam_size, cfg.tar_len
        L, H = cfg.num_layers, cfg.num_head
        d_head = cfg.embedding_dim // H

        def zeros(shape, like):
            return torch.zeros(shape, dtype=like.dtype, device=dev)

        z = {
            "tokens": torch.zeros((S, K, T), dtype=torch.long, device=dev),
            "probs": torch.zeros((S, K), dtype=torch.float32, device=dev),
            "finished": torch.zeros((S, K), dtype=torch.bool, device=dev),
            "pos": torch.zeros((S,), dtype=torch.long, device=dev),
            "live": torch.zeros((S,), dtype=torch.bool, device=dev),
            "done": torch.zeros((S,), dtype=torch.bool, device=dev),
            "diff": zeros((S,) + chunk["diff"].shape[1:], chunk["diff"]),
            "sub_token": zeros((S,) + chunk["sub_token"].shape[1:],
                               chunk["sub_token"]),
            "src_mask": zeros((S,) + chunk["src_mask"].shape[1:],
                              chunk["src_mask"]),
            # the slot's tar budget: full until a shorter-bucket sample
            # is seated (decode_tar_buckets)
            "limit": torch.full((S,), T, dtype=torch.long, device=dev),
        }
        if cfg.beam_kv_cache:
            ck = chunk["cross_k"]
            for f in ("cross_k", "cross_v"):
                z[f] = zeros((L, S * K) + ck.shape[2:], ck)
            sp = chunk["src_proj"]
            z["src_proj"] = zeros((S * K,) + sp.shape[1:], sp)
            cd = chunk["cache_seed"]
            if self._paged:
                P, BS, W = (self._pool_blocks, self._block_size,
                            self._table_width)
                # P blocks and the scratch block P
                z["k_pool"] = zeros((L, P + 1, K, H, BS, d_head), cd)
                z["v_pool"] = zeros((L, P + 1, K, H, BS, d_head), cd)
                z["block_tab"] = torch.full((S, W), P, dtype=torch.long,
                                            device=dev)   # all unmapped
            else:
                z["k_cache"] = zeros((L, S * K, H, T, d_head), cd)
                z["v_cache"] = zeros((L, S * K, H, T, d_head), cd)
            self._kv_bytes_per_slot = paging.kv_bytes_per_slot(
                cfg, paged=self._paged, block_size=self._block_size,
                pool_blocks=self._pool_blocks, slots=S,
                itemsize=cd.element_size())
        else:
            st = chunk["states"]
            z["states"] = zeros((S * K,) + st.shape[1:], st)
        self._state = z

    def _insert(self, chunk, rows: List[int], slots: List[int], limit: int,
                block_rows: Optional[np.ndarray]) -> None:
        """Copy chunk rows ``rows`` into slots ``slots`` (one each), with
        tar budget ``limit`` and (paged arena) the block grants
        ``block_rows`` (n, W), P-padded past the reservation.

        No cache is zeroed, in either arena: a fresh slot's unwritten
        positions get -1e9 from the step's validity mask, and exp(-1e9 -
        m) is exactly 0, so stale values multiply a hard zero; the paged
        arena only maps blocks."""
        cfg, st, K = self.cfg, self._state, self.cfg.beam_size
        n = len(rows)
        # firacheck: allow[HOST-SYNC] rows and slots are the host int lists refill planned; no device value exists here
        r_np, s_np = np.asarray(rows), np.asarray(slots)
        lanes = np.arange(K)
        # rows, slots and their per-beam rows in one copy to the device
        idx = self._index(np.concatenate([
            r_np, s_np, (r_np[:, None] * K + lanes).reshape(-1),
            (s_np[:, None] * K + lanes).reshape(-1)]))
        r, s = idx[:n], idx[n:2 * n]
        r_bk, s_bk = idx[2 * n:2 * n + n * K], idx[2 * n + n * K:]
        tokens0, probs0, finished0, _neg = _init_beam(n, cfg, self.device)
        st["tokens"].index_copy_(0, s, tokens0)
        st["probs"].index_copy_(0, s, probs0)
        st["finished"].index_copy_(0, s, finished0)
        for f in ("diff", "sub_token", "src_mask"):
            st[f].index_copy_(0, s, chunk[f].index_select(0, r))
        st["pos"].index_fill_(0, s, 0)
        st["live"].index_fill_(0, s, True)
        st["done"].index_fill_(0, s, False)
        st["limit"].index_fill_(0, s, limit)
        if cfg.beam_kv_cache:
            for f in ("cross_k", "cross_v"):
                st[f].index_copy_(1, s_bk, chunk[f].index_select(1, r_bk))
            st["src_proj"].index_copy_(
                0, s_bk, chunk["src_proj"].index_select(0, r_bk))
            if self._paged:
                st["block_tab"].index_copy_(0, s, self._index(block_rows))
        else:
            st["states"].index_copy_(0, s_bk,
                                     chunk["states"].index_select(0, r_bk))

    def _one_step(self, gate=None) -> torch.Tensor:
        """One beam position of every live, not yet done slot, in place,
        on the decode-side module; returns the number of active slots (a
        device scalar). Reads nothing back to the host.

        ``gate`` (None on the plain path, which then launches what it
        always did): an (S,) bool the spec verify ANDs into the active
        mask, freezing rows whose drafts diverged. A frozen row is an
        inactive row (blended state; paged: its table rows address the
        scratch block, so it neither appends nor permutes), with one more
        care in the unpaged arena: its cache rows take the identity
        permutation, since it resumes later and must find its history
        unshuffled."""
        cfg, model, st = self.cfg, self._dmodel, self._state
        S, K, T = self.slots, cfg.beam_size, cfg.tar_len
        tokens, probs, finished, pos = (st["tokens"], st["probs"],
                                        st["finished"], st["pos"])
        active = st["live"] & ~st["done"]
        if gate is not None:
            active = active & gate
        # idle and settled rows clamp to a legal position; what they
        # compute is blended away below
        pos_c = pos.clamp(max=T - 2)
        flat = tokens.reshape(S * K, T)
        pos_bk = pos_c.repeat_interleave(K)
        mask_k = st["src_mask"].repeat_interleave(K, dim=0)
        slot_src = {"diff": st["diff"], "sub_token": st["sub_token"]}
        all_fin_before = finished.all(dim=1)
        fac = cfg.beam_factored_topk

        if cfg.beam_kv_cache:
            valid = step_valid_mask(flat, pos_bk, T)[:, None, None, :]
            tok_in = flat.gather(1, pos_bk[:, None])
            tail = (st["cross_k"], st["cross_v"], st["src_proj"], valid)
            if self._paged:
                # idle and settled slots neither write nor permute real
                # blocks: their table rows may name blocks harvest has
                # returned and insert granted to another slot, so they
                # address the scratch block P for this step
                tab = torch.where(active[:, None], st["block_tab"],
                                  self._pool_blocks)
                step = (model.dist_parts_step_paged if fac
                        else model.fused_probs_step_paged)
                out = step(mask_k, tok_in, pos_bk, st["k_pool"],
                           st["v_pool"], tab, *tail)
            else:
                step = (model.dist_parts_step_multi if fac
                        else model.fused_probs_step_multi)
                out = step(mask_k, tok_in, pos_bk, st["k_cache"],
                           st["v_cache"], *tail)
            parts = [p[:, 0] for p in out[:-2]]
        else:
            tar_mask = flat != 0
            tar_mask[:, 0] = True
            if fac:
                parts = model.dist_parts(st["states"], mask_k, flat, tar_mask)
            else:
                parts = (model.fused_probs(st["states"], mask_k, flat,
                                           tar_mask),)
            # each row's own position out of the full-prefix decode
            rows = torch.arange(S * K, device=flat.device)
            parts = [p[rows, pos_bk] for p in parts]
        parts = [p.reshape(S, K, -1) for p in parts]
        select = _select_factored if fac else _select
        new_tokens, new_probs, new_finished, src_beam = select(
            *parts, tokens, probs, finished, pos_c, slot_src, cfg, self._neg)

        if cfg.beam_kv_cache and self._paged:
            # the caches follow their beams: block contents move between
            # beam lanes inside each slot's own blocks (the table stays);
            # grants never overlap, so real targets are disjoint, and the
            # gather is a copy before the write
            idx = src_beam[None, :, None, :, None, None, None]
            for f in ("k_pool", "v_pool"):
                pool = st[f]
                blocks = pool[:, tab]           # (L, S, W, K, H, BS, dh)
                pool[:, tab] = blocks.gather(3, idx.expand(blocks.shape))
        elif cfg.beam_kv_cache:
            # the batched beam's gather; idle and settled rows permute
            # their own stale rows, which no later step reads unwritten;
            # a row the verify froze keeps its rows in place
            if gate is not None:
                src_beam = torch.where(
                    active[:, None], src_beam,
                    torch.arange(K, device=flat.device)[None, :])
            rows = (src_beam + torch.arange(S, device=flat.device)[:, None]
                    * K).reshape(-1)
            for f in ("k_cache", "v_cache"):
                st[f].copy_(st[f][:, rows])

        a = active
        st["tokens"] = torch.where(a[:, None, None], new_tokens, tokens)
        st["probs"] = torch.where(a[:, None], new_probs, probs)
        st["finished"] = torch.where(a[:, None], new_finished, finished)
        new_pos = torch.where(a, pos + 1, pos)
        st["pos"] = new_pos
        # the early-exit predicate a slot: settled once an all-finished
        # beam set has been re-sorted by a step, or its budget spent
        all_fin_after = st["finished"].all(dim=1)
        st["done"] = st["done"] | (a & ((new_pos >= st["limit"] - 1)
                                        | (all_fin_before & all_fin_after)))
        return a.sum()

    def _step(self) -> torch.Tensor:
        """R = ``cfg.engine_harvest_every`` micro-steps (slots that settle
        on the way mask themselves out, so R moves only which dispatch a
        harvest lands in); returns their active-slot count, on the
        device."""
        occ = self._one_step()
        # firacheck: allow[HOST-SYNC] engine_harvest_every is a config int; no device value exists here
        for _ in range(max(1, int(self.cfg.engine_harvest_every)) - 1):
            occ = occ + self._one_step()
        return occ

    def _read_flag(self, flag: torch.Tensor) -> bool:
        """One device flag to the host: the verify loop's predicate (a
        host sync, counted). False on a retired engine, so a verify the
        watchdog abandoned launches no further frame."""
        if self.retired:
            return False
        self.stats.host_syncs += 1
        return bool(flag)

    def _spec_round(self):
        """One draft and its verify over the arena: (occupancy at entry,
        the device counters [tested, matched], the frames run)."""
        drafts = self._drafter(self._state)
        return spec_lib.run_verify(self._one_step, self._state, drafts,
                                   self._spec_k, self.cfg.tar_len,
                                   self._read_flag)

    def _decode_call(self, fn):
        """``fn`` under the weight tier: int8 weights dequantized once for
        the whole dispatch (decode/quant.decode_call)."""
        return quant.decode_call(self._dmodel, self._wq_scales, fn)

    def _read_rows(self, slots: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        """The token and score rows of ``slots``, in one device-to-host
        copy (ids below 2**53 and f32 scores are exact in f64)."""
        st, n = self._state, len(slots)
        idx = self._index(slots)
        toks = st["tokens"].index_select(0, idx)
        probs = st["probs"].index_select(0, idx)
        # firacheck: allow[HOST-SYNC] harvest IS the engine's designated output boundary: settled beams must reach the host to be cooked into text, and the sliced row gather is exactly the copy this readback exists to make
        packed = torch.cat([toks.reshape(n, -1).double(), probs.double()],
                           dim=1).cpu()
        self.stats.host_syncs += 1
        kt = toks[0].numel()
        # firacheck: allow[HOST-SYNC] packed is the host copy the .cpu() above made; no device value exists here
        return (packed[:, :kt].long().reshape(toks.shape).numpy(),
                # firacheck: allow[HOST-SYNC] same host copy as the line above
                packed[:, kt:].float().numpy())

    @torch.inference_mode()
    def prewarm(self, hosts: Iterable[Dict]) -> None:
        """One warm dispatch of every piece before a timed run, so that
        the kernels' build and first launch fall outside it: a prefill of
        each host batch (one a decode bucket), an insert into slot 0 that
        is undone, one step over the all-dead arena (nothing active:
        nothing changes), one row read, and with spec decode one draft and
        one verify over it (no live row: no frame runs). Leaves no trace in
        the stats but ``warm_step_dispatches``."""
        chunk = None
        for host in hosts:
            batch = batch_to_device(host, self.device)
            chunk = self._prefill(batch)
            self._guard_step(self._prefill_label(host), batch)
            self._ensure_state(chunk)
        if chunk is None:
            return
        syncs = self.stats.host_syncs
        unmapped = (np.full((1, self._table_width), self._pool_blocks)
                    if self._paged else None)
        self._insert(chunk, [0], [0], self.cfg.tar_len, unmapped)
        self._guard_step(self.label(INSERT_LABEL), self._state)
        self._state["live"][0] = False
        self._decode_call(self._step)
        self._guard_dispatch(False)
        if self._spec_tier is not None:
            self._decode_call(self._spec_round)
            self._guard_dispatch(True)
        self._read_rows([0])
        self._guard_step(self.label(HARVEST_LABEL), self._state)
        self.stats.host_syncs = syncs
        self.stats.warm_step_dispatches += 1

    # --- host scheduler ------------------------------------------------

    def begin_stream(self) -> None:
        """Reset the host scheduling state for a fresh stream (the arena,
        the prefix cache and the stats persist)."""
        self._staged: "collections.deque[_Staged]" = collections.deque()
        self._staged_rows = 0
        self._free: "collections.deque[int]" = collections.deque(
            range(self.slots))
        self._busy: Dict[int, Tuple[int, Dict, int]] = {}
        # the paged allocator: a free deque and refcounted grants; the
        # pool's contents stay (stale values are masked, never read)
        self._free_blocks: "collections.deque[int]" = collections.deque(
            range(self._pool_blocks))
        self._block_refs: Dict[int, int] = {}
        self._slot_blocks: Dict[int, List[int]] = {}
        # in-flight dedup (cfg.prefix_cache): digest -> leader position of
        # every admitted, unharvested row, its reverse, and leader position
        # -> the followers coalesced onto its seat
        self._inflight: Dict[str, int] = {}
        self._row_digest: Dict[int, str] = {}
        self._followers: Dict[int, List[Tuple[int, Dict, int]]] = {}
        # positions whose seat serves a group coalesced above the engine
        # (the serve loop keeps those followers): stamped by the loop each
        # round, read only by the shared-block meter
        self.shared_positions: set = set()
        # cache fills waiting for the next harvest: (rows and digests,
        # the rows' artifacts on their way to the host)
        self._pending_fills: List[Tuple[List[Tuple[int, str]], Dict]] = []

    def _acquire_blocks(self, need: int) -> List[int]:
        """Grant ``need`` free blocks at refcount 1 (the caller checked
        there are enough)."""
        grant: List[int] = []
        for _ in range(need):
            b = self._free_blocks.popleft()
            assert self._block_refs.get(b, 0) == 0, \
                f"block {b} granted while already held (double grant)"
            self._block_refs[b] = 1
            grant.append(b)
        if self._leaks is not None:
            for b in grant:
                self._leaks.note_acquire(
                    "block", f"{self.tag or 'engine'}@{id(self):x}:{b}",
                    what=f"paged block {b}")
        return grant

    def _release_blocks(self, blocks) -> None:
        """Drop one reference a block; at zero it returns to the free
        deque."""
        for b in blocks:
            n = self._block_refs.get(b, 0)
            assert n > 0, f"block {b} released while not granted"
            if n == 1:
                del self._block_refs[b]
                self._free_blocks.append(b)
                if self._leaks is not None:
                    self._leaks.note_release(
                        "block", f"{self.tag or 'engine'}@{id(self):x}:{b}")
            else:
                self._block_refs[b] = n - 1

    def allocator_invariants(self) -> List[str]:
        """Allocator health: every pool block free or granted, none
        granted twice, refcounts matching the grants. Empty = healthy."""
        errs: List[str] = []
        free = list(self._free_blocks)
        if len(set(free)) != len(free):
            errs.append("duplicate blocks on the free list")
        granted: Dict[int, int] = {}
        for blocks in self._slot_blocks.values():
            for b in blocks:
                granted[b] = granted.get(b, 0) + 1
        for b, holders in granted.items():
            refs = self._block_refs.get(b, 0)
            if refs < holders:
                errs.append(f"block {b} held by {holders} grant(s) but "
                            f"refcount {refs}")
        for b, refs in self._block_refs.items():
            if refs < 1:
                errs.append(f"block {b} carries refcount {refs} <= 0")
        overlap = set(granted) & set(free)
        if overlap:
            errs.append(f"blocks {sorted(overlap)[:4]} both free and granted")
        if len(free) + len(self._block_refs) != self._pool_blocks:
            errs.append(
                f"free ({len(free)}) + granted ({len(self._block_refs)}) "
                f"!= pool ({self._pool_blocks})")
        return errs

    # --- prefix-cache surface -------------------------------------------

    def _artifact_fields(self) -> Tuple[str, ...]:
        return ((prefix_cache_lib.ARTIFACT_FIELDS_KV + ("cache_seed",))
                if self.cfg.beam_kv_cache
                else prefix_cache_lib.ARTIFACT_FIELDS_NOKV)

    def _fill_copies(self, chunk, rows: List[int]) -> Dict[str, torch.Tensor]:
        """Start the copies to the host of ``rows``' artifacts, one beam
        lane a row (the K lanes are equal by construction): gathered on
        the device, then copied without blocking into pinned buffers on
        the card (on the CPU the gather is the copy). The next harvest's
        done-mask read waits for them on the same stream."""
        K, dev = self.cfg.beam_size, self.device
        r = self._index(rows)
        lanes = r * K
        out = {}
        for f in self._artifact_fields():
            t = chunk[f]
            if f == "cache_seed":
                g = t
            elif f in ("cross_k", "cross_v"):
                g = t.index_select(1, lanes)
            elif f in ("src_proj", "states"):
                g = t.index_select(0, lanes)
            else:
                g = t.index_select(0, r)
            if dev.type == "cuda":
                host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                host.copy_(g, non_blocking=True)
                g = host
            out[f] = g
        return out

    def _to_numpy(self, t: torch.Tensor) -> np.ndarray:
        """A host tensor as numpy (bf16 as its int16 bits)."""
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        # firacheck: allow[HOST-SYNC] t is the pinned host copy _fill_copies queued at admit; harvest's done-mask read already waited for it (the JAX package's deferred miss-fill draining boundary), so this is a host view
        return t.numpy()

    def _drain_pending_fills(self) -> None:
        """Store the rows of every prefill that filled the cache, by
        content digest. Runs in harvest, after its done-mask read, which
        waited for the copies on the same stream: no sync of its own."""
        while self._pending_fills:
            fills, host = self._pending_fills.pop(0)
            compact = {f: self._to_numpy(t) for f, t in host.items()}
            entries = prefix_cache_lib.extract_payloads(
                compact, list(range(len(fills))), 1)
            for i, (_r, d) in enumerate(fills):
                self.stats.cache_evictions += self._cache.put(d, entries[i])

    def _chunk_from_cache(self, payloads: Dict[int, Dict], C: int
                          ) -> Dict[str, torch.Tensor]:
        """The staged chunk of cached rows: one lane a row built on the
        host, copied to the device and repeated across the beam there,
        bitwise what the prefill would have produced for those rows."""
        K, dev = self.cfg.beam_size, self.device
        compact = prefix_cache_lib.build_chunk(payloads, C, 1)
        chunk = {}
        for f, a in compact.items():
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                t = t.pin_memory()
            t = t.to(dev, non_blocking=dev.type == "cuda")
            if self._artifact_dtypes.get(f) == torch.bfloat16:
                t = t.view(torch.bfloat16)   # from its int16 bits
            if f in ("cross_k", "cross_v"):
                t = t.repeat_interleave(K, dim=1)
            elif f in ("src_proj", "states"):
                t = t.repeat_interleave(K, dim=0)
            chunk[f] = t
        return chunk

    def cache_contains(self, digest) -> bool:
        """Non-mutating cache probe (the serve loop splits a batch into
        hits and misses with it)."""
        return self._cache is not None and self._cache.contains(digest)

    def cache_put(self, digest, payload) -> None:
        """Seed one artifact payload prefilled elsewhere: the next
        admission of ``digest`` seats from the cache. A no-op without a
        cache or for a pad row's (None) digest."""
        if self._cache is not None and digest is not None:
            self.stats.cache_evictions += self._cache.put(digest, payload)

    def cache_clear(self) -> None:
        """Drop every cached entry (so a warm pass hands a timed one no
        hits)."""
        if self._cache is not None:
            self._cache.clear()

    def cache_len(self) -> int:
        return len(self._cache) if self._cache is not None else 0

    def wants_input(self) -> bool:
        """Prefill ahead: keep ``engine_prefill_depth`` chunks staged, and
        at least enough rows to refill every free slot."""
        # firacheck: allow[HOST-SYNC] engine_prefill_depth is a config int; no device value exists here
        depth = max(1, int(self.cfg.engine_prefill_depth))
        return (len(self._staged) < depth
                or self._staged_rows < len(self._free))

    def in_flight(self) -> int:
        return len(self._busy)

    def in_flight_positions(self) -> List[int]:
        """Split positions seated in slots (the serve loop stamps seat
        times from these)."""
        return [pid for (pid, _host, _row) in self._busy.values()]

    @property
    def staged_rows(self) -> int:
        """Admitted (prefilled) rows not yet seated in a slot."""
        return self._staged_rows

    def pending_positions(self) -> List[int]:
        """Every admitted, unfinished request: seated, staged, or
        coalesced onto a seat as a follower; what a retirement owes."""
        pos = [pid for (pid, _host, _row) in self._busy.values()]
        pos += [pid for e in self._staged for (_r, pid) in e.rows]
        pos += [fpos for fl in self._followers.values()
                for (fpos, _h, _r) in fl]
        return pos

    def retire(self) -> List[Dict]:
        """Mark this engine dead and hand back a re-admission batch for
        every request it still owed: one host batch a partly served chunk,
        ``valid`` restricted to the owed rows and their split positions in
        ``_positions`` (followers from their own host batches). Scheduling
        state clears, every block grant is released through the refcounted
        path; the arena and the stats stay."""
        self.retired = True   # first: an abandoned call stops when it wakes
        groups: Dict[int, List] = {}
        hosts: Dict[int, Dict] = {}
        for _slot, (pid, host, r) in sorted(self._busy.items()):
            hosts[id(host)] = host
            groups.setdefault(id(host), []).append((r, pid))
        for entry in self._staged:
            hosts[id(entry.host)] = entry.host
            groups.setdefault(id(entry.host), []).extend(entry.rows)
        for _leader, fl in sorted(self._followers.items()):
            for fpos, fhost, frow in fl:
                hosts[id(fhost)] = fhost
                groups.setdefault(id(fhost), []).append((frow, fpos))
        payloads: List[Dict] = []
        for hid, rows in groups.items():
            host = hosts[hid]
            requeued = dict(host)
            # firacheck: allow[HOST-SYNC] host["valid"] is the feeder's host-side numpy batch field; no device value exists here
            valid = np.zeros_like(np.asarray(host["valid"]))
            positions = np.full(valid.shape[0], -1, dtype=np.int64)
            for r, pid in rows:
                valid[r] = True
                positions[r] = pid
            requeued["valid"] = valid
            requeued["_positions"] = positions
            payloads.append(requeued)
        # a canonical order: by the smallest owed position
        payloads.sort(
            key=lambda b: int(b["_positions"][b["_positions"] >= 0].min()))
        self._busy.clear()
        self._staged.clear()
        self._staged_rows = 0
        self._free = collections.deque(range(self.slots))
        for slot in list(self._slot_blocks):
            self._release_blocks(self._slot_blocks.pop(slot))
        self._inflight.clear()
        self._row_digest.clear()
        self._followers.clear()
        self._pending_fills.clear()   # a dead engine fills no cache
        return payloads

    @torch.inference_mode()
    def admit(self, host: Dict, index: int, device_batch=None) -> None:
        """Prefill one packed batch and stage its real rows. ``host``:
        the host batch (``_positions`` gives each row's split position;
        without it row r of batch ``index`` is index * C + r);
        ``device_batch``: its fields already on the device (the Feeder's),
        else they are copied here.

        With ``cfg.prefix_cache`` two host passes run first: rows
        byte-identical to a request in flight coalesce onto its seat, and
        a chunk whose other rows are all cached seats from the cache with
        no prefill. The dedup and cache maps change only once staging has
        succeeded, so a prefill that raises (or that the watchdog
        abandons) leaves no orphaned follower or in-flight digest."""
        if self._faults is not None:
            self._faults.check("engine.prefill")
        if self.retired:
            return
        positions = host.get("_positions")
        valid = host["valid"]
        C = valid.shape[0]
        # firacheck: allow[HOST-SYNC] _positions is a host-only numpy field (feeder strips it from the wire); no device value exists here
        row_ids = [(r, int(positions[r]) if positions is not None
                    else index * C + r) for r in range(C) if valid[r]]
        digests = None
        if self._cache is not None and row_ids:
            digests = host.get("_digests")   # stamped on a feeder worker
            if digests is None:
                digests = prefix_cache_lib.payload_digests(
                    host, self._tier_ns)
        # pass 1, in-flight dedup (reads only; the maps commit below)
        followers: List[Tuple[int, int, int]] = []   # (leader, pos, row)
        seat_rows: List[Tuple[int, int]] = []
        if digests is not None:
            batch_leaders: Dict[str, int] = {}
            for r, pos_id in row_ids:
                d = digests[r]
                leader = None
                if d is not None:
                    leader = self._inflight.get(d)
                    if leader is None:
                        leader = batch_leaders.get(d)
                if leader is not None:
                    followers.append((leader, pos_id, r))
                else:
                    if d is not None:
                        batch_leaders[d] = pos_id
                    seat_rows.append((r, pos_id))
        else:
            seat_rows = row_ids

        # pass 2, the prefill-result cache: a chunk whose rows are all
        # cached is built from them, with no prefill
        chunk = None
        payloads: Dict[int, Dict] = {}
        pending_fill = None
        st = self.stats
        if seat_rows and self._cache is not None and all(
                self._cache.contains(digests[r]) for r, _p in seat_rows):
            for r, _pos in seat_rows:
                payload, outcome = self._cache.take(digests[r])
                if outcome == "integrity_drop":
                    st.cache_integrity_drops += 1
                if payload is None:   # a fault miss or a dropped entry:
                    payloads.clear()  # the whole chunk prefills (a cache
                    break             # fault is a miss, never a wrong
                #                       answer)
                payloads[r] = payload
        if seat_rows and len(payloads) == len(seat_rows) and payloads:
            st.cache_hits += len(payloads)
            st.cache_hbm_bytes_saved += sum(
                prefix_cache_lib.payload_nbytes(p) for p in payloads.values())
            st.prefills_saved += 1
            chunk = self._chunk_from_cache(payloads, C)
            self._ensure_state(chunk)
        elif seat_rows:
            if device_batch is None:
                device_batch = batch_to_device(host, self.device)
            chunk = self._prefill(device_batch)
            if self.retired:
                # the watchdog expired during the prefill and the engine
                # was retired: its requests were handed back already
                return
            self._guard_step(self._prefill_label(host), device_batch)
            self._ensure_state(chunk)
            st.prefills += 1
            if self._cache is not None:
                st.cache_misses += len(seat_rows)
                fills = [(r, digests[r]) for r, _pos in seat_rows
                         if digests[r] is not None]
                if fills:
                    pending_fill = (fills, self._fill_copies(
                        chunk, [r for r, _d in fills]))

        # commit, on a live engine only
        if self.retired:
            return
        if pending_fill is not None:
            self._pending_fills.append(pending_fill)
        if followers:
            for leader, pos_id, r in followers:
                self._followers.setdefault(leader, []).append(
                    (pos_id, host, r))
            st.dedup_fanout += len(followers)
            if not seat_rows:
                st.prefills_saved += 1   # the whole chunk coalesced
        if not seat_rows:
            return
        if digests is not None:
            for r, pos_id in seat_rows:
                if digests[r] is not None:
                    self._inflight[digests[r]] = pos_id
                    self._row_digest[pos_id] = digests[r]
        # the chunk's tar budget is its bucket's, visible in the packed
        # msg width, under decode_tar_buckets; else the full tar_len
        # firacheck: allow[HOST-SYNC] a shape of the host batch; no device value exists here
        limit = (int(host["msg"].shape[1]) if self.cfg.decode_tar_buckets
                 else self.cfg.tar_len)
        self._staged.append(_Staged(chunk=chunk, host=host,
                                    rows=collections.deque(seat_rows),
                                    limit=limit))
        self._staged_rows += len(seat_rows)

    @torch.inference_mode()
    def refill(self, refill_order: str = "fifo") -> None:
        """Seat staged rows in every free slot, one insert a staged chunk
        touched. Paged: each seated row is granted ceil(limit / block)
        blocks; when the pool cannot cover the head row's reservation the
        refill stops there until harvests return blocks (head-of-line).
        A retired engine seats nothing, checked at every loop boundary."""
        while not self.retired and self._free and self._staged:
            entry = self._staged[0]
            need = (paging.blocks_per_seq(entry.limit, self._block_size)
                    if self._paged else 0)
            if self._paged and len(self._free_blocks) < need:
                break
            rows, slots, grants = [], [], []
            while not self.retired and self._free and entry.rows and (
                    not self._paged or len(self._free_blocks) >= need):
                r, pos_id = entry.rows.popleft()
                slot = (self._free.popleft() if refill_order == "fifo"
                        else self._free.pop())
                if self._paged:
                    grant = self._acquire_blocks(need)
                    self._slot_blocks[slot] = grant
                    grants.append(grant + [self._pool_blocks]
                                  * (self._table_width - need))
                self._busy[slot] = (pos_id, entry.host, r)
                rows.append(r)
                slots.append(slot)
            if self.retired:
                return
            self._insert(entry.chunk, rows, slots, entry.limit,
                         # firacheck: allow[HOST-SYNC] grants are host block ids from the allocator; no device value exists here
                         np.asarray(grants) if self._paged else None)
            if self.retired:
                return
            self._guard_step(self.label(INSERT_LABEL), self._state)
            self.stats.refills += 1
            self.stats.slots_refilled += len(rows)
            self._staged_rows -= len(rows)
            if not entry.rows:
                self._staged.popleft()

    @torch.inference_mode()
    def step_dispatch(self) -> None:
        """Queue one step dispatch (R micro-steps) and read nothing back;
        or, with spec decode on and no cooldown running, one draft and
        its verify (which reads the loop's predicate a frame). Either
        advances every live slot at least one position."""
        if self._faults is not None:
            self._faults.check("engine.step")
        if self.retired:
            return
        spec_now = self._spec_tier is not None and self._spec_cd == 0
        if spec_now:
            occ, counters, iters = self._decode_call(self._spec_round)
        else:
            occ = self._decode_call(self._step)
        if self.retired:
            return   # abandoned by the watchdog: the loop owns the stats
        self._guard_dispatch(spec_now)
        self._pending_occ = occ
        self._pending_spec = (counters, iters) if spec_now else None
        if self._spec_cd > 0:
            self._spec_cd -= 1
        st = self.stats
        if spec_now:
            # one step: the forwards-a-token accounting; the frames land
            # in spec_frames at harvest
            st.steps += 1
            st.verify_dispatches += 1
        else:
            # firacheck: allow[HOST-SYNC] engine_harvest_every is a config int; no device value exists here
            st.steps += max(1, int(self.cfg.engine_harvest_every))
        st.step_dispatches += 1
        st.pool_blocks = self._pool_blocks
        st.kv_block_size = self._block_size
        st.kv_bytes_per_slot = self._kv_bytes_per_slot
        st.kv_dtype = self.cfg.kv_dtype
        st.serve_precision = self.cfg.serve_precision
        if self._paged:
            used = self._pool_blocks - len(self._free_blocks)
            st.block_steps += used
            st.peak_blocks = max(st.peak_blocks, used)
            if self._followers or self.shared_positions:
                # blocks whose seat serves a coalesced group: one grant,
                # the decode of every request in it
                fan = self.shared_positions
                shared = sum(
                    len(self._slot_blocks.get(s, ()))
                    for s, (pid, _h, _r) in self._busy.items()
                    if pid in self._followers or pid in fan)
                st.shared_block_peak = max(st.shared_block_peak, shared)

    @torch.inference_mode()
    def harvest(self) -> List[EngineItem]:
        """Read the last dispatch's done mask and occupancy (one host
        sync), store the pending cache fills, then read the settled slots'
        rows (one more sync, when any settled); free their slots and
        blocks and return their samples, each leader's followers
        included."""
        if self._faults is not None:
            self._faults.check("engine.harvest")
        if self.retired:
            return []
        st, stats = self._state, self.stats
        spec = self._pending_spec
        parts = [st["done"].long(), self._pending_occ.reshape(1).long()]
        if spec is not None:
            parts.append(spec[0].long())   # the verify's [tested, matched]
        # firacheck: allow[HOST-SYNC] the per-dispatch done-mask/occupancy read (one sync a harvest), where the JAX engine queues copy_to_host_async and reads it a dispatch later; a CUDA-graph step (ROADMAP.md A.5) must take it off the dispatch path
        flags = torch.cat(parts).cpu()
        if self.retired:
            return []
        stats.host_syncs += 1
        S = self.slots
        # firacheck: allow[HOST-SYNC] flags is the host copy the .cpu() above made; no device value exists here
        occ_now = int(flags[S])
        stats.occupied_slot_steps += occ_now
        if spec is not None:
            # firacheck: allow[HOST-SYNC] same host flags copy as above
            tested, matched = int(flags[S + 1]), int(flags[S + 2])
            self._pending_spec = None
            stats.drafted += self._spec_k * occ_now
            stats.accepted += matched
            stats.steps_saved += tested - occ_now
            stats.spec_frames += spec[1]
            if occ_now and matched == 0:
                # acceptance stalled: a few plain dispatches before the
                # next draft
                self._spec_cd = spec_lib.STALL_COOLDOWN
        if self._pending_fills:
            # stored before any dedup entry is popped below: a digest
            # leaves _inflight only once its cache entry exists
            self._drain_pending_fills()
        # firacheck: allow[HOST-SYNC] same host flags copy as above
        done = flags[:S].numpy()
        newly = [s for s in self._busy if done[s]]
        items: List[EngineItem] = []
        if not newly:
            return items
        toks, probs = self._read_rows(newly)
        if self.retired:
            return []   # abandoned mid-read: retire() requeued them all
        self._guard_step(self.label(HARVEST_LABEL), self._state)
        K, T = self.cfg.beam_size, self.cfg.tar_len
        row_bytes = (K * T + K) * 8   # the f64 rows harvest copies
        for i, s in enumerate(newly):
            pos_id, host, r = self._busy.pop(s)
            self._free.append(s)
            self._release_blocks(self._slot_blocks.pop(s, ()))
            stats.commits += 1
            stats.harvest_row_reads += 1
            items.append(EngineItem(position=pos_id, host=host, row=r,
                                    tokens=toks[i], probs=probs[i]))
            # fan-out: every follower coalesced onto this seat gets the
            # leader's beams at its own position (same digest, same
            # payload bytes, so the same decode)
            d = self._row_digest.pop(pos_id, None)
            if d is not None:
                self._inflight.pop(d, None)
            for fpos, fhost, frow in self._followers.pop(pos_id, ()):
                stats.commits += 1
                items.append(EngineItem(position=fpos, host=fhost, row=frow,
                                        tokens=toks[i], probs=probs[i]))
        stats.harvest_bytes_read += row_bytes * len(newly)
        stats.harvest_bytes_saved += row_bytes * (self.slots - len(newly))
        return items

    def run(self, feed, *, refill_order: str = "fifo"
            ) -> Iterator[EngineItem]:
        """Drive the engine over ``feed``, an iterable of
        ``data.feeder.FedBatch`` (the batched beam's packed batches:
        ``item.device`` is the prefill input, ``item.host`` keeps the text
        fields and ``_positions``). ``refill_order``: which free slot a
        waiting row takes, "fifo" or "lifo" (the output is the same).
        Yields one :class:`EngineItem` a sample as it settles."""
        if refill_order not in ("fifo", "lifo"):
            raise ValueError(f"refill_order {refill_order!r} not in "
                             f"{{'fifo', 'lifo'}}")
        self.begin_stream()
        feed_iter = iter(feed)
        exhausted = False
        while True:
            while not exhausted and self.wants_input():
                try:
                    item = next(feed_iter)
                except StopIteration:
                    exhausted = True
                    break
                self.admit(item.host, item.index,
                           None if item.device is item.host else item.device)
            self.refill(refill_order)
            if not self._busy:
                if exhausted:
                    break
                continue
            self.step_dispatch()
            yield from self.harvest()

"""Cross-request prefix cache: content-addressed prefill reuse
(counterpart of ``fira_tpu/decode/prefix_cache.py``).

Serving traffic repeats (CI re-runs, bots, client retries send
byte-identical diffs), yet every request pays a full prefill: the encoder
pass, the per-beam cross K/V and the copy head's source projection, the
read-only half of a seat's state. This module is the reuse lever
(vLLM's content-addressed block sharing, SOSP '23):

- **Content address**: a request's identity is a keyed blake2b digest of
  its packed wire payload, every non-host-only field's bytes, dtype and
  shape (no process-global hashing; the same hex strings as the JAX
  package's for the same payload). It is computed on the host, on a feeder
  worker where one assembles the payload (serve/server._request_tasks),
  and on demand in the engine otherwise.
- **Prefill-result cache** (:class:`PrefixCache`): digest -> the row's
  prefill artifacts, held as host numpy copies. On a hit the engine builds
  a staged chunk from cached rows with numpy and one copy to the device,
  and seats it without running the prefill. An LRU bounded by entries
  (``cfg.prefix_cache_entries``) and optionally bytes; while a fault
  injector arms the ``cache.lookup`` site every entry carries a content
  checksum verified at lookup, so a corrupt-injected read is detected and
  the entry dropped (a miss, never a wrong answer).
- **In-flight dedup** rides the same digests: byte-identical requests
  already admitted coalesce onto the existing seat and are delivered by
  fan-out at harvest. The maps live in the engine and the serve loop;
  this module provides the addressing.

Equivalence: a cache-hit seat decodes from bit-identical artifact values
(a host round trip copies bits), so its (tokens, probs), and with them its
output bytes, equal the cold run's (tests/test_torch_prefix_cache.py).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

# the serving tier's digest namespace (the one copy is the quant module's)
from fira_tpu_torch.decode.quant import tier_namespace  # noqa: F401

# the keyed-digest discipline of robust/faults.py: never Python hash()
# (salted per process), always a keyed blake2b over explicit bytes
_DIGEST_KEY = b"fira-prefix-cache-v1"

# the per-row prefill artifact fields, by engine mode (the chunk keys of
# decode/engine.SlotEngine._prefill_fn minus the scalar dtype marker)
ARTIFACT_FIELDS_KV = ("src_mask", "diff", "sub_token",
                      "cross_k", "cross_v", "src_proj")
ARTIFACT_FIELDS_NOKV = ("src_mask", "diff", "sub_token", "states")


def _digest_arrays(items: Iterable[Tuple[str, np.ndarray]],
                   namespace: bytes = b"") -> str:
    """Keyed blake2b over (name, dtype, shape, bytes) of each array —
    shape/dtype are hashed so a bucket geometry change can never alias a
    content match across geometries. ``namespace`` (the serving tier's,
    :func:`tier_namespace`) prefixes the hash so artifacts of different
    low-precision tiers can never alias; empty on the f32/f32 path."""
    h = hashlib.blake2b(key=_DIGEST_KEY, digest_size=16)
    if namespace:
        h.update(namespace)
    for name, arr in items:
        a = np.ascontiguousarray(arr)
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def payload_digests(host: Dict, namespace: bytes = b""
                    ) -> List[Optional[str]]:
    """One content digest per VALID row of a packed host batch (None for
    pad rows): every wire field (host-only "_" keys and the positional
    ``valid`` mask excluded) contributes its row's bytes. Two rows digest
    equal iff their packed payloads are byte-identical at the same
    geometry and the same ``namespace`` (:func:`tier_namespace`): the
    dedup and cache identity."""
    valid = np.asarray(host["valid"], dtype=bool)
    fields = sorted(k for k in host if not k.startswith("_") and k != "valid")
    out: List[Optional[str]] = []
    for r in range(valid.shape[0]):
        # firacheck: allow[HOST-SYNC] packed host batches are numpy already (the feeder assembles on host); digesting their bytes is pure host work, no device value exists here
        out.append(_digest_arrays(((f, np.asarray(host[f])[r])
                                   for f in fields), namespace)
                   if valid[r] else None)
    return out


def stamp_digests(host: Dict, namespace: bytes = b"") -> Dict:
    """Attach ``_digests`` (host-only metadata: no "_" key ships to the
    device) to a packed batch: the worker-side stamping hook
    (serve/server._request_tasks), so the scheduler thread never pays the
    hashing. ``namespace``: as :func:`payload_digests`; the stamping side
    and the engine's on-demand side derive it from the same config."""
    host["_digests"] = payload_digests(host, namespace)
    return host


def payload_nbytes(payload: Dict[str, np.ndarray]) -> int:
    return sum(int(np.asarray(v).nbytes) for v in payload.values())


def payload_checksum(payload: Dict[str, np.ndarray]) -> str:
    """Content checksum of one per-row artifact payload: the keyed digest
    the cache's integrity check uses."""
    return _digest_arrays(sorted(payload.items()))


def extract_payloads(chunk_host: Dict[str, np.ndarray], rows: List[int],
                     beam: int) -> Dict[int, Dict[str, np.ndarray]]:
    """Slice one prefilled chunk's host copy into per-row cache payloads.
    Row r owns beam lanes ``r*K..(r+1)*K`` of the K-repeated arrays
    (cross_k/cross_v on axis 1, src_proj/states on axis 0), and those K
    lanes are byte-identical by construction (the prefill's
    ``repeat_interleave``), so the payload stores one lane and
    :func:`build_chunk` repeats it: 1/K the host memory, hashing and
    byte-budget charge for a bit-identical rebuild. ``beam=1`` reads a
    chunk that holds one lane a row already (the engine copies only those
    to the host). ``seed`` records the cache-seed dtype so a rebuilt chunk
    reproduces the prefill's exactly."""
    K = int(beam)
    kv = "cross_k" in chunk_host
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for r in rows:
        p: Dict[str, np.ndarray] = {
            "src_mask": np.ascontiguousarray(chunk_host["src_mask"][r]),
            "diff": np.ascontiguousarray(chunk_host["diff"][r]),
            "sub_token": np.ascontiguousarray(chunk_host["sub_token"][r]),
        }
        if kv:
            p["cross_k"] = np.ascontiguousarray(
                chunk_host["cross_k"][:, r * K:r * K + 1])
            p["cross_v"] = np.ascontiguousarray(
                chunk_host["cross_v"][:, r * K:r * K + 1])
            p["src_proj"] = np.ascontiguousarray(
                chunk_host["src_proj"][r * K:r * K + 1])
            p["seed"] = np.zeros((), chunk_host["cache_seed"].dtype)
        else:
            p["states"] = np.ascontiguousarray(
                chunk_host["states"][r * K:r * K + 1])
        out[r] = p
    return out


def build_chunk(payloads: Dict[int, Dict[str, np.ndarray]], batch_rows: int,
                beam: int) -> Dict[str, np.ndarray]:
    """Assemble a staged chunk from cached per-row payloads: the key set,
    shapes and dtypes of the prefill's output for this geometry, with
    ``beam`` lanes a row (``beam=1``: one lane a row, which the engine
    repeats on the device). Rows without a payload (pad rows, coalesced
    rows) stay zero; no insert ever seats them, so their values are never
    read."""
    C, K = int(batch_rows), int(beam)
    any_p = next(iter(payloads.values()))
    kv = "cross_k" in any_p
    out: Dict[str, np.ndarray] = {}
    for f in ("src_mask", "diff", "sub_token"):
        a = any_p[f]
        out[f] = np.zeros((C,) + a.shape, a.dtype)
    if kv:
        ck = any_p["cross_k"]          # (L, 1, ...) — one stored lane
        L = ck.shape[0]
        for f in ("cross_k", "cross_v"):
            out[f] = np.zeros((L, C * K) + ck.shape[2:], ck.dtype)
        sp = any_p["src_proj"]         # (1, ...)
        out["src_proj"] = np.zeros((C * K,) + sp.shape[1:], sp.dtype)
        out["cache_seed"] = np.zeros((), any_p["seed"].dtype)
    else:
        st = any_p["states"]           # (1, ...)
        out["states"] = np.zeros((C * K,) + st.shape[1:], st.dtype)
    for r, p in payloads.items():
        for f in ("src_mask", "diff", "sub_token"):
            out[f][r] = p[f]
        # repeat the one stored lane across the K beam slots: bitwise
        # what the prefill's repeat_interleave produced
        if kv:
            out["cross_k"][:, r * K:(r + 1) * K] = np.repeat(
                p["cross_k"], K, axis=1)
            out["cross_v"][:, r * K:(r + 1) * K] = np.repeat(
                p["cross_v"], K, axis=1)
            out["src_proj"][r * K:(r + 1) * K] = np.repeat(
                p["src_proj"], K, axis=0)
        else:
            out["states"][r * K:(r + 1) * K] = np.repeat(
                p["states"], K, axis=0)
    return out


@dataclasses.dataclass
class _Entry:
    payload: Dict[str, np.ndarray]
    checksum: Optional[str]  # keyed digest of the payload content —
    #                          computed/verified only while a fault
    #                          injector arms cache.lookup (the only
    #                          writer between put and take IS that
    #                          injector's corrupt; hashing megabytes of
    #                          artifacts per hit on the scheduler thread
    #                          would tax exactly the path the cache
    #                          exists to make cheap)
    nbytes: int


class PrefixCache:
    """Capacity-bounded LRU of per-row prefill artifacts, content-
    addressed by payload digest. Host-side only: no device memory, no
    compiled programs, no locks (the scheduler thread owns it — one
    instance per engine replica, per-chip like the arena it feeds).

    ``take`` is the metered lookup: LRU-touches on a hit, and — while an
    injector arms the ``cache.lookup`` site — runs the fault check (a
    raise demotes the lookup to a miss) and verifies the entry's content
    checksum (a corrupt-injected read is dropped, never served).
    ``contains`` is the non-mutating probe the serve loop partitions
    batches with.
    """

    def __init__(self, entries: int, *, max_bytes: int = 0, faults=None):
        if int(entries) < 1:
            raise ValueError(
                f"prefix cache needs >= 1 entry of capacity, got {entries}")
        if int(max_bytes) < 0:
            raise ValueError(
                f"prefix cache byte budget must be >= 0, got {max_bytes}")
        self.capacity = int(entries)
        # optional host-RAM bound: artifact payloads are MBs per entry at
        # production geometry, so the entry cap alone can pin gigabytes
        self.max_bytes = int(max_bytes)
        self._nbytes = 0
        self._lru: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._faults = faults
        self._lookups = 0   # deterministic event key for the fault site

    def _integrity(self) -> bool:
        """Content checksums are maintained exactly while the
        ``cache.lookup`` fault site is armed — corrupt-injection is the
        one writer between put and take, and the chaos contract is that
        its scramble is DETECTED and dropped, never served."""
        return self._faults is not None and self._faults.armed(
            "cache.lookup")

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def contains(self, digest: Optional[str]) -> bool:
        return digest is not None and digest in self._lru

    def take(self, digest: str
             ) -> Tuple[Optional[Dict[str, np.ndarray]], str]:
        """(payload, outcome) — outcome one of ``hit`` / ``miss`` /
        ``fault_miss`` (injected lookup raise, absorbed here: a cache
        fault must never become a wrong answer or a shed request) /
        ``integrity_drop`` (content checksum mismatch: the entry is
        evicted and the caller re-prefills)."""
        entry = self._lru.get(digest)
        if entry is None:
            return None, "miss"
        payload = entry.payload
        if self._integrity():
            self._lookups += 1
            try:
                self._faults.check("cache.lookup", key=self._lookups)
            except Exception:
                return None, "fault_miss"
            payload = self._faults.corrupt("cache.lookup", self._lookups,
                                           payload)
            if (entry.checksum is not None
                    and payload_checksum(payload) != entry.checksum):
                del self._lru[digest]
                self._nbytes -= entry.nbytes
                return None, "integrity_drop"
        self._lru.move_to_end(digest)
        return payload, "hit"

    def put(self, digest: str, payload: Dict[str, np.ndarray]) -> int:
        """Insert/refresh one entry; returns how many LRU entries were
        evicted to make room (the eviction meter). Eviction honors both
        bounds: the entry cap AND, when ``max_bytes`` is set, the host
        byte budget (an over-budget entry alone still lives — the cache
        degrades to capacity one, never refuses to serve)."""
        old = self._lru.get(digest)
        if old is not None:
            self._nbytes -= old.nbytes
        entry = _Entry(
            payload=payload,
            checksum=(payload_checksum(payload)
                      if self._integrity() else None),
            nbytes=payload_nbytes(payload))
        self._lru[digest] = entry
        self._lru.move_to_end(digest)
        self._nbytes += entry.nbytes
        evicted = 0
        while len(self._lru) > self.capacity or (
                self.max_bytes and self._nbytes > self.max_bytes
                and len(self._lru) > 1):
            _d, e = self._lru.popitem(last=False)
            self._nbytes -= e.nbytes
            evicted += 1
        return evicted

    def clear(self) -> None:
        self._lru.clear()
        self._nbytes = 0

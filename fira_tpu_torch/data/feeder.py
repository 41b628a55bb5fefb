"""Asynchronous host input pipeline: batch assembly off the consumer's
thread, then the copy to the card (counterpart of
``fira_tpu/data/feeder.py``).

``Feeder`` is a bounded pool of worker threads that runs assembly tasks
ahead of the training loop, the dev gate and the test decode:

- **order**: the task sequence IS the batch order. Workers assemble out of
  order; the consumer side emits strictly in sequence, so the
  deterministic ``(seed, epoch)`` stream of
  ``data.batching.epoch_index_chunks`` is kept byte for byte, for any
  worker count.
- **bounding**: at most ``depth`` tasks are in flight (dispatched but not
  yet consumed), so host memory stays O(depth * batch_bytes).
- **transfer** (``put=True``): the consumer copies each batch's
  ``fields`` to ``device`` as it takes the batch (``batch_to_device``:
  pinned memory, ids upcast to int64 on the device), on its own current
  stream, so the copies queue behind the steps already issued and need no
  cross-stream ordering. Workers only assemble. (Copying from the workers
  on a side stream gave no more steps/s on the card: see ``PERF.md``.) A
  stacked group (data/grouping.py: leading axis K or A, ``valid`` 2-D)
  goes as one copy per field. Keys starting with "_" (``_positions``,
  ``_tag``) are host-only and never ship.
- **errors**: every task exception is wrapped in :class:`FeederTaskError`
  with the task's sequence number and its ``note`` (split positions). A
  failing task is retried up to ``retries`` times with a linear backoff
  first. Then, under ``on_error="raise"`` (the default), the first
  surviving exception re-raises at the consumer on its next
  ``__next__``; under ``on_error="record"`` the item is emitted in
  sequence with ``error`` set and ``host``/``device`` None, and the stream
  goes on.
- **shutdown**: ``close()`` (also called by the context manager, at the
  end of the stream and on an error) stops dispatch and joins every
  thread.
- **observability**: each item carries ``stall_s`` (the consumer's time
  in ``__next__`` for it: waiting, and queueing its copies; the numerator
  of the loop's feed share) and ``queue_depth`` (ready batches when the
  consumer arrived); ``stats()`` sums them.

``num_workers=0`` is the synchronous mode: the same interface, the tasks
run on the consumer's thread (their time is then all stall), and no thread
is started.

The Feeder never waits for the device: ``n_valid`` is counted on the host
batch before the transfer. ``faults`` (an armed
``robust.faults.FaultInjector``) checks the ``feeder.assemble`` site
before each attempt's assembly (raise/hang) and scrambles the assembled
batch after it (corrupt), then checks ``feeder.device_put`` on the worker
before the batch is handed to the transfer; each draw keyed by the task's
sequence number (and the attempt), as in the JAX package.

``sharding`` (``parallel.mesh.feed_shardings``): under a training mesh
every rank runs its own Feeder over the same tasks, so each assembles the
same global batch in the same order from the same seed, and the callable
cuts the rank's rows before the copy (axis 1 of a stacked group, axis 0
of a batch): ``host`` stays the global batch (and ``n_valid`` its count),
``device`` holds the rank's rows on its device. The stream is thus
byte-stable across worker counts and data-axis sizes.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from fira_tpu_torch.robust.faults import backoff_s

Batch = Dict[str, Any]
Task = Callable[[], Batch]

# batch fields the decode needs on the device (valid stays on the host,
# and so do msg/msg_tar, which only training and the dev gate read there);
# edge_kinds (typed_edges only) goes too whenever the host batch has it
DEVICE_FIELDS = ("diff", "diff_mark", "ast_change", "sub_token",
                 "senders", "receivers", "values")
TRAIN_FIELDS = DEVICE_FIELDS + ("msg", "msg_tar")
OPTIONAL_FIELDS = ("edge_kinds",)


def batch_to_device(host: Dict[str, np.ndarray], device: torch.device,
                    fields=DEVICE_FIELDS) -> Dict[str, torch.Tensor]:
    """Copy ``fields`` of a host batch (or of a stacked group, every
    field with a leading group axis), and those of ``OPTIONAL_FIELDS`` it
    holds, to ``device`` on the current stream. Ids, edge indices and
    edge kinds travel in their narrow wire types and are
    upcast to int64 on the device; edge values stay f32, or arrive as bf16
    bits in uint16 (``batching.bf16_bits``) and are viewed as
    ``torch.bfloat16`` after the copy. On a CUDA device the copies come
    from pinned memory and do not block."""
    cuda = device.type == "cuda"
    out = {}
    for f in (*fields, *(f for f in OPTIONAL_FIELDS if f in host)):
        a = host[f]
        bits = a.dtype == np.uint16
        t = torch.from_numpy(a.view(np.int16) if bits else a)
        if cuda:
            t = t.pin_memory()
        t = t.to(device, non_blocking=cuda)
        if bits:
            out[f] = t.view(torch.bfloat16)
        else:
            out[f] = t if f == "values" else t.long()
    return out


class FeederTaskError(RuntimeError):
    """One assembly task failed (after its retry budget): carries the
    task's sequence number and its ``note`` (split positions, site), so
    the poisoned sample is named in the traceback."""

    def __init__(self, index: int, note: Optional[str],
                 original: BaseException) -> None:
        where = f" ({note})" if note else ""
        super().__init__(
            f"feeder task {index}{where} failed: "
            f"{type(original).__name__}: {original}")
        self.index = index
        self.note = note
        self.original = original


@dataclasses.dataclass
class FedBatch:
    """One emitted pipeline item."""

    index: int          # position in the deterministic batch order
    host: Optional[Batch]  # the assembled numpy batch; None on an
                        # error-carrying item (record mode)
    device: Any         # the fields on the device (== host when put=False)
    n_valid: int        # real (non-pad) rows, counted before the transfer
                        # (over every member of a stacked group)
    stall_s: float      # consumer time in __next__ for THIS item
    queue_depth: int    # ready-but-unconsumed items when consumer arrived
    error: Optional[BaseException] = None  # FeederTaskError in record mode
    retries: int = 0    # assembly attempts beyond the first this item took
    task_s: float = 0.0  # seconds of the successful assembly attempt


class Feeder:
    """Bounded-queue background batch assembly and transfer.

    ``tasks``: iterable of zero-arg callables, each returning one host
    batch; it is drained lazily on the dispatcher thread, so a generator
    is fine. ``put=False`` skips the transfer (host-only pipelines, e.g.
    tests); otherwise ``fields`` go to ``device``.
    """

    def __init__(self, tasks: Iterable[Task], *, num_workers: int = 2,
                 depth: int = 4, put: bool = True, device="cuda",
                 fields=DEVICE_FIELDS, on_error: str = "raise",
                 retries: int = 0, faults=None,
                 sharding: Optional[Callable[[Batch], Batch]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        if on_error not in ("raise", "record"):
            raise ValueError(f"on_error {on_error!r} not in "
                             f"{{'raise', 'record'}}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self._put = put
        self._device = torch.device(device)
        self._fields = fields
        self._num_workers = num_workers
        self._depth = depth
        self._on_error = on_error
        self._retries = retries
        self._faults = faults
        self._sharding = sharding
        self._next = 0                 # next sequence number to emit
        self._n_stalls = 0
        self._stall_s = 0.0
        self._stall_max = 0.0
        self._depth_sum = 0
        self._depth_min: Optional[int] = None
        self._n_task_errors = 0
        self._n_task_retries = 0
        self._task_s = 0.0
        self._closed = False

        if num_workers == 0:
            self._task_iter: Iterator[Task] = iter(tasks)
            self._threads: list = []
            return

        self._cond = threading.Condition()
        self._ready: Dict[int, FedBatch] = {}
        self._error: Optional[BaseException] = None
        self._total: Optional[int] = None   # set when tasks exhaust
        self._stop = threading.Event()
        self._inflight = threading.Semaphore(depth)
        self._task_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads = [
            threading.Thread(target=self._dispatch, args=(iter(tasks),),
                             name="fira-feeder-dispatch", daemon=True)
        ] + [
            threading.Thread(target=self._work, name=f"fira-feeder-worker-{i}",
                             daemon=True)
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    # --- pipeline threads ---

    def _dispatch(self, tasks: Iterator[Task]) -> None:
        seq = 0
        try:
            for task in tasks:
                # bound in-flight work; poll so close() can interrupt a
                # dispatcher blocked on a full pipeline
                while not self._stop.is_set():
                    if self._inflight.acquire(timeout=0.05):
                        break
                if self._stop.is_set():
                    return
                self._task_q.put((seq, task))
                seq += 1
        except BaseException as e:  # a raising tasks generator poisons the feed
            self._poison(e)
            return
        finally:
            for _ in range(self._num_workers):
                self._task_q.put(None)
        with self._cond:
            self._total = seq
            self._cond.notify_all()

    def _work(self) -> None:
        while True:
            got = self._task_q.get()
            if got is None or self._stop.is_set():
                return
            seq, task = got
            try:
                item = self._execute(seq, task)
            except BaseException as e:
                self._poison(e)
                return
            with self._cond:
                self._ready[seq] = item
                self._cond.notify_all()

    def _execute(self, seq: int, task: Task) -> FedBatch:
        """Run ONE assembly task under the retry policy: failures burn the
        retry budget with a linear backoff; a surviving exception is
        wrapped with the task's identity and raised (``"raise"``) or
        returned as an error-carrying item (``"record"``)."""
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                if self._faults is not None:
                    self._faults.check("feeder.assemble", key=(seq, attempt))
                host = task()
                if self._faults is not None:
                    host = self._faults.corrupt("feeder.assemble", seq, host)
                # counted on the host before the transfer: reading it back
                # from the device would wait for the queued steps
                n_valid = int(host["valid"].sum())
                if self._faults is not None:
                    self._faults.check("feeder.device_put",
                                       key=(seq, attempt))
                return FedBatch(seq, host, host, n_valid, 0.0, 0,
                                retries=attempt,
                                task_s=time.perf_counter() - t0)
            except Exception as e:
                if attempt < self._retries:
                    attempt += 1
                    time.sleep(backoff_s(attempt))
                    continue
                err = FeederTaskError(seq, getattr(task, "note", None), e)
                if self._on_error == "record":
                    return FedBatch(seq, None, None, 0, 0.0, 0, error=err,
                                    retries=attempt)
                raise err from e

    def _poison(self, e: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = e
            self._cond.notify_all()
        self._stop.set()

    # --- consumer side ---

    def __iter__(self) -> "Feeder":
        return self

    def __next__(self) -> FedBatch:
        if self._num_workers == 0:
            return self._next_sync()
        t0 = time.perf_counter()
        with self._cond:
            depth_seen = len(self._ready)
            while True:
                if self._error is not None:
                    err = self._error
                    break
                if self._next in self._ready:
                    err = None
                    item = self._ready.pop(self._next)
                    break
                if self._total is not None and self._next >= self._total:
                    err = StopIteration()
                    break
                self._cond.wait()
        if err is not None:
            self.close()
            raise err
        self._next += 1
        self._inflight.release()
        self._device_put(item)
        stall = time.perf_counter() - t0
        item.stall_s = stall
        item.queue_depth = depth_seen
        self._record(item, stall, depth_seen)
        return item

    def _next_sync(self) -> FedBatch:
        t0 = time.perf_counter()
        try:
            task = next(self._task_iter)
        except StopIteration:
            self._closed = True
            raise
        item = self._execute(self._next, task)
        self._device_put(item)
        stall = time.perf_counter() - t0
        self._next += 1
        item.stall_s = stall
        self._record(item, stall, 0)
        return item

    def _device_put(self, item: FedBatch) -> None:
        """Queue the copies of ``fields`` (this rank's rows, under a
        ``sharding``) to the device on the consumer's current stream. Keys
        starting with "_" are host-only metadata and never ship."""
        if self._put and item.error is None:
            host = (item.host if self._sharding is None
                    else self._sharding(item.host))
            item.device = batch_to_device(host, self._device, self._fields)

    def _record(self, item: FedBatch, stall: float, depth_seen: int) -> None:
        self._n_stalls += 1
        self._stall_s += stall
        self._stall_max = max(self._stall_max, stall)
        self._depth_sum += depth_seen
        self._depth_min = (depth_seen if self._depth_min is None
                           else min(self._depth_min, depth_seen))
        self._n_task_retries += item.retries
        self._task_s += item.task_s
        if item.error is not None:
            self._n_task_errors += 1

    # --- lifecycle ---

    def close(self) -> None:
        """Stop dispatch, unblock and join every pipeline thread.
        Idempotent; called at the end of the stream, on an error and by
        the context manager. A caller that stops iterating early must call
        it (or use ``with``)."""
        if self._closed:
            return
        self._closed = True
        if not self._threads:
            return
        self._stop.set()
        for _ in range(self._num_workers):
            self._task_q.put(None)   # unblock workers parked on get()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []

    def __enter__(self) -> "Feeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best effort: never leave threads parked forever
        try:
            self.close()
        except Exception:
            pass

    # --- observability ---

    def stats(self) -> Dict[str, float]:
        """Feed-stall and queue-depth sums over the items emitted so far.
        ``feed_stall_s`` is the numerator of the loop's feed share."""
        n = self._n_stalls
        return {
            "batches": float(n),
            "feed_stall_s": self._stall_s,
            "feed_stall_max_ms": 1e3 * self._stall_max,
            "queue_depth_sum": float(self._depth_sum),
            "queue_depth_mean": (self._depth_sum / n) if n else 0.0,
            "queue_depth_min": float(self._depth_min or 0),
            "num_workers": float(self._num_workers),
            "depth": float(self._depth),
            "task_errors": float(self._n_task_errors),
            "task_retries": float(self._n_task_retries),
            "task_s": self._task_s,
        }


def task_note(positions, *, geom_tag: Optional[str] = None,
              site: Optional[str] = None) -> str:
    """Task identity for FeederTaskError: the split positions the task
    assembles (the first six), and the bucket geometry and call site when
    known."""
    pos = [int(p) for p in positions]
    shown = ", ".join(str(p) for p in pos[:6])
    if len(pos) > 6:
        shown += f", ... {len(pos) - 6} more"
    parts = [f"split positions [{shown}]"]
    if geom_tag:
        parts.append(f"bucket {geom_tag}")
    if site:
        parts.append(site)
    return "; ".join(parts)


def assembly_tasks(split, chunks, cfg, *, batch_size: Optional[int] = None
                   ) -> Iterator[Task]:
    """One ``make_batch`` task per index chunk (see
    ``data.batching.epoch_index_chunks`` for the order), each with a
    ``note`` naming its split positions."""
    from fira_tpu_torch.data.batching import make_batch

    for chunk in chunks:
        def task(c=chunk):
            return make_batch(split, c, cfg, batch_size=batch_size)
        task.note = task_note(chunk, site="assembly_tasks")
        yield task

"""Ordered, crash-resilient streaming output for decode loops.

The bucketed packer (data/buckets.py) and the slot-refill engine
(decode/engine.py) both emit predictions OUT of split order — the packer
reorders the batch stream, the engine harvests whichever slot settles
first. Output files, however, are one plain line per sample in split
order (the reference's OUTPUT/output_fira contract).

:class:`OrderedStreamWriter` restores order ON THE WAY to disk instead of
buffering the whole run in memory and writing the ordered file only at
completion (the pre-engine bucketed path): lines arrive keyed by split
position, and the contiguous prefix from position 0 streams to
``<path>.partial`` the moment it completes — a byte-exact, parseable
PREFIX of the final file, every flushed line a finished prediction in
its final place. Lines above a gap wait in memory for the ordered file
AND spill position-tagged (``pos\\tline``) to ``<path>.partial.tail`` the
moment they are added, so a crash costs NOTHING that was decoded: the
plain prefix plus the tagged tail together hold every finished line
(the tagged-tail recovery contract of the old bucketed stream, now
layered on top of the plain prefix instead of replacing it).
``close()`` renames ``.partial`` to the final path atomically and
removes the tail spill, exactly like the historical plain streaming
path. ``pending`` exposes the above-gap count for observability.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


class OrderedStreamWriter:
    """Position-keyed streaming writer with atomic completion.

    Use as a context manager: on a clean exit the partial file is renamed
    to ``path``; on an exception both the plain prefix (``.partial``) and
    the tagged above-gap spill (``.partial.tail``) are LEFT on disk as
    the crash-recovery pair (never renamed, never deleted).
    """

    def __init__(self, path: str, *, start: int = 0,
                 expected: Optional[int] = None):
        """``expected``: total line count the completed file must have —
        close() refuses to rename a silently truncated file (a tail-of-
        split sample that was never decoded leaves no interior gap, so
        the gap check alone cannot see it)."""
        self.path = path
        self.partial_path = path + ".partial"
        self.tail_path = path + ".partial.tail"
        self.expected = expected
        self._pending: Dict[int, str] = {}
        self._next = start
        self._written = 0
        self._closed = False
        self._aborted = False
        # line-buffered: the crash contract promises every ADDED line is
        # on disk, not parked in a userspace stdio buffer until the next
        # periodic flush — a hard kill (OOM, SIGKILL) must not eat
        # decoded predictions. Output files are a few thousand lines; a
        # write syscall per line is noise next to a beam step.
        self._f = open(self.partial_path, "w", buffering=1)
        self._tail_f: Optional = None  # opened lazily on the first gap

    def add(self, pos: int, line: str) -> None:
        """Stage ``line`` at split position ``pos``; flush the contiguous
        prefix, spill anything above a gap to the tagged tail. Each
        position must be added exactly once."""
        if self._closed:
            raise ValueError("writer is closed")
        if pos < self._next or pos in self._pending:
            raise ValueError(f"duplicate output position {pos}")
        if pos == self._next:
            self._f.write(line)
            self._next += 1
            self._written += 1
        else:
            # above a gap: held for the ordered file, AND on disk tagged —
            # a crash must not cost a finished prediction
            self._pending[pos] = line
            if self._tail_f is None:
                self._tail_f = open(self.tail_path, "w", buffering=1)
            self._tail_f.write(f"{pos}\t{line}")
        while self._next in self._pending:
            self._f.write(self._pending.pop(self._next))
            self._next += 1
            self._written += 1

    @property
    def written(self) -> int:
        """Lines flushed to the plain prefix (its parseable length)."""
        return self._written

    @property
    def pending(self) -> int:
        """Lines held above a gap (all of them also in the tagged tail)."""
        return len(self._pending)

    def flush(self) -> None:
        self._f.flush()
        if self._tail_f is not None:
            self._tail_f.flush()

    def close(self) -> str:
        """Complete the file: requires no gaps (every position below the
        high-water mark added), then atomically renames partial -> final
        and removes the tail spill. Raises if the writer was aborted —
        the final file was never produced, only the recovery pair."""
        if self._aborted:
            raise RuntimeError(
                f"writer was aborted — {self.path} was never produced; "
                f"the flushed prefix is at {self.partial_path}")
        if self._closed:
            return self.path
        if self._pending:
            self.abort()  # leave the prefix + tagged tail for post-mortem
            raise RuntimeError(
                f"{len(self._pending)} line(s) stranded above a gap at "
                f"position {self._next} — a sample was never decoded; the "
                f"flushed prefix is preserved at {self.partial_path} and "
                f"the stranded lines, position-tagged, at {self.tail_path}")
        if self.expected is not None and self._written != self.expected:
            self.abort()  # suffix truncation: no gap, but samples missing
            raise RuntimeError(
                f"only {self._written} of {self.expected} expected lines "
                f"were written — trailing sample(s) were never decoded; "
                f"the flushed prefix is preserved at {self.partial_path}")
        self._f.close()
        if self._tail_f is not None:
            self._tail_f.close()
            os.remove(self.tail_path)
        self._closed = True
        os.replace(self.partial_path, self.path)
        return self.path

    def abort(self) -> None:
        """Stop writing, LEAVING the plain prefix and the tagged tail on
        disk (the crash contract: everything decoded stays recoverable)."""
        if not self._closed:
            self._f.close()
            if self._tail_f is not None:
                self._tail_f.close()
            self._closed = True
            self._aborted = True

    def __enter__(self) -> "OrderedStreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()

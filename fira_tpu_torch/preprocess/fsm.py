"""Hunk-splitting FSM: diff token/mark streams -> typed chunks.

Pure rebuild of the reference's preprocessing state machine
(Preprocess/run_total_process_data.py:8-158). Walks the
aligned (difftoken, diffmark) streams and segments each commit's diff into
typed chunks:

    type  0   context run (including every <nb>...<nl> header block)
    type -1   pure deletion run
    type  1   pure addition run
    type 100  update: a delete-run immediately followed by an add-run,
              emitted as the pair (delete_tokens, add_tokens)

Semantics preserved exactly: a delete-run flushed by context becomes type -1
(NOT an update even if adds come later); an add-run is promoted to an update
only when the pending delete-run is non-empty; <nb> blocks must be all
context (mark 2) through their closing <nl>; end-of-stream flushes like <nb>.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

Chunk = Union[List[str], Tuple[List[str], List[str]]]

NB = "<nb>"
NL = "<nl>"


class FSMError(ValueError):
    """Malformed (tokens, marks) input (the reference uses bare asserts)."""


def split_hunks(tokens: Sequence[str], marks: Sequence[int]
                ) -> Tuple[List[Chunk], List[int]]:
    """Segment one commit's diff. Returns (chunks, types) where types[i] in
    {0, -1, 1, 100} and a type-100 chunk is (delete_tokens, add_tokens)."""
    if len(tokens) != len(marks):
        raise FSMError(f"token/mark length mismatch: {len(tokens)} vs {len(marks)}")

    chunks: List[Chunk] = []
    types: List[int] = []
    delete_run: List[str] = []
    add_run: List[str] = []
    normal_run: List[str] = []
    state: Union[str, int] = "<start>"

    def flush_pending() -> None:
        nonlocal state
        if state == 0:
            if not normal_run:
                raise FSMError("empty context run at flush")
            chunks.append(list(normal_run))
            types.append(0)
        elif state == -1:
            if not delete_run:
                raise FSMError("empty delete run at flush")
            chunks.append(list(delete_run))
            types.append(-1)
        elif state == 1:
            if not add_run:
                raise FSMError("empty add run at flush")
            if not delete_run:
                chunks.append(list(add_run))
                types.append(1)
            else:
                chunks.append((list(delete_run), list(add_run)))
                types.append(100)

    j = 0
    n = len(tokens)
    while j < n:
        token, mark = tokens[j], marks[j]
        if mark not in (1, 2, 3) and token != NB:
            raise FSMError(f"mark {mark!r} at {j} outside {{1,2,3}}")

        if token == NB:
            flush_pending()
            if mark != 2:
                raise FSMError(f"<nb> at {j} has mark {mark}, expected 2")
            try:
                end_nl = tokens.index(NL, j)
            except ValueError:
                raise FSMError(f"<nb> at {j} without closing <nl>") from None
            for jj in range(j, end_nl + 1):
                if marks[jj] != 2:
                    raise FSMError(
                        f"non-context mark {marks[jj]} inside <nb> block at {jj}")
            chunks.append(list(tokens[j : end_nl + 1]))
            types.append(0)
            state = "<start>"
            delete_run, add_run, normal_run = [], [], []
            j = end_nl + 1
            continue

        if state == "<start>":
            if mark == 1:
                delete_run.append(token)
                state = -1
            elif mark == 3:
                add_run.append(token)
                state = 1
            elif mark == 2:
                normal_run.append(token)
                state = 0
        elif state == 0:
            if mark == 2:
                normal_run.append(token)
            else:
                chunks.append(list(normal_run))
                types.append(0)
                normal_run = []
                if mark == 1:
                    delete_run.append(token)
                    state = -1
                else:
                    add_run.append(token)
                    state = 1
        elif state == -1:
            if mark == 1:
                delete_run.append(token)
            elif mark == 3:
                add_run.append(token)
                state = 1
            else:  # context flushes the delete-run as a pure deletion
                chunks.append(list(delete_run))
                types.append(-1)
                delete_run = []
                normal_run.append(token)
                state = 0
        elif state == 1:
            if mark == 3:
                add_run.append(token)
            else:
                if not delete_run:
                    chunks.append(list(add_run))
                    types.append(1)
                else:
                    chunks.append((list(delete_run), list(add_run)))
                    types.append(100)
                delete_run, add_run = [], []
                if mark == 1:
                    delete_run.append(token)
                    state = -1
                else:
                    normal_run.append(token)
                    state = 0
        j += 1

    flush_pending()
    return chunks, types


def flatten_chunks(chunks: Sequence[Chunk], types: Sequence[int]) -> List[str]:
    """Re-concatenate chunk tokens in order (delete before add for updates) —
    must reproduce the original difftoken stream, the reference's global
    invariant (process_data_ast_parallel.py:420)."""
    out: List[str] = []
    for chunk, t in zip(chunks, types):
        if t == 100:
            out.extend(chunk[0])
            out.extend(chunk[1])
        else:
            out.extend(chunk)  # type: ignore[arg-type]
    return out

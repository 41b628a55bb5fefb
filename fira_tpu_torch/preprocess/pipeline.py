"""Preprocessing pipeline: raw diff streams -> complete DataSet corpus.

Rebuilds the reference's orchestration layer
(Preprocess/run_total_process_data.py:160-184 worker fan-out,
gather_data.py shard concatenation) with a cleaner contract:

- Input: a corpus dir holding at least ``difftoken.json`` + ``diffmark.json``
  (plus ``msg.json`` / ``variable.json`` from the crawl stage; ``diffatt.json``
  is derived here when absent).
- Shard workers (multiprocessing) run the FSM + AST extraction per commit and
  write per-shard stream files under ``<out>/shards/shard_<s>_<e>/``;
  idempotent re-runs skip completed shards (the reference skips on an existing
  pickle, run_total_process_data.py:161).
- Per-commit failures degrade that commit to an empty graph and are recorded
  in the shard's ``errors.json`` (the reference aborts the whole 100-commit
  shard to an ERROR file instead, process_data_ast_parallel.py:439-443).
- ``gather`` concatenates shards in order, asserts the commit count, and
  writes the six graph streams next to the inputs; vocabularies are built
  last if absent (Dataset.py:46-62 rebuilds ast_change_vocab the same way).

The native astdiff library is loaded once per worker process — no JVM
subprocesses (the reference forks two per update hunk).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from fira_tpu_torch.data.schema import CORPUS_FILES
from fira_tpu_torch.data.vocab import CASE_PRESERVED_TOKENS, Vocab
from fira_tpu_torch.preprocess import extract
from fira_tpu_torch.preprocess.fsm import split_hunks

GRAPH_STREAMS = ("ast", "change", "edge_ast", "edge_ast_code",
                 "edge_change_ast", "edge_change_code")

_IDENT_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_$]*$")
_CAMEL_RE = re.compile(
    r"[A-Z]+(?=[A-Z][a-z0-9])|[A-Z]?[a-z0-9]+|[A-Z]+|\$")


def split_sub_tokens(token: str) -> List[str]:
    """camelCase/snake_case sub-token split, lower-cased.

    Produces the ``diffatt.json`` stream (SURVEY.md Appendix A): a token
    yields sub-tokens only when it actually splits into >= 2 parts;
    placeholders (STRING0, NUMBER3, ...), punctuation, keywords-as-single-
    words and sentinels yield []. Sub-tokens are asserted lower-case
    downstream (Dataset.py:150-151), so parts are lowered here.
    """
    if token in CASE_PRESERVED_TOKENS or not _IDENT_RE.match(token):
        return []
    parts: List[str] = []
    for piece in token.split("_"):
        if not piece:
            continue
        parts.extend(m.group(0) for m in _CAMEL_RE.finditer(piece))
    parts = [p.lower() for p in parts if p and p != "$"]
    return parts if len(parts) >= 2 else []


def derive_diffatt(difftokens: Sequence[Sequence[str]]
                   ) -> List[List[List[str]]]:
    return [[split_sub_tokens(t) for t in commit] for commit in difftokens]


# --------------------------------------------------------------------------
# Shard worker
# --------------------------------------------------------------------------

def _empty_commit_graph() -> Dict[str, list]:
    return {s: [] for s in GRAPH_STREAMS}


def process_commits(difftokens: Sequence[Sequence[str]],
                    diffmarks: Sequence[Sequence[int]],
                    begin: int, end: int, *, index_offset: int = 0
                    ) -> Tuple[Dict[str, list], List[dict]]:
    """Extract graphs for commits [begin, end). ``index_offset`` maps local
    positions back to corpus-global commit indices (error records and the
    reference's per-commit hack both key on the global index). Returns
    ({stream: [per-commit lists]}, [error records])."""
    streams: Dict[str, list] = {s: [] for s in GRAPH_STREAMS}
    errors: List[dict] = []
    for m in range(begin, end):
        try:
            chunks, types = split_hunks(difftokens[m], diffmarks[m])
            g = extract.extract_commit(chunks, types, difftokens[m],
                                       commit_index=index_offset + m)
            commit = {
                "ast": g.ast,
                "change": g.change,
                "edge_ast": [list(e) for e in g.edge_ast],
                "edge_ast_code": [list(e) for e in g.edge_ast_code],
                "edge_change_ast": [list(e) for e in g.edge_change_ast],
                "edge_change_code": [list(e) for e in g.edge_change_code],
            }
        except Exception as exc:  # degrade the commit, keep the corpus aligned
            errors.append({"commit": index_offset + m,
                           "error": f"{type(exc).__name__}: {exc}"})
            commit = _empty_commit_graph()
        for s in GRAPH_STREAMS:
            streams[s].append(commit[s])
    return streams, errors


def _shard_dir(out_dir: str, begin: int, end: int) -> str:
    return os.path.join(out_dir, "shards", f"shard_{begin}_{end}")


def _shard_done(out_dir: str, begin: int, end: int) -> bool:
    # errors.json is part of done-ness: it is always written (possibly []),
    # so a shard that crashed between its stream writes and its error record
    # reprocesses instead of passing for a clean shard on re-run. Shard dirs
    # written before this marker existed also reprocess once — deliberate: a
    # legacy shard without errors.json is indistinguishable from a crashed
    # one, and correctness of the error ledger beats one re-run.
    d = _shard_dir(out_dir, begin, end)
    return all(os.path.exists(os.path.join(d, f"{s}.json"))
               for s in GRAPH_STREAMS) \
        and os.path.exists(os.path.join(d, "errors.json"))


def _run_shard(job: Tuple[str, int, int, list, list]) -> Tuple[int, int, int]:
    """(out_dir, begin, end, difftoken_slice, diffmark_slice) ->
    (begin, end, n_errors). The parent ships each worker only its own slice
    of the streams, so corpus-sized JSON is parsed exactly once."""
    out_dir, begin, end, difftokens, diffmarks = job
    if _shard_done(out_dir, begin, end):
        # idempotent re-run: report the errors recorded when the shard ran,
        # so re-runs don't claim a clean corpus that isn't
        err_path = os.path.join(_shard_dir(out_dir, begin, end), "errors.json")
        with open(err_path) as f:
            return begin, end, len(json.load(f))
    streams, errors = process_commits(difftokens, diffmarks, 0,
                                      end - begin, index_offset=begin)
    d = _shard_dir(out_dir, begin, end)
    os.makedirs(d, exist_ok=True)
    for s in GRAPH_STREAMS:
        tmp = os.path.join(d, f"{s}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(streams[s], f)
        os.replace(tmp, os.path.join(d, f"{s}.json"))
    # last write completes the shard (atomic like the streams above)
    tmp = os.path.join(d, "errors.json.tmp")
    with open(tmp, "w") as f:
        json.dump(errors, f, indent=1)
    os.replace(tmp, os.path.join(d, "errors.json"))
    return begin, end, len(errors)


# --------------------------------------------------------------------------
# Orchestrator + gather
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineReport:
    n_commits: int
    n_shards: int
    n_errors: int
    skipped_shards: int


def run_pipeline(data_dir: str, *, out_dir: Optional[str] = None,
                 shard_size: int = 100, num_procs: Optional[int] = None,
                 build_vocabs: bool = True) -> PipelineReport:
    """Full pipeline: shard fan-out, gather, diffatt derivation, vocabs."""
    out_dir = out_dir or data_dir
    with open(os.path.join(data_dir, "difftoken.json")) as f:
        difftokens = json.load(f)
    n = len(difftokens)
    with open(os.path.join(data_dir, "diffmark.json")) as f:
        diffmarks = json.load(f)
    jobs = []
    for s in range(0, n, shard_size):
        e = min(s + shard_size, n)
        jobs.append((out_dir, s, e, difftokens[s:e], diffmarks[s:e]))
    skipped = sum(1 for j in jobs if _shard_done(out_dir, j[1], j[2]))

    num_procs = num_procs or min(len(jobs), os.cpu_count() or 1)
    if num_procs <= 1 or len(jobs) <= 1:
        results = [_run_shard(j) for j in jobs]
    else:
        # spawn, not fork: the caller may be multi-threaded (torch's
        # thread pools, pytest), and the workers import no torch anyway.
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(num_procs) as pool:
            results = pool.map(_run_shard, jobs)
    n_errors = sum(r[2] for r in results)

    gather(out_dir, n, shard_size=shard_size)

    if not os.path.exists(os.path.join(out_dir, "diffatt.json")):
        with open(os.path.join(out_dir, "diffatt.json"), "w") as f:
            json.dump(derive_diffatt(difftokens), f)

    if build_vocabs:
        _build_vocabs(data_dir, out_dir, difftokens)
    return PipelineReport(n_commits=n, n_shards=len(jobs),
                          n_errors=n_errors, skipped_shards=skipped)


def gather(out_dir: str, n_commits: int, shard_size: int = 100) -> None:
    """Concatenate shard outputs in index order into the six corpus streams
    (gather_data.py:14-43, including its final count assert)."""
    totals: Dict[str, list] = {s: [] for s in GRAPH_STREAMS}
    for begin in range(0, n_commits, shard_size):
        end = min(begin + shard_size, n_commits)
        d = _shard_dir(out_dir, begin, end)
        for s in GRAPH_STREAMS:
            with open(os.path.join(d, f"{s}.json")) as f:
                totals[s].extend(json.load(f))
    for s in GRAPH_STREAMS:
        if len(totals[s]) != n_commits:
            raise RuntimeError(
                f"gather: stream {s} has {len(totals[s])} commits, "
                f"expected {n_commits}")
        tmp = os.path.join(out_dir, f"{s}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(totals[s], f)
        os.replace(tmp, os.path.join(out_dir, f"{s}.json"))


def _build_vocabs(data_dir: str, out_dir: str,
                  difftokens: Sequence[Sequence[str]]) -> None:
    word_path = os.path.join(out_dir, "word_vocab.json")
    if not os.path.exists(word_path):
        streams = list(difftokens)
        msg_path = os.path.join(data_dir, "msg.json")
        if os.path.exists(msg_path):
            with open(msg_path) as f:
                streams += json.load(f)
        Vocab.build_word_vocab(streams).to_json(word_path)
    ast_path = os.path.join(out_dir, "ast_change_vocab.json")
    if not os.path.exists(ast_path):
        with open(os.path.join(out_dir, "ast.json")) as f:
            asts = json.load(f)
        Vocab.build_ast_change_vocab(asts).to_json(ast_path)


def main(args) -> int:
    """CLI entry (``python -m fira_tpu_torch.cli preprocess``)."""
    report = run_pipeline(
        args.data_dir,
        shard_size=getattr(args, "shard_size", 100) or 100,
        num_procs=getattr(args, "num_procs", None),
    )
    missing = [f for f in CORPUS_FILES
               if not os.path.exists(os.path.join(args.data_dir, f))]
    print(f"preprocess: {report.n_commits} commits, {report.n_shards} shards "
          f"({report.skipped_shards} already done), "
          f"{report.n_errors} degraded commits")
    if missing:
        print(f"note: corpus still missing {missing} (crawl-stage inputs)")
    return 0

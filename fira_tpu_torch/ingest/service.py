"""Per-request ingest: raw diff -> wire payload -> commit message (the
one-shot half of the JAX package's ``ingest/service.py``, docs/INGEST.md).

Each request runs the whole preprocessing stack the corpus went through
offline:

    raw diff text
      -> difftext.parse_request          (lex:      file/hunk structure +
                                          Java lexing, mark streams)
      -> fsm.split_hunks + extract_commit (parse:    hunk FSM, AST parse/
                                          diff, graph extraction on the
                                          native astdiff library)
      -> process_record + make_batch     (assemble: frozen-vocab encode,
                                          copy labels, COO adjacency, the
                                          row the corpus path ships)

EQUIVALENCE CONTRACT: a corpus commit's reconstructed diff
(``difftext.reconstruct_request``) pushed through :func:`ingest_request`
yields a wire payload byte-identical to ``make_batch`` over the frozen
corpus row, provided the corpus' graph streams came from the same
extraction (``data.synthetic.write_extracted_corpus_dir`` builds such
corpora).

DEGRADATION CONTRACT, in order of severity:
- unknown word tokens encode to <unkm> and unknown AST/change labels to
  <pad> (counted per request, never a crash);
- an extraction failure degrades the request to a code-tokens-only graph
  (the pipeline's per-commit degradation, recorded per request);
- an over-budget diff is deterministically truncated to the config
  geometry (``cfg.ingest_truncate = "clip"``, recorded per request) or
  rejected with ``IngestError`` (``"shed"``);
- malformed diff text raises ``difftext.DiffParseError``; the serving
  loop sheds such a request with the reason recorded and an empty output
  line.

:func:`serve_diffs` is ``cli serve --input diffs``: the serving loop of
``serve/server.py`` fed by one ingest task a request on the Feeder's
workers (:func:`ingest_request_tasks`), with the fast path of
``ingest/cache.py`` (:func:`build_fast_path`). :func:`one_shot_message`
is ``cli message``: one diff in, the batched beam on the model's device,
one message out.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.schema import CommitRecord
from fira_tpu_torch.data.vocab import PAD_ID, UNK_TOKEN, Vocab, normalize_token
from fira_tpu_torch.ingest.cache import (EXEC_MODES, HunkMemo, IngestCache,
                                         IngestExecutor, LexMemo,
                                         text_digest)
from fira_tpu_torch.ingest.difftext import DiffRequest, parse_request
from fira_tpu_torch.preprocess.fsm import NB, NL, split_hunks
from fira_tpu_torch.preprocess.pipeline import split_sub_tokens

TRUNCATE_MODES = ("clip", "shed")


class IngestError(ValueError):
    """A request the ingest pipeline rejects by policy (over-budget under
    ``ingest_truncate = "shed"``, empty after truncation)."""


# --------------------------------------------------------------------------
# parse-time knob validation (CLI exit 2)
# --------------------------------------------------------------------------

def ingest_errors(cfg: FiraConfig, *, input_mode: str = "graphs",
                  diff_trace: Optional[str] = None,
                  command: str = "serve") -> List[str]:
    """Named-knob ingest admission check (docs/INGEST.md knob table), in
    the JAX package's words."""
    errs: List[str] = []
    if cfg.ingest_workers < 0:
        errs.append(
            f"ingest_workers {cfg.ingest_workers} must be >= 0 assembly "
            f"workers (0 = reuse feeder_workers for ingest request tasks)")
    if cfg.ingest_truncate not in TRUNCATE_MODES:
        errs.append(
            f"ingest_truncate {cfg.ingest_truncate!r} must be one of "
            f"{'/'.join(TRUNCATE_MODES)}: 'clip' deterministically "
            f"truncates an over-budget diff to the config geometry "
            f"(recorded per request), 'shed' rejects it with a recorded "
            f"error")
    if cfg.ingest_cache_entries < 0:
        errs.append(
            f"ingest_cache_entries {cfg.ingest_cache_entries} must be "
            f">= 0 cached whole-diff payloads (0 = unbounded entry "
            f"count; the LRU of the ingest result cache)")
    if cfg.ingest_cache_bytes < 0:
        errs.append(
            f"ingest_cache_bytes {cfg.ingest_cache_bytes} must be >= 0 "
            f"(0 = unbounded; otherwise the whole-diff result cache "
            f"evicts LRU-first until its payload bytes fit)")
    if cfg.ingest_exec not in EXEC_MODES:
        errs.append(
            f"ingest_exec {cfg.ingest_exec!r} must be one of "
            f"{'/'.join(EXEC_MODES)}: 'thread' runs the AST parse stage "
            f"inline on the feeder workers, 'process' ships it to a "
            f"spawned process pool (the GIL-bound stage's scaling mode)")
    if command != "serve":
        return errs
    if input_mode not in ("graphs", "diffs"):
        errs.append(f"--input {input_mode!r} must be 'graphs' (corpus "
                    f"split requests) or 'diffs' (raw-diff requests)")
    if input_mode == "diffs":
        if not diff_trace:
            errs.append(
                "--input diffs needs --diff-trace PATH: a file of "
                "'#! request'-separated unified diffs, or a directory of "
                ".diff files (docs/INGEST.md)")
        elif not os.path.exists(diff_trace):
            errs.append(f"--diff-trace {diff_trace}: path does not exist")
        else:
            # load the trace: an empty file, an unreadable one, or a
            # directory with no .diff files is an exit 2 here too
            from fira_tpu_torch.ingest.difftext import read_diff_trace

            try:
                read_diff_trace(diff_trace)
            except (OSError, ValueError) as e:
                errs.append(f"--diff-trace {diff_trace}: {e}")
    elif diff_trace:
        errs.append("--diff-trace only applies with --input diffs "
                    "(--input graphs serves the corpus test split)")
    return errs


# --------------------------------------------------------------------------
# lenient frozen-vocab encoding (OOV -> UNK / PAD, never a crash)
# --------------------------------------------------------------------------

class _LenientVocab(Vocab):
    """View over a frozen vocab whose conversion never raises: unknown
    tokens fall back to <unkm> when the vocab has one (the word vocab),
    else to <pad> (the ast/change vocab). Fallbacks are counted, the
    per-request OOV record. The strict vocab's ids whenever every token
    is known, which keeps the round-trip contract byte-exact."""

    def __init__(self, base: Vocab):
        self.token_to_id = base.token_to_id
        self.id_to_token = base.id_to_token
        self.unk_fallbacks = 0   # unknown -> <unkm> (the word vocab)
        self.pad_fallbacks = 0   # unknown -> <pad>  (the ast/change vocab)

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        out = []
        for t in tokens:
            t = normalize_token(t)
            if t in self.token_to_id:
                out.append(self.token_to_id[t])
            elif UNK_TOKEN in self.token_to_id:
                self.unk_fallbacks += 1
                out.append(self.token_to_id[UNK_TOKEN])
            else:
                self.pad_fallbacks += 1
                out.append(PAD_ID)
        return out


# --------------------------------------------------------------------------
# per-request record construction (FSM + extraction + truncation policy)
# --------------------------------------------------------------------------

def _truncate_tokens(tokens: List[str], marks: List[int], budget: int
                     ) -> Tuple[List[str], List[int], int]:
    """Clip the streams to ``budget`` tokens at a chunk-safe boundary: a
    cut landing inside an open ``<nb>`` block backs off to before the
    ``<nb>`` (a half-open header block would fail the FSM)."""
    cut = budget
    for j in range(cut - 1, -1, -1):
        if tokens[j] == NL:
            break
        if tokens[j] == NB:
            cut = j
            break
    return tokens[:cut], marks[:cut], len(tokens) - cut


def _clip_sub_tokens(tokens: List[str], atts: List[List[str]],
                     budget: int) -> Tuple[List[List[str]], int]:
    """Drop whole tokens' sub-token lists (every occurrence: a repeated
    token keeps one att list) so the deduplicated sub-token node count
    fits ``budget``. Returns the lists and the dropped node count."""
    kept: set = set()
    used = 0
    dropped: Dict[str, int] = {}   # unique token -> its sub-token count
    for tok, att in zip(tokens, atts):
        if not att or tok in kept or tok in dropped:
            continue
        if used + len(att) > budget:
            dropped[tok] = len(att)
        else:
            kept.add(tok)
            used += len(att)
    if not dropped:
        return atts, 0
    out = [[] if (tok in dropped and att) else att
           for tok, att in zip(tokens, atts)]
    return out, sum(dropped.values())


def ingest_record(req: DiffRequest, cfg: FiraConfig, *,
                  truncate: Optional[str] = None,
                  commit_index: Optional[int] = None,
                  memo: Optional[HunkMemo] = None
                  ) -> Tuple[CommitRecord, Dict]:
    """Parsed request -> :class:`CommitRecord` + per-request info dict
    (``truncated``: what the deterministic clip dropped, or None;
    ``degraded``: the extraction error the request degraded on, or
    None). Mirrors the offline pipeline exactly for requests that fit
    the config geometry, the round-trip contract's precondition.

    ``memo``: a hunk-level AST memo (``ingest.cache.HunkMemo``, or a
    request's ``MemoTally`` of one): chunk extractions are reused across
    near-identical requests, bit-exact since they are pure functions of
    the chunk (the rebase still runs here)."""
    from fira_tpu_torch.preprocess import extract

    truncate = truncate or cfg.ingest_truncate
    if truncate not in TRUNCATE_MODES:
        raise ValueError(f"truncate {truncate!r} not in {TRUNCATE_MODES}")
    info: Dict = {"truncated": None, "degraded": None}

    def record_trunc(key: str, n: int) -> None:
        if n:
            info["truncated"] = dict(info["truncated"] or {}, **{key: n})

    tokens, marks = list(req.tokens), list(req.marks)
    budget = cfg.sou_len - 2  # <start>/<eos> take two positions
    if len(tokens) > budget:
        if truncate == "shed":
            raise IngestError(
                f"diff has {len(tokens)} tokens > sou budget {budget} "
                f"(ingest_truncate=shed)")
        tokens, marks, dropped = _truncate_tokens(tokens, marks, budget)
        if not tokens:
            raise IngestError(
                "diff empty after truncation to the sou budget (a single "
                "header block larger than sou_len)")
        record_trunc("diff_tokens_dropped", dropped)

    atts = [split_sub_tokens(t) for t in tokens]
    atts, sub_dropped = _clip_sub_tokens(tokens, atts, cfg.sub_token_len)
    if sub_dropped:
        if truncate == "shed":
            raise IngestError(
                f"diff needs {sub_dropped} sub-token nodes beyond "
                f"sub_token_len {cfg.sub_token_len} (ingest_truncate=shed)")
        record_trunc("sub_tokens_dropped", sub_dropped)

    try:
        chunks, types = split_hunks(tokens, marks)
        g = extract.extract_commit(chunks, types, tokens,
                                   commit_index=commit_index, memo=memo)
        ast, change = list(g.ast), list(g.change)
        edge_ast = list(g.edge_ast)
        edge_ast_code = list(g.edge_ast_code)
        edge_change_ast = list(g.edge_change_ast)
        edge_change_code = list(g.edge_change_code)
    except Exception as exc:
        # the pipeline's per-commit degradation (preprocess/pipeline.py):
        # the request keeps its code tokens, the graph goes empty
        info["degraded"] = f"{type(exc).__name__}: {exc}"
        ast, change = [], []
        edge_ast, edge_ast_code = [], []
        edge_change_ast, edge_change_code = [], []

    node_budget = cfg.ast_change_len
    if len(ast) + len(change) > node_budget:
        if truncate == "shed":
            raise IngestError(
                f"diff has {len(ast)} AST + {len(change)} change nodes > "
                f"ast_change_len {node_budget} (ingest_truncate=shed)")
        keep_ast = min(len(ast), node_budget)
        keep_change = node_budget - keep_ast
        record_trunc("ast_nodes_dropped", len(ast) - keep_ast)
        record_trunc("change_nodes_dropped", len(change) - keep_change)
        ast, change = ast[:keep_ast], change[:keep_change]
        edge_ast = [(a, b) for a, b in edge_ast
                    if a < keep_ast and b < keep_ast]
        edge_ast_code = [(a, j) for a, j in edge_ast_code if a < keep_ast]
        edge_change_ast = [(c, a) for c, a in edge_change_ast
                           if c < keep_change and a < keep_ast]
        edge_change_code = [(c, j) for c, j in edge_change_code
                            if c < keep_change]

    record = CommitRecord(
        diff_tokens=tokens, diff_marks=marks, diff_atts=atts,
        msg_tokens=list(req.msg_tokens), var_map=dict(req.var_map),
        ast_labels=ast, change_labels=change,
        edge_ast=edge_ast, edge_ast_code=edge_ast_code,
        edge_change_ast=edge_change_ast,
        edge_change_code=edge_change_code)
    return record, info


# --------------------------------------------------------------------------
# record -> wire payload
# --------------------------------------------------------------------------

def _clip_edges(ex, cfg: FiraConfig) -> Tuple[object, int]:
    """Fit an example's ragged COO under ``cfg.max_edges``: drop trailing
    family edges (the self-loops, the last ``graph_len`` entries the
    bucketed ``make_batch`` drops from, stay whole)."""
    # firacheck: allow[HOST-SYNC] Example arrays are host numpy (data/dataset.process_record output); shape arithmetic is pure host planning
    n = int(ex.senders.shape[0])
    if n <= cfg.max_edges:
        return ex, 0
    fam = n - cfg.graph_len
    keep_fam = cfg.max_edges - cfg.graph_len
    sel = np.r_[0:keep_fam, fam:n]
    return dataclasses.replace(
        ex, senders=ex.senders[sel], receivers=ex.receivers[sel],
        values=ex.values[sel], kinds=ex.kinds[sel]), fam - keep_fam


def ingest_request(text: str, word_vocab: Vocab, ast_change_vocab: Vocab,
                   cfg: FiraConfig, *, table=None,
                   truncate: Optional[str] = None,
                   batch_size: int = 1,
                   lex=None,
                   executor: Optional[IngestExecutor] = None) -> Dict:
    """One raw request -> its wire payload (the ``make_batch`` dict of the
    corpus path, request in row 0 and the other ``batch_size - 1`` rows
    padding), plus host-only metadata:

    - ``_bucket``   smallest admissible decode bucket of ``table`` by the
                    request's measured extents (0 without a table);
    - ``_var``      the request's anonymization map, one entry per row;
    - ``_ingest``   per-stage seconds (``lex_s``/``parse_s``/
                    ``assemble_s``), token count, the truncation record,
                    the degradation reason, and the OOV fallback counts
                    (``oov_words``: diff/msg tokens encoded to <unkm>;
                    ``oov_ast``: AST/change labels encoded to <pad>);
                    with an ``executor``, also ``memo_hits`` and
                    ``memo_misses``, the hunk memo's reuse inside this
                    request.

    ``lex``/``executor``: the fast-path hooks (ingest/cache.py): the
    lexer memo for the lex stage, and the parse-stage executor (inline
    with the hunk memo, or the spawned process pool). None runs the plain
    pipeline; the payload is bit-exact either way.
    """
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.dataset import ProcessedSplit, process_record

    t0 = time.perf_counter()
    req = parse_request(text, lex=lex)
    t1 = time.perf_counter()
    memo_hits = memo_misses = 0
    if executor is not None:
        record, info, memo_hits, memo_misses = executor.parse(
            req, cfg, truncate or cfg.ingest_truncate)
    else:
        record, info = ingest_record(req, cfg, truncate=truncate)
    t2 = time.perf_counter()

    words = _LenientVocab(word_vocab)
    asts = _LenientVocab(ast_change_vocab)
    ex = process_record(record, words, asts, cfg)
    ex, edges_dropped = _clip_edges(ex, cfg)
    if edges_dropped:
        if (truncate or cfg.ingest_truncate) == "shed":
            raise IngestError(
                f"diff has {edges_dropped} edges beyond max_edges "
                f"{cfg.max_edges} (ingest_truncate=shed)")
        info["truncated"] = dict(info["truncated"] or {},
                                 edges_dropped=edges_dropped)
    split1 = ProcessedSplit.from_examples([ex])
    if table is not None:
        from fira_tpu_torch.data import buckets as buckets_lib

        ext = buckets_lib.sample_extents(split1, cfg)
        if cfg.decode_tar_buckets and not record.msg_tokens:
            # tar-bucketed assignment goes by the reference message's
            # extent, the generation budget; a diff with no reference
            # reserves the full tar budget, or its message would be
            # clipped at a small bucket's tar
            ext = dataclasses.replace(
                ext, msg=np.full_like(ext.msg, cfg.tar_len))
        bucket = int(buckets_lib.assign_buckets(
            ext, table, use_msg=cfg.decode_tar_buckets)[0])
        geom = table[bucket]
    else:
        bucket, geom = 0, None
    # firacheck: allow[HOST-SYNC] np.asarray of a host int list builds the make_batch index chunk; no device value exists here
    host = make_batch(split1, np.asarray([0]), cfg, batch_size=batch_size,
                      geom=geom)
    t3 = time.perf_counter()

    host["_bucket"] = bucket
    host["_var"] = [req.var_map or None] + [None] * (batch_size - 1)
    host["_ingest"] = {
        "lex_s": round(t1 - t0, 9),
        "parse_s": round(t2 - t1, 9),
        "assemble_s": round(t3 - t2, 9),
        "n_tokens": len(record.diff_tokens),
        "truncated": info["truncated"],
        "degraded": info["degraded"],
        "oov_words": words.unk_fallbacks,
        "oov_ast": asts.pad_fallbacks,
    }
    if executor is not None:
        # the partial-hit meter: hunk-memo reuse inside a whole-diff miss,
        # apart from the result cache's `cached` flag
        host["_ingest"]["memo_hits"] = memo_hits
        host["_ingest"]["memo_misses"] = memo_misses
    return host


def build_fast_path(cfg: FiraConfig, *, faults=None, context=None):
    """The fast-path objects of one serve run, per the knobs: ``(cache,
    lex, executor)``. The whole-diff result cache and the lexer memo
    (None with ``ingest_cache`` off); the executor: the spawned process
    pool under ``ingest_exec=process``, the inline one carrying the hunk
    memo when the cache is on, else None (the plain pipeline).

    ``context``: ``(word_vocab, ast_change_vocab, cfg, table)``; given,
    the process pool ingests whole requests (raw text out, an assembled
    payload back), so the parent's time a request is pickling only. The
    caller owns ``executor.close()``."""
    cache = lex = memo = None
    if cfg.ingest_cache:
        cache = IngestCache(cfg.ingest_cache_entries,
                            max_bytes=cfg.ingest_cache_bytes,
                            faults=faults)
        memo = HunkMemo()
        lex = LexMemo()
    if cfg.ingest_exec == "process":
        executor = IngestExecutor(
            "process", workers=cfg.ingest_workers or cfg.feeder_workers,
            context=context)
    elif memo is not None:
        executor = IngestExecutor("thread", memo=memo)
    else:
        executor = None
    return cache, lex, executor


def ingest_request_tasks(requests: Sequence[str], cfg: FiraConfig,
                         word_vocab: Vocab, ast_change_vocab: Vocab,
                         table=None, faults=None, cache=None, lex=None,
                         executor: Optional[IngestExecutor] = None):
    """One ingest task a request, request order: the Feeder runs them on
    its workers as ``serve/server._request_tasks`` runs corpus assembly,
    so payloads are ready ahead of their arrivals, a failing request
    rides the per-task error channel into the quarantine, and digests are
    stamped on the worker when the prefix cache is on. The
    ``ingest.parse`` fault site fires here (raise or hang before the
    parse, corrupt on the assembled payload; each retry a fresh keyed
    draw).

    ``cache``/``lex``/``executor``: the fast path (:func:`build_fast_path`).
    With the cache the raw text is content-addressed before any lexing: a
    byte-identical repeat skips the pipeline and replays the stored
    payload (``_ingest`` stamps with ``cached: True``); the
    ``ingest.cache`` site fires inside the lookup (raise: a miss; corrupt:
    a checksum drop and a re-ingest). The cache stores the clean
    computation: the ``ingest.parse`` corrupt scramble and the prefix
    cache's digest stamp are applied per emission, after the lookup, so
    a fault's blast radius and the dedup identities are the cache-off
    path's."""
    from fira_tpu_torch.data.feeder import task_note
    from fira_tpu_torch.decode.prefix_cache import stamp_digests
    from fira_tpu_torch.decode.quant import tier_namespace

    stamp = cfg.prefix_cache
    tier_ns = tier_namespace(cfg)
    for i, text in enumerate(requests):
        def task(text=text, i=i, attempts={"n": 0}):
            if faults is not None:
                # the attempt advances before the check, so a fired raise
                # still moves the key: every retry is a fresh draw
                key = (i, attempts["n"])
                attempts["n"] += 1
                faults.check("ingest.parse", key=key)
            host = None
            digest = None
            if cache is not None:
                digest = text_digest(text)
                host, _outcome = cache.take(digest, fault_key=i)
            if host is None:
                # a miss makes this task the digest's in-flight leader:
                # its duplicates wait inside cache.take until put (success)
                # or abandon (a failing request must not wedge them)
                try:
                    if executor is not None and executor.offloads_requests:
                        host = executor.ingest(text)
                    else:
                        host = ingest_request(text, word_vocab,
                                              ast_change_vocab, cfg,
                                              table=table, lex=lex,
                                              executor=executor)
                except BaseException:
                    if cache is not None:
                        cache.abandon(digest)
                    raise
                if cache is not None:
                    cache.put(digest, host)
            if faults is not None:
                host = faults.corrupt("ingest.parse", i, host)
            return stamp_digests(host, tier_ns) if stamp else host
        task.note = task_note([i], site="ingest request")
        yield task


def _template_split(word_vocab: Vocab, ast_change_vocab: Vocab,
                    cfg: FiraConfig):
    """A one-row ProcessedSplit of an empty commit at the config
    geometry: the shapes and dtypes of the all-pad template batches when
    no corpus split backs the request stream."""
    from fira_tpu_torch.data.dataset import ProcessedSplit, process_record

    rec = CommitRecord([], [], [], [], {}, [], [], [], [], [], [])
    ex = process_record(rec, _LenientVocab(word_vocab),
                        _LenientVocab(ast_change_vocab), cfg)
    return ProcessedSplit.from_examples([ex])


# --------------------------------------------------------------------------
# the diff-serving driver (the raw-diff twin of serve.server.serve_split)
# --------------------------------------------------------------------------

def serve_diffs(model, word_vocab: Vocab, ast_change_vocab: Vocab,
                cfg: FiraConfig, *,
                requests: Sequence[str],
                arrival_times,
                out_dir: str = "OUTPUT",
                ablation: Optional[str] = None,
                clock: str = "wall",
                engine=None,
                metrics_path: Optional[str] = None,
                fast_path=None, guard=None) -> Dict:
    """Serve the raw diffs ``requests`` (request ``i`` arrives at
    ``arrival_times[i]``) on the model's device through the ServeLoop of
    ``serve_split``, on one engine or a fleet of ``cfg.engine_replicas``
    (no respawn and no journal here, as in the JAX package): the same
    admission, deadlines, shedding, retirement, dedup, position-keyed
    writer and metrics artifact, the payloads coming from
    :func:`ingest_request` on the Feeder's workers instead of corpus
    ``make_batch``. A request that fails to parse, or that the truncation
    policy rejects, is shed with its error recorded and an empty output
    line; every ingested request's record carries its ``_ingest`` stamps.

    ``engine``: an engine already built and warmed (its caller owns its
    config and stats). ``fast_path``: a caller-owned ``(cache, lex,
    executor)`` from :func:`build_fast_path`, kept across runs (a warm
    process pool); the caller clears and closes it. Without it the run
    builds its own and closes its executor. ``guard``: an armed
    ``analysis.sanitizer.CompileGuard`` for the engines' dispatches; with
    the leak guard armed, the run ends with ``assert_clean`` as
    ``serve_split``'s."""
    from fira_tpu_torch.data import buckets as buckets_lib
    from fira_tpu_torch.data.feeder import Feeder
    from fira_tpu_torch.decode.runner import output_name
    from fira_tpu_torch.decode.stream import OrderedStreamWriter
    from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                            reference_words)
    from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
    from fira_tpu_torch.robust import faults as faults_lib
    from fira_tpu_torch.serve.server import (ServeLoop, build_engines,
                                             finalize_serve_result,
                                             make_clock,
                                             metrics_snapshotter,
                                             prepare_templates,
                                             run_loop_guarded, serve_errors)

    faults = faults_lib.injector_from(cfg)
    times = np.asarray(arrival_times, dtype=np.float64)
    n_req = len(times)
    if n_req != len(requests):
        raise ValueError(f"{len(requests)} requests for {n_req} arrivals")
    errs = serve_errors(cfg, trace=True) + ingest_errors(cfg)
    if errs:
        raise ValueError("; ".join(errs))
    clk = make_clock(clock)

    table = buckets_lib.decode_table(cfg) if cfg.buckets else None
    model.eval()
    owner, engines, built = build_engines(model, cfg, engine=engine,
                                          faults=faults, guard=guard)
    templates = prepare_templates(
        owner, _template_split(word_vocab, ast_change_vocab, cfg), cfg,
        table, prewarm=built, guard=guard)

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, output_name(ablation))
    bleu_by_pos: Dict[int, float] = {}
    snapshot = metrics_snapshotter(metrics_path, owner, faults)

    def emit(pos, host, row, tokens, probs):
        # the sample emitter's tail with the request's own anonymization
        # map (the packed batch's _var column): the same cooking, so a
        # reconstructed corpus request serves the graphs path's line
        best = int(np.argmax(probs))
        # firacheck: allow[HOST-SYNC] tokens is the host numpy beam the engine's harvest returned; cooking it into text is the output boundary
        hyp = cook_prediction(tokens[best].tolist()[1:], host["diff"][row],
                              host["sub_token"][row], word_vocab, cfg,
                              resolve=False)
        ref = reference_words(host["msg"][row], word_vocab)
        bleu_by_pos[pos] = nltk_sentence_bleu([ref], hyp)
        vm = host.get("_var")
        var_map = vm[row] if vm is not None else None
        writer.add(pos, " ".join(deanonymize(hyp, var_map)) + "\n")

    # the pipeline depth scales with the worker count: single-row payloads
    # are small, and a depth of feeder_depth would idle a wide pool once
    # four payloads are ready; the workers must run ahead of arrivals
    workers = cfg.ingest_workers or cfg.feeder_workers
    depth = max(cfg.feeder_depth, 4 * max(1, workers))
    if fast_path is not None:
        cache, lex, executor = fast_path
        own_executor = None
    else:
        cache, lex, executor = build_fast_path(
            cfg, faults=faults,
            context=(word_vocab, ast_change_vocab, cfg, table))
        own_executor = executor
    try:
        with OrderedStreamWriter(out_path, expected=n_req) as writer, \
                Feeder(ingest_request_tasks(requests, cfg, word_vocab,
                                            ast_change_vocab, table,
                                            faults=faults, cache=cache,
                                            lex=lex, executor=executor),
                       num_workers=workers, depth=depth, put=False,
                       on_error="record",
                       retries=max(0, cfg.robust_retries),
                       faults=faults) as feed:
            loop = ServeLoop(
                engines, cfg, arrival_times=times, feed=feed, table=table,
                assignment=None, templates=templates, clock=clk, emit=emit,
                shed=lambda rec: writer.add(rec.position, "\n"),
                faults=faults, snapshot=snapshot)
            loop.stats.ingest_pipeline = (workers, depth)
            if cache is not None:
                # the run's cache meter, in the summary's ingest block
                loop.stats.ingest_cache = cache.summary
            stats = run_loop_guarded(loop, snapshot)
    finally:
        if own_executor is not None:
            own_executor.close()
    from fira_tpu_torch.analysis.sanitizer import leak_guard

    lg = leak_guard()
    if lg is not None:
        lg.assert_clean("serve_diffs teardown")
    return finalize_serve_result(stats, owner, faults, out_path=out_path,
                                 bleu_by_pos=bleu_by_pos,
                                 metrics_path=metrics_path)


# --------------------------------------------------------------------------
# one-shot: cli message <diff-file>
# --------------------------------------------------------------------------

def one_shot_message(model, word_vocab: Vocab, ast_change_vocab: Vocab,
                     cfg: FiraConfig, text: str, *,
                     stats: Optional[Dict] = None) -> str:
    """One diff in, one commit message out (``cli message``): ingest the
    request (truncation policy included), run the batched beam
    ``make_beam_search(model, cfg)`` on the model's device and in its
    compute dtype over a ``cfg.test_batch_size``-row batch (the request
    and padding rows, the JAX package's shapes), cook and de-anonymize the
    argmax beam. ``stats``, when given, receives the ``_ingest`` stamps,
    the beam's and the cooking's seconds (``beam_s``, ``cook_s``; the
    beam's include the copy to the device and the tokens' copy back) and
    the request row's beam probabilities (``probs``, beam width floats)."""
    from fira_tpu_torch.data.feeder import batch_to_device
    from fira_tpu_torch.decode.beam import make_beam_search
    from fira_tpu_torch.decode.text import cook_prediction, deanonymize

    host = ingest_request(text, word_vocab, ast_change_vocab, cfg,
                          batch_size=cfg.test_batch_size)
    t0 = time.perf_counter()
    model.eval()
    device = next(model.parameters()).device
    tokens, probs = make_beam_search(model, cfg)(batch_to_device(host,
                                                                 device))
    tokens, probs = tokens[0].cpu().numpy(), probs[0].cpu().numpy()
    t1 = time.perf_counter()
    best = int(np.argmax(probs))
    hyp = cook_prediction(tokens[best].tolist()[1:], host["diff"][0],
                          host["sub_token"][0], word_vocab, cfg,
                          resolve=False)
    message = " ".join(deanonymize(hyp, host["_var"][0]))
    if stats is not None:
        stats.update(host["_ingest"], beam_s=t1 - t0,
                     cook_s=time.perf_counter() - t1, probs=probs)
    return message

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
- malformed diff text raises ``difftext.DiffParseError``.

:func:`one_shot_message` is ``cli message``: one diff in, the batched
beam on the model's device, one message out. Serving raw diffs (the
result cache, the memos, the process executor, ``serve_diffs``) comes
with the serving loop (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.schema import CommitRecord
from fira_tpu_torch.data.vocab import PAD_ID, UNK_TOKEN, Vocab, normalize_token
from fira_tpu_torch.ingest.cache import EXEC_MODES
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
                  commit_index: Optional[int] = None
                  ) -> Tuple[CommitRecord, Dict]:
    """Parsed request -> :class:`CommitRecord` + per-request info dict
    (``truncated``: what the deterministic clip dropped, or None;
    ``degraded``: the extraction error the request degraded on, or
    None). Mirrors the offline pipeline exactly for requests that fit
    the config geometry, the round-trip contract's precondition."""
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
                                   commit_index=commit_index)
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
                   batch_size: int = 1) -> Dict:
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
                    ``oov_ast``: AST/change labels encoded to <pad>).
    """
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.dataset import ProcessedSplit, process_record

    t0 = time.perf_counter()
    req = parse_request(text)
    t1 = time.perf_counter()
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
    return host


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

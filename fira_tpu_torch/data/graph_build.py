"""Pure graph-assembly functions: sub-token dedup, copy labels, edge COO.

This is the parity-critical heart of the data layer, a function-for-invariant
rebuild of the reference's per-commit tensorization (Dataset.py:96-334) with
one deliberate representation change: the adjacency leaves the host as a
normalized COO edge list (senders/receivers/values), never as a dense
graph_len^2 array. The reference densifies every sample on the host
(Dataset.py:336-343; ~287 MB per 170-batch) — the device scatters the COO into
a dense batch once per step, so the host->device
transfer is ~100x smaller and the GCN still runs a dense bmm.

Node index space (Dataset.py:225-266 offset arithmetic), for the full config:
  [0, sou_len)                         diff tokens (incl. <start> at 0)
  [sou_len, sou_len+sub_token_len)     sub-token nodes
  [sou_len+sub_token_len, graph_len)   AST-type nodes, then change nodes
                                       (change nodes start at +len(ast_labels))

Replicated quirks (SURVEY.md Appendix B):
- the six edge families collapse into ONE untyped adjacency (process_edge's
  `kind` argument is dead, Dataset.py:346-357);
- code-side skip rule `p2 >= sou_len` applies to change->code and ast->code
  edges only (Dataset.py:228,243); sub-token and sequential edges are NOT
  range-checked by the reference. We check only the graph_len bound (indices
  beyond it would have crashed the reference's scipy constructor, so raising
  preserves crash parity); an over-long diff or sub-token list whose edges
  bleed across region boundaries but stay inside the graph is wired exactly
  as the reference wires it — silently;
- diff copy labels carry a +1 <start> shift, sub-token labels do not
  (Dataset.py:202,213), and diff copies take precedence (Dataset.py:210-211);
- symmetric degree normalization 1/sqrt(deg_row)/sqrt(deg_col) computed over
  the deduplicated, self-looped edge multiset (Dataset.py:277-291).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


class GraphBuildError(ValueError):
    pass


def dedup_sub_tokens(
    diff_tokens: Sequence[str], diff_atts: Sequence[Sequence[str]]
) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Sub-token node list + (token_pos, sub_pos) edges with per-token dedup.

    Dataset.py:173-196: a repeated integral token reuses its existing
    sub-token nodes and only contributes new edges. Positions are relative to
    the raw (unshifted, unpadded) diff.
    """
    sub_tokens: List[str] = []
    edges: List[Tuple[int, int]] = []
    seen: Dict[str, List[int]] = {}
    for j, att in enumerate(diff_atts):
        if not att:
            continue
        for part in att:
            # crash parity with Dataset.py:148-151: a non-lowercase sub-token
            # would silently miss copy-label matches against normalized
            # message tokens, so fail loudly like the reference does.
            if not part.islower():
                raise GraphBuildError(
                    f"sub-token {part!r} of token {diff_tokens[j]!r} is not "
                    f"lower-case"
                )
        token = diff_tokens[j]
        if token in seen:
            existing = [sub_tokens[k] for k in seen[token]]
            if existing != list(att):
                raise GraphBuildError(
                    f"token {token!r} repeated with different sub-tokens: "
                    f"{existing} vs {list(att)}"
                )
            for k in seen[token]:
                edges.append((j, k))
        else:
            start = len(sub_tokens)
            seen[token] = list(range(start, start + len(att)))
            sub_tokens.extend(att)
            for k in seen[token]:
                edges.append((j, k))
    return sub_tokens, edges


def copy_labels(
    msg_ids: Sequence[int],
    msg_tokens: Sequence[str],
    diff_tokens: Sequence[str],
    sub_tokens: Sequence[str],
    vocab_size: int,
    sou_len: int,
    use_subtoken_copy: bool = True,
    sub_token_len: int = None,
) -> List[int]:
    """Per-position target labels with copy ids (Dataset.py:199-213).

    A message token found among the diff tokens gets label
    ``vocab_size + diff_index + 1`` (the +1 mirrors the <start> shift of the
    padded diff). One found among sub-tokens gets
    ``vocab_size + sou_len + sub_index`` — unless a diff copy already claimed
    the position (diff precedence). Otherwise the label stays the vocab id.

    Replicated quirk: indices come from the UNtruncated diff/sub-token lists
    (Dataset.py:202,209 search the raw lists), so a first occurrence past the
    padded length yields a label in the wrong copy span — exactly as the
    reference supervises it. A label beyond the fused distribution entirely
    (diff index >= sou_len + sub_token_len - 1) made the reference's torch
    NLL crash loudly; a clamping gather would not, so when ``sub_token_len``
    is given we raise instead.
    """
    labels = list(msg_ids)
    for k, token in enumerate(msg_tokens):
        if token in diff_tokens:
            labels[k] = diff_tokens.index(token) + vocab_size + 1
    if use_subtoken_copy:
        for k, token in enumerate(msg_tokens):
            if token in sub_tokens:
                if labels[k] >= vocab_size:
                    continue  # diff copy wins (Dataset.py:210-211)
                labels[k] = sub_tokens.index(token) + vocab_size + sou_len
    if sub_token_len is not None:
        width = vocab_size + sou_len + sub_token_len
        for k, label in enumerate(labels):
            if label >= width:
                raise GraphBuildError(
                    f"copy label {label} at msg position {k} exceeds the "
                    f"fused distribution width {width}"
                )
    return labels


# Edge-family kinds, in the reference's insertion order (Dataset.py:220-275).
# The reference COMPUTES these six families then flattens them (process_edge's
# `kind` argument is dead, Dataset.py:346-357); kinds are retained here so the
# opt-in typed-edge extension (cfg.typed_edges) can weight families — with all
# weights 1 it reproduces the flattened reference graph exactly.
EDGE_KIND_CHANGE_CODE = 0
EDGE_KIND_CHANGE_AST = 1
EDGE_KIND_AST_CODE = 2
EDGE_KIND_AST_AST = 3
EDGE_KIND_CODE_SUBTOKEN = 4
EDGE_KIND_SEQUENTIAL = 5
EDGE_KIND_SELF_LOOP = 6
N_EDGE_KINDS = 7


@dataclasses.dataclass
class CooAdjacency:
    """Symmetric, degree-normalized adjacency as COO triplets."""

    senders: np.ndarray    # int32 [n_edges]
    receivers: np.ndarray  # int32 [n_edges]
    values: np.ndarray     # float32 [n_edges]
    kinds: np.ndarray      # int8 [n_edges] (EDGE_KIND_*; first family wins
                           # on dedup, like the reference's first-insert)

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    def to_dense(self, n: int) -> np.ndarray:
        dense = np.zeros((n, n), dtype=np.float32)
        dense[self.senders, self.receivers] = self.values
        return dense


def build_adjacency(
    *,
    sou_len: int,
    sub_token_len: int,
    ast_change_len: int,
    raw_diff_len: int,
    n_ast: int,
    edge_change_code: Sequence[Tuple[int, int]],
    edge_change_ast: Sequence[Tuple[int, int]],
    edge_ast_code: Sequence[Tuple[int, int]],
    edge_ast: Sequence[Tuple[int, int]],
    edge_sub_token: Sequence[Tuple[int, int]],
    use_edit: bool = True,
) -> CooAdjacency:
    """Assemble the per-commit adjacency exactly as Dataset.py:220-294.

    Families are appended in the reference's order (change-code, change-ast,
    ast-code, ast-ast, code-subtoken, sequential chain, self-loops), each edge
    inserted symmetrically once, then symmetrically degree-normalized.
    ``use_edit=False`` drops the two change families (no_edit ablation).
    """
    graph_len = sou_len + sub_token_len + ast_change_len
    ast_base = sou_len + sub_token_len
    change_base = ast_base + n_ast

    pairs: List[Tuple[int, int]] = []
    kinds: List[int] = []
    seen = set()

    def add(p1: int, p2: int, kind: int) -> None:
        # process_edge (Dataset.py:346-357): both directions, dedup, weight 1.
        if not (0 <= p1 < graph_len and 0 <= p2 < graph_len):
            raise GraphBuildError(
                f"edge ({p1},{p2}) outside graph of {graph_len} nodes"
            )
        if (p1, p2) not in seen:
            seen.add((p1, p2))
            pairs.append((p1, p2))
            kinds.append(kind)
        if (p2, p1) not in seen:
            seen.add((p2, p1))
            pairs.append((p2, p1))
            kinds.append(kind)

    if use_edit:
        for c, j in edge_change_code:          # Dataset.py:225-230
            p2 = j + 1
            if p2 >= sou_len:
                continue
            add(change_base + c, p2, EDGE_KIND_CHANGE_CODE)
        for c, a in edge_change_ast:           # Dataset.py:233-237
            add(change_base + c, ast_base + a, EDGE_KIND_CHANGE_AST)
    for a, j in edge_ast_code:                 # Dataset.py:240-245
        p2 = j + 1
        if p2 >= sou_len:
            continue
        add(ast_base + a, p2, EDGE_KIND_AST_CODE)
    for a1, a2 in edge_ast:                    # Dataset.py:248-252
        add(ast_base + a1, ast_base + a2, EDGE_KIND_AST_AST)
    for j, k in edge_sub_token:                # Dataset.py:255-259
        add(j + 1, sou_len + k, EDGE_KIND_CODE_SUBTOKEN)
    for j in range(raw_diff_len + 2 - 1):      # Dataset.py:263-266
        add(j, j + 1, EDGE_KIND_SEQUENTIAL)

    for i in range(graph_len):                 # Dataset.py:271-275
        if (i, i) in seen:
            raise GraphBuildError(f"explicit self-edge on node {i} before self-loops")
        pairs.append((i, i))
        kinds.append(EDGE_KIND_SELF_LOOP)

    rows = np.fromiter((p[0] for p in pairs), dtype=np.int32, count=len(pairs))
    cols = np.fromiter((p[1] for p in pairs), dtype=np.int32, count=len(pairs))
    # symmetric degree normalization (Dataset.py:277-291)
    deg_row = np.bincount(rows, minlength=graph_len).astype(np.float64)
    deg_col = np.bincount(cols, minlength=graph_len).astype(np.float64)
    values = 1.0 / np.sqrt(deg_row[rows]) / np.sqrt(deg_col[cols])
    return CooAdjacency(rows, cols, values.astype(np.float32),
                        np.asarray(kinds, dtype=np.int8))



"""Plain tensorisation of generated commits, written from FIRA's data
semantics (reference ``Dataset.py``:96-343), independent of the port:
ids with <start>/<eos> and padding, the diff marks, the AST + edit-op
node ids, the per-token sub-token nodes, the copy labels and the dense,
symmetric, self-looped, degree-normalised adjacency.

Imports torch and numpy only. ``geom`` is a plain dict of the
configuration's sizes (``sou_len``, ``tar_len``, ``sub_token_len``,
``ast_change_len``, ``vocab_size``) and the vocabularies map token
strings to ids.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

PAD, EOS, START, UNK = 0, 1, 2, 3


def _pad(ids: Sequence[int], n: int) -> List[int]:
    ids = list(ids)[:n]
    return ids + [PAD] * (n - len(ids))


def _ids(tokens, vocab: Dict[str, int]) -> List[int]:
    return [vocab.get(t, UNK) for t in tokens]


def _sub_nodes(tokens, atts):
    """Sub-token nodes, one run a distinct token (a repeat reuses its
    token's nodes), and the (diff position, node) pairs."""
    nodes: List[str] = []
    first: Dict[str, List[int]] = {}
    pairs = []
    for j, parts in enumerate(atts):
        if not parts:
            continue
        t = tokens[j]
        if t not in first:
            first[t] = list(range(len(nodes), len(nodes) + len(parts)))
            nodes.extend(parts)
        pairs.extend((j, k) for k in first[t])
    return nodes, pairs


def _labels(msg, msg_ids, tokens, nodes, V: int, sou: int) -> List[int]:
    """Copy labels: a message word found in the diff points at its first
    position there (+1 for <start>); else one found among the sub-token
    nodes points there; else its vocabulary id."""
    out = list(msg_ids)
    for k, w in enumerate(msg):
        if w in tokens:
            out[k] = V + 1 + tokens.index(w)
        elif w in nodes:
            out[k] = V + sou + nodes.index(w)
    return out


def commit_rows(c: Dict, geom: Dict, words: Dict[str, int],
                asts: Dict[str, int]) -> Dict[str, np.ndarray]:
    """One commit's fixed-length id rows and its undirected edge list."""
    sou, tar = geom["sou_len"], geom["tar_len"]
    sub, ac = geom["sub_token_len"], geom["ast_change_len"]
    V = geom["vocab_size"]
    tokens, msg = c["difftoken"], c["msg"]
    nodes, sub_pairs = _sub_nodes(tokens, c["diffatt"])
    msg_ids = _ids(msg, words)
    ast_base, change_base = sou + sub, sou + sub + len(c["ast"])
    edges = []
    for ch, j in c["edge_change_code"]:
        if j + 1 < sou:
            edges.append((change_base + ch, j + 1))
    edges += [(change_base + ch, ast_base + a)
              for ch, a in c["edge_change_ast"]]
    edges += [(ast_base + a, j + 1) for a, j in c["edge_ast_code"]
              if j + 1 < sou]
    edges += [(ast_base + a, ast_base + b) for a, b in c["edge_ast"]]
    edges += [(j + 1, sou + k) for j, k in sub_pairs]
    edges += [(j, j + 1) for j in range(len(tokens) + 1)]
    return dict(
        diff=np.array(_pad([START] + _ids(tokens, words) + [EOS], sou)),
        mark=np.array(_pad([2] + list(c["diffmark"]) + [2], sou)),
        ast_change=np.array(_pad(_ids(c["ast"] + c["change"], asts), ac)),
        sub_token=np.array(_pad(_ids(nodes, words), sub)),
        msg=np.array(_pad([START] + msg_ids + [EOS], tar)),
        msg_tar=np.array(_pad(
            [START] + _labels(msg, msg_ids, tokens, nodes, V, sou) + [EOS],
            tar)),
        edges=np.array(edges, dtype=np.int64).reshape(-1, 2))


def dense_adjacency(edge_lists, n: int, device) -> torch.Tensor:
    """(B, n, n) f32: each edge both ways once, a self-loop on every
    node, then A[i, j] / sqrt(deg i) / sqrt(deg j)."""
    B = len(edge_lists)
    a = torch.zeros((B, n, n), dtype=torch.float32, device=device)
    for b, e in enumerate(edge_lists):
        e = torch.as_tensor(e, device=device)
        a[b, e[:, 0], e[:, 1]] = 1.0
        a[b, e[:, 1], e[:, 0]] = 1.0
    a += torch.eye(n, device=device)
    a = a.clamp(max=1.0)
    d = a.sum(-1).rsqrt()
    return a * d[:, :, None] * d[:, None, :]


def make_batch(commits: Sequence[Dict], geom: Dict, words, asts,
               device) -> Dict[str, torch.Tensor]:
    """Stacked int64 id rows and the dense adjacency of ``commits``."""
    rows = [commit_rows(c, geom, words, asts) for c in commits]
    out = {k: torch.as_tensor(np.stack([r[k] for r in rows]),
                              dtype=torch.long, device=device)
           for k in ("diff", "mark", "ast_change", "sub_token", "msg",
                     "msg_tar")}
    n = geom["sou_len"] + geom["sub_token_len"] + geom["ast_change_len"]
    out["adj"] = dense_adjacency([r["edges"] for r in rows], n, device)
    return out

"""Seeded commit generator: the benchmark's frozen, widened copy of the
synthetic corpus generator (``fira_tpu_torch/data/synthetic.py``
``generate_corpus``), in the same 11-stream schema.

Widened in three ways:

- every length is drawn from a clipped log-normal whose parameters the
  traffic file gives (``commits`` block): raw diff tokens, the share of
  diff tokens that are identifiers with sub-tokens, AST nodes, edit-op
  (change) nodes, message tokens; each is clipped at FIRA's caps (210
  diff positions with <start>/<eos>, 160 sub-token nodes, 280 AST and
  change nodes, 30 message positions, 6,144 COO entries);
- the word vocabulary is filled to ``vocab_size`` (24,650 published) and
  the AST/edit vocabulary to ``ast_vocab_size`` (71);
- ids are drawn over the whole vocabulary, by a bounded Zipf law over
  ranks (exponent ``zipf``), as code tokens are.

A word is the string ``w<id>`` and an AST label ``a<id>``: both are fixed
points of the port's case normalisation and lemmatisation, so the id a
token gets is its own number. Variable anonymisation is not drawn
(``variable`` is empty for every commit).

Byte-stable for a seed: draws come from numpy's legacy ``RandomState``,
whose streams numpy keeps fixed across versions.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

WORD_SPECIALS = ["<pad>", "<eos>", "<start>", "<unkm>"]
CHANGE_LABELS = ["update", "delete", "add", "move", "match"]
AST_SPECIALS = ["<pad>"] + CHANGE_LABELS

# FIRA's caps (reference run_model.py:31-35 and the port's max_edges)
SOU_LEN, SUB_LEN, AST_CHANGE_LEN, TAR_LEN, MAX_EDGES = 210, 160, 280, 30, 6144


def rng_for(seed: int, stream: int = 0) -> np.random.RandomState:
    """A legacy RandomState keyed by a seed of up to 64 bits and a
    stream number."""
    seed = int(seed)
    return np.random.RandomState(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(stream)])


def word_vocab(size: int) -> Dict[str, int]:
    vocab = {t: i for i, t in enumerate(WORD_SPECIALS)}
    vocab.update((f"w{i}", i) for i in range(len(WORD_SPECIALS), size))
    return vocab


def ast_vocab(size: int) -> Dict[str, int]:
    vocab = {t: i for i, t in enumerate(AST_SPECIALS)}
    vocab.update((f"a{i}", i) for i in range(len(AST_SPECIALS), size))
    return vocab


class _Zipf:
    """Bounded Zipf draws over ``n`` ranks starting at id ``first``."""

    def __init__(self, first: int, n: int, s: float):
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
        self.cdf = np.cumsum(w) / w.sum()
        self.first = first

    def draw(self, rng, k: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random_sample(k), side="right")
        return self.first + np.minimum(idx, len(self.cdf) - 1)


def _length(rng, spec: Dict, hi: int) -> int:
    """A clipped log-normal length: median ``median``, log-sd ``sigma``,
    within [min, min(max, hi)]."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"])
    return int(np.clip(round(x), spec["min"], min(spec["max"], hi)))


def generate(params: Dict, n: int, seed: int) -> List[Dict]:
    """``n`` commits from ``params`` (a traffic file's ``commits`` block,
    with the vocabulary sizes and, where they are not FIRA's, the caps:
    ``sou_len`` ...), each a dict of the 11 corpus streams
    (``difftoken`` ... ``edge_*``)."""
    rng = rng_for(seed, 1)
    sou = int(params.get("sou_len", SOU_LEN))
    sub_len = int(params.get("sub_token_len", SUB_LEN))
    ac = int(params.get("ast_change_len", AST_CHANGE_LEN))
    tar = int(params.get("tar_len", TAR_LEN))
    V = int(params["vocab_size"])
    A = int(params["ast_vocab_size"])
    words = _Zipf(len(WORD_SPECIALS), V - len(WORD_SPECIALS),
                  float(params["zipf"]))
    n_labels = A - len(AST_SPECIALS)
    out = []
    for _ in range(n):
        n_diff = _length(rng, params["diff_tokens"], sou - 2)
        ids = words.draw(rng, n_diff)
        tokens = [f"w{i}" for i in ids]
        marks = rng.choice([1, 2, 3], size=n_diff,
                           p=params["mark_p"]).tolist()
        # identifiers: each distinct token is one with probability
        # ident_share, its parts fixed within the commit (the sub-token
        # dedup's contract), until the 160 sub-token nodes are spent
        parts_of: Dict[str, List[str]] = {}
        n_sub = 0
        lo, hi = params["parts_per_ident"]
        for t in dict.fromkeys(tokens):
            if rng.random_sample() >= params["ident_share"]:
                continue
            k = int(rng.randint(lo, hi + 1))
            if n_sub + k > sub_len:
                break
            parts_of[t] = [f"w{i}" for i in words.draw(rng, k)]
            n_sub += k
        atts = [list(parts_of.get(t, ())) for t in tokens]

        n_ast = _length(rng, params["ast_nodes"], ac - 1)
        n_change = _length(rng, params["change_nodes"], ac - n_ast)
        ast = [f"a{len(AST_SPECIALS) + int(i)}"
               for i in rng.randint(0, n_labels, size=n_ast)]
        change = [CHANGE_LABELS[int(i)]
                  for i in rng.randint(0, len(CHANGE_LABELS), size=n_change)]
        # a tree over the AST nodes; leaf edges into the raw diff; each
        # edit op touches code or AST nodes
        edge_ast = [[int(rng.randint(0, i)), i] for i in range(1, n_ast)]
        n_leaf = int(round(params["ast_code_share"] * n_ast))
        edge_ast_code = [[int(a), int(j)] for a, j in zip(
            rng.randint(0, n_ast, size=n_leaf),
            rng.randint(0, n_diff, size=n_leaf))]
        elo, ehi = params["edges_per_change"]
        edge_change_ast, edge_change_code = [], []
        for c in range(n_change):
            for _e in range(int(rng.randint(elo, ehi + 1))):
                if rng.random_sample() < params["change_code_share"]:
                    edge_change_code.append([c, int(rng.randint(0, n_diff))])
                else:
                    edge_change_ast.append([c, int(rng.randint(0, n_ast))])

        n_msg = _length(rng, params["msg_tokens"], tar - 2)
        subs = [p for t in parts_of for p in parts_of[t]]
        msg = []
        copy, sub = params["msg_copy_share"], params["msg_sub_share"]
        for u in rng.random_sample(n_msg):
            if u < copy:
                msg.append(tokens[int(rng.randint(0, n_diff))])
            elif subs and u < copy + sub:
                msg.append(subs[int(rng.randint(0, len(subs)))])
            else:
                msg.append(f"w{int(words.draw(rng, 1)[0])}")
        out.append(dict(
            difftoken=tokens, diffmark=marks, diffatt=atts, msg=msg,
            variable={}, ast=ast, change=change, edge_ast=edge_ast,
            edge_ast_code=edge_ast_code, edge_change_ast=edge_change_ast,
            edge_change_code=edge_change_code))
    return out


def edge_entries(commit: Dict, use_edit: bool = True) -> int:
    """COO entries the commit's self-looped, symmetric adjacency has at
    the full geometry (an upper bound: duplicates collapse)."""
    fam = (len(commit["edge_ast"]) + len(commit["edge_ast_code"])
           + sum(len(a) for a in commit["diffatt"]))
    if use_edit:
        fam += len(commit["edge_change_ast"]) + len(commit["edge_change_code"])
    seq = len(commit["difftoken"]) + 1
    return 2 * (fam + seq) + SOU_LEN + SUB_LEN + AST_CHANGE_LEN

"""Deterministic synthetic corpus in the reference DataSet/ schema.

The reference's corpus blobs are stripped from the mount (SURVEY.md caveat),
so tests and the fira-tiny config run on generated commits that are
structurally faithful to Appendix A: <nb>/<nl> sentinel blocks with mark-2
headers, deleted/added/context runs, camelCase sub-token splits, variable
anonymization maps, a small AST with parent-child edges, AST->code leaf
edges, and change (edit-op) nodes wired to both code and AST — i.e. every
edge family the graph assembly wires.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from fira_tpu_torch.data.schema import Corpus
from fira_tpu_torch.data.vocab import LEMMATIZATION, Vocab, normalize_token

_PARTS = [
    "get", "set", "add", "remove", "update", "check", "user", "name",
    "count", "value", "index", "list", "node", "item", "cache", "parser",
    "token", "buffer", "handler", "config", "state", "map", "size", "flag",
]
_TYPES = ["int", "long", "boolean", "String", "void", "Object"]
_MSG_VERBS = ["fixed", "added", "removed", "update", "refactor", "use", "handle"]
_MSG_NOUNS = ["bug", "npe", "leak", "test", "check", "logic", "default", "case"]
_AST_LABELS = [
    "typedeclaration", "methoddeclaration", "block",
    "variabledeclarationstatement", "methodinvocation", "simplename",
    "ifstatement", "returnstatement", "assignment", "expressionstatement",
]
_CHANGE_KINDS = ["match", "update", "move", "delete", "add"]

# --- planted-signal mode (generate_corpus(signal=True)) ---
# The quality-parity campaign needs a corpus where each ablated channel
# carries information recoverable ONLY through that channel, so the Table-3
# ablation ORDERING becomes a test of whether the architecture exploits the
# channel — the mechanism the paper's ablations demonstrate — rather than a
# coin flip on signal-free noise:
#   edit channel: the message verb is (usually) a function of the change
#     NODES' kind labels, which are what use_edit=False removes; the kinds
#     are sampled independently of the diff text, so nothing else reveals
#     them.
#   sub-token channel: messages (usually) include a camelCase part of an
#     identifier present in THIS commit, drawn from a pool with a rare tail
#     — the generation path can't learn rare parts seen once, the sub-token
#     copy pointer reads them off the diff.
_KIND_VERB = {"delete": "removed", "add": "added", "update": "update",
              "move": "refactor", "match": "handle"}
_KIND_PRIORITY = ["delete", "add", "update", "move", "match"]
# ~13.8k entries: over a 90k-commit corpus each appears only a few times,
# so the generation softmax can't learn it but the copy pointer can read it
_PARTS_RARE = [p + q + r for p in _PARTS for q in _PARTS for r in _PARTS]


def _camel(rng: random.Random, n_parts: int = 2) -> Tuple[str, List[str]]:
    parts = [rng.choice(_PARTS) for _ in range(n_parts)]
    name = parts[0] + "".join(p.capitalize() for p in parts[1:])
    return name, parts


def _atts_for(token: str, split_map: Dict[str, List[str]]) -> List[str]:
    return list(split_map.get(token, []))


def generate_corpus(n_commits: int, seed: int = 0,
                    signal: bool = False) -> Corpus:
    """``signal=False`` (default) is byte-stable for a given seed — tests
    and pinned artifacts depend on it. ``signal=True`` plants the
    channel-specific message signal described above for the ablation
    campaign; it draws extra randomness, so it is a different corpus."""
    rng = random.Random(seed)
    streams: Dict[str, list] = {
        k: [] for k in [
            "difftoken", "diffmark", "diffatt", "msg", "variable", "ast",
            "change", "edge_ast", "edge_ast_code", "edge_change_ast",
            "edge_change_code",
        ]
    }

    for _ in range(n_commits):
        split_map: Dict[str, List[str]] = {}

        def ident(n_parts=2):
            if signal and rng.random() < 0.25:
                # rare-tail part: seen in ~a handful of commits corpus-wide,
                # so only the sub-token copy pointer can reproduce it
                parts = [rng.choice(_PARTS), rng.choice(_PARTS_RARE)]
                name = parts[0] + parts[1].capitalize()
            else:
                name, parts = _camel(rng, n_parts)
            if len(parts) > 1:
                split_map[name] = parts
            return name

        cls = ident(2).capitalize()
        method = ident(2)
        old_var = ident(2)
        new_var = ident(2)
        typ = rng.choice(_TYPES)

        # header block: <nb> ... <nl>, all context (mark 2)
        tokens: List[str] = ["<nb>", "class", cls, "<nl>"]
        marks: List[int] = [2, 2, 2, 2]

        def emit(toks: List[str], mark: int):
            tokens.extend(toks)
            marks.extend([mark] * len(toks))

        emit(["public", typ, method, "(", ")", "{"], 2)
        emit(["int", old_var, "=", f"NUMBER{rng.randrange(4)}", ";"], 1)   # deleted
        emit(["int", new_var, "=", f"NUMBER{rng.randrange(4)}", ";"], 3)   # added
        if rng.random() < 0.5:
            extra = ident(2)
            emit(["return", extra, ";"], rng.choice([1, 2, 3]))
        emit(["}"], 2)

        diff_atts = [_atts_for(t, split_map) for t in tokens]

        # variable anonymization: occasionally map an identifier to a placeholder
        var_map: Dict[str, str] = {}
        if rng.random() < 0.4:
            secret = method
            var_map[secret] = f"STRING{rng.randrange(8)}"
            split_map.pop(secret, None)
            for j, t in enumerate(tokens):
                if t == secret:
                    diff_atts[j] = []

        # message: verbs trigger lemmatization; copyable identifiers + subtoken parts
        msg = [rng.choice(_MSG_VERBS), rng.choice(_MSG_NOUNS)]
        if rng.random() < 0.7:
            msg += ["in", rng.choice([method, old_var, new_var])]
        if rng.random() < 0.5:
            msg += [rng.choice(_PARTS)]  # often a sub-token of something

        # small AST over the method: indices into ast list
        n_ast = rng.randint(3, 6)
        ast = [rng.choice(_AST_LABELS) for _ in range(n_ast)]
        ast[0] = "typedeclaration"
        edge_ast = [[rng.randrange(i), i] for i in range(1, n_ast)]  # tree edges

        # AST leaves point at identifier positions in the raw diff
        ident_positions = [
            j for j, t in enumerate(tokens)
            if t not in ("<nb>", "<nl>") and marks[j] in (1, 2, 3) and t[0].isalpha()
        ]
        rng.shuffle(ident_positions)
        edge_ast_code = []
        used_code = set()
        for a in range(n_ast):
            if rng.random() < 0.6 and ident_positions:
                pos = ident_positions.pop()
                if pos not in used_code:
                    used_code.add(pos)
                    edge_ast_code.append([a, pos])

        # change nodes: each touches either a code position or an ast node
        n_change = rng.randint(1, 3)
        change = [rng.choice(_CHANGE_KINDS) for _ in range(n_change)]
        edge_change_code = []
        edge_change_ast = []
        for c in range(n_change):
            if rng.random() < 0.5 and ident_positions:
                pos = ident_positions.pop()
                if pos not in used_code:
                    used_code.add(pos)
                    edge_change_code.append([c, pos])
                    continue
            edge_change_ast.append([c, rng.randrange(n_ast)])

        if signal:
            # edit-channel plant: the verb follows the change nodes' kind
            # labels (sampled independently of the diff text, so ONLY the
            # change nodes — what use_edit=False removes — reveal it)
            for kind in _KIND_PRIORITY:
                if kind in change:
                    if rng.random() < 0.85:
                        msg[0] = _KIND_VERB[kind]
                    break
            # sub-token-channel plant: a camelCase part of an identifier in
            # THIS commit; the rare tail makes the copy pointer the only
            # reliable route
            parts_pool = [p for nm in (method, old_var, new_var)
                          for p in split_map.get(nm, [])]
            if parts_pool and rng.random() < 0.8:
                msg.append(rng.choice(parts_pool))

        streams["difftoken"].append(tokens)
        streams["diffmark"].append(marks)
        streams["diffatt"].append(diff_atts)
        streams["msg"].append(msg)
        streams["variable"].append(var_map)
        streams["ast"].append(ast)
        streams["change"].append(change)
        streams["edge_ast"].append(edge_ast)
        streams["edge_ast_code"].append(edge_ast_code)
        streams["edge_change_ast"].append(edge_change_ast)
        streams["edge_change_code"].append(edge_change_code)

    return Corpus(streams)


def build_vocabs(corpus: Corpus, min_freq: int = 1) -> Tuple[Vocab, Vocab]:
    """Word + ast/change vocabs over the processed token space (substituted,
    case-normalized, lemmatized), mirroring what the reference ships."""
    from fira_tpu_torch.data.dataset import _substitute

    word_streams = []
    for i in range(len(corpus)):
        var_map = corpus.streams["variable"][i]
        diff = _substitute(corpus.streams["difftoken"][i], var_map)
        msg = [
            LEMMATIZATION.get(t, t)
            for t in _substitute(corpus.streams["msg"][i], var_map)
        ]
        subs = [p for att in corpus.streams["diffatt"][i] for p in att]
        word_streams.extend([diff, msg, subs])
    word_vocab = Vocab.build_word_vocab(word_streams, min_freq=min_freq)
    ast_vocab = Vocab.build_ast_change_vocab(corpus.streams["ast"])
    return word_vocab, ast_vocab


def write_corpus_dir(data_dir: str, n_commits: int, seed: int = 0,
                     min_freq: int = 1, signal: bool = False) -> Corpus:
    """Generate and persist a DataSet/-layout corpus directory."""
    corpus = generate_corpus(n_commits, seed=seed, signal=signal)
    corpus.save(data_dir)
    word_vocab, ast_vocab = build_vocabs(corpus, min_freq=min_freq)
    import os

    word_vocab.to_json(os.path.join(data_dir, "word_vocab.json"))
    ast_vocab.to_json(os.path.join(data_dir, "ast_change_vocab.json"))
    return corpus


def write_extracted_corpus_dir(data_dir: str, n_commits: int, seed: int = 0,
                               min_freq: int = 1) -> Corpus:
    """A corpus whose graph streams come from the real extraction
    pipeline instead of the random synthetic ones: the synthetic
    difftoken/diffmark/msg/variable streams are kept, ``diffatt`` is
    re-derived (``pipeline.derive_diffatt``, the reference convention),
    and ast/change/edge_* are produced by ``pipeline.process_commits``
    (FSM + native astdiff extraction, per-commit degradation included).

    The round-trip corpus of the ingest equivalence contract
    (docs/INGEST.md): a commit's reconstructed unified diff pushed
    through ``ingest`` re-runs the same FSM and extraction and must
    reproduce these streams, hence byte-identical wire payloads."""
    import os

    from fira_tpu_torch.preprocess.pipeline import (derive_diffatt,
                                                    process_commits)

    corpus = generate_corpus(n_commits, seed=seed)
    corpus.streams["diffatt"] = derive_diffatt(corpus.streams["difftoken"])
    # index_offset clears the reference's per-corpus commit-70 case
    # (extract.ast_code_edges' 'nextParent'): ingest extracts requests
    # with no index, so the round-trip corpus is extracted without one too
    streams, _errors = process_commits(corpus.streams["difftoken"],
                                       corpus.streams["diffmark"],
                                       0, n_commits,
                                       index_offset=1_000_000)
    corpus.streams.update(streams)
    corpus.save(data_dir)
    word_vocab, ast_vocab = build_vocabs(corpus, min_freq=min_freq)
    word_vocab.to_json(os.path.join(data_dir, "word_vocab.json"))
    ast_vocab.to_json(os.path.join(data_dir, "ast_change_vocab.json"))
    return corpus

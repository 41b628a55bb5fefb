"""Typed schema for the 11-stream commit corpus (SURVEY.md Appendix A).

The reference keeps the corpus as 11 index-aligned JSON lists under DataSet/
(Dataset.py:30-44). ``CommitRecord`` is the per-commit view; ``Corpus`` loads,
validates, and iterates the directory layout. The same layout is produced by
the synthetic generator and by the preprocessing pipeline, so everything
downstream is source-agnostic.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Tuple

# file name -> (json key used internally)
CORPUS_FILES = [
    "difftoken.json",       # [str] diff tokens with <nb>/<nl> sentinels
    "diffmark.json",        # [int] 1=deleted, 2=context, 3=added
    "diffatt.json",         # [[str]] per-token sub-token lists ([] if none)
    "msg.json",             # [str] first-sentence commit message tokens
    "variable.json",        # {orig_identifier: placeholder}
    "ast.json",             # [str] AST internal-node type labels
    "change.json",          # [str] edit-op labels (match/update/move/delete/add)
    "edge_ast.json",        # [[i,j]] AST parent->child (indices into ast)
    "edge_ast_code.json",   # [[ast_i, code_j]] AST-leaf-parent -> raw diff pos
    "edge_change_ast.json", # [[change_i, ast_j]]
    "edge_change_code.json" # [[change_i, code_j]]
]

WORD_VOCAB_FILE = "word_vocab.json"
AST_CHANGE_VOCAB_FILE = "ast_change_vocab.json"
SPLIT_INDEX_FILE = "all_index"  # {'train': [...], 'valid': [...], 'test': [...]}


@dataclasses.dataclass
class CommitRecord:
    """One commit's change representation (pre-tensorization)."""

    diff_tokens: List[str]
    diff_marks: List[int]
    diff_atts: List[List[str]]
    msg_tokens: List[str]
    var_map: Dict[str, str]
    ast_labels: List[str]
    change_labels: List[str]
    edge_ast: List[Tuple[int, int]]
    edge_ast_code: List[Tuple[int, int]]
    edge_change_ast: List[Tuple[int, int]]
    edge_change_code: List[Tuple[int, int]]


class Corpus:
    """The 11 index-aligned streams, loaded whole (they are small per-commit)."""

    def __init__(self, streams: Dict[str, list]):
        self.streams = streams
        lengths = {k: len(v) for k, v in streams.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"corpus streams disagree on length: {lengths}")
        self.num_commits = next(iter(lengths.values()))

    @classmethod
    def load(cls, data_dir: str) -> "Corpus":
        streams = {}
        for fname in CORPUS_FILES:
            with open(os.path.join(data_dir, fname)) as f:
                streams[fname.removesuffix(".json")] = json.load(f)
        return cls(streams)

    def save(self, data_dir: str) -> None:
        os.makedirs(data_dir, exist_ok=True)
        for fname in CORPUS_FILES:
            key = fname.removesuffix(".json")
            with open(os.path.join(data_dir, fname), "w") as f:
                json.dump(self.streams[key], f)

    def __len__(self) -> int:
        return self.num_commits

    def record(self, i: int) -> CommitRecord:
        s = self.streams
        return CommitRecord(
            diff_tokens=list(s["difftoken"][i]),
            diff_marks=list(s["diffmark"][i]),
            diff_atts=[list(a) for a in s["diffatt"][i]],
            msg_tokens=list(s["msg"][i]),
            var_map=dict(s["variable"][i]),
            ast_labels=list(s["ast"][i]),
            change_labels=list(s["change"][i]),
            edge_ast=[tuple(e) for e in s["edge_ast"][i]],
            edge_ast_code=[tuple(e) for e in s["edge_ast_code"][i]],
            edge_change_ast=[tuple(e) for e in s["edge_change_ast"][i]],
            edge_change_code=[tuple(e) for e in s["edge_change_code"][i]],
        )

    def records(self) -> Iterator[CommitRecord]:
        for i in range(self.num_commits):
            yield self.record(i)

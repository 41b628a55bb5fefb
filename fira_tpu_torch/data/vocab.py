"""Vocabularies and token normalization rules.

Rebuilds the reference's two-vocabulary scheme:
- word vocab: ids 0-3 are <pad>, <eos>, <start>, <unkm>, then corpus tokens
  (run_model.py:48-53, DataSet/word_vocab.json schema).
- ast/change vocab: ids 0-5 are <pad>, update, delete, add, move, match, then
  lower-cased AST type labels (Dataset.py:46-62).

Token normalization (Dataset.py:69-78,123-137): every token is lower-cased
unless it belongs to the case-preserved placeholder set; unknown tokens map to
<unkm>; commit messages additionally lemmatize added/fixed/removed (and -ing
forms) to their stems.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence

PAD_TOKEN = "<pad>"
EOS_TOKEN = "<eos>"
START_TOKEN = "<start>"
UNK_TOKEN = "<unkm>"
WORD_SPECIALS = [PAD_TOKEN, EOS_TOKEN, START_TOKEN, UNK_TOKEN]

PAD_ID, EOS_ID, START_ID, UNK_ID = 0, 1, 2, 3

# Edit-operation labels occupy ids 1-5 of the ast/change vocab (Dataset.py:56).
CHANGE_LABELS = ["update", "delete", "add", "move", "match"]
AST_CHANGE_SPECIALS = [PAD_TOKEN] + CHANGE_LABELS

# Message lemmatization table (Dataset.py:15).
LEMMATIZATION = {
    "added": "add",
    "fixed": "fix",
    "removed": "remove",
    "adding": "add",
    "fixing": "fix",
    "removing": "remove",
}

# Case-preserved placeholder tokens (the reference's VOCAB_UPPER_CASE file,
# 163 entries). Three bare anonymization markers, numbered literal
# placeholders, and 33 corpus-derived label-like tokens that survived
# anonymization. Membership is all that matters (Dataset.py:72,128).
_LABEL_LIKE = [
    "withInt:", "TODO:", "Note:", "forString:", "initWithLong:",
    "ofItemAtPath:", "WALK:", "Zeros:", "withChar:", "SubjectDN:",
    "IssuerDN:", "nextParent:", "methodLoop:", "eachFont:", "READ:",
    "classLoop:", "handleKeyboard:", "initWithNSString:", "FIXME:",
    "mainLoop:", "Students:", "initWithInt:", "withNSString:",
    "Distribution:", "Normalized:", "Size:", "Uniform:", "VI:", "TBD:",
    "STARTWALK:", "DESTSTOPS:", "Fingerprint:", "checkSupertypes:",
]
CASE_PRESERVED_TOKENS = frozenset(
    ["NAMESPACE", "SINGLE", "COMMENT"]
    + [f"STRING{i}" for i in range(62)]
    + [f"NUMBER{i}" for i in range(52)]
    + [f"FLOAT{i}" for i in range(13)]
    + _LABEL_LIKE
)


def normalize_token(token: str) -> str:
    """Lower-case unless the token is a case-preserved placeholder."""
    return token if token in CASE_PRESERVED_TOKENS else token.lower()


class Vocab:
    """A frozen token->id mapping with the reference's conversion semantics."""

    def __init__(self, token_to_id: Dict[str, int]):
        self.token_to_id = dict(token_to_id)
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}

    def __len__(self) -> int:
        return len(self.token_to_id)

    def __contains__(self, token: str) -> bool:
        return token in self.token_to_id

    def __getitem__(self, token: str) -> int:
        return self.token_to_id[token]

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        """Dataset.py:69-78: case-normalize, then map with <unkm> fallback.

        The ast/change vocab has no <unkm> (the reference guarantees coverage
        by building it over the full corpus, Dataset.py:46-60) — an unknown
        there is a data bug and raises instead of silently mapping."""
        out = []
        for t in tokens:
            t = normalize_token(t)
            if t in self.token_to_id:
                out.append(self.token_to_id[t])
            elif UNK_TOKEN in self.token_to_id:
                out.append(self.token_to_id[UNK_TOKEN])
            else:
                raise KeyError(f"token {t!r} missing from un-UNK'd vocab")
        return out

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.id_to_token[i] for i in ids]

    # --- construction ---

    @classmethod
    def from_json(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls(json.load(f))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.token_to_id, f, indent=1)

    @classmethod
    def build_word_vocab(
        cls, token_streams: Iterable[Sequence[str]], min_freq: int = 1
    ) -> "Vocab":
        """Frequency-ordered word vocab with the 4 specials up front."""
        freq: Dict[str, int] = {}
        for stream in token_streams:
            for tok in stream:
                tok = normalize_token(tok)
                freq[tok] = freq.get(tok, 0) + 1
        mapping = {t: i for i, t in enumerate(WORD_SPECIALS)}
        for tok in sorted(freq, key=lambda t: (-freq[t], t)):
            if freq[tok] >= min_freq and tok not in mapping:
                mapping[tok] = len(mapping)
        return cls(mapping)

    @classmethod
    def build_ast_change_vocab(
        cls, ast_label_streams: Iterable[Sequence[str]], threshold: int = 1
    ) -> "Vocab":
        """Dataset.py:46-60: specials then lower-cased AST labels >= threshold,
        in first-seen order (dict insertion order, as the reference iterates)."""
        counts: Dict[str, int] = {}
        for stream in ast_label_streams:
            for label in stream:
                label = label.lower()
                counts[label] = counts.get(label, 0) + 1
        mapping = {t: i for i, t in enumerate(AST_CHANGE_SPECIALS)}
        for label, c in counts.items():
            if c >= threshold and label not in mapping:
                mapping[label] = len(mapping)
        return cls(mapping)


def pad_sequence(seq: List[int], max_len: int, pad_id: int = PAD_ID) -> List[int]:
    """Dataset.py:80-86: right-pad or truncate to exactly max_len."""
    if len(seq) < max_len:
        return seq + [pad_id] * (max_len - len(seq))
    return seq[:max_len]

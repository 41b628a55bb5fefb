"""ROUGE-L for commit messages, sumeval-equivalent.

The reference shells out to the ``sumeval`` CLI (Metrics/
Rouge.py:8-11); ROUGE-L is implemented in-repo instead (the port's copy
of ``fira_tpu/eval/rouge.py``). The pipeline was pinned EMPIRICALLY against the paper's
own numbers: lower-case, strip every non-alphanumeric character, whitespace
split, no stopword removal, no stemming, LCS F-measure with alpha=0.5,
averaged x100 over index-paired lines. On the shipped OUTPUT/ files this
reproduces all four published ROUGE-L rows simultaneously —
21.58 / 21.15 / 20.97 / 20.15 (FIRA / -edit / -subtoken / -nothing,
preprint Table 1+3) — each within +-0.005, which pins the tokenization as
sumeval's (tests/test_metrics_golden.py, on the JAX package's copy)."""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence

_NON_ALNUM = re.compile(r"[^a-z0-9 ]")


def _tokenize(line: str) -> List[str]:
    """sumeval-equivalent preprocessing: lower-case, drop every character
    outside [a-z0-9 ], whitespace split."""
    return _NON_ALNUM.sub(" ", line.strip().lower()).split()


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: str, ref: str, alpha: float = 0.5) -> float:
    h, r = _tokenize(hyp), _tokenize(ref)
    lcs = _lcs_len(h, r)
    if lcs == 0:
        return 0.0
    precision = lcs / len(h)
    recall = lcs / len(r)
    return precision * recall / ((1 - alpha) * precision + alpha * recall)


def rouge_l(hyp_lines: Iterable[str], ref_lines: Iterable[str]) -> float:
    """Mean sentence ROUGE-L F1 x100 over index-matched pairs."""
    refs = [r.strip() for r in ref_lines if r.strip()]
    hyps = list(hyp_lines)
    if not refs:
        return 0.0
    total = 0.0
    n = 0
    for i, ref in enumerate(refs):
        if i >= len(hyps):
            break
        total += rouge_l_sentence(hyps[i], ref)
        n += 1
    return total * 100.0 / max(n, 1)


def rouge_l_files(hyp_path: str, ref_path: str) -> float:
    with open(hyp_path) as h, open(ref_path) as r:
        return rouge_l(h.readlines(), r.readlines())

"""B-Norm BLEU — the metric of record for commit-message quality.

Behavior-identical rebuild of the reference scorer
(Metrics/Bleu-B-Norm.py): punctuation pre-split + lower-case
pairing keyed by line index (:131-155), NIST mteval-v11a normalization
(:10-42), per-sentence BLEU-4 with +1 smoothing on n>1 and the
(reflen+1)/(testlen+1) brevity penalty (:94-129), averaged x100 over pairs
(:160-169). The port's copy of ``fira_tpu/eval/bnorm_bleu.py``;
tests/test_torch_eval.py holds it to that module's floats.

One deliberate divergence: an empty hypothesis line is scored as the empty
string instead of crashing (the reference raises at Bleu-B-Norm.py:142); the
shipped OUTPUT files contain no empty lines, so golden numbers are unaffected.
"""

from __future__ import annotations

import math
import re
import sys
import xml.sax.saxutils
from typing import Iterable, List, Sequence, Tuple

_N = 4  # BLEU order

# mteval-v11a language-independent pass (Bleu-B-Norm.py:10-16)
_PRE_RULES = [
    (re.compile("<skipped>"), ""),
    (re.compile(r"-\n"), ""),
    (re.compile(r"\n"), " "),
]

# mteval-v11a western-language tokenization pass (Bleu-B-Norm.py:18-24)
_POST_RULES = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def mteval_tokenize(text) -> List[str]:
    """NIST mteval-v11a normalize + tokenize (Bleu-B-Norm.py:26-42)."""
    if not isinstance(text, str):
        text = " ".join(text)
    for pat, rep in _PRE_RULES:
        text = pat.sub(rep, text)
    text = xml.sax.saxutils.unescape(text, {"&quot;": '"'})
    text = " %s " % text
    text = text.lower()
    for pat, rep in _POST_RULES:
        text = pat.sub(rep, text)
    return text.split()


def split_punct(line: str) -> str:
    """Word/punct splitter applied before pairing (Bleu-B-Norm.py:131-132)."""
    return " ".join(re.findall(r"[\w]+|[^\s\w]", line))


def _ngram_counts(words: Sequence[str], max_n: int = _N) -> dict:
    counts: dict = {}
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            gram = tuple(words[i : i + n])
            counts[gram] = counts.get(gram, 0) + 1
    return counts


def sentence_bleu_stats(
    hypothesis: str, references: Sequence[str]
) -> Tuple[float, int]:
    """Smoothed sentence BLEU and the effective (shortest) reference length.

    Mirrors cook_refs/cook_test/score_cooked (Bleu-B-Norm.py:52-129) for a
    single sentence pair: clipped n-gram matches against the per-n max count
    over references, +1 smoothing for n>1, and brevity penalty
    min(0, 1 - (reflen+1)/(testlen+1)).
    """
    ref_token_lists = [mteval_tokenize(r) for r in references]
    hyp = mteval_tokenize(hypothesis)

    max_ref_counts: dict = {}
    for ref in ref_token_lists:
        for gram, c in _ngram_counts(ref).items():
            if c > max_ref_counts.get(gram, 0):
                max_ref_counts[gram] = c
    ref_len = min(len(r) for r in ref_token_lists)

    guess = [max(len(hyp) - n + 1, 0) for n in range(1, _N + 1)]
    correct = [0] * _N
    for gram, c in _ngram_counts(hyp).items():
        correct[len(gram) - 1] += min(max_ref_counts.get(gram, 0), c)

    tiny = sys.float_info.min  # keeps log() total, as the reference does (:110)
    log_bleu = 0.0
    for n in range(_N):
        smooth = 1 if n > 0 else 0
        log_bleu += math.log(correct[n] + smooth + tiny) - math.log(
            guess[n] + smooth + tiny
        )
    log_bleu /= float(_N)
    log_bleu += min(0.0, 1.0 - float(ref_len + 1) / (len(hyp) + 1))
    return math.exp(log_bleu), ref_len


def _pair_by_index(
    hyp_lines: Iterable[str], ref_lines: Iterable[str]
) -> List[Tuple[str, str]]:
    """Index-matched (hyp, ref) pairs after the reference's cooking.

    References: blank lines dropped before numbering (Bleu-B-Norm.py:173).
    Both sides: strip, lower, punct-split (:146,153). Unpaired trailing
    hypotheses are silently ignored (OUTPUT/ground_truth is 7,660 lines vs
    7,661 predictions — the last prediction never scores).
    """
    refs = [r.strip() for r in ref_lines if r.strip()]
    hyps = list(hyp_lines)
    pairs = []
    for i, ref in enumerate(refs):
        if i >= len(hyps):
            break
        hyp = hyps[i]
        pairs.append(
            (split_punct(hyp.strip().lower()), split_punct(ref.strip().lower()))
        )
    return pairs


def bnorm_bleu(hyp_lines: Iterable[str], ref_lines: Iterable[str]) -> float:
    """Corpus B-Norm BLEU x100 (mean of per-pair smoothed BLEU-4)."""
    pairs = _pair_by_index(hyp_lines, ref_lines)
    if not pairs:
        return 0.0
    total = 0.0
    for hyp, ref in pairs:
        score, _ = sentence_bleu_stats(hyp, [ref])
        total += score
    return total * 100.0 / len(pairs)


def bnorm_bleu_files(hyp_path: str, ref_path: str) -> float:
    with open(hyp_path) as h, open(ref_path) as r:
        return bnorm_bleu(h.readlines(), r.readlines())

"""In-loop dev/test BLEU: NLTK sentence_bleu with method2 smoothing.

The reference gates its best-checkpoint decision on THIS metric
(run_model.py:22,171: nltk sentence_bleu, SmoothingFunction
method2), which differs from the reported B-Norm number. To reproduce the
same "best" checkpoint selection we implement method2 exactly: BLEU-4 with
uniform weights where every n-gram numerator and denominator gets +1 for
n > 1, and the standard exp brevity penalty. Falls back to NLTK itself when
available (they agree to float precision; see tests/test_metrics_golden.py).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu_method2(
    references: List[Sequence[str]], hypothesis: Sequence[str]
) -> float:
    """nltk.translate.bleu_score.sentence_bleu(..., smoothing_function=method2).

    NLTK semantics replicated (verified against the installed NLTK in
    tests/test_metrics_golden.py): modified precision clips against the
    per-reference max count with denominator floored at 1 (so 4-grams of a
    3-token hypothesis contribute 0/1); a zero unigram match zeroes the whole
    score BEFORE smoothing; method2 then adds 1 to numerator and denominator
    for n >= 2 only; brevity penalty uses the closest reference length
    (ties -> shorter).
    """
    hyp_len = len(hypothesis)
    if hyp_len == 0:
        return 0.0

    # closest reference length (nltk closest_ref_length)
    ref_lens = [len(r) for r in references]
    closest = min(ref_lens, key=lambda rl: (abs(rl - hyp_len), rl))

    p_log_sum = 0.0
    for n in range(1, 5):
        hyp_counts = _ngrams(hypothesis, n)
        max_counts: Counter = Counter()
        for ref in references:
            for gram, c in _ngrams(ref, n).items():
                if c > max_counts[gram]:
                    max_counts[gram] = c
        clipped = sum(min(c, max_counts[g]) for g, c in hyp_counts.items())
        total = max(hyp_len - n + 1, 1)  # nltk modified_precision denominator
        if n == 1 and clipped == 0:
            return 0.0
        if n >= 2:
            clipped += 1
            total += 1
        p_log_sum += 0.25 * math.log(clipped / total)

    if hyp_len > closest:
        bp = 1.0
    else:
        bp = math.exp(1 - closest / hyp_len)
    return bp * math.exp(p_log_sum)


def nltk_sentence_bleu(references, hypothesis) -> float:
    """Prefer real NLTK when importable (exact reference behavior); otherwise
    use the in-repo replication above."""
    try:
        import nltk.translate.bleu_score as bleu_score

        smooth = bleu_score.SmoothingFunction().method2
        return bleu_score.sentence_bleu(
            references, hypothesis, smoothing_function=smooth
        )
    except Exception:
        return sentence_bleu_method2(list(references), hypothesis)

"""Penalty-BLEU: reference-length-weighted corpus BLEU.

Behavior-identical rebuild of Metrics/Bleu-Penalty.py: the
per-pair cooking is shared with B-Norm BLEU, but the corpus score is a
weighted mean where each pair's weight is its *effective reference length*
share (Bleu-Penalty.py:172-186 — the variable is named ``test_len`` there but
score_cooked returns totalcomps['reflen'] at :124, i.e. the shortest-ref
length; we reproduce that behavior, not the name). The reference prints the
raw [0,1] value; we scale x100 so the paper's Table 2 number (13.30) reads
directly. The port's copy of ``fira_tpu/eval/penalty_bleu.py``.
"""

from __future__ import annotations

from typing import Iterable

from fira_tpu_torch.eval.bnorm_bleu import _pair_by_index, sentence_bleu_stats


def penalty_bleu(hyp_lines: Iterable[str], ref_lines: Iterable[str]) -> float:
    pairs = _pair_by_index(hyp_lines, ref_lines)
    if not pairs:
        return 0.0
    scores = []
    weights = []
    for hyp, ref in pairs:
        score, ref_len = sentence_bleu_stats(hyp, [ref])
        scores.append(score)
        weights.append(ref_len)
    total_weight = float(sum(weights))
    if total_weight == 0:
        return 0.0
    return 100.0 * sum(w / total_weight * s for w, s in zip(weights, scores))


def penalty_bleu_files(hyp_path: str, ref_path: str) -> float:
    with open(hyp_path) as h, open(ref_path) as r:
        return penalty_bleu(h.readlines(), r.readlines())

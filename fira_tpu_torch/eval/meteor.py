"""METEOR, matching Metrics/Meteor.py:8-13: mean per-line
``nltk.translate.meteor_score`` x100 over index-paired files.

Two paths:

- wordnet available -> delegate to NLTK itself (exact parity with the
  reference by construction; its old NLTK split raw strings on whitespace,
  which we replicate by passing ``.split()`` tokens).
- wordnet corpus missing (a host without NLTK's data, as offline ones) ->
  a native implementation of the same algorithm (Lavie-Agarwal alignment:
  exact stage, Porter-stem stage, fmean alpha=0.9, fragmentation penalty
  gamma=0.5 beta=3) MINUS the wordnet-synonym stage. The result is a strict
  lower bound on real METEOR: every synonym pair the wordnet stage would
  align is left unmatched. ``meteor_detail()`` reports which path ran; the
  paper's 14.93 can only be pinned where wordnet exists. The port's copy
  of ``fira_tpu/eval/meteor.py``; ``nltk`` is imported only when a score
  is asked for.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def _wordnet_or_none():
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("test")  # force the corpus load
        return wordnet
    except Exception:
        return None


# ---- native path (NLTK's algorithm, minus the wordnet stage) ----

def _match_stage(enum_hyp: List[Tuple[int, str]],
                 enum_ref: List[Tuple[int, str]], key) -> List[Tuple[int, int]]:
    """Greedy stage alignment over the not-yet-matched words, mirroring
    NLTK's _match_enums/_enum_stem_match traversal order. ``key`` is applied
    once per word (NLTK stems once too), not once per comparison."""
    keyed_hyp = [key(w) for _, w in enum_hyp]
    keyed_ref = [key(w) for _, w in enum_ref]
    matches = []
    for i in range(len(enum_hyp))[::-1]:
        for j in range(len(enum_ref))[::-1]:
            if keyed_hyp[i] == keyed_ref[j]:
                matches.append((enum_hyp[i][0], enum_ref[j][0]))
                enum_hyp.pop(i)
                keyed_hyp.pop(i)
                enum_ref.pop(j)
                keyed_ref.pop(j)
                break
    return matches


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    chunks = 1
    matches = sorted(matches, key=lambda m: m[0])
    for i in range(len(matches) - 1):
        if (matches[i + 1][0] == matches[i][0] + 1
                and matches[i + 1][1] == matches[i][1] + 1):
            continue
        chunks += 1
    return chunks


def _native_single(ref_words: List[str], hyp_words: List[str], *,
                   alpha: float = 0.9, beta: float = 3.0,
                   gamma: float = 0.5) -> float:
    from nltk.stem.porter import PorterStemmer

    stemmer = PorterStemmer()
    enum_hyp = list(enumerate([w.lower() for w in hyp_words]))
    enum_ref = list(enumerate([w.lower() for w in ref_words]))
    n_hyp, n_ref = len(enum_hyp), len(enum_ref)
    matches = _match_stage(enum_hyp, enum_ref, lambda w: w)
    matches += _match_stage(enum_hyp, enum_ref, stemmer.stem)
    m = len(matches)
    if m == 0 or n_hyp == 0 or n_ref == 0:
        return 0.0
    precision = m / n_hyp
    recall = m / n_ref
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    return (1.0 - gamma * frag ** beta) * fmean


def meteor_detail(hyp_lines: Iterable[str], ref_lines: Iterable[str]) -> dict:
    """{'value': mean x100, 'wordnet': bool}. See module docstring."""
    try:
        import nltk  # noqa: F401  (both paths need it: meteor_score / Porter)
    except Exception as e:  # pragma: no cover
        raise RuntimeError(f"nltk unavailable for METEOR: {e}")
    hyps = [h.rstrip("\n") for h in hyp_lines]
    refs = [r.rstrip("\n") for r in ref_lines]
    wn = _wordnet_or_none()
    scores: List[float] = []
    if wn is not None:
        from nltk.translate.meteor_score import meteor_score

        for ref, hyp in zip(refs, hyps):
            scores.append(meteor_score([ref.split()], hyp.split()))
    else:
        for ref, hyp in zip(refs, hyps):
            scores.append(_native_single(ref.split(), hyp.split()))
    value = 100.0 * sum(scores) / len(scores) if scores else 0.0
    return {"value": value, "wordnet": wn is not None}


def meteor(hyp_lines: Iterable[str], ref_lines: Iterable[str]) -> float:
    return meteor_detail(hyp_lines, ref_lines)["value"]


def meteor_detail_files(hyp_path: str, ref_path: str) -> dict:
    # reference splits on "\n" (Meteor.py:9-10), pairing trailing empty strings
    # too; zip() truncates to the shorter list the same way.
    with open(hyp_path) as h, open(ref_path) as r:
        return meteor_detail(h.read().split("\n"), r.read().split("\n"))


def meteor_files(hyp_path: str, ref_path: str) -> float:
    return meteor_detail_files(hyp_path, ref_path)["value"]

"""Host-side id -> text post-processing shared by dev and test decoding.

Replicates the reference's output cooking exactly
(run_model.py:141-179 dev, :342-372 test):
copy-id resolution against the sample's own diff / sub-token id arrays,
<eos> truncation, special-token stripping with <unkm> rendered as the
emoji sentinel, and reverse-variable-map de-anonymization applied AFTER
BLEU is scored on the anonymized tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.vocab import (
    EOS_ID,
    EOS_TOKEN,
    PAD_TOKEN,
    START_TOKEN,
    UNK_TOKEN,
    Vocab,
)

UNK_RENDER = "\U0001f605"  # the reference prints <unkm> as 😅 (run_model.py:162,355)


def resolve_copy_ids(ids: Sequence[int], diff_ids: Sequence[int],
                     sub_token_ids: Sequence[int], cfg: FiraConfig) -> List[int]:
    """run_model.py:154-158: ids >= vocab+sou_len index the sub-token array,
    ids >= vocab index the padded diff array."""
    out = []
    for t in ids:
        if t >= cfg.vocab_size + cfg.sou_len:
            t = int(sub_token_ids[t - cfg.vocab_size - cfg.sou_len])
        elif t >= cfg.vocab_size:
            t = int(diff_ids[t - cfg.vocab_size])
        out.append(int(t))
    return out


def truncate_at_eos(ids: Sequence[int]) -> List[int]:
    ids = list(ids)
    if EOS_ID in ids:
        ids = ids[: ids.index(EOS_ID)]
    return ids


def ids_to_words(ids: Sequence[int], vocab: Vocab) -> List[str]:
    """Tokens with specials stripped and <unkm> rendered (run_model.py:161-163:
    join, replace, strip, re-split — equivalent to dropping strippable tokens)."""
    words = []
    for tok in vocab.convert_ids_to_tokens(ids):
        if tok in (PAD_TOKEN, START_TOKEN, EOS_TOKEN):
            continue
        words.append(UNK_RENDER if tok == UNK_TOKEN else tok)
    return words


def deanonymize(words: Sequence[str], var_map: Optional[Dict[str, str]]) -> List[str]:
    """Reverse the per-commit variable anonymization (run_model.py:143-146,
    175-177): placeholder -> original identifier."""
    if not var_map:
        return list(words)
    reverse = {v: k for k, v in var_map.items()}
    return [reverse.get(w, w) for w in words]


def cook_prediction(ids: Sequence[int], diff_ids, sub_token_ids, vocab: Vocab,
                    cfg: FiraConfig, *, resolve: bool = True) -> List[str]:
    """Greedy/beam output ids -> anonymized word list (pre-BLEU form)."""
    ids = truncate_at_eos(ids)
    if resolve:
        ids = resolve_copy_ids(ids, diff_ids, sub_token_ids, cfg)
    return ids_to_words(ids, vocab)


def reference_words(msg_ids: Sequence[int], vocab: Vocab) -> List[str]:
    """run_model.py:165-167: the <start>-stripped, <eos>-truncated reference."""
    msg_ids = list(np.asarray(msg_ids).tolist())
    return ids_to_words(truncate_at_eos(msg_ids[1:]), vocab)

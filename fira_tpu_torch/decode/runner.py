"""Test-split decoding loop (the reference's ``test()``,
run_model.py:187-380; counterpart of the JAX package's
``decode/runner.py`` on its batched-beam path): decode every sample, pick
the argmax-probability beam, cook text, score in-loop sentence BLEU, and
write one prediction per line to OUTPUT/output_fira (ablations write their
own suffixed files).

A plain loop over the split's ``epoch_index_chunks`` batches: each batch is
assembled on the host, copied to the device from pinned memory without
blocking, and beam-decoded; its tokens come back to the host to be cooked
into text. Lines stream to disk in split order through the ordered writer
(decode/stream.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.batching import epoch_index_chunks, make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.decode.beam import beam_search_cached
from fira_tpu_torch.decode.stream import OrderedStreamWriter
from fira_tpu_torch.decode.text import (cook_prediction, deanonymize,
                                        reference_words)
from fira_tpu_torch.eval.dev_bleu import nltk_sentence_bleu
from fira_tpu_torch.model.model import FiraModel

# batch fields the decode needs on the device (valid stays on the host,
# and so do msg/msg_tar, which only training and the dev gate read there)
DEVICE_FIELDS = ("diff", "diff_mark", "ast_change", "sub_token",
                 "senders", "receivers", "values")
TRAIN_FIELDS = DEVICE_FIELDS + ("msg", "msg_tar")


def output_name(ablation: Optional[str]) -> str:
    """OUTPUT file naming per paper ablation (BASELINE.md rows)."""
    if ablation in (None, "", "none", "full"):
        return "output_fira"
    return f"output_fira_{ablation}"


def sample_emitter(writer, *, vocab, cfg: FiraConfig, bleu_by_pos: Dict,
                   n_total: int, var_maps=None, indices=None):
    """The per-sample tail: pick the argmax beam, cook text, score BLEU,
    de-anonymize, write at the sample's split position."""

    def emit(pos, host, row, tokens, probs):
        best = int(np.argmax(probs))             # run_model.py:351
        ids = tokens[best].tolist()
        # beam output ids are already copy-resolved at extension time
        hyp = cook_prediction(ids[1:], host["diff"][row],
                              host["sub_token"][row], vocab, cfg,
                              resolve=False)
        ref = reference_words(host["msg"][row], vocab)
        # keyed by position, summed in split order at the end
        bleu_by_pos[pos] = nltk_sentence_bleu([ref], hyp)
        n = len(bleu_by_pos)
        var_map = (var_maps[indices[pos]]
                   if var_maps is not None else None)
        writer.add(pos, " ".join(deanonymize(hyp, var_map)) + "\n")
        if n % 1000 == 0:
            writer.flush()
            print(f"decode: {n}/{n_total}", flush=True)

    return emit


def batch_to_device(host: Dict[str, np.ndarray], device: torch.device,
                    fields=DEVICE_FIELDS) -> Dict[str, torch.Tensor]:
    """Copy ``fields`` of a host batch; ids and edge indices travel in
    their narrow wire types and are upcast to int64 on the device. On a
    CUDA device the copies come from pinned memory and do not block."""
    cuda = device.type == "cuda"
    out = {}
    for f in fields:
        t = torch.from_numpy(host[f])
        if cuda:
            t = t.pin_memory()
        t = t.to(device, non_blocking=cuda)
        out[f] = t if f == "values" else t.long()
    return out


def run_test(model: FiraModel, dataset: FiraDataset,
             cfg: Optional[FiraConfig] = None, *,
             out_dir: str = "OUTPUT",
             ablation: Optional[str] = None,
             var_maps: Optional[List[Dict[str, str]]] = None,
             split: str = "test") -> Dict[str, float]:
    """Decode ``split`` with the batched KV-cached beam on the model's
    device. Returns mean sentence BLEU, the sample count and the path."""
    cfg = cfg or dataset.cfg
    device = next(model.parameters()).device
    data = dataset.splits[split]
    vocab = dataset.word_vocab
    indices = dataset.split_indices[split]
    bs = cfg.test_batch_size

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, output_name(ablation))
    bleu_by_pos: Dict[int, float] = {}
    n_total = len(data)
    model.eval()
    cursor = 0
    with OrderedStreamWriter(out_path, expected=n_total) as writer:
        emit = sample_emitter(writer, vocab=vocab, cfg=cfg,
                              bleu_by_pos=bleu_by_pos, n_total=n_total,
                              var_maps=var_maps, indices=indices)
        for chunk in epoch_index_chunks(n_total, cfg, batch_size=bs):
            host = make_batch(data, chunk, cfg, batch_size=bs)
            tokens, probs = beam_search_cached(
                model, batch_to_device(host, device), cfg)
            tokens, probs = tokens.cpu().numpy(), probs.cpu().numpy()
            for i in np.flatnonzero(host["valid"]):
                emit(cursor, host, i, tokens[i], probs[i])
                cursor += 1
    n = len(bleu_by_pos)
    total_bleu = sum(bleu_by_pos[p] for p in sorted(bleu_by_pos))
    return {"sentence_bleu": total_bleu / max(n, 1), "n": float(n),
            "output_path": out_path}  # type: ignore[dict-item]

"""Batched KV-cached beam search (counterpart of the JAX package's
``decode/beam.py::beam_search_cached`` in its default modes).

The reference's decoder loop (run_model.py:187-380) re-runs the full
decoder on the padded prefix per step and beam, fuses gen+copy
probabilities, multiplies by the running beam probability (probabilities,
not log-probs, :271), appends finished-beam sentinel probabilities
(:281-298), takes one global top-k (:305-310), and resolves copy ids to
source token ids at beam-extension time (:334-337).

Here beams fold into the batch dimension and each of the tar_len-1 steps
decodes ONE position against per-layer self-attention caches; the
cross-attention K/V and the copy head's source projection are computed once
per item and repeated per beam. The slice runs the JAX package's default
modes only: reference-compat probability space, selection over the fused
distribution, and all tar_len-1 steps (no early exit).

Ties: ``jax.lax.top_k`` is stable (the lower index wins a tie) and
``torch.topk`` promises no order among ties, so selection sorts with
``torch.sort(descending=True, stable=True)`` and keeps the first K.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.vocab import EOS_ID, START_ID
from fira_tpu_torch.model.model import FiraModel


def _resolve_copy(tok, diff, sub_token, cfg: FiraConfig):
    """Copy-id -> source token id (run_model.py:334-337), vectorized.

    tok: (B, K) candidate ids over the fused output space;
    diff: (B, sou_len); sub_token: (B, sub_token_len), int64.
    """
    V = cfg.vocab_size
    sub_pos = (tok - V - cfg.sou_len).clamp(0, cfg.sub_token_len - 1)
    diff_pos = (tok - V).clamp(0, cfg.sou_len - 1)
    from_sub = torch.gather(sub_token, 1, sub_pos)
    from_diff = torch.gather(diff, 1, diff_pos)
    return torch.where(tok >= V + cfg.sou_len, from_sub,
                       torch.where(tok >= V, from_diff, tok))


def step_valid_mask(flat, s: int, T: int):
    """Cached-decode per-position validity: real (nonzero) prefix tokens,
    position 0 (<start>) always attended, causally restricted to
    positions <= ``s``."""
    base = flat != 0
    base[:, 0] = True
    return base & (torch.arange(T, device=flat.device)[None, :] <= s)


def stable_top_k(x, k: int):
    """Top-k along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _init_beam(B: int, cfg: FiraConfig, device):
    """Initial (tokens, probs, finished) + the masked/pad value: beam 0
    prob 1, the others 0 (run_model.py:216-221); -1 is the reference's
    masked value (:273,294)."""
    K, T = cfg.beam_size, cfg.tar_len
    tokens0 = torch.zeros((B, K, T), dtype=torch.long, device=device)
    tokens0[:, :, 0] = START_ID
    probs0 = torch.zeros((B, K), dtype=torch.float32, device=device)
    probs0[:, 0] = 1.0
    finished0 = torch.zeros((B, K), dtype=torch.bool, device=device)
    return tokens0, probs0, finished0, -1.0


def _selection_tail(cand, tokens, probs, finished, s: int, batch,
                    cfg: FiraConfig, neg: float):
    """Mask finished beams, append their sentinel entries, one global
    top-k over K*W + K candidates, decode sentinels vs real candidates,
    write the chosen token at position s+1 (run_model.py:267-310).
    cand: (B, K, W) candidate scores over the fused output space."""
    B, K, W = cand.shape
    cand = cand.masked_fill(finished[:, :, None], neg)
    sentinel = torch.where(finished, probs, torch.full_like(probs, neg))
    allc = torch.cat([cand.reshape(B, K * W), sentinel], dim=1)
    top_vals, top_idx = stable_top_k(allc, K)           # (B, K)

    is_sent = top_idx >= K * W
    src_beam = torch.where(is_sent, top_idx - K * W, top_idx // W)
    tok = torch.where(is_sent, torch.zeros_like(top_idx), top_idx % W)
    tok = _resolve_copy(tok, batch["diff"], batch["sub_token"], cfg)

    new_tokens = torch.gather(
        tokens, 1, src_beam[:, :, None].expand(B, K, tokens.shape[2]))
    keep = new_tokens[:, :, s + 1]   # finished beams keep their padding
    new_tokens[:, :, s + 1] = torch.where(is_sent, keep, tok)
    new_finished = is_sent | (tok == EOS_ID)
    return new_tokens, top_vals, new_finished, src_beam


def _select(dist, tokens, probs, finished, s: int, batch, cfg: FiraConfig,
            neg: float):
    """One beam-selection round given this step's fused distribution
    dist (B, K, V_out): active beams contribute dist x prob, finished beams
    a sentinel carrying their own probability."""
    return _selection_tail(dist * probs[:, :, None], tokens, probs, finished,
                           s, batch, cfg, neg)


@torch.inference_mode()
def beam_search_cached(model: FiraModel, batch: Dict[str, torch.Tensor],
                       cfg: FiraConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, beam, tar_len) with copy ids already resolved,
    probs (B, beam)); the best beam is argmax(probs) (run_model.py:351).
    ``batch`` holds tensors on the model's device, ids as int64."""
    K, T, V_out = cfg.beam_size, cfg.tar_len, cfg.output_vocab_size
    B = batch["diff"].shape[0]
    L, H = cfg.num_layers, cfg.num_head
    d_head = cfg.embedding_dim // H

    states, mask = model.encode(batch)
    mask_k = mask.repeat_interleave(K, dim=0)
    # project once per ITEM, then repeat per beam (beams share the states)
    cross_k, cross_v, src_proj = model.decode_init(states)
    cross_k = cross_k.repeat_interleave(K, dim=1)   # (L, B*K, H, S, d_head)
    cross_v = cross_v.repeat_interleave(K, dim=1)
    src_proj = src_proj.repeat_interleave(K, dim=0)

    tokens, probs, finished, neg = _init_beam(B, cfg, states.device)
    k_cache = torch.zeros((L, B * K, H, T, d_head), dtype=states.dtype,
                          device=states.device)
    v_cache = torch.zeros_like(k_cache)

    for s in range(T - 1):
        flat = tokens.reshape(B * K, T)
        valid = step_valid_mask(flat, s, T)
        fused, k_cache, v_cache = model.fused_probs_step(
            mask_k, flat[:, s : s + 1], s, k_cache, v_cache, cross_k,
            cross_v, src_proj, valid[:, None, None, :])   # (B*K, 1, V_out)
        tokens, probs, finished, src_beam = _select(
            fused[:, 0, :].reshape(B, K, V_out), tokens, probs, finished, s,
            batch, cfg, neg)
        # permute cached histories to follow their beams
        idx = (src_beam + torch.arange(B, device=src_beam.device)[:, None]
               * K).reshape(-1)
        k_cache = k_cache[:, idx]
        v_cache = v_cache[:, idx]
    return tokens, probs

"""Batched beam search (counterpart of the JAX package's
``decode/beam.py``, every mode of it).

The reference's decoder loop (run_model.py:187-380) re-runs the full
decoder on the padded prefix per step and beam, fuses gen+copy
probabilities, multiplies by the running beam probability (probabilities,
not log-probs, :271), appends finished-beam sentinel probabilities
(:281-298), takes one global top-k (:305-310), and resolves copy ids to
source token ids at beam-extension time (:334-337).

Here beams fold into the batch dimension. The config selects the mode:

- ``beam_kv_cache`` (default): each of the tar_len-1 steps decodes ONE
  position against per-layer self-attention caches, with the
  cross-attention K/V and the copy head's source projection computed once
  per item and repeated per beam (:func:`beam_search_cached`); False
  re-decodes the whole prefix every step, as the reference
  (:func:`beam_search`);
- ``beam_compat_prob_space`` (default): the reference's probability
  space, masked value -1; False accumulates log(clamp(p, 1e-10, 1)),
  masked value -inf;
- ``beam_factored_topk``: candidates from the per-side top-k of the
  unfused (gen, copy, gate), 2K a beam, instead of the fused
  distribution (:func:`_select_factored`);
- ``beam_early_exit``: stop after the first step that starts with every
  beam finished (the one settling step after which the state is a fixed
  point), bit-exact against the full scan; this reads one flag from the
  device a step.

Ties: ``jax.lax.top_k`` gives a tie to the lower index and ``torch.topk``
promises no order among ties, so every top-k here (the global selection
and the factored per-side one) is a stable descending sort
(:func:`stable_top_k`). On the card it is faster, in device time and in
host time a call, than ``torch.topk`` with its ties repaired
(``decode/ablate_topk.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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


def step_valid_mask(flat, s, T: int):
    """Cached-decode per-position validity: real (nonzero) prefix tokens,
    position 0 (<start>) always attended, causally restricted to
    positions <= ``s``. ``s`` is an int (the batched beam: every row at
    one depth) or a (B,) tensor (the slot engine: each row at its slot's
    own), the same per-row rule either way. The mask also guards the
    engine's paged reads: a position a slot never wrote (a stale pool
    block's included) gets -1e9, whose softmax weight is exactly 0."""
    base = flat != 0
    base[:, 0] = True
    lim = s[:, None] if torch.is_tensor(s) else s
    return base & (torch.arange(T, device=flat.device)[None, :] <= lim)


def top_beam_token(tokens, pos):
    """The top beam's token at each row's position ``pos`` (B,): the
    token emitted by the step that advanced row b to ``pos[b]`` (the
    selection's top-k is in descending order, so beam 0 is the running
    best). The spec verify (decode/spec.py) accepts a drafted token
    exactly when it equals this. tokens: (B, K, T)."""
    return tokens[:, 0, :].gather(1, pos[:, None])[:, 0]


def scatter_token(flat, pos, tok):
    """Write ``tok[b]`` at row b's own column ``pos[b]`` of ``flat`` (B,
    T), in place, and return it: the spec drafters' single-beam roll
    (decode/spec.py)."""
    flat[torch.arange(flat.shape[0], device=flat.device), pos] = \
        tok.to(flat.dtype)
    return flat


def stable_top_k(x, k: int):
    """Top-k along the last axis, ties to the lower index (as
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _init_beam(B: int, cfg: FiraConfig, device):
    """Initial (tokens, probs, finished) + the masked/pad value. Prob
    space: beam 0 prob 1, the others 0 (run_model.py:216-221), masked
    value -1 (the reference's, :273,294). Log space: 0 and -inf, masked
    value -inf."""
    K, T = cfg.beam_size, cfg.tar_len
    tokens0 = torch.zeros((B, K, T), dtype=torch.long, device=device)
    tokens0[:, :, 0] = START_ID
    compat = cfg.beam_compat_prob_space
    probs0 = torch.full((B, K), 0.0 if compat else -float("inf"),
                        dtype=torch.float32, device=device)
    probs0[:, 0] = 1.0 if compat else 0.0
    finished0 = torch.zeros((B, K), dtype=torch.bool, device=device)
    return tokens0, probs0, finished0, -1.0 if compat else -float("inf")


def _selection_tail(cand, ids, tokens, probs, finished, s, batch,
                    cfg: FiraConfig, neg: float):
    """Mask finished beams, append their sentinel entries, one global
    top-k over K*W + K candidates, decode sentinels vs real candidates,
    write the chosen token at position s+1 (run_model.py:267-310).
    cand: (B, K, W) candidate scores in the selection space. ids: None
    when W is the fused output space (the token id is the index within
    the beam's W); else a (B, K, W) table of fused-space ids (the factored
    path's per-side candidates). ``s``: an int, or a (B,) tensor of
    per-row positions (the slot engine), where row b writes its own
    column s[b]+1; the per-row math is the same."""
    B, K, W = cand.shape
    cand = cand.masked_fill(finished[:, :, None], neg)
    sentinel = torch.where(finished, probs, torch.full_like(probs, neg))
    allc = torch.cat([cand.reshape(B, K * W), sentinel], dim=1)
    top_vals, top_idx = stable_top_k(allc, K)           # (B, K)

    is_sent = top_idx >= K * W
    zero = torch.zeros_like(top_idx)
    src_beam = torch.where(is_sent, top_idx - K * W, top_idx // W)
    if ids is None:
        tok = torch.where(is_sent, zero, top_idx % W)
    else:
        tok = torch.gather(ids.reshape(B, K * W), 1,
                           torch.where(is_sent, zero, top_idx))
        tok = torch.where(is_sent, zero, tok)
    tok = _resolve_copy(tok, batch["diff"], batch["sub_token"], cfg)

    new_tokens = torch.gather(
        tokens, 1, src_beam[:, :, None].expand(B, K, tokens.shape[2]))
    if torch.is_tensor(s):
        col = (s + 1)[:, None, None].expand(B, K, 1)
        keep = new_tokens.gather(2, col)[:, :, 0]
        new_tokens.scatter_(2, col, torch.where(is_sent, keep, tok)[:, :, None])
    else:
        keep = new_tokens[:, :, s + 1]   # finished beams keep their padding
        new_tokens[:, :, s + 1] = torch.where(is_sent, keep, tok)
    new_finished = is_sent | (tok == EOS_ID)
    return new_tokens, top_vals, new_finished, src_beam


def _candidates(p, probs, cfg: FiraConfig):
    """Candidate scores from probabilities ``p`` (B, K, W) and the running
    beam scores: p x prob, or log(clamp(p, 1e-10, 1)) + prob. A
    prob-space score below the smallest normal float is flushed to zero,
    as XLA flushes subnormal results on the TPU and the CPU (CUDA and
    PyTorch's CPU kernels keep them): after ~25 steps of a flat
    distribution the reference's probability products underflow, and
    from there exact zeros tie and the lowest index wins."""
    if cfg.beam_compat_prob_space:
        c = p * probs[:, :, None]
        return c.masked_fill(c < torch.finfo(c.dtype).tiny, 0.0)
    return torch.log(p.clamp(1e-10, 1.0)) + probs[:, :, None]


def _select(dist, tokens, probs, finished, s, batch, cfg: FiraConfig,
            neg: float):
    """One beam-selection round given this step's fused distribution
    dist (B, K, V_out): active beams contribute their candidates, finished
    beams a sentinel carrying their own score."""
    return _selection_tail(_candidates(dist, probs, cfg), None, tokens,
                           probs, finished, s, batch, cfg, neg)


def _select_factored(gen, copy, gate, tokens, probs, finished, s,
                     batch, cfg: FiraConfig, neg: float):
    """One selection round from the distribution factors gen (B, K,
    vocab), copy (B, K, sou+sub) and gate (B, K, 2). The fused
    distribution is [gate0*gen || gate1*copy], so each beam's top K lie in
    the union of its per-side top Ks: 2K candidates a beam, with the
    fused path's products (gate x side, then the beam score), so their
    values are bit-equal to the fused ones. Only the order among exactly
    equal candidates of different sides can differ from the fused scan's."""
    K, V = gen.shape[1], gen.shape[2]
    gv, gi = stable_top_k(gen, K)
    cv, ci = stable_top_k(copy, K)
    side = torch.cat([gv * gate[:, :, 0:1], cv * gate[:, :, 1:2]], dim=-1)
    ids = torch.cat([gi, ci + V], dim=-1)               # fused-space ids
    return _selection_tail(_candidates(side, probs, cfg), ids, tokens,
                           probs, finished, s, batch, cfg, neg)


def _run_steps(step, carry, T: int, early_exit: bool):
    """Drive ``step(carry, s) -> carry`` over positions 0..T-2; carry[2]
    is ``finished``. With ``early_exit`` stop after the first step that
    started with every beam finished and ended so (the JAX package's
    ``while_loop`` condition): that step re-sorts the finished beams by
    their sentinels, after which the carry is a fixed point. Returns
    (carry, steps run)."""
    for s in range(T - 1):
        settled = carry[2].all() if early_exit else None
        carry = step(carry, s)
        # firacheck: allow[HOST-SYNC] the early-exit predicate is read on the host once a position (one sync a step), where the JAX package's while_loop condition stays on the device; a CUDA-graph beam (ROADMAP.md A.5) must move it
        if early_exit and bool(settled & carry[2].all()):
            return carry, s + 1
    return carry, T - 1


@torch.inference_mode()
def beam_search(model: FiraModel, batch: Dict[str, torch.Tensor],
                cfg: FiraConfig, with_steps: bool = False
                ) -> Tuple[torch.Tensor, ...]:
    """Full-prefix beam (``beam_kv_cache=False``): every step re-decodes
    the whole (B*K, tar_len) prefix with :meth:`FiraModel.fused_probs`
    (or ``dist_parts``, factored) and selects at position s. The pad mask
    is the prefix's nonzero tokens with position 0 (<start>) always
    attended, not the cache's causal mask. Returns (tokens, probs), and
    the steps run with ``with_steps``."""
    K, T, V_out = cfg.beam_size, cfg.tar_len, cfg.output_vocab_size
    B = batch["diff"].shape[0]
    states, mask = model.encode(batch)
    states_k = states.repeat_interleave(K, dim=0)
    mask_k = mask.repeat_interleave(K, dim=0)
    tokens, probs, finished, neg = _init_beam(B, cfg, states.device)

    def step(carry, s):
        tokens, probs, finished = carry
        flat = tokens.reshape(B * K, T)
        tar_mask = flat != 0
        tar_mask[:, 0] = True
        if cfg.beam_factored_topk:
            gen, copy, gate = model.dist_parts(states_k, mask_k, flat,
                                               tar_mask)
            out = _select_factored(
                gen[:, s].reshape(B, K, -1), copy[:, s].reshape(B, K, -1),
                gate[:, s].reshape(B, K, 2), tokens, probs, finished, s,
                batch, cfg, neg)
        else:
            fused = model.fused_probs(states_k, mask_k, flat, tar_mask)
            out = _select(fused[:, s].reshape(B, K, V_out), tokens, probs,
                          finished, s, batch, cfg, neg)
        return out[:3]

    (tokens, probs, _), steps = _run_steps(step, (tokens, probs, finished),
                                           T, cfg.beam_early_exit)
    return (tokens, probs, steps) if with_steps else (tokens, probs)


@torch.inference_mode()
def beam_search_cached(model: FiraModel, batch: Dict[str, torch.Tensor],
                       cfg: FiraConfig, with_steps: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Returns (tokens (B, beam, tar_len) with copy ids already resolved,
    probs (B, beam)), and the steps run with ``with_steps``; the best beam
    is argmax(probs) (run_model.py:351). ``batch`` holds tensors on the
    model's device, ids as int64. The caches follow their beams through
    each step's ``src_beam`` permutation."""
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
    beam_base = torch.arange(B, device=states.device)[:, None] * K

    def step(carry, s):
        tokens, probs, finished, k_cache, v_cache = carry
        flat = tokens.reshape(B * K, T)
        args = (mask_k, flat[:, s : s + 1], s, k_cache, v_cache, cross_k,
                cross_v, src_proj, step_valid_mask(flat, s, T)[:, None, None])
        if cfg.beam_factored_topk:
            gen, copy, gate, k_cache, v_cache = model.dist_parts_step(*args)
            tokens, probs, finished, src_beam = _select_factored(
                gen[:, 0].reshape(B, K, -1), copy[:, 0].reshape(B, K, -1),
                gate[:, 0].reshape(B, K, 2), tokens, probs, finished, s,
                batch, cfg, neg)
        else:
            fused, k_cache, v_cache = model.fused_probs_step(*args)
            tokens, probs, finished, src_beam = _select(
                fused[:, 0].reshape(B, K, V_out), tokens, probs, finished,
                s, batch, cfg, neg)
        # permute cached histories to follow their beams
        idx = (src_beam + beam_base).reshape(-1)
        return tokens, probs, finished, k_cache[:, idx], v_cache[:, idx]

    (tokens, probs, *_), steps = _run_steps(
        step, (tokens, probs, finished, k_cache, torch.zeros_like(k_cache)),
        T, cfg.beam_early_exit)
    return (tokens, probs, steps) if with_steps else (tokens, probs)


def make_beam_search(model: FiraModel, cfg: FiraConfig,
                     with_steps: bool = False) -> Callable:
    """The beam the config selects as a function of the device batch:
    KV-cached (``beam_kv_cache``, the default) or full-prefix. With
    ``with_steps`` it returns (tokens, probs, steps run)."""
    impl = beam_search_cached if cfg.beam_kv_cache else beam_search
    return lambda batch: impl(model, batch, cfg, with_steps=with_steps)


def eos_biased(state_dict, delta: float = 8.0):
    """A copy of ``state_dict`` whose generation head is biased hard
    toward <eos> (``out_fc.bias[EOS_ID] += delta``), so every beam
    finishes within a few positions: the counterpart of the JAX package's
    ``eos_biased_params``, for exercising early exit and the finished-beam
    sentinels."""
    out = dict(state_dict)
    bias = out["out_fc.bias"].clone()
    bias[EOS_ID] += delta
    out["out_fc.bias"] = bias
    return out

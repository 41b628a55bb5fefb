"""FIRA model: GCN graph encoder + Transformer decoder + dual copy head
(counterpart of ``fira_tpu/model/model.py``).

The adjacency arrives as padded COO triplets and is scattered once per
batch into a dense (B, graph_len, graph_len) tensor that all GCN rounds
reuse. The decode path is the KV-cached one: ``decode_init`` computes the
per-layer cross-attention K/V and the copy head's source projection once
per batch, and ``fused_probs_step`` decodes one position against the
self-attention caches. ``forward`` is the training loss (sum, count) and
``dev_predict`` the dev gate's teacher-forced greedy ids. Every copy-head
score goes through ``ops.copy_score.copy_scores``, the CUDA kernels (K1
forward, K2 backward) on a CUDA tensor.

Dropout draws from the ``torch.Generator`` passed to ``forward`` (and from
there to ``encode``, ``Decoder.forward`` and the layers), in training mode
only; the cached decode path is always deterministic.

Submodule names follow the JAX package's parameter tree, so
``fira_tpu_torch.convert`` maps a flax checkpoint onto this module by name.

``FiraModel(cfg, dtype=...)`` computes in ``dtype`` (by default
``cfg.compute_dtype``) with f32 parameters, as the JAX ``FiraModel(cfg,
dtype=...)``: embeddings, the dense adjacency and every matmul in the
compute dtype (in bf16 the copy score, K1/K2, takes bf16 src, tgt, w and
bias), LayerNorm and the softmaxes in the stable dtype
(``layers.stable_dtype``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from fira_tpu_torch.config import FiraConfig, unsupported
from fira_tpu_torch.model.layers import (
    NEG_INF,
    Attention,
    Combination,
    FeedForward,
    GCN,
    dense,
    embedding,
    init_parameters,
    position_encoding,
    stable_dtype,
)
from fira_tpu_torch.ops import copy_score


def dense_adjacency(senders, receivers, values, graph_len: int,
                    out_dtype=None):
    """Scatter padded COO triplets into a dense (B, N, N) adjacency, in
    ``out_dtype`` (default: the values' own).

    Pad entries are (0, 0, 0.0): adding zero changes nothing, and
    graph_build dedups cells, so each cell receives exactly one value and
    the accumulating scatter is exact, also straight into bf16: the same
    bits as scattering f32 and casting."""
    B = senders.shape[0]
    dt = values.dtype if out_dtype is None else out_dtype
    adj = torch.zeros((B, graph_len, graph_len), dtype=dt,
                      device=values.device)
    b_idx = torch.arange(B, device=values.device)[:, None].expand_as(senders)
    adj.index_put_((b_idx, senders.long(), receivers.long()), values.to(dt),
                   accumulate=True)
    return adj


def _embed(table: nn.Embedding, ids, dtype):
    """Lookup in the table cast to ``dtype``, as flax's ``nn.Embed(dtype=)``
    (so a bf16 backward accumulates repeated ids in bf16, as there)."""
    return F.embedding(ids, table.weight.to(dtype))


def _embed_padded(table: nn.Embedding, ids, dtype):
    """padding_idx=0 semantics (gnn_transformer.py:32-39) applied at lookup,
    as the JAX package does: pad rows contribute exactly zero."""
    return _embed(table, ids, dtype) * (ids != 0)[..., None].to(dtype)


def _residual_dtype(cfg: FiraConfig, dtype):
    """The post-LN output type: None keeps the stable dtype."""
    return None if cfg.stable_residual else dtype


class Encoder(nn.Module):
    """gnn_transformer.py:21-62: embeddings + num_layers rounds of
    {mark-fusion Combination on the diff rows -> GCN over the whole
    [diff || sub || ast_change] node buffer}."""

    def __init__(self, cfg: FiraConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.embedding_dim
        rdt = _residual_dtype(cfg, dtype)
        self.word_embed = embedding(cfg.vocab_size, d, device)
        self.mark_embed = embedding(4, d, device)
        self.ast_change_embed = embedding(cfg.ast_change_vocab_size, d, device)
        for i in range(cfg.num_layers):
            self.add_module(f"combination_{i}", Combination(
                cfg.num_head, d, cfg.dropout_rate, device=device,
                dtype=dtype, residual_dtype=rdt))
            self.add_module(f"gcn_{i}", GCN(
                d, cfg.gcn_dropout_rate, device=device, dtype=dtype,
                residual_dtype=rdt))
        self.register_buffer(
            "pos", torch.from_numpy(position_encoding(cfg.sou_len, d)).to(
                device=device, dtype=dtype), persistent=False)

    def forward(self, diff, mark, ast_change, adj, sub_token, generator=None):
        sou, dt = self.cfg.sou_len, self.dtype
        input_em = _embed_padded(self.word_embed, diff, dt) + self.pos[None]
        mark_em = _embed_padded(self.mark_embed, mark, dt)
        graph_em = torch.cat([input_em,
                              _embed_padded(self.word_embed, sub_token, dt),
                              _embed_padded(self.ast_change_embed, ast_change,
                                            dt)], dim=1)
        for i in range(self.cfg.num_layers):
            diff_em = graph_em[:, :sou]
            diff_em = getattr(self, f"combination_{i}")(diff_em, diff_em,
                                                        mark_em, generator)
            # the buffer keeps its type: round 0's is the compute dtype, so
            # the first Combination output is cast into it (as the JAX
            # package's in-place update); after the first GCN it is the
            # post-LN type
            graph_em = torch.cat([diff_em.to(graph_em.dtype),
                                  graph_em[:, sou:]], dim=1)
            graph_em = getattr(self, f"gcn_{i}")(graph_em, adj, generator)
        return (graph_em[:, :sou],
                graph_em[:, sou : sou + self.cfg.sub_token_len])


class Decoder(nn.Module):
    """gnn_transformer.py:88-122: num_layers x {causal self-attention,
    cross-attention over the [diff || sub-token] encoder states, FFN}, all
    post-LN. ``forward`` decodes a full prefix; ``cross_kv`` +
    ``decode_step`` are the cached path with the same parameters."""

    def __init__(self, cfg: FiraConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, h = cfg.embedding_dim, cfg.num_head
        rdt = _residual_dtype(cfg, dtype)
        # no padding_idx on the decoder embedding (gnn_transformer.py:93-94)
        self.embed = embedding(cfg.vocab_size, d, device)
        for i in range(cfg.num_layers):
            for kind in ("self_attn", "cross_attn"):
                self.add_module(f"{kind}_{i}", Attention(
                    h, d, cfg.dropout_rate, device=device, dtype=dtype,
                    residual_dtype=rdt))
            self.add_module(f"ffn_{i}", FeedForward(
                d, cfg.ffn_mult, cfg.dropout_rate, device=device, dtype=dtype,
                residual_dtype=rdt))
        self.register_buffer(
            "pos", torch.from_numpy(position_encoding(cfg.tar_len, d)).to(
                device=device, dtype=dtype), persistent=False)

    def _layer(self, kind: str, i: int):
        return getattr(self, f"{kind}_{i}")

    def forward(self, tar, sou_embedding, sou_mask, tar_mask_pad,
                generator=None):
        x = _embed(self.embed, tar, self.dtype) + self.pos[None, : tar.shape[1]]
        for i in range(self.cfg.num_layers):
            x = self._layer("self_attn", i)(x, x, x, tar_mask_pad, causal=True,
                                            generator=generator)
            x = self._layer("cross_attn", i)(x, sou_embedding, sou_embedding,
                                             sou_mask, generator=generator)
            x = self._layer("ffn", i)(x, generator)
        return x

    def cross_kv(self, sou_embedding):
        """Per-layer cross-attention K/V of the encoder states, computed
        once per batch: (L, B, H, S, d_head) x 2."""
        ks, vs = zip(*(self._layer("cross_attn", i).project_kv(
            sou_embedding, sou_embedding) for i in range(self.cfg.num_layers)))
        return torch.stack(ks), torch.stack(vs)

    def decode_step(self, tok, pos_idx: int, k_cache, v_cache, cross_k,
                    cross_v, sou_mask, self_mask):
        """One decode position with cached K/V.

        tok: (B, 1) token ids at position ``pos_idx``; k_cache/v_cache:
        (L, B, H, tar_len, d_head) self-attention caches, WRITTEN IN PLACE at
        position ``pos_idx`` (the JAX package returns updated copies; in
        place saves a cache copy per layer and step); self_mask:
        (B, 1, 1, tar_len) validity of cached positions. The caches hold
        the encoder states' type; writes cast to it and reads promote to
        its stable dtype, as the JAX package's. Returns
        (x (B, 1, D), k_cache, v_cache)."""
        x = (_embed(self.embed, tok, self.dtype)
             + self.pos[pos_idx][None, None, :])
        cd = stable_dtype(k_cache.dtype)
        for i in range(self.cfg.num_layers):
            sa = self._layer("self_attn", i)
            k_new, v_new = sa.project_kv(x, x)        # (B, H, 1, d_head)
            k_cache[i, :, :, pos_idx] = k_new[:, :, 0]
            v_cache[i, :, :, pos_idx] = v_new[:, :, 0]
            x = sa.attend(x, k_cache[i].to(cd), v_cache[i].to(cd), self_mask)
            x = self._layer("cross_attn", i).attend(x, cross_k[i], cross_v[i],
                                                    sou_mask)
            x = self._layer("ffn", i)(x)
        return x, k_cache, v_cache


class CopyNet(nn.Module):
    """Model.py:7-20: Bahdanau-style pointer scores over source positions
    plus a 2-way generate/copy gate. ``score`` holds the JAX package's
    ``_ScoreHead`` (kernel (D, 1), bias (1,)) as a Linear(D, 1).

    ``score_fn`` is the scoring function, ``copy_score.copy_scores``. It is
    an attribute only so that a comparison run can swap in the plain
    version on the card; no entry point of the port changes it.

    In bf16 the scores take w and bias cast to bf16 (the JAX package's
    ``copy_head_impl="pallas"`` path), and the gate's softmax runs in the
    stable dtype."""

    def __init__(self, d_model: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.src_proj = dense(d_model, d_model, bias=False, device=device,
                              dtype=dtype)
        self.tgt_proj = dense(d_model, d_model, bias=False, device=device,
                              dtype=dtype)
        self.score = dense(d_model, 1, device=device, dtype=dtype)
        self.gate = dense(d_model, 2, device=device, dtype=dtype)
        self.score_fn = copy_score.copy_scores

    def project_src(self, source):
        """(B,S,D) source projection — constant per batch."""
        return self.src_proj(source)

    def score_gate(self, src, target):
        """Pointer scores (B,T,S) + gate (B,T,2) from a pre-projected source."""
        tgt = self.tgt_proj(target)
        dt = self.dtype
        scores = self.score_fn(src, tgt, self.score.weight.t().to(dt),
                               self.score.bias.to(dt))
        gate = self.gate(target)
        return scores, torch.softmax(gate.to(stable_dtype(gate.dtype)), dim=-1)

    def forward(self, source, target):
        return self.score_gate(self.project_src(source), target)


class FiraModel(nn.Module):
    """Model.py:24-86: encoder + decoder + fused gen/copy distribution.
    ``dtype``: the compute dtype, a torch dtype or its name (default
    ``cfg.compute_dtype``); the parameters are f32 whatever it is."""

    def __init__(self, cfg: FiraConfig, device=None, dtype=None):
        super().__init__()
        errs = unsupported(cfg)
        if errs:
            raise ValueError("config selects paths the port does not run: "
                             + "; ".join(errs))
        dtype = dtype or cfg.compute_dtype
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.cfg, self.dtype = cfg, dtype
        self.encoder = Encoder(cfg, device, dtype)
        self.decoder = Decoder(cfg, device, dtype)
        self.copy_net = CopyNet(cfg.embedding_dim, device, dtype)
        self.out_fc = dense(cfg.embedding_dim, cfg.vocab_size, device=device,
                            dtype=dtype)

    def init_parameters(self, gen: torch.Generator) -> "FiraModel":
        """Random weights from ``gen`` (PyTorch's default distributions)."""
        return init_parameters(self, gen)

    def encode(self, batch: Dict[str, torch.Tensor], generator=None):
        """Run the graph encoder once; returns ([diff||sub] states, mask)."""
        graph_len = (batch["diff"].shape[1] + batch["sub_token"].shape[1]
                     + batch["ast_change"].shape[1])
        adj = dense_adjacency(batch["senders"], batch["receivers"],
                              batch["values"], graph_len,
                              out_dtype=self.dtype)
        diff, sub_token = batch["diff"].long(), batch["sub_token"].long()
        sou_emb, sub_emb = self.encoder(diff, batch["diff_mark"].long(),
                                        batch["ast_change"].long(), adj,
                                        sub_token, generator)
        states = torch.cat([sou_emb, sub_emb], dim=1)
        mask = torch.cat([diff != 0, sub_token != 0], dim=1)
        return states, mask

    def _heads(self, mask, src_proj, tar_emb):
        """Generation softmax, masked copy softmax and gate, all three in
        the stable dtype."""
        sd = stable_dtype(self.dtype)
        gen = torch.softmax(self.out_fc(tar_emb).to(sd), dim=-1)
        scores, gate = self.copy_net.score_gate(src_proj, tar_emb)
        copy = torch.softmax(
            scores.masked_fill(~mask[:, None, :], NEG_INF).to(sd), dim=-1)
        return gen, copy, gate

    @staticmethod
    def _fuse(gen, copy, gate):
        return torch.cat([gate[:, :, 0:1] * gen, gate[:, :, 1:2] * copy],
                         dim=-1)

    def _dist_parts(self, states, mask, tar, tar_mask_pad, generator=None):
        """Decoder over a full prefix, then the generation softmax, masked
        copy softmax and gate, unfused."""
        tar_emb = self.decoder(tar.long(), states, mask, tar_mask_pad,
                               generator)
        return self._heads(mask, self.copy_net.project_src(states), tar_emb)

    def fused_probs(self, states, mask, tar, tar_mask_pad):
        """Decoder + copy fusion over a full prefix -> probability-space
        distribution over vocab_size + sou_len + sub_token_len
        (Model.py:52-64)."""
        return self._fuse(*self._dist_parts(states, mask, tar, tar_mask_pad))

    def forward(self, batch: Dict[str, torch.Tensor], generator=None):
        """Training/dev loss: (nll_sum, token_count), as the reference
        (Model.py:66-84); callers normalise. The label is ``msg_tar``
        shifted left with a zero column; each position's label probability
        is gathered from the unfused factors (gate x gen or gate x copy),
        clamped to [1e-10, 1] and logged; label 0 is masked out. Dropout
        draws from ``generator`` in training mode."""
        states, mask = self.encode(batch, generator)
        tar = batch["msg"].long()
        gen, copy, gate = self._dist_parts(states, mask, tar, tar != 0,
                                           generator)
        msg_tar = batch["msg_tar"].long()
        label = torch.cat([msg_tar[:, 1:], torch.zeros_like(msg_tar[:, :1])],
                          dim=1)
        label_mask = label != 0
        V = self.cfg.vocab_size
        is_gen = label < V
        gi = torch.where(is_gen, label, 0)[..., None]
        ci = (label - V).clamp(0, copy.shape[-1] - 1)[..., None]
        pg = gen.gather(-1, gi)[..., 0] * gate[..., 0]
        pc = copy.gather(-1, ci)[..., 0] * gate[..., 1]
        nll = -torch.log(torch.where(is_gen, pg, pc).clamp(1e-10, 1.0))
        nll = torch.where(label_mask, nll, torch.zeros_like(nll))
        return nll.sum(), label_mask.sum()

    @torch.no_grad()
    def dev_predict(self, batch: Dict[str, torch.Tensor]):
        """Teacher-forced greedy ids for all positions (Model.py:86): the
        argmax of the fused distribution, with dropout off whatever the
        module's mode (restored after)."""
        was_training = self.training
        self.eval()
        try:
            states, mask = self.encode(batch)
            tar = batch["msg"].long()
            return self.fused_probs(states, mask, tar, tar != 0).argmax(-1)
        finally:
            self.train(was_training)

    def decode_init(self, states):
        """Everything constant across decode steps, once per batch:
        per-layer cross-attention K/V and the copy head's source
        projection."""
        cross_k, cross_v = self.decoder.cross_kv(states)
        return cross_k, cross_v, self.copy_net.project_src(states)

    def fused_probs_step(self, mask, tok, pos_idx: int, k_cache, v_cache,
                         cross_k, cross_v, src_proj, self_mask):
        """One-position fused distribution with KV caching: same math as
        slicing position ``pos_idx`` out of :meth:`fused_probs`. Returns
        (fused (B, 1, V_out), k_cache, v_cache)."""
        tar_emb, k_cache, v_cache = self.decoder.decode_step(
            tok, pos_idx, k_cache, v_cache, cross_k, cross_v, mask, self_mask)
        return (self._fuse(*self._heads(mask, src_proj, tar_emb)),
                k_cache, v_cache)

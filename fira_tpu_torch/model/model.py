"""FIRA model: GCN graph encoder + Transformer decoder + dual copy head
(counterpart of ``fira_tpu/model/model.py``).

The adjacency arrives as padded COO triplets. Under
``adjacency_impl="dense"`` it is scattered once per batch into a dense
(B, graph_len, graph_len) tensor that all GCN rounds reuse (as one
linearized 1-D scatter under ``flat_scatter``); under ``"segment"`` each
round applies A.x straight from the triplets (``coo_matvec``).
``typed_edges`` scales each edge by a learned gain of its family
(``edge_gain``) first. ``encoder_buffer="split"`` keeps the [diff] and
[sub||ast] node rows as two tensors. The full-prefix decode is
``fused_probs`` / ``dist_parts``; the KV-cached one is ``decode_init``
(per-layer cross-attention K/V and the copy head's source projection,
once per batch) and ``fused_probs_step`` / ``dist_parts_step`` (one
position against the self-attention caches). ``dist_parts*`` return the
unfused (gen, copy, gate) that the factored beam selects from.
``forward`` is the training loss (sum, count) and ``dev_predict`` the dev
gate's teacher-forced greedy ids. Every copy-head score goes through
``ops.copy_score.copy_scores``, the CUDA kernels (K1 forward, K2
backward) on a CUDA tensor.

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

``FiraModel(cfg, mesh=...)`` is one rank's part of a training mesh
(``parallel/mesh.py``, a bound ``Mesh``): it holds this rank's rows of
every batch, and under ``n_model`` > 1 the tensor-parallel shards of the
layers (``model/layers.py``). In the copy head ``src_proj`` and
``tgt_proj`` are column-parallel, so K1 and K2 run on this rank's
``d / n_model`` features with its slice of ``w``; the partial scores are
all-reduced over the model axis and the bias added once, and ``w``'s
gradient is the all-gather of the slices' (``mesh.scatter_to``). The
vocabulary head ``out_fc`` is row-parallel over d (its all-reduce carries
the whole (B, T, vocab) logits, as the JAX layout does). With
``cfg.seq_shards`` > 1 the decoder's cross-attention runs as ring
attention (``parallel/ring.py``) over the mesh's ``seq`` groups; a
``seq_shards`` that does not divide the ranks raises the JAX model's
ValueError.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from fira_tpu_torch.config import FiraConfig, unsupported
from fira_tpu_torch.data.graph_build import N_EDGE_KINDS
from fira_tpu_torch.model.layers import (
    NEG_INF,
    Attention,
    Combination,
    FeedForward,
    GCN,
    append_block_kv,
    dense,
    embedding,
    gather_block_kv,
    init_parameters,
    position_encoding,
    stable_dtype,
)
from fira_tpu_torch.ops import copy_score


def dense_adjacency(senders, receivers, values, graph_len: int,
                    out_dtype=None, flat: bool = False):
    """Scatter padded COO triplets into a dense (B, N, N) adjacency, in
    ``out_dtype`` (default: the values' own).

    Pad entries are (0, 0, 0.0): adding zero changes nothing, and
    graph_build dedups cells, so each cell receives exactly one value and
    the accumulating scatter is exact, also straight into bf16: the same
    bits as scattering f32 and casting. ``flat``: one 1-D scatter over
    the linearized cell index (b*N + s)*N + r, bit-identical (the same
    cells get the same single values)."""
    B = senders.shape[0]
    dt = values.dtype if out_dtype is None else out_dtype
    dev = values.device
    b_idx = torch.arange(B, device=dev)[:, None]
    if flat:
        idx = ((b_idx * graph_len + senders.long()) * graph_len
               + receivers.long())
        adj = torch.zeros(B * graph_len * graph_len, dtype=dt, device=dev)
        adj.index_put_((idx.reshape(-1),), values.to(dt).reshape(-1),
                       accumulate=True)
        return adj.reshape(B, graph_len, graph_len)
    adj = torch.zeros((B, graph_len, graph_len), dtype=dt, device=dev)
    adj.index_put_((b_idx.expand_as(senders), senders.long(),
                    receivers.long()), values.to(dt), accumulate=True)
    return adj


def coo_matvec(senders, receivers, values, x):
    """A.x straight from the COO triplets (dense[b, senders, receivers] =
    values): gather each edge's source row x[b, receivers], weight it, and
    scatter-add it into row senders. O(edges) instead of O(N^2); pad edges
    (0, 0, 0.0) add zero. Accumulates in ``stable_dtype(x.dtype)`` (f32
    under bf16, as the dense bmm accumulates) and returns x's type; the
    sums differ from the dense bmm by reassociation. The scatter-add is
    ``index_put_(accumulate=True)``, whose autograd keeps only the index:
    ``index_add_`` also keeps the (B*E, d) messages, one such tensor a GCN
    round (1.07 GB at fira-full)."""
    B, N, d = x.shape
    acc = stable_dtype(x.dtype)
    rows = torch.arange(B, device=x.device)[:, None] * N
    msgs = (x.to(acc).reshape(B * N, d).index_select(
                0, (rows + receivers.long()).reshape(-1))
            * values.reshape(-1, 1).to(acc))
    out = torch.zeros((B * N, d), dtype=acc, device=x.device).index_put_(
        ((rows + senders.long()).reshape(-1),), msgs, accumulate=True)
    return out.reshape(B, N, d).to(x.dtype)


ONE_HOT_ROWS = 128   # a table of at most this many rows: a one-hot product


def _embed(table: nn.Embedding, ids, dtype):
    """Lookup in the table cast to ``dtype``, as flax's ``nn.Embed(dtype=)``.
    A table sharded on the feature dim (``tp_group``) gathers the lookup.

    A table of at most ``ONE_HOT_ROWS`` rows (the 4 marks, the 71 AST
    tokens) is looked up as the product of the ids' one-hot rows with it:
    each of its rows repeats thousands of times in a batch, and on the
    H100 the embedding kernel's backward gave these tables gradients whose
    last bits changed from run to run, while an index's backward (the
    sorted ``index_put_``) adds a row's repeats one after another and
    doubled the training step (``PERF.md``). The product's forward is
    exact (one nonzero term a sum); its backward is a matrix product."""
    weight = table.weight.to(dtype)
    if weight.shape[0] <= ONE_HOT_ROWS:
        rows = torch.arange(weight.shape[0], device=ids.device)
        out = (ids[..., None] == rows).to(dtype) @ weight
    else:
        out = F.embedding(ids, weight)
    group = getattr(table, "tp_group", None)
    if group is None:
        return out
    from fira_tpu_torch.parallel.mesh import gather_from

    return gather_from(out, group, -1)


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
    [diff || sub || ast_change] node buffer}. ``adj``: a dense (B, N, N)
    adjacency or a callable applying A.x (``coo_matvec``). Under
    ``encoder_buffer="split"`` the buffer is two tensors, [diff] and
    [sub || ast_change], and the dense adjacency two column slabs, made
    once a forward and reused by every round."""

    def __init__(self, cfg: FiraConfig, device=None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.embedding_dim
        rdt = _residual_dtype(cfg, dtype)
        self.word_embed = embedding(cfg.vocab_size, d, device, mesh)
        self.mark_embed = embedding(4, d, device, mesh)
        self.ast_change_embed = embedding(cfg.ast_change_vocab_size, d,
                                          device, mesh)
        for i in range(cfg.num_layers):
            self.add_module(f"combination_{i}", Combination(
                cfg.num_head, d, cfg.dropout_rate, device=device,
                dtype=dtype, residual_dtype=rdt, mesh=mesh))
            self.add_module(f"gcn_{i}", GCN(
                d, cfg.gcn_dropout_rate, device=device, dtype=dtype,
                residual_dtype=rdt, mesh=mesh))
        self.register_buffer(
            "pos", torch.from_numpy(position_encoding(cfg.sou_len, d)).to(
                device=device, dtype=dtype), persistent=False)

    def forward(self, diff, mark, ast_change, adj, sub_token, generator=None):
        sou, dt = self.cfg.sou_len, self.dtype
        input_em = _embed_padded(self.word_embed, diff, dt) + self.pos[None]
        mark_em = _embed_padded(self.mark_embed, mark, dt)
        rest = torch.cat([_embed_padded(self.word_embed, sub_token, dt),
                          _embed_padded(self.ast_change_embed, ast_change,
                                        dt)], dim=1)
        split = self.cfg.encoder_buffer == "split"
        if split:   # config.unsupported refuses it with segment
            graph_em = (input_em, rest)
            adj = (adj[:, :, :sou].contiguous(), adj[:, :, sou:].contiguous())
        else:
            graph_em = torch.cat([input_em, rest], dim=1)
        for i in range(self.cfg.num_layers):
            diff_em = graph_em[0] if split else graph_em[:, :sou]
            diff_em = getattr(self, f"combination_{i}")(diff_em, diff_em,
                                                        mark_em, generator)
            # the buffer keeps its type: round 0's is the compute dtype, so
            # the first Combination output is cast into it (as the JAX
            # package's in-place update); after the first GCN it is the
            # post-LN type
            if split:
                graph_em = (diff_em.to(graph_em[1].dtype), graph_em[1])
            else:
                graph_em = torch.cat([diff_em.to(graph_em.dtype),
                                      graph_em[:, sou:]], dim=1)
            graph_em = getattr(self, f"gcn_{i}")(graph_em, adj, generator)
        if split:
            return graph_em[0], graph_em[1][:, : self.cfg.sub_token_len]
        return (graph_em[:, :sou],
                graph_em[:, sou : sou + self.cfg.sub_token_len])


class Decoder(nn.Module):
    """gnn_transformer.py:88-122: num_layers x {causal self-attention,
    cross-attention over the [diff || sub-token] encoder states, FFN}, all
    post-LN. ``forward`` decodes a full prefix; ``cross_kv`` +
    ``decode_step`` are the cached path with the same parameters."""

    def __init__(self, cfg: FiraConfig, device=None,
                 dtype: torch.dtype = torch.float32, mesh=None, ring=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, h = cfg.embedding_dim, cfg.num_head
        rdt = _residual_dtype(cfg, dtype)
        # no padding_idx on the decoder embedding (gnn_transformer.py:93-94)
        self.embed = embedding(cfg.vocab_size, d, device, mesh)
        for i in range(cfg.num_layers):
            for kind in ("self_attn", "cross_attn"):
                # only cross-attention rides the ring: its key axis
                # ([diff||sub]) is the long one, and self-attention is
                # causal
                self.add_module(f"{kind}_{i}", Attention(
                    h, d, cfg.dropout_rate, device=device, dtype=dtype,
                    residual_dtype=rdt, mesh=mesh,
                    ring=ring if kind == "cross_attn" else None))
            self.add_module(f"ffn_{i}", FeedForward(
                d, cfg.ffn_mult, cfg.dropout_rate, device=device, dtype=dtype,
                residual_dtype=rdt, mesh=mesh))
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
            x = self._layers_after_self(i, x, sa, k_cache[i].to(cd),
                                        v_cache[i].to(cd), self_mask,
                                        cross_k, cross_v, sou_mask)
        return x, k_cache, v_cache

    def embed_at(self, tok, pos_idx):
        """The decoder's input at per-row positions: token embedding plus
        the position row. tok (B, n) with pos_idx (B, n), or tok (B, 1)
        with a (B,) vector (the engine's step)."""
        table = self.pos[pos_idx]
        if table.dim() == 2:             # (B,) positions -> (B, 1, D)
            table = table[:, None, :]
        return _embed(self.embed, tok, self.dtype) + table

    def _layers_after_self(self, i, x, sa, k, v, self_mask, cross_k,
                           cross_v, sou_mask):
        """Layer i past its K/V write: self-attention over the cache view,
        cross-attention, FFN."""
        x = sa.attend(x, k, v, self_mask)
        x = self._layer("cross_attn", i).attend(x, cross_k[i], cross_v[i],
                                                sou_mask)
        return self._layer("ffn", i)(x)

    def decode_step_multi(self, tok, pos_idx, k_cache, v_cache, cross_k,
                          cross_v, sou_mask, self_mask):
        """:meth:`decode_step` at one position PER ROW: ``pos_idx`` is a
        (B,) vector and row b writes its K/V at ``pos_idx[b]`` (the slot
        engine holds samples at mixed depths). Per row the same math as
        :meth:`decode_step` at that row's position. Writes the caches in
        place; returns (x, k_cache, v_cache)."""
        B = tok.shape[0]
        b_idx = torch.arange(B, device=tok.device)
        x = self.embed_at(tok, pos_idx)
        cd = stable_dtype(k_cache.dtype)
        for i in range(self.cfg.num_layers):
            sa = self._layer("self_attn", i)
            k_new, v_new = sa.project_kv(x, x)        # (B, H, 1, d_head)
            k_cache[i, b_idx, :, pos_idx] = k_new[:, :, 0].to(k_cache.dtype)
            v_cache[i, b_idx, :, pos_idx] = v_new[:, :, 0].to(v_cache.dtype)
            x = self._layers_after_self(i, x, sa, k_cache[i].to(cd),
                                        v_cache[i].to(cd), self_mask,
                                        cross_k, cross_v, sou_mask)
        return x, k_cache, v_cache

    def decode_step_paged(self, tok, pos_idx, k_pool, v_pool, block_tab,
                          cross_k, cross_v, sou_mask, self_mask):
        """:meth:`decode_step_multi` with the self-attention cache in a
        pool of KV blocks behind a block table (the engine's paged arena):
        k_pool/v_pool (L, P + 1, K, H, block, d_head), the last block the
        scratch block that sentinel ids address; ``block_tab`` (S, W)
        maps slot s's positions [w*block, (w+1)*block) to a pool block
        (sentinel P: unmapped). Each row appends at its own position in
        its slot's tail block, then attends over the gathered view, which
        equals the whole-sequence cache at every written position.

        tok: (S*K, 1); pos_idx: (S*K,) (the rows of a slot share theirs);
        W*block must equal the attended width ``self_mask.shape[-1]``."""
        _L, _P1, K, _H, BS, _dh = k_pool.shape
        B = tok.shape[0]
        S, W = block_tab.shape
        if W * BS != self_mask.shape[-1] or B != S * K:
            raise ValueError(
                f"paged cache geometry mismatch: table {W} x block {BS} "
                f"must tile the {self_mask.shape[-1]}-position budget and "
                f"pool beam lanes {K} x {S} slots must equal the {B} rows")
        rows = torch.arange(B, device=tok.device)
        blk = block_tab[rows // K, pos_idx // BS]    # (B,) current tail block
        krow, off = rows % K, pos_idx % BS
        x = self.embed_at(tok, pos_idx)
        for i in range(self.cfg.num_layers):
            sa = self._layer("self_attn", i)
            k_new, v_new = sa.project_kv(x, x)        # (B, H, 1, d_head)
            append_block_kv(k_pool, i, blk, krow, off, k_new[:, :, 0])
            append_block_kv(v_pool, i, blk, krow, off, v_new[:, :, 0])
            x = self._layers_after_self(
                i, x, sa, gather_block_kv(k_pool[i], block_tab),
                gather_block_kv(v_pool[i], block_tab), self_mask, cross_k,
                cross_v, sou_mask)
        return x, k_pool, v_pool


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
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(bias=False, device=device, dtype=dtype, mesh=mesh,
                  parallel="column")
        self.src_proj = dense(d_model, d_model, **kw)
        self.tgt_proj = dense(d_model, d_model, **kw)
        self.score = dense(d_model, 1, device=device, dtype=dtype)
        self.gate = dense(d_model, 2, device=device, dtype=dtype)
        self.score_fn = copy_score.copy_scores
        # the model axis' group when src/tgt hold feature shards
        self.tp_group = self.src_proj.tp_group

    def project_src(self, source):
        """(B,S,D) source projection — constant per batch."""
        return self.src_proj(source)

    def score_gate(self, src, target):
        """Pointer scores (B,T,S) + gate (B,T,2) from a pre-projected source."""
        tgt = self.tgt_proj(target)
        dt = self.dtype
        w, bias = self.score.weight.t().to(dt), self.score.bias.to(dt)
        if self.tp_group is None:
            scores = self.score_fn(src, tgt, w, bias)
        else:
            from fira_tpu_torch.parallel import mesh as pmesh

            g = self.tp_group
            part = self.score_fn(src, tgt, pmesh.scatter_to(w, g, 0),
                                 torch.zeros_like(bias))
            scores = pmesh.reduce_from(part, g) + bias
        gate = self.gate(target)
        return scores, torch.softmax(gate.to(stable_dtype(gate.dtype)), dim=-1)

    def forward(self, source, target):
        return self.score_gate(self.project_src(source), target)


class FiraModel(nn.Module):
    """Model.py:24-86: encoder + decoder + fused gen/copy distribution.
    ``dtype``: the compute dtype, a torch dtype or its name (default
    ``cfg.compute_dtype``); the parameters are f32 whatever it is. Under
    ``cfg.typed_edges`` it also holds ``edge_gain``, one f32 gain per
    edge family (ones at init: the adjacency is then the untyped one)."""

    def __init__(self, cfg: FiraConfig, device=None, dtype=None, mesh=None):
        super().__init__()
        errs = unsupported(cfg)
        if errs:
            raise ValueError("config selects paths the port does not run: "
                             + "; ".join(errs))
        ring = None
        if cfg.seq_shards > 1:
            from fira_tpu_torch.parallel.mesh import seq_shards_errors

            errs = seq_shards_errors(cfg, mesh.world if mesh else 1,
                                     mesh.n_model if mesh else 1)
            if errs:
                raise ValueError("; ".join(errs))
            if mesh.seq_shards != cfg.seq_shards:
                raise ValueError(f"seq_shards={cfg.seq_shards}: the mesh was "
                                 f"bound for seq_shards={mesh.seq_shards}")
            ring = mesh
        dtype = dtype or cfg.compute_dtype
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self.cfg, self.dtype = cfg, dtype
        self.encoder = Encoder(cfg, device, dtype, mesh)
        self.decoder = Decoder(cfg, device, dtype, mesh, ring)
        self.copy_net = CopyNet(cfg.embedding_dim, device, dtype, mesh)
        self.out_fc = dense(cfg.embedding_dim, cfg.vocab_size, device=device,
                            dtype=dtype, mesh=mesh, parallel="row",
                            scatter_input=True)
        if cfg.typed_edges:
            self.edge_gain = nn.Parameter(torch.ones(
                N_EDGE_KINDS, dtype=torch.float32, device=device))

    def init_parameters(self, gen: torch.Generator) -> "FiraModel":
        """Random weights from ``gen`` (PyTorch's default distributions);
        ``edge_gain`` ones."""
        init_parameters(self, gen)
        if self.cfg.typed_edges:
            with torch.no_grad():
                self.edge_gain.fill_(1.0)
        return self

    def encode(self, batch: Dict[str, torch.Tensor], generator=None):
        """Run the graph encoder once; returns ([diff||sub] states, mask)."""
        cfg = self.cfg
        graph_len = (batch["diff"].shape[1] + batch["sub_token"].shape[1]
                     + batch["ast_change"].shape[1])
        values = batch["values"]
        if cfg.typed_edges:
            values = values * self.edge_gain.to(values.dtype)[
                batch["edge_kinds"].long()]
        if cfg.adjacency_impl == "segment":
            adj = functools.partial(coo_matvec, batch["senders"],
                                    batch["receivers"], values)
        else:
            adj = dense_adjacency(batch["senders"], batch["receivers"],
                                  values, graph_len, out_dtype=self.dtype,
                                  flat=cfg.flat_scatter)
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

    def dist_parts(self, states, mask, tar, tar_mask_pad, generator=None):
        """Decoder over a full prefix, then the generation softmax, masked
        copy softmax and gate, unfused: the training loss gathers its
        labels from them, and the factored full-prefix beam takes its
        per-side top-k from them."""
        tar_emb = self.decoder(tar.long(), states, mask, tar_mask_pad,
                               generator)
        return self._heads(mask, self.copy_net.project_src(states), tar_emb)

    def fused_probs(self, states, mask, tar, tar_mask_pad):
        """Decoder + copy fusion over a full prefix -> probability-space
        distribution over vocab_size + sou_len + sub_token_len
        (Model.py:52-64)."""
        return self._fuse(*self.dist_parts(states, mask, tar, tar_mask_pad))

    def forward(self, batch: Dict[str, torch.Tensor], generator=None):
        """Training/dev loss: (nll_sum, token_count), as the reference
        (Model.py:66-84); callers normalise. The label is ``msg_tar``
        shifted left with a zero column; each position's label probability
        is gathered from the unfused factors (gate x gen or gate x copy),
        clamped to [1e-10, 1] and logged; label 0 is masked out. Dropout
        draws from ``generator`` in training mode."""
        states, mask = self.encode(batch, generator)
        tar = batch["msg"].long()
        gen, copy, gate = self.dist_parts(states, mask, tar, tar != 0,
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

    def copy_draft_scores(self, mask, src_proj, tok, pos_idx):
        """The speculative ``copy`` drafter's head (decode/spec.py): the
        pointer scores alone against the raw target-embedding proxy
        ``Decoder.embed_at(tok, pos_idx)``; no decoder layer runs and no
        cache is touched, so a k-token draft costs k embedding rows and k
        copy scores (K1 at (B, 1, S, D)). The scores get the step's
        source-validity mask (-1e9). Draft quality moves only the
        acceptance rate, never the output (the verify is the exact step).
        tok: (B, 1); pos_idx: (B,). Returns (B, 1, S)."""
        x = self.decoder.embed_at(tok, pos_idx)
        scores, _gate = self.copy_net.score_gate(src_proj, x)
        return scores.masked_fill(~mask[:, None, :], NEG_INF)

    def dist_parts_step(self, mask, tok, pos_idx: int, k_cache, v_cache,
                        cross_k, cross_v, src_proj, self_mask):
        """One-position distribution factors with KV caching: the (gen,
        copy, gate) of :meth:`fused_probs_step` unfused, for the factored
        beam. Returns (gen, copy, gate, k_cache, v_cache)."""
        tar_emb, k_cache, v_cache = self.decoder.decode_step(
            tok, pos_idx, k_cache, v_cache, cross_k, cross_v, mask, self_mask)
        return (*self._heads(mask, src_proj, tar_emb), k_cache, v_cache)

    def fused_probs_step(self, mask, tok, pos_idx: int, k_cache, v_cache,
                         cross_k, cross_v, src_proj, self_mask):
        """One-position fused distribution with KV caching: same math as
        slicing position ``pos_idx`` out of :meth:`fused_probs`. Returns
        (fused (B, 1, V_out), k_cache, v_cache)."""
        gen, copy, gate, k_cache, v_cache = self.dist_parts_step(
            mask, tok, pos_idx, k_cache, v_cache, cross_k, cross_v, src_proj,
            self_mask)
        return self._fuse(gen, copy, gate), k_cache, v_cache

    def dist_parts_step_multi(self, mask, tok, pos_idx, k_cache, v_cache,
                              cross_k, cross_v, src_proj, self_mask):
        """:meth:`dist_parts_step` at a (B,) vector of positions, one a
        row (the slot engine's step): ``Decoder.decode_step_multi`` and
        the same heads. Returns (gen, copy, gate, k_cache, v_cache)."""
        tar_emb, k_cache, v_cache = self.decoder.decode_step_multi(
            tok, pos_idx, k_cache, v_cache, cross_k, cross_v, mask, self_mask)
        return (*self._heads(mask, src_proj, tar_emb), k_cache, v_cache)

    def fused_probs_step_multi(self, mask, tok, pos_idx, k_cache, v_cache,
                               cross_k, cross_v, src_proj, self_mask):
        """:meth:`fused_probs_step` at a (B,) vector of positions.
        Returns (fused (B, 1, V_out), k_cache, v_cache)."""
        gen, copy, gate, k_cache, v_cache = self.dist_parts_step_multi(
            mask, tok, pos_idx, k_cache, v_cache, cross_k, cross_v, src_proj,
            self_mask)
        return self._fuse(gen, copy, gate), k_cache, v_cache

    def dist_parts_step_paged(self, mask, tok, pos_idx, k_pool, v_pool,
                              block_tab, cross_k, cross_v, src_proj,
                              self_mask):
        """:meth:`dist_parts_step_multi` over the paged arena
        (``Decoder.decode_step_paged``); the heads are the shared
        :meth:`_heads`, so per row the factors equal the unpaged step's.
        Returns (gen, copy, gate, k_pool, v_pool)."""
        tar_emb, k_pool, v_pool = self.decoder.decode_step_paged(
            tok, pos_idx, k_pool, v_pool, block_tab, cross_k, cross_v, mask,
            self_mask)
        return (*self._heads(mask, src_proj, tar_emb), k_pool, v_pool)

    def fused_probs_step_paged(self, mask, tok, pos_idx, k_pool, v_pool,
                               block_tab, cross_k, cross_v, src_proj,
                               self_mask):
        """:meth:`fused_probs_step_multi` over the paged arena. Returns
        (fused (B, 1, V_out), k_pool, v_pool)."""
        gen, copy, gate, k_pool, v_pool = self.dist_parts_step_paged(
            mask, tok, pos_idx, k_pool, v_pool, block_tab, cross_k, cross_v,
            src_proj, self_mask)
        return self._fuse(gen, copy, gate), k_pool, v_pool

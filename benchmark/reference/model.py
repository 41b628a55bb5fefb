"""Plain PyTorch FIRA, written from the paper's model (reference
``gnn_transformer.py``, ``combination_layer.py`` and ``Model.py``),
independent of the port: a function of a dict of weights (named as the port's parameters, which the
benchmark makes and hands to both sides) and a batch from
``reference.batch``.

- Encoder: word, mark and AST embeddings (pad rows zero; sin/cos
  positions interleaved on the diff), then L rounds of the combination
  gate on the diff rows and one GCN round over all 650 nodes, post-LN.
- Decoder: L layers of causal self-attention, cross-attention over the
  [diff || sub-token] states and a ReLU FFN, post-LN, -1e9 masks.
- Heads: the generation softmax, the Bahdanau copy scores
  w . tanh(src + tgt) + b over the 370 source positions (softmax), and
  the 2-way gate; the loss gathers each label's probability from its
  side, clamps it to [1e-10, 1] and sums -log over real labels.
- Dropout, in training, draws ``torch.rand`` at each output's shape from
  the generator the benchmark seeds for both sides, in the model's order
  (per encoder round: the gate, the combination's output, the GCN; per
  decoder layer: self-attention, cross-attention, FFN), keeping an
  element where the draw is >= p and scaling it by 1/(1-p).

Imports torch and numpy only; computes in float32 (the caller sets
TF32).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e9


def positions(n: int, d: int, device) -> torch.Tensor:
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(d // 2)[None, :].astype(np.float64)
    ang = i / np.power(10000.0, 2.0 * j / d)
    pos = np.zeros((n, d), dtype=np.float32)
    pos[:, 0::2], pos[:, 1::2] = np.sin(ang), np.cos(ang)
    return torch.from_numpy(pos).to(device)


class Ref:
    """The reference over weights ``w`` (name -> f32 tensor) and a config
    dict ``cfg`` (FiraConfig field names). ``gen``: the dropout generator
    (None: no dropout)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: Dict,
                 gen: Optional[torch.Generator] = None):
        self.w, self.cfg, self.gen = w, cfg, gen
        self.d, self.h, self.L = (cfg["embedding_dim"], cfg["num_head"],
                                  cfg["num_layers"])
        self.V = cfg["vocab_size"]

    # --- pieces -----------------------------------------------------------

    def lin(self, x, name, bias=True):
        y = x @ self.w[name + ".weight"].t()
        return y + self.w[name + ".bias"] if bias else y

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], 1e-5)

    def drop(self, x, p):
        if self.gen is None or p == 0.0:
            return x
        r = torch.rand(x.shape, generator=self.gen, device=x.device)
        return torch.where(r >= p, x / (1.0 - p), torch.zeros_like(x))

    def attn(self, name, q_in, kv_in, mask, causal=False):
        B, Tq, d = q_in.shape
        h, dh = self.h, self.d // self.h

        def heads(x):
            return x.reshape(B, x.shape[1], h, dh).transpose(1, 2)

        q = heads(self.lin(q_in, name + ".q_proj"))
        k = heads(self.lin(kv_in, name + ".k_proj"))
        v = heads(self.lin(kv_in, name + ".v_proj"))
        s = q @ k.transpose(-1, -2) / math.sqrt(dh)
        s = s.masked_fill(mask[:, None, None, :] == 0, NEG)
        if causal:
            tri = torch.ones(Tq, Tq, dtype=torch.bool,
                             device=q_in.device).tril()
            s = s.masked_fill(~tri, NEG)
        o = (s.softmax(-1) @ v).transpose(1, 2).reshape(B, Tq, d)
        o = self.drop(self.lin(o, name + ".out_proj"),
                      self.cfg["dropout_rate"])
        return self.ln(o + q_in, name + ".norm")

    # --- model ------------------------------------------------------------

    def encode(self, b):
        c, w, d = self.cfg, self.w, self.d
        sou = c["sou_len"]

        def emb(table, ids):
            return w[table][ids] * (ids != 0)[..., None]

        x = emb("encoder.word_embed.weight", b["diff"]) + positions(
            sou, d, b["diff"].device)
        mark = emb("encoder.mark_embed.weight", b["mark"])
        g = torch.cat([x, emb("encoder.word_embed.weight", b["sub_token"]),
                       emb("encoder.ast_change_embed.weight",
                           b["ast_change"])], 1)
        p = c["dropout_rate"]
        for i in range(self.L):
            n = f"encoder.combination_{i}"
            de = g[:, :sou]
            q, k = self.lin(de, n + ".q_proj"), self.lin(de, n + ".k_proj")
            v = self.lin(mark, n + ".v_proj")
            sc = 1.0 / math.sqrt(d // self.h)
            t = q * k * sc - q * v * sc
            gate = self.drop(torch.sigmoid(t) * k + torch.sigmoid(-t) * v, p)
            o = self.drop(self.lin(gate, n + ".out_proj"), p)
            g = torch.cat([self.ln(o + de, n + ".norm"), g[:, sou:]], 1)
            n = f"encoder.gcn_{i}"
            y = b["adj"] @ self.lin(g, n + ".fc1")
            y = self.drop(self.lin(y, n + ".fc2"), c["gcn_dropout_rate"])
            g = self.ln(y + g, n + ".norm")
        states = g[:, : sou + c["sub_token_len"]]
        mask = torch.cat([b["diff"] != 0, b["sub_token"] != 0], 1)
        return states, mask

    def decode(self, tar, tar_mask, states, mask):
        """Decoder over a full prefix ``tar`` (B, T)."""
        T = tar.shape[1]
        x = self.w["decoder.embed.weight"][tar] + positions(
            self.cfg["tar_len"], self.d, tar.device)[:T]
        for i in range(self.L):
            x = self.attn(f"decoder.self_attn_{i}", x, x, tar_mask, True)
            x = self.attn(f"decoder.cross_attn_{i}", x, states, mask)
            n = f"decoder.ffn_{i}"
            f = self.lin(torch.relu(self.lin(x, n + ".fc1")), n + ".fc2")
            x = self.ln(self.drop(f, self.cfg["dropout_rate"]) + x,
                        n + ".norm")
        return x

    def heads(self, x, states, mask):
        """(gen, copy, gate) at every position of decoder output ``x``."""
        w = self.w
        gen = self.lin(x, "out_fc").softmax(-1)
        src = self.lin(states, "copy_net.src_proj", bias=False)
        tgt = self.lin(x, "copy_net.tgt_proj", bias=False)
        score = (torch.tanh(src[:, None] + tgt[:, :, None])
                 @ w["copy_net.score.weight"][0]) + w["copy_net.score.bias"]
        copy = score.masked_fill(~mask[:, None, :], NEG).softmax(-1)
        gate = self.lin(x, "copy_net.gate").softmax(-1)
        return gen, copy, gate

    def loss(self, b, rows=None):
        """Mean -log p of the real labels (sum over tokens / their count).
        ``rows``: a subset of batch rows (the half-batch fault)."""
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        states, mask = self.encode(b)
        tar = b["msg"]
        x = self.decode(tar, tar != 0, states, mask)
        gen, copy, gate = self.heads(x, states, mask)
        lab = torch.cat([b["msg_tar"][:, 1:],
                         torch.zeros_like(b["msg_tar"][:, :1])], 1)
        is_gen = lab < self.V
        pg = gen.gather(-1, torch.where(is_gen, lab, 0)[..., None])[..., 0]
        pc = copy.gather(-1, (lab - self.V).clamp(
            0, copy.shape[-1] - 1)[..., None])[..., 0]
        p = torch.where(is_gen, pg * gate[..., 0], pc * gate[..., 1])
        nll = -torch.log(p.clamp(1e-10, 1.0))
        real = lab != 0
        return torch.where(real, nll, 0.0).sum() / real.sum().clamp(min=1)

"""Seeded model weights, made on the device in a few large draws and
handed to the program and to the reference alike.

The names and shapes are FIRA's parameters (the port's ``state_dict``
names). Distributions are PyTorch's defaults, as the port's own
initialiser uses them: a linear layer's weight and bias U(+-1/sqrt(fan
in)), an embedding N(0, 1), LayerNorm ones and zeros. One uniform draw
covers every linear parameter and one normal draw every embedding, from a
``torch.Generator`` on ``device`` seeded by the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str, int]]


def spec(cfg: Dict) -> Spec:
    """(name, shape, kind, fan_in) of every parameter, kind one of
    ``uniform``, ``normal``, ``ones``, ``zeros``."""
    d, L, V = cfg["embedding_dim"], cfg["num_layers"], cfg["vocab_size"]
    A, f = cfg["ast_change_vocab_size"], cfg["ffn_mult"] * cfg["embedding_dim"]
    out: Spec = []

    def linear(name, d_in, d_out, bias=True):
        out.append((name + ".weight", (d_out, d_in), "uniform", d_in))
        if bias:
            out.append((name + ".bias", (d_out,), "uniform", d_in))

    def norm(name):
        out.append((name + ".weight", (d,), "ones", 0))
        out.append((name + ".bias", (d,), "zeros", 0))

    for name, rows in (("encoder.word_embed", V), ("encoder.mark_embed", 4),
                       ("encoder.ast_change_embed", A)):
        out.append((name + ".weight", (rows, d), "normal", 0))
    for i in range(L):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"encoder.combination_{i}.{p}", d, d)
        norm(f"encoder.combination_{i}.norm")
        linear(f"encoder.gcn_{i}.fc1", d, d)
        linear(f"encoder.gcn_{i}.fc2", d, d)
        norm(f"encoder.gcn_{i}.norm")
    out.append(("decoder.embed.weight", (V, d), "normal", 0))
    for i in range(L):
        for kind in ("self_attn", "cross_attn"):
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(f"decoder.{kind}_{i}.{p}", d, d)
            norm(f"decoder.{kind}_{i}.norm")
        linear(f"decoder.ffn_{i}.fc1", d, f)
        linear(f"decoder.ffn_{i}.fc2", f, d)
        norm(f"decoder.ffn_{i}.norm")
    linear("copy_net.src_proj", d, d, bias=False)
    linear("copy_net.tgt_proj", d, d, bias=False)
    linear("copy_net.score", d, 1)
    linear("copy_net.gate", d, 2)
    linear("out_fc", d, V)
    return out


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` for ``seed`` on ``device`` (f32)."""
    sp = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    n_u = sum(math.prod(s) for _, s, k, _ in sp if k == "uniform")
    n_n = sum(math.prod(s) for _, s, k, _ in sp if k == "normal")
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2.0).sub_(1.0)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, i_n = {}, 0, 0
    for name, s, kind, fan_in in sp:
        n = math.prod(s)
        if kind == "uniform":
            out[name] = uni[iu: iu + n].view(s).mul_(1.0 / math.sqrt(fan_in))
            iu += n
        elif kind == "normal":
            out[name] = nor[i_n: i_n + n].view(s)
            i_n += n
        elif kind == "ones":
            out[name] = torch.ones(s, device=device)
        else:
            out[name] = torch.zeros(s, device=device)
    return out

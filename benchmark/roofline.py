"""Operation and byte counts of the copy-score kernels (K1, K2), the
FLOP count of a training step's matrix products, and the published peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).

K1 computes score[b,t,s] = w . tanh(src[b,s] + tgt[b,t]) + bias; K2 is
its backward (dsrc, dtgt, dw). As in the port's kernel table: 4
operations an element of (B, T, S, D) for K1 and 8 for K2; each input
byte read once and each output byte written once. A kernel's least time
is the larger of operations over the f32 peak and bytes over the HBM
peak.
"""

from __future__ import annotations

from typing import Dict

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def k1_bound_s(B: int, T: int, S: int, D: int, elem: int = 4) -> float:
    ops = 4.0 * B * T * S * D
    byt = elem * (B * S * D + B * T * D + B * T * S) + 4 * (D + 1)
    return max(ops / PEAK_F32_FLOPS, byt / PEAK_BYTES_PER_S)


def k2_bound_s(B: int, T: int, S: int, D: int, elem: int = 4) -> float:
    ops = 8.0 * B * T * S * D
    byt = elem * 2 * (B * S * D + B * T * D) + elem * B * T * S + 4 * 2 * D
    return max(ops / PEAK_F32_FLOPS, byt / PEAK_BYTES_PER_S)


# --- the step's FLOPs: its matrix products at the geometry it runs ---------
#
# The port's step pads every commit to the configuration's full geometry
# (sou_len diff rows, graph_len nodes under a dense adjacency, tar_len
# message positions, copy_len source states), so its work per commit is
# fixed by the configuration and not by the traffic's lengths. Products
# the step does not do in full are counted at what they need: the causal
# self-attention's lower triangle; the combination gate's elementwise
# terms and the softmaxes are not counted.


def encoder_flops(cfg: Dict, n_diff: int, n_nodes: int) -> float:
    """One sample's encoder forward: per round the combination's four
    projections on its diff rows, the GCN's two over its nodes and the
    propagation A.x as a dense (n_nodes x n_nodes) product."""
    d, L = cfg["embedding_dim"], cfg["num_layers"]
    per = (4 * 2 * n_diff * d * d + 2 * 2 * n_nodes * d * d
           + 2 * n_nodes * n_nodes * d)
    return float(L * per)


def decoder_flops(cfg: Dict, m: int, s: int) -> float:
    """One sample's teacher-forced decoder and heads over m message
    positions against s source states (the training forward)."""
    d, L, V = cfg["embedding_dim"], cfg["num_layers"], cfg["vocab_size"]
    f = cfg["ffn_mult"] * d
    causal = m * (m + 1) // 2
    per = (4 * 2 * m * d * d + 2 * 2 * causal * d          # self-attention
           + 2 * 2 * m * d * d + 2 * 2 * s * d * d          # cross q,o; k,v
           + 2 * 2 * m * s * d                              # cross scores
           + 2 * 2 * m * d * f)                             # FFN
    heads = (2 * m * d * V + 2 * s * d * d + 2 * m * d * d  # out_fc, src, tgt
             + 2 * m * s * d + 2 * m * d * 2)               # w . tanh, gate
    return float(L * per + heads)


def train_commit_flops(cfg: Dict) -> float:
    """Forward, backward and the update of one commit of a training step
    at the configuration's geometry: 3x the forward's matrix products."""
    sou, sub, ast = cfg["sou_len"], cfg["sub_token_len"], cfg["ast_change_len"]
    return 3.0 * (encoder_flops(cfg, sou, sou + sub + ast)
                  + decoder_flops(cfg, cfg["tar_len"], sou + sub))

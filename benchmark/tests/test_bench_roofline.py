"""``benchmark/roofline.py`` against the port's kernel table (PERF.md):
K1 and K2 at the training shape (170, 30, 370, 256) f32, K1 at the
cached decode shape; the step's FLOPs a commit."""

import pytest

from benchmark import roofline


def test_k1_train_bound_is_operations():
    assert roofline.k1_bound_s(170, 30, 370, 256) * 1e3 == pytest.approx(
        0.0288, abs=5e-5)


def test_k2_train_bound_is_operations():
    assert roofline.k2_bound_s(170, 30, 370, 256) * 1e3 == pytest.approx(
        0.0577, abs=5e-5)


@pytest.mark.parametrize("B, bound_ms", [(60, 0.00683), (192, 0.0219)])
def test_k1_decode_bound_is_bytes(B, bound_ms):
    assert roofline.k1_bound_s(B, 1, 370, 256) * 1e3 == pytest.approx(
        bound_ms, rel=5e-3)


def test_train_commit_flops_at_fira_full():
    """The step's matrix products a commit at fira-full's geometry,
    written out term by term: 210 diff rows, 650 nodes, 30 message
    positions, 370 source states, d 256, 6 layers, 24,650 words."""
    cfg = dict(embedding_dim=256, num_layers=6, vocab_size=24650,
               ffn_mult=4, sou_len=210, sub_token_len=160,
               ast_change_len=280, tar_len=30)
    d, m, s, n = 256, 30, 370, 650
    enc = 6 * (8 * 210 * d * d + 4 * n * d * d + 2 * n * n * d)
    dec = 6 * (8 * m * d * d + 4 * (m * (m + 1) // 2) * d + 4 * m * d * d
               + 4 * s * d * d + 4 * m * s * d + 4 * m * d * 4 * d)
    heads = (2 * m * d * 24650 + 2 * s * d * d + 2 * m * d * d
             + 2 * m * s * d + 4 * m * d)
    assert roofline.train_commit_flops(cfg) == 3.0 * (enc + dec + heads)

"""The commit generator: byte-stable for a seed, inside FIRA's caps, and
every commit tensorised by the port's data layer without an error."""

import hashlib
import json
import os

import pytest

from benchmark.gen import commits as gen

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(json.load(open(os.path.join(
    BENCH, "traffic", "train_b170.json")))["commits"],
    vocab_size=24650, ast_vocab_size=71)


def digest(seed, n=40):
    return hashlib.sha256(json.dumps(gen.generate(PARAMS, n, seed),
                                     sort_keys=True).encode()).hexdigest()


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11, 2**40 + 3])
def test_byte_stable_for_a_seed(seed):
    assert digest(seed) == digest(seed)


def test_seeds_differ():
    assert digest(1) != digest(2)


def test_inside_the_caps():
    for c in gen.generate(PARAMS, 300, 17):
        assert len(c["difftoken"]) + 2 <= gen.SOU_LEN
        assert sum(len(a) for a in {t: a for t, a in zip(
            c["difftoken"], c["diffatt"])}.values()) <= gen.SUB_LEN
        assert len(c["ast"]) + len(c["change"]) <= gen.AST_CHANGE_LEN
        assert len(c["msg"]) + 2 <= gen.TAR_LEN
        assert gen.edge_entries(c) <= gen.MAX_EDGES
        ids = [int(t[1:]) for t in c["difftoken"] + c["msg"]]
        assert min(ids) >= 4 and max(ids) < 24650


def test_port_tensorises_every_commit():
    from fira_tpu_torch.config import fira_full
    from benchmark.harness import program as P

    cfg = fira_full(vocab_size=24650, ast_change_vocab_size=71)
    split = P.port_split(gen.generate(PARAMS, 60, 3), cfg)
    assert len(split) == 60
    width = cfg.vocab_size + cfg.sou_len + cfg.sub_token_len
    assert split.arrays["msg_tar"].max() < width
    n_edges = split.arrays["edge_offsets"][1:] - split.arrays["edge_offsets"][:-1]
    assert n_edges.max() <= cfg.max_edges

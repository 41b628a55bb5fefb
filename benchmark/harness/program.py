"""Set-up shared by the drivers: the seeded commit pool, its tensorised
form through the port's own data layer, the port's configuration, the
port's model holding the seeded weights, and the host spans and window
clock of a run.

Everything imported from ``fira_tpu_torch`` is the system under test.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np

from benchmark.gen import commits as gen
from benchmark.harness import weights as weights_lib


def dropout_seed(seed: int) -> int:
    return (int(seed) * 1_000_003 + 1) & (2**63 - 1)


def pool(ctx) -> List[Dict]:
    """The cell's pool of distinct commits, made from the seed."""
    cfg = ctx.cfg
    params = dict(ctx.traffic["commits"], vocab_size=cfg["vocab_size"],
                  ast_vocab_size=cfg["ast_change_vocab_size"],
                  **{k: cfg[k] for k in ("sou_len", "sub_token_len",
                                         "ast_change_len", "tar_len")})
    return gen.generate(params, int(ctx.traffic["pool"]), ctx.seed)


def vocabs(cfg: Dict):
    return (gen.word_vocab(cfg["vocab_size"]),
            gen.ast_vocab(cfg["ast_change_vocab_size"]))


def port_config(ctx):
    """The port's FiraConfig: the configuration file's fields."""
    from fira_tpu_torch.config import FiraConfig

    return FiraConfig(**ctx.cfg)


def port_split(commits: List[Dict], cfg):
    """The pool tensorised by the port's ``process_record`` (set-up)."""
    from fira_tpu_torch.data.dataset import ProcessedSplit, process_record
    from fira_tpu_torch.data.schema import CommitRecord
    from fira_tpu_torch.data.vocab import Vocab

    words, asts = vocabs(dict(vocab_size=cfg.vocab_size,
                              ast_change_vocab_size=cfg.ast_change_vocab_size))
    wv, av = Vocab(words), Vocab(asts)
    ex = [process_record(CommitRecord(
        diff_tokens=c["difftoken"], diff_marks=c["diffmark"],
        diff_atts=c["diffatt"], msg_tokens=c["msg"], var_map=c["variable"],
        ast_labels=c["ast"], change_labels=c["change"],
        edge_ast=[tuple(e) for e in c["edge_ast"]],
        edge_ast_code=[tuple(e) for e in c["edge_ast_code"]],
        edge_change_ast=[tuple(e) for e in c["edge_change_ast"]],
        edge_change_code=[tuple(e) for e in c["edge_change_code"]]),
        wv, av, cfg) for c in commits]
    return ProcessedSplit.from_examples(ex)


def port_model(ctx, cfg):
    """The port's model on the device with the seed's weights."""
    from fira_tpu_torch.model.model import FiraModel

    w = weights_lib.make(ctx.cfg, ctx.seed, ctx.device)
    model = FiraModel(cfg, device=ctx.device)
    model.load_state_dict(w, strict=True)
    del w
    return model


def order(seed: int, n_pool: int):
    """The pool's order: a seeded permutation, cycled; chunk i of size B
    holds positions [i*B, (i+1)*B) of the cycle."""
    perm = gen.rng_for(seed, 2).permutation(n_pool)

    def chunk(i: int, B: int) -> np.ndarray:
        return perm[(i * B + np.arange(B)) % n_pool]
    return chunk


class Spans:
    """Host seconds, counts and intervals of the benchmark's spans around
    calls into the program, while ``open`` (the window)."""

    def __init__(self):
        self.open = False
        self.s: Dict[str, float] = {}
        self.n: Dict[str, int] = {}
        self.intervals: List = []   # (start, end, name) while open

    @contextlib.contextmanager
    def __call__(self, name: str):
        a = time.perf_counter()
        yield
        if self.open:
            b = time.perf_counter()
            self.s[name] = self.s.get(name, 0.0) + b - a
            self.n[name] = self.n.get(name, 0) + 1
            self.intervals.append((a, b, name))


class Phases:
    """Seconds of each named part of set-up, on the host clock."""

    def __init__(self):
        self.s: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = now - self.t
        self.t = now


def check(name: str, value: float, limits: Dict) -> Dict:
    return dict(name=name, value=float(value), limit=float(limits[name]))


def tf32_off(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


"""The beam's top-k, a stable sort, against ``torch.topk`` with its ties
repaired, on the card.

    python -m fira_tpu_torch.decode.ablate_topk

Both give the k largest entries of a row, ties to the lower index (as
``jax.lax.top_k``): :func:`beam.stable_top_k`, the beam's, sorts the whole
row; :func:`top_k_no_sort`, the alternative, finds the k-th value with
``torch.topk``, takes every entry above it and fills the rest with the
lowest-index entries equal to it, then orders the k results. The script
swaps either in for the beam's per-side (factored) and global top-k and
decodes the test split of a
synthetic corpus at fira-full width (vocabularies padded to the paper's
24,650 words and 71 AST tokens; random weights, seed 0) with the cached
beam in prob space, f32 and bf16:

- factored: per side / global = sort / sort, no-sort / sort and
  no-sort / no-sort, in turns a b c c b a;
- fused: global = sort and no-sort, in turns a b b a.

Each decode's tokens and scores must be bitwise equal to the first's. It
prints the beam loop's commits/s (batches already on the card, host wall
to a synchronise) of every turn; then each top-k alone at the beam's row
shapes: device ms (``timing.time_ms``) and host µs to queue one call.
Writes its corpus under ``build/ablate_topk`` of the checkout. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import torch

from fira_tpu_torch.cli import resolve_device
from fira_tpu_torch.config import fira_full
from fira_tpu_torch.data import buckets, synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.decode import beam
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.ops.timing import smi_name_power, time_ms

N_COMMITS, SEED = 720, 0
WORD_VOCAB, AST_VOCAB = 24_650, 71


def top_k_no_sort(x, k: int):
    """:func:`beam.stable_top_k`'s result without sorting the row."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above, tied = x > kth, x == kth
    need = k - above.sum(-1, keepdim=True)
    sel = above | (tied & (tied.cumsum(-1) <= need))
    # the j-th selected entry (index order) goes to slot j, the rest to a
    # discard slot k
    slot = torch.where(sel, sel.cumsum(-1) - 1, k)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    idx = torch.zeros((*x.shape[:-1], k + 1), dtype=torch.long,
                      device=x.device).scatter_(-1, slot, pos)[..., :k]
    vals = x.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)


def corpus(root: str) -> FiraDataset:
    """The synthetic corpus with its vocabularies padded by filler tokens
    to the paper's sizes, so every width is fira-full's."""
    data_dir = os.path.join(root, "build", "ablate_topk")
    shutil.rmtree(data_dir, ignore_errors=True)
    synthetic.write_corpus_dir(data_dir, n_commits=N_COMMITS, seed=SEED)
    for fname, size in (("word_vocab.json", WORD_VOCAB),
                        ("ast_change_vocab.json", AST_VOCAB)):
        path = os.path.join(data_dir, fname)
        with open(path) as f:
            vocab = json.load(f)
        for i in range(size - len(vocab)):
            vocab[f"<filler_{i}>"] = len(vocab)
        with open(path, "w") as f:
            json.dump(vocab, f)
    return FiraDataset(data_dir, fira_full())


def decode(model, cfg, batches, side, glob) -> tuple:
    """The cached beam over ``batches`` with ``side`` as the factored
    per-side top-k and ``glob`` as the global one: (commits/s, outputs).
    The beam calls ``beam.stable_top_k`` for both: on (B, K, width) rows
    per side, on (B, K*W + K) rows globally."""
    beam.stable_top_k = lambda x, k: (side if x.dim() == 3 else glob)(x, k)
    search = beam.make_beam_search(model, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [search(b) for b, _ in batches]
    torch.cuda.synchronize()
    rate = sum(n for _, n in batches) / (time.perf_counter() - t0)
    return rate, [x.cpu() for o in outs for x in o]


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_topk: no CUDA device", file=sys.stderr)
        return 2
    sort = beam.stable_top_k
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    resolve_device("cuda")   # TF32 off, as the CLI runs
    print(f"[device] {smi_name_power()}", flush=True)
    ds = corpus(root)
    cfg = ds.cfg
    data, dev = ds.splits["test"], torch.device("cuda")
    batches = []
    for chunk, geom in buckets.decode_plan(data, cfg):
        host = make_batch(data, chunk, cfg, batch_size=cfg.test_batch_size,
                          geom=geom)
        batches.append((batch_to_device(host, dev), int(host["valid"].sum())))
    designs = {
        "factored": {"sort/sort": (sort, sort),
                     "no-sort/sort": (top_k_no_sort, sort),
                     "no-sort/no-sort": (top_k_no_sort, top_k_no_sort)},
        "fused": {"global sort": (sort, sort),
                  "global no-sort": (sort, top_k_no_sort)}}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        model = FiraModel(c, device=dev, dtype=dtype).init_parameters(
            torch.Generator().manual_seed(SEED)).eval()
        for mode, variants in designs.items():
            cm = c.replace(beam_factored_topk=mode == "factored")
            decode(model, cm, batches, sort, sort)     # warm
            rates, first = {v: [] for v in variants}, None
            for name in [*variants, *reversed(variants)]:
                rate, out = decode(model, cm, batches, *variants[name])
                first = first or out
                if not all(torch.equal(a, b) for a, b in zip(out, first)):
                    print(f"ablate_topk: {dtype} {mode} {name} decodes other "
                          f"tokens or scores", file=sys.stderr)
                    return 1
                rates[name].append(rate)
            print(f"[{dtype} {mode}] cached, prob space, {len(data)} "
                  f"commits, beam loop commits/s in turns "
                  f"(per side / global top-k; outputs bitwise equal): "
                  + "; ".join(f"{v} " + " ".join(f"{r:.2f}" for r in rs)
                              for v, rs in rates.items()), flush=True)
        del model
    beam.stable_top_k = sort
    K, V = cfg.beam_size, cfg.vocab_size
    rows = {"factored per side, generation": (cfg.test_batch_size * K, V),
            "factored per side, copy": (cfg.test_batch_size * K,
                                        cfg.copy_len),
            "factored global": (cfg.test_batch_size, 2 * K * K + K),
            "fused global": (cfg.test_batch_size,
                             K * cfg.output_vocab_size + K)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for what, shape in rows.items():
        x = torch.rand(shape, generator=gen, device=dev)
        got = {}
        for name, fn in (("sort", sort), ("no-sort", top_k_no_sort)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(x, K)
            host_us = 1e6 * (time.perf_counter() - t0) / 200
            torch.cuda.synchronize()
            got[name] = (time_ms(lambda: fn(x, K)), host_us)
        print(f"[top-k] {what} {shape}, k {K}: "
              + "; ".join(f"{n} device {ms:.4f} ms, host {us:.1f} us a call"
                          for n, (ms, us) in got.items()), flush=True)
    print(smi_name_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Three forms of the embedding lookup on the card: the model's
(``model._embed``: a one-hot product for a table of at most
``ONE_HOT_ROWS`` rows, ``F.embedding`` for the rest), an index for every
table (``weight[ids]``, whose backward adds repeated ids with the sorted
``index_put_``) and ``F.embedding`` for every table (whose backward is
the embedding kernel's).

    python -m fira_tpu_torch.model.ablate_embed

At fira-full width (the synthetic corpus of ``decode.ablate_topk``, its
vocabularies padded to the paper's sizes; random weights, seed 0), f32
and then bf16:

- reproducibility: the gradients of one training batch from two backward
  passes, bitwise equal or not, and the leaves that differ;
- the training step (batch 170, full geometry, Adam, dropout from a
  seeded generator): ms a step (host wall to a synchronise, over
  ``STEPS`` steps after two warm ones), in turns a b c c b a;
- one decode batch (the first 20 test commits, the cached beam in prob
  space): ms (host wall to a synchronise, the median of ``DECODES``), in
  turns a b c c b a; the tokens and scores of the three forms must be
  bitwise equal (each forward gives the table's rows exactly).

The swap replaces ``model._embed`` for the run and restores it. Writes its
corpus under ``build/ablate_topk`` of the checkout. Needs a CUDA card.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import torch
import torch.nn.functional as F

from fira_tpu_torch.cli import resolve_device
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.decode import beam
from fira_tpu_torch.decode.ablate_topk import SEED, corpus
from fira_tpu_torch.model import model as model_mod
from fira_tpu_torch.ops.timing import smi_name_power
from fira_tpu_torch.train.state import init_state
from fira_tpu_torch.train.step import loss_fn, train_step

STEPS, DECODES = 10, 3


def embed_kernel(table, ids, dtype):
    """``model._embed`` through ``F.embedding`` for every table (no
    tensor-parallel tables here)."""
    return F.embedding(ids, table.weight.to(dtype))


def embed_index(table, ids, dtype):
    """``model._embed`` as an index for every table."""
    return table.weight.to(dtype)[ids]


def grads_differ(model, batch) -> list:
    """The leaves whose gradients differ between two backward passes of
    ``batch`` with dropout from the same seed."""
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch,
                torch.Generator(device="cuda").manual_seed(SEED)).backward()
        runs.append({k: p.grad.clone() for k, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return [k for k, g in runs[0].items() if not torch.equal(g, runs[1][k])]


def step_ms(state, batches) -> float:
    for b in batches[:2]:
        train_step(state.model, state.optimizer, b, state.generator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(STEPS):
        train_step(state.model, state.optimizer, batches[i % len(batches)],
                   state.generator)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEPS


def decode_ms(model, cfg, batch) -> tuple:
    search = beam.make_beam_search(model.eval(), cfg)
    search(batch)
    times, out = [], None
    for _ in range(DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = search(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), [x.cpu() for x in out]


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_embed: no CUDA device", file=sys.stderr)
        return 2
    port = model_mod._embed
    designs = {"model": port, "index": embed_index,
               "F.embedding": embed_kernel}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    resolve_device("cuda")   # TF32 off, as the CLI runs
    smi = smi_name_power()
    print(f"[device] {smi}", flush=True)
    ds = corpus(root)
    cfg = ds.cfg
    dev = torch.device("cuda")
    train, test = ds.splits["train"], ds.splits["test"]
    B = cfg.batch_size
    hosts = [make_batch(train, [(B * i + j) % len(train) for j in range(B)],
                        cfg, batch_size=B) for i in range(4)]
    dec_host = make_batch(test, list(range(cfg.test_batch_size)), cfg,
                          batch_size=cfg.test_batch_size)
    order = [*designs, *reversed(designs)]
    try:
        for dtype in ("float32", "bfloat16"):
            c = cfg.replace(compute_dtype=dtype)
            batches = [batch_to_device(h, dev, TRAIN_FIELDS) for h in hosts]
            state = init_state(c, dev)
            for name, fn in designs.items():
                model_mod._embed = fn
                bad = grads_differ(state.model, batches[0])
                print(f"[{dtype} {name}] two backward passes of one batch: "
                      f"{len(bad)} of "
                      f"{len(list(state.model.parameters()))} gradient "
                      f"leaves differ {bad}", flush=True)
            steps = {k: [] for k in designs}
            for name in order:
                model_mod._embed = designs[name]
                steps[name].append(step_ms(state, batches))
            print(f"[{dtype}] training step (batch {B}, full geometry), ms "
                  f"a step in turns a b c c b a: " + "; ".join(
                      f"{k} " + " ".join(f"{t:.3f}" for t in v)
                      for k, v in steps.items()), flush=True)
            model = state.model
            del state, batches
            dec = batch_to_device(dec_host, dev)
            times, outs = {k: [] for k in designs}, {}
            for name in order:
                model_mod._embed = designs[name]
                ms, out = decode_ms(model, c, dec)
                times[name].append(ms)
                outs.setdefault(name, out)
            same = all(torch.equal(a, b) for o in outs.values()
                       for a, b in zip(o, outs["model"]))
            print(f"[{dtype}] one decode batch ({cfg.test_batch_size} "
                  f"commits, cached beam, prob space), ms in turns "
                  f"a b c c b a: "
                  + "; ".join(f"{k} " + " ".join(f"{t:.3f}" for t in v)
                              for k, v in times.items())
                  + f"; outputs bitwise equal: {same}", flush=True)
            if not same:
                print("ablate_embed: the forms decode differently",
                      file=sys.stderr)
                return 1
            del model, dec
            torch.cuda.empty_cache()
    finally:
        model_mod._embed = port
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A tiny copy of the benchmark for CPU tests: the real driver, metric
readers, generator and reference, with a fira-tiny-sized configuration
and traffic mix, written into a scratch directory laid out as a
checkout (``BENCHMARK.json`` beside ``benchmark/``)."""

import copy
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {
    "sou_len": 32, "tar_len": 12, "att_len": 6, "ast_change_len": 24,
    "sub_token_len": 24, "embedding_dim": 64, "num_head": 4,
    "num_layers": 2, "dropout_rate": 0.1, "gcn_dropout_rate": 0.2,
    "ffn_mult": 4, "vocab_size": 300, "ast_change_vocab_size": 20,
    "lr": 0.0001, "batch_size": 8, "test_batch_size": 4, "beam_size": 3,
    "max_edges": 512, "compute_dtype": "float32", "feeder_workers": 2,
    "feeder_depth": 4}


def tiny_commits():
    c = copy.deepcopy(json.load(open(os.path.join(
        BENCH, "traffic", "train_b170.json")))["commits"])
    c["diff_tokens"].update(median=12, max=30)
    c["ast_nodes"].update(median=6, max=14)
    c["change_nodes"].update(median=2, max=6)
    c["msg_tokens"].update(median=5, max=10)
    return c


def write(dst: str, limits=None) -> dict:
    """The tiny checkout at ``dst``; returns its BENCHMARK.json."""
    b = os.path.join(dst, "benchmark")
    for kind in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, kind), exist_ok=True)
    for kind in ("drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(b, kind),
                        ignore=shutil.ignore_patterns("__pycache__"))
    json.dump({"source": "test", "reduced": [], "config": TINY},
              open(os.path.join(b, "configs", "tiny.json"), "w"))
    commits = tiny_commits()
    train = {"driver": "train", "batch_size": 8, "pool": 40,
             "warm_steps": 1, "trace_steps": 2, "commits": commits}
    json.dump(train, open(os.path.join(b, "traffic", "train_tiny.json"), "w"))
    json.dump(limits or {"loss_gap": 1e-4, "grad_gap": 1e-3,
                         "delta_gap": 1e-2},
              open(os.path.join(b, "limits", "train.tiny.json"), "w"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "tests"}]
    spec["workloads"] = [
        {"name": "train.tiny", "config": "tiny", "traffic": "train_tiny",
         "chips": 1, "why": "tests"}]
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if "workloads" in m:
                m["workloads"] = ["train.tiny"]
    json.dump(spec, open(os.path.join(dst, "BENCHMARK.json"), "w"))
    return spec

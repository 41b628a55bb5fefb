"""The harness finds every piece by name: a configuration, a traffic
mix, a driver, a limits file and a per-layer metric dropped in as new
files, with entries added to BENCHMARK.json, run with no existing file
of the benchmark edited."""

import hashlib
import json
import os

import torch

import tiny
from benchmark.harness import bench

DRIVER = '''
from benchmark.harness import program as P


def run(ctx):
    n = len(P.pool(ctx))
    return dict(driver="count", setup_s=0.5, window_s=1.0, peak_bytes=0,
                commits=n, attempted=n, failed=0, spans={}, counts={},
                checks=[P.check("pool_gap", 0.0, ctx.limits)])
'''
METRIC = '''
def read(rec):
    return float(rec["commits"]) if rec["driver"] == "count" else None
'''


def tree_digest(root):
    h = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            h[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return h


def test_new_pieces_are_found_by_name(tmp_path):
    root = str(tmp_path)
    spec = tiny.write(root)
    b = os.path.join(root, "benchmark")
    before = tree_digest(b)
    cfg = json.load(open(os.path.join(b, "configs", "tiny.json")))
    cfg["config"]["vocab_size"] = 400
    json.dump(cfg, open(os.path.join(b, "configs", "tiny400.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "train_tiny.json")))
    mix.update(driver="count", pool=17)
    json.dump(mix, open(os.path.join(b, "traffic", "count17.json"), "w"))
    open(os.path.join(b, "drivers", "count.py"), "w").write(DRIVER)
    open(os.path.join(b, "metrics", "pool_size.count.py"), "w").write(METRIC)
    json.dump({"pool_gap": 0.0},
              open(os.path.join(b, "limits", "count.tiny400.json"), "w"))
    spec["configs"].append({"name": "tiny400", "source": "test",
                            "file": "benchmark/configs/tiny400.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "count.tiny400", "config": "tiny400",
                              "traffic": "count17", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "pool_size.count", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "setup_s",
                              "workloads": ["count.tiny400"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    after = tree_digest(b)
    assert all(after[k] == v for k, v in before.items())
    out = bench.run_cell("count.tiny400", 5, 1.0, True, torch.device("cpu"),
                         torch, bench=spec, bench_dir=b)
    assert out["result"]["correct"]
    assert out["result"]["metrics"] == {
        "pool_size.count": {"value": 17.0, "unit": "count"}}
    e2e = bench.run_cell("count.tiny400", 5, 1.0, False, torch.device("cpu"),
                         torch, bench=spec, bench_dir=b)["result"]["metrics"]
    assert set(e2e) == {"setup_s"}


def test_metrics_follow_their_workloads():
    spec = bench.benchmark()
    for wl in spec["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(spec, wl["name"], False)}
        layer = bench.metrics_of(spec, wl["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
        assert os.path.exists(os.path.join(bench.ROOT, next(
            c["file"] for c in spec["configs"] if c["name"] == wl["config"])))
        bench.cell(wl["name"], spec)
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            assert os.path.exists(bench.piece("metrics", m["name"], ".py"))

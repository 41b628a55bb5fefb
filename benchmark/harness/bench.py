"""The harness: finds a cell's configuration, traffic mix, driver, limits
and metric readers by name, runs the driver, and builds the result line.

Layout (each piece a file of its own, found by the name
``BENCHMARK.json`` gives):

- ``configs/<config>.json``: ``config`` (FiraConfig fields, the run's
  sizes), ``source``, ``reduced``, ``assumed``;
- ``traffic/<traffic>.json``: ``driver`` and its parameters;
- ``drivers/<driver>.py``: ``run(ctx) -> dict``, the record of one run;
- ``limits/<workload>.json``: the limit of each number the cell compares;
- ``metrics/<metric>.py``: ``read(rec) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def piece(kind: str, name: str, ext: str, bench_dir: str = BENCH_DIR) -> str:
    path = os.path.join(bench_dir, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} entry named {name!r} ({path})")
    return path


def load_module(path: str):
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its pieces, the run's arguments and
    the device. ``t0``: the process's start on the host clock."""

    torch: Any
    workload: Dict
    config: Dict          # the configuration file
    traffic: Dict         # the traffic file
    limits: Dict          # name -> limit of each compared number
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float

    @property
    def cfg(self) -> Dict:
        return self.config["config"]


def cell(name: str, bench: Dict, bench_dir: str = BENCH_DIR) -> Dict:
    """The workload entry ``name`` and its pieces, found by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    config = load_json(piece("configs", wl["config"], ".json", bench_dir))
    traffic = load_json(piece("traffic", wl["traffic"], ".json", bench_dir))
    limits = load_json(piece("limits", name, ".json", bench_dir))
    driver = load_module(piece("drivers", traffic["driver"], ".py",
                               bench_dir))
    return dict(workload=wl, config=config, traffic=traffic, limits=limits,
                driver=driver)


def metrics_of(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: per-layer ones with ``trace``, else the
    end-to-end ones; each only where its ``workloads`` (if given) list
    the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def read_metrics(bench: Dict, name: str, trace: bool, rec: Dict,
                 bench_dir: str = BENCH_DIR) -> Dict[str, Dict]:
    out = {}
    for m in metrics_of(bench, name, trace):
        reader = load_module(piece("metrics", m["name"], ".py", bench_dir))
        v = reader.read(rec)
        if v is None:
            continue
        v = float(v)
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def checks_line(checks: List[Dict]) -> Dict[str, Dict]:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]}
            for c in checks}


def judge(checks: List[Dict]) -> bool:
    """Every compared number at or under its limit (a NaN fails)."""
    return all(c["value"] <= c["limit"] for c in checks)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             torch, t0: Optional[float] = None, bench: Optional[Dict] = None,
             bench_dir: str = BENCH_DIR) -> Dict:
    """Run one cell; the result dict (without ``device``) and the record."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or benchmark(os.path.dirname(bench_dir))
    c = cell(name, bench, bench_dir)
    ctx = Ctx(torch=torch, workload=c["workload"], config=c["config"],
              traffic=c["traffic"], limits=c["limits"], seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device, t0=t0)
    rec = c["driver"].run(ctx)
    checks = rec["checks"]
    result = {
        "correct": judge(checks),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": read_metrics(bench, name, trace, rec, bench_dir),
    }
    return dict(result=result, rec=rec, checks=checks)


def env_caches(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

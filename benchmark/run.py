"""Benchmark of the PyTorch/CUDA port (``fira_tpu_torch``) on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the cell's numbers compared with
their limits on standard error, then one JSON line on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics with ``--trace 0``, the per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``checks`` last. Exits 2 without a
result when the cell needs more CUDA devices than there are, and 3 when
the process has loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "fira_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import bench

    bench.env_caches()
    spec = bench.benchmark()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), device, torch, t0=T0, bench=spec)
    rec, result = out["rec"], out["result"]
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": int(wl["chips"]),
        "memory_peak_bytes": int(rec["peak_bytes"]),
        "power_limit": power_limit(),
    }
    tr = rec.get("trace")
    if args.trace and tr:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = bench.checks_line(out["checks"])
    print(f"readings {json.dumps(rec.get('readings', {}))}", file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

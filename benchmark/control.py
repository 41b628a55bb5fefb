"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size (not run by the benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed, one JSON line: the program's numbers (the cell's own run,
with a short window; a training cell needs none beyond its first steps),
the control's (the plain reference put in the program's place and
computed in TF32, the precision below the configuration's float32 with
TF32 off) and the planted faults' (half of each batch left out, the mean
taken over the rest; a state left unchanged, whose first gradient and
change read as nought, with no run). Each is judged as a run is
(``bench.judge`` over the cell's limits): its ``correct`` beside its
numbers. The last line counts, for each, the seeds judged correct.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_readings(ctx, mod, P):
    torch = ctx.torch
    commits = P.pool(ctx)
    chunk = P.order(ctx.seed, len(commits))
    B = int(ctx.traffic["batch_size"])
    P.tf32_off(torch)
    ref = mod.reference_steps(ctx, commits, B, chunk)
    names, losses, g1, _w3, w0 = ref
    out = {"fault_state_unchanged": mod.compare(
        names, losses, [torch.zeros_like(g) for g in g1], w0, ref)}
    for name, tf32, rows in (("control_tf32", True, None),
                             ("fault_half_batch", False,
                              torch.arange(B // 2, device=ctx.device))):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        names, losses, g1, w3, _w0 = mod.reference_steps(
            ctx, commits, B, chunk, rows_kept=rows)
        P.tf32_off(torch)
        out[name] = mod.compare(names, losses, g1, w3, ref)
    return out


def judged(numbers, limits, bench, P):
    """``numbers`` with the harness's verdict over ``limits``."""
    checks = [P.check(k, numbers[k], limits) for k in limits]
    return dict(numbers, correct=bench.judge(checks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--skip-program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import bench
    from benchmark.harness import program as P

    bench.env_caches()
    spec = bench.benchmark()
    c = bench.cell(args.workload, spec)
    if c["traffic"]["driver"] != "train":
        print(f"no control readings for the {c['traffic']['driver']!r} "
              "driver", file=sys.stderr)
        return 2
    tally = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Ctx(torch=torch, workload=c["workload"],
                        config=c["config"], traffic=c["traffic"],
                        limits=c["limits"], seed=seed, seconds=args.seconds,
                        trace=False, device=torch.device("cuda"),
                        t0=time.perf_counter())
        line = {"seed": seed}
        if not args.skip_program:
            rec = c["driver"].run(ctx)
            line["program"] = dict(
                {k["name"]: k["value"] for k in rec["checks"]},
                correct=bench.judge(rec["checks"]))
            line["program_readings"] = rec.get("readings")
        for name, numbers in train_readings(ctx, c["driver"], P).items():
            line[name] = judged(numbers, c["limits"], bench, P)
        for name, v in line.items():
            if isinstance(v, dict) and "correct" in v:
                n = tally.setdefault(name, [0, 0])
                n[0] += int(v["correct"])
                n[1] += 1
        print(json.dumps(line), flush=True)
    print(json.dumps({"correct_of_seeds": tally}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

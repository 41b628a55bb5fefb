"""The control and the faults, judged as a run is (``bench.judge`` over
the cell's limits) by ``control.py``: on the CPU the planted faults read
``correct`` false beside a sound program; on a card the plain reference
in TF32, put in the program's place, reads at least three times the
program's own numbers and is judged not correct against the tiny cell's
card limits (the readings at the cell's size are in PERF.md)."""

import os
import time

import pytest
import torch

import tiny
from benchmark import control
from benchmark.harness import bench
from benchmark.harness import program as P


# Limits of the tiny cell on a card, set as the cell's are: from the
# program's largest reading over seeds 11-22 (loss 1.9e-07, grad 1.8e-07,
# delta 1.5e-05) and the TF32 control's smallest (3.6e-06, 3.7e-04,
# 1.0e-03), on an NVIDIA H100.
CARD_LIMITS = {"loss_gap": 1e-6, "grad_gap": 1e-5, "delta_gap": 1e-4}


def readings(tmp_path, device, seed, limits=None):
    d = str(tmp_path)
    spec = tiny.write(d, limits)
    c = bench.cell("train.tiny", spec, os.path.join(d, "benchmark"))
    ctx = bench.Ctx(torch=torch, workload=c["workload"], config=c["config"],
                    traffic=c["traffic"], limits=c["limits"], seed=seed,
                    seconds=1.0, trace=False, device=device,
                    t0=time.perf_counter())
    rec = c["driver"].run(ctx)
    prog = {k["name"]: k["value"] for k in rec["checks"]}
    out = {name: control.judged(v, c["limits"], bench, P)
           for name, v in control.train_readings(ctx, c["driver"],
                                                 P).items()}
    return dict(out, program=control.judged(prog, c["limits"], bench, P))


def test_faults_are_judged_not_correct(tmp_path):
    r = readings(tmp_path, torch.device("cpu"), 21)
    assert r["program"]["correct"]
    assert not r["fault_half_batch"]["correct"]
    assert not r["fault_state_unchanged"]["correct"]
    assert r["fault_state_unchanged"]["delta_gap"] == pytest.approx(1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tf32_control_reads_above_the_program(tmp_path, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = readings(tmp_path, torch.device("cuda"), seed, CARD_LIMITS)
    prog = {k: v for k, v in r["program"].items() if k.endswith("_gap")}
    ctl = r["control_tf32"]
    assert max(ctl[k] / max(v, 1e-12) for k, v in prog.items()) >= 3.0
    assert r["program"]["correct"] and not ctl["correct"]

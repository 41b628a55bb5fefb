"""Whole runs of the tiny cells on the CPU (the harness's look for a
card skipped): ``correct`` comes out true on sound runs and false when
the timed path is broken underneath: a step that leaves the state
unchanged, half of each batch left out (the mean over the rest)."""

import os

import pytest
import torch

import tiny
from benchmark.harness import bench


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    spec = tiny.write(d)
    return spec, os.path.join(d, "benchmark")


def run(checkout, name, seed=31337):
    spec, bdir = checkout
    return bench.run_cell(name, seed, 1.0, False, torch.device("cpu"), torch,
                          bench=spec, bench_dir=bdir)


def test_sound_run_is_correct(checkout):
    metric = "train_commits_per_s"
    out = run(checkout, "train.tiny")
    r = out["result"]
    assert r["correct"], out["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {metric, "setup_s"}   # no peak on the CPU
    assert r["metrics"][metric]["value"] > 0


def test_state_left_unchanged_fails(checkout, monkeypatch):
    from fira_tpu_torch.train import step as step_mod

    def frozen(model, optimizer, batch, generator, mesh=None):
        model.train()
        return step_mod.loss_fn(model, batch, generator).detach()

    monkeypatch.setattr(step_mod, "train_step", frozen)
    out = run(checkout, "train.tiny")
    assert not out["result"]["correct"]
    gap = {c["name"]: c["value"] for c in out["checks"]}
    assert gap["delta_gap"] == pytest.approx(1.0)


def test_half_batch_fails(checkout, monkeypatch):
    from fira_tpu_torch.train import step as step_mod

    whole = step_mod.train_step

    def half(model, optimizer, batch, generator, mesh=None):
        n = next(iter(batch.values())).shape[0] // 2
        return whole(model, optimizer, {k: v[:n] for k, v in batch.items()},
                     generator, mesh)

    monkeypatch.setattr(step_mod, "train_step", half)
    assert not run(checkout, "train.tiny")["result"]["correct"]

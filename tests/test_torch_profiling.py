"""The port's tracing and step-timing hooks
(``fira_tpu_torch/utils/profiling.py``) against the JAX package's
``fira_tpu/utils/profiling.py``, on the CPU:

- ``trace`` writes a ``*.pt.trace.json`` holding the ``train_step#N``
  ranges of ``step_annotation``; ``trace(None)`` starts no profiler;
- ``Meter``'s summary equals the JAX ``Meter``'s, key for key, on one tick
  sequence under one stubbed ``time.perf_counter``;
- ``train(profile_dir=...)`` with ``fused_steps=2`` writes the window
  (steps 2 on, one range a grouped dispatch) and records the JAX loop's
  grouped-program warning and console lines, on one seeded fira-tiny
  corpus each package writes with its own generator.
"""

import glob
import json
import os
import re

import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.train.loop import train as jax_train
from fira_tpu.utils import profiling as jax_profiling
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.train.loop import train
from fira_tpu_torch.utils import profiling

N_COMMITS, SEED, BS = 40, 5, 4


def _annotations(log_dir):
    """The ``train_step#N`` range names of the one trace under log_dir."""
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(e["name"] for e in events
                  if str(e.get("name", "")).startswith("train_step#"))


def test_trace_writes_the_step_ranges(tmp_path):
    with profiling.trace(str(tmp_path)):
        for step in (3, 4):
            with profiling.step_annotation(step):
                (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert _annotations(str(tmp_path)) == ["train_step#3", "train_step#4"]
    assert profiling.annotation_name(12) == "train_step#12"


def test_trace_none_is_a_noop(tmp_path):
    with profiling.trace(None):
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(2).sum()
    with jax_profiling.trace(None):
        pass
    assert os.listdir(tmp_path) == []


def test_meter_summary_matches_jax(monkeypatch):
    """start, a warmup tick, ticks with items and stalls, a pause and a
    restart: the same clock readings give the same seven figures."""
    readings = [0.0, 0.5, 0.75, 1.25, 1.3, 2.0, 2.6, 2.9, 3.15]

    def run(meter_cls):
        clock = iter(readings)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        m = meter_cls(warmup=1)
        assert m.summary() == jax_profiling.Meter().summary()
        m.start()
        m.tick(4)                     # warmup: dropped
        m.tick(4, stall_s=0.05)
        m.tick(3, stall_s=0.125)
        m.pause()                     # a dev gate
        m.start()
        m.tick(4, stall_s=0.0)
        m.tick(2, stall_s=0.2)
        m.tick(4, stall_s=0.01)
        m.tick(4, stall_s=0.02)
        return m.summary()

    want = run(jax_profiling.Meter)
    got = run(profiling.Meter)
    assert got == want
    assert set(got) == {"steps", "items_per_sec", "mean_step_ms",
                        "p50_step_ms", "p99_step_ms", "feed_stall_frac",
                        "feed_stall_ms_per_step"}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_prof"))
    tdir = str(tmp_path_factory.mktemp("torch_prof"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=N_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=N_COMMITS, seed=SEED)
    return (JaxDataset(jdir, jax_fira_tiny(batch_size=BS)),
            FiraDataset(tdir, fira_tiny(batch_size=BS)))


def test_train_profile_window_and_warning_match_jax(corpora, tmp_path,
                                                    capsys):
    """fused_steps=2, profile_steps=4: the ranges of the grouped
    dispatches from step 2 until past step 5, named by their first step,
    and the JAX loop's warning and console lines."""
    jds, tds = corpora
    knobs = dict(fused_steps=2, dev_start_epoch=5)
    jres = jax_train(jds, jds.cfg.replace(**knobs),
                     out_dir=str(tmp_path / "jax"), epochs=1, resume=False,
                     profile_dir=str(tmp_path / "jax_trace"),
                     profile_steps=4)
    jax_out = capsys.readouterr().out
    tdir = str(tmp_path / "torch_trace")
    tres = train(tds, tds.cfg.replace(**knobs), device="cpu",
                 out_dir=str(tmp_path / "torch"), epochs=1, resume=False,
                 profile_dir=tdir, profile_steps=4)
    out = capsys.readouterr().out
    assert tres.warnings == jres.warnings
    assert tres.warnings[0].startswith("profiling the grouped program")
    for line in (jres.warnings[0], "profile trace written to "):
        assert (line in out) == (line in jax_out) == True  # noqa: E712
    assert tres.steps >= 6
    assert _annotations(tdir) == ["train_step#2", "train_step#4"]
    assert re.search(r"profile trace written to .*torch_trace", out)


def test_train_profile_not_written_lines(corpora, tmp_path, capsys):
    """A run that ends before the window, and profile_steps=0, say so in
    the JAX loop's words and write no trace."""
    _, tds = corpora
    cfg = tds.cfg.replace(dev_start_epoch=5)
    train(tds, cfg, device="cpu", out_dir=str(tmp_path / "a"), epochs=1,
          profile_dir=str(tmp_path / "p0"), profile_steps=0)
    assert ("profile trace NOT written: profile_steps=0"
            in capsys.readouterr().out)
    few = tds.cfg.replace(dev_start_epoch=5, batch_size=64)
    res = train(tds, few, device="cpu", out_dir=str(tmp_path / "b"),
                epochs=1, profile_dir=str(tmp_path / "p1"))
    assert res.steps < 2
    assert (f"profile trace NOT written: run ended after {res.steps} steps, "
            f"before the profile window (starts at step 2)"
            in capsys.readouterr().out)
    assert not glob.glob(str(tmp_path / "p*" / "*.json"))

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
  corpus each package writes with its own generator;
- the port's span and counter recorder: counts, totals and medians under
  a stubbed clock, spans from two threads, the capture's bound and its
  silence when closed, ``record_function`` ranges of the spans inside a
  ``trace`` window only, and the train loop's readings of its own run.
"""

import glob
import json
import os
import re
import threading

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


def _stub_clock(monkeypatch, readings):
    clock = iter(readings)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))


def test_span_aggregates_and_median(monkeypatch):
    """Counts, totals and medians of three spans and a counter under a
    stubbed clock; ``since`` a mark gives what came after it; a raising
    block is not recorded; a capture keeps the interval."""
    rec = profiling.Recorder()
    _stub_clock(monkeypatch, [0.0, 0.5, 1.0, 1.25, 2.0, 4.0, 5.0, 5.5,
                              6.0, 7.0, 8.0, 8.5])
    for _ in range(3):
        with rec.span("a"):
            pass
    assert rec.spans() == {"a": {"count": 3, "total_s": 2.75,
                                 "median_s": 0.5}}
    mark = rec.mark()
    with rec.span("a") as s:
        pass
    assert (s.start, s.end, s.seconds) == (5.0, 5.5, 0.5)
    with pytest.raises(ValueError):
        with rec.span("a"):
            raise ValueError("not recorded")
    with rec.capture() as cap:
        with rec.span("b") as b:
            pass
    assert b.seconds == 0.5 and cap.intervals == [
        (8.0, 8.5, "b", threading.current_thread().name)]
    rec.count("c")
    rec.count("c", 4)
    assert rec.spans(since=mark) == {
        "a": {"count": 1, "total_s": 0.5, "median_s": 0.5},
        "b": {"count": 1, "total_s": 0.5, "median_s": 0.5}}
    assert rec.spans()["a"] == {"count": 4, "total_s": 3.25,
                                "median_s": 0.5}
    assert rec.counters() == {"c": 5} == rec.counters(since=mark)
    mark = rec.mark()
    rec.count("c", 2)
    assert rec.counters(since=mark) == {"c": 2}
    assert rec.spans(since=mark) == {}
    rec.reset()
    assert rec.spans() == {} and rec.counters() == {}


def test_recent_durations_are_bounded():
    rec = profiling.Recorder(recent=4)
    for d in (9.0, 9.0, 9.0, 1.0, 2.0, 3.0, 4.0):
        rec.record("x", 0.0, d)
    got = rec.spans()["x"]
    assert got["count"] == 7 and got["total_s"] == 37.0
    assert got["median_s"] == 2.5           # of the last four only


def test_spans_from_two_threads():
    """Two threads (and the caller) record one name: no update is lost,
    and the capture names each interval's thread."""
    rec = profiling.Recorder()
    n = 2000
    barrier = threading.Barrier(3)

    def work():
        barrier.wait(timeout=10)
        for _ in range(n):
            with rec.span("s"):
                pass
            rec.count("c")

    threads = [threading.Thread(target=work, name=f"rec-{i}")
               for i in range(2)]
    with rec.capture() as cap:
        for t in threads:
            t.start()
        work()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert rec.spans()["s"]["count"] == 3 * n
    assert rec.counters() == {"c": 3 * n}
    by_thread = {}
    for _, _, name, thread in cap.intervals:
        assert name == "s"
        by_thread[thread] = by_thread.get(thread, 0) + 1
    assert by_thread == {"rec-0": n, "rec-1": n,
                         threading.current_thread().name: n}


def test_capture_is_bounded_and_silent_when_closed():
    rec = profiling.Recorder()
    with rec.span("before"):
        pass
    with rec.capture(limit=3) as cap:
        for i in range(5):
            rec.record(f"x{i}", float(i), i + 0.5)
        with pytest.raises(RuntimeError, match="already open"):
            with rec.capture():
                pass
    with rec.span("after"):
        pass
    assert [iv[:3] for iv in cap.intervals] == [
        (0.0, 0.5, "x0"), (1.0, 1.5, "x1"), (2.0, 2.5, "x2")]
    assert cap.dropped == 2
    assert rec.spans()["x4"]["count"] == 1   # the aggregates keep all
    with rec.capture() as later:
        pass
    assert later.intervals == [] and later.dropped == 0


def test_spans_are_ranges_inside_a_trace_window_only(tmp_path):
    """Inside ``trace`` (the ``--profile-dir`` window) each span is a
    ``record_function`` range of the trace; outside it a span enters
    none."""
    with profiling.span("train.forward"):
        assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.trace(str(tmp_path)):
        assert profiling.RECORDER.windows == 1
        with profiling.span("train.forward"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        with profiling.span("train.backward"):
            torch.ones(4).sum()
        with profiling.span("feeder.put"):
            torch.ones(4).sum()
    assert profiling.RECORDER.windows == 0
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("train.forward", "train.backward", "feeder.put"):
        assert names.count(name) == 1, name


def test_train_loop_reads_its_own_spans(corpora, tmp_path, capsys):
    """The loop's closing line and ``TrainResult`` carry the run's issue
    medians and Feeder readings; the dev gates' batches stay out of the
    program's recorder, so its puts are the training batches'."""
    _, tds = corpora
    mark = profiling.mark()
    res = train(tds, tds.cfg.replace(dev_start_epoch=0), device="cpu",
                out_dir=str(tmp_path), epochs=1, resume=False)
    out = capsys.readouterr().out
    assert res.gates >= 1
    spans = profiling.spans(since=mark)
    assert spans["feeder.put"]["count"] == res.feeder["batches"] == res.steps
    for part in ("forward", "backward", "optimizer"):
        assert spans[f"train.{part}"]["count"] == res.steps
        assert res.step_ms[part] == pytest.approx(
            1e3 * spans[f"train.{part}"]["median_s"], rel=1e-9)
    assert res.feeder["put_ms"] > 0 and res.feeder["wait_ms"] >= 0
    assert 0 < res.feeder["pool_use"] and 0 <= res.feeder["not_ready_frac"] <= 1
    assert "train.steps" not in profiling.counters(since=mark)   # no card
    assert re.search(r"throughput: .* \| host issue ms: forward [0-9.]+ "
                     r"backward [0-9.]+ optimizer [0-9.]+ \| feeder ms: "
                     r"wait [0-9.]+ put [0-9.]+, pool use [0-9.]+ %, "
                     r"not ready [0-9.]+ %", out), out

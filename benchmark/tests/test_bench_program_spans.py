"""The readers of the program's own spans and counters: None on a record
of another driver, on a recorder without the span or counter, and on a
program without the recorder (the parent of the change that brought
them); the right value on a stubbed recorder. And the shared clock: the
breakdown names an idle gap by a span the program captured."""

import pytest

from benchmark.harness import bench
from benchmark.harness.trace import summarize
from fira_tpu_torch.utils import profiling

MEDIANS = {"fwd_issue_ms.train": "train.forward",
           "bwd_issue_ms.train": "train.backward",
           "opt_issue_ms.train": "train.optimizer",
           "feed_put_ms.train": "feeder.put"}
FRAC = "issue_bound_step_frac.train"
TRAIN = {"driver": "train"}


def reader(name):
    return bench.load_module(bench.piece("metrics", name, ".py")).read


def stub(monkeypatch, spans=None, counters=None):
    monkeypatch.setattr(profiling, "spans", lambda since=None: spans or {})
    monkeypatch.setattr(profiling, "counters",
                        lambda since=None: counters or {})


@pytest.mark.parametrize("name", sorted(MEDIANS) + [FRAC])
def test_nothing_to_read_is_none(monkeypatch, name):
    read = reader(name)
    stub(monkeypatch, spans={"other": {"count": 3, "total_s": 1.0,
                                       "median_s": 0.2}},
         counters={"other": 3})
    assert read(TRAIN) is None
    stub(monkeypatch, spans={s: {"count": 4, "total_s": 1.0,
                                 "median_s": 0.25}
                             for s in MEDIANS.values()},
         counters={"train.steps": 4, "train.issue_bound": 1})
    assert read({"driver": "decode"}) is None
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read(TRAIN) is None


@pytest.mark.parametrize("name", sorted(MEDIANS))
def test_median_in_ms(monkeypatch, name):
    stub(monkeypatch, spans={MEDIANS[name]: {"count": 555, "total_s": 5.0,
                                             "median_s": 0.0125}})
    assert reader(name)(TRAIN) == pytest.approx(12.5)


def test_issue_bound_share(monkeypatch):
    read = reader(FRAC)
    stub(monkeypatch, counters={"train.steps": 8, "train.issue_bound": 2})
    assert read(TRAIN) == pytest.approx(25.0)
    stub(monkeypatch, counters={"train.steps": 8})
    assert read(TRAIN) == 0.0


def test_readers_read_the_real_recorder():
    """Recorded through the program's own API, read back by each reader."""
    profiling.reset()
    for name in MEDIANS.values():
        for d in (0.001, 0.003, 0.002):
            profiling.RECORDER.record(name, 10.0, 10.0 + d)
    profiling.count("train.steps", 4)
    profiling.count("train.issue_bound", 3)
    try:
        for name in MEDIANS:
            assert reader(name)(TRAIN) == pytest.approx(2.0)
        assert reader(FRAC)(TRAIN) == pytest.approx(75.0)
    finally:
        profiling.reset()


def test_breakdown_names_a_gap_by_a_captured_span(monkeypatch):
    """The program's captured intervals share ``perf_counter`` with the
    benchmark's spans, so ``trace.summarize`` names the device's idle gaps
    by them as they are (synthetic device intervals in microseconds): the
    gap inside the backward is the backward's, inside the benchmark's
    wider ``train_step`` span."""
    rec = profiling.Recorder()
    clock = iter([1.000, 1.010, 1.010, 1.030, 1.030, 1.034])
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    with rec.capture() as cap:
        with rec.span("train.forward"):
            pass
        with rec.span("train.backward"):
            pass
        with rec.span("train.optimizer"):
            pass
    host = [(1e6 * a, 1e6 * b, n) for a, b, n, _ in cap.intervals]
    host.append((1e6 * 0.999, 1e6 * 1.035, "train_step"))
    lo, hi = 1e6 * 1.000, 1e6 * 1.035
    dev = [(lo, 1e6 * 1.015, "fwd"), (1e6 * 1.025, 1e6 * 1.0345, "bwd"),
           (1e6 * 1.0345, hi, "adam")]
    out = summarize(dev, host, 0.035, lo, hi)
    assert out["busy_s"] == pytest.approx(0.025)
    assert [n for n, _ in out["idle_gaps"]] == ["train.backward"]
    assert out["idle_gaps"][0][1] == pytest.approx(0.010)

"""The port's Feeder (``fira_tpu_torch.data.feeder``) against the JAX
package's (``fira_tpu.data.feeder``, ``put=False``) on the same corpus and
index chunks:

- the same batches, byte for byte, in the same order, for 0, 1, 2 and 4
  workers, and equal to the inline ``make_batch`` stream the train loop
  assembled before it took a Feeder;
- a failing task raises ``FeederTaskError`` with its note (the JAX note),
  or is emitted in sequence with ``error`` set under ``on_error="record"``;
- retries absorb transient failures;
- no pipeline thread is alive after ``close()``, on every exit path;
- ``put=True`` to the CPU gives ``batch_to_device``'s tensors, bf16 wire
  values as ``torch.bfloat16``;
- the CPU train loop takes the same steps with 0 and 2 workers;
- at 0 and 2 workers, each item's ``stall_s`` is its ``feeder.wait``
  plus its ``feeder.put``, ``feeder.assemble`` counts one successful
  attempt an emitted batch (retries left out), and ``feeder.not_ready``
  counts the batches not ready on the consumer's arrival."""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.data.feeder import assembly_tasks as jax_assembly_tasks
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import epoch_index_chunks, make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import (TRAIN_FIELDS, Feeder, FeederTaskError,
                                        assembly_tasks, batch_to_device)
from fira_tpu_torch.train import loop
from fira_tpu_torch.utils import profiling

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4,
            dropout_rate=0.0, gcn_dropout_rate=0.0)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=40, seed=3)
    synthetic.write_corpus_dir(tdir, n_commits=40, seed=3)
    jds = JaxDataset(jdir, JaxConfig(**GEOM))
    tds = FiraDataset(tdir, FiraConfig(**GEOM))
    return jds, tds


def _chunks(tds, epoch=0):
    cfg = tds.cfg
    return epoch_index_chunks(len(tds.splits["train"]), cfg, shuffle=True,
                              seed=cfg.seed, epoch=epoch)


def _feeder_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("fira-feeder") and t.is_alive()]


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("workers", (0, 1, 2, 4))
def test_batches_equal_jax_feeder_in_order(corpora, workers):
    jds, tds = corpora
    chunks = _chunks(tds, epoch=1)
    bs = tds.cfg.batch_size
    with JaxFeeder(jax_assembly_tasks(jds.splits["train"], chunks, jds.cfg,
                                      batch_size=bs),
                   num_workers=workers, depth=3, put=False) as jf:
        want = [(it.index, it.n_valid, it.host) for it in jf]
    with Feeder(assembly_tasks(tds.splits["train"], chunks, tds.cfg,
                               batch_size=bs),
                num_workers=workers, depth=3, put=False) as feed:
        got = [(it.index, it.n_valid, it.host) for it in feed]
        stats = feed.stats()
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[0] for g in got] == list(range(len(chunks)))
    for (_, _, g), (_, _, w) in zip(got, want):
        _same(g, w)
    assert stats["batches"] == len(chunks)
    assert stats["num_workers"] == workers
    assert not _feeder_threads()


def test_epoch_stream_equals_inline_assembly(corpora):
    """What the loop assembled inline before, batch for batch."""
    _, tds = corpora
    cfg, split = tds.cfg, tds.splits["train"]
    for epoch in (0, 1):
        chunks = _chunks(tds, epoch)
        inline = [make_batch(split, c, cfg, batch_size=cfg.batch_size)
                  for c in chunks]
        with Feeder(assembly_tasks(split, chunks, cfg,
                                   batch_size=cfg.batch_size),
                    num_workers=cfg.feeder_workers, depth=cfg.feeder_depth,
                    put=False) as feed:
            fed = [it.host for it in feed]
        assert len(fed) == len(inline)
        for a, b in zip(fed, inline):
            _same(a, b)


def _failing_tasks(tds, bad: int, fail_times: int, calls: dict):
    split, cfg = tds.splits["train"], tds.cfg
    for i, task in enumerate(assembly_tasks(split, _chunks(tds), cfg,
                                            batch_size=cfg.batch_size)):
        if i == bad:
            def flaky(task=task):
                calls["n"] = calls.get("n", 0) + 1
                if calls["n"] <= fail_times:
                    raise ValueError("poisoned sample")
                return task()
            flaky.note = task.note
            yield flaky
        else:
            yield task


@pytest.mark.parametrize("workers", (0, 2))
def test_failing_task_raises_with_its_note(corpora, workers):
    jds, tds = corpora
    with pytest.raises(FeederTaskError) as exc:
        with Feeder(_failing_tasks(tds, 2, 10**9, {}), num_workers=workers,
                    depth=2, put=False) as feed:
            for _ in feed:
                pass
    err = exc.value
    chunk = _chunks(tds)[2]
    jax_note = list(jax_assembly_tasks(jds.splits["train"], [chunk],
                                       jds.cfg))[0].note
    assert err.index == 2 and err.note == jax_note
    assert isinstance(err.original, ValueError)
    assert "poisoned sample" in str(err) and jax_note in str(err)
    assert not _feeder_threads()


@pytest.mark.parametrize("workers", (0, 2))
def test_record_mode_emits_the_error_in_sequence(corpora, workers):
    _, tds = corpora
    with Feeder(_failing_tasks(tds, 1, 10**9, {}), num_workers=workers,
                depth=2, put=False, on_error="record") as feed:
        items = list(feed)
        stats = feed.stats()
    assert [it.index for it in items] == list(range(len(_chunks(tds))))
    bad = items[1]
    assert isinstance(bad.error, FeederTaskError)
    assert bad.host is None and bad.device is None and bad.n_valid == 0
    assert all(it.error is None for i, it in enumerate(items) if i != 1)
    assert stats["task_errors"] == 1


@pytest.mark.parametrize("workers", (0, 2))
def test_retries_absorb_transient_failures(corpora, workers):
    _, tds = corpora
    calls = {}
    with Feeder(_failing_tasks(tds, 1, 2, calls), num_workers=workers,
                depth=2, put=False, retries=2) as feed:
        items = list(feed)
        stats = feed.stats()
    assert calls["n"] == 3
    assert items[1].retries == 2 and items[1].error is None
    assert stats["task_retries"] == 2
    want = make_batch(tds.splits["train"], _chunks(tds)[1], tds.cfg,
                      batch_size=tds.cfg.batch_size)
    _same(items[1].host, want)


def test_no_thread_left_on_any_exit(corpora):
    _, tds = corpora
    split, cfg = tds.splits["train"], tds.cfg
    tasks = lambda: assembly_tasks(split, _chunks(tds), cfg,  # noqa: E731
                                   batch_size=cfg.batch_size)
    feed = Feeder(tasks(), num_workers=4, depth=2, put=False)
    assert len(_feeder_threads()) == 5          # dispatcher + 4 workers
    list(feed)                                  # exhaustion
    assert not _feeder_threads()
    feed = Feeder(tasks(), num_workers=4, depth=2, put=False)
    next(feed)                                  # early stop
    feed.close()
    feed.close()                                # idempotent
    assert not _feeder_threads()

    def bad_generator():
        yield from list(tasks())[:1]
        raise RuntimeError("task generator broke")

    with pytest.raises(RuntimeError, match="task generator broke"):
        list(Feeder(bad_generator(), num_workers=2, depth=2, put=False))
    assert not _feeder_threads()


def test_order_under_thread_stress():
    """More workers than cores, a short switch interval and tasks that
    finish out of order: every item still comes out once, in order."""
    n = 200

    def tasks():
        for i in range(n):
            def task(i=i):
                time.sleep(random.Random(i).random() * 1e-3)
                return {"valid": np.ones(1, bool), "i": np.array([i])}
            yield task

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with Feeder(tasks(), num_workers=16, depth=8, put=False) as feed:
            got = [int(it.host["i"][0]) for it in feed]
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(n))
    assert not _feeder_threads()


def test_put_to_cpu_gives_batch_to_device(corpora):
    _, tds = corpora
    split = tds.splits["train"]
    for dtype in ("float32", "bfloat16"):
        cfg = tds.cfg.replace(compute_dtype=dtype)
        chunks = _chunks(tds)
        with Feeder(assembly_tasks(split, chunks, cfg,
                                   batch_size=cfg.batch_size),
                    num_workers=2, depth=2, device="cpu",
                    fields=TRAIN_FIELDS) as feed:
            for it in feed:
                want = batch_to_device(it.host, torch.device("cpu"),
                                       TRAIN_FIELDS)
                assert sorted(it.device) == sorted(TRAIN_FIELDS)
                for k, t in it.device.items():
                    assert t.dtype == want[k].dtype and torch.equal(
                        t, want[k]), k
                vals = it.device["values"]
                assert vals.dtype == getattr(torch, dtype)
                f32 = make_batch(split, chunks[it.index], tds.cfg,
                                 batch_size=cfg.batch_size)["values"]
                assert torch.equal(vals, torch.from_numpy(f32).to(vals.dtype))
                assert it.device["diff"].dtype == torch.int64


def test_train_loop_same_steps_with_and_without_workers(corpora, tmp_path):
    """The CPU train loop (dropout off) takes the same losses whether the
    batches come from 2 workers or the loop's own thread, and reports the
    Feeder's stats."""
    _, tds = corpora
    losses = {}
    for workers in (0, 2):
        cfg = tds.cfg.replace(feeder_workers=workers, dev_start_epoch=10**6)
        res = loop.train(tds, cfg, device="cpu",
                         out_dir=str(tmp_path / f"w{workers}"), epochs=1,
                         resume=False)
        losses[workers] = res.losses
        assert res.feeder["batches"] == res.steps == len(_chunks(tds))
        assert res.feeder["num_workers"] == workers
        assert 0.0 <= res.feed_stall_frac <= 1.0
    assert losses[0] == losses[2]
    assert not _feeder_threads()


def test_cli_refuses_bad_feeder_knobs(capsys):
    """A negative worker count exits 2 naming the knob, before any data or
    device is touched; so does a depth below 1 in the config."""
    from fira_tpu_torch import cli
    from fira_tpu_torch.config import unsupported

    assert cli.main(["train", "--device", "cpu", "--feeder-workers",
                     "-1"]) == 2
    assert "feeder_workers=-1" in capsys.readouterr().err
    assert any("feeder_depth=0" in e
               for e in unsupported(FiraConfig(feeder_depth=0)))
    assert not unsupported(FiraConfig(feeder_workers=0))


def _by_thread(intervals, name, thread):
    return [(a, b) for a, b, n, t in intervals if n == name and t == thread]


@pytest.mark.parametrize("workers", (0, 2))
def test_stall_is_wait_plus_put(corpora, workers):
    _, tds = corpora
    split, cfg = tds.splits["train"], tds.cfg
    chunks = _chunks(tds)
    with profiling.capture() as cap:
        with Feeder(assembly_tasks(split, chunks, cfg,
                                   batch_size=cfg.batch_size),
                    num_workers=workers, depth=2, device="cpu",
                    fields=TRAIN_FIELDS) as feed:
            items = list(feed)
    me = threading.current_thread().name
    waits = _by_thread(cap.intervals, "feeder.wait", me)
    puts = _by_thread(cap.intervals, "feeder.put", me)
    assert len(items) == len(waits) == len(puts) == len(chunks)
    for it, (w0, w1), (p0, p1) in zip(items, waits, puts):
        assert w1 <= p0
        assert it.stall_s == (w1 - w0) + (p1 - p0)
    assert feed.stats()["feed_stall_s"] == pytest.approx(
        sum(it.stall_s for it in items), rel=1e-12)


@pytest.mark.parametrize("workers", (0, 2))
def test_assemble_counts_one_an_emitted_batch(corpora, workers):
    """Two failed attempts before the third succeeds: one
    ``feeder.assemble`` a batch, on the workers' threads (the consumer's
    at 0)."""
    _, tds = corpora
    mark = profiling.mark()
    with profiling.capture() as cap:
        with Feeder(_failing_tasks(tds, 1, 2, {}), num_workers=workers,
                    depth=2, put=False, retries=2) as feed:
            items = list(feed)
    assert items[1].retries == 2
    assert profiling.spans(since=mark)["feeder.assemble"]["count"] == len(
        items) == len(_chunks(tds))
    threads = {t for _, _, n, t in cap.intervals if n == "feeder.assemble"}
    if workers:
        assert threads and all(t.startswith("fira-feeder-worker")
                               for t in threads)
    else:
        assert threads == {threading.current_thread().name}


@pytest.mark.parametrize("workers", (0, 2))
def test_not_ready_counts_batches_missing_on_arrival(workers):
    """The first batch waits on a gate that opens after the consumer has
    asked for it: not ready. With workers, the second is assembled while
    the consumer sleeps: ready. Without, no batch is ever ready before it
    is asked for."""
    gate = threading.Event()

    def tasks():
        for i in range(2):
            def task(i=i):
                assert gate.wait(timeout=30)
                return {"valid": np.ones(1, bool), "i": np.array([i])}
            yield task

    mark = profiling.mark()
    opener = threading.Timer(0.2, gate.set)
    with Feeder(tasks(), num_workers=workers, depth=2, put=False) as feed:
        opener.start()
        first = next(feed)
        time.sleep(0.5)          # the workers finish the second batch
        second = next(feed)
    opener.join(timeout=30)
    assert [int(it.host["i"][0]) for it in (first, second)] == [0, 1]
    counts = profiling.counters(since=mark)
    assert counts.get("feeder.not_ready", 0) == (2 if workers == 0 else 1)
    assert profiling.spans(since=mark)["feeder.wait"]["count"] == 2

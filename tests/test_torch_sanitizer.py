"""The port's runtime sanitizer (``fira_tpu_torch/analysis/sanitizer.py``):
one counterpart for each case of the JAX package's
``tests/test_sanitizer.py``, and two held against the JAX package on one
seeded fira-tiny corpus each package writes with its own generator:

- the guard's labels and their dispatch counts (``_seen``) after ``train``
  equal the JAX loop's, at the full geometry and with buckets and
  ``fused_steps=2`` (the pre-warm's declared family included);
- a NaN parameter raises ``FloatingPointError`` in both packages' armed
  train step (JAX: ``jax_debug_nans``; the port: the module hook, naming
  the module).

The JAX runs take most of this file's time (~1.5 min).
"""

import collections
import threading

import jax
import numpy as np
import pytest
import torch

from fira_tpu.analysis import sanitizer as jax_sanitizer
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import buckets as jax_buckets
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.train import step as jax_step
from fira_tpu.train.loop import train as jax_train
from fira_tpu.train.state import init_state as jax_init_state
from fira_tpu_torch.analysis import sanitizer
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, Feeder, batch_to_device
from fira_tpu_torch.data.grouping import stack_group
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.ingest.cache import IngestCache
from fira_tpu_torch.robust.watchdog import WatchdogTimeout, run_with_watchdog
from fira_tpu_torch.train import state as state_lib
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.loop import train

N_COMMITS, SEED, BS = 24, 11, 4


# --------------------------------------------------------------------------
# the signature guard (JAX: compile capture and the compile-count guard)
# --------------------------------------------------------------------------

def test_signature_tells_shapes_dtypes_and_devices_apart():
    """The counterpart of compile capture: what the guard records is the
    inputs' signature, equal for equal geometry and changed by shape,
    dtype or nesting."""
    x = torch.ones(3)
    base = sanitizer.signature(x, {"a": torch.zeros(2, 4, dtype=torch.long)})
    assert base == sanitizer.signature(
        torch.zeros(3), {"a": torch.ones(2, 4, dtype=torch.long)})
    assert base != sanitizer.signature(torch.ones(4), {"a": torch.zeros(2, 4)})
    assert base != sanitizer.signature(
        x, {"a": torch.zeros(2, 4, dtype=torch.int32)})
    assert base[0] == ((3,), "torch.float32", "cpu")
    assert sanitizer.signature(np.zeros((2,), np.int32))[0][:2] == (
        (2,), "int32")
    assert sanitizer.signature(None, 3) == ("NoneType", "int")


def test_guard_allows_warmup_then_raises_on_retrace():
    guard = sanitizer.CompileGuard()
    guard.step("f", torch.ones(2))        # warmup: the signature is taken
    guard.step("f", torch.zeros(2))       # steady state: same signature
    with pytest.raises(sanitizer.RetraceError, match="program 'f'") as ei:
        guard.step("f", torch.ones(5))    # shape drift
    assert "(2,)" in str(ei.value) and "(5,)" in str(ei.value)
    assert guard.compiles_after_warmup() == 1


def test_guard_is_per_label_and_closes_over_declared_labels():
    """A second program's first dispatch is its own warmup, whatever its
    shapes; after declare(), an undeclared label raises, and the declare
    is additive."""
    guard = sanitizer.CompileGuard()
    guard.step("f", torch.ones(2))
    guard.step("g", torch.ones(7))        # late first dispatch of another
    guard.step("f", torch.ones(2))
    assert not guard.family_closed
    guard.declare(["f", "g"])
    assert guard.family_closed
    with pytest.raises(sanitizer.RetraceError, match="not in the declared"):
        guard.step("h", torch.ones(1))
    guard.declare(["h"])
    guard.step("h", torch.ones(1))
    assert guard._seen == {"f": 2, "g": 1, "h": 1}
    assert guard.compiles_after_warmup() == 0
    assert (sanitizer.program_label("grouped_step", "a16.e256.t8", 8)
            == jax_sanitizer.program_label("grouped_step", "a16.e256.t8", 8)
            == "grouped_step[a16.e256.t8.g8]")
    for args in [("train_step",), ("train_step", "a1.e2.t3"),
                 ("grouped_step", None, 2)]:
        assert (sanitizer.program_label(*args)
                == jax_sanitizer.program_label(*args))


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


class _Outer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = torch.nn.Sequential(torch.nn.Identity(), _Log())

    def forward(self, x):
        return self.inner(x) + 1.0


def test_sanitize_restores_hooks_and_catches_nans():
    """The counterpart of jax_debug_nans: a module whose output holds a
    NaN (or an Inf) raises FloatingPointError naming it; the backward's NaN
    is re-raised as FloatingPointError; on exit the hooks, the anomaly mode
    and the guards are as before."""
    m = _Outer()
    with sanitizer.sanitize() as guard:
        assert guard is not None and sanitizer.nan_check() is not None
        assert sanitizer.thread_guard() and sanitizer.leak_guard()
        with pytest.raises(FloatingPointError,
                           match=r"'_Outer\.inner\.1' \(_Log\) produced NaN"):
            m(torch.tensor([-1.0, 1.0]))
        with pytest.raises(FloatingPointError, match="produced Inf"):
            m(torch.tensor([0.0, 1.0]))
        m(torch.tensor([1.0, 2.0]))      # finite: no raise
        w = torch.tensor([1.0], requires_grad=True)
        with pytest.raises(FloatingPointError, match="backward produced NaN"):
            sanitizer.backward((torch.sqrt(w - 1.0) * 0.0).sum())
    with sanitizer.sanitize(nans=False, infs=True):
        m(torch.tensor([-1.0, 1.0]))     # NaN not checked
        with pytest.raises(FloatingPointError, match="produced Inf"):
            m(torch.tensor([0.0, 1.0]))
    assert sanitizer.nan_check() is None
    assert sanitizer.thread_guard() is None and sanitizer.leak_guard() is None
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(m(torch.tensor([-1.0]))).all()   # hooks are gone
    with sanitizer.sanitize(enabled=False) as guard:
        assert guard is None and sanitizer.nan_check() is None


# --------------------------------------------------------------------------
# the train loop's labels, against the JAX loop's
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_san"))
    tdir = str(tmp_path_factory.mktemp("torch_san"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=N_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=N_COMMITS, seed=SEED)
    jds = JaxDataset(jdir, jax_fira_tiny(batch_size=BS))
    tds = FiraDataset(tdir, fira_tiny(batch_size=BS))
    table = B.choose_buckets(tds.splits["train"], tds.cfg)
    assert table == jax_buckets.choose_buckets(jds.splits["train"], jds.cfg)
    assert len(table) >= 1
    return dict(jds=jds, tds=tds, table=table)


def _guarded_runs(tiny, out_dir, bucketed):
    """One epoch of each package's train loop under its guard, at the full
    geometry or with buckets and ``fused_steps=2``: (JAX guard, port
    guard, port result)."""
    knobs = dict(dev_start_epoch=0, dev_every_batches=4)
    if bucketed:
        knobs.update(buckets=tiny["table"], fused_steps=2)
    jcfg = tiny["jds"].cfg.replace(**knobs)
    tcfg = tiny["tds"].cfg.replace(**knobs)
    with jax_sanitizer.sanitize(nans=False, infs=False) as jguard:
        jax_train(tiny["jds"], jcfg, out_dir=f"{out_dir}/jax", epochs=1,
                  resume=False, guard=jguard)
    with sanitizer.sanitize(nans=False, infs=False) as tguard:
        result = train(tiny["tds"], tcfg, device="cpu",
                       out_dir=f"{out_dir}/torch", epochs=1, resume=False,
                       guard=tguard)
    return jguard, tguard, result


@pytest.fixture(scope="module")
def full_runs(tiny, tmp_path_factory):
    return _guarded_runs(tiny, str(tmp_path_factory.mktemp("full")), False)


def test_guard_wiring_through_train_loop(full_runs):
    """train() steps the guard at every dispatch site (train_step and
    dev_step) without a raise on a healthy run."""
    _, guard, result = full_runs
    assert result.epochs_run == 1
    assert guard._seen.get("train_step", 0) >= 2
    assert guard._seen.get("dev_step", 0) >= 1
    assert guard.compiles_after_warmup() == 0


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["full", "buckets_fused2"])
def test_guard_labels_and_counts_match_jax(tiny, full_runs, tmp_path,
                                           bucketed):
    """The same corpus, config and epoch through both loops under the
    guard: every label (bucket tags and group sizes included) and its
    dispatch count equal; bucketed, each declared label's pre-warm step
    counts once in both."""
    jguard, tguard, _ = (_guarded_runs(tiny, str(tmp_path), True)
                         if bucketed else full_runs)
    assert tguard._seen == jguard._seen
    assert tguard._declared == jguard._declared
    assert tguard.compiles_after_warmup() == 0
    if bucketed:
        assert any(k.startswith("grouped_step[") for k in tguard._seen)


def test_signature_count_regression_unfused_and_fused(tiny):
    """The fixed-geometry contract over the real steps: N dispatches of
    each program hold the warmup's signature."""
    ds = tiny["tds"]
    cfg, split = ds.cfg, ds.splits["train"]
    rng = np.random.RandomState(0)

    def fresh_batch():
        return make_batch(split, rng.choice(len(split), cfg.batch_size,
                                            replace=True), cfg)

    state = state_lib.init_state(cfg, "cpu")
    guard = sanitizer.CompileGuard()
    for i in range(3):
        batch = batch_to_device(fresh_batch(), torch.device("cpu"),
                                TRAIN_FIELDS)
        step_lib.train_step(state.model, state.optimizer, batch,
                            state.generator)
        assert guard.step_counting("train_step", batch) == 0, i
    for i in range(2):
        stacked = batch_to_device(stack_group([fresh_batch(), fresh_batch()]),
                                  torch.device("cpu"), TRAIN_FIELDS)
        step_lib.multi_step(state.model, state.optimizer, stacked,
                            state.generator)
        assert guard.step_counting("grouped_step", stacked) == 0, i
    assert guard.compiles_after_warmup() == 0
    assert guard._seen == {"train_step": 3, "grouped_step": 2}


def _port_step(tds, idx, nan_param: str):
    """One armed port train step with ``nan_param`` set to NaN."""
    cfg = tds.cfg
    state = state_lib.init_state(cfg, "cpu")
    with torch.no_grad():
        state.model.get_parameter(nan_param).fill_(float("nan"))
    batch = batch_to_device(make_batch(tds.splits["train"], idx, cfg),
                            torch.device("cpu"), TRAIN_FIELDS)
    return lambda: step_lib.train_step(state.model, state.optimizer, batch,
                                       state.generator)


def test_nan_parameter_raises_in_both_packages(tiny):
    """One armed train step with the word embedding set to NaN: JAX's
    jax_debug_nans and the port's module hook both raise
    FloatingPointError, the port naming the first module whose output is
    NaN. With the copy head's score weight NaN instead, the port names
    K1's module, the copy head; unarmed, the step runs on to a NaN
    loss."""
    jds, tds = tiny["jds"], tiny["tds"]
    jcfg = jds.cfg
    idx = np.arange(BS)
    jbatch = jax_make_batch(jds.splits["train"], idx, jcfg)
    jmodel = JaxModel(jcfg)
    jstate = jax_init_state(jmodel, jcfg, jbatch)
    params = jax.tree_util.tree_map(lambda x: x, jstate.params)
    table = params["encoder"]["word_embed"]["embedding"]
    params["encoder"]["word_embed"]["embedding"] = table * np.nan
    jstate = jstate.replace(params=params)
    step = jax.jit(jax_step.make_train_step(jmodel, jcfg))
    with jax_sanitizer.sanitize():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(step(jstate, jbatch))

    with sanitizer.sanitize():
        with pytest.raises(FloatingPointError,
                           match=r"'FiraModel\.encoder\.combination_0\.q_proj' "
                                 r"\(Dense\) produced NaN"):
            _port_step(tds, idx, "encoder.word_embed.weight")()
        with pytest.raises(FloatingPointError,
                           match=r"'FiraModel\.copy_net' \(CopyNet\)"):
            _port_step(tds, idx, "copy_net.score.weight")()
    assert torch.isnan(_port_step(tds, idx, "copy_net.score.weight")())


# --------------------------------------------------------------------------
# ThreadGuard: the lock-discipline sanitizer
# --------------------------------------------------------------------------

def test_thread_guard_lockless_mutation_raises_and_locked_passes():
    tg = sanitizer.ThreadGuard()
    lock = tg.lock(threading.Lock(), "L")
    d = tg.wrap({}, lock, "D")
    with pytest.raises(sanitizer.LockDisciplineError) as ei:
        d["x"] = 1
    assert "without holding its owning lock" in str(ei.value)
    assert tg.violations and tg.violations[0]["structure"] == "D"
    with lock:
        d["x"] = 1
        d.pop("x")
        d.setdefault("y", 2)
    assert dict(d) == {"y": 2}
    c = tg.wrap(collections.Counter(), lock, "C")
    with pytest.raises(sanitizer.LockDisciplineError):
        c["site"] += 1
    with lock:
        c["site"] += 1
    assert c["site"] == 1


def test_thread_guard_cross_thread_violation_names_the_thread():
    tg = sanitizer.ThreadGuard()
    lock = tg.lock(threading.Lock(), "L")
    d = tg.wrap({}, lock, "D")
    box = {}

    def worker():
        try:
            d["k"] = 1   # no lock held on this thread
        except sanitizer.LockDisciplineError as e:
            box["err"] = str(e)

    with lock:  # holding it on the main thread authorizes no other
        t = threading.Thread(target=worker, name="rogue")
        t.start()
        t.join()
    assert "rogue" in box["err"]


def test_thread_guard_records_lock_order_inversion():
    tg = sanitizer.ThreadGuard()
    a = tg.lock(threading.Lock(), "A")
    b = tg.lock(threading.Lock(), "B")
    with a:
        with b:
            pass
    assert not tg.inversions
    with b:
        with a:
            pass
    assert len(tg.inversions) == 1
    assert tg.summary()["inversions"]


def test_thread_guard_unarmed_is_plain_and_armed_wraps():
    c = IngestCache(entries=4)
    assert type(c._lru) is collections.OrderedDict
    assert not isinstance(c._lock, sanitizer._GuardedLock)
    with sanitizer.thread_guarding() as tg:
        g = IngestCache(entries=4)
        assert isinstance(g._lock, sanitizer._GuardedLock)
        g.put("d", {"x": np.zeros(3, np.int32)})
        out, outcome = g.take("d")
        assert outcome == "hit" and out is not None
        with pytest.raises(sanitizer.LockDisciplineError):
            g._lru["evil"] = None
        assert tg.violations
    assert type(IngestCache(entries=4)._lru) is collections.OrderedDict


def _tasks(n):
    return ((lambda i=i: {"valid": np.ones(2, bool),
                          "payload": np.full(3, i)}) for i in range(n))


def test_thread_guard_feeder_ordered_channel_guarded():
    """The feeder's ready channel works under the guard (every write site
    holds the condition), and the stream keeps its order."""
    with sanitizer.thread_guarding():
        with Feeder(_tasks(8), num_workers=3, depth=2, put=False) as feed:
            assert isinstance(feed._cond, sanitizer._GuardedLock)
            order = [item.index for item in feed]
    assert order == list(range(8))


# --------------------------------------------------------------------------
# LeakGuard: the resource-lifecycle sanitizer
# --------------------------------------------------------------------------

def test_leak_guard_assert_clean_names_the_acquire_site():
    with sanitizer.leak_guarding() as lg:
        lg.note_acquire("block", "engine@0:7", what="paged block 7")
        with pytest.raises(sanitizer.LeakError) as ei:
            lg.assert_clean("test teardown")
        msg = str(ei.value)
        assert "paged block 7" in msg
        assert "block 'engine@0:7'" in msg
        assert "test_torch_sanitizer.py" in msg
        assert "RES-LEAK discipline" in msg
        lg.note_release("block", "engine@0:7")
        lg.assert_clean("test teardown")
        s = lg.summary()
        assert s["acquires"] == 1 and s["releases"] == 1
        assert s["open"] == 0 and s["unmatched_releases"] == 0


def test_leak_guard_feeder_threads_check_in_and_out():
    with sanitizer.leak_guarding() as lg:
        with Feeder(_tasks(6), num_workers=2, depth=2, put=False) as feed:
            order = [item.index for item in feed]
        lg.assert_clean("feeder teardown")
        assert lg.summary()["acquires"] >= 2
    assert order == list(range(6))


def test_leak_guard_unjoined_thread_raises_at_teardown():
    gate = threading.Event()
    with sanitizer.leak_guarding() as lg:
        t = threading.Thread(target=gate.wait, daemon=True)
        t.start()
        lg.track_thread(t, what="planted worker thread")
        with pytest.raises(sanitizer.LeakError) as ei:
            lg.assert_clean("planted teardown")
        assert "planted worker thread" in str(ei.value)
        gate.set()
        t.join()
        lg.note_joined(t)
        lg.assert_clean("planted teardown")


def test_leak_guard_watchdog_abandonment_is_sanctioned():
    """A blown dispatch abandons its daemon thread by design: the ledger
    records the sanction instead of a leak."""
    release = threading.Event()
    with sanitizer.leak_guarding() as lg:
        with pytest.raises(WatchdogTimeout):
            run_with_watchdog(release.wait, 0.05, label="test-hang")
        lg.assert_clean("watchdog teardown")
        s = lg.summary()
        assert s["abandoned"] == 1 and s["open"] == 0
    release.set()


def test_leak_guard_unarmed_owners_carry_none_and_allocate_no_guard(
        monkeypatch):
    """Unarmed, owners capture None at construction and no LeakGuard is
    ever allocated."""
    created = []
    orig_init = sanitizer.LeakGuard.__init__

    def spy(self, *a, **k):
        created.append(self)
        return orig_init(self, *a, **k)

    monkeypatch.setattr(sanitizer.LeakGuard, "__init__", spy)
    assert sanitizer.leak_guard() is None
    with Feeder(_tasks(4), num_workers=2, depth=2, put=False) as feed:
        order = [item.index for item in feed]
    assert order == list(range(4))
    assert feed._leaks is None
    assert not created

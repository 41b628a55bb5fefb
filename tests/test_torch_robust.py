"""The port's fault injection and degradation (``fira_tpu_torch/robust``,
the Feeder's fault hooks, the engine's retirement, the serve loop's
quarantine) against the JAX package's, on the same corpus and weights
(``convert.params_from_flax``) at the JAX tests' widths
(tests/test_robust.py):

- the spec grammar and ``robust_errors`` in the JAX package's words, the
  ingest sites parsed as JAX parses them, and the sites the port does
  not wire refused naming their ROADMAP item;
- the injector fires at the same event keys as JAX's for one seed, and a
  corrupt scrambles the same bytes;
- the watchdog inline, through a thread, with an exception and on
  timeout (its cancel event set);
- serve runs with a fault armed at each of the seven serve-path sites
  (the ingest sites: tests/test_torch_serve_diffs.py) give the
  JAX package's fired counts, completions, sheds and per-request
  statuses on one replayed trace (virtual clock), and every completed
  position the no-fault bytes;
- a raising step retires the one engine and sheds the rest with the
  reason; a hang past the watchdog does too, in bounded time;
- the train loop's dev gate under the watchdog is skipped with a warning;
- ``serve_metrics.json`` is written atomically, and an aborted run leaves
  the writer's ``.partial`` and a valid ``.partial`` metrics snapshot."""

import dataclasses
import json
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.data.synthetic import write_corpus_dir
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.robust import faults as jax_faults
from fira_tpu.robust.watchdog import WatchdogTimeout as JaxWatchdogTimeout
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder, FeederTaskError
from fira_tpu_torch.decode.runner import run_test
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import faults
from fira_tpu_torch.robust.watchdog import WatchdogTimeout, run_with_watchdog
from fira_tpu_torch.serve import poisson_times, serve_split
from fira_tpu_torch.serve.server import write_metrics_atomic

KNOBS = dict(batch_size=8, test_batch_size=6, decode_engine=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine runs many tiny ops, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tests' corpus (40 commits, seed 13) and widths, seeded
    weights biased toward <eos> (mixed settle depths) in both packages,
    and a replayed trace."""
    d = str(tmp_path_factory.mktemp("chaos_corpus"))
    write_corpus_dir(d, n_commits=40, seed=13)
    jds = JaxDataset(d, jax_fira_tiny(**KNOBS))
    tds = FiraDataset(d, fira_tiny(**KNOBS))
    batch = make_batch(tds.splits["train"], np.arange(6), tds.cfg)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(0), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = eos_biased_params(params, delta=4.0)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    trace = poisson_times(len(tds.splits["train"]), rate=0.4, seed=3)
    drain = run_test(model, tds, tds.cfg, out_dir=str(tmp_path_factory
                                                      .mktemp("drain")),
                     split="train")
    lines = open(drain["output_path"]).read().split("\n")
    return dict(jds=jds, tds=tds, params=params, model=model, trace=trace,
                lines=lines, dir=d)


def repeats(setup, knobs):
    """A request mix with repeats (each of the first 10 samples 3 or 4
    times) when the prefix cache is on, so cache lookups happen."""
    if not knobs.get("prefix_cache"):
        return None
    return np.arange(len(setup["trace"])) % 10


def port_serve(setup, tmp, mix=None, **knobs):
    return serve_split(setup["model"], setup["tds"],
                       setup["tds"].cfg.replace(**knobs),
                       arrival_times=setup["trace"], out_dir=str(tmp),
                       split="train", clock="virtual",
                       request_mix=(repeats(setup, knobs) if mix is None
                                    else mix))


def jax_serve(setup, tmp, **knobs):
    cfg = setup["jds"].cfg.replace(**knobs)
    return jax_serve_split(JaxModel(cfg), setup["params"], setup["jds"], cfg,
                           arrival_times=setup["trace"], out_dir=str(tmp),
                           split="train", clock="virtual",
                           request_mix=repeats(setup, knobs))


def assert_degraded_bytes(m, ref_lines):
    """Shed positions hold empty lines; every completed position holds the
    no-fault line."""
    got = open(m["output_path"]).read().split("\n")
    assert len(got) == len(ref_lines)
    shed = {r["position"] for r in m["request_records"]
            if r["status"] != "done"}
    for pos, (a, b) in enumerate(zip(ref_lines, got)):
        assert b == ("" if pos in shed else a), pos


# --------------------------------------------------------------------------
# the spec grammar and the knob checks
# --------------------------------------------------------------------------

BAD_SPECS = [
    "feeder.assemble:raise:0.1",
    "nowhere:raise:0.1:7",
    "engine.step:explode:0.1:7",
    "engine.step:corrupt:0.1:7",
    "engine.step:raise:1.5:7",
    "engine.step:raise:x:7",
    "engine.step:raise:0.1:x",
    "engine.step:raise:0.1:7,engine.step:raise:0.2:8",
]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_fault_spec_rejected_in_the_jax_words(bad):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_fault_specs(bad)
    with pytest.raises(ValueError) as got:
        faults.parse_fault_specs(bad)
    assert str(got.value) == str(want.value)


def test_fault_spec_parses_like_jax():
    spec = ("feeder.assemble:raise:0.1:7, engine.step:hang:1:0,"
            "cache.lookup:corrupt:0.5:3")
    got = faults.parse_fault_specs(spec)
    want = jax_faults.parse_fault_specs(spec)
    assert ([dataclasses.astuple(s) for s in got]
            == [dataclasses.astuple(s) for s in want])
    assert faults.SITES == jax_faults.SITES
    assert faults.KINDS == jax_faults.KINDS
    assert faults.CORRUPT_SITES == jax_faults.CORRUPT_SITES


@pytest.mark.parametrize("site", ["ingest.parse", "ingest.cache"])
def test_ingest_sites_parse_like_jax(site):
    """The raw-diff ingest sites are wired: each kind parses and passes
    ``robust_errors`` exactly as in the JAX package."""
    for kind in ("raise", "hang", "corrupt"):
        spec = f"{site}:{kind}:0.1:7, engine.step:raise:0.5:1"
        got = faults.parse_fault_specs(spec)
        want = jax_faults.parse_fault_specs(spec)
        assert ([dataclasses.astuple(s) for s in got]
                == [dataclasses.astuple(s) for s in want])
        assert (faults.robust_errors(fira_tiny(inject_faults=spec))
                == jax_faults.robust_errors(jax_fira_tiny(inject_faults=spec))
                == [])
    assert site not in faults.UNWIRED_SITES and site in faults.CORRUPT_SITES


def test_fleet_replica_parses_as_jax():
    """``fleet.replica`` is wired: every kind parses as the JAX package
    parses it (corrupt refused in its words: a dispatch boundary owns no
    payload)."""
    for kind in ("raise", "hang"):
        spec = f"fleet.replica:{kind}:0.25:7"
        assert ([dataclasses.astuple(s)
                 for s in faults.parse_fault_specs(spec)]
                == [dataclasses.astuple(s)
                    for s in jax_faults.parse_fault_specs(spec)])
        assert faults.robust_errors(fira_tiny(inject_faults=spec)) == []
    spec = "fleet.replica:corrupt:0.25:7"
    assert (faults.robust_errors(fira_tiny(inject_faults=spec))
            == jax_faults.robust_errors(jax_fira_tiny(inject_faults=spec)))
    assert "fleet.replica" not in faults.UNWIRED_SITES


@pytest.mark.parametrize("site", ["disagg.transport", "disagg.worker"])
def test_disagg_site_parses_as_jax(site):
    """The prefill tier's sites are wired: each kind the JAX package
    takes there parses to its specs (``corrupt`` only at the transport,
    which owns a payload; both packages refuse it at the worker in the
    same words), and nothing is left unwired."""
    for kind in ("raise", "hang", "corrupt"):
        spec = f"{site}:{kind}:0.1:7"
        errs = faults.robust_errors(fira_tiny(inject_faults=spec))
        assert errs == jax_faults.robust_errors(jax_fira_tiny(
            inject_faults=spec))
        assert bool(errs) == (kind == "corrupt"
                              and site not in faults.CORRUPT_SITES)
        if not errs:
            assert ([dataclasses.astuple(s)
                     for s in faults.parse_fault_specs(spec)]
                    == [dataclasses.astuple(s)
                        for s in jax_faults.parse_fault_specs(spec)])
    assert faults.UNWIRED_SITES == {}
    assert faults.SITES == jax_faults.SITES


@pytest.mark.parametrize("knobs", [
    {}, dict(inject_faults="bogus"), dict(dispatch_watchdog_s=-1.0),
    dict(robust_retries=-1), dict(fault_hang_s=0.0),
    dict(inject_faults="engine.step:raise:2:0", robust_retries=-3)])
def test_robust_errors_equal_jax(knobs):
    assert (faults.robust_errors(fira_tiny(**knobs))
            == jax_faults.robust_errors(jax_fira_tiny(**knobs)))


def test_backoff_curve_is_jax_and_the_feeders():
    from fira_tpu_torch.data import feeder

    for a in range(8):
        assert faults.backoff_s(a) == jax_faults.backoff_s(a)
    assert feeder.backoff_s is faults.backoff_s   # one definition


# --------------------------------------------------------------------------
# injector determinism, against the JAX draws
# --------------------------------------------------------------------------

def fire_pattern(lib, spec, site, keys):
    inj = lib.FaultInjector(lib.parse_fault_specs(spec))
    out = []
    for k in keys:
        try:
            inj.check(site, key=k)
            out.append(False)
        except lib.InjectedFault:
            out.append(True)
    return out, inj.summary(), dict(inj.fired_keys)


@pytest.mark.parametrize("spec,site,keys", [
    ("engine.step:raise:0.3:42", "engine.step", [None] * 60),
    ("serve.admit:raise:0.08:13", "serve.admit", [None] * 60),
    ("feeder.assemble:raise:0.1:7", "feeder.assemble",
     [(s, a) for s in range(30) for a in range(2)]),
    ("feeder.device_put:raise:0.2:5", "feeder.device_put",
     [(s, 0) for s in range(40)]),
])
def test_injector_fires_at_the_jax_keys(spec, site, keys):
    got = fire_pattern(faults, spec, site, keys)
    want = fire_pattern(jax_faults, spec, site, keys)
    assert got == want
    assert sum(got[0]) > 0
    # an unarmed site never fires
    faults.FaultInjector(faults.parse_fault_specs(spec)).check(
        "engine.harvest")


def test_corrupt_scrambles_the_jax_bytes():
    spec = "feeder.assemble:corrupt:0.5:7"
    inj = faults.FaultInjector(faults.parse_fault_specs(spec))
    jinj = jax_faults.FaultInjector(jax_faults.parse_fault_specs(spec))
    rng = np.random.default_rng(0)
    fired = 0
    for seq in range(16):
        batch = {"diff": rng.integers(0, 50, (1, 9)).astype(np.int16),
                 "sub_token": rng.integers(0, 50, (1, 5)).astype(np.int16),
                 "valid": np.ones(1, bool)}
        got = inj.corrupt("feeder.assemble", seq, dict(batch))
        want = jinj.corrupt("feeder.assemble", seq, dict(batch))
        for k in batch:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        fired += got is not batch and not np.array_equal(got["diff"],
                                                         batch["diff"])
    assert fired == inj.summary()["feeder.assemble"] > 0
    inj.check("feeder.assemble", key=0)   # raise/hang ignore a corrupt spec


# --------------------------------------------------------------------------
# the watchdog
# --------------------------------------------------------------------------

def test_watchdog_inline_value_exception_and_timeout():
    import threading

    assert run_with_watchdog(lambda: 7, 0.0) == 7       # inline, off
    assert run_with_watchdog(lambda: 7, 5.0) == 7       # threaded
    with pytest.raises(KeyError, match="boom"):
        run_with_watchdog(lambda: (_ for _ in ()).throw(KeyError("boom")),
                          5.0)
    cancel = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(WatchdogTimeout, match="slow") as got:
        run_with_watchdog(lambda: time.sleep(3.0), 0.1, label="slow",
                          cancel_event=cancel)
    assert time.perf_counter() - t0 < 1.0   # abandoned, not awaited
    assert cancel.is_set()
    from fira_tpu.robust.watchdog import run_with_watchdog as jax_run

    with pytest.raises(JaxWatchdogTimeout) as want:
        jax_run(lambda: time.sleep(3.0), 0.1, label="slow")
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the Feeder's fault sites, against the JAX Feeder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec,retries", [
    ("feeder.assemble:raise:0.3:7", 0), ("feeder.assemble:raise:0.3:7", 2),
    ("feeder.device_put:raise:0.3:5", 1),
    ("feeder.assemble:corrupt:0.3:7", 0)])
def test_feeder_sites_fire_as_jax(spec, retries):
    def tasks():
        for i in range(12):
            def task(i=i):
                return {"valid": np.ones(1, bool),
                        "diff": np.arange(i, i + 4)[None],
                        "sub_token": np.arange(3)[None]}
            task.note = f"split positions [{i}]"
            yield task

    def run(feeder_cls, lib):
        inj = lib.FaultInjector(lib.parse_fault_specs(spec))
        kw = {} if feeder_cls is JaxFeeder else {"device": "cpu"}
        with feeder_cls(tasks(), num_workers=2, put=False, on_error="record",
                        retries=retries, faults=inj, **kw) as feed:
            items = [(it.error is None, it.retries,
                      None if it.host is None else it.host["diff"].tolist())
                     for it in feed]
        return items, inj.summary(), sorted(
            (s, sorted(map(str, k))) for s, k in inj.fired_keys.items())

    got = run(Feeder, faults)
    assert got == run(JaxFeeder, jax_faults)
    assert sum(got[1].values()) > 0


def test_feeder_errors_name_the_task():
    inj = faults.FaultInjector(faults.parse_fault_specs(
        "feeder.assemble:raise:1:0"))

    def task():
        return {"valid": np.ones(1, bool)}
    task.note = "split positions [3]; serve request"
    with Feeder([task], num_workers=0, put=False, faults=inj,
                on_error="record") as feed:
        item = next(feed)
    assert isinstance(item.error, FeederTaskError)
    assert "split positions [3]" in str(item.error)
    assert "injected fault at feeder.assemble" in str(item.error)


# --------------------------------------------------------------------------
# serving under faults: the JAX package's counts and statuses
# --------------------------------------------------------------------------

SITE_RUNS = [
    dict(inject_faults="feeder.assemble:raise:0.1:7", robust_retries=0),
    dict(inject_faults="feeder.assemble:raise:0.1:7", robust_retries=2),
    dict(inject_faults="feeder.device_put:raise:0.15:4", robust_retries=0),
    dict(inject_faults="feeder.assemble:corrupt:0.08:7"),
    dict(inject_faults="engine.prefill:raise:0.15:9", robust_retries=1),
    dict(inject_faults="serve.admit:raise:0.08:13", robust_retries=1),
    dict(inject_faults="engine.harvest:raise:0.02:7"),
    dict(inject_faults="cache.lookup:corrupt:1:2", prefix_cache=True),
    dict(inject_faults="cache.lookup:raise:0.5:2", prefix_cache=True),
]


@pytest.mark.parametrize("knobs", SITE_RUNS,
                         ids=[k["inject_faults"].split(":")[0] + "-"
                              + k["inject_faults"].split(":")[1]
                              + f"-{i}" for i, k in enumerate(SITE_RUNS)])
def test_serve_under_faults_gives_the_jax_counts(setup, tmp_path, knobs):
    got = port_serve(setup, tmp_path / "port", **knobs)
    want = jax_serve(setup, tmp_path / "jax", **knobs)
    assert got["faults"] == want["faults"]
    assert sum(got["faults"].values()) > 0
    for key in ("offered", "completed", "shed_error", "request_retries",
                "replica_retirements", "completion_order"):
        assert got["serve"][key] == want["serve"][key], key
    assert ([r["status"] for r in got["request_records"]]
            == [r["status"] for r in want["request_records"]])
    assert ([r["retries"] for r in got["request_records"]]
            == [r["retries"] for r in want["request_records"]])
    for key in ("cache_hits", "cache_integrity_drops", "dedup_fanout",
                "prefills_saved"):
        assert got["engine"][key] == want["engine"][key], key
    if "feeder.assemble:corrupt" in knobs["inject_faults"]:
        # a scrambled payload decodes to its own (garbage) line only
        assert got["serve"]["completed"] == got["serve"]["offered"]
        ref = open(want["output_path"]).read()
        assert open(got["output_path"]).read() == ref
    elif "cache.lookup" in knobs["inject_faults"]:
        # a cache fault is a miss, never a wrong answer: the bytes of the
        # same mix with the cache off
        off = port_serve(setup, tmp_path / "off",
                         mix=repeats(setup, knobs), prefix_cache=False)
        assert (open(got["output_path"]).read()
                == open(off["output_path"]).read())
        assert (got["engine"]["cache_integrity_drops"]
                or "raise" in knobs["inject_faults"])
    else:
        assert_degraded_bytes(got, setup["lines"])


def test_engine_retirement_sheds_the_rest_with_the_reason(setup, tmp_path):
    """A step that raises retires the one engine: every request still
    owed is shed with the reason, as JAX does when every replica is
    lost; the output stays position-complete."""
    knobs = dict(inject_faults="engine.step:raise:0.05:18")
    got = port_serve(setup, tmp_path / "port", **knobs)
    want = jax_serve(setup, tmp_path / "jax", **knobs)
    sv = got["serve"]
    assert got["faults"] == want["faults"] == {"engine.step": 1}
    assert sv["replica_retirements"] == 1 and sv["retired_replicas"] == ["r0"]
    assert 0 < sv["completed"] < sv["offered"]
    assert sv["completed"] + sv["shed_error"] == sv["offered"]
    for key in ("completed", "shed_error", "requeued_requests",
                "completion_order", "replicas_alive_over_time"):
        assert sv[key] == want["serve"][key], key
    recs = got["request_records"]
    assert ([(r["status"], r["requeues"], r["error"]) for r in recs]
            == [(r["status"], r["requeues"], r["error"])
                for r in want["request_records"]])
    shed = [r for r in recs if r["status"] == "shed_error"]
    assert all("no live replicas" in r["error"]
               and "engine.step" in r["error"] for r in shed)
    assert all(math.isnan(r["done_t"]) for r in shed)
    assert_degraded_bytes(got, setup["lines"])


def test_watchdog_retires_a_hung_engine_in_bounded_time(setup, tmp_path):
    """An injected hang past the watchdog: the step is abandoned (the
    sleeping thread sees ``retired`` when it wakes and launches nothing),
    the engine retired, the rest shed with the reason; the run ends long
    before the hang would."""
    knobs = dict(inject_faults="engine.step:hang:0.05:18", fault_hang_s=6.0,
                 dispatch_watchdog_s=1.5)
    t0 = time.perf_counter()
    got = port_serve(setup, tmp_path, **knobs)
    assert time.perf_counter() - t0 < 30
    sv = got["serve"]
    assert got["faults"] == {"engine.step": 1}
    assert sv["replica_retirements"] == 1
    assert "WatchdogTimeout" in got["request_records"][-1]["error"]
    assert sv["completed"] + sv["shed_error"] == sv["offered"]
    assert_degraded_bytes(got, setup["lines"])


# --------------------------------------------------------------------------
# the train loop's dev gate under the watchdog
# --------------------------------------------------------------------------

def test_train_dev_gate_watchdog_skips_wedged_gate(setup, tmp_path,
                                                   monkeypatch):
    import fira_tpu_torch.train.loop as loop_mod

    cfg = setup["tds"].cfg.replace(epochs=1, dev_start_epoch=0,
                                   dev_every_batches=2,
                                   dispatch_watchdog_s=0.1,
                                   feeder_workers=0)

    def wedged_dev(*a, **k):
        time.sleep(2.0)
        return 0.5, "never observed\n", 1

    monkeypatch.setattr(loop_mod, "run_dev", wedged_dev)
    result = loop_mod.train(setup["tds"], cfg, device="cpu",
                            out_dir=str(tmp_path / "OUT"), resume=False)
    assert result.epochs_run == 1
    assert any("dev gate" in w and "skipped" in w for w in result.warnings)
    assert result.best_bleu == 0.0   # the wedged gate's result never landed
    assert result.gates == 0


def test_cli_robust_knob_validation_exit2(setup, tmp_path, capsys):
    base = ["test", "--config", "fira-tiny", "--device", "cpu",
            "--data-dir", setup["dir"], "--out-dir", str(tmp_path / "OUT")]
    assert cli.main(base + ["--inject-faults", "nowhere:raise:0.1:7"]) == 2
    assert "not a registered fault site" in capsys.readouterr().err
    assert cli.main(base + ["--inject-faults", "disagg.transport:raise:2:0"]) \
        == 2
    want = jax_faults.robust_errors(jax_fira_tiny(
        inject_faults="disagg.transport:raise:2:0"))
    assert want and want[0] in capsys.readouterr().err
    assert cli.main(base + ["--dispatch-watchdog-s", "-2"]) == 2
    assert "dispatch_watchdog_s" in capsys.readouterr().err
    assert cli.main(base + ["--robust-retries", "-1"]) == 2
    assert "robust_retries" in capsys.readouterr().err


# --------------------------------------------------------------------------
# serve_metrics.json: atomic, and what an aborted run leaves
# --------------------------------------------------------------------------

def test_write_metrics_atomic_roundtrip(tmp_path):
    path = str(tmp_path / "m.json")
    write_metrics_atomic(path, {"a": 1})
    assert json.load(open(path)) == {"a": 1}
    write_metrics_atomic(path, {"a": 2})
    assert json.load(open(path)) == {"a": 2}
    assert not os.path.exists(path + ".tmp")
    with pytest.raises(ValueError):
        write_metrics_atomic(path, {"bad": float("nan")})
    assert json.load(open(path)) == {"a": 2}   # the failed write tore nothing


def test_aborted_serve_leaves_partial_output_and_metrics(setup, tmp_path,
                                                         monkeypatch):
    """A failure mid-run (here the output layer's, after 9 samples): the
    ordered writer's ``.partial`` prefix and a valid ``.partial`` metrics
    snapshot survive, and no final artifact is written."""
    import fira_tpu_torch.serve.server as server

    real = server.sample_emitter

    def failing_emitter(*a, **k):
        emit, n = real(*a, **k), [0]

        def wrapped(*args):
            n[0] += 1
            if n[0] > 9:
                raise RuntimeError("output layer failed")
            emit(*args)
        return wrapped

    monkeypatch.setattr(server, "sample_emitter", failing_emitter)
    out = tmp_path / "OUT"
    mp = str(out / "serve_metrics.json")
    with pytest.raises(RuntimeError, match="output layer failed"):
        serve_split(setup["model"], setup["tds"], setup["tds"].cfg,
                    arrival_times=setup["trace"], out_dir=str(out),
                    split="train", clock="virtual", metrics_path=mp)
    prefix = open(out / "output_fira.partial").read()
    assert prefix.endswith("\n") or prefix == ""
    rec = json.load(open(mp + ".partial"))
    assert rec["in_progress"] is True
    assert len(rec["request_records"]) == rec["serve"]["offered"] > 0
    assert rec["serve"]["completed"] >= 9
    assert not os.path.exists(mp)
    assert not os.path.exists(out / "output_fira")


def test_serve_metrics_written_atomically(setup, tmp_path):
    mp = str(tmp_path / "serve_metrics.json")
    m = serve_split(setup["model"], setup["tds"], setup["tds"].cfg,
                    arrival_times=setup["trace"],
                    out_dir=str(tmp_path / "OUT"), split="train",
                    clock="virtual", metrics_path=mp)
    assert m["metrics_path"] == mp
    rec = json.load(open(mp))
    assert rec["serve"]["completed"] == len(setup["trace"])
    assert "host_syncs" in rec["engine"]
    assert not os.path.exists(mp + ".partial")
    assert not os.path.exists(mp + ".tmp")

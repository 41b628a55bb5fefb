"""The port's serving loop (``fira_tpu_torch/serve``) against the JAX
package's (tests/test_serve.py), on the same corpus and weights
(``convert.params_from_flax``) at the JAX tests' widths:

- Poisson times bitwise equal to JAX's (both numpy), trace files written
  byte for byte alike and read back, malformed traces rejected in the
  same words;
- on a replayed trace under the virtual clock, the port's serve output
  equals its drain decode's bytes and the JAX package's serve bytes in
  the kv-cache x factored-top-k x paged modes, for any harvest cadence,
  feeder worker count and prefill budget;
- the virtual-clock request records (arrival, admit, seat, first-step
  and done stamps, rounds, status) and the ``serve`` summary equal JAX's
  field for field;
- queue-cap, deadline and prefill-budget shedding give JAX's counts and
  records;
- ``serve_errors`` in JAX's words; ``cli serve`` refuses bad knobs (an
  ``--input diffs`` without a readable ``--diff-trace`` in JAX's words)
  and the paths it does not run (the fault sites of later items), and a
  ``--resume`` with no journal or on the raw-diff path, with exit 2, and
  serves end to end on the CPU with the bytes of ``cli test --engine``
  and a request journal."""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import write_corpus_dir
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.decode.engine import SlotEngine as JaxEngine
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.serve import arrivals as jax_arrivals
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu.serve.server import ServeStats as JaxServeStats
from fira_tpu.serve.server import serve_errors as jax_serve_errors
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.decode.engine import SlotEngine
from fira_tpu_torch.decode.runner import run_test
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.serve import arrivals, serve_split
from fira_tpu_torch.serve.server import ServeStats, serve_errors

KNOBS = dict(batch_size=8, test_batch_size=6, decode_engine=True)
# (kv cache, factored top-k, paged arena)
MODES = [(True, False, True), (True, False, False), (True, True, True),
         (True, True, False), (False, False, False), (False, True, False)]


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
    the JAX tests' trace (rate 0.4, seed 3) over the train split."""
    d = str(tmp_path_factory.mktemp("serve_corpus"))
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
    trace = arrivals.poisson_times(len(tds.splits["train"]), rate=0.4,
                                   seed=3)
    return dict(jds=jds, tds=tds, params=params, model=model, trace=trace,
                dir=d, tmp=tmp_path_factory, runs={})


def port_serve(setup, out, times=None, engine=None, **knobs):
    return serve_split(setup["model"], setup["tds"],
                       setup["tds"].cfg.replace(**knobs),
                       arrival_times=(setup["trace"] if times is None
                                      else times),
                       out_dir=str(out), split="train", clock="virtual",
                       engine=engine)


def jax_serve(setup, out, times=None, engine=None, **knobs):
    cfg = setup["jds"].cfg.replace(**knobs)
    return jax_serve_split(JaxModel(cfg), setup["params"], setup["jds"], cfg,
                           arrival_times=(setup["trace"] if times is None
                                          else times),
                           out_dir=str(out), split="train", clock="virtual",
                           engine=engine)


def read(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def mode_knobs(kv, fac, paged):
    return dict(beam_kv_cache=kv, beam_factored_topk=fac,
                engine_paged_kv=paged)


def default_runs(setup):
    """The default mode's port and JAX serve runs on the trace (cached)."""
    if "default" not in setup["runs"]:
        tmp = setup["tmp"].mktemp("default")
        setup["runs"]["default"] = (port_serve(setup, tmp / "port"),
                                    jax_serve(setup, tmp / "jax"))
    return setup["runs"]["default"]


# --------------------------------------------------------------------------
# arrival schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,rate,seed", [(50, 2.0, 9), (33, 0.4, 3),
                                         (7, 123.5, 0), (0, 1.0, 1)])
def test_poisson_times_bitwise_equal_jax(n, rate, seed):
    got = arrivals.poisson_times(n, rate, seed=seed)
    want = jax_arrivals.poisson_times(n, rate, seed=seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.all(np.diff(got) >= 0)


def test_trace_files_equal_jax_and_roundtrip(tmp_path):
    a = arrivals.poisson_times(50, rate=2.0, seed=9)
    assert not np.array_equal(a, arrivals.poisson_times(50, 2.0, seed=10))
    path, jpath = str(tmp_path / "t"), str(tmp_path / "jt")
    arrivals.write_trace(path, a)
    jax_arrivals.write_trace(jpath, a)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = arrivals.read_trace(path)
    np.testing.assert_array_equal(got, jax_arrivals.read_trace(path))
    np.testing.assert_allclose(got, a, atol=1e-9)
    with open(path, "a") as f:
        f.write("# a comment\n\n")
    np.testing.assert_array_equal(arrivals.read_trace(path), got)


@pytest.mark.parametrize("content", [
    "0.5\nbogus\n", "1.0\n0.5\n", "-1\n", "# c\n\n2.0\n1.0\n",
    "0.1\n0.2\n0.15\n"])
def test_malformed_trace_rejected_like_jax(tmp_path, content):
    path = str(tmp_path / "t")
    with open(path, "w") as f:
        f.write(content)
    with pytest.raises(ValueError) as want:
        jax_arrivals.read_trace(path)
    with pytest.raises(ValueError) as got:
        arrivals.read_trace(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("times", [[1.0, 0.5], [-1.0, 0.5], [[0.0]]])
def test_write_trace_validation_like_jax(tmp_path, times):
    with pytest.raises(ValueError) as want:
        jax_arrivals.write_trace(str(tmp_path / "j"), np.array(times))
    with pytest.raises(ValueError) as got:
        arrivals.write_trace(str(tmp_path / "j"), np.array(times))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="rate"):
        arrivals.poisson_times(5, rate=0.0)


# --------------------------------------------------------------------------
# replay equivalence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv,fac,paged", MODES)
def test_serve_replay_bytes_equal_drain_and_jax(setup, tmp_path, kv, fac,
                                                paged):
    """Replayed trace, nothing shed: the port's serve output is its drain
    decode's bytes and the JAX package's serve bytes, in every mode."""
    knobs = mode_knobs(kv, fac, paged)
    cfg = setup["tds"].cfg.replace(**knobs)
    drain = run_test(setup["model"], setup["tds"], cfg,
                     out_dir=str(tmp_path / "drain"), split="train")
    if (kv, fac, paged) == MODES[0]:
        got, want = default_runs(setup)
    else:
        got = port_serve(setup, tmp_path / "port", **knobs)
        want = jax_serve(setup, tmp_path / "jax", **knobs)
    assert read(got) == read(drain) == read(want)
    assert got["sentence_bleu"] == drain["sentence_bleu"]
    sv = got["serve"]
    assert sv["completed"] == sv["offered"] == len(setup["trace"])
    assert sv["shed_queue_full"] == sv["shed_deadline"] == 0
    assert ([r["status"] for r in got["request_records"]]
            == [r["status"] for r in want["request_records"]])


@pytest.mark.parametrize("knobs", [
    dict(engine_harvest_every=1, feeder_workers=0),
    dict(engine_harvest_every=4, feeder_workers=2),
    dict(engine_harvest_every=3, feeder_workers=1, serve_prefill_budget=4,
         engine_prefill_depth=4)])
def test_serve_replay_invariant_to_schedule_knobs(setup, tmp_path, knobs):
    ref, _ = default_runs(setup)
    got = port_serve(setup, tmp_path, **knobs)
    assert read(got) == read(ref)
    assert got["serve"]["completed"] == got["serve"]["offered"]


def test_virtual_clock_records_equal_jax(setup):
    """The strongest check of the slice: under the virtual clock the
    scheduler's every decision shows in the stamps, and they equal the
    JAX package's, record for record, and so does the summary."""
    got, want = default_runs(setup)
    assert got["request_records"] == want["request_records"]
    assert got["serve"] == want["serve"]
    recs = got["request_records"]
    for r in recs:
        assert r["status"] == "done"
        assert (r["arrival_t"] <= r["admit_t"] <= r["seat_t"]
                <= r["first_step_t"] <= r["done_t"])
    seats = [r["seat_t"] for r in recs]
    assert seats == sorted(seats)          # FIFO admission
    sv = got["serve"]
    assert sv["p50_ttft_s"] <= sv["p99_ttft_s"] <= sv["p99_e2e_s"]
    for key in ("prefills", "refills", "slots_refilled", "steps_run",
                "step_dispatches", "commits", "slot_occupancy"):
        assert got["engine"][key] == want["engine"][key], key


def test_completion_sequence_stable_across_worker_counts(setup, tmp_path):
    runs = [port_serve(setup, tmp_path / f"w{w}", feeder_workers=w)
            for w in (0, 2)]
    assert runs[0]["request_records"] == runs[1]["request_records"]
    assert runs[0]["serve"] == runs[1]["serve"]


# --------------------------------------------------------------------------
# backpressure: the JAX package's counts and records
# --------------------------------------------------------------------------

def shed_pair(setup, tmp_path, slots, runs):
    """The port and the JAX package over ``runs`` (loop knobs each) on a
    burst, one engine of ``slots`` slots each reused across the runs."""
    n = len(setup["tds"].splits["train"])
    burst = np.zeros(n)
    tcfg = setup["tds"].cfg.replace(engine_slots=slots)
    jcfg = setup["jds"].cfg.replace(engine_slots=slots)
    teng = SlotEngine(setup["model"], tcfg)
    jeng = JaxEngine(JaxModel(jcfg), setup["params"], jcfg)
    out = []
    for i, knobs in enumerate(runs):
        got = port_serve(setup, tmp_path / f"p{i}", burst, teng,
                         engine_slots=slots, **knobs)
        want = jax_serve(setup, tmp_path / f"j{i}", burst, jeng,
                         engine_slots=slots, **knobs)
        keep = ("completed", "shed_queue_full", "shed_deadline", "rounds",
                "admits", "max_admits_per_round", "peak_queue_depth",
                "completion_order", "deadline_missed")
        assert ({k: got["serve"][k] for k in keep}
                == {k: want["serve"][k] for k in keep}), knobs
        assert _records_equal(got, want)
        out.append(got)
    return out, n


def _records_equal(got, want) -> bool:
    """Records equal field for field, NaN stamps (never seated) matching."""
    for a, b in zip(got["request_records"], want["request_records"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k]), (a, b)
            else:
                assert a[k] == b[k], (k, a, b)
    return True


def test_bounded_queue_sheds_like_jax(setup, tmp_path):
    (m,), n = shed_pair(setup, tmp_path, 6, [dict(serve_queue_cap=2)])
    sv = m["serve"]
    assert sv["shed_queue_full"] > 0
    assert sv["completed"] + sv["shed_queue_full"] == n
    lines = open(m["output_path"]).read().splitlines()
    assert len(lines) == n          # a shed position holds an empty line
    shed = [r for r in m["request_records"]
            if r["status"] == "shed_queue_full"]
    assert all(math.isnan(r["seat_t"]) for r in shed)


def test_deadline_sheds_like_jax(setup, tmp_path):
    (m,), n = shed_pair(setup, tmp_path, 4, [dict(serve_deadline_steps=1)])
    sv = m["serve"]
    assert sv["shed_deadline"] > 0 and sv["completed"] > 0
    assert sv["completed"] + sv["shed_deadline"] == n


def test_prefill_budget_caps_admissions_like_jax(setup, tmp_path):
    (b1, b2), n = shed_pair(setup, tmp_path, 12, [
        dict(serve_prefill_budget=1, engine_prefill_depth=2),
        dict(serve_prefill_budget=2, engine_prefill_depth=2)])
    for budget, m in ((1, b1), (2, b2)):
        assert m["serve"]["completed"] == n
        assert m["serve"]["max_admits_per_round"] <= budget
    assert b2["serve"]["max_admits_per_round"] \
        > b1["serve"]["max_admits_per_round"]


# --------------------------------------------------------------------------
# the knob checks and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("trace,knobs", [
    (False, dict(serve_rate=1.0)), (True, {}), (False, {}),
    (True, dict(serve_rate=-1.0)),
    (False, dict(serve_rate=1.0, serve_prefill_budget=0)),
    (False, dict(serve_rate=1.0, serve_prefill_budget=9)),
    (False, dict(serve_rate=1.0, engine_slots=8, engine_replicas=2,
                 serve_prefill_budget=5)),
    (False, dict(serve_rate=1.0, serve_deadline_steps=-1)),
    (False, dict(serve_rate=1.0, serve_queue_cap=-2))])
def test_serve_errors_equal_jax(trace, knobs):
    base = dict(decode_engine=True, test_batch_size=6)
    assert (serve_errors(fira_tiny(**base, **knobs), trace=trace)
            == jax_serve_errors(jax_fira_tiny(**base, **knobs), trace=trace))


def test_serve_stats_summary_keys_equal_jax():
    """Same fields, same summary keys; the completion order serializes and
    the heartbeats serialize in a stable order."""
    assert ([f.name for f in dataclasses.fields(ServeStats)]
            == [f.name for f in dataclasses.fields(JaxServeStats)])
    assert ServeStats(records=[]).summary() \
        == JaxServeStats(records=[]).summary()
    a, b = ServeStats(records=[]), ServeStats(records=[])
    a.completions = b.completions = [4, 1, 3]
    a.heartbeats["r1"] = {"rounds": 7}
    a.heartbeats["r0"] = {"rounds": 9}
    b.heartbeats["r0"] = {"rounds": 9}
    b.heartbeats["r1"] = {"rounds": 7}
    assert a.summary()["completion_order"] == [4, 1, 3]
    assert json.dumps(a.summary()) == json.dumps(b.summary())


@pytest.mark.parametrize("flags,named", [
    ([], "serve_rate"),
    (["--serve-rate", "5", "--serve-prefill-budget", "0"],
     "serve_prefill_budget"),
    (["--serve-rate", "5", "--serve-deadline-steps", "-1"],
     "serve_deadline_steps"),
    (["--serve-rate", "5", "--serve-queue-cap", "-1"], "serve_queue_cap"),
    (["--serve-rate", "5", "--prefix-cache-entries", "0"],
     "prefix_cache_entries"),
    (["--serve-rate", "5", "--input", "diffs"],
     "--input diffs needs --diff-trace PATH"),
    # --resume with no journal of an earlier run, and on the raw-diff path
    # (which keeps none), in the JAX package's words
    (["--serve-rate", "5", "--resume"],
     "--resume requires an existing serve journal at "),
    (["--serve-rate", "5", "--input", "diffs", "--diff-trace", __file__,
      "--resume"], "--resume supports --input graphs only"),
    (["--serve-rate", "5", "--serve-tiers", "prefill-pool",
      "--prefix-cache", "off"], "serve_tiers=prefill-pool requires "
     "prefix_cache"),
    (["--serve-rate", "5", "--input", "diffs", "--diff-trace",
      "/no/such/path"], "--diff-trace /no/such/path: path does not exist")])
def test_cli_serve_refusals_exit_2(setup, tmp_path, capsys, flags, named):
    rc = cli.main(["serve", "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", setup["dir"], "--out-dir",
                   str(tmp_path / "OUT"), *flags])
    assert rc == 2
    assert named in capsys.readouterr().err


def test_cli_serve_end_to_end_on_the_cpu(setup, tmp_path, capsys):
    """``cli serve --device cpu`` on a replayed trace writes the bytes of
    ``cli test --engine`` on the same checkpoint (cache on, the default,
    and off), an atomic serve_metrics.json and a request journal with one
    done record a request; an over-long trace exits 2."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(setup["model"].state_dict(), str(ckpt / "best.pt"))
    base = ["--config", "fira-tiny", "--device", "cpu", "--data-dir",
            setup["dir"], "--ckpt-dir", str(ckpt)]
    assert cli.main(["test", "--engine", "--out-dir",
                     str(tmp_path / "test"), *base]) == 0
    n = len(setup["tds"].splits["test"])
    trace = str(tmp_path / "trace.txt")
    arrivals.write_trace(trace, arrivals.poisson_times(n, 0.5, seed=1))
    ref = open(tmp_path / "test" / "output_fira", "rb").read()
    for cache in ("on", "off"):
        out = tmp_path / f"serve_{cache}"
        capsys.readouterr()
        assert cli.main(["serve", "--out-dir", str(out), "--serve-trace",
                         trace, "--serve-clock", "virtual",
                         "--prefix-cache", cache, *base]) == 0
        printed = capsys.readouterr().out
        assert f"serve: {n}/{n} completed" in printed
        assert open(out / "output_fira", "rb").read() == ref
        rec = json.load(open(out / "serve_metrics.json"))
        assert rec["serve"]["completed"] == n
        assert len(rec["request_records"]) == n
        assert (rec["engine"]["cache_misses"] > 0) == (cache == "on")
        assert not os.path.exists(out / "serve_metrics.json.partial")
        assert [f for f in os.listdir(out)
                if f.endswith(".journal")] == ["output_fira.journal"]
        with open(out / "output_fira.journal") as f:
            kinds = [json.loads(line)["kind"] for line in f]
        assert kinds[0] == "begin" and kinds.count("done") == n
    arrivals.write_trace(trace, arrivals.poisson_times(n + 5, 0.5, seed=1))
    assert cli.main(["serve", "--out-dir", str(tmp_path / "long"),
                     "--serve-trace", trace, *base]) == 2

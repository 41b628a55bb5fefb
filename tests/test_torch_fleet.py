"""The port's replicated engine fleet (``fira_tpu_torch/parallel/fleet.py``)
and the serve loop over it, against the JAX package's
(tests/test_fleet.py, the fleet cases of tests/test_robust.py) on the same
corpus and weights (``convert.params_from_flax``), each JAX fleet run once
a module:

- ``run_test`` on 1, 2 and 3 replicas, and under either refill order and
  prefill depth, writes the port's one-engine bytes and the JAX fleet's;
  the fleet's ``FleetStats.summary()`` carries the JAX keys (plus the
  port's ``host_syncs`` and ``warm_step_dispatches``) with the JAX
  schedule's counts;
- ``fleet_divisibility_errors`` and the slot and pool ``ValueError``s in
  the JAX package's words;
- a drain fleet that loses a replica to a seeded ``fleet.replica`` fault
  writes the no-fault bytes with the JAX retirements and requeues;
- ``serve_split`` on 2 replicas under the virtual clock, with and without
  a seeded ``fleet.replica`` fault: the bytes, the request records field
  for field, the retirements, requeues, heartbeats and alive trace of the
  JAX serve.

Tolerance: none. Output files compare as bytes, records and summaries
field for field (the virtual clock has no wall time)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as cc

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import write_corpus_dir
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.decode.runner import run_test as jax_run_test
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.parallel import fleet as jax_fleet
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu_torch import convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.decode.runner import run_test
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.parallel import fleet
from fira_tpu_torch.serve import poisson_times, serve_split

KNOBS = dict(batch_size=8, test_batch_size=6, decode_engine=True)
# the draw of this spec fires once over the 2-replica serve of the trace,
# mid-run: one replica retires, its requests finish on the other
SERVE_FAULT = "fleet.replica:raise:0.03:6"
DRAIN_FAULT = "fleet.replica:raise:0.05:8"   # tests/test_robust.py's
# FleetStats keys whose values are the schedule's (the JAX engine copies
# harvested rows in its own layout, so the byte meters differ)
SCHEDULE_KEYS = ("replicas", "slots", "prefills", "refills",
                 "slots_refilled", "steps_run", "step_dispatches",
                 "commits", "dispatches", "per_replica_commits",
                 "pool_blocks", "peak_blocks", "retirements",
                 "retired_replicas", "requeues", "respawns",
                 "respawned_replicas", "spare_attaches")


@pytest.fixture(scope="module", autouse=True)
def xla_cache(tmp_path_factory):
    """A persistent XLA compilation cache for this module: each JAX engine
    jits its own programs, so every engine the JAX fleets build (replicas,
    replacements, spares) would compile the same programs again; with the
    cache each compiles once. The process's settings come back after."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    cc.reset_cache()
    jax.config.update("jax_compilation_cache_dir",
                      str(tmp_path_factory.mktemp("xla_cache")))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])
    cc.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engines run many tiny ops, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tests' corpus (40 commits, seed 13) and widths, weights
    biased toward <eos> (mixed settle depths) in both packages, the JAX
    tests' trace, and the port's one-engine drain bytes."""
    d = str(tmp_path_factory.mktemp("fleet_corpus"))
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
    one = run_test(model, tds, tds.cfg, split="train",
                   out_dir=str(tmp_path_factory.mktemp("one")))
    return dict(jds=jds, tds=tds, params=params, model=model, trace=trace,
                tmp=tmp_path_factory, one=read(one), jax={})


def read(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def jax_drain(setup, **knobs):
    """The JAX package's ``run_test`` on the train split (once a knob
    set)."""
    key = ("drain",) + tuple(sorted(knobs.items()))
    if key not in setup["jax"]:
        cfg = setup["jds"].cfg.replace(**knobs)
        setup["jax"][key] = jax_run_test(
            JaxModel(cfg), setup["params"], setup["jds"], cfg,
            split="train", out_dir=str(setup["tmp"].mktemp("jax_drain")))
    return setup["jax"][key]


def port_drain(setup, tmp, refill_order="fifo", **knobs):
    return run_test(setup["model"], setup["tds"],
                    setup["tds"].cfg.replace(**knobs), split="train",
                    out_dir=str(tmp), refill_order=refill_order)


def assert_schedule_equal(got, want):
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"host_syncs", "warm_step_dispatches"}
    assert ({k: got[k] for k in SCHEDULE_KEYS}
            == {k: want[k] for k in SCHEDULE_KEYS})


# --------------------------------------------------------------------------
# drain decode over the fleet
# --------------------------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_fleet_bytes_equal_one_engine_and_jax_fleet(setup, tmp_path,
                                                    replicas):
    """The output file is the one engine's and the JAX 2-replica fleet's
    for any replica count; at 2 the fleet's schedule is JAX's."""
    got = port_drain(setup, tmp_path, engine_replicas=replicas)
    want = jax_drain(setup, engine_replicas=2)
    assert read(got) == setup["one"] == read(want)
    assert got["sentence_bleu"] == pytest.approx(want["sentence_bleu"],
                                                 abs=1e-12)
    eng = got["engine"]
    n = len(setup["tds"].splits["train"])
    assert eng["commits"] == n
    if replicas == 1:
        assert "replicas" not in eng   # the lone engine's own stats
        return
    assert eng["replicas"] == replicas == len(eng["per_replica_commits"])
    assert all(c > 0 for c in eng["per_replica_commits"])
    assert eng["warm_step_dispatches"] == replicas
    if replicas == 2:
        assert_schedule_equal(eng, want["engine"])


@pytest.mark.parametrize("order,depth", [("lifo", 2), ("fifo", 1)])
def test_fleet_refill_interleaving_keeps_the_bytes(setup, tmp_path, order,
                                                   depth):
    got = port_drain(setup, tmp_path, refill_order=order,
                     engine_replicas=2, engine_prefill_depth=depth)
    assert read(got) == setup["one"]


def test_fleet_slot_and_pool_errors_in_jax_words(setup):
    model, cfg = setup["model"], setup["tds"].cfg
    jmodel, jcfg = JaxModel(setup["jds"].cfg), setup["jds"].cfg
    for kw, fkw in ((dict(replicas=3, slots=8), {}),
                    (dict(replicas=2), dict(kv_pool_blocks=7)),
                    (dict(replicas=0), {})):
        with pytest.raises(ValueError) as want:
            jax_fleet.EngineFleet(jmodel, setup["params"],
                                  jcfg.replace(**fkw), **kw)
        with pytest.raises(ValueError) as got:
            fleet.EngineFleet(model, cfg.replace(**fkw), **kw)
        assert str(got.value) == str(want.value)
    f = fleet.EngineFleet(model, cfg, replicas=2, slots=8)
    assert [e.slots for e in f.engines] == [4, 4]
    assert [e.tag for e in f.engines] == ["r0", "r1"]
    assert all(e.model is model for e in f.engines)   # one device: shared
    for knobs in (dict(engine_replicas=3, engine_slots=8),
                  dict(engine_replicas=2, engine_slots=8),
                  dict(engine_replicas=1, engine_slots=7),
                  dict(engine_replicas=4)):
        assert (fleet.fleet_divisibility_errors(cfg.replace(**knobs))
                == jax_fleet.fleet_divisibility_errors(jcfg.replace(**knobs)))


def test_drain_fleet_retires_and_requeues_like_jax(setup, tmp_path):
    """A seeded ``fleet.replica`` fault retires a replica mid-drain: the
    bytes are the no-fault run's, the retirement and requeues JAX's."""
    knobs = dict(engine_replicas=2, inject_faults=DRAIN_FAULT)
    got = port_drain(setup, tmp_path, **knobs)
    want = jax_drain(setup, **knobs)
    assert read(got) == setup["one"] == read(want)
    eng = got["engine"]
    assert eng["retirements"] == 1 and eng["requeues"] > 0
    assert_schedule_equal(eng, want["engine"])


# --------------------------------------------------------------------------
# the serve loop over the fleet
# --------------------------------------------------------------------------

def records_equal(got, want) -> None:
    """Records equal field for field, NaN stamps matching."""
    assert len(got["request_records"]) == len(want["request_records"])
    for a, b in zip(got["request_records"], want["request_records"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k]), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


SERVE_KEYS = ("offered", "completed", "completion_order", "shed_error",
              "replica_retirements", "retired_replicas", "requeued_requests",
              "respawns", "replicas_alive_over_time", "heartbeats",
              "admission_paused_rounds", "rounds", "admits",
              "max_admits_per_round", "peak_queue_depth")


@pytest.mark.parametrize("fault", ["", SERVE_FAULT], ids=["clean", "fault"])
def test_serve_fleet_equals_jax(setup, tmp_path, fault):
    """``serve_split`` on 2 replicas (virtual clock): JAX's bytes, records
    and recovery record; admission rotates, so both replicas serve; a
    ``fleet.replica`` retirement requeues onto the survivor and writes the
    clean bytes."""
    knobs = dict(engine_replicas=2, inject_faults=fault)
    got = serve_split(setup["model"], setup["tds"],
                      setup["tds"].cfg.replace(**knobs),
                      arrival_times=setup["trace"],
                      out_dir=str(tmp_path / "port"), split="train",
                      clock="virtual")
    jcfg = setup["jds"].cfg.replace(**knobs)
    want = jax_serve_split(JaxModel(jcfg), setup["params"], setup["jds"],
                           jcfg, arrival_times=setup["trace"],
                           out_dir=str(tmp_path / "jax"), split="train",
                           clock="virtual")
    assert read(got) == read(want) == setup["one"]
    sv = got["serve"]
    assert ({k: sv[k] for k in SERVE_KEYS}
            == {k: want["serve"][k] for k in SERVE_KEYS})
    records_equal(got, want)
    assert_schedule_equal(got["engine"], want["engine"])
    assert sv["completed"] == len(setup["trace"])
    assert set(sv["heartbeats"]) == {"r0", "r1"}
    assert all(c > 0 for c in got["engine"]["per_replica_commits"])
    if fault:
        assert got["faults"] == want["faults"] == {"fleet.replica": 1}
        assert sv["replica_retirements"] == 1 and sv["requeued_requests"] > 0
        assert [e["alive"] for e in sv["replicas_alive_over_time"]] == [2, 1]
    else:
        assert sv["replica_retirements"] == 0

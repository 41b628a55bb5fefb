"""The port's disaggregated prefill tier (``fira_tpu_torch/serve/disagg.py``
and its wiring in the serve loop) against the JAX package's, mirroring
tests/test_disagg.py.

Tolerances: output bytes exact (the tiers against the in-process serve of
the same trace); the tier's meters (``TierStats.summary()``) equal the JAX
tier's key for key, and its counters equal on a one-worker run of the
same flood trace under the same seeded transport fault (the JAX tier runs
once in this module: its spawned JAX worker compiles its prefill, the
cost that makes tests/test_disagg.py slow).

Cases: the bytes at 1 worker over the pipe, and at 2 over shared memory
under a flood against a 1 MB artifact budget (the peak in flight within
it); zero decode-side prefills, the records' tier stamps, no
shared-memory segment left after close; a worker death requeued to the
survivor; every worker lost falling back in process, recorded; a corrupt
artifact caught by its checksum and prefilled again (the run held to the
JAX tier's counters); the named-knob messages and the CLI's exit 2."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.serve import disagg as jax_disagg
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny, unsupported
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.decode import engine, prefix_cache
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import faults
from fira_tpu_torch.serve import arrivals, disagg, serve_split

MIX = list(range(12))          # all distinct: every request is a tier job
# the JAX comparison's fault: a seeded transport corrupt whose draws fire
# on rows 1 and 2 of the flood's third group only, and not on the group
# that resubmits them (checked below), so which rows travel together does
# not depend on when results arrive
TRANSPORT_FAULT = "disagg.transport:corrupt:0.3:38"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, which the tiers' workers take from their
    parent: each run spawns processes, and the suite's parallel workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=24, seed=13)
    knobs = dict(batch_size=8, test_batch_size=4, decode_engine=True,
                 engine_slots=4, prefix_cache=True)
    jds = JaxDataset(d, jax_fira_tiny(**knobs))
    tds = FiraDataset(d, fira_tiny(**knobs))
    batch = make_batch(tds.splits["train"], np.arange(4), tds.cfg,
                       batch_size=4)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(2), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = eos_biased_params(params, delta=1.0)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return dict(d=d, jds=jds, tds=tds, params=params, model=model.eval())


@pytest.fixture(scope="module")
def trace():
    return arrivals.poisson_times(len(MIX), rate=1.0, seed=3)


@pytest.fixture(scope="module")
def inproc_ref(setup, trace, tmp_path_factory):
    """The in-process (tiers off) serve of the same mix: the bytes every
    tier run must write."""
    out = str(tmp_path_factory.mktemp("inproc"))
    m = serve_split(setup["model"], setup["tds"], setup["tds"].cfg,
                    arrival_times=trace, out_dir=out, split="train",
                    clock="virtual", request_mix=MIX)
    assert m["serve"]["completed"] == len(MIX)
    assert "tiers" not in m["serve"]
    with open(m["output_path"], "rb") as f:
        out = f.read()
    assert len(set(out.split(b"\n"))) > 3     # real, varied messages
    return out


def _serve(setup, tmp_path, times, **knobs):
    cfg = setup["tds"].cfg.replace(serve_tiers="prefill-pool", **knobs)
    m = serve_split(setup["model"], setup["tds"], cfg, arrival_times=times,
                    out_dir=str(tmp_path), split="train", clock="virtual",
                    request_mix=MIX)
    with open(m["output_path"], "rb") as f:
        return m, f.read()


def _segments():
    return set(glob.glob("/dev/shm/psm_*"))


@pytest.mark.parametrize("workers,transport", [(1, "pipe"), (2, "shm")])
def test_tier_bytes_equal_in_process(setup, trace, inproc_ref, tmp_path,
                                     monkeypatch, workers, transport):
    """The tiers write the in-process bytes; every row is delivered by a
    worker and seated from the cache (no decode-side prefill); the
    records carry the tier's stamps. Over shared memory every result is a
    segment, unlinked by the parent (none left after close); that run is
    a flood (every arrival at t=0) against a 1 MB in-flight budget:
    submissions wait for deliveries and the peak stays within it."""
    knobs = dict(prefill_workers=workers)
    times = trace
    if transport == "shm":
        monkeypatch.setattr(disagg, "SHM_MIN_BYTES", 0)
        knobs["serve_artifact_budget_mb"] = 1
        times = [0.0] * len(MIX)
    before = _segments()
    m, out = _serve(setup, tmp_path, times, **knobs)
    assert out == inproc_ref
    tiers = m["serve"]["tiers"]
    assert tiers["workers"] == workers and tiers["workers_lost"] == 0
    assert tiers["rows_delivered"] == len(MIX) and not tiers["fallback"]
    assert (tiers["shm_segments"] > 0) == (transport == "shm")
    assert tiers["inflight_bytes"] == 0
    assert m["engine"]["prefills"] == 0
    assert m["engine"]["cache_hits"] == len(MIX)
    done = [r for r in m["request_records"] if r["status"] == "done"]
    assert len(done) == len(MIX) and all(
        r["transport_s"] is not None and r["artifact_bytes"] > 0
        and r["prefill_queue_s"] is not None for r in done)
    assert _segments() <= before
    if transport == "shm":
        assert 0 < tiers["peak_inflight_bytes"] <= 1 << 20


WORKER_FAULT = "disagg.worker:raise:0.05:73176"


def test_worker_death_requeues_to_survivor(setup, trace, inproc_ref,
                                           tmp_path):
    """A seeded ``disagg.worker`` fault kills worker 0 at its first work
    item (the serve starts once the pool is up, so the first group is
    worker 0's; worker 1's draws fire at none of the first 120 items): its
    rows go to the survivor, the bytes stay the in-process ones."""
    inj = faults.injector_from(fira_tiny(inject_faults=WORKER_FAULT))
    spec = inj._by_site["disagg.worker"]
    assert [s for s in range(30) if inj._draw(spec, f"w0:{s}")] \
        == [0, 1, 2, 22]
    assert not any(inj._draw(spec, f"w1:{s}") for s in range(120))
    m, out = _serve(setup, tmp_path, trace, prefill_workers=2,
                    inject_faults=WORKER_FAULT)
    tiers = m["serve"]["tiers"]
    assert tiers["workers_lost"] == 1 and not tiers["fallback"]
    assert tiers["rows_resubmitted"] >= 1
    assert tiers["rows_by_worker"].keys() == {"1"}
    assert m["serve"]["completed"] == len(MIX)
    assert out == inproc_ref


def test_all_workers_lost_falls_back_in_process(setup, trace, inproc_ref,
                                                tmp_path):
    m, out = _serve(setup, tmp_path, trace, prefill_workers=1,
                    inject_faults="disagg.worker:raise:0.6:7")
    tiers = m["serve"]["tiers"]
    assert tiers["workers_lost"] == 1 and tiers["fallback"]
    assert tiers["fallback_reason"] == (
        "all prefill workers lost; decode tier resumed in-process prefill")
    assert m["serve"]["completed"] == len(MIX)
    assert out == inproc_ref
    assert m["engine"]["prefills"] > 0     # the rest prefilled in process


def test_corrupt_artifact_caught_and_stats_equal_jax(setup, inproc_ref,
                                                      tmp_path):
    """One worker, a flood, a seeded transport corrupt: the scrambled rows
    are caught by their checksums at the seat and prefilled again (the
    in-process bytes, never a wrong answer); the summary's keys equal the
    JAX tier's, and so do its counters on the same run (the bytes, the
    in-flight estimates and the seconds depend on each package's own
    array types and clocks)."""
    inj = faults.injector_from(fira_tiny(inject_faults=TRANSPORT_FAULT))
    spec = inj._by_site["disagg.transport"]
    assert [(q, i) for q in range(3) for i in range(4)
            if inj._draw(spec, f"{q}:{i}")] == [(2, 1), (2, 2)]
    assert not any(inj._draw(spec, f"3:{i}") for i in range(2))
    flood = [0.0] * len(MIX)
    knobs = dict(serve_tiers="prefill-pool", prefill_workers=1,
                 inject_faults=TRANSPORT_FAULT)
    m, out = _serve(setup, tmp_path / "port", flood, prefill_workers=1,
                    inject_faults=TRANSPORT_FAULT)
    assert out == inproc_ref
    jcfg = setup["jds"].cfg.replace(**knobs)
    jm = jax_serve_split(JaxModel(jcfg), setup["params"], setup["jds"],
                         jcfg, arrival_times=flood,
                         out_dir=str(tmp_path / "jax"), split="train",
                         clock="virtual", request_mix=MIX)
    got, want = m["serve"]["tiers"], jm["serve"]["tiers"]
    assert list(got) == list(want)
    assert list(disagg.TierStats().summary()) == list(
        jax_disagg.TierStats().summary())
    same = ("workers", "workers_lost", "fallback", "fallback_reason",
            "groups_submitted", "rows_submitted", "rows_delivered",
            "rows_resubmitted", "rows_given_up", "transport_msgs_lost",
            "transport_integrity_drops", "shm_segments", "inflight_bytes",
            "peak_backlog", "rows_by_worker")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["transport_integrity_drops"] == 2
    assert got["rows_resubmitted"] == 2 and got["groups_submitted"] == 4
    assert m["faults"] == jm["faults"]
    assert m["serve"]["completed"] == jm["serve"]["completed"] == len(MIX)


@pytest.mark.parametrize("knobs", [
    dict(), dict(serve_tiers="prefill-pool"), dict(serve_tiers="bogus"),
    dict(serve_tiers="prefill-pool", prefix_cache=False),
    dict(serve_tiers="prefill-pool", decode_engine=False),
    dict(serve_tiers="prefill-pool", prefill_workers=0),
    dict(serve_tiers="prefill-pool", serve_artifact_budget_mb=-1)])
def test_disagg_errors_equal_jax(knobs):
    kw = dict(decode_engine=True, prefix_cache=True)
    kw.update(knobs)
    got = disagg.disagg_errors(fira_tiny(**kw))
    assert got == jax_disagg.disagg_errors(jax_fira_tiny(**kw))
    assert (disagg.TIERS, disagg.SHM_MIN_BYTES) == (jax_disagg.TIERS,
                                                    jax_disagg.SHM_MIN_BYTES)
    if kw.get("serve_tiers", "off") != "off":
        assert all(e in unsupported(fira_tiny(**kw)) for e in got)


def test_cli_disagg_knob_validation_exit2(setup, tmp_path, capsys):
    base = ["serve", "--config", "fira-tiny", "--device", "cpu",
            "--data-dir", setup["d"], "--out-dir", str(tmp_path / "o"),
            "--serve-rate", "5", "--engine", "--prefix-cache", "on",
            "--serve-tiers", "prefill-pool"]
    jcfg = jax_fira_tiny(decode_engine=True, prefix_cache=True,
                         serve_tiers="prefill-pool")
    for flags, knobs in ((["--prefill-workers", "0"],
                          dict(prefill_workers=0)),
                         (["--serve-artifact-budget-mb", "-1"],
                          dict(serve_artifact_budget_mb=-1))):
        assert cli.main(base + flags) == 2
        want = jax_disagg.disagg_errors(jcfg.replace(**knobs))
        assert want[0] in capsys.readouterr().err
    no_cache = [("off" if a == "on" else a) for a in base]
    assert cli.main(no_cache + ["--prefill-workers", "2"]) == 2
    want = jax_disagg.disagg_errors(jcfg.replace(prefix_cache=False))
    assert want[0] in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(base + ["--serve-tiers", "bogus"])
    assert exc.value.code == 2


def test_worker_prefill_is_the_engines(setup):
    """A worker child, on the device it is given (the CPU here, on a
    request for it), warms the engine's own prefill: its ``ready``
    reports a row's artifact bytes as the parent's engine makes them,
    and it stops and exits on close."""
    cfg = setup["tds"].cfg.replace(prefill_workers=1,
                                   serve_tiers="prefill-pool")
    tmpl = make_batch(setup["tds"].splits["train"], np.arange(0), cfg,
                      batch_size=4)
    tier = disagg.PrefillTier(
        {k: v.numpy() for k, v in setup["model"].state_dict().items()},
        cfg, templates={0: tmpl}, device="cpu", dtype="float32")
    with tier:
        w = tier._workers[0]
        assert w.conn.poll(120)
        kind, wid, est = w.conn.recv()
        assert w.proc.pid != os.getpid() and w.proc.is_alive()
    assert not w.proc.is_alive()
    eng = engine.SlotEngine(setup["model"], cfg)
    with torch.inference_mode():
        chunk = eng._prefill(batch_to_device(tmpl, torch.device("cpu")))
        lanes = eng._fill_copies(chunk, [0])
    payload = prefix_cache.extract_payloads(
        {f: eng._to_numpy(t) for f, t in lanes.items()}, [0], 1)[0]
    assert (kind, wid, est) == ("ready", 0,
                                {0: prefix_cache.payload_nbytes(payload)})


def test_a_started_tier_serves_two_runs(setup, trace, inproc_ref, tmp_path):
    """A pool started once serves two runs (``serve_split(tier=...)``, as
    a bench reuses an engine): the in-process bytes both times, each
    run's meters its own, the pool left running for its owner."""
    cfg = setup["tds"].cfg.replace(serve_tiers="prefill-pool",
                                   prefill_workers=1)
    tier = disagg.PrefillTier(
        {k: v.numpy() for k, v in setup["model"].state_dict().items()},
        cfg, templates={0: make_batch(setup["tds"].splits["train"],
                                      np.arange(0), cfg, batch_size=4)},
        device="cpu", dtype="float32")
    with tier:
        for run in ("a", "b"):
            m = serve_split(setup["model"], setup["tds"], cfg,
                            arrival_times=trace, out_dir=str(tmp_path / run),
                            split="train", clock="virtual", request_mix=MIX,
                            tier=tier)
            with open(m["output_path"], "rb") as f:
                assert f.read() == inproc_ref
            assert m["serve"]["tiers"]["rows_delivered"] == len(MIX)
            assert m["engine"]["prefills"] == 0
            assert tier.alive and tier._workers[0].proc.is_alive()
    assert not tier._workers[0].proc.is_alive()

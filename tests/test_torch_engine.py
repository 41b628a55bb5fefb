"""The port's slot-refill engine (``fira_tpu_torch/decode/engine.py``)
against the JAX package's ``SlotEngine`` on the same corpus and weights
(the JAX engine jitted, its copy head on the Pallas kernel interpreted on
the CPU): per sample tokens exactly equal, probabilities at rtol 1e-5, in
the four kv-cache x factored-top-k modes on random weights and on weights
biased toward <eos> (samples then settle at mixed depths, so slots refill
while others are mid-flight), and once in log space.

Against the port's own batched beam the contract is the JAX package's:
bitwise per sample, in every mode, for slot counts 1, 3, 4 and 7 and both
refill orders. ``run_test`` with ``decode_engine`` writes the batched
decode's file byte for byte and leaves no ``.partial``; settled slots
retire early; the step reads nothing back to the host and calls the copy
head once a micro-step; ``EngineStats.summary()`` carries the JAX keys."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.decode import beam as jax_beam
from fira_tpu.decode import engine as jax_engine
from fira_tpu.decode.runner import _decode_tasks
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import convert
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder
from fira_tpu_torch.decode import beam, engine, runner
from fira_tpu_torch.model.model import FiraModel

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)
MODES = [(True, False), (True, True), (False, False), (False, True)]
SPLIT = "train"          # the big split: several batches, real refills
EOS_DELTA = 2.0          # moderate: samples settle at mixed depths


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: the engine runs thousands of
    tiny ops, and with the suite's parallel workers each sharing the cores
    a full thread pool a worker makes them many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    jds = JaxDataset(d, JaxConfig(**GEOM, copy_head_impl="pallas"))
    tds = FiraDataset(d, FiraConfig(**GEOM))
    jcfg, tcfg = jds.cfg, tds.cfg
    batch = make_batch(tds.splits["test"], np.arange(3), tcfg, batch_size=4)
    params = jax.jit(lambda b: JaxModel(jcfg).init(
        jax.random.PRNGKey(1), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    weights = {"random": params,
               "eos_biased": jax_beam.eos_biased_params(params, EOS_DELTA),
               "eos_saturated": jax_beam.eos_biased_params(params, 8.0)}
    return dict(jds=jds, tds=tds, jcfg=jcfg, tcfg=tcfg, weights=weights,
                models={}, runs={}, jax_engines={})


def _model(setup, weights):
    """The port model on ``weights`` (one a weight set)."""
    if weights not in setup["models"]:
        model = FiraModel(setup["tcfg"])
        model.load_state_dict(convert.params_from_flax(jax.tree_util.tree_map(
            np.asarray, setup["weights"][weights])))
        setup["models"][weights] = model.eval()
    return setup["models"][weights]


def _knobs(kv, fac, prob=True):
    return dict(beam_kv_cache=kv, beam_factored_topk=fac,
                beam_compat_prob_space=prob)


def jax_engine_run(setup, knobs, weights):
    """{split position: (tokens, probs)} of the JAX engine. One engine a
    mode serves both weight sets (its programs take the weights as an
    argument; a dirty arena is part of its contract), so each mode
    compiles once."""
    cfg = setup["jcfg"].replace(**knobs)
    key = tuple(sorted(knobs.items()))
    if key not in setup["jax_engines"]:
        setup["jax_engines"][key] = jax_engine.SlotEngine(
            JaxModel(cfg), setup["weights"][weights], cfg)
    eng = setup["jax_engines"][key]
    eng.params = eng._decode_params = setup["weights"][weights]
    tasks, _ = _decode_tasks(setup["jds"].splits[SPLIT], cfg)
    with JaxFeeder(tasks, num_workers=0, depth=1) as feed:
        return {it.position: (np.asarray(it.tokens), np.asarray(it.probs))
                for it in eng.run(feed)}


def engine_run(setup, cfg, weights, **kw):
    """({split position: (tokens, probs)}, the engine) of the port's."""
    order = kw.pop("refill_order", "fifo")
    eng = engine.SlotEngine(_model(setup, weights), cfg, **kw)
    data = setup["tds"].splits[SPLIT]
    tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                      batch_size=cfg.test_batch_size)
    with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
        got = {it.position: (it.tokens, it.probs)
               for it in eng.run(feed, refill_order=order)}
    return got, eng


def batched_run(setup, cfg, weights):
    """{split position: (tokens, probs)} of the port's batched beam."""
    key = (tuple(sorted(_knobs(cfg.beam_kv_cache, cfg.beam_factored_topk,
                               cfg.beam_compat_prob_space).items())),
           weights)
    if key not in setup["runs"]:
        search = beam.make_beam_search(_model(setup, weights), cfg)
        data = setup["tds"].splits[SPLIT]
        tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                          batch_size=cfg.test_batch_size)
        out = {}
        with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
            for item in feed:
                toks, probs = search(item.device)
                for i in np.flatnonzero(item.host["valid"]):
                    out[int(item.host["_positions"][i])] = (
                        toks[i].numpy(), probs[i].numpy())
        setup["runs"][key] = out
    return setup["runs"][key]


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0], err_msg=str(p))
        assert got[p][1].tobytes() == want[p][1].tobytes(), p


CASES = [(kv, fac, True) for kv, fac in MODES] + [(True, False, False)]


@pytest.mark.parametrize("weights", ["random", "eos_biased"])
@pytest.mark.parametrize("kv,fac,prob", CASES)
def test_engine_matches_jax_engine(setup, kv, fac, prob, weights):
    knobs = _knobs(kv, fac, prob)
    want = jax_engine_run(setup, knobs, weights)
    got, eng = engine_run(setup, setup["tcfg"].replace(**knobs), weights)
    assert set(got) == set(want) == set(range(len(setup["tds"].splits[SPLIT])))
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0], err_msg=str(p))
        np.testing.assert_allclose(got[p][1], want[p][1], rtol=1e-5,
                                   atol=1e-7, err_msg=str(p))
    assert eng.stats.commits == len(want)
    assert eng.stats.slots_refilled == len(want)
    if weights == "eos_biased":
        # samples settle at mixed depths, so slots refill mid-flight
        lengths = {int((t[np.argmax(p)] != 0).sum()) for t, p in got.values()}
        assert len(lengths) >= 2, lengths


@pytest.mark.parametrize("weights", ["random", "eos_biased"])
@pytest.mark.parametrize("kv,fac,prob", CASES)
def test_engine_bitwise_equals_batched_beam(setup, kv, fac, prob, weights):
    cfg = setup["tcfg"].replace(**_knobs(kv, fac, prob))
    got, _eng = engine_run(setup, cfg, weights)
    assert_bitwise(got, batched_run(setup, cfg, weights))


@pytest.mark.parametrize("order", ["fifo", "lifo"])
@pytest.mark.parametrize("slots", [1, 3, 4, 7])
def test_slot_count_and_refill_order_keep_the_bits(setup, slots, order):
    cfg = setup["tcfg"]
    got, eng = engine_run(setup, cfg, "eos_biased", slots=slots,
                          refill_order=order)
    assert eng.slots == slots
    assert_bitwise(got, batched_run(setup, cfg, "eos_biased"))
    assert eng.allocator_invariants() == []


def test_run_test_writes_the_batched_bytes(setup, tmp_path):
    cfg = setup["tcfg"]
    model = _model(setup, "eos_biased")
    off = runner.run_test(model, setup["tds"], cfg, split=SPLIT,
                          out_dir=str(tmp_path / "off"))
    on_cfg = cfg.replace(decode_engine=True)
    on = runner.run_test(_model(setup, "eos_biased"), setup["tds"],
                         on_cfg, split=SPLIT, out_dir=str(tmp_path / "on"),
                         engine_slots=3, refill_order="lifo")
    with open(off["output_path"], "rb") as a, open(on["output_path"],
                                                   "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and want.count(b"\n") == len(setup["tds"].splits[SPLIT])
    assert on["sentence_bleu"] == off["sentence_bleu"]
    assert "engine" not in off
    assert on["engine"]["commits"] == len(setup["tds"].splits[SPLIT])
    assert on["engine"]["slots"] == 3
    assert on["engine"]["warm_step_dispatches"] == 1
    for suffix in (".partial", ".partial.tail"):
        assert not os.path.exists(on["output_path"] + suffix)


def test_settled_slots_retire_early(setup):
    """On weights biased hard toward <eos> every slot settles within a
    few positions: the engine's micro-steps come in far below the batched
    full scan's, and a prefill runs once a batch."""
    cfg = setup["tcfg"]
    got, eng = engine_run(setup, cfg, "eos_saturated")
    assert_bitwise(got, batched_run(setup, cfg, "eos_saturated"))
    n = len(setup["tds"].splits[SPLIT])
    n_batches = -(-n // cfg.test_batch_size)
    assert 0 < eng.stats.steps < n_batches * (cfg.tar_len - 1)
    # the beam work done: under half of the full scan's
    assert eng.stats.occupied_slot_steps < n * (cfg.tar_len - 1) // 2
    assert eng.stats.prefills == n_batches
    assert 0.0 < eng.stats.slot_occupancy <= 1.0


def test_summary_has_the_jax_keys(setup):
    _got, eng = engine_run(setup, setup["tcfg"], "eos_biased")
    got = eng.stats.summary()
    want = jax_engine.EngineStats(slots=1).summary()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"host_syncs", "warm_step_dispatches"}
    for key in ("prefills", "refills", "slots_refilled", "steps_run",
                "step_dispatches", "commits", "dispatches", "pool_blocks",
                "kv_block_size", "kv_bytes_per_slot", "peak_blocks",
                "harvest_row_reads", "harvest_bytes_read", "host_syncs"):
        assert got[key] > 0, key
    assert 0 < got["slot_occupancy"] <= 1 and 0 < got["pool_utilization"] <= 1
    assert got["steps_run"] == 4 * got["step_dispatches"]   # R = 4
    assert got["harvest_row_reads"] == got["commits"]
    # one read of the done mask a dispatch, one more when a slot settled
    assert (got["step_dispatches"] < got["host_syncs"]
            <= 2 * got["step_dispatches"])


def test_step_reads_nothing_back_and_scores_once_a_micro_step(setup,
                                                              monkeypatch):
    """A step dispatch neither syncs with nor branches on the device (no
    ``item``, ``tolist``, ``cpu``, ``numpy``, ``nonzero`` or truth test of
    a tensor) and calls the copy head (K1 on the card) once a
    micro-step."""
    cfg = setup["tcfg"].replace(engine_harvest_every=3)
    model = _model(setup, "eos_biased")
    calls = []
    score_fn = model.copy_net.score_fn
    monkeypatch.setattr(model.copy_net, "score_fn",
                        lambda *a: calls.append(1) or score_fn(*a))
    eng = engine.SlotEngine(model, cfg)
    data = setup["tds"].splits[SPLIT]
    hosts = [t() for t in B.bucketed_assembly_tasks(
        data, B.output_plan(data, cfg), cfg, batch_size=4)]
    eng.prewarm(hosts[:1])
    assert len(calls) == 3
    eng.admit(hosts[0], 0)
    eng.refill()

    def forbidden(*_a, **_k):
        raise AssertionError("the step read the device back")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "nonzero",
                     "__bool__"):
            m.setattr(torch.Tensor, name, forbidden)
        eng.step_dispatch()
    assert len(calls) == 6
    assert eng.harvest() is not None

"""The engine's entry points in the port's CLI: ``cli test --engine
--buckets auto --decode-tar-buckets`` writes the JAX package's
``output_fira`` (its engine, tar-bucketed, on the same checkpoint) byte
for byte and prints its decode table; ``--perf production`` sets exactly
the union of the two production knob sets and writes the bytes of the
engine in that mode; a bad engine flag exits 2 naming it; a knob value
no path runs is refused by name; and the fleet, recovery and
serving-tier knobs are accepted, a bad value exiting 2 in the JAX
package's words."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from fira_tpu.cli import _load_var_maps
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import buckets as JB
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode import quant as jax_quant
from fira_tpu.decode import spec as jax_spec
from fira_tpu.decode.runner import run_test as jax_run_test
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.parallel import fleet as jax_fleet
from fira_tpu.robust import faults as jax_faults
from fira_tpu.robust import recovery as jax_recovery
from fira_tpu.serve import disagg as jax_disagg
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import (DECODE_PERF_KNOBS, PRODUCTION_PERF_KNOBS,
                                   FiraConfig, fira_tiny, unsupported)
from fira_tpu_torch.decode import engine
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.parallel import fleet
from fira_tpu_torch.robust import recovery

N_COMMITS, SEED, TEST_BS = 120, 3, 4


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
    """One corpus written by the JAX package (the port reads the same
    files) and a checkpoint of the port's seeded initialisation."""
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=N_COMMITS, seed=SEED)
    jds = JaxDataset(d, jax_fira_tiny(copy_head_impl="pallas",
                                      test_batch_size=TEST_BS))
    jcfg = jds.cfg
    model = FiraModel(FiraConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(FiraConfig)}))
    model.init_parameters(torch.Generator().manual_seed(0))
    ckpt = tmp_path_factory.mktemp("ckpt")
    torch.save(model.state_dict(), ckpt / "best.pt")
    return dict(dir=d, jds=jds, jcfg=jcfg, ckpt=str(ckpt),
                params=jax.tree_util.tree_map(
                    jnp.asarray, convert.params_to_flax(model.state_dict())))


def port_test(setup, out, *flags):
    return cli.main(["test", "--config", "fira-tiny", "--device", "cpu",
                     "--data-dir", setup["dir"], "--out-dir", out,
                     "--ckpt-dir", setup["ckpt"], "--test-batch-size",
                     str(TEST_BS), *flags])


def read(out):
    with open(os.path.join(out, "output_fira"), "rb") as f:
        return f.read()


def test_tar_bucketed_engine_writes_the_jax_bytes(setup, tmp_path, capsys):
    jds = setup["jds"]
    split = jds.splits["test"]
    cfg = setup["jcfg"].replace(
        buckets=JB.choose_buckets(split, setup["jcfg"]), decode_engine=True,
        decode_tar_buckets=True)
    table = JB.decode_table(cfg)
    assert min(g.tar_len for g in table) < cfg.tar_len   # a real cap
    jout = str(tmp_path / "jax")
    jax_run_test(JaxModel(cfg), setup["params"], jds, cfg, out_dir=jout,
                 var_maps=_load_var_maps(setup["dir"]))
    out = str(tmp_path / "port")
    assert port_test(setup, out, "--engine", "--buckets", "auto",
                     "--decode-tar-buckets") == 0
    printed = capsys.readouterr().out
    assert ("decode table: " + ", ".join(map(JB.geom_tag, table))
            in printed)
    assert '"commits": %d' % len(split) in printed
    want = read(jout)
    assert read(out) == want and want.count(b"\n") == len(split)
    # the cap changed the text: the tar-pinned engine writes other lines
    pinned = str(tmp_path / "pinned")
    assert port_test(setup, pinned, "--engine", "--buckets", "auto") == 0
    assert read(pinned) != want


def test_perf_production_sets_the_union_of_both_sets():
    parity = cli.resolve_config(cli.build_parser().parse_args(["test"]))
    prod = cli.resolve_config(cli.build_parser().parse_args(
        ["test", "--perf", "production"]))
    union = {**PRODUCTION_PERF_KNOBS, **DECODE_PERF_KNOBS}
    assert len(union) == len(PRODUCTION_PERF_KNOBS) + len(DECODE_PERF_KNOBS)
    for f in dataclasses.fields(FiraConfig):
        want = union.get(f.name, getattr(parity, f.name))
        assert getattr(prod, f.name) == want, f.name
    assert not unsupported(prod)
    # a flag given overrides the preset
    eng_off = cli.resolve_config(cli.build_parser().parse_args(
        ["test", "--perf", "production", "--engine-slots", "7"]))
    assert eng_off.engine_slots == 7 and eng_off.decode_engine


def test_perf_production_writes_the_engine_bytes(setup, tmp_path, capsys):
    prod, eng = str(tmp_path / "prod"), str(tmp_path / "engine")
    assert port_test(setup, prod, "--perf", "production") == 0
    assert "engine: {" in capsys.readouterr().out
    assert port_test(setup, eng, "--engine", "--beam-factored-topk",
                     "--beam-early-exit") == 0
    assert read(prod) == read(eng)
    batched = str(tmp_path / "batched")
    assert port_test(setup, batched, "--beam-factored-topk",
                     "--beam-early-exit") == 0
    assert read(batched) == read(prod)


@pytest.mark.parametrize("flags,named", [
    (["--engine-slots", "0"], "--engine-slots"),
    (["--engine-harvest-every", "0"], "--engine-harvest-every"),
    (["--engine-prefill-depth", "-1"], "--engine-prefill-depth"),
    (["--kv-paged", "maybe"], "--kv-paged"),
    # a value no path of either package runs
    (["--engine-replicas", "0"], "--engine-replicas"),
    (["--prefix-cache", "maybe"], "--prefix-cache"),
    (["--spec-decode", "turbo"], "--spec-decode"),
    (["--kv-dtype", "fp8"], "--kv-dtype"),
])
def test_bad_engine_flag_exits_2_naming_it(setup, tmp_path, capsys, flags,
                                           named):
    with pytest.raises(SystemExit) as exit_:
        port_test(setup, str(tmp_path), "--engine", *flags)
    assert exit_.value.code == 2
    assert named in capsys.readouterr().err


@pytest.mark.parametrize("flags,named", [
    (["--kv-block-size", "5"],
     "kv_block_size 5 does not divide decode tar budget 12"),
    (["--kv-pool-blocks", "1"], "kv_pool_blocks 1 per replica < engine "
     "slots 4"),
    (["--kv-block-size", "-2"], "kv_block_size -2 must be >= 1"),
])
def test_bad_paging_knob_exits_2_naming_it(setup, tmp_path, capsys, flags,
                                           named):
    assert port_test(setup, str(tmp_path), "--engine", *flags) == 2
    assert named in capsys.readouterr().err


REFUSED = [
    ("dispatch_watchdog_s", -1.0, "must be 0 (watchdog off) or > 0"),
]


@pytest.mark.parametrize("knob,value,brings", REFUSED)
def test_knob_the_engine_does_not_run_is_refused(knob, value, brings):
    cfg = fira_tiny(decode_engine=True, vocab_size=40,
                    ast_change_vocab_size=10, **{knob: value})
    named = [e for e in unsupported(cfg)
             if e.startswith((f"{knob}=", f"{knob} "))]
    assert len(named) == 1 and brings in named[0], unsupported(cfg)
    model = FiraModel(cfg.replace(**{knob: getattr(fira_tiny(), knob)}))
    with pytest.raises(ValueError, match=knob):
        engine.SlotEngine(model, cfg)


# knob -> (a value the port now runs, flags of a bad value, the JAX
# package's check that names it)
ACCEPTED = [
    ("engine_replicas", dict(engine_replicas=2),
     ["--engine-slots", "5", "--engine-replicas", "2"],
     lambda c: jax_fleet.fleet_divisibility_errors(
         c.replace(engine_slots=5, engine_replicas=2))),
    ("engine_spares", dict(engine_spares=1, max_respawns=1),
     ["--engine-spares", "1"],
     lambda c: jax_recovery.recovery_errors(c.replace(engine_spares=1))),
    ("inject_faults", dict(inject_faults="fleet.replica:raise:0.5:3"),
     ["--inject-faults", "fleet.replica:corrupt:0.5:3"],
     lambda c: jax_faults.robust_errors(
         c.replace(inject_faults="fleet.replica:corrupt:0.5:3"))),
    ("max_respawns", dict(max_respawns=1), ["--max-respawns", "-1"],
     lambda c: jax_recovery.recovery_errors(c.replace(max_respawns=-1))),
]


@pytest.mark.parametrize("knob,good,bad,jax_check", ACCEPTED,
                         ids=[a[0] for a in ACCEPTED])
def test_fleet_and_recovery_knob_accepted_with_jax_validation(
        setup, tmp_path, capsys, knob, good, bad, jax_check):
    """The fleet and recovery knobs the port runs now: a good value passes
    every check of both packages and builds an engine; ``cli test
    --engine`` with a bad one exits 2 printing the JAX package's
    message."""
    cfg = fira_tiny(decode_engine=True, vocab_size=40,
                    ast_change_vocab_size=10, **good)
    jcfg = jax_fira_tiny(decode_engine=True, **good)
    assert unsupported(cfg) == [] and recovery.recovery_errors(cfg) == []
    assert fleet.fleet_divisibility_errors(cfg) == []
    assert (jax_recovery.recovery_errors(jcfg)
            == jax_fleet.fleet_divisibility_errors(jcfg) == [])
    engine.SlotEngine(FiraModel(cfg), cfg)
    want = jax_check(jax_fira_tiny(decode_engine=True,
                                   test_batch_size=TEST_BS))
    assert len(want) == 1 and knob.split("_")[0] in want[0]
    assert port_test(setup, str(tmp_path), "--engine", *bad) == 2
    assert want[0] in capsys.readouterr().err


# the serving-tier knobs the port runs now: knob -> (a value the port
# runs, a CLI call with a value the JAX package refuses, the JAX check
# that names it)
TIER_ACCEPTED = [
    ("serve_tiers", dict(serve_tiers="prefill-pool", prefix_cache=True),
     ["test", "--engine", "--serve-tiers", "prefill-pool"],
     lambda c: jax_disagg.disagg_errors(c.replace(
         serve_tiers="prefill-pool"))),
    ("spec_decode", dict(spec_decode="draft"),
     ["test", "--engine", "--spec-decode", "copy", "--spec-k", "99"],
     lambda c: jax_spec.spec_errors(c.replace(spec_decode="copy",
                                              engine_spec_k=99))),
    ("kv_dtype", dict(kv_dtype="bf16"), ["test", "--kv-dtype", "bf16"],
     lambda c: jax_quant.quant_errors(c.replace(decode_engine=False,
                                                kv_dtype="bf16"))),
    ("serve_precision", dict(serve_precision="int8w"),
     ["train", "--serve-precision", "int8w"],
     lambda c: jax_quant.quant_errors(c.replace(serve_precision="int8w"),
                                      train=True)),
]


@pytest.mark.parametrize("knob,good,bad,jax_check", TIER_ACCEPTED,
                         ids=[a[0] for a in TIER_ACCEPTED])
def test_serving_tier_knob_accepted_with_jax_validation(
        setup, tmp_path, capsys, knob, good, bad, jax_check):
    """The serving-tier knobs the port runs now: a value the JAX package
    runs passes the port's checks and the JAX package's (``spec_errors``,
    ``quant_errors``, ``disagg_errors``) and builds an engine; a CLI call
    the JAX package refuses exits 2 printing its message."""
    cfg = fira_tiny(decode_engine=True, vocab_size=40,
                    ast_change_vocab_size=10, **good)
    jcfg = jax_fira_tiny(decode_engine=True, **good)
    assert unsupported(cfg) == []
    assert (jax_spec.spec_errors(jcfg) == jax_quant.quant_errors(jcfg)
            == jax_disagg.disagg_errors(jcfg) == [])
    engine.SlotEngine(FiraModel(cfg).init_parameters(
        torch.Generator().manual_seed(0)), cfg)
    want = jax_check(jax_fira_tiny(decode_engine=True,
                                   test_batch_size=TEST_BS))
    assert len(want) == 1 and knob.split("_")[0] in want[0]
    command, *flags = bad
    rc = cli.main([command, "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", setup["dir"], "--out-dir",
                   str(tmp_path / "o"), "--ckpt-dir", setup["ckpt"],
                   "--test-batch-size", str(TEST_BS), *flags])
    assert rc == 2
    assert want[0] in capsys.readouterr().err


def test_prefix_cache_is_refused_in_the_jax_words():
    errs = unsupported(fira_tiny(prefix_cache=True, prefix_cache_entries=0))
    assert any(e.startswith("prefix_cache requires the decode engine")
               for e in errs)
    assert any(e.startswith("prefix_cache_entries 0 must be >= 1")
               for e in errs)

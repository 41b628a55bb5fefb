"""The port's speculative draft-and-verify decode
(``fira_tpu_torch/decode/spec.py`` and the engine's spec dispatch) against
the JAX package's, on the same corpus and weights (the JAX engine jitted,
its copy head on the Pallas kernel interpreted on the CPU), mirroring
tests/test_spec.py.

Tolerances: tokens and output bytes exact; spec-on against spec-off in
the port bitwise (tokens and probabilities); the port against the JAX
engine, probabilities at rtol 1e-5 (atol 1e-7), as
tests/test_torch_engine.py holds them; the spec counters (``drafted``,
``accepted``, ``verify_dispatches``, ``steps_saved``, ``spec_frames``)
exactly equal to the JAX engine's on the same stream.

Cases: spec-on equals spec-off per sample in all four kv x factored
modes, both tiers, the arena paged and unpaged; the counters and the
samples against the JAX engine in each kv x factored mode (the tiers
alternating, as tests/test_spec.py pairs them); file bytes for k in
{2, 4}, another harvest cadence and 2 replicas; target-blind weights
saturating the copy tier's acceptance, as in the JAX engine; the stall
cooldown; the named-knob messages and the CLI's exit 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as cc

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.decode import beam as jax_beam
from fira_tpu.decode import engine as jax_engine
from fira_tpu.decode import spec as jax_spec
from fira_tpu.decode.runner import _decode_tasks
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder
from fira_tpu_torch.decode import engine, runner, spec
from fira_tpu_torch.model.model import FiraModel

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)
SPLIT = "train"
EOS_DELTA = 2.0          # mixed settle depths, slots refill mid-flight
COUNTERS = ("drafted", "accepted", "verify_dispatches", "steps_saved",
            "spec_frames", "step_dispatches", "steps", "commits")
# (kv_cache, factored_topk, tier): every kv x factored mode, the tiers
# alternating (tests/test_spec.py's pairing)
JAX_CASES = [(True, False, "draft"), (True, True, "copy"),
             (False, False, "copy"), (False, True, "draft")]


@pytest.fixture(scope="module", autouse=True)
def xla_cache(tmp_path_factory):
    """A persistent XLA compilation cache for this module (the JAX engines
    of one mode share their programs), the process's settings restored
    after."""
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
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    jds = JaxDataset(d, JaxConfig(**GEOM, copy_head_impl="pallas",
                                  decode_engine=True))
    tds = FiraDataset(d, FiraConfig(**GEOM, decode_engine=True))
    batch = make_batch(tds.splits["test"], np.arange(3), tds.cfg,
                       batch_size=4)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(1), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    # each weight set built on both sides from the same flax tree: the
    # JAX helper on the flax tree, the port's on its converted state dict
    plain = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            params))
    weights = {
        "eos": (jax_beam.eos_biased_params(params, EOS_DELTA),
                convert.params_from_flax(jax.tree_util.tree_map(
                    np.asarray, jax_beam.eos_biased_params(params,
                                                           EOS_DELTA)))),
        "blind": (jax_spec.copy_biased_params(params, delta=9.0,
                                              target_blind=True),
                  spec.copy_biased_params(plain, delta=9.0,
                                          target_blind=True)),
    }
    return dict(d=d, jds=jds, tds=tds, weights=weights, models={},
                jax_engines={}, plain={})


def _model(setup, weights):
    if weights not in setup["models"]:
        model = FiraModel(setup["tds"].cfg)
        model.load_state_dict(setup["weights"][weights][1])
        setup["models"][weights] = model.eval()
    return setup["models"][weights]


def port_run(setup, weights, **knobs):
    """({split position: (tokens, probs)}, stats) of the port's engine."""
    cfg = setup["tds"].cfg.replace(**knobs)
    eng = engine.SlotEngine(_model(setup, weights), cfg)
    data = setup["tds"].splits[SPLIT]
    tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                      batch_size=cfg.test_batch_size)
    with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
        got = {it.position: (it.tokens, it.probs) for it in eng.run(feed)}
    return got, eng.stats


def plain_run(setup, weights, **knobs):
    """The port's spec-off run in the same kv x factored x paged mode."""
    key = (weights, tuple(sorted(knobs.items())))
    if key not in setup["plain"]:
        setup["plain"][key] = port_run(setup, weights, **knobs)
    return setup["plain"][key]


def jax_run(setup, weights, **knobs):
    """({split position: (tokens, probs)}, stats) of the JAX engine; one
    engine a config, its weights swapped between runs."""
    cfg = setup["jds"].cfg.replace(**knobs)
    key = tuple(sorted(knobs.items()))
    params = setup["weights"][weights][0]
    if key not in setup["jax_engines"]:
        setup["jax_engines"][key] = jax_engine.SlotEngine(JaxModel(cfg),
                                                          params, cfg)
    eng = setup["jax_engines"][key]
    eng.params = eng._decode_params = params
    eng.stats = jax_engine.EngineStats(slots=eng.slots)
    eng._spec_cd = 0      # a fresh engine's cooldown
    tasks, _ = _decode_tasks(setup["jds"].splits[SPLIT], cfg)
    with JaxFeeder(tasks, num_workers=0, depth=1) as feed:
        got = {it.position: (np.asarray(it.tokens), np.asarray(it.probs))
               for it in eng.run(feed)}
    return got, eng.stats


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0], err_msg=str(p))
        assert got[p][1].tobytes() == want[p][1].tobytes(), p


def assert_matches_jax(got, want):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0], err_msg=str(p))
        np.testing.assert_allclose(got[p][1], want[p][1], rtol=1e-5,
                                   atol=1e-7, err_msg=str(p))


def counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


MODES = [(kv, fac, paged) for kv in (True, False) for fac in (False, True)
         for paged in ((True, False) if kv else (True,))]


@pytest.mark.parametrize("tier", ["copy", "draft"])
@pytest.mark.parametrize("kv,fac,paged", MODES)
def test_spec_equals_plain_per_sample(setup, kv, fac, paged, tier):
    """Spec on gives every sample the plain engine's tokens and
    probabilities bit for bit (only the dispatch pattern moves), with
    real drafting and fewer dispatches' worth of steps."""
    knobs = dict(beam_kv_cache=kv, beam_factored_topk=fac,
                 engine_paged_kv=paged)
    want, plain = plain_run(setup, "eos", **knobs)
    got, st = port_run(setup, "eos", spec_decode=tier, **knobs)
    assert_bitwise(got, want)
    assert st.verify_dispatches > 0 and st.drafted > 0
    assert st.commits == plain.commits == len(want)
    assert st.spec_frames >= st.verify_dispatches


@pytest.mark.parametrize("kv,fac,tier", JAX_CASES)
def test_spec_counters_and_samples_match_jax(setup, kv, fac, tier):
    """The same stream through the JAX engine's spec path and the port's:
    the samples equal (tokens exact, probs rtol 1e-5) and every spec
    counter equal."""
    knobs = dict(beam_kv_cache=kv, beam_factored_topk=fac, spec_decode=tier)
    want, jst = jax_run(setup, "eos", **knobs)
    got, st = port_run(setup, "eos", **knobs)
    assert_matches_jax(got, want)
    assert counters(st) == counters(jst)
    assert st.verify_dispatches > 0


@pytest.mark.parametrize("knobs", [
    dict(spec_decode="copy", engine_spec_k=2),
    dict(spec_decode="draft", engine_spec_k=4),
    dict(spec_decode="copy", engine_harvest_every=1),
    dict(spec_decode="draft", engine_replicas=2, engine_slots=8),
], ids=["copy-k2", "draft-k4", "copy-R1", "draft-2-replicas"])
def test_spec_file_bytes_invariant(setup, tmp_path, knobs):
    """``run_test`` writes the plain engine's bytes whatever the draft
    length, the harvest cadence or the replica count."""
    cfg = setup["tds"].cfg
    model = _model(setup, "eos")
    ref = runner.run_test(model, setup["tds"], cfg, split=SPLIT,
                          out_dir=str(tmp_path / "plain"))
    m = runner.run_test(model, setup["tds"], cfg.replace(**knobs),
                        split=SPLIT, out_dir=str(tmp_path / "spec"))
    with open(ref["output_path"], "rb") as a, \
            open(m["output_path"], "rb") as b:
        assert a.read() == b.read()
    assert m["engine"]["verify_dispatches"] > 0
    if "engine_replicas" in knobs:
        assert len(m["engine"]["per_replica_acceptance"]) == 2


def test_copy_tier_acceptance_saturates_when_target_blind(setup):
    """Target-blind copy-biased weights make the copy drafter's proxy the
    step's own copy scores: acceptance saturates as in the JAX engine
    (counters equal), steps (a verify counts one) fall below the plain
    run's and the output stays the plain run's."""
    knobs = dict(spec_decode="copy", engine_spec_k=4)
    want, plain = plain_run(setup, "blind")
    got, st = port_run(setup, "blind", **knobs)
    assert_bitwise(got, want)
    _jgot, jst = jax_run(setup, "blind", beam_kv_cache=True,
                         beam_factored_topk=True, spec_decode="copy")
    assert counters(st) == counters(jst)
    assert st.accepted > 0 and st.steps_saved > 0
    assert st.acceptance_rate > 0.5, st.summary()
    assert st.steps < plain.steps
    assert st.steps_per_commit < plain.steps_per_commit


def test_stall_cooldown_falls_back_to_plain(setup):
    """After a verify whose drafts all missed, STALL_COOLDOWN plain
    dispatches run before the next draft: some step dispatches are plain,
    the output unchanged."""
    want, _plain = plain_run(setup, "eos", beam_factored_topk=True)
    got, st = port_run(setup, "eos", spec_decode="copy",
                       beam_factored_topk=True)
    assert_bitwise(got, want)
    assert spec.STALL_COOLDOWN == jax_spec.STALL_COOLDOWN == 4
    assert st.verify_dispatches < st.step_dispatches


CONFIG_CASES = [
    dict(spec_decode="off"),
    dict(spec_decode="off", engine_spec_k=999),
    dict(spec_decode="turbo"),
    dict(spec_decode="copy", decode_engine=False),
    dict(spec_decode="draft", engine_spec_k=0),
    dict(spec_decode="draft", engine_spec_k=99),
    dict(spec_decode="draft", engine_spec_k=2),
    dict(spec_decode="copy", engine_spec_k=8, buckets=((16, 400, 6),),
         decode_tar_buckets=True),
]


@pytest.mark.parametrize("knobs", CONFIG_CASES)
def test_spec_errors_match_jax(knobs):
    kw = dict(decode_engine=True)
    kw.update(knobs)
    assert spec.spec_errors(fira_tiny(**kw)) \
        == jax_spec.spec_errors(jax_fira_tiny(**kw))
    assert (spec.DRAFT_LABEL, spec.VERIFY_LABEL, spec.SPEC_TIERS) == (
        jax_spec.DRAFT_LABEL, jax_spec.VERIFY_LABEL, jax_spec.SPEC_TIERS)


def test_cli_exits_2_on_spec_knobs(setup, tmp_path, capsys):
    """Parse-time refusals in the JAX package's words, exit 2; valid spec
    knobs pass admission (the run then stops on the missing checkpoint,
    exit 1)."""
    base = ["test", "--config", "fira-tiny", "--device", "cpu",
            "--data-dir", setup["d"], "--out-dir", str(tmp_path / "o")]
    assert cli.main(base + ["--spec-decode", "copy"]) == 2
    want = jax_spec.spec_errors(jax_fira_tiny(spec_decode="copy"))
    assert want[0] in capsys.readouterr().err
    assert cli.main(base + ["--engine", "--spec-decode", "draft",
                            "--spec-k", "99"]) == 2
    want = jax_spec.spec_errors(jax_fira_tiny(
        decode_engine=True, spec_decode="draft", engine_spec_k=99))
    assert want[0] in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main(base + ["--engine", "--spec-decode", "turbo"])
    assert exc.value.code == 2
    assert cli.main(base + ["--engine", "--spec-decode", "copy",
                            "--spec-k", "2"]) == 1


def test_labels_carry_the_spec_pair(setup):
    """The declared family gains the (S, k) draft and verify names, with
    the tier and replica tags composed as in the JAX engine; spec off
    leaves it as it was."""
    model = _model(setup, "eos")
    cfg = setup["tds"].cfg
    plain = engine.SlotEngine(model, cfg)
    assert plain.labels() == ["engine_prefill", "engine_step",
                              "engine_insert", "engine_harvest"]
    armed = engine.SlotEngine(model, cfg.replace(
        spec_decode="copy", kv_dtype="bf16", serve_precision="int8w"),
        tag="r1")
    assert armed.labels()[-2:] == [
        "engine_draft[k4.bf16kv.int8w.r1]",
        "engine_verify[k4.bf16kv.int8w.r1]"]
    assert armed.label(engine.STEP_LABEL) == "engine_step[bf16kv.int8w.r1]"

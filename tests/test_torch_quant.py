"""The port's low-precision serving tiers (``fira_tpu_torch/decode/quant.py``
and the engine's bf16 KV arena and decode-weight tiers) against the JAX
package's, mirroring tests/test_quant_tiers.py.

Tolerances: int8 codes and scales bit for bit against the JAX package's
quantizer (both quantize the same converted weights, each in its own
layout: neither side converts the other's result); the round trip within
scale / 2 an element; tier tags, namespaces, digests and messages equal;
the engine under each tier against the JAX engine under the same tier,
tokens exact and probabilities at rtol 1e-5 (atol 1e-7), as
tests/test_torch_engine.py holds them; within a tier the output bytes
equal over two runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as cc

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.decode import beam as jax_beam
from fira_tpu.decode import engine as jax_engine
from fira_tpu.decode import prefix_cache as jax_pc
from fira_tpu.decode import quant as jax_quant
from fira_tpu.decode.runner import _decode_tasks
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, fira_tiny, unsupported
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder
from fira_tpu_torch.decode import engine, paging, prefix_cache, quant, runner
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.parallel import fleet

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)
SPLIT = "train"
TIERS = [dict(kv_dtype="bf16"), dict(serve_precision="bf16"),
         dict(serve_precision="int8w")]
TIER_IDS = ["bf16kv", "bf16w", "int8w"]


@pytest.fixture(scope="module", autouse=True)
def xla_cache(tmp_path_factory):
    """A persistent XLA compilation cache for this module, the process's
    settings restored after."""
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
    params = jax_beam.eos_biased_params(params, 2.0)
    host = jax.tree_util.tree_map(np.asarray, params)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(host))
    return dict(d=d, jds=jds, tds=tds, params=params, host=host,
                model=model.eval())


def _flax_leaf(tree, name: str, tensor):
    """The flax leaf behind a port parameter name, in the port's layout
    (a Dense kernel transposed)."""
    *mods, leaf = name.split(".")
    node = tree
    for m in mods:
        node = node[m]
    if leaf == "bias":
        return node["bias"]
    if mods[-1].endswith("embed"):
        return node["embedding"]
    if tensor.dim() == 1:
        return node["scale"]
    return np.asarray(node["kernel"]).T


# --- the int8 quantizer ------------------------------------------------------

@pytest.mark.parametrize("shape,zero_cols", [
    ((7, 5, 16), ()), ((4, 3), (0, 2)), ((32, 212), (5,))])
def test_quantize_int8_equals_jax_bit_for_bit(shape, zero_cols):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    for c in zero_cols:
        w[..., c] = 0.0
    q, scale = quant.quantize_int8(w)
    jq, jscale = jax_quant.quantize_int8(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    assert q.tobytes() == np.asarray(jq).tobytes()
    assert scale.tobytes() == np.asarray(jscale).tobytes()
    tq, tscale = quant.quantize_int8(torch.from_numpy(w))
    assert tq.tobytes() == q.tobytes() and tscale.tobytes() == scale.tobytes()
    for c in zero_cols:
        assert scale[c] == 1.0 and not q[..., c].any()
    # the round trip: within half a step of each column's scale, the
    # column's extreme hit exactly (up to its one rounding)
    back = quant.dequantize_int8(torch.from_numpy(q),
                                 torch.from_numpy(scale)).numpy()
    assert back.tobytes() == np.asarray(jax_quant.dequantize_int8(
        jnp.asarray(q), jnp.asarray(scale))).tobytes()
    assert np.all(np.abs(w - back) <= scale / 2 + 1e-9)
    assert int(np.max(np.abs(q))) <= 127


def test_f32_tier_is_the_identity(setup):
    cfg = setup["tds"].cfg
    dm, scales = quant.quantize_decode_params(setup["model"], cfg)
    assert dm is setup["model"] and scales is None
    assert quant.dequant_tree(dm, None) is None
    assert quant.decode_call(dm, None, lambda: 7) == 7


@pytest.mark.parametrize("sp", ["bf16", "int8w"])
def test_decode_params_equal_jax_in_scope(setup, sp):
    """Only rank >= 2 float leaves under decoder, out_fc and copy_net
    change; the encoder is shared (not copied), 1-D leaves stay f32; the
    bf16 leaves and the int8 codes and scales equal the JAX package's
    tree leaf for leaf; the int8 reconstruction equals the JAX
    ``dequant_tree``'s."""
    model = setup["model"]
    cfg = setup["tds"].cfg.replace(serve_precision=sp)
    dm, scales = quant.quantize_decode_params(model, cfg)
    jtree, jscales = jax_quant.quantize_decode_params(setup["host"],
                                                      jax_fira_tiny(
                                                          **GEOM,
                                                          serve_precision=sp,
                                                          decode_engine=True))
    assert dm is not model and dm.encoder is model.encoder
    orig = dict(model.named_parameters())
    changed = 0
    for name, p in dm.named_parameters():
        scoped = name.split(".")[0] in quant.DECODE_WEIGHT_SCOPES
        if not scoped:
            assert p is orig[name]
            continue
        want = _flax_leaf(jtree, name, p)
        if p.dim() < 2:
            assert p.dtype == torch.float32
            assert torch.equal(p, orig[name])
            continue
        changed += 1
        if sp == "bf16":
            assert p.dtype == torch.bfloat16
            assert p.float().numpy().tobytes() == np.asarray(
                want, np.float32).tobytes()
        else:
            assert p.dtype == torch.int8
            assert p.numpy().tobytes() == np.ascontiguousarray(
                want).tobytes()
            js = np.asarray(_flax_leaf(jscales, name, p)).reshape(-1)
            assert scales[name].reshape(-1).numpy().tobytes() \
                == js.tobytes()
    assert changed == sum(1 for n, p in orig.items()
                          if n.split(".")[0] in quant.DECODE_WEIGHT_SCOPES
                          and p.dim() >= 2)
    if sp == "int8w":
        deq = quant.dequant_tree(dm, scales)
        jdeq = jax_quant.dequant_tree(jtree, jscales)
        for name, t in deq.items():
            assert t.dtype == torch.float32
            assert t.numpy().tobytes() == np.ascontiguousarray(
                _flax_leaf(jax.tree_util.tree_map(np.asarray, jdeq), name,
                           t)).tobytes()


@pytest.mark.parametrize("knobs", [{}] + TIERS + [
    dict(kv_dtype="bf16", serve_precision="int8w")])
def test_tags_namespaces_and_digests_equal_jax(setup, knobs):
    cfg = fira_tiny(decode_engine=True, **knobs)
    jcfg = jax_fira_tiny(decode_engine=True, **knobs)
    assert quant.tier_tag(cfg) == jax_quant.tier_tag(jcfg)
    ns = quant.tier_namespace(cfg)
    assert ns == jax_quant.tier_namespace(jcfg)
    assert prefix_cache.tier_namespace(cfg) == ns
    idx = np.arange(6)
    got = prefix_cache.payload_digests(
        make_batch(setup["tds"].splits[SPLIT], idx, setup["tds"].cfg,
                   batch_size=8), ns)
    want = jax_pc.payload_digests(
        jax_make_batch(setup["jds"].splits[SPLIT], idx, setup["jds"].cfg,
                       batch_size=8), ns)
    assert got == want
    assert quant.kv_seed_dtype(cfg, torch.float32) == (
        torch.bfloat16 if knobs.get("kv_dtype") == "bf16" else torch.float32)
    assert paging.kv_itemsize(cfg) == (2 if knobs.get("kv_dtype") == "bf16"
                                       else 4)


@pytest.mark.parametrize("knobs,train", [
    (dict(), False), (dict(kv_dtype="bf16", serve_precision="int8w"), False),
    (dict(kv_dtype="fp8"), False), (dict(serve_precision="int4"), False),
    (dict(kv_dtype="bf16", decode_engine=False), False),
    (dict(serve_precision="int8w", decode_engine=False), False),
    (dict(kv_dtype="bf16"), True), (dict(), True)])
def test_quant_errors_equal_jax(knobs, train):
    kw = dict(decode_engine=True)
    kw.update(knobs)
    got = quant.quant_errors(fira_tiny(**kw), train=train)
    assert got == jax_quant.quant_errors(jax_fira_tiny(**kw), train=train)
    if not train:
        assert all(e in unsupported(fira_tiny(**kw)) for e in got)


def test_cli_exits_2_on_tier_knobs(setup, tmp_path, capsys):
    """Each tier knob without the engine, and any armed tier on ``cli
    train``, exits 2 printing the JAX package's message; with the engine
    the knobs pass admission (the run stops on the missing checkpoint)."""
    base = ["test", "--config", "fira-tiny", "--device", "cpu",
            "--data-dir", setup["d"], "--out-dir", str(tmp_path / "o")]
    for flags, knobs in ((["--kv-dtype", "bf16"], dict(kv_dtype="bf16")),
                         (["--serve-precision", "int8w"],
                          dict(serve_precision="int8w"))):
        assert cli.main(base + flags) == 2
        want = jax_quant.quant_errors(jax_fira_tiny(**knobs))
        assert want and want[0] in capsys.readouterr().err
    assert cli.main(["train", "--config", "fira-tiny", "--device", "cpu",
                     "--data-dir", setup["d"], "--out-dir",
                     str(tmp_path / "t"), "--kv-dtype", "bf16"]) == 2
    want = jax_quant.quant_errors(jax_fira_tiny(kv_dtype="bf16"), train=True)
    assert want[0] in capsys.readouterr().err
    for flags in (["--kv-dtype", "fp8"], ["--serve-precision", "int4"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(base + ["--engine"] + flags)
        assert exc.value.code == 2
    assert cli.main(base + ["--engine", "--kv-dtype", "bf16",
                            "--serve-precision", "int8w"]) == 1


# --- the engine under each tier ----------------------------------------------

def port_run(setup, **knobs):
    cfg = setup["tds"].cfg.replace(**knobs)
    eng = engine.SlotEngine(setup["model"], cfg)
    data = setup["tds"].splits[SPLIT]
    tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                      batch_size=cfg.test_batch_size)
    with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
        got = {it.position: (it.tokens, it.probs) for it in eng.run(feed)}
    return got, eng


def jax_run(setup, **knobs):
    cfg = setup["jds"].cfg.replace(**knobs)
    eng = jax_engine.SlotEngine(JaxModel(cfg), setup["params"], cfg)
    tasks, _ = _decode_tasks(setup["jds"].splits[SPLIT], cfg)
    with JaxFeeder(tasks, num_workers=0, depth=1) as feed:
        got = {it.position: (np.asarray(it.tokens), np.asarray(it.probs))
               for it in eng.run(feed)}
    return got, eng


@pytest.mark.parametrize("knobs", TIERS, ids=TIER_IDS)
def test_engine_tier_matches_jax_tier(setup, knobs):
    """The port's engine under a tier decodes every sample as the JAX
    engine under the same tier, stamps the tier, and the bf16 arena
    holds half the f32 arena's bytes a slot."""
    want, jeng = jax_run(setup, **knobs)
    got, eng = port_run(setup, **knobs)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0], err_msg=str(p))
        np.testing.assert_allclose(got[p][1], want[p][1], rtol=1e-5,
                                   atol=1e-7, err_msg=str(p))
    s, js = eng.stats.summary(), jeng.stats.summary()
    for k in ("kv_dtype", "serve_precision", "kv_bytes_per_slot",
              "step_dispatches", "commits"):
        assert s[k] == js[k], k
    f32 = paging.kv_bytes_per_slot(
        setup["tds"].cfg, paged=True, block_size=eng._block_size,
        pool_blocks=eng._pool_blocks, slots=eng.slots, itemsize=4)
    assert s["kv_bytes_per_slot"] * (2 if knobs.get("kv_dtype") else 1) \
        == f32
    if knobs.get("kv_dtype"):
        assert eng._state["k_pool"].dtype == torch.bfloat16
        assert eng._state["src_proj"].dtype == torch.float32
        assert eng._state["cross_k"].dtype == torch.float32


@pytest.mark.parametrize("knobs", [
    dict(kv_dtype="bf16", serve_precision="int8w", engine_paged_kv=False),
    dict(serve_precision="bf16", beam_kv_cache=False)],
    ids=["bf16kv-int8w-unpaged", "bf16w-full-prefix"])
def test_tier_bytes_stable_and_spec_exact(setup, tmp_path, knobs):
    """Within a tier the file bytes are a function of the stream: equal
    over two runs, and spec decode writes that tier's plain bytes."""
    cfg = setup["tds"].cfg.replace(**knobs)
    outs = []
    for name, c in (("a", cfg), ("b", cfg),
                    ("spec", cfg.replace(spec_decode="copy"))):
        m = runner.run_test(setup["model"], setup["tds"], c, split=SPLIT,
                            out_dir=str(tmp_path / name))
        with open(m["output_path"], "rb") as f:
            outs.append(f.read())
        assert m["engine"]["serve_precision"] == c.serve_precision
    assert outs[0] == outs[1] == outs[2]


def test_int8_dequantized_once_a_dispatch(setup, monkeypatch):
    """int8 weights are reconstructed once a step dispatch and once a
    draft-and-verify dispatch (and once for each in the prewarm), never
    once a micro-step."""
    calls = []
    real = quant.dequant_tree
    monkeypatch.setattr(quant, "dequant_tree",
                        lambda *a: calls.append(1) or real(*a))
    cfg = setup["tds"].cfg.replace(serve_precision="int8w",
                                   spec_decode="copy")
    eng = engine.SlotEngine(setup["model"], cfg)
    eng.prewarm([make_batch(setup["tds"].splits[SPLIT], np.arange(0), cfg,
                            batch_size=cfg.test_batch_size)])
    assert len(calls) == 2
    data = setup["tds"].splits[SPLIT]
    tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                      batch_size=cfg.test_batch_size)
    with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
        list(eng.run(feed))
    assert len(calls) == 2 + eng.stats.step_dispatches
    assert eng.stats.steps > eng.stats.step_dispatches   # R=4 plain ones


def test_respawned_replica_requantizes(setup):
    """Every replica, and a replacement built mid-run, quantizes its own
    decode module from the original weights: int8 codes equal, never
    shared, the original model untouched."""
    cfg = setup["tds"].cfg.replace(serve_precision="int8w",
                                   engine_replicas=2, engine_slots=8)
    fl = fleet.EngineFleet(setup["model"], cfg, replicas=2)
    fresh = fl._build_replacement(setup["model"].encoder.word_embed
                                  .weight.device, "r9")
    engines = list(fl.engines) + [fresh]
    w = "decoder.self_attn_0.q_proj.weight"
    codes = [dict(e._dmodel.named_parameters())[w] for e in engines]
    assert all(c.dtype == torch.int8 for c in codes)
    assert all(torch.equal(c, codes[0]) for c in codes)
    assert len({id(c) for c in codes}) == len(codes)
    assert all(e._wq_scales is not None for e in engines)
    assert dict(setup["model"].named_parameters())[w].dtype == torch.float32
    assert fresh.label(engine.STEP_LABEL) == "engine_step[int8w.r9]"

"""The port's ring attention (``fira_tpu_torch/parallel/ring.py``)
against the dense oracle, both the port's and the JAX package's
``dense_reference_attention``, and the model with ``seq_shards`` against
dense cross-attention (the counterparts of tests/test_ring.py). The
port's ranks are 4 spawned gloo processes on the CPU, one module-scoped
pool (``RankPool``); ``seq_shards`` 2 groups them as (data 2, seq 2), 4 as
one ring of 4, each rank holding its rows of the batch
(``ring.ring_attend``).

- the output equals the dense oracle at rtol/atol 2e-5, causal too, and
  on fully masked rows (finite: -1e9, not -inf);
- the gradient of ``sum(out ** 2)`` through the ring's backward equals
  dense autograd at rtol/atol 5e-4 (JAX's tolerance);
- 64 positions over a ring of 4 (16 a rank) still match;
- the model's loss with ``seq_shards=2`` equals dense cross-attention at
  rtol 2e-5 (and the JAX package's dense loss on the same weights), and
  the full-prefix beam is token-exact with probabilities at rtol 2e-5 /
  atol 1e-6;
- a ``seq_shards`` that does not divide the ranks or the devices raises
  the JAX model's ValueError, and one beside tensor parallelism is
  admitted (``tests/test_torch_mesh.py`` holds its step to JAX's);
- the one-process ring (``ring.DeviceRing``) over ``["cpu"] * n``
  equals the dense oracle, a fully masked row too;
- the full-prefix beam of a ``seq_shards=2`` model over ``["cpu"] * 8``
  (ring data axis 4) equals JAX's ``beam_search`` with ``seq_shards=2``
  on its 8 devices (tokens equal, probabilities at rtol 2e-5 / atol
  1e-6, as tests/test_ring.py holds JAX's ring to its dense beam), early
  exit off and on; rows that the data axis does not divide take dense
  attention, as JAX's ``_ring_applicable`` routes them;
- the engine's full-prefix arena on that ring writes the dense engine's
  bytes;
- ``cli test`` and ``cli message`` with ``--seq-shards 2 --device cpu``
  write the dense run's bytes with the visible devices patched to 8, and
  exit 2 in the JAX model's words on the one CPU device."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.decode import beam as jax_beam
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.parallel import ring as jax_ring
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import DEVICE_FIELDS, TRAIN_FIELDS, \
    batch_to_device
from fira_tpu_torch.decode import runner
from fira_tpu_torch.decode.beam import beam_search
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.parallel import jobs
from fira_tpu_torch.parallel import mesh as pmesh
from fira_tpu_torch.parallel import ring
from fira_tpu_torch.train.state import init_state

import torch_rank_jobs

TOL = dict(rtol=2e-5, atol=2e-5)


def _mesh(seq_shards, n=4):
    return dataclasses.replace(
        pmesh.make_mesh(n, 1, devices=["cpu"] * n), seq_shards=seq_shards)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with pmesh.RankPool(_mesh(0), str(tmp_path_factory.mktemp("pool"))) as p:
        yield p


def _rand_qkv(seed, B=4, H=4, T=32, Dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, Dh)).astype(np.float32)
               for _ in range(3))
    # ragged key padding: each row keeps a random prefix
    keep = rng.integers(T // 2, T + 1, B)
    mask = np.arange(T)[None, :] < keep[:, None]
    return q, k, v, mask


def _ring(pool, seq_shards, q, k, v, mask, causal=False):
    res = pool.run(torch_rank_jobs.ring_job,
                   *(torch.from_numpy(x) for x in (q, k, v)),
                   torch.from_numpy(mask), causal, mesh=_mesh(seq_shards))
    return {n: torch.cat([r[n] for r in res]).numpy() for n in res[0]}


def _dense(q, k, v, mask, causal=False):
    return ring.dense_reference_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        causal=causal).numpy()


@pytest.mark.parametrize("seq_shards", [2, 4])
def test_matches_dense_oracle(pool, seq_shards):
    q, k, v, mask = _rand_qkv(0)
    want = _dense(q, k, v, mask)
    np.testing.assert_allclose(want, np.asarray(
        jax_ring.dense_reference_attention(q, k, v, mask)), **TOL)
    got = _ring(pool, seq_shards, q, k, v, mask)["out"]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seq_shards", [2, 4])
def test_causal_matches_dense_oracle(pool, seq_shards):
    q, k, v, mask = _rand_qkv(1)
    want = _dense(q, k, v, mask, causal=True)
    np.testing.assert_allclose(want, np.asarray(
        jax_ring.dense_reference_attention(q, k, v, mask, causal=True)),
        **TOL)
    got = _ring(pool, seq_shards, q, k, v, mask, causal=True)["out"]
    np.testing.assert_allclose(got, want, **TOL)


def test_fully_masked_rows_match_dense_semantics(pool):
    # -1e9 (not -inf) masking: a fully masked query row degrades to a
    # near-uniform average like the dense Attention, never NaN
    q, k, v, _ = _rand_qkv(2)
    mask = np.zeros((q.shape[0], q.shape[2]), dtype=bool)
    want = _dense(q, k, v, mask)
    np.testing.assert_allclose(want, np.asarray(
        jax_ring.dense_reference_attention(q, k, v, mask)), **TOL)
    got = _ring(pool, 2, q, k, v, mask)
    assert np.isfinite(got["out"]).all()
    np.testing.assert_allclose(got["out"], want, **TOL)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (ring.dense_reference_attention(qt, kt, vt, torch.from_numpy(mask))
     ** 2).sum().backward()
    for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
        np.testing.assert_allclose(got[name], t.grad.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq_shards", [2, 4])
def test_gradient_through_ring_backward(pool, seq_shards, causal):
    q, k, v, mask = _rand_qkv(3)
    got = _ring(pool, seq_shards, q, k, v, mask, causal=causal)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring.dense_reference_attention(qt, kt, vt, torch.from_numpy(mask),
                                         causal=causal)
    (out ** 2).sum().backward()
    for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
        np.testing.assert_allclose(got[name], t.grad.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


def test_longer_than_rank_count_blocks(pool):
    # T=64 over a ring of 4: 16 keys and queries a rank
    q, k, v, mask = _rand_qkv(4, T=64)
    want = _dense(q, k, v, mask, causal=True)
    got = _ring(pool, 4, q, k, v, mask, causal=True)["out"]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_dev,seq_shards", [(2, 2), (4, 4), (8, 2)],
                         ids=["2dev-s2", "4dev-s4", "8dev-s2"])
def test_device_ring_matches_dense_oracle(n_dev, seq_shards):
    q, k, v, mask = _rand_qkv(5, B=8)
    mask[1] = False          # a fully masked row: -1e9, not -inf
    want = _dense(q, k, v, mask)
    np.testing.assert_allclose(want, np.asarray(
        jax_ring.dense_reference_attention(q, k, v, mask)), **TOL)
    dr = ring.DeviceRing(["cpu"] * n_dev, seq_shards)
    assert dr.n_data == n_dev // seq_shards and dr.applicable(8, 32, 32)
    assert not dr.applicable(8, 31, 32) and not dr.applicable(8, 32, 33)
    assert dr.applicable(6, 32, 32) == (6 % dr.n_data == 0)
    got = dr.attend(*(torch.from_numpy(x) for x in (q, k, v)),
                    torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def model_setup(tmp_path_factory):
    # batch 8 = 4 ranks x 2 rows; S = 32 + 24 = 56 and tar 12 divide seq 2
    d = str(tmp_path_factory.mktemp("ring_corpus"))
    synthetic.write_corpus_dir(d, n_commits=24, seed=9)
    ds = FiraDataset(d, fira_tiny(batch_size=8, test_batch_size=8,
                                  dropout_rate=0.0, gcn_dropout_rate=0.0))
    cfg = ds.cfg
    host = make_batch(ds.splits["train"], np.arange(8), cfg, batch_size=8)
    model = init_state(cfg, "cpu").model.eval()
    return dict(cfg=cfg, host=host, model=model, full=model.state_dict(),
                dir=d, ds=ds, jax={})


def _jax_side(model_setup):
    """JAX's config and parameters of the port's weights (built once).
    The parameters are copies: a pool job moves the port's tensors into
    shared memory, and an array that aliased their old storage would
    read freed memory."""
    if not model_setup["jax"]:
        cfg = model_setup["cfg"]
        model_setup["jax"].update(
            params=jax.tree_util.tree_map(
                lambda x: jnp.asarray(np.array(x)),
                convert.params_to_flax(model_setup["full"])),
            cfg=JaxConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(JaxConfig)}))
    return model_setup["jax"]["cfg"], model_setup["jax"]["params"]


def _ring_model(model_setup, cfg, n_dev=8):
    model = FiraModel(cfg.replace(seq_shards=2),
                      ring_devices=["cpu"] * n_dev).eval()
    model.load_state_dict(model_setup["full"])
    return model


def test_model_loss_and_beam_match_dense(pool, model_setup):
    cfg, host, model = (model_setup[k] for k in ("cfg", "host", "model"))
    with torch.no_grad():
        nll, cnt = model(batch_to_device(host, torch.device("cpu"),
                                         TRAIN_FIELDS))
        tokens, probs = beam_search(model, batch_to_device(
            host, torch.device("cpu"), DEVICE_FIELDS), cfg)
    jcfg, jparams = _jax_side(model_setup)
    jnll, jcnt = jax.jit(lambda p, b: JaxModel(jcfg).apply(
        {"params": p}, b, deterministic=True))(
            jparams, {k: jnp.asarray(v) for k, v in host.items()})
    np.testing.assert_allclose(float(nll), float(jnll), rtol=2e-5)
    assert int(cnt) == int(jcnt)
    res = pool.run(jobs.model_job, cfg.replace(seq_shards=2),
                   model_setup["full"], host, beam=True, mesh=_mesh(2))
    assert sum(r["count"] for r in res) == int(cnt)
    np.testing.assert_allclose(sum(r["nll"] for r in res), float(nll),
                               rtol=2e-5)
    # the full-prefix beam rides the ring with tar-length queries
    np.testing.assert_array_equal(
        torch.cat([r["tokens"] for r in res]).numpy(), tokens.numpy())
    np.testing.assert_allclose(torch.cat([r["probs"] for r in res]).numpy(),
                               probs.numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("early_exit", [False, True], ids=["scan", "early"])
def test_device_ring_beam_matches_jax(model_setup, early_exit):
    cfg = model_setup["cfg"].replace(beam_early_exit=early_exit)
    host = model_setup["host"]
    jcfg, jparams = _jax_side(model_setup)
    jcfg = jcfg.replace(seq_shards=2, beam_early_exit=early_exit)
    assert len(jax.devices()) == 8    # JAX's ring mesh: (data 4, seq 2)
    jtok, jprobs = jax_beam.beam_search(
        JaxModel(jcfg), jparams, {k: jnp.asarray(v) for k, v in host.items()},
        jcfg)
    model = _ring_model(model_setup, cfg)
    batch = batch_to_device(host, torch.device("cpu"), DEVICE_FIELDS)
    ring.ROUTES.clear()
    tokens, probs, steps = beam_search(model, batch, cfg, with_steps=True)
    # 8 items x 3 beams = 24 rows over the data axis 4: every step's
    # cross-attention of every layer rides the ring
    assert ring.ROUTES == {"ring": cfg.num_layers * steps}
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=2e-5,
                               atol=1e-6)
    # 3 items: 9 rows, which the data axis 4 does not divide: dense, as
    # JAX's _ring_applicable routes them, so the dense model's own beam
    few = {k: v[:3] for k, v in batch.items()}
    ring.ROUTES.clear()
    got = beam_search(model, few, cfg, with_steps=True)
    assert ring.ROUTES == {"dense": cfg.num_layers * got[2]}
    want = beam_search(model_setup["model"], few, cfg, with_steps=True)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))


def test_engine_full_prefix_arena_on_the_ring(model_setup, tmp_path):
    cfg = model_setup["cfg"].replace(decode_engine=True, beam_kv_cache=False)
    ds = model_setup["ds"]
    dense = runner.run_test(model_setup["model"], ds, cfg, split="train",
                            out_dir=str(tmp_path / "dense"))
    ring.ROUTES.clear()
    got = runner.run_test(_ring_model(model_setup, cfg), ds,
                          cfg.replace(seq_shards=2), split="train",
                          out_dir=str(tmp_path / "ring"))
    # 8 slots x 3 beams = 24 arena rows: every micro-step rides the ring
    assert ring.ROUTES["ring"] > 0 and not ring.ROUTES["dense"]
    assert got["n"] == dense["n"] > 8
    name = runner.output_name(None)
    with open(tmp_path / "dense" / name, "rb") as a, \
            open(tmp_path / "ring" / name, "rb") as b:
        assert a.read() == b.read()


MESSAGE_DIFF = (
    "diff --git a/src/Foo.java b/src/Foo.java\n"
    "--- a/src/Foo.java\n+++ b/src/Foo.java\n"
    "@@ -10,4 +10,4 @@ class Foo\n"
    " public void run ( ) {\n"
    "-int count = 42 ;\n"
    "+for ( int i = 0 ; i < 9 ; i ++ ) { step ( i ) ; }\n"
    " }\n")


def test_cli_decode_commands_with_seq_shards(model_setup, tmp_path, capsys,
                                             monkeypatch):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(model_setup["full"], ckpt / "best.pt")
    diff = tmp_path / "one.diff"
    diff.write_text(MESSAGE_DIFF)
    base = ["--config", "fira-tiny", "--data-dir", model_setup["dir"],
            "--ckpt-dir", str(ckpt), "--device", "cpu", "--batch-size", "8",
            "--test-batch-size", "8"]

    def run(tag, *extra):
        out = str(tmp_path / tag)
        assert cli.main(["test", *base, "--out-dir", out, *extra]) == 0
        with open(os.path.join(out, runner.output_name(None)), "rb") as f:
            written = f.read()
        capsys.readouterr()
        assert cli.main(["message", str(diff), *base, *extra]) == 0
        return written, capsys.readouterr().out

    want = run("dense")
    assert want[0] and want[1].strip()
    # on the one CPU device JAX's model raises; the CLI exits 2 in its words
    for cmd in (["test", *base, "--out-dir", str(tmp_path / "x")],
                ["message", str(diff), *base]):
        assert cli.main([*cmd, "--seq-shards", "2"]) == 2
        assert "seq_shards=2 does not divide the 1 visible devices" in \
            capsys.readouterr().err
    monkeypatch.setattr(ring, "visible_device_count", lambda kind: 8)
    ring.ROUTES.clear()
    assert run("ring", "--seq-shards", "2") == want
    # the cached beam's cross-attention has one-position queries: dense,
    # as in JAX
    assert ring.ROUTES["dense"] > 0 and not ring.ROUTES["ring"]


def test_indivisible_seq_shards_raise(model_setup):
    cfg = model_setup["cfg"]
    with pytest.raises(ValueError, match="seq_shards=3"):
        FiraModel(cfg.replace(seq_shards=3), mesh=_mesh(3))
    with pytest.raises(ValueError, match="seq_shards=2 does not divide the "
                                         "1 visible devices"):
        FiraModel(cfg.replace(seq_shards=2))   # no mesh: the one CPU device
    with pytest.raises(ValueError, match="seq_shards=3 does not divide the "
                                         "8 visible devices"):
        FiraModel(cfg.replace(seq_shards=3), ring_devices=["cpu"] * 8)
    # beside tensor parallelism: admitted wherever seq_shards divides the
    # ranks (tests/test_torch_mesh.py runs it)
    assert pmesh.layout_errors(cfg.replace(seq_shards=2), 2, 2) == []
    assert pmesh.layout_errors(cfg.replace(seq_shards=4), 2, 2) == []
    assert pmesh.layout_errors(cfg.replace(seq_shards=3), 4, 1) == [
        "seq_shards=3 does not divide the 4 visible devices"]

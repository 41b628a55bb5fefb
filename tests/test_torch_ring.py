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
- a ``seq_shards`` that does not divide the ranks raises a ValueError
  naming it, and one beside tensor parallelism names the ROADMAP item."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.parallel import ring as jax_ring
from fira_tpu_torch import convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import DEVICE_FIELDS, TRAIN_FIELDS, \
    batch_to_device
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
    return dict(cfg=cfg, host=host, model=model, full=model.state_dict())


def test_model_loss_and_beam_match_dense(pool, model_setup):
    cfg, host, model = (model_setup[k] for k in ("cfg", "host", "model"))
    with torch.no_grad():
        nll, cnt = model(batch_to_device(host, torch.device("cpu"),
                                         TRAIN_FIELDS))
        tokens, probs = beam_search(model, batch_to_device(
            host, torch.device("cpu"), DEVICE_FIELDS), cfg)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_flax(model_setup["full"]))
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(JaxConfig)})
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


def test_indivisible_seq_shards_raise(model_setup):
    cfg = model_setup["cfg"]
    with pytest.raises(ValueError, match="seq_shards=3"):
        FiraModel(cfg.replace(seq_shards=3), mesh=_mesh(3))
    with pytest.raises(ValueError, match="seq_shards"):
        FiraModel(cfg.replace(seq_shards=2))   # no mesh: one rank
    tp = dataclasses.replace(pmesh.make_mesh(2, 2, devices=["cpu"] * 4),
                             seq_shards=2)
    with pytest.raises(ValueError, match="ROADMAP A.10"):
        FiraModel(cfg.replace(seq_shards=2), mesh=tp)
    assert pmesh.layout_errors(cfg.replace(seq_shards=3), 4, 1) == [
        "seq_shards=3 does not divide the 4 visible devices"]

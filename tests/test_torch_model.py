"""The port's FiraModel against the JAX package's on the same weights and
batch: encoder states, decode_init, the full-prefix fused distribution and
the cached one-position step (f32, rtol/atol 1e-5: the two frameworks sum
matmuls and softmaxes in different orders). Also the port's copied batch
assembly against the JAX package's, and the weight converter's round trip.
The JAX side runs the Pallas copy-score kernel, interpreted on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import convert
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.model.model import FiraModel

TOL = dict(rtol=1e-5, atol=1e-5)
GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)


N_STEPS = 3


def _jax_outputs(model, params, batch, cfg):
    """Everything the tests compare, from ONE jitted program (eager
    op-by-op dispatch, and the Pallas interpreter under it, is slow)."""
    msg = batch["msg"].astype(jnp.int32)
    states, mask = model.apply(params, batch, method=JaxModel.encode)
    init = model.apply(params, states, method=JaxModel.decode_init)
    fused = model.apply(params, states, mask, msg, msg != 0,
                        method=JaxModel.fused_probs)
    L, H, T = cfg.num_layers, cfg.num_head, cfg.tar_len
    k = v = jnp.zeros((L, msg.shape[0], H, T, cfg.embedding_dim // H))
    steps = []
    for s in range(N_STEPS):
        valid = (msg != 0) & (jnp.arange(T)[None, :] <= s)
        valid = valid.at[:, 0].set(True)[:, None, None, :]
        f, k, v = model.apply(params, mask, msg[:, s : s + 1], s, k, v,
                              *init, valid, method=JaxModel.fused_probs_step)
        steps.append((f, k, v))
    return dict(states=states, mask=mask, init=init, fused=fused, steps=steps)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=24, seed=11)
    synthetic.write_corpus_dir(tdir, n_commits=24, seed=11)
    jds = JaxDataset(jdir, JaxConfig(**GEOM, copy_head_impl="pallas"))
    tds = FiraDataset(tdir, FiraConfig(**GEOM))
    jcfg, tcfg = jds.cfg, tds.cfg
    idx = np.arange(3)   # a partial batch: one all-pad row
    jbatch = jax_make_batch(jds.splits["train"], idx, jcfg, batch_size=4)
    tbatch = make_batch(tds.splits["train"], idx, tcfg, batch_size=4)
    jmodel = JaxModel(jcfg)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    variables = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(0), b, deterministic=True))(jb)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, b: _jax_outputs(jmodel, p, b, jcfg))(variables, jb))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel = FiraModel(tcfg)
    tmodel.load_state_dict(convert.params_from_flax(params))
    tmodel.eval()
    return dict(jcfg=jcfg, tcfg=tcfg, jbatch=jbatch, tbatch=tbatch,
                params=params, tmodel=tmodel, ref=ref)


def test_batches_match_jax(setup):
    jb, tb = setup["jbatch"], setup["tbatch"]
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)


def test_convert_round_trip(setup):
    params = setup["params"]
    back = convert.params_to_flax(convert.params_from_flax(params))
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        assert flat_back[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))


def test_state_dict_covers_every_parameter(setup):
    sd = convert.params_from_flax(setup["params"])
    assert set(sd) == set(setup["tmodel"].state_dict())
    assert sd["copy_net.score.weight"].shape == (1, setup["tcfg"].embedding_dim)


def _encode(setup):
    tb = batch_to_device(setup["tbatch"], torch.device("cpu"))
    with torch.no_grad():
        return setup["tmodel"].encode(tb)


def test_encode_matches_jax(setup):
    states, mask = _encode(setup)
    np.testing.assert_array_equal(mask.numpy(), setup["ref"]["mask"])
    np.testing.assert_allclose(states.numpy(), setup["ref"]["states"], **TOL)


def test_decode_init_matches_jax(setup):
    states, _ = _encode(setup)
    with torch.no_grad():
        got = setup["tmodel"].decode_init(states)
    for want, t in zip(setup["ref"]["init"], got):
        assert want.shape == tuple(t.shape)
        np.testing.assert_allclose(t.numpy(), want, **TOL)


def test_fused_probs_matches_jax(setup):
    states, mask = _encode(setup)
    msg = torch.from_numpy(setup["tbatch"]["msg"]).long()
    with torch.no_grad():
        got = setup["tmodel"].fused_probs(states, mask, msg, msg != 0)
    cfg = setup["tcfg"]
    assert got.shape == (4, cfg.tar_len, cfg.output_vocab_size)
    np.testing.assert_allclose(got.numpy(), setup["ref"]["fused"], **TOL)


def test_fused_probs_step_matches_jax(setup):
    """Three cached steps on the same inputs: the fused distribution and
    the filled cache positions agree with the JAX package's."""
    cfg, tmodel = setup["tcfg"], setup["tmodel"]
    states, mask = _encode(setup)
    msg = torch.from_numpy(setup["tbatch"]["msg"]).long()
    L, H, T = cfg.num_layers, cfg.num_head, cfg.tar_len
    k = torch.zeros((L, msg.shape[0], H, T, cfg.embedding_dim // H))
    v = torch.zeros_like(k)
    with torch.no_grad():
        init = tmodel.decode_init(states)
        for s, (wf, wk, wv) in enumerate(setup["ref"]["steps"]):
            valid = (msg != 0) & (torch.arange(T)[None, :] <= s)
            valid[:, 0] = True
            f, k, v = tmodel.fused_probs_step(mask, msg[:, s : s + 1], s, k,
                                              v, *init,
                                              valid[:, None, None, :])
            np.testing.assert_allclose(f.numpy(), wf, **TOL)
            np.testing.assert_allclose(k.numpy(), wk, **TOL)
            np.testing.assert_allclose(v.numpy(), wv, **TOL)


def test_unsupported_knob_raises():
    with pytest.raises(ValueError, match="beam_early_exit"):
        FiraModel(FiraConfig(**GEOM, vocab_size=40, ast_change_vocab_size=10,
                             beam_early_exit=True))

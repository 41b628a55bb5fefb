"""bf16 compute in the port (``compute_dtype="bfloat16"``,
``stable_residual``) against the JAX package's bf16 on the same weights
and batch (a tiny geometry; the JAX side runs the Pallas copy head,
interpreted on the CPU, in one jitted program):

- the bf16 wire: edge values rounded on the host to the same bits as the
  JAX package's ``ml_dtypes`` values, every other field equal;
- ``stable_residual=False`` in f32 is bitwise the default (loss and every
  gradient), as ``tests/test_model.py`` pins for JAX;
- the bf16 loss within rtol 2e-2 of JAX bf16 (the JAX package's own bf16
  tolerance, ``tests/test_model.py``), the token count exact;
- each parameter's bf16 gradient: its relative L2 distance to the JAX
  bf16 gradient is at most twice that tensor's JAX bf16-versus-f32
  distance (bf16 rounds at other places in the two frameworks; the bound
  says the port is no further from JAX bf16 than twice JAX bf16's own
  distance from f32);
- ``stable_residual=False`` in bf16 within 2 % of the loss, as in JAX;
- an f32 checkpoint decodes in bf16 through the port's beam (shape,
  finite probabilities; the share of tokens equal to the JAX bf16 beam's
  is printed) and through ``cli test --dtype bfloat16``."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode.beam import make_beam_search
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.decode.beam import beam_search_cached
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.train import step as step_lib

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4,
            dropout_rate=0.0, gcn_dropout_rate=0.0)
BF16 = dict(compute_dtype="bfloat16")


def _jax_side(m32, m16, m16n, params, b32, b16, search16):
    def loss(m, b):
        def f(p):
            nll, cnt = m.apply({"params": p}, b, deterministic=True)
            return nll / jnp.maximum(cnt, 1), (nll, cnt)
        return jax.value_and_grad(f, has_aux=True)(params)

    out = {}
    for name, m, b in (("f32", m32, b32), ("bf16", m16, b16)):
        (_, (nll, cnt)), g = loss(m, b)
        out[name] = dict(nll=nll, cnt=cnt, grads=g)
    nll, cnt = m16n.apply({"params": params}, b16, deterministic=True)
    out["bf16_nores"] = dict(nll=nll, cnt=cnt)
    out["beam"] = search16(params, b16)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=40, seed=7)
    synthetic.write_corpus_dir(tdir, n_commits=40, seed=7)
    jds = JaxDataset(jdir, JaxConfig(**GEOM, copy_head_impl="pallas"))
    tds = FiraDataset(tdir, FiraConfig(**GEOM))
    jcfg, tcfg = jds.cfg, tds.cfg
    jcfg16 = jcfg.replace(**BF16)
    idx = np.arange(3)   # a partial batch: one all-pad row
    split_j, split_t = jds.splits["train"], tds.splits["train"]
    jb = {k: jax_make_batch(split_j, idx, c, batch_size=4)
          for k, c in (("f32", jcfg), ("bf16", jcfg16))}
    tb = {k: make_batch(split_t, idx, c, batch_size=4)
          for k, c in (("f32", tcfg), ("bf16", tcfg.replace(**BF16)))}
    m32 = JaxModel(jcfg)
    m16 = JaxModel(jcfg16, dtype=jnp.bfloat16)
    m16n = JaxModel(jcfg16.replace(stable_residual=False), dtype=jnp.bfloat16)
    j32 = {k: jnp.asarray(v) for k, v in jb["f32"].items()}
    j16 = {k: jnp.asarray(v) for k, v in jb["bf16"].items()}
    params = jax.jit(lambda b: m32.init(
        jax.random.PRNGKey(0), b, deterministic=True))(j32)["params"]
    search16 = make_beam_search(m16, jcfg16)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda p, a, b: _jax_side(m32, m16, m16n, p, a, b, search16))(
            params, j32, j16))
    return dict(jb=jb, tb=tb, tcfg=tcfg, ref=ref, tds=tds, tdir=tdir,
                state_dict=convert.params_from_flax(
                    jax.tree_util.tree_map(np.asarray, params)))


def _flat(tree):
    return {k: v.numpy() for k, v in convert.params_from_flax(tree).items()}


def _port(setup, **kw):
    """Loss (nll, count) and every gradient of the port on the batch of its
    dtype, with the weights JAX initialised."""
    cfg = setup["tcfg"].replace(**kw)
    model = FiraModel(cfg)
    model.load_state_dict(setup["state_dict"])
    key = "bf16" if cfg.compute_dtype == "bfloat16" else "f32"
    batch = batch_to_device(setup["tb"][key], torch.device("cpu"),
                            TRAIN_FIELDS)
    with torch.no_grad():
        nll, cnt = model(batch)
    step_lib.loss_fn(model, batch).backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return float(nll), int(cnt), grads


def test_bf16_wire_values_are_the_jax_bits(setup):
    jb, tb = setup["jb"]["bf16"], setup["tb"]["bf16"]
    assert sorted(jb) == sorted(tb)
    assert jb["values"].dtype == ml_dtypes.bfloat16
    assert tb["values"].dtype == np.uint16
    np.testing.assert_array_equal(jb["values"].view(np.uint16), tb["values"])
    for k in jb:
        if k != "values":
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    # on the device: bf16, and the same bits as the f32 values cast there
    dev = batch_to_device(tb, torch.device("cpu"))["values"]
    f32 = torch.from_numpy(setup["tb"]["f32"]["values"])
    assert dev.dtype == torch.bfloat16
    assert torch.equal(dev.view(torch.int16), f32.to(torch.bfloat16).view(
        torch.int16))
    # the wire stays f32 where the JAX package keeps it f32
    cfg = setup["tcfg"].replace(compute_dtype="bfloat16", typed_edges=True)
    assert make_batch(setup["tds"].splits["train"], np.arange(3), cfg,
                      batch_size=4)["values"].dtype == np.float32


def test_stable_residual_off_is_exact_in_f32(setup):
    nll_a, cnt_a, ga = _port(setup)
    nll_b, cnt_b, gb = _port(setup, stable_residual=False)
    assert (nll_a, cnt_a) == (nll_b, cnt_b)
    for n in ga:
        assert np.array_equal(ga[n], gb[n]), n


def test_bf16_loss_matches_jax_bf16(setup):
    ref = setup["ref"]["bf16"]
    nll, cnt, _ = _port(setup, **BF16)
    assert cnt == int(ref["cnt"])
    np.testing.assert_allclose(nll, float(ref["nll"]), rtol=2e-2)


def _rel(a, b):
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def test_bf16_gradients_within_twice_the_jax_bf16_gap(setup):
    _, _, grads = _port(setup, **BF16)
    j16 = _flat(setup["ref"]["bf16"]["grads"])
    j32 = _flat(setup["ref"]["f32"]["grads"])
    assert sorted(grads) == sorted(j16)
    worst = []
    for n, g in grads.items():
        assert np.isfinite(g).all(), n
        port_gap, jax_gap = _rel(g, j16[n]), _rel(j16[n], j32[n])
        worst.append((port_gap / max(jax_gap, 1e-30), n, port_gap, jax_gap))
        assert port_gap <= 2 * jax_gap, (n, port_gap, jax_gap)
    worst.sort(reverse=True)
    print("largest port-vs-JAX-bf16 / JAX-bf16-vs-f32 ratios:",
          [(n, round(r, 3)) for r, n, _, _ in worst[:5]])


def test_stable_residual_off_close_in_bf16(setup):
    a, ca, _ = _port(setup, **BF16)
    b, cb, _ = _port(setup, stable_residual=False, **BF16)
    la, lb = a / ca, b / cb
    assert abs(la - lb) / abs(la) < 0.02, (la, lb)
    ref = setup["ref"]["bf16_nores"]
    np.testing.assert_allclose(b, float(ref["nll"]), rtol=2e-2)


def test_f32_checkpoint_decodes_in_bf16(setup, tmp_path):
    path = str(tmp_path / "best.pt")
    torch.save(setup["state_dict"], path)
    cfg = setup["tcfg"].replace(**BF16)
    model = FiraModel(cfg)
    model.load_state_dict(torch.load(path, weights_only=True))
    assert model.dtype == torch.bfloat16
    batch = batch_to_device(setup["tb"]["bf16"], torch.device("cpu"))
    tokens, probs = beam_search_cached(model, batch, cfg)
    assert tokens.shape == (4, cfg.beam_size, cfg.tar_len)
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()
    jtok, jprobs = setup["ref"]["beam"]
    assert jtok.shape == tuple(tokens.shape)
    print(f"bf16 beam tokens equal to the JAX bf16 beam's: "
          f"{(tokens.numpy() == jtok).mean():.3f} "
          f"(best beams {(tokens.numpy()[np.arange(4), probs.argmax(1)] == jtok[np.arange(4), jprobs.argmax(1)]).mean():.3f})")


def test_cli_test_decodes_an_f32_checkpoint_in_bf16(setup, tmp_path):
    """``cli test --dtype bfloat16`` reads an f32 ``best.pt`` (fira-tiny
    weights from a seed) and writes one line per test commit."""
    ds = FiraDataset(setup["tdir"], fira_tiny())
    model = FiraModel(ds.cfg).init_parameters(torch.Generator().manual_seed(0))
    assert model.dtype == torch.float32
    os.makedirs(tmp_path / "ckpt")
    torch.save(model.state_dict(), str(tmp_path / "ckpt" / "best.pt"))
    out = tmp_path / "out"
    rc = cli.main(["test", "--config", "fira-tiny", "--device", "cpu",
                   "--dtype", "bfloat16", "--data-dir", setup["tdir"],
                   "--out-dir", str(out), "--ckpt-dir",
                   str(tmp_path / "ckpt"), "--feeder-workers", "1"])
    assert rc == 0
    with open(out / "output_fira") as f:
        lines = f.read().split("\n")[:-1]
    assert len(lines) == len(ds.splits["test"])


def test_unknown_compute_dtype_is_refused():
    from fira_tpu_torch.config import unsupported

    cfg = FiraConfig(**GEOM, vocab_size=50, ast_change_vocab_size=10)
    assert not unsupported(cfg.replace(compute_dtype="bfloat16",
                                       stable_residual=False))
    errs = unsupported(cfg.replace(compute_dtype="float16"))
    assert errs and "compute_dtype='float16'" in errs[0]
    with pytest.raises(ValueError, match="compute_dtype"):
        FiraModel(cfg.replace(compute_dtype="float16"))

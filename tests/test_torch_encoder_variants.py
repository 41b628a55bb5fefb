"""The encoder variants of the port against the JAX model on the same
weights and batch (a tiny geometry, dropout off; the JAX side jitted, its
copy head on the Pallas kernel interpreted on the CPU): the split node
buffer, the segment (COO) adjacency with and without sorted edges, the
flat adjacency scatter, and typed edges at init, with non-unit gains, and
with the segment adjacency. For each: the host batch equal to the JAX
package's byte for byte, ``encode`` at rtol/atol 1e-5, the loss at rtol
1e-5 with the count exact, and every gradient (``edge_gain``'s included)
at rtol 5e-4 / atol 1e-5.

Also: the flat scatter bit-identical to the N-D one and to the JAX one;
``coo_matvec`` against the dense product and accumulating in f32 under
bf16; typed edges at init bit-identical to untyped with a gradient
reaching every edge family; the split path's dropout stream equal to the
single path's; the refusals (in the JAX model's words) and the knobs now
run; ``convert`` carrying ``edge_gain`` both ways; ``edge_kinds`` on the
device and in a stacked group; ``cli train`` with the encoder flags."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model import model as jax_model
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, unsupported
from fira_tpu_torch.data import grouping, synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.data.graph_build import N_EDGE_KINDS
from fira_tpu_torch.model import model as model_lib
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.state import CheckpointManager

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4,
            dropout_rate=0.0, gcn_dropout_rate=0.0)
GAINS = np.asarray([1.5, 0.5, 2.0, 0.25, 1.0, 0.75, 1.25], np.float32)

VARIANTS = {
    "split": (dict(encoder_buffer="split"), None),
    "segment": (dict(adjacency_impl="segment"), None),
    "segment_sorted": (dict(adjacency_impl="segment", sort_edges=True), None),
    "flat": (dict(flat_scatter=True, sort_edges=True), None),
    "typed_init": (dict(typed_edges=True), np.ones(N_EDGE_KINDS, np.float32)),
    "typed_gains": (dict(typed_edges=True), GAINS),
    "typed_segment": (dict(typed_edges=True, adjacency_impl="segment"),
                      GAINS),
}
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
ENCODE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    jds = JaxDataset(d, JaxConfig(**GEOM, copy_head_impl="pallas"))
    jcfg = jds.cfg
    tcfg = FiraConfig(**GEOM, vocab_size=jcfg.vocab_size,
                      ast_change_vocab_size=jcfg.ast_change_vocab_size)
    split = jds.splits["train"]
    chunk = np.arange(3)           # a partial batch: one all-pad row
    jb = {k: jnp.asarray(v) for k, v in
          jax_make_batch(split, chunk, jcfg.replace(typed_edges=True),
                         batch_size=4).items()}
    params = jax.jit(lambda b: JaxModel(jcfg.replace(typed_edges=True)).init(
        jax.random.PRNGKey(2), b, deterministic=True))(jb)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return dict(jcfg=jcfg, tcfg=tcfg, split=split, chunk=chunk,
                params=params)


def _params(setup, gains):
    p = {k: v for k, v in setup["params"].items() if k != "edge_gain"}
    if gains is not None:
        p["edge_gain"] = gains
    return p


def _jax_reference(jcfg, params, batch):
    model = JaxModel(jcfg)

    def run(p, b):
        states, _ = model.apply({"params": p}, b,
                                method=JaxModel.encode)

        def loss(q):
            nll, cnt = model.apply({"params": q}, b, deterministic=True)
            return nll / jnp.maximum(cnt, 1), (nll, cnt)

        (_, (nll, cnt)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return states, nll, cnt, grads

    states, nll, cnt, grads = jax.jit(run)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return (np.asarray(states), float(nll), int(cnt),
            {k: v.numpy() for k, v in convert.params_from_flax(
                jax.tree_util.tree_map(np.asarray, grads)).items()})


def _port_loss_grads(model, batch):
    model.zero_grad(set_to_none=True)
    nll, cnt = model(batch)
    (nll / cnt.clamp(min=1)).backward()
    return (float(nll.detach()), int(cnt),
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(setup, variant):
    knobs, gains = VARIANTS[variant]
    jcfg = setup["jcfg"].replace(**knobs)
    tcfg = setup["tcfg"].replace(**knobs)
    assert unsupported(tcfg) == []
    batch = make_batch(setup["split"], setup["chunk"], tcfg, batch_size=4)
    jbatch = jax_make_batch(setup["split"], setup["chunk"], jcfg,
                            batch_size=4)
    assert sorted(batch) == sorted(jbatch)
    assert ("edge_kinds" in batch) == bool(tcfg.typed_edges)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    params = _params(setup, gains)
    states, nll, cnt, grads = _jax_reference(jcfg, params, batch)

    model = FiraModel(tcfg)
    model.load_state_dict(convert.params_from_flax(params))
    model.eval()
    tb = batch_to_device(batch, torch.device("cpu"), TRAIN_FIELDS)
    with torch.no_grad():
        got_states, _ = model.encode(tb)
    np.testing.assert_allclose(got_states.numpy(), states, **ENCODE_TOL)
    got_nll, got_cnt, got_grads = _port_loss_grads(model, tb)
    assert got_cnt == cnt
    np.testing.assert_allclose(got_nll, nll, **LOSS_TOL)
    assert sorted(got_grads) == sorted(grads)
    assert ("edge_gain" in got_grads) == bool(tcfg.typed_edges)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g, grads[name], **GRAD_TOL, err_msg=name)


def _graph(seed=0, B=3, N=20, E=64, dt=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N, (B, E)).astype(np.int16),
            rng.integers(0, N, (B, E)).astype(np.int16),
            rng.normal(size=(B, E)).astype(dt), N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_scatter_bit_identical(setup, dtype):
    """Deduplicated cells, as graph_build guarantees, plus (0, 0, 0.0)
    pads: each cell gets one value, so both scatters write the same bits;
    against the JAX flat scatter too."""
    s, r, v, N = _graph()
    cells = {}
    for b in range(s.shape[0]):
        for e in range(s.shape[1]):
            if (b, s[b, e], r[b, e]) in cells:
                s[b, e] = r[b, e] = v[b, e] = 0
            cells[(b, s[b, e], r[b, e])] = True
    ts, tr, tv = (torch.from_numpy(a) for a in (s, r, v))
    flat = model_lib.dense_adjacency(ts, tr, tv, N, out_dtype=dtype,
                                     flat=True)
    nd = model_lib.dense_adjacency(ts, tr, tv, N, out_dtype=dtype)
    assert flat.dtype == dtype and torch.equal(flat, nd)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_model.dense_adjacency(jnp.asarray(s), jnp.asarray(r),
                                     jnp.asarray(v), N, out_dtype=jdt,
                                     flat=True)
    np.testing.assert_array_equal(flat.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_coo_matvec_equals_dense_and_jax():
    s, r, v, N = _graph(1)
    x = np.random.default_rng(2).normal(size=(3, N, 8)).astype(np.float32)
    ts, tr, tv, tx = (torch.from_numpy(a) for a in (s, r, v, x))
    got = model_lib.coo_matvec(ts, tr, tv, tx)
    dense = torch.bmm(model_lib.dense_adjacency(ts, tr, tv, N), tx)
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
    want = jax_model.coo_matvec(jnp.asarray(s), jnp.asarray(r),
                                jnp.asarray(v), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_coo_matvec_accumulates_f32_under_bf16():
    """512 bf16 messages of 0.01 into one node sum to 5.12 in f32 before
    the one cast (a bf16 running sum would stall far below)."""
    B, N, E = 1, 4, 512
    out = model_lib.coo_matvec(torch.zeros((B, E), dtype=torch.long),
                               torch.ones((B, E), dtype=torch.long),
                               torch.full((B, E), 0.01),
                               torch.ones((B, N, 2), dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert abs(float(out[0, 0, 0]) - 5.12) <= 5.12 * 1e-2


def test_typed_at_init_bit_identical_and_gains_get_gradients(setup):
    tcfg = setup["tcfg"]
    gen = torch.Generator().manual_seed(0)
    plain = FiraModel(tcfg).init_parameters(gen).eval()
    typed = FiraModel(tcfg.replace(typed_edges=True)).eval()
    missing, unexpected = typed.load_state_dict(plain.state_dict(),
                                                strict=False)
    assert missing == ["edge_gain"] and not unexpected
    assert torch.equal(typed.edge_gain, torch.ones(N_EDGE_KINDS))
    rows = dict(split=setup["split"], indices=setup["chunk"], batch_size=4)
    pb = batch_to_device(make_batch(cfg=tcfg, **rows), torch.device("cpu"),
                         TRAIN_FIELDS)
    tb = batch_to_device(make_batch(cfg=tcfg.replace(typed_edges=True),
                                    **rows), torch.device("cpu"),
                         TRAIN_FIELDS)
    assert tb["edge_kinds"].dtype == torch.int64 and "edge_kinds" not in pb
    with torch.no_grad():
        assert torch.equal(plain.encode(pb)[0], typed.encode(tb)[0])
        assert all(torch.equal(a, b) for a, b in zip(plain(pb), typed(tb)))
    step_lib.loss_fn(typed, tb).backward()
    g = typed.edge_gain.grad
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    present = np.unique(tb["edge_kinds"].numpy())
    assert bool((g[present] != 0).all()), (g, present)


def test_split_dropout_stream_equals_single(setup):
    """In training mode with dropout on, the split and single encoders
    draw the same masks from the same generator: the outputs agree to
    reassociation and the generators end in the same state."""
    tcfg = setup["tcfg"].replace(dropout_rate=0.1, gcn_dropout_rate=0.2)
    single = FiraModel(tcfg).init_parameters(
        torch.Generator().manual_seed(0)).train()
    split = FiraModel(tcfg.replace(encoder_buffer="split")).train()
    split.load_state_dict(single.state_dict())
    batch = batch_to_device(make_batch(setup["split"], setup["chunk"], tcfg,
                                       batch_size=4), torch.device("cpu"))
    outs, gens = [], []
    for m in (single, split):
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            outs.append(m.encode(batch, gen)[0])
        gens.append(gen.get_state())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(gens[0], gens[1])
    with torch.no_grad():
        off = single.eval().encode(batch)[0]
    assert not torch.allclose(off, outs[0], rtol=1e-3, atol=1e-3)


INVALID = [
    dict(encoder_buffer="double"),
    dict(adjacency_impl="sparse"),
    dict(encoder_buffer="split", adjacency_impl="segment"),
    dict(adjacency_impl="segment", flat_scatter=True),
]


@pytest.mark.parametrize("knobs", INVALID, ids=lambda k: "-".join(
    f"{a}={b}" for a, b in k.items()))
def test_invalid_combination_refused_in_jax_words(setup, knobs):
    tcfg = setup["tcfg"].replace(**knobs)
    with pytest.raises(ValueError) as port_err:
        FiraModel(tcfg)
    jcfg = setup["jcfg"].replace(**knobs)
    batch = jax_make_batch(setup["split"], setup["chunk"],
                           jcfg.replace(adjacency_impl="dense"),
                           batch_size=4)
    with pytest.raises(ValueError) as jax_err:
        JaxModel(jcfg).init(jax.random.PRNGKey(0), batch, deterministic=True)
    assert str(jax_err.value) in str(port_err.value)


@pytest.mark.parametrize("knob,value", [
    ("serve_tiers", "prefill-pool"), ("prefix_cache", True),
    ("kv_dtype", "bf16"), ("serve_precision", "int8w"),
    ("spec_decode", "draft")])
def test_engine_knobs_still_refused(setup, knob, value):
    with pytest.raises(ValueError, match=knob):
        FiraModel(setup["tcfg"].replace(**{knob: value}))


@pytest.mark.parametrize("knob,value", [
    ("adjacency_impl", "segment"), ("flat_scatter", True),
    ("encoder_buffer", "split"), ("typed_edges", True),
    ("beam_compat_prob_space", False), ("beam_kv_cache", False),
    ("beam_factored_topk", True), ("beam_early_exit", True),
    ("decode_engine", True), ("decode_tar_buckets", True)])
def test_knob_now_runs(setup, knob, value):
    assert unsupported(setup["tcfg"].replace(**{knob: value})) == []


def test_convert_round_trips_edge_gain(setup):
    params = _params(setup, GAINS)
    sd = convert.params_from_flax(params)
    assert sd["edge_gain"].shape == (N_EDGE_KINDS,)
    back = convert.params_to_flax(sd)
    assert sorted(back) == sorted(params)
    np.testing.assert_array_equal(back["edge_gain"], GAINS)
    model = FiraModel(setup["tcfg"].replace(typed_edges=True))
    model.load_state_dict(sd)
    torch.testing.assert_close(model.edge_gain, torch.from_numpy(GAINS))
    for key, leaf in jax.tree_util.tree_leaves_with_path(
            convert.params_to_flax(model.state_dict())):
        want = params
        for k in key:
            want = want[k.key]
        np.testing.assert_array_equal(leaf, want)
    moments = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.5), params)
    state = convert.adam_state_from_optax(moments, moments, 3, model)
    names = [n for n, _ in model.named_parameters()]
    assert "edge_gain" in names
    gain_state = state["state"][names.index("edge_gain")]
    assert gain_state["exp_avg"].shape == (N_EDGE_KINDS,)
    torch.optim.Adam(model.parameters()).load_state_dict(state)


def test_edge_kinds_reach_the_device_and_the_stacked_group(setup):
    tcfg = setup["tcfg"].replace(typed_edges=True)
    batches = [make_batch(setup["split"], setup["chunk"] + i, tcfg,
                          batch_size=4) for i in range(2)]
    stacked = grouping.stack_group(batches, pad_to=3)
    assert stacked["edge_kinds"].shape == (3, 4, tcfg.max_edges)
    np.testing.assert_array_equal(stacked["edge_kinds"][2], 0)
    dev = batch_to_device(stacked, torch.device("cpu"), TRAIN_FIELDS)
    assert dev["edge_kinds"].dtype == torch.int64
    np.testing.assert_array_equal(dev["edge_kinds"][:2].numpy(),
                                  np.stack([b["edge_kinds"]
                                            for b in batches]))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_corpus"))
    synthetic.write_corpus_dir(d, n_commits=40, seed=6)
    return d


@pytest.mark.parametrize("flags", [
    ["--encoder-buffer", "split"],
    ["--adjacency", "segment", "--sort-edges"],
    ["--typed-edges", "--adjacency", "segment"]], ids=lambda f: f[1])
def test_cli_train_with_encoder_flags(corpus, tmp_path, flags):
    out = str(tmp_path / "out")
    argv = ["--config", "fira-tiny", "--device", "cpu", "--data-dir", corpus,
            "--out-dir", out, "--batch-size", "8", *flags]
    assert cli.main(["train", *argv, "--epochs", "1"]) == 0
    sd = CheckpointManager(os.path.join(out, "ckpt")).load_latest()["model"]
    assert ("edge_gain" in sd) == ("--typed-edges" in flags)
    if "edge_gain" in sd:
        assert not torch.equal(sd["edge_gain"], torch.ones(N_EDGE_KINDS))
    assert cli.main(["test", *argv]) == 0


def test_cli_refuses_split_with_segment(corpus, tmp_path, capsys):
    rc = cli.main(["train", "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", corpus, "--out-dir", str(tmp_path),
                   "--encoder-buffer", "split", "--adjacency", "segment"])
    assert rc == 2
    assert "encoder_buffer='split' needs the dense adjacency" in \
        capsys.readouterr().err

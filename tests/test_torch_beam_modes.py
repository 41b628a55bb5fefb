"""Every beam mode of the port against the JAX package's on the same
weights and batch (the JAX beam jitted, its copy head on the Pallas kernel
interpreted on the CPU): the six (kv_cache, factored_topk, prob_space)
cases of the JAX early-exit test, each with early exit on and off, on
random weights and on weights biased toward <eos> (every beam finishes
within a few positions, so early exit really stops early). Tokens and the
steps run must be exactly equal, probabilities (or log-probabilities) at
rtol 1e-5.

Also: the per-side top-k of the factored beam gives ties to the lower
index, as ``jax.lax.top_k``, on rows built of ties (a copy side whose
padded positions share one value); the factored selection round equals
the JAX one on such factors; ``make_beam_search`` dispatches on
``beam_kv_cache``; ``cli test --beam-factored-topk --beam-early-exit``
writes the plain decode's bytes, and ``--beam-log-space`` reaches the
config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode import beam as jax_beam
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.decode import beam, runner
from fira_tpu_torch.model.model import FiraModel

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)

MODES = [
    # (kv_cache, factored_topk, compat_prob_space), as
    # tests/test_beam_early_exit.py
    (False, False, True),
    (False, True, True),
    (True, False, True),
    (True, True, True),
    (True, False, False),
    (False, False, False),
]
KNOBS = ("beam_kv_cache", "beam_factored_topk", "beam_compat_prob_space")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    jds = JaxDataset(d, JaxConfig(**GEOM, copy_head_impl="pallas"))
    jcfg = jds.cfg
    tcfg = FiraConfig(**GEOM, vocab_size=jcfg.vocab_size,
                      ast_change_vocab_size=jcfg.ast_change_vocab_size)
    split = jds.splits["test"]
    batch = make_batch(split, np.arange(min(4, len(split))), tcfg,
                       batch_size=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b: JaxModel(jcfg).init(
        jax.random.PRNGKey(1), b, deterministic=True))(jb)["params"]
    weights = {"random": params,
               "eos_biased": jax_beam.eos_biased_params(params)}
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jb=jb, weights=weights,
                corpus=d, jax_runs={})


def _jax_run(setup, mode, early, weights):
    """The JAX beam's (tokens, probs, steps), one compile per (mode,
    early) shared by both weight sets."""
    key = (mode, early)
    if key not in setup["jax_runs"]:
        cfg = setup["jcfg"].replace(**dict(zip(KNOBS, mode)),
                                    beam_early_exit=early)
        setup["jax_runs"][key] = (jax_beam.make_beam_search(
            JaxModel(cfg), cfg, with_steps=True), {})
    search, done = setup["jax_runs"][key]
    if weights not in done:
        toks, probs, steps = search(setup["weights"][weights], setup["jb"])
        done[weights] = (np.asarray(toks), np.asarray(probs), int(steps))
    return done[weights]


def _port_run(setup, cfg, weights):
    model = FiraModel(cfg)
    model.load_state_dict(convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, setup["weights"][weights])))
    model.eval()
    toks, probs, steps = beam.make_beam_search(model, cfg, with_steps=True)(
        batch_to_device(setup["batch"], torch.device("cpu")))
    return toks.numpy(), probs.numpy(), steps


@pytest.mark.parametrize("weights", ["random", "eos_biased"])
@pytest.mark.parametrize("early", [False, True], ids=["full", "early"])
@pytest.mark.parametrize("mode", MODES,
                         ids=lambda m: "kv%d-fac%d-prob%d" % m)
def test_beam_mode_matches_jax(setup, mode, early, weights):
    cfg = setup["tcfg"].replace(**dict(zip(KNOBS, mode)),
                                beam_early_exit=early)
    want_toks, want_probs, want_steps = _jax_run(setup, mode, early, weights)
    toks, probs, steps = _port_run(setup, cfg, weights)
    np.testing.assert_array_equal(toks, want_toks)
    assert steps == want_steps
    np.testing.assert_allclose(probs, want_probs, rtol=1e-5, atol=1e-7)
    T = cfg.tar_len
    if early and weights == "eos_biased":
        assert steps < T - 1       # every beam finished: it stopped early
    if not early:
        assert steps == T - 1


def test_early_exit_equals_full_scan_bitwise(setup):
    """On the <eos>-biased weights early exit stops short of the full scan
    and returns its tokens and probabilities bit for bit."""
    for mode in MODES:
        cfg = setup["tcfg"].replace(**dict(zip(KNOBS, mode)))
        full = _port_run(setup, cfg, "eos_biased")
        early = _port_run(setup, cfg.replace(beam_early_exit=True),
                          "eos_biased")
        assert early[2] < full[2] == cfg.tar_len - 1, mode
        np.testing.assert_array_equal(early[0], full[0])
        np.testing.assert_array_equal(early[1], full[1])


def test_factored_differs_from_fused_only_where_prob_scores_underflow(setup):
    """At tar_len 30 on random weights the prob-space beam scores (29
    products of probabilities of a few %) fall below the smallest normal
    float; XLA flushes them to zero, and so does the port. From there
    exact zeros tie: the fused beam takes the lowest fused-space ids, the
    factored one only sees its per-side top ids, so the JAX package's two
    modes pick different tokens on those rows. The port reproduces each
    mode token for token, its two modes differ only on rows whose scores
    are all zero, and in log space (no underflow) they agree."""
    jds = JaxDataset(setup["corpus"], JaxConfig(**dict(GEOM, tar_len=30),
                                                copy_head_impl="pallas"))
    jcfg, tcfg = jds.cfg, setup["tcfg"].replace(tar_len=30)
    n = min(4, len(jds.splits["test"]))
    batch = batch_to_device(make_batch(jds.splits["test"], np.arange(n),
                                       tcfg, batch_size=4),
                            torch.device("cpu"))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = setup["weights"]["random"]
    model = FiraModel(tcfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    got = {}
    for prob in (True, False):
        for fac in (False, True):
            knobs = dict(beam_compat_prob_space=prob, beam_factored_topk=fac)
            c = jcfg.replace(**knobs)
            want = [np.asarray(x) for x in jax_beam.make_beam_search(
                JaxModel(c), c)(params, jb)]
            toks, probs = beam.make_beam_search(
                model, tcfg.replace(**knobs))(batch)
            np.testing.assert_array_equal(toks.numpy(), want[0])
            np.testing.assert_allclose(probs.numpy(), want[1], rtol=1e-5,
                                       atol=1e-7)
            got[prob, fac] = toks.numpy(), probs.numpy()
    (t0, p0), (t1, p1) = got[True, False], got[True, True]
    differ = [r for r in range(n) if not np.array_equal(t0[r], t1[r])]
    assert differ, "no prob-space row underflowed: the case is vacuous"
    assert all((p0[r] == 0).all() and (p1[r] == 0).all() for r in differ)
    np.testing.assert_array_equal(got[False, False][0], got[False, True][0])
    np.testing.assert_array_equal(got[False, False][1], got[False, True][1])


def test_prob_space_candidates_flush_subnormals(setup):
    """A prob-space candidate below the smallest normal float becomes
    exactly zero (XLA's flush); normal products and log space pass."""
    tiny = float(np.finfo(np.float32).tiny)
    p = torch.tensor([[[0.5, 1e-20, 0.0]]])
    probs = torch.tensor([[1e-20]])
    got = beam._candidates(p, probs, setup["tcfg"])    # 5e-21, 1e-40, 0
    assert got[0, 0, 0].item() == np.float32(0.5) * np.float32(1e-20)
    assert got[0, 0, 1:].tolist() == [0.0, 0.0]
    got = beam._candidates(p, torch.tensor([[4 * tiny]]), setup["tcfg"])
    assert got[0, 0].tolist() == [np.float32(2 * tiny), 0.0, 0.0]
    logs = beam._candidates(p, probs, setup["tcfg"].replace(
        beam_compat_prob_space=False))
    np.testing.assert_allclose(logs.numpy(), np.log(np.clip(
        p.numpy(), 1e-10, 1.0)) + 1e-20)


def _tied_rows(rng):
    """(2, 3, 40) rows of ties: a generation-like side drawn from four
    values, and a copy-like side whose positions past each row's length
    share one masked value, some real positions tying with each other."""
    gen = rng.integers(0, 4, size=(2, 3, 40)).astype(np.float32) / 8.0
    copy = np.full((2, 3, 40), 1e-9, np.float32)
    for b in range(2):
        for k in range(3):
            n = int(rng.integers(1, 6))
            copy[b, k, :n] = rng.choice([0.5, 0.25, 0.25], size=n)
    return gen, copy


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_per_side_top_k_breaks_ties_like_jax(k):
    """The factored beam's per-side top-k on both sides' tied rows: the
    indices and values of ``jax.lax.top_k``."""
    rng = np.random.default_rng(0)
    for x in _tied_rows(rng):
        vals, idx = beam.stable_top_k(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("compat", [True, False], ids=["prob", "log"])
def test_factored_selection_matches_jax_on_ties(compat):
    """One factored selection round on tied factors, a finished beam
    among them: tokens, scores, finished flags and source beams equal to
    the JAX package's ``_select_factored``."""
    V, S = 40, 40
    knobs = dict(GEOM, vocab_size=V, ast_change_vocab_size=8,
                 beam_compat_prob_space=compat)
    cfg, jcfg = FiraConfig(**knobs), JaxConfig(**knobs)
    assert cfg.copy_len == S
    rng = np.random.default_rng(1)
    gen, copy = _tied_rows(rng)
    gate = np.array([[[0.5, 0.5], [0.25, 0.75], [0.5, 0.5]]] * 2,
                    np.float32)
    B, K = 2, 3
    tokens, probs, finished, neg = beam._init_beam(B, cfg, "cpu")
    jtokens, jprobs, jfinished, jneg = jax_beam._init_beam(B, jcfg)
    start = (np.array([[0.5, 0.25, 0.25]] * B, np.float32) if compat
             else np.log(np.array([[0.5, 0.25, 0.25]] * B, np.float32)))
    fin = np.array([[False, True, False], [False, False, False]])
    tokens[:, :, 1] = torch.tensor([[4, 1, 5], [6, 7, 8]])
    diff = rng.integers(1, V, size=(B, cfg.sou_len))
    sub = rng.integers(1, V, size=(B, cfg.sub_token_len))
    got = beam._select_factored(
        torch.from_numpy(gen), torch.from_numpy(copy), torch.from_numpy(gate),
        tokens, torch.from_numpy(start), torch.from_numpy(fin), 1,
        {"diff": torch.from_numpy(diff), "sub_token": torch.from_numpy(sub)},
        cfg, neg)
    want = jax_beam._select_factored(
        jnp.asarray(gen), jnp.asarray(copy), jnp.asarray(gate),
        jnp.asarray(tokens.numpy(), jnp.int32), jnp.asarray(start),
        jnp.asarray(fin), 1,
        {"diff": jnp.asarray(diff, jnp.int32),
         "sub_token": jnp.asarray(sub, jnp.int32)}, jcfg, jneg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_beam_search_dispatches_on_kv_cache(setup, monkeypatch):
    calls = []
    for name in ("beam_search", "beam_search_cached"):
        monkeypatch.setattr(beam, name, lambda *a, _n=name, **k:
                            calls.append((_n, k["with_steps"])))
    for kv in (True, False):
        beam.make_beam_search(None, setup["tcfg"].replace(beam_kv_cache=kv),
                              with_steps=kv)({})
    assert calls == [("beam_search_cached", True), ("beam_search", False)]


def test_eos_biased_moves_only_the_eos_bias(setup):
    model = FiraModel(setup["tcfg"]).init_parameters(
        torch.Generator().manual_seed(0))
    sd = model.state_dict()
    biased = beam.eos_biased(sd, delta=8.0)
    for k, v in sd.items():
        if k != "out_fc.bias":
            assert biased[k] is v
    diff = (biased["out_fc.bias"] - sd["out_fc.bias"]).numpy()
    assert np.flatnonzero(diff).tolist() == [beam.EOS_ID]
    assert diff[beam.EOS_ID] == 8.0
    jbias = np.asarray(jax_beam.eos_biased_params(
        {"out_fc": {"bias": sd["out_fc.bias"].numpy()}})["out_fc"]["bias"])
    np.testing.assert_array_equal(biased["out_fc.bias"].numpy(), jbias)


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """A tiny corpus and a seeded ``best.pt``, its <eos> bias raised so
    that the messages end at mixed lengths."""
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data")
    synthetic.write_corpus_dir(data, n_commits=60, seed=4)
    cfg = FiraDataset(data, fira_tiny()).cfg
    model = FiraModel(cfg).init_parameters(torch.Generator().manual_seed(0))
    ckpt = root / "ckpt"
    ckpt.mkdir()
    torch.save(beam.eos_biased(model.state_dict(), delta=1.5),
               ckpt / "best.pt")
    return data, str(ckpt), root


def _cli_test(trained_ckpt, name, *flags):
    data, ckpt, root = trained_ckpt
    out = str(root / name)
    assert cli.main(["test", "--config", "fira-tiny", "--data-dir", data,
                     "--out-dir", out, "--ckpt-dir", ckpt, "--device", "cpu",
                     *flags]) == 0
    with open(os.path.join(out, "output_fira"), "rb") as f:
        return f.read()


def test_cli_factored_early_exit_writes_the_plain_bytes(trained_ckpt):
    plain = _cli_test(trained_ckpt, "plain")
    assert plain.strip()
    assert _cli_test(trained_ckpt, "fast", "--beam-factored-topk",
                     "--beam-early-exit") == plain


def test_cli_beam_flags_reach_the_config(trained_ckpt, monkeypatch):
    seen = []
    real = beam.make_beam_search

    def spy(model, cfg, with_steps=False):
        seen.append(cfg)
        return real(model, cfg, with_steps)

    monkeypatch.setattr(runner, "make_beam_search", spy)
    _cli_test(trained_ckpt, "log", "--beam-log-space", "--beam-early-exit")
    (cfg,) = seen
    assert not cfg.beam_compat_prob_space and cfg.beam_early_exit
    assert cfg.beam_kv_cache and not cfg.beam_factored_topk

"""The port's KV-cached beam against the JAX package's jitted beam
(``make_beam_search``, copy head on the Pallas kernel interpreted on the
CPU) on the same weights and batch: tokens exactly equal, probabilities at
rtol 1e-5 (f32; the frameworks sum in different orders). Run once on
random weights and once with the generation head biased toward <eos>, so
that beams finish and the finished-beam sentinels decide selection. Plus
the stable top-k that selection relies on: ties go to the lower index, as
``jax.lax.top_k`` does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode.beam import eos_biased_params, make_beam_search
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import convert
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.feeder import batch_to_device
from fira_tpu_torch.decode import beam
from fira_tpu_torch.model.model import FiraModel

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    jax_synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    jds = JaxDataset(d, JaxConfig(**GEOM, copy_head_impl="pallas"))
    jcfg = jds.cfg
    split = jds.splits["test"]
    batch = make_batch(split, np.arange(min(4, len(split))),
                       FiraConfig(**GEOM, vocab_size=jcfg.vocab_size,
                                  ast_change_vocab_size=jcfg.ast_change_vocab_size),
                       batch_size=4)
    jmodel = JaxModel(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(1), b, deterministic=True))(jb)["params"]
    search = make_beam_search(jmodel, jcfg)
    runs = {}
    for name, p in (("random", params),
                    ("eos_biased", eos_biased_params(params, delta=4.0))):
        tokens, probs = search(p, jb)
        runs[name] = (jax.tree_util.tree_map(np.asarray, p),
                      np.asarray(tokens), np.asarray(probs))
    tcfg = FiraConfig(**GEOM).replace(
        vocab_size=jcfg.vocab_size,
        ast_change_vocab_size=jcfg.ast_change_vocab_size)
    return tcfg, batch, runs


@pytest.mark.parametrize("run", ["random", "eos_biased"])
def test_beam_matches_jax(setup, run):
    cfg, batch, runs = setup
    params, want_tokens, want_probs = runs[run]
    model = FiraModel(cfg)
    model.load_state_dict(convert.params_from_flax(params))
    model.eval()
    tokens, probs = beam.beam_search_cached(
        model, batch_to_device(batch, torch.device("cpu")), cfg)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=1e-5,
                               atol=1e-7)
    if run == "eos_biased":
        # the sentinel path ran: every best beam ended in <eos>
        assert all(1 in row[int(np.argmax(p))] for row, p in
                   zip(want_tokens, want_probs))


def test_stable_top_k_breaks_ties_like_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(6, 50)).astype(np.float32)  # many ties
    vals, idx = beam.stable_top_k(torch.from_numpy(x), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_selection_tie_goes_to_lower_candidate():
    """Two beams offer the same token at the same probability: the
    candidate with the lower flat index (beam 0) wins, as in the JAX
    package's selection."""
    cfg = FiraConfig(**GEOM, vocab_size=10, ast_change_vocab_size=8,
                     beam_size=2)
    B, K, V_out = 1, 2, cfg.output_vocab_size
    tokens, probs, finished, neg = beam._init_beam(B, cfg, "cpu")
    probs[:] = torch.tensor([[0.5, 0.5]])
    dist = torch.zeros((B, K, V_out))
    dist[:, :, 7] = 0.4
    dist[:, :, 5] = 0.4
    batch = {"diff": torch.zeros((B, cfg.sou_len), dtype=torch.long),
             "sub_token": torch.zeros((B, cfg.sub_token_len),
                                      dtype=torch.long)}
    new_tokens, new_probs, _, src_beam = beam._select(
        dist, tokens, probs, finished, 0, batch, cfg, neg)
    # flat order: beam 0 token 5, beam 0 token 7, beam 1 token 5, ...
    assert src_beam.tolist() == [[0, 0]]
    assert new_tokens[0, :, 1].tolist() == [5, 7]
    torch.testing.assert_close(new_probs, torch.full((1, 2), 0.2))

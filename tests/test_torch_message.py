"""``cli message``, the one-shot diff-in / message-out path, in the port
against the JAX package: at ``fira_tiny`` f32 with JAX-initialised weights
carried across by ``convert``, ``one_shot_message`` gives the JAX
package's string for reconstructed corpus diffs and for real-traffic
diffs (no ``#!`` metadata, unseen words, over budget); ``cli message``
exits 2 naming the missing target in the JAX CLI's words, 1 with
``rejected`` on a malformed diff, and 0 printing the message under
``--device cpu`` on a checkpoint of those weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fira_tpu.decode.beam as jax_beam
from fira_tpu import cli as jax_cli
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import write_extracted_corpus_dir
from fira_tpu.ingest.difftext import DiffParseError as JaxDiffParseError
from fira_tpu.ingest.difftext import parse_request as jax_parse_request
from fira_tpu.ingest.difftext import reconstruct_request
from fira_tpu.ingest.service import one_shot_message as jax_one_shot
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.ingest.service import one_shot_message
from fira_tpu_torch.model.model import FiraModel

N_COMMITS, SEED, TEST_BS = 24, 13, 4

REAL_DIFFS = [
    # unseen words and AST shapes, no reference message or variable map
    "diff --git a/src/Foo.java b/src/Foo.java\n"
    "--- a/src/Foo.java\n+++ b/src/Foo.java\n"
    "@@ -10,4 +10,4 @@ class WeirdNewClazz\n"
    " public void frobnicateWidget ( ) {\n"
    "-int legacyCounterXyz = 42 ;\n"
    "+for ( int qq = 0 ; qq < 9 ; qq ++ ) { zorp ( qq ) ; }\n"
    " }\n",
    # over the sou budget: clipped
    "diff --git a/F.java b/F.java\n--- a/F.java\n+++ b/F.java\n"
    "@@ -1,1 +1,1 @@ class Big\n"
    + "".join(f"+int var{i} = {i} ;\n" for i in range(40)),
]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The round-trip corpus, JAX-initialised weights, the JAX package's
    messages and request-row beam probabilities (its beam compiled once),
    and the port's model and
    checkpoint of the same weights."""
    d = str(tmp_path_factory.mktemp("corpus"))
    corpus = write_extracted_corpus_dir(d, N_COMMITS, seed=SEED)
    texts = [reconstruct_request(corpus.record(i)) for i in range(8)]
    texts += REAL_DIFFS
    jds = JaxDataset(d, jax_fira_tiny(test_batch_size=TEST_BS))
    jcfg = jds.cfg
    jmodel = JaxModel(jcfg)
    sample = jax_make_batch(jds.splits["train"], np.arange(TEST_BS), jcfg,
                            batch_size=TEST_BS)
    jb = {k: jnp.asarray(v) for k, v in sample.items()}
    params = jax.jit(lambda b: jmodel.init(
        jax.random.PRNGKey(3), b, deterministic=True))(jb)["params"]
    # one_shot_message builds a fresh jitted beam each call; hand it one
    # built once, for this model and config only
    make_beam_search = jax_beam.make_beam_search
    search = make_beam_search(jmodel, jcfg)
    want_probs = []

    def recorded(p, wire):
        tokens, probs = search(p, wire)
        want_probs.append(np.asarray(probs)[0])
        return tokens, probs

    def cached(model, cfg, with_steps=False):
        assert model is jmodel and cfg == jcfg and not with_steps
        return recorded

    jax_beam.make_beam_search = cached
    try:
        want = [jax_one_shot(jmodel, params, jds.word_vocab,
                             jds.ast_change_vocab, jcfg, t) for t in texts]
    finally:
        jax_beam.make_beam_search = make_beam_search
    state_dict = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    ds = FiraDataset(d, fira_tiny(test_batch_size=TEST_BS))
    model = FiraModel(ds.cfg)
    model.load_state_dict(state_dict)
    ckpt = tmp_path_factory.mktemp("ckpt")
    torch.save(model.state_dict(), ckpt / "best.pt")
    files = tmp_path_factory.mktemp("diffs")
    paths = []
    for i, t in enumerate(texts):
        paths.append(str(files / f"{i}.diff"))
        with open(paths[-1], "w") as f:
            f.write(t)
    return dict(dir=d, texts=texts, want=want, want_probs=want_probs,
                ds=ds, model=model,
                ckpt=str(ckpt), paths=paths)


@pytest.mark.parametrize("i", range(len(REAL_DIFFS) + 8))
def test_one_shot_message_equals_jax(setup, i):
    stats = {}
    got = one_shot_message(setup["model"], setup["ds"].word_vocab,
                           setup["ds"].ast_change_vocab, setup["ds"].cfg,
                           setup["texts"][i], stats=stats)
    assert got == setup["want"][i]
    assert got.strip(), "an empty message tests nothing"
    np.testing.assert_allclose(stats["probs"], setup["want_probs"][i],
                               rtol=1e-5, atol=1e-7)
    assert {"lex_s", "parse_s", "assemble_s", "beam_s",
            "cook_s"} <= set(stats)
    if i == 9:
        assert stats["truncated"]["diff_tokens_dropped"] > 0


def _port_cli(setup, *args):
    return cli.main(["message", *args, "--config", "fira-tiny",
                     "--data-dir", setup["dir"], "--ckpt-dir",
                     setup["ckpt"], "--test-batch-size", str(TEST_BS)])


@pytest.mark.parametrize("target", [None, "/no/such/file.diff"])
def test_cli_message_exit_2_in_jax_words(setup, capsys, target):
    args = [target] if target else []
    assert _port_cli(setup, *args, "--device", "cpu") == 2
    got = capsys.readouterr()
    assert jax_cli.main(["message", *args, "--config", "fira-tiny",
                         "--data-dir", setup["dir"]]) == 2
    want = capsys.readouterr()
    assert got.err == want.err and "parse-time validation: message" \
        in got.err
    assert got.out == ""


def test_cli_message_rejects_malformed_diff(setup, capsys, tmp_path):
    bad = tmp_path / "bad.diff"
    bad.write_text("this is not a diff\n")
    assert _port_cli(setup, str(bad), "--device", "cpu") == 1
    err = capsys.readouterr().err
    with pytest.raises(JaxDiffParseError) as want:
        jax_parse_request(bad.read_text())
    assert err == f"message: {bad} rejected: {want.value}\n"
    binary = tmp_path / "binary.diff"
    binary.write_bytes(b"\xff\xfe@@ -1 +1 @@\n")
    assert _port_cli(setup, str(binary), "--device", "cpu") == 1
    assert "rejected" in capsys.readouterr().err


@pytest.mark.parametrize("i", [0, 8])
def test_cli_message_prints_the_jax_message(setup, capsys, i):
    assert _port_cli(setup, setup["paths"][i], "--device", "cpu") == 0
    assert capsys.readouterr().out == setup["want"][i] + "\n"
    if not torch.cuda.is_available():
        # the card is the default: without one the CLI raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _port_cli(setup, setup["paths"][i])

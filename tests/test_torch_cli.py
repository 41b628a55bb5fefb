"""The port's ``test`` CLI end to end on a tiny synthetic corpus: on the
same weights it writes an OUTPUT/output_fira byte-identical to the JAX
package's ``run_test`` with the Pallas copy head (interpreted on the CPU).
The weights are the port's own seeded initialisation, carried to the JAX
package with ``convert.params_to_flax``; with them the messages run to
many words, so the comparison covers real text, not empty lines.
Without a checkpoint it exits 1 with the JAX CLI's message; asked for
``--device cuda`` on a host without a card it raises.

``train`` on a tiny corpus writes ``train_process`` lines in the JAX
format, at the same (epoch, batch) gates as the JAX package's ``train()``
on the same corpus and config, plus ``latest.pt`` (and ``best.pt`` when dev
BLEU improved); a second call resumes and runs no epoch; ``test`` then
decodes the trained checkpoint.

``--buckets`` with a malformed or out-of-range entry exits 2 naming it;
``--accum-steps`` drops a fused value the named config carries unless
``--fused-steps`` pins it; ``train --buckets auto`` runs with
``--fused-steps 2`` and with ``--accum-steps 2``, and ``test --buckets
auto`` writes the unbucketed decode's bytes; ``decode_tar_buckets=True``
is refused.

``--synthetic 24`` writes the JAX CLI's corpus files byte for byte; the
two CLIs' flag sets differ only by the port's ``--device`` and
``--feeder-workers``; ``latest.pt`` records ``rng_impl`` and a resume
under another is refused in the JAX package's words (a checkpoint without
the field reads as threefry)."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from fira_tpu.cli import _load_var_maps
from fira_tpu.config import fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode.runner import run_test as jax_run_test
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.train.loop import train as jax_train
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig as TorchConfig
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.model.model import FiraModel

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COMMITS, SEED, TEST_BS = 80, 3, 4


def test_output_file_byte_identical_to_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax_data"), str(tmp_path / "torch_data")
    jax_synthetic.write_corpus_dir(jdir, n_commits=N_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=N_COMMITS, seed=SEED)
    cfg = fira_tiny(copy_head_impl="pallas", test_batch_size=TEST_BS)
    ds = JaxDataset(jdir, cfg)
    cfg = ds.cfg
    tmodel = FiraModel(TorchConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(TorchConfig)}))
    tmodel.init_parameters(torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(tmodel.state_dict(), ckpt / "best.pt")

    params = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_flax(tmodel.state_dict()))
    jout = str(tmp_path / "jax_out")
    metrics = jax_run_test(JaxModel(cfg), params, ds, cfg, out_dir=jout,
                           var_maps=_load_var_maps(jdir))
    assert int(metrics["n"]) == len(ds.splits["test"]) > TEST_BS
    tout = str(tmp_path / "torch_out")
    proc = subprocess.run(
        [sys.executable, "-m", "fira_tpu_torch.cli", "test",
         "--config", "fira-tiny", "--data-dir", tdir, "--out-dir", tout,
         "--ckpt-dir", str(ckpt), "--test-batch-size", str(TEST_BS),
         "--device", "cpu"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "test sentence-bleu" in proc.stdout
    with open(os.path.join(jout, "output_fira"), "rb") as f:
        want = f.read()
    with open(os.path.join(tout, "output_fira"), "rb") as f:
        got = f.read()
    assert want.count(b"\n") == len(ds.splits["test"])
    assert len(want.split()) > 5 * len(ds.splits["test"])   # real text
    assert got == want


def test_no_checkpoint_exits_1(tmp_path, capsys):
    rc = cli.main(["test", "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", str(tmp_path / "data"),
                   "--out-dir", str(tmp_path / "out"),
                   "--ckpt-dir", str(tmp_path / "none")])
    assert rc == 1
    assert (f"no checkpoint under {tmp_path / 'none'}; train first"
            in capsys.readouterr().err)


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["test", "--config", "fira-tiny", "--device", "cuda",
                  "--data-dir", str(tmp_path), "--out-dir", str(tmp_path)])


TRAIN_COMMITS, TRAIN_BS = 40, 4
GATE_LINE = re.compile(r"^epoch: (\d+) batch: (\d+) dev bleu: (\S+) "
                       r"is better: (True|False)$")


def _gates(path):
    with open(path) as f:
        lines = f.read().splitlines()
    matches = [GATE_LINE.match(line) for line in lines]
    assert lines and all(matches), lines
    return [(int(m[1]), int(m[2])) for m in matches]


def test_train_then_resume_then_test(tmp_path, capsys):
    """fira-tiny has dev_start_epoch=0 and dev_every_batches=4; at batch
    size 4 an epoch of the train split has several gates."""
    jdir, tdir = str(tmp_path / "jax_data"), str(tmp_path / "torch_data")
    jax_synthetic.write_corpus_dir(jdir, n_commits=TRAIN_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=TRAIN_COMMITS, seed=SEED)
    jds = JaxDataset(jdir, fira_tiny(batch_size=TRAIN_BS))
    jout = str(tmp_path / "jax_out")
    jax_train(jds, jds.cfg, out_dir=jout, epochs=2,
              var_maps=_load_var_maps(jdir))

    tout = str(tmp_path / "torch_out")
    argv = ["--config", "fira-tiny", "--device", "cpu", "--data-dir", tdir,
            "--out-dir", tout, "--batch-size", str(TRAIN_BS)]
    assert cli.main(["train", *argv, "--epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"best dev bleu: \S+  throughput: \S+ commits/sec/chip"
                     r"  feed_stall_frac: \S+", out), out
    gates = _gates(os.path.join(tout, "train_process"))
    assert gates == _gates(os.path.join(jout, "train_process"))
    assert len(gates) > 2 and {e for e, _ in gates} == {0, 1}
    ckpt = os.path.join(tout, "ckpt")
    assert os.path.isfile(os.path.join(ckpt, "latest.pt"))
    improved = "True" in open(os.path.join(tout, "train_process")).read()
    assert os.path.isfile(os.path.join(ckpt, "best.pt")) == improved

    assert cli.main(["train", *argv, "--epochs", "2"]) == 0
    assert "resumed at epoch 2" in capsys.readouterr().out
    assert _gates(os.path.join(tout, "train_process")) == gates

    assert cli.main(["test", *argv]) == 0
    assert "test sentence-bleu" in capsys.readouterr().out
    with open(os.path.join(tout, "output_fira")) as f:
        assert len(f.read().splitlines()) == len(jds.splits["test"])


def test_train_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--config", "fira-tiny", "--device", "cuda",
                  "--data-dir", str(tmp_path), "--out-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    synthetic.write_corpus_dir(tdir, n_commits=TRAIN_COMMITS, seed=SEED)
    return tdir


@pytest.mark.parametrize("spec,named", [
    ("8:192", "'8:192' is not AST:EDGES:TAR"),
    ("8:192:8,8:x:8", "'8:x:8' is not AST:EDGES:TAR"),
    ("999:192:8", "--buckets invalid: bucket ast_len 999 outside [1, 24]"),
    ("8:16:8", "--buckets invalid: bucket max_edges 16 outside"),
])
def test_malformed_buckets_exit_2_naming_the_entry(tiny_corpus, tmp_path,
                                                   capsys, spec, named):
    for command in ("train", "test"):
        ckpt = tmp_path / "ckpt"
        ckpt.mkdir(exist_ok=True)
        torch.save({}, ckpt / "best.pt")   # test reads it before the data
        rc = cli.main([command, "--config", "fira-tiny", "--device", "cpu",
                       "--data-dir", tiny_corpus, "--out-dir", str(tmp_path),
                       "--ckpt-dir", str(ckpt), "--buckets", spec])
        assert rc == 2
        assert named in capsys.readouterr().err


def test_accum_steps_drop_a_config_fused_value_unless_pinned(
        tiny_corpus, tmp_path, capsys, monkeypatch):
    """A named config that carries fused_steps=8 (as the JAX package's
    production preset does): ``--accum-steps`` drops it, unless
    ``--fused-steps`` pins it, and then the two conflict."""
    from fira_tpu_torch import config as config_lib
    from fira_tpu_torch.train import loop

    monkeypatch.setitem(config_lib.NAMED_CONFIGS, "fira-tiny-fused8",
                        lambda **kw: config_lib.fira_tiny(fused_steps=8,
                                                          **kw))
    seen = []

    def fake_train(dataset, cfg, **kw):
        seen.append(cfg)
        return loop.TrainResult(state=None, best_bleu=0.0, epochs_run=0,
                                commits_per_sec=0.0, steps_per_sec=0.0,
                                feed_stall_frac=0.0, steps=0, gates=0,
                                dev_batches=0, dev_seconds=0.0)

    monkeypatch.setattr(loop, "train", fake_train)
    argv = ["train", "--config", "fira-tiny-fused8", "--device", "cpu",
            "--data-dir", tiny_corpus, "--out-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    assert cli.main([*argv, "--accum-steps", "2"]) == 0
    assert cli.main([*argv, "--accum-steps", "2", "--buckets", "auto"]) == 0
    assert [(c.fused_steps, c.accum_steps) for c in seen] == [
        (8, 1), (1, 2), (1, 2)]
    assert seen[0].buckets == seen[1].buckets == () != seen[2].buckets
    capsys.readouterr()
    assert cli.main([*argv, "--accum-steps", "2", "--fused-steps", "8"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err
    assert cli.main([*argv, "--fused-steps", "0"]) == 2
    assert "fused_steps=0 (must be >= 1" in capsys.readouterr().err


def test_bucketed_grouped_train_then_bucketed_test(tiny_corpus, tmp_path,
                                                   capsys):
    """``train --buckets auto`` with ``--fused-steps 2`` and with
    ``--accum-steps 2`` on the CPU; ``test --buckets auto`` of the trained
    checkpoint writes the unbucketed decode's bytes."""
    base = ["--config", "fira-tiny", "--device", "cpu", "--data-dir",
            tiny_corpus, "--batch-size", str(TRAIN_BS)]
    for knob in (["--fused-steps", "2"], ["--accum-steps", "2"]):
        out = str(tmp_path / knob[0].strip("-"))
        assert cli.main(["train", *base, "--out-dir", out, "--epochs", "1",
                         "--buckets", "auto", *knob]) == 0
        text = capsys.readouterr().out
        assert re.search(r"^buckets: \d+:\d+:\d+", text, re.M), text
        assert os.path.isfile(os.path.join(out, "ckpt", "latest.pt"))
    ckpt = str(tmp_path / "fused-steps" / "ckpt")
    outs = []
    for extra in ([], ["--buckets", "auto"]):
        out = str(tmp_path / f"test{len(outs)}")
        assert cli.main(["test", *base, "--out-dir", out, "--ckpt-dir", ckpt,
                         *extra]) == 0
        with open(os.path.join(out, "output_fira"), "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 0


def test_decode_tar_buckets_refused(tiny_corpus, tmp_path, capsys):
    """``--decode-tar-buckets`` runs now (``--engine``); it is refused,
    exit 2 naming the knob, when ``--kv-block-size`` does not tile every
    declared tar budget (the fira-tiny tar_len 12 here)."""
    from fira_tpu_torch.config import fira_tiny, unsupported

    assert not unsupported(fira_tiny(decode_tar_buckets=True))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    rc = cli.main(["test", "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", tiny_corpus, "--out-dir", str(tmp_path),
                   "--ckpt-dir", str(ckpt), "--engine",
                   "--decode-tar-buckets", "--kv-block-size", "5"])
    assert rc == 2
    assert ("kv_block_size 5 does not divide decode tar budget 12"
            in capsys.readouterr().err)


def test_synthetic_writes_the_jax_clis_files(tmp_path, capsys):
    """``--synthetic 24`` writes the corpus before anything else, file for
    file and byte for byte the JAX CLI's (both then stop: no
    checkpoint)."""
    from fira_tpu import cli as jax_cli

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_cli.main(["test", "--config", "fira-tiny", "--synthetic",
                         "24", "--data-dir", jdir,
                         "--out-dir", str(tmp_path / "jo")]) == 1
    assert cli.main(["test", "--config", "fira-tiny", "--device", "cpu",
                     "--synthetic", "24", "--data-dir", tdir,
                     "--out-dir", str(tmp_path / "to")]) == 1
    out = capsys.readouterr().out
    assert f"synthetic corpus: 24 commits -> {tdir}" in out
    assert f"synthetic corpus: 24 commits -> {jdir}" in out
    # the JAX CLI loads the corpus before its checkpoint check, which
    # writes the split index; the port's loads it after
    from fira_tpu_torch.config import fira_tiny as torch_fira_tiny
    from fira_tpu_torch.data.dataset import FiraDataset

    FiraDataset(tdir, torch_fira_tiny())
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    names = [n for n in sorted(os.listdir(tdir))    # the corpus files, not
             if os.path.isfile(os.path.join(tdir, n))]   # the load's cache
    assert len(names) > 5
    for name in names:
        with open(os.path.join(tdir, name), "rb") as f, \
                open(os.path.join(jdir, name), "rb") as g:
            assert f.read() == g.read(), name


def test_flag_sets_differ_only_by_device_and_feeder_workers():
    """Every flag of the JAX CLI, with its choices; the port adds
    --device and --feeder-workers."""
    from fira_tpu import cli as jax_cli

    def flags(parser):
        return {o: a for a in parser._actions for o in a.option_strings}

    jax_flags, port_flags = flags(jax_cli.build_parser()), flags(
        cli.build_parser())
    assert set(port_flags) ^ set(jax_flags) == {"--device",
                                                "--feeder-workers"}
    for name in ("--copy-head", "--rng-impl", "--sanitize", "--profile-dir",
                 "--synthetic"):
        assert port_flags[name].choices == jax_flags[name].choices, name
        assert port_flags[name].default == jax_flags[name].default, name
    assert jax_flags["--backend"].choices == ["jax"]
    assert port_flags["--backend"].choices == ["torch"]
    args = cli.build_parser().parse_args(
        ["train", "--copy-head", "pallas", "--rng-impl", "rbg"])
    cfg = cli.resolve_config(args)
    assert (cfg.copy_head_impl, cfg.rng_impl) == ("pallas", "rbg")


def test_checkpoint_rng_impl_recorded_and_mismatch_refused(tmp_path):
    """``latest.pt`` records the config's rng_impl; a resume under another
    is refused with the JAX package's message (from its own orbax
    checkpoint), and a checkpoint without the field reads as threefry."""
    from fira_tpu.data.batching import make_batch as jax_make_batch
    from fira_tpu.train.state import CheckpointManager as JaxCkpt
    from fira_tpu.train.state import init_state as jax_init_state
    from fira_tpu_torch.train import state as state_lib

    jdir = str(tmp_path / "jax_data")
    jax_synthetic.write_corpus_dir(jdir, n_commits=24, seed=SEED)
    jds = JaxDataset(jdir, fira_tiny(batch_size=2))
    jbatch = jax_make_batch(jds.splits["train"], [0, 1], jds.cfg)
    jstate = jax_init_state(JaxModel(jds.cfg), jds.cfg, jbatch)
    jck = JaxCkpt(str(tmp_path / "jax_ckpt"))
    jck.save_latest(jstate, best_bleu=0.0, epoch=1, rng_impl="rbg")
    with pytest.raises(ValueError) as jerr:
        jck.restore_latest(jstate, expect_rng_impl="threefry")

    tcfg = TorchConfig(vocab_size=jds.cfg.vocab_size,
                       ast_change_vocab_size=jds.cfg.ast_change_vocab_size,
                       **{f.name: getattr(jds.cfg, f.name)
                          for f in dataclasses.fields(TorchConfig)
                          if f.name not in ("vocab_size",
                                            "ast_change_vocab_size")
                          and hasattr(jds.cfg, f.name)})
    state = state_lib.init_state(tcfg, "cpu")
    ck = state_lib.CheckpointManager(str(tmp_path / "ckpt"))
    ck.save_latest(state, best_bleu=0.0, epoch=1, rng_impl="rbg")
    assert ck.load_latest()["rng_impl"] == "rbg"
    with pytest.raises(ValueError) as terr:
        ck.restore_latest(state, expect_rng_impl="threefry")
    assert str(terr.value) == str(jerr.value)
    assert ck.restore_latest(state, expect_rng_impl="rbg")["epoch"] == 1

    payload = ck.load_latest()
    del payload["rng_impl"]        # a checkpoint from before the field
    torch.save(payload, ck.path(ck.LATEST))
    assert ck.restore_latest(state, expect_rng_impl="threefry")["epoch"] == 1
    with pytest.raises(ValueError, match="rng_impl='threefry'"):
        ck.restore_latest(state, expect_rng_impl="rbg")

"""The port's grouped steps (``fira_tpu_torch/data/grouping.py``,
``train/step.multi_step`` and ``accum_step``, and the train loop's one
scheduler) against the JAX package's, on the same synthetic corpus written
by each package's own generator (fira-tiny, batch 8):

- ``grouped_plan`` (chunks, geometries, ``pad_to``) equal for fused K in
  {1, 2, 3} and accum A in {2, 4}, with a bucket table and without;
  ``stack_group`` and ``plan_report`` equal;
- ``multi_step`` over a stacked group equal to K ``train_step`` calls from
  the same state and dropout generator state (losses and weights, bitwise);
- ``accum_step`` against the JAX package's ``make_accum_step`` from the
  same weights, dropout off: loss rtol 1e-6, weights rtol 5e-3 / atol 1e-5
  (the JAX package's own accumulation tolerance,
  tests/test_train_decode.py); an accum group padded with all-invalid
  micro-batches equal to the plain step on its one real batch (the loss
  exactly, the weights at the same tolerance);
- the ``train_process`` gate positions (epoch, batch) and the optimizer
  step count of ``train`` with buckets and ``fused_steps=2``, and with
  buckets and ``accum_steps=2``, equal to the JAX loop's;
- the warning when ``fused_steps`` does not divide ``dev_every_batches``.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import grouping as JG
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.train import step as jax_step
from fira_tpu.train.loop import train as jax_train
from fira_tpu.train.state import init_state as jax_init_state
from fira_tpu_torch import convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data import grouping as G
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.train import state as state_lib
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.loop import train

N_COMMITS, SEED, BS = 120, 3, 8
NO_DROPOUT = dict(dropout_rate=0.0, gcn_dropout_rate=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=N_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=N_COMMITS, seed=SEED)
    kw = dict(batch_size=BS, test_batch_size=4)
    jds = JaxDataset(jdir, jax_fira_tiny(**kw))
    tds = FiraDataset(tdir, fira_tiny(**kw))
    buckets = B.choose_buckets(tds.splits["train"], tds.cfg)
    assert len(buckets) >= 2, buckets
    return dict(jds=jds, tds=tds, buckets=buckets)


def _cfgs(corpus, bucketed):
    buckets = corpus["buckets"] if bucketed else ()
    return (corpus["jds"].cfg.replace(buckets=buckets),
            corpus["tds"].cfg.replace(buckets=buckets))


@pytest.mark.parametrize("bucketed", [False, True], ids=["full", "buckets"])
@pytest.mark.parametrize("group_size,accum", [(1, False), (2, False),
                                              (3, False), (2, True),
                                              (4, True)])
def test_grouped_plan_matches_jax(corpus, bucketed, group_size, accum):
    jcfg, tcfg = _cfgs(corpus, bucketed)
    js, ts = corpus["jds"].splits["train"], corpus["tds"].splits["train"]
    for epoch in (0, 1):
        kw = dict(batch_size=BS, group_size=group_size, accum=accum,
                  shuffle=True, seed=5, epoch=epoch)
        want = JG.grouped_plan(js, jcfg, **kw)
        got = G.grouped_plan(ts, tcfg, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.geom == w.geom and g.pad_to == w.pad_to
            assert len(g.chunks) == len(w.chunks)
            for gc, wc in zip(g.chunks, w.chunks):
                np.testing.assert_array_equal(gc, wc)
        if group_size > 1:
            # groups really form, and the tails follow each mode's rule
            assert any(e.pad_to == group_size for e in got)
            if accum:
                assert all(e.pad_to == group_size for e in got)
            else:
                assert any(e.pad_to == 1 for e in got)
        assert (G.plan_report(ts, tcfg, got, batch_size=BS)
                == JG.plan_report(js, jcfg, want, batch_size=BS))


@pytest.mark.parametrize("pad_to", [None, 3])
def test_stack_group_matches_jax(corpus, pad_to):
    jcfg, tcfg = _cfgs(corpus, True)
    js, ts = corpus["jds"].splits["train"], corpus["tds"].splits["train"]
    geom = B.bucket_table(tcfg)[0]
    idx = np.where(B.sample_extents(ts, tcfg).admissible(geom))[0]
    chunks = [idx[:BS], idx[BS:BS + 5]]
    want = JG.stack_group([jax_make_batch(js, c, jcfg, batch_size=BS,
                                          geom=geom) for c in chunks],
                          pad_to=pad_to)
    got = G.stack_group([make_batch(ts, c, tcfg, batch_size=BS, geom=geom)
                         for c in chunks], pad_to=pad_to)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape == (pad_to or 2,) + \
            want[k].shape[1:]
        assert got[k].tobytes() == want[k].tobytes(), k
    # the assembly task stacks the same arrays and tags the geometry
    entry = G.GroupEntry(tuple(chunks), geom, pad_to or 2)
    (task,) = G.grouped_assembly_tasks(ts, [entry], tcfg, batch_size=BS)
    built = task()
    assert built.pop("_tag") == B.geom_tag(geom)
    for k in want:
        assert built[k].tobytes() == got[k].tobytes(), k
    assert "bucket " + B.geom_tag(geom) in task.note
    assert int(built["valid"].sum()) == BS + 5


def _stacked(corpus, n, cfg, sizes=None):
    """``n`` batches of one bucket's samples, stacked, on the CPU."""
    split = corpus["tds"].splits["train"]
    geom = B.bucket_table(cfg)[0]
    idx = np.where(B.sample_extents(split, cfg).admissible(geom))[0]
    sizes = sizes or [BS] * n
    starts = np.cumsum([0] + sizes[:-1])
    host = [make_batch(split, idx[s:s + m], cfg, batch_size=BS, geom=geom)
            for s, m in zip(starts, sizes)]
    return host, geom


def _device(batch):
    return batch_to_device(batch, torch.device("cpu"), TRAIN_FIELDS)


def test_multi_step_equals_sequential_steps(corpus):
    _, cfg = _cfgs(corpus, True)
    host, _ = _stacked(corpus, 3, cfg)
    a = state_lib.init_state(cfg, "cpu", seed=4)
    b = state_lib.init_state(cfg, "cpu", seed=4)
    got = step_lib.multi_step(a.model, a.optimizer,
                              _device(G.stack_group(host)),
                              a.generator)
    want = [step_lib.train_step(b.model, b.optimizer, _device(h),
                                b.generator) for h in host]
    assert got.shape == (3,)
    assert got.tolist() == [float(x) for x in want]
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n


def test_accum_step_matches_jax(corpus):
    jcfg, tcfg = _cfgs(corpus, True)
    jcfg = jcfg.replace(copy_head_impl="pallas", **NO_DROPOUT)
    tcfg = tcfg.replace(**NO_DROPOUT)
    host, geom = _stacked(corpus, 2, tcfg, sizes=[BS, 5])
    js = corpus["jds"].splits["train"]
    idx = np.where(B.sample_extents(corpus["tds"].splits["train"], tcfg)
                   .admissible(geom))[0]
    jhost = [jax_make_batch(js, idx[:BS], jcfg, batch_size=BS, geom=geom),
             jax_make_batch(js, idx[BS:BS + 5], jcfg, batch_size=BS,
                            geom=geom)]
    jmodel = JaxModel(jcfg)
    stacked = {k: jnp.asarray(v)
               for k, v in jax_step.stack_batches(jhost).items()}
    jstate = jax.jit(lambda b: jax_init_state(jmodel, jcfg, b))(
        {k: jnp.asarray(v) for k, v in jhost[0].items()})
    jnew, jm = jax.jit(jax_step.make_accum_step(jmodel, jcfg))(jstate,
                                                               stacked)

    model = FiraModel(tcfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    opt = state_lib.make_optimizer(model, tcfg)
    loss = step_lib.accum_step(model, opt,
                               _device(G.stack_group(host)),
                               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-6)
    want = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jnew.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=5e-3, atol=1e-5, err_msg=name)


def test_accum_tail_of_invalid_micro_batches_equals_plain_step(corpus):
    _, cfg = _cfgs(corpus, True)
    cfg = cfg.replace(**NO_DROPOUT)
    host, _ = _stacked(corpus, 1, cfg, sizes=[6])
    a = state_lib.init_state(cfg, "cpu", seed=2)
    b = state_lib.init_state(cfg, "cpu", seed=2)
    padded = _device(G.stack_group(host, pad_to=3))
    assert not padded["msg"][1:].any()
    got = step_lib.accum_step(a.model, a.optimizer, padded, a.generator)
    want = step_lib.train_step(b.model, b.optimizer, _device(host[0]),
                               b.generator)
    # the loss exactly; the weights at the JAX package's tolerance for the
    # same check: the plain step scales its backward by 1 / count at the
    # top, the accumulated one divides the summed gradients at the end
    assert float(got) == float(want)
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=5e-3, atol=1e-5, err_msg=n)


GATE_LINE = re.compile(r"^epoch: (\d+) batch: (\d+) dev bleu: \S+ "
                       r"is better: (?:True|False)$")


def _gates(out_dir):
    with open(os.path.join(out_dir, "train_process")) as f:
        lines = f.read().splitlines()
    matches = [GATE_LINE.match(line) for line in lines]
    assert lines and all(matches), lines
    return [(int(m[1]), int(m[2])) for m in matches]


@pytest.mark.parametrize("knobs", [dict(fused_steps=2), dict(accum_steps=2)],
                         ids=["fused2", "accum2"])
def test_train_gates_and_steps_match_jax(corpus, tmp_path, knobs):
    """fira-tiny gates every 4 batches from epoch 0. Both loops read only
    gate positions and step counts here, so the JAX side runs its XLA copy
    head."""
    jcfg, tcfg = _cfgs(corpus, True)
    jres = jax_train(corpus["jds"], jcfg.replace(**knobs),
                     out_dir=str(tmp_path / "jax"), epochs=2)
    tres = train(corpus["tds"], tcfg.replace(**knobs), device="cpu",
                 out_dir=str(tmp_path / "torch"), epochs=2)
    gates = _gates(str(tmp_path / "torch"))
    assert gates == _gates(str(tmp_path / "jax"))
    assert len(gates) == tres.gates > 2
    assert tres.state.step == tres.steps == int(jres.state.step)
    assert tres.groups > 0 and not tres.warnings
    if "accum_steps" in knobs:
        assert tres.batches == 2 * tres.steps
    else:
        assert tres.batches == tres.steps
    assert len(tres.losses) == tres.steps
    assert all(np.isfinite(tres.losses))


def test_fused_cadence_warning(corpus, tmp_path, capsys):
    _, tcfg = _cfgs(corpus, True)
    tres = train(corpus["tds"], tcfg.replace(fused_steps=3,
                                             dev_start_epoch=5),
                 device="cpu", out_dir=str(tmp_path), epochs=1)
    (w,) = tres.warnings
    assert "fused_steps=3 does not divide dev_every_batches=4" in w
    assert f"WARNING: {w}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="mutually exclusive"):
        train(corpus["tds"], tcfg.replace(fused_steps=2, accum_steps=2),
              device="cpu", out_dir=str(tmp_path), epochs=1)

"""The port's training mesh (``fira_tpu_torch/parallel/mesh.py``) against
the JAX package's (``fira_tpu/parallel/mesh.py``) on its 8-device virtual
CPU mesh (tests/conftest.py), at a tiny geometry, dropout off unless
stated. The port's ranks are spawned gloo processes on the CPU; one
module-scoped pool of 4 (``RankPool``) runs every layout's job
(``parallel/jobs.py``), so the processes start once.

- ``param_spec`` equals JAX's on every parameter, and the divisibility
  messages are JAX's words (``train`` raises, the CLI exits 2);
- one step at DP 2x1, TP 1x2 and 2x2 under the three encoder layouts JAX's
  own mesh test pins (tests/test_train_decode.py: parity, split buffer,
  flat scatter): the loss within rtol 2e-5 and the gathered gradients
  within rtol 5e-4 / atol 1e-5 of JAX's loss and gradient jitted with the
  shardings ``jit_train_step`` pins on the same layout (the split and flat
  layouts on 2x2 only: JAX compiles each layout once, and its loss does
  not depend on the layout, its own test's pin);
- a 1x1 mesh (a one-rank process group in this process) bitwise equal to
  no mesh: losses, parameters, ``latest.pt``'s bytes;
- the train loop's fused (``multi_step``) and accumulated
  (``accum_step``) groups on a 2x1 mesh: losses within rtol 1e-5 of one
  process;
- 3 Adam steps at 2x2 equal to the single-process run (losses rtol 1e-5;
  parameters atol 1e-5 where the first gradient is above 1e-6, else
  within 3 lr, as tests/test_torch_train.py holds Adam);
- with dropout on, the replicated parameters bit-identical across the
  tensor-parallel ranks, and the losses the single process' (a mesh draws
  the single-process masks between its ranks);
- checkpoints cross both ways between a 1x2 mesh run and a single-process
  run;
- the Feeder's stream byte-stable across workers and data-axis sizes, each
  rank's rows its block of the host batch (tests/test_multichip.py's
  counterpart);
- ``cli train --mesh``: exit 2 on divisibility, on more devices than
  visible and on ``--seq-shards`` the ranks cannot take; training with
  ``--device cpu --mesh 2x1``;
- the spawned ranks import no JAX and nothing of the JAX package."""

import dataclasses
import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.parallel import mesh as jax_pmesh
from fira_tpu.train.state import init_state as jax_init_state
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data import grouping as G
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, Feeder, batch_to_device
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.parallel import jobs
from fira_tpu_torch.parallel import mesh as pmesh
from fira_tpu_torch.train import state as state_lib
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.train.loop import train, train_rank

import torch_rank_jobs

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4,
            dropout_rate=0.0, gcn_dropout_rate=0.0)
OVERRIDES = {"parity": {},
             "split_buffer": {"encoder_buffer": "split", "sort_edges": True},
             "flat_scatter": {"flat_scatter": True, "sort_edges": True}}
LAYOUTS = [(2, 1), (1, 2), (2, 2)]
TABLE_SPEC = ((8, 192, 8), (16, 256, 8))
LR = 1e-4


def _cpu_mesh(n_data, n_model, **kw):
    return pmesh.make_mesh(n_data, n_model,
                           devices=["cpu"] * (n_data * n_model), **kw)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with pmesh.RankPool(_cpu_mesh(2, 2),
                        str(tmp_path_factory.mktemp("pool"))) as p:
        yield p


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=40, seed=5)
    synthetic.write_corpus_dir(tdir, n_commits=40, seed=5)
    jds = JaxDataset(jdir, JaxConfig(**GEOM))
    tds = FiraDataset(tdir, FiraConfig(**GEOM))
    jbatches = [jax_make_batch(jds.splits["train"], np.arange(4 * i, 4 * i + 4),
                               jds.cfg, batch_size=4) for i in range(3)]
    tbatches = [make_batch(tds.splits["train"], np.arange(4 * i, 4 * i + 4),
                           tds.cfg, batch_size=4) for i in range(3)]
    jb = {k: jnp.asarray(v) for k, v in jbatches[0].items()}
    jstate = jax.jit(lambda b: jax_init_state(JaxModel(jds.cfg), jds.cfg,
                                              b))(jb)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    return dict(jds=jds, tds=tds, jbatches=jbatches, tbatches=tbatches,
                params=params, full=convert.params_from_flax(params),
                jax_runs={})


def _jax_loss_grads(setup, name, layout):
    """JAX's loss and gradient of the first batch, jitted on ``layout``
    with the parameter and batch shardings ``jit_train_step`` pins."""
    key = (name, layout)
    if key not in setup["jax_runs"]:
        jcfg = setup["jds"].cfg.replace(**OVERRIDES[name])
        model = JaxModel(jcfg)
        mesh = jax_pmesh.make_mesh(n_data=layout[0], n_model=layout[1])
        # (the split/flat layouts also sort edges on the host)
        batch = {k: jnp.asarray(v) for k, v in jax_make_batch(
            setup["jds"].splits["train"], np.arange(4), jcfg,
            batch_size=4).items()}

        def loss(p, b):
            nll, cnt = model.apply({"params": p}, b, deterministic=True)
            return nll / jnp.maximum(cnt, 1)

        fn = jax.jit(jax.value_and_grad(loss), in_shardings=(
            jax_pmesh.params_shardings(setup["params"], mesh),
            jax_pmesh.batch_shardings(batch, mesh)))
        value, grads = fn(setup["params"], batch)
        setup["jax_runs"][key] = (float(value), {
            k: v.numpy() for k, v in convert.params_from_flax(
                jax.tree_util.tree_map(np.asarray, grads)).items()})
    return setup["jax_runs"][key]


def test_param_spec_matches_jax():
    model = FiraModel(fira_tiny(vocab_size=50, ast_change_vocab_size=20,
                                typed_edges=True))
    specs = {}
    for name, p in model.named_parameters():
        want = tuple(jax_pmesh.param_spec(convert.flax_path(name, p)))
        assert pmesh.param_spec(name, p) == want, name
        specs[want] = specs.get(want, 0) + 1
    # every rule of the table is exercised
    assert set(specs) == {(), (None, "model"), ("model",), ("model", None)}


def test_divisibility_errors_match_jax(setup, tmp_path):
    jcfg = jax_fira_tiny(buckets=TABLE_SPEC, batch_size=9)
    tcfg = fira_tiny(buckets=TABLE_SPEC, batch_size=9)
    want = jax_pmesh.divisibility_errors(jcfg, 2)
    assert len(want) == 3 and pmesh.divisibility_errors(tcfg, 2) == want
    assert pmesh.divisibility_errors(tcfg.replace(batch_size=8), 2) == []
    assert pmesh.divisibility_errors(tcfg, 1) == []
    cfg = setup["tds"].cfg.replace(batch_size=9)
    with pytest.raises(ValueError, match="divisibility"):
        train(setup["tds"], cfg, mesh=_cpu_mesh(2, 1),
              out_dir=str(tmp_path / "o"), epochs=1, resume=False)
    assert not os.path.exists(tmp_path / "o")   # refused before any build


@pytest.mark.parametrize("layout", LAYOUTS, ids=["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("name", list(OVERRIDES))
def test_one_step_matches_jax(setup, pool, name, layout):
    if name != "parity" and layout != (2, 2):
        jax_layout = (2, 2)
    else:
        jax_layout = layout
    want_loss, want_grads = _jax_loss_grads(setup, name, jax_layout)
    tcfg = setup["tds"].cfg.replace(**OVERRIDES[name])
    host = make_batch(setup["tds"].splits["train"], np.arange(4), tcfg,
                      batch_size=4)
    got = pool.run(jobs.step_job, tcfg, setup["full"], [host],
                   mesh=_cpu_mesh(*layout))[0]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=2e-5)
    assert sorted(got["grads"]) == sorted(want_grads)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want_grads[k], rtol=5e-4,
                                   atol=1e-5, err_msg=k)


def _single_steps(setup, cfg, n=3, seed=0):
    model = FiraModel(cfg)
    model.load_state_dict(setup["full"])
    opt = state_lib.make_optimizer(model, cfg)
    gen = torch.Generator().manual_seed(seed)
    batches = [batch_to_device(b, torch.device("cpu"), TRAIN_FIELDS)
               for b in setup["tbatches"][:n]]
    model.train()
    step_lib.loss_fn(model, batches[0], torch.Generator().manual_seed(seed)
                     ).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    opt.zero_grad(set_to_none=True)
    losses = [float(step_lib.train_step(model, opt, b, gen)) for b in batches]
    return losses, grads, model.state_dict()


def test_three_adam_steps_2x2_match_single_process(setup, pool):
    cfg = setup["tds"].cfg
    want_losses, grads, want_params = _single_steps(setup, cfg)
    got = pool.run(jobs.step_job, cfg, setup["full"], setup["tbatches"],
                   mesh=_cpu_mesh(2, 2))[0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    for k, w in want_params.items():
        diff = (got["params"][k] - w).abs()
        live = grads[k].abs() > 1e-6 if k in grads else torch.ones_like(
            diff, dtype=torch.bool)
        assert not live.any() or float(diff[live].max()) <= 1e-5, k
        assert float(diff.max()) <= 3 * LR + 1e-6, k


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_dropout_keeps_tp_replicas_identical(setup, pool, layout):
    cfg = setup["tds"].cfg.replace(dropout_rate=0.1, gcn_dropout_rate=0.2)
    res = pool.run(jobs.step_job, cfg, setup["full"], setup["tbatches"],
                   grads=False, mesh=_cpu_mesh(*layout))
    n_model = layout[1]
    for r in range(len(res)):
        peer = res[r - r % n_model]          # the first rank of its group
        assert sorted(res[r]["replicated"]) == sorted(peer["replicated"])
        for k, v in res[r]["replicated"].items():
            assert torch.equal(v, peer["replicated"][k]), (r, k)
    # the ranks draw the single process' masks between them
    want, _, _ = _single_steps(setup, cfg)
    np.testing.assert_allclose(res[0]["losses"], want, rtol=2e-5)


def test_mesh_1x1_bitwise_equals_no_mesh(setup, tmp_path):
    ds = setup["tds"]
    cfg = ds.cfg.replace(dropout_rate=0.1, gcn_dropout_rate=0.2,
                         dev_start_epoch=99, feeder_workers=0)
    a = train(ds, cfg, device="cpu", out_dir=str(tmp_path / "a"), epochs=1,
              resume=False)
    b = train(ds, cfg, device="cpu", mesh=_cpu_mesh(1, 1),
              out_dir=str(tmp_path / "b"), epochs=1, resume=False)
    assert a.losses == b.losses and len(a.losses) > 2
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert filecmp.cmp(tmp_path / "a" / "ckpt" / "latest.pt",
                       tmp_path / "b" / "ckpt" / "latest.pt", shallow=False)


def test_checkpoint_round_trip_mesh_and_single(setup, pool, tmp_path):
    ds = setup["tds"]
    cfg = ds.cfg.replace(dev_start_epoch=99, feeder_workers=0)
    kw = dict(ckpt_dir=None, var_maps=None)

    def single(out, epochs, resume=True):
        return train(ds, cfg, device="cpu", out_dir=str(out), epochs=epochs,
                     resume=resume, **kw)

    def on_mesh(out, epochs):
        return pool.run(train_rank, ds, cfg, dict(
            out_dir=str(out), epochs=epochs, resume=True, **kw),
            mesh=_cpu_mesh(1, 2))[0]

    ref1 = single(tmp_path / "ref", 1, resume=False)
    shutil.copytree(tmp_path / "ref", tmp_path / "to_mesh")
    ref2 = single(tmp_path / "ref", 2)
    # a mesh run's epoch 1, its checkpoint resumed by one process
    m1 = on_mesh(tmp_path / "from_mesh", 1)
    np.testing.assert_allclose(m1["losses"], ref1.losses, rtol=1e-5)
    saved = state_lib.CheckpointManager(
        str(tmp_path / "from_mesh" / "ckpt")).load_latest()
    want = state_lib.CheckpointManager(
        str(tmp_path / "ref" / "ckpt")).load_latest()
    assert {k: v.shape for k, v in saved["model"].items()} == {
        k: v.shape for k, v in want["model"].items()}
    assert saved["epoch"] == 1 and saved["step"] == len(ref1.losses)
    resumed = single(tmp_path / "from_mesh", 2)
    assert resumed.epochs_run == 1
    np.testing.assert_allclose(resumed.losses, ref2.losses, rtol=1e-5)
    # one process' epoch 1, resumed on the mesh
    m2 = on_mesh(tmp_path / "to_mesh", 2)
    assert m2["epochs_run"] == 1
    np.testing.assert_allclose(m2["losses"], ref2.losses, rtol=1e-5)


def test_feeder_stream_byte_stable_across_workers_and_data_axis(
        tmp_path_factory):
    d = str(tmp_path_factory.mktemp("feed_corpus"))
    synthetic.write_corpus_dir(d, n_commits=28, seed=9)
    ds = FiraDataset(d, fira_tiny(batch_size=8, buckets=TABLE_SPEC))
    cfg, split = ds.cfg, ds.splits["train"]
    table = B.bucket_table(cfg)
    plan = G.grouped_plan(split, cfg, batch_size=8, group_size=2,
                          shuffle=True, seed=5, epoch=1, table=table)

    def stream(workers, mesh):
        tasks = G.grouped_assembly_tasks(split, plan, cfg, batch_size=8)
        with Feeder(tasks, num_workers=workers, depth=3, device="cpu",
                    fields=TRAIN_FIELDS,
                    sharding=pmesh.feed_shardings(mesh)) as feed:
            return [(item.host, item.device) for item in feed]

    ref = [h for h, _ in stream(0, None)]
    saw = set()
    for workers, n_data in ((2, 1), (0, 2), (2, 4)):
        for rank in range(n_data):
            mesh = dataclasses.replace(_cpu_mesh(n_data, 1), rank=rank)
            got = stream(workers, mesh)
            assert len(got) == len(ref) == len(plan)
            for want, (host, dev) in zip(ref, got):
                assert set(want) == set(host)
                for k in want:
                    if k == "_tag":
                        assert want[k] == host[k]
                    else:
                        np.testing.assert_array_equal(want[k], host[k])
                stacked = host["valid"].ndim == 2
                saw.add(stacked)
                axis = 1 if stacked else 0
                per = host["msg"].shape[axis] // n_data
                rows = np.take(host["msg"], range(rank * per,
                                                  (rank + 1) * per), axis)
                np.testing.assert_array_equal(dev["msg"].numpy(), rows)
    assert saw == {True, False}


def test_cli_train_mesh(tmp_path, capsys):
    d = str(tmp_path / "corpus")
    synthetic.write_corpus_dir(d, n_commits=16, seed=5)
    base = ["train", "--config", "fira-tiny", "--data-dir", d,
            "--device", "cpu"]
    assert cli.main([*base, "--batch-size", "9", "--mesh", "2x1",
                     "--out-dir", str(tmp_path / "x")]) == 2
    err = capsys.readouterr().err
    assert "batch_size 9 is not divisible by the mesh's data axis " \
           "(n_data=2)" in err
    assert cli.main([*base, "--seq-shards", "2",
                     "--out-dir", str(tmp_path / "x")]) == 2
    assert "seq_shards=2 does not divide the 1 visible devices" in \
        capsys.readouterr().err
    assert cli.main([*base, "--seq-shards", "2", "--mesh", "1x2",
                     "--batch-size", "4",
                     "--out-dir", str(tmp_path / "x")]) == 2
    assert "ROADMAP A.10" in capsys.readouterr().err
    if torch.cuda.device_count() < 2:
        # a mesh larger than the GPUs visible, in the JAX package's words
        assert cli.main(["train", "--config", "fira-tiny", "--data-dir", d,
                         "--mesh", "2x1",
                         "--out-dir", str(tmp_path / "x")]) == 2
        assert (f"need 2 devices, have {torch.cuda.device_count()}"
                in capsys.readouterr().err)
    out = str(tmp_path / "out")
    assert cli.main([*base, "--mesh", "2x1", "--batch-size", "4",
                     "--epochs", "1", "--out-dir", out]) == 0
    assert "best dev bleu:" in capsys.readouterr().out
    payload = state_lib.CheckpointManager(
        os.path.join(out, "ckpt")).load_latest()
    model = FiraModel(FiraDataset(d, fira_tiny()).cfg)
    model.load_state_dict(payload["model"])
    assert payload["epoch"] == 1


def test_ranks_import_no_jax(pool):
    banned = {"jax", "jaxlib", "flax", "orbax", "fira_tpu"}
    for loaded in pool.run(torch_rank_jobs.modules_job):
        assert "fira_tpu_torch" in loaded and not banned & set(loaded)


@pytest.mark.parametrize("knobs", [{"fused_steps": 2}, {"accum_steps": 2}],
                         ids=["fused", "accum"])
def test_grouped_steps_on_a_mesh_match_single_process(setup, pool, tmp_path,
                                                      knobs):
    """``multi_step`` and ``accum_step`` under a 2x1 mesh: the train
    loop's losses equal one process' (the stacked groups' rows cut on
    axis 1, the accumulated count summed over the data axis)."""
    ds = setup["tds"]
    cfg = ds.cfg.replace(dev_start_epoch=99, feeder_workers=0, **knobs)
    kw = dict(epochs=1, resume=False, ckpt_dir=None, var_maps=None)
    want = train(ds, cfg, device="cpu", out_dir=str(tmp_path / "one"), **kw)
    got = pool.run(train_rank, ds, cfg, dict(out_dir=str(tmp_path / "mesh"),
                                             **kw), mesh=_cpu_mesh(2, 1))[0]
    assert got["groups"] == want.groups > 0
    np.testing.assert_allclose(got["losses"], want.losses, rtol=1e-5)

"""The port's training path against the JAX package's, on the same weights
and batches (a tiny geometry; the JAX side runs the Pallas copy head,
interpreted on the CPU, jitted):

- the loss (nll_sum, count) at rtol 1e-5 with the count exact, and every
  parameter's gradient at rtol 5e-4 / atol 1e-5 (the JAX package's own
  gradient tolerance, tests/test_copy_score.py);
- ``dev_predict`` ids exactly;
- Adam alone on the same numpy gradients for 3 steps at rtol 1e-6 /
  atol 1e-8 (rounding only);
- 3 train steps with dropout off (dropout streams cannot match across
  frameworks): losses at rtol 1e-5; parameters at atol 1e-5 wherever the
  step-1 gradient has |g| > 1e-6, and elsewhere within 3 lr, because there
  Adam's g / (|g| + eps) turns rounding noise into up to a step;
- a JAX train state carried across after one step (weights and Adam
  moments): the next step's losses at rtol 1e-5;
- the epoch batch order equal to the JAX loop's for the same seed and
  epoch;
- ``train_step``, ``multi_step`` and ``accum_step`` record their forward,
  backward and optimizer spans, a step each (accum: one forward and
  backward a micro-batch, one optimizer), and count ``train.steps`` /
  ``train.issue_bound`` only on a CUDA device, by the state of the event
  the previous step recorded at its end."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fira_tpu.config import FiraConfig as JaxConfig
from fira_tpu.data import grouping
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.train import step as jax_step
from fira_tpu.train.state import init_state as jax_init_state
from fira_tpu_torch import convert
from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import epoch_index_chunks, make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.data.grouping import stack_group
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.train import state as state_lib
from fira_tpu_torch.train import step as step_lib
from fira_tpu_torch.utils import profiling

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4,
            dropout_rate=0.0, gcn_dropout_rate=0.0)
LR = 1e-4
N_STEPS = 3


def _flat(tree):
    """Flax tree -> {port parameter name: numpy array} (transposed as the
    weights are)."""
    return {k: v.numpy() for k, v in convert.params_from_flax(tree).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=40, seed=5)
    synthetic.write_corpus_dir(tdir, n_commits=40, seed=5)
    jds = JaxDataset(jdir, JaxConfig(**GEOM, copy_head_impl="pallas"))
    tds = FiraDataset(tdir, FiraConfig(**GEOM))
    jcfg, tcfg = jds.cfg, tds.cfg
    split = len(jds.splits["train"])
    chunks = [np.arange(4 * i, 4 * i + 4) % split for i in range(N_STEPS)]
    chunks[0] = chunks[0][:3]      # a partial batch: one all-pad row
    jbatches = [jax_make_batch(jds.splits["train"], c, jcfg, batch_size=4)
                for c in chunks]
    tbatches = [make_batch(tds.splits["train"], c, tcfg, batch_size=4)
                for c in chunks]
    jmodel = JaxModel(jcfg)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in jbatches]
    jstate = jax.jit(lambda b: jax_init_state(jmodel, jcfg, b))(jb[0])

    def loss(p, b):
        nll, cnt = jmodel.apply({"params": p}, b, deterministic=True)
        return nll / jnp.maximum(cnt, 1), (nll, cnt)

    (_, (nll, cnt)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jstate.params, jb[0])
    dev_ids = jax.jit(jax_step.make_dev_step(jmodel))(jstate.params, jb[0])
    step = jax.jit(jax_step.make_train_step(jmodel, jcfg))
    states, losses = [jstate], []
    for b in jb:
        s, m = step(states[-1], b)
        states.append(s)
        losses.append(float(m["loss"]))
    return dict(jcfg=jcfg, tcfg=tcfg, jb=jb, tbatches=tbatches,
                jstate=jstate, nll=float(nll), cnt=int(cnt), grads=grads,
                dev_ids=np.asarray(dev_ids), states=states, losses=losses,
                step=step, jds=jds, tds=tds)


def _port_model(setup, params):
    model = FiraModel(setup["tcfg"])
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def _device(batch):
    return batch_to_device(batch, torch.device("cpu"), TRAIN_FIELDS)


def test_loss_and_gradients_match_jax(setup):
    model = _port_model(setup, setup["jstate"].params)
    model.eval()
    batch = _device(setup["tbatches"][0])
    with torch.no_grad():
        nll, cnt = model(batch)
    assert int(cnt) == setup["cnt"]
    np.testing.assert_allclose(float(nll), setup["nll"], rtol=1e-5)
    step_lib.loss_fn(model, batch).backward()
    want = _flat(setup["grads"])
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=5e-4,
                                   atol=1e-5, err_msg=name)


def test_dev_predict_matches_jax(setup):
    model = _port_model(setup, setup["jstate"].params)
    model.train()      # dev_predict turns dropout off by itself
    ids = model.dev_predict(_device(setup["tbatches"][0]))
    assert model.training
    np.testing.assert_array_equal(ids.numpy(), setup["dev_ids"])


def test_adam_alone_matches_optax(setup):
    model = _port_model(setup, setup["jstate"].params)
    opt = state_lib.make_optimizer(model, setup["tcfg"])
    assert setup["tcfg"].lr == LR
    rng = np.random.default_rng(3)
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tx = optax.adam(LR)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jopt = tx.init(jparams)

    @jax.jit
    def update(grads, jopt, jparams):
        upd, jopt = tx.update(grads, jopt, jparams)
        return optax.apply_updates(jparams, upd), jopt

    for _ in range(3):
        # magnitudes from 1e-9 to 1, the near-eps range included
        grads = {n: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(
            -9, 0, v.shape)).astype(np.float32) for n, v in params.items()}
        jparams, jopt = update(grads, jopt, jparams)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]),
                                   rtol=1e-6, atol=1e-8, err_msg=n)


def _port_steps(model, opt, batches):
    gen = torch.Generator().manual_seed(0)
    return [float(step_lib.train_step(model, opt, _device(b), gen))
            for b in batches]


def test_train_steps_match_jax(setup):
    model = _port_model(setup, setup["jstate"].params)
    opt = state_lib.make_optimizer(model, setup["tcfg"])
    losses = _port_steps(model, opt, setup["tbatches"])
    np.testing.assert_allclose(losses, setup["losses"], rtol=1e-5)
    want = _flat(setup["states"][-1].params)
    g1 = _flat(setup["grads"])
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        big = np.abs(g1[name]) > 1e-6
        np.testing.assert_allclose(got[big], want[name][big], rtol=0,
                                   atol=1e-5, err_msg=name)
        assert np.all(np.abs(got - want[name])[~big] <= 3 * LR), name


def test_state_carried_across_continues_the_run(setup):
    """One JAX step, then its weights and Adam moments go to the port
    (``adam_state_from_optax``); both sides take the next step."""
    s1 = setup["states"][1]
    adam = s1.opt_state[0]
    model = _port_model(setup, s1.params)
    opt = state_lib.make_optimizer(model, setup["tcfg"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    opt.load_state_dict(convert.adam_state_from_optax(
        to_np(adam.mu), to_np(adam.nu), np.asarray(adam.count), model,
        lr=LR))
    assert opt.param_groups[0]["lr"] == LR
    losses = _port_steps(model, opt, setup["tbatches"][1:])
    np.testing.assert_allclose(losses, setup["losses"][1:], rtol=1e-5)
    step2 = opt.state[next(model.parameters())]["step"]
    assert float(step2) == N_STEPS


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (7, 1)])
def test_epoch_batch_order_matches_jax(setup, seed, epoch):
    jsplit = setup["jds"].splits["train"]
    n = len(jsplit)
    jcfg = setup["jcfg"].replace(batch_size=3)
    plan = grouping.grouped_plan(jsplit, jcfg, batch_size=3, group_size=1,
                                 shuffle=True, seed=seed, epoch=epoch)
    want = [entry[0][0] for entry in plan]
    got = epoch_index_chunks(n, setup["tcfg"], batch_size=3, shuffle=True,
                             seed=seed, epoch=epoch)
    assert len(got) == len(want) == -(-n // 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_round_trip_resumes_the_stream(setup, tmp_path):
    """latest.pt restores weights, Adam state, the step and the dropout
    generator: a restored state's next step equals the original's."""
    cfg = setup["tcfg"].replace(dropout_rate=0.1, gcn_dropout_rate=0.2)
    a = state_lib.init_state(cfg, "cpu", seed=4)
    batch = _device(setup["tbatches"][1])
    step_lib.train_step(a.model, a.optimizer, batch, a.generator)
    a.step = 1
    ckpt = state_lib.CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_latest(a, best_bleu=0.25, epoch=3)
    ckpt.save_best(a.model)
    b = state_lib.init_state(cfg, "cpu", seed=9)
    meta = ckpt.restore_latest(b)
    assert meta == {"epoch": 3, "best_bleu": 0.25} and b.step == 1
    la = step_lib.train_step(a.model, a.optimizer, batch, a.generator)
    lb = step_lib.train_step(b.model, b.optimizer, batch, b.generator)
    assert float(la) == float(lb)
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n
    best = torch.load(ckpt.path(ckpt.BEST), weights_only=True)
    assert set(best) == set(a.model.state_dict())


@pytest.mark.parametrize("entry,k,want", [
    ("train_step", 1, (1, 1, 1)),
    ("multi_step", 3, (3, 3, 3)),
    ("accum_step", 3, (3, 3, 1)),
])
def test_steps_record_their_spans(setup, entry, k, want):
    """Forward, backward and optimizer spans a call (K steps of
    ``multi_step``; A micro-batches and one optimizer step of
    ``accum_step``); no step counter on the CPU."""
    st = state_lib.init_state(setup["tcfg"], "cpu", seed=4)
    hosts = setup["tbatches"][:k]
    batch = _device(hosts[0] if k == 1 else stack_group(hosts))
    mark = profiling.mark()
    getattr(step_lib, entry)(st.model, st.optimizer, batch, st.generator)
    spans = profiling.spans(since=mark)
    got = tuple(spans[f"train.{p}"]["count"]
                for p in ("forward", "backward", "optimizer"))
    assert got == want
    assert all(v["total_s"] > 0 for v in spans.values())
    assert profiling.counters(since=mark) == {}


@pytest.mark.parametrize("idle", [True, False])
def test_issue_bound_counts_a_step_whose_stream_is_idle(monkeypatch, idle):
    """On a CUDA device a step after another counts ``train.steps``, and
    ``train.issue_bound`` when the event the previous step recorded after
    its last launch has completed (``query()``, stubbed here: no card on
    the CPU). The first step on a device, and a step on the CPU, count
    nothing; one event a device is recorded again each step."""
    events, streams = [], []

    class Event:
        def __init__(self):
            self.on = []
            events.append(self)

        def record(self, stream):
            self.on.append(stream)

        def query(self):
            return idle

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: streams.append(device) or "stream")
    monkeypatch.setattr(step_lib, "_STEP_ENDS", {})

    class OnCard:
        device = torch.device("cuda", 0)

    card, cpu = {"diff": OnCard()}, {"diff": torch.zeros(1)}
    mark = profiling.mark()
    step_lib._count_issue(card)     # the first step: nothing to query
    assert profiling.counters(since=mark) == {}
    step_lib._end_step(card)
    step_lib._count_issue(card)
    step_lib._end_step(card)
    step_lib._count_issue(cpu)
    step_lib._end_step(cpu)
    assert len(events) == 1 and events[0].on == ["stream", "stream"]
    assert streams == [torch.device("cuda", 0)] * 2
    want = {"train.steps": 1}
    if idle:
        want["train.issue_bound"] = 1
    assert profiling.counters(since=mark) == want


@pytest.mark.parametrize("entry,k", [("train_step", 1), ("accum_step", 2)])
def test_issue_probe_brackets_the_step(setup, monkeypatch, entry, k):
    """A step queries the previous step's end before its first launch
    (ahead of the forward's span) and records its own end after its last
    (behind the optimizer's span)."""
    calls = []
    record = profiling.RECORDER.record
    monkeypatch.setattr(profiling.RECORDER, "record",
                        lambda name, a, b: calls.append(name)
                        or record(name, a, b))
    monkeypatch.setattr(step_lib, "_count_issue",
                        lambda batch: calls.append("query"))
    monkeypatch.setattr(step_lib, "_end_step",
                        lambda batch: calls.append("end"))
    st = state_lib.init_state(setup["tcfg"], "cpu", seed=4)
    hosts = setup["tbatches"][:k]
    batch = _device(hosts[0] if k == 1 else stack_group(hosts))
    getattr(step_lib, entry)(st.model, st.optimizer, batch, st.generator)
    assert calls == (["query"] + ["train.forward", "train.backward"] * k
                     + ["train.optimizer", "end"])

"""The plain reference against the port at a tiny size on the CPU, on
seeded weights and generated commits: the training loss (dropout off and
on, the same stream) and every gradient."""

import os
import time

import numpy as np
import pytest
import torch

import tiny
from benchmark.harness import bench
from benchmark.harness import program as P
from benchmark.harness import weights as weights_lib
from benchmark.reference import batch as ref_batch
from benchmark.reference.model import Ref


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    spec = tiny.write(d)
    c = bench.cell("train.tiny", spec, os.path.join(d, "benchmark"))
    ctx = bench.Ctx(torch=torch, workload=c["workload"], config=c["config"],
                    traffic=c["traffic"], limits=c["limits"], seed=424242,
                    seconds=1.0, trace=False, device=torch.device("cpu"),
                    t0=time.perf_counter())
    commits = P.pool(ctx)[:8]
    words, asts = P.vocabs(ctx.cfg)
    cfg = P.port_config(ctx)
    split = P.port_split(commits, cfg)
    return (ctx, cfg, commits, split,
            ref_batch.make_batch(commits, ctx.cfg, words, asts, "cpu"))


def port_batch(split, cfg, n):
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device

    return batch_to_device(make_batch(split, np.arange(n), cfg, batch_size=n),
                           torch.device("cpu"), TRAIN_FIELDS)


def test_batch_matches_port(setup):
    from fira_tpu_torch.model.model import dense_adjacency

    ctx, cfg, commits, split, ref = setup
    b = port_batch(split, cfg, len(commits))
    for k, rk in (("diff", "diff"), ("diff_mark", "mark"),
                  ("ast_change", "ast_change"), ("sub_token", "sub_token"),
                  ("msg", "msg"), ("msg_tar", "msg_tar")):
        assert torch.equal(b[k].long(), ref[rk]), k
    adj = dense_adjacency(b["senders"], b["receivers"], b["values"],
                          cfg.graph_len)
    torch.testing.assert_close(adj, ref["adj"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dropout", [False, True])
def test_train_loss_and_gradients(setup, dropout):
    from fira_tpu_torch.train.step import loss_fn

    ctx, cfg, commits, split, ref = setup
    model = P.port_model(ctx, cfg)
    model.train(dropout)
    g_port = torch.Generator().manual_seed(7) if dropout else None
    loss = loss_fn(model, port_batch(split, cfg, len(commits)), g_port)
    loss.backward()
    w = {k: v.clone().requires_grad_(True)
         for k, v in weights_lib.make(ctx.cfg, ctx.seed, "cpu").items()}
    r = Ref(w, ctx.cfg, torch.Generator().manual_seed(7) if dropout else None)
    rl = r.loss(ref)
    rl.backward()
    assert float(loss.detach()) == pytest.approx(float(rl.detach()), rel=1e-6)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, w[name].grad, rtol=1e-4,
                                   atol=1e-6, msg=name)

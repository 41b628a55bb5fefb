"""Training window: ``fira_tpu_torch.train.step.train_step`` on batches the
port's ``data.feeder.Feeder`` assembles (``data.batching.make_batch``)
from the seeded pool, with Adam and dropout on, at the configuration's
full geometry.

Set-up builds one model, optimizer and dropout generator, drives them
through the first three steps (the checked ones, on rows that all
differ) and ``warm_steps`` more, and hands the same objects to the
window. The window runs steps until ``--seconds`` have passed, then
synchronises: commits over the window's seconds.

After the window (peak memory read, the program's state freed) the plain
reference follows the first three steps from the seed's weights and the
same commits and dropout stream: each step's loss, the first gradient as
Adam got it (its first moment after step 1, over 1 - beta1) and each
parameter's change after step 3, compared leaf by leaf by their norms.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import roofline
from benchmark.harness import program as P
from benchmark.harness import weights as weights_lib
from benchmark.harness.trace import Tracer
from benchmark.reference import batch as ref_batch
from benchmark.reference.model import Ref

CHECKED_STEPS = 3
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def run(ctx) -> dict:
    torch = ctx.torch
    from fira_tpu_torch.cli import resolve_device
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, Feeder
    from fira_tpu_torch.train import step as step_mod
    from fira_tpu_torch.train.state import make_optimizer

    tr = ctx.traffic
    phase = P.Phases()
    device = resolve_device(ctx.device.type)
    cfg = P.port_config(ctx)
    B = int(tr["batch_size"])
    commits = P.pool(ctx)
    phase("pool")
    split = P.port_split(commits, cfg)
    chunk = P.order(ctx.seed, len(commits))
    phase("process_record")

    def tasks():
        i = 0
        while True:
            idx = chunk(i, B)
            yield lambda idx=idx: make_batch(split, idx, cfg, batch_size=B)
            i += 1

    model = P.port_model(ctx, cfg)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(P.dropout_seed(ctx.seed))
    names = [n for n, _ in model.named_parameters()]
    phase("weights")
    spans = P.Spans()
    tracer = Tracer(torch) if ctx.trace else None
    feed = Feeder(tasks(), num_workers=cfg.feeder_workers,
                  depth=cfg.feeder_depth, device=device, fields=TRAIN_FIELDS)
    try:
        losses, g1, w3 = [], None, None
        for k in range(CHECKED_STEPS + int(tr["warm_steps"])):
            item = next(feed)
            loss = step_mod.train_step(model, opt, item.device, gen)
            if k < CHECKED_STEPS:
                losses.append(loss)
            if k == 0:
                g1 = [(opt.state[p]["exp_avg"] / (1 - BETA1)).cpu()
                      if p in opt.state else torch.zeros(p.shape)
                      for p in model.parameters()]
            if k == CHECKED_STEPS - 1:
                w3 = [p.detach().to("cpu", copy=True)
                      for p in model.parameters()]
        losses = [float(x) for x in losses]
        phase("first_steps")

        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t0
        spans.open = True
        if tracer:
            tracer.start()
        steps = commits_done = 0
        while True:
            with spans("feed"):
                item = next(feed)
            with spans("train_step"):
                step_mod.train_step(model, opt, item.device, gen)
            steps += 1
            commits_done += item.n_valid
            if tracer and steps == int(tr["trace_steps"]):
                tracer.stop()
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        spans.open = False
        if tracer:
            tracer.stop()
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    finally:
        feed.close()
    trace = tracer.summary(spans.intervals) if tracer else None
    del model, opt, gen, feed, item
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(ctx, commits, names, losses, g1, w3, B, chunk)
    shape = (B, cfg.tar_len, cfg.copy_len, cfg.embedding_dim)
    return dict(
        driver="train", setup_s=setup_s, window_s=t1 - t0, peak_bytes=peak,
        commits=commits_done, steps=steps, attempted=steps, failed=0,
        spans=spans.s, counts=spans.n,
        model_flops=commits_done * roofline.train_commit_flops(ctx.cfg),
        peak_flops=roofline.PEAK_F32_FLOPS, trace=trace,
        k1_bound_s=roofline.k1_bound_s(*shape),
        k2_bound_s=roofline.k2_bound_s(*shape), checks=checks,
        readings=dict(losses=losses, setup_phases=phase.s))


def reference_steps(ctx, commits, B, chunk, n_steps=CHECKED_STEPS,
                    rows_kept=None):
    """The plain reference's first ``n_steps`` from the seed: (losses,
    first gradients, parameters after the last step, initial
    parameters), all leaves in the weights' order. ``rows_kept``: the
    batch rows each step keeps (the half-batch fault)."""
    torch = ctx.torch
    dev = ctx.device
    words, asts = P.vocabs(ctx.cfg)
    w0 = weights_lib.make(ctx.cfg, ctx.seed, dev)
    names = list(w0)
    leaves = {n: w0[n].clone().requires_grad_(True) for n in names}
    gen = torch.Generator(device=dev).manual_seed(P.dropout_seed(ctx.seed))
    ref = Ref(leaves, ctx.cfg, gen)
    m = {n: torch.zeros_like(leaves[n]) for n in names}
    v = {n: torch.zeros_like(leaves[n]) for n in names}
    lr = float(ctx.cfg["lr"])
    losses, g1 = [], None
    for k in range(n_steps):
        batch = ref_batch.make_batch([commits[i] for i in chunk(k, B)],
                                     ctx.cfg, words, asts, dev)
        loss = ref.loss(batch, rows_kept)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        if k == 0:
            g1 = [g.detach() for g in grads]
        with torch.no_grad():
            t = k + 1
            for n, g in zip(names, grads):
                m[n].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[n].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                denom = (v[n].sqrt() / (1 - BETA2 ** t) ** 0.5).add_(EPS)
                leaves[n].addcdiv_(m[n], denom, value=-lr / (1 - BETA1 ** t))
        del batch, loss, grads
    w3 = [leaves[n].detach() for n in names]
    return names, losses, g1, w3, [w0[n] for n in names]


def leaf_gap(prog, ref, keep):
    """Worst leaf of | |prog| - |ref| | over max(|ref|, the median leaf's
    |ref|), over the leaves ``keep`` marks."""
    pn = np.array([float(x.double().norm()) for x in prog])
    rn = np.array([float(x.double().norm()) for x in ref])
    med = float(np.median(rn[keep]))
    gap = np.abs(pn - rn) / np.maximum(rn, med)
    return float(gap[keep].max())


def compare(names_p, losses_p, g1_p, w3_p, ref_out):
    """The three numbers from the program's readings and the reference's
    run: loss_gap (worst step, relative), grad_gap and delta_gap (worst
    leaf). Leaves whose reference gradient norm is under a thousandth of
    the median leaf's are left out (nought to rounding: they move under
    Adam by round-off alone)."""
    names_r, losses_r, g1_r, w3_r, w0_r = ref_out
    order = [names_p.index(n) for n in names_r]
    g1_p = [g1_p[i].to(g1_r[0].device) for i in order]
    w3_p = [w3_p[i].to(g1_r[0].device) for i in order]
    gn = np.array([float(g.double().norm()) for g in g1_r])
    keep = gn >= 1e-3 * float(np.median(gn))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    grad_gap = leaf_gap(g1_p, g1_r, keep)
    delta_gap = leaf_gap([a - b for a, b in zip(w3_p, w0_r)],
                         [a - b for a, b in zip(w3_r, w0_r)], keep)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, delta_gap=delta_gap,
                leaves_left_out=int((~keep).sum()))


def check(ctx, commits, names, losses, g1, w3, B, chunk):
    torch = ctx.torch
    P.tf32_off(torch)
    r = compare(names, losses, g1, w3,
                reference_steps(ctx, commits, B, chunk))
    return [P.check(k, r[k], ctx.limits)
            for k in ("loss_gap", "grad_gap", "delta_gap")]

"""Rank jobs that hold a mesh layout against one process: each runs in
every rank of a ``RankPool`` (``parallel/mesh.py``) as ``fn(mesh, ...)``
and returns what the caller compares, on the CPU. ``chip_smoke.py`` sends
them all, the CPU tests the first and the third; they live in the port so
that spawned ranks import nothing but it.

- :func:`step_job`: train steps of the model on this rank's part of the
  mesh, from whole weights: the global loss of each step, the first
  batch's gradients and the weights after the steps gathered whole, this
  rank's replicated parameters (the tensor-parallel ranks must keep them
  bit-identical), the steps' wall time, peak memory and kernel launches.
- :func:`model_job`: the model's loss (and optionally the full-prefix
  beam) on this rank's rows, with the cross-attention on the ring under
  ``cfg.seq_shards``.
- :func:`probe_job`, :func:`all_reduce_job`: which collectives the
  backend runs on the mesh's devices, and the time of out_fc's
  all-reduce.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.data.feeder import DEVICE_FIELDS, TRAIN_FIELDS, \
    batch_to_device
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.ops import copy_score
from fira_tpu_torch.parallel import mesh as pmesh


def local_model(mesh, cfg: FiraConfig, full_sd) -> FiraModel:
    """This rank's model on its device, cut from the whole ``full_sd``."""
    model = FiraModel(cfg, device=mesh.device, mesh=mesh)
    model.load_state_dict(pmesh.shard_state(full_sd, mesh))
    return model


def _rows(mesh, host: Dict, fields) -> Dict[str, torch.Tensor]:
    return batch_to_device(pmesh.feed_shardings(mesh)(host), mesh.device,
                           fields)


def _cpu(sd) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_job(mesh, cfg: FiraConfig, full_sd, host_batches: List[Dict], *,
             seed: int = 0, grads: bool = True) -> Dict:
    """``len(host_batches)`` train steps (``train_step`` under the mesh)
    from the whole weights ``full_sd``, dropout from a generator seeded
    ``seed`` on every rank. With ``grads`` the first batch's gradients
    are taken first from a generator of the same seed, without a step.
    Gathers are collectives: every rank returns, rank 0 the whole
    tensors."""
    from fira_tpu_torch.train.state import make_optimizer
    from fira_tpu_torch.train.step import loss_fn, train_step

    dev = mesh.device
    model = local_model(mesh, cfg, full_sd)
    optimizer = make_optimizer(model, cfg)
    batches = [_rows(mesh, b, TRAIN_FIELDS) for b in host_batches]
    out: Dict = {}
    if grads:
        model.train()
        g0 = torch.Generator(device=dev).manual_seed(seed)
        loss_fn(model, batches[0], g0, mesh).backward()
        pmesh.sync_grads(model, mesh)
        whole = pmesh.gather_state(
            {n: p.grad for n, p in model.named_parameters()}, mesh)
        out["grads"] = _cpu(whole)
        optimizer.zero_grad(set_to_none=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    copy_score.copy_scores.launches = 0
    copy_score.copy_scores_backward.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    losses = [train_step(model, optimizer, b, gen, mesh) for b in batches]
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0
    out["k1"] = copy_score.copy_scores.launches
    out["k2"] = copy_score.copy_scores_backward.launches
    out["peak"] = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    out["losses"] = [float(x) for x in losses]
    out["params"] = _cpu(pmesh.gather_state(model.state_dict(), mesh))
    out["replicated"] = {n: p.detach().cpu()
                         for n, p in model.named_parameters()
                         if pmesh.shard_dim(n, p) is None}
    if mesh.rank:
        out.pop("grads", None)
        out.pop("params")
    return out


def model_job(mesh, cfg: FiraConfig, full_sd, host: Dict,
              beam: bool = False) -> Dict:
    """This rank's (nll_sum, count) of the model on its rows of ``host``
    with dropout off, and with ``beam`` the full-prefix beam's (tokens,
    probs) of those rows (``beam_early_exit`` must be off: every rank
    steps the ring together)."""
    from fira_tpu_torch.decode.beam import beam_search

    model = local_model(mesh, cfg, full_sd).eval()
    with torch.no_grad():
        nll, count = model(_rows(mesh, host, TRAIN_FIELDS))
        out = {"nll": float(nll), "count": int(count)}
        if beam:
            tokens, probs = beam_search(model, _rows(mesh, host,
                                                     DEVICE_FIELDS), cfg)
            out.update(tokens=tokens.cpu(), probs=probs.cpu())
    return out


PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "send_recv")


def probe_job(mesh, ops=PROBE_OPS, modes=("native", "staged"),
              n: int = 1 << 16) -> Dict:
    """Which collectives the mesh's backend runs on its devices' tensors,
    each tried natively (``torch.distributed`` on the tensor itself) or
    through the mesh module's host staging (``mode`` "staged"), each
    checked against its expected values (send/recv only with two ranks or
    more). Returns {"op mode": "ok", "wrong values" or the error}. A
    native collective that the backend cannot run may also end the
    process, which the pool reports."""
    import torch.distributed as dist

    g = mesh.group(pmesh.ALL)
    W, r = mesh.world, mesh.rank
    x = torch.full((n,), float(r + 1), device=mesh.device)

    def native(op):
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y, group=g)
        elif op == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0, group=g)
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(W)]
            dist.all_gather(parts, x, group=g)
            y = torch.cat(parts)
        else:
            y = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (r - 1) % W, g),
                   dist.P2POp(dist.irecv, y, (r + 1) % W, g)]
            for q in dist.batch_isend_irecv(ops):
                q.wait()
        return y

    def staged(op):
        if op == "all_reduce":
            return pmesh.all_reduce_(x.clone(), g)
        if op == "broadcast":
            return pmesh.broadcast_(x.clone(), g, 0)
        if op == "all_gather":
            return pmesh.all_gather(x, g, 0)
        return pmesh.send_recv(x, g, (r - 1) % W, (r + 1) % W)

    want = {"all_reduce": torch.full((n,), W * (W + 1) / 2),
            "broadcast": torch.ones(n),
            "all_gather": torch.cat([torch.full((n,), float(i + 1))
                                     for i in range(W)]),
            "send_recv": torch.full((n,), float((r + 1) % W + 1))}
    res = {}
    for op in ops:
        if op == "send_recv" and W == 1:
            continue
        for mode in modes:
            try:
                y = (native if mode == "native" else staged)(op)
                _sync(mesh.device)
                res[f"{op} {mode}"] = ("ok" if torch.equal(y.cpu(), want[op])
                                       else "wrong values")
            except Exception as e:   # the finding is which ones raise
                res[f"{op} {mode}"] = (f"{type(e).__name__}: "
                                       f"{str(e).splitlines()[0]}")
    return res


def all_reduce_job(mesh, shape, reps: int = 5) -> Dict:
    """Milliseconds of one all-reduce of an f32 tensor of ``shape`` over
    the model axis (out_fc's: its (B*T, vocab) partial logits), the mean
    of ``reps`` after one warm-up, synchronised on the host clock."""
    g = mesh.group(pmesh.MODEL_AXIS)
    x = torch.ones(shape, device=mesh.device)
    pmesh.all_reduce_(x, g)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        pmesh.all_reduce_(x, g)
    _sync(mesh.device)
    return {"ms": 1e3 * (time.perf_counter() - t0) / reps,
            "bytes": x.numel() * x.element_size()}

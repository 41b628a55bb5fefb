"""The (data, model) mesh for multi-GPU training: data and tensor
parallelism over ``torch.distributed`` (counterpart of
``fira_tpu/parallel/mesh.py``).

The JAX package lays its training out with ``jax.jit`` and
``NamedSharding`` over a 2-axis mesh and lets XLA insert the collectives.
Here every rank is a process with one device, and the collectives are
written out:

- ``data``: each rank holds ``batch_size / n_data`` rows of every batch
  (:func:`feed_shardings`); the loss is normalised over the *global*
  batch (its ``nll_sum`` and token count all-reduced, as the reference
  normalises after DataParallel's gather, run_model.py:104-105), and the
  gradients are summed over the axis after the backward
  (:func:`sync_grads`).
- ``model``: Megatron-style tensor parallelism under the JAX package's
  rules (:data:`_PARAM_RULES`, applied to the port's names through
  ``convert.flax_path``): column-parallel first projections, row-parallel
  second ones, so a pair costs one all-reduce; the embeddings are sharded
  on the feature dim and all-gathered after the lookup. Adam's moments
  follow their parameters. The layers (``model/layers.py``) hold the
  shards; the autograd functions below are their collectives.

Rank ``r`` sits at grid cell ``(r // n_model, r % n_model)``, as the JAX
grid ``devices.reshape(n_data, n_model)``. :func:`make_mesh` describes the
layout; a rank binds it (:meth:`Mesh.bind`) once its process group is up,
which makes one group per axis. ``train.loop.train(..., mesh=...)`` with
more than one rank spawns the ranks itself (:class:`RankPool`: ``spawn``
start, a ``FileStore`` rendezvous in a directory of the run, no network
port, one rank per device); one rank runs in the caller's process.

Collectives run on NCCL between distinct GPUs and on gloo on the CPU. A
gloo group on CUDA tensors stages each collective through host memory
(:func:`all_reduce_`, :func:`all_gather`, :func:`all_to_all`,
:func:`send_recv`), so two ranks
can share one card there (NCCL refuses two ranks of one communicator on a
device).

Dropout is laid out so that a mesh run draws the single-process masks:
every rank seeds the same generator stream (``train/state.init_state``),
draws each mask at the global shape (``layers.dropout``) and keeps its
part: a data rank its rows of the global batch, a model rank its feature
slice of a feature-sharded tensor. So the ranks of a model group draw
identical masks for their replicated tensors and their replicas never
drift apart, and a data rank's masks are its rows of the mask the single
process draws for the whole batch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import re
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
ALL = "all"   # every rank of the mesh (a pool may hold more)

# (regex over the "/"-joined flax path) -> spec in the flax layout, one
# entry per dim (None: whole). First match wins; default replicated. The
# JAX package's rules (fira_tpu/parallel/mesh.py), kept here verbatim.
_PARAM_RULES: Tuple[Tuple[str, tuple], ...] = (
    # embeddings: shard the feature dim (vocab sizes are odd; d is 2^k)
    (r"embedding$", (None, MODEL_AXIS)),
    # column-parallel kernels
    (r"(q_proj|k_proj|v_proj|fc1|src_proj|tgt_proj)/kernel$",
     (None, MODEL_AXIS)),
    (r"(q_proj|k_proj|v_proj|fc1)/bias$", (MODEL_AXIS,)),
    # row-parallel kernels (bias replicated: applied after the all-reduce)
    (r"(out_proj|fc2)/kernel$", (MODEL_AXIS, None)),
    # vocab head: contract over sharded d_model -> all-reduce, output
    # replicated
    (r"out_fc/kernel$", (MODEL_AXIS, None)),
)


def param_spec(name: str, tensor: torch.Tensor) -> tuple:
    """The JAX package's spec of the port parameter ``name`` (a tensor of
    its rank), in the flax layout: () replicated, else one entry a dim."""
    from fira_tpu_torch.convert import flax_path

    path = flax_path(name, tensor)
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path):
            return spec
    return ()


def shard_dim(name: str, tensor: torch.Tensor) -> Optional[int]:
    """The dim of the port's tensor that the model axis splits, or None
    if replicated: a Dense weight is the flax kernel transposed."""
    from fira_tpu_torch.convert import flax_path

    spec = param_spec(name, tensor)
    if MODEL_AXIS not in spec:
        return None
    dim = spec.index(MODEL_AXIS)
    return 1 - dim if flax_path(name, tensor).endswith("/kernel") else dim


@dataclasses.dataclass
class Mesh:
    """A (data, model) grid of ranks, one device each: ``devices[r]`` is
    rank r's. Unbound (as :func:`make_mesh` returns it) it only describes
    the layout; :meth:`bind` in a rank adds that rank's coordinates and
    its process groups (one per axis, plus :data:`ALL` and, with
    ``seq_shards`` > 1, the ring's :data:`SEQ_AXIS` groups of
    ``seq_shards`` consecutive ranks)."""

    n_data: int
    n_model: int
    devices: Tuple[str, ...]
    backend: str
    seq_shards: int = 0
    rank: int = 0
    groups: Optional[Dict[str, Any]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def device(self) -> torch.device:
        return torch.device(self.devices[self.rank])

    @property
    def bound(self) -> bool:
        return self.groups is not None

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError("mesh is not bound to a process group "
                               "(Mesh.bind in a rank)")
        return self.groups[axis]

    def bind(self, rank: int) -> Optional["Mesh"]:
        """This mesh seen from ``rank`` of the default process group:
        every group of the layout is made (each rank of the default group
        must call this, in the same order), and the rank's own are kept.
        None for a rank past the mesh (a pool wider than the job)."""
        groups: Dict[str, Any] = {}
        W, nd, nm = self.world, self.n_data, self.n_model
        layouts = [
            (DATA_AXIS, [[i * nm + j for i in range(nd)] for j in range(nm)]),
            (MODEL_AXIS, [[i * nm + j for j in range(nm)] for i in range(nd)]),
            (ALL, [list(range(W))]),
        ]
        if self.seq_shards > 1:
            s = self.seq_shards
            layouts.append((SEQ_AXIS, [list(range(b * s, (b + 1) * s))
                                       for b in range(W // s)]))
        for axis, blocks in layouts:
            for ranks in blocks:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
        if rank >= W:
            return None
        return dataclasses.replace(self, rank=rank, groups=groups)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible GPU;
    ``n_data`` default: all of them over ``n_model``). NCCL when the
    devices are distinct GPUs, gloo on the CPU (a CPU device may repeat:
    each rank is a process). A list that repeats a GPU runs only on gloo,
    which the caller must name. Raises ValueError otherwise, and when
    there are fewer devices than ranks (the JAX package's words)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        devs.append(str(d))
    if n_data is None:
        if len(devs) % n_model:
            raise ValueError(
                f"{len(devs)} devices not divisible by n_model={n_model}")
        n_data = len(devs) // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: each axis needs at "
                         f"least one rank")
    if len(devs) < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} devices, have {len(devs)}")
    devs = devs[: n_data * n_model]
    kinds = {torch.device(d).type for d in devs}
    if not kinds <= {"cpu", "cuda"} or kinds == {"cpu", "cuda"}:
        raise ValueError(f"mesh devices {devs}: all CPU or all CUDA")
    if kinds == {"cpu"}:
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: use gloo")
        backend = "gloo"
    else:
        repeats = len(set(devs)) < len(devs)
        if repeats and backend != "gloo":
            raise ValueError(
                f"mesh devices {devs} repeat a GPU: NCCL refuses two ranks "
                f"of one communicator on one device; name backend='gloo' "
                f"to share it")
        backend = backend or "nccl"
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r}")
    return Mesh(n_data=n_data, n_model=n_model, devices=tuple(devs),
                backend=backend)


# --- collectives (gloo stages CUDA tensors through host memory) ---

def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank
    order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _via_host(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in
    place."""
    if _via_host(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def send_recv(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to group rank ``dst`` and receive a tensor of its shape
    from group rank ``src``, as one ``batch_isend_irecv``."""
    host = _via_host(t, group)
    out = torch.empty_like(t, device="cpu" if host else t.device)
    send = t.cpu() if host else t.contiguous()
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


def all_to_all(t: torch.Tensor, group, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """Cut ``t`` into ``n`` chunks along ``split_dim``, send chunk j to
    group rank j, and concatenate the chunks received along ``cat_dim``
    in group-rank order (one ``all_to_all_single``)."""
    n = dist.get_world_size(group)
    host = _via_host(t, group)
    src = t.movedim(split_dim, 0).contiguous()
    if host:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat([c.movedim(0, split_dim) for c in out.chunk(n, 0)],
                     cat_dim).to(t.device)


def _chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return t.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated tensor entering
    a sharded computation (a column-parallel layer's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel layer."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward along ``dim``, own slice backward: a sharded
    tensor leaving for replicated work (every rank's gradient is whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    """Own slice forward, all-gather backward: a replicated tensor used
    only through this rank's slice (a row-parallel layer fed a replicated
    input, the copy score's ``w``)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` forward, the reverse all-to-all backward: a
    tensor resharded from one dim to another within a group (the ring's
    rows and sequence blocks)."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return all_to_all(g, ctx.group, cat_dim, split_dim), None, None, None


def copy_to(x, group):
    return _Copy.apply(x, group)


def reduce_from(x, group):
    return _Reduce.apply(x, group)


def gather_from(x, group, dim: int):
    return _Gather.apply(x, group, dim)


def scatter_to(x, group, dim: int):
    return _Scatter.apply(x, group, dim)


def reshard(x, group, split_dim: int, cat_dim: int):
    return _AllToAll.apply(x, group, split_dim, cat_dim)


# --- state: parameters and Adam moments ---

def _model_slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh):
    if dim is None or mesh.n_model == 1:
        return t
    return t.chunk(mesh.n_model, dim)[mesh.model_index].contiguous()


def shard_state(state_dict, mesh: Mesh) -> "OrderedDict[str, torch.Tensor]":
    """This rank's shards of a full model ``state_dict``."""
    return OrderedDict((k, _model_slice(v, shard_dim(k, v), mesh))
                       for k, v in state_dict.items())


def _model_gather(t: torch.Tensor, name: str, full: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    dim = shard_dim(name, full)
    if dim is None or mesh.n_model == 1:
        return t
    return all_gather(t, mesh.group(MODEL_AXIS), dim)


def gather_state(state_dict, mesh: Mesh) -> "OrderedDict[str, torch.Tensor]":
    """The full ``state_dict`` from this rank's shards: a collective over
    the model axis (every rank calls it); the input itself when
    ``n_model`` is 1."""
    if mesh.n_model == 1:
        return state_dict
    return OrderedDict((k, _model_gather(v, k, v, mesh))
                       for k, v in state_dict.items())


def _map_moments(opt_sd: Dict, names: List[str], fn) -> Dict:
    state = {}
    for i, entry in opt_sd["state"].items():
        state[i] = {k: (fn(v, names[int(i)]) if k in ("exp_avg",
                                                      "exp_avg_sq") else v)
                    for k, v in entry.items()}
    return {"state": state, "param_groups": opt_sd["param_groups"]}


def shard_optimizer_state(opt_sd: Dict, names: List[str], mesh: Mesh) -> Dict:
    """This rank's Adam state from a full one: each moment sharded as its
    parameter (``names``: the model's parameter names, in order)."""
    if mesh.n_model == 1:
        return opt_sd
    return _map_moments(opt_sd, names, lambda v, n: _model_slice(
        v, shard_dim(n, v), mesh))


def gather_optimizer_state(opt_sd: Dict, names: List[str],
                           mesh: Mesh) -> Dict:
    """The full Adam state from this rank's: a collective over the model
    axis, as :func:`gather_state`."""
    if mesh.n_model == 1:
        return opt_sd
    return _map_moments(opt_sd, names,
                        lambda v, n: _model_gather(v, n, v, mesh))


def sync_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every gradient over the data axis, as one flat all-reduce."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh.group(DATA_AXIS))
    off = 0
    for g in grads:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()


# --- admission ---

def divisibility_errors(cfg, n_data: int) -> List[str]:
    """Parse-time mesh admission check: every dispatched train batch
    shards its batch axis over the ``data`` mesh axis, so each bucket's
    batch size must divide by ``n_data``. One named message per
    offending bucket, in the JAX package's words."""
    errs: List[str] = []
    if n_data <= 1:
        return errs
    from fira_tpu_torch.data.buckets import bucket_table, geom_tag

    for geom in bucket_table(cfg):
        if cfg.batch_size % n_data:
            errs.append(
                f"bucket {geom_tag(geom)}: batch_size {cfg.batch_size} is "
                f"not divisible by the mesh's data axis (n_data={n_data}); "
                f"every dispatched batch shards rows over that axis")
    return errs


def seq_shards_errors(cfg, n_ranks: int, n_model: int = 1) -> List[str]:
    """``seq_shards`` against the ranks: the JAX model's refusal when it
    does not divide them, and the combination the port does not run."""
    s = cfg.seq_shards
    if s <= 1:
        return []
    if n_ranks % s:
        return [f"seq_shards={s} does not divide the {n_ranks} visible "
                f"devices"]
    if n_model > 1:
        return [f"seq_shards={s} with n_model={n_model}: the port runs "
                f"ring attention on a data-only mesh (ROADMAP A.10)"]
    return []


def layout_errors(cfg, n_data: int, n_model: int) -> List[str]:
    """Everything a (n_data, n_model) mesh refuses for ``cfg``: the JAX
    package's divisibility messages, ``seq_shards``, and the shapes tensor
    parallelism splits (heads, widths; the port's shards are even)."""
    errs = divisibility_errors(cfg, n_data)
    errs += seq_shards_errors(cfg, n_data * n_model, n_model)
    if n_model > 1:
        for knob, value in (("num_head", cfg.num_head),
                            ("embedding_dim", cfg.embedding_dim)):
            if value % n_model:
                errs.append(f"{knob}={value} is not divisible by the mesh's "
                            f"model axis (n_model={n_model})")
    return errs


def feed_shardings(mesh: Optional[Mesh]):
    """Feeder ``sharding=`` callable: a host batch -> this rank's rows.
    A K-stacked group (2-D ``valid``) keeps axis 1's slice, a per-step
    batch axis 0's: rank ``data_index`` takes the ``data_index``-th of
    ``n_data`` equal blocks. Keys starting with "_" (host-only) pass
    whole. ``mesh=None`` returns None (every row)."""
    if mesh is None:
        return None
    n, i = mesh.n_data, mesh.data_index

    def rows(batch):
        axis = 1 if batch["valid"].ndim == 2 else 0
        out = {}
        for k, v in batch.items():
            if k.startswith("_"):
                out[k] = v
                continue
            per = v.shape[axis] // n
            out[k] = v[:, i * per:(i + 1) * per] if axis else \
                v[i * per:(i + 1) * per]
        return out

    return rows


# --- ranks ---

def _rank_main(rank: int, mesh: Mesh, store_path: str, timeout_s: float,
               inbox, outbox) -> None:
    """A spawned rank: join the process group, then run jobs until None."""
    dev = torch.device(mesh.devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        # full f32 products, as the CLI's device (cli.resolve_device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:   # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world))
    kw = {}
    if mesh.backend == "nccl":
        kw["device_id"] = dev
    try:
        dist.init_process_group(
            mesh.backend, store=dist.FileStore(store_path, mesh.world),
            rank=rank, world_size=mesh.world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    except BaseException:
        outbox.put((rank, "error", traceback.format_exc()))
        return
    outbox.put((rank, "ok", None))
    # every rank runs the same jobs in the same order, so each layout's
    # groups are made once, the first time a job asks for it
    layouts: Dict[tuple, Optional[Mesh]] = {}
    while True:
        job = inbox.get()
        if job is None:
            break
        fn, args, kwargs, job_mesh = job
        try:
            key = (job_mesh.n_data, job_mesh.n_model, job_mesh.seq_shards,
                   job_mesh.devices, job_mesh.backend)
            if key not in layouts:
                layouts[key] = job_mesh.bind(rank)
            bound = layouts[key]
            res = fn(bound, *args, **kwargs) if bound is not None else None
            outbox.put((rank, "ok", res))
        except BaseException:
            outbox.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``mesh.world`` spawned rank processes, one a device, joined into
    one process group by a ``FileStore`` under ``store_dir``; they stay up
    across jobs, so a series of layouts pays the processes' start once.

    ``run(fn, *args, mesh=None, **kwargs)`` calls ``fn(bound_mesh, *args,
    **kwargs)`` in
    every rank of ``mesh`` (default: the pool's; a job's mesh may use
    fewer ranks, on the same devices) and returns the results by rank.
    ``fn`` must be importable by name in a spawned rank, which starts
    from the caller's ``sys.path`` (the port's ``parallel/jobs.py``, or a
    JAX-free module beside the tests), its arguments and result picklable
    (CPU tensors). A rank
    that raises fails the job: the pool is torn down and RuntimeError
    carries the rank's traceback."""

    def __init__(self, mesh: Mesh, store_dir: str, timeout_s: float = 900.0):
        import multiprocessing

        self.mesh = dataclasses.replace(mesh, groups=None)
        self.timeout_s = timeout_s
        os.makedirs(store_dir, exist_ok=True)
        store = os.path.join(store_dir, f"mesh_store_{os.getpid()}_{id(self)}")
        if os.path.exists(store):
            os.remove(store)
        ctx = multiprocessing.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(mesh.world)]
        self._procs = [ctx.Process(
            target=_rank_main, args=(r, self.mesh, store, timeout_s,
                                     self._inboxes[r], self._outbox),
            name=f"fira-rank-{r}", daemon=True) for r in range(mesh.world)]
        for p in self._procs:
            p.start()
        self._collect(mesh.world)

    def _collect(self, n: int) -> list:
        import time

        out: List[Any] = [None] * n
        deadline = time.monotonic() + self.timeout_s
        got = 0
        while got < n:
            try:
                rank, status, res = self._outbox.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close(kill=True)
                    raise RuntimeError(
                        f"mesh rank {dead[0].name} died (exit code "
                        f"{dead[0].exitcode})" if dead else
                        f"mesh ranks gave no answer in {self.timeout_s} s")
                continue
            got += 1
            if status == "error":
                self.close(kill=True)
                raise RuntimeError(f"mesh rank {rank} failed:\n{res}")
            if rank < n:
                out[rank] = res
        return out

    def run(self, fn: Callable, *args, mesh: Optional[Mesh] = None,
            **kwargs) -> list:
        job_mesh = dataclasses.replace(mesh or self.mesh, groups=None)
        if job_mesh.world > self.mesh.world or (
                job_mesh.devices != self.mesh.devices[: job_mesh.world]):
            raise ValueError(f"job mesh {job_mesh.n_data}x{job_mesh.n_model}"
                             f" on {job_mesh.devices} does not fit the pool's "
                             f"{self.mesh.devices}")
        for box in self._inboxes:
            box.put((fn, args, kwargs, job_mesh))
        return self._collect(self.mesh.world)[: job_mesh.world]

    def close(self, kill: bool = False) -> None:
        if not self._procs:
            return
        if not kill:
            for box in self._inboxes:
                box.put(None)
            for p in self._procs:
                p.join(timeout=60)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def init_single(mesh: Mesh, store_dir: str) -> Mesh:
    """Join a one-rank process group in this process (the real code path
    with degenerate collectives) and bind ``mesh`` to it; undo with
    ``dist.destroy_process_group()``."""
    if mesh.world != 1:
        raise ValueError(f"init_single: a {mesh.n_data}x{mesh.n_model} "
                         f"mesh has {mesh.world} ranks")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process")
    dev = torch.device(mesh.devices[0])
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if mesh.backend == "nccl":
            kw["device_id"] = dev
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"mesh_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group(mesh.backend, store=dist.FileStore(store, 1),
                            rank=0, world_size=1)
    return mesh.bind(0)

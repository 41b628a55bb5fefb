"""Ring attention: sequence-parallel exact attention over a group of
ranks (counterpart of ``fira_tpu/parallel/ring.py``).

Each rank of a ``seq`` group holds one block of the queries and one
block of the keys and values. The K/V blocks and their key mask rotate
``n - 1`` times around the group (``dist.batch_isend_irecv``: rank j
sends its block to rank j - 1, as the JAX ``ppermute``), and each rank
merges every block into a running flash-style online softmax.
:class:`_RingAttention` is a ``torch.autograd.Function`` (torch.distributed
has no autograd through send/recv) whose backward is a second ring: the
forward's log-sum-exp is saved (as its running max and sum), and dK/dV
travel with their block until they are home.

Numerics as the repo's dense attention: additive ``-1e9`` masking where
the key mask is 0 (``model/layers.py`` Attention), never -inf, so a fully
masked query row gets the dense path's uniform softmax, not NaN. Causal
mode masks keys whose global position is past the query's (both
sequences sharded contiguously).

:func:`ring_attend` is the model's layout (``layers.Attention.attend``
routes cross-attention through it): the ranks hold the rows of a
data-parallel batch, and a ``seq`` group of ``s`` consecutive ranks (the
JAX ring mesh's ``(data = W / s, seq = s)`` layout) reshards them with
one all-to-all each for q, k, v and the mask: every member sends each
other member that member's sequence block of its rows, and so holds the
group's ``s * B`` rows at its own ``T/s`` queries and ``S/s`` keys, no
more elements than its own rows at full length. The ring runs on those
blocks, and the reverse all-to-all brings each rank its own rows back at
full length, so the rest of the model sees whole tensors. Under tensor
parallelism a rank holds its rows at its slice of the heads: each (row,
local heads) tile is a set of independent attention problems, the
members of a ``seq`` group hold tiles of the same shape, and the
all-to-all concatenates them whatever rows and heads each holds (the
ranks of a model group hold disjoint heads of the same rows, so no
element is held twice). :class:`MeshRing` is that ring as the model
holds it.

:class:`DeviceRing` is the decode commands' ring: one process drives a
list of devices, as the JAX package's one process drives its ``(n_dev /
s, s)`` ring mesh under ``shard_map``. The rows are split ``n_dev / s``
ways and the sequence ``s`` ways (JAX's ``P("data", None, "seq",
None)``); within each group of ``s`` devices the K/V blocks and their
mask rotate by device-to-device copies, and each device merges them into
the same online softmax, in the same order, as :func:`ring_attention`.
No process group: plain torch operations, so autograd runs through it
(the decode commands take no gradient). :func:`visible_device_count` is the one
place the visible devices are counted.

Which attention takes the ring is the JAX Attention's rule
(``_ring_applicable``): a 2-D key-padding mask, both lengths divisible by
``s``, and the global rows by the ring's data axis; every other
attention of a ring model is dense, as in JAX. :data:`ROUTES` counts
the two routes.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import torch
import torch.distributed as dist

from fira_tpu_torch.parallel.mesh import (SEQ_AXIS, reshard,
                                          send_recv, seq_shards_errors)

NEG_INF = -1e9

# attention calls of a ring model's cross-attention by route: "ring" or
# "dense" (the JAX rule's fallback), counted where ``Attention.attend``
# decides
ROUTES: Counter = Counter()


def _scores(q, k, kv_mask, bias):
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    return s if bias is None else s + bias


def _causal_bias(q_start: int, Tq: int, k_start: int, Tk: int, device):
    q_pos = q_start + torch.arange(Tq, device=device)
    k_pos = k_start + torch.arange(Tk, device=device)
    allowed = k_pos[None, :] <= q_pos[:, None]
    zero = torch.zeros((), device=device)
    return torch.where(allowed, zero, zero + NEG_INF)[None, None]


def _empty_acc(B, H, Tq, Dh, device):
    """The online softmax's start: running max -1e9 (the masking floor),
    sum 0, output 0 (f32)."""
    return (torch.full((B, H, Tq), NEG_INF, device=device),
            torch.zeros((B, H, Tq), device=device),
            torch.zeros((B, H, Tq, Dh), device=device))


def _merge(acc, qf, kf, vf, mask, bias):
    """One K/V block merged into the running (max, sum, output)."""
    m, l, o = acc
    s = _scores(qf, kf, mask, bias)
    m_blk = s.amax(-1)
    p = torch.exp(s - m_blk[..., None])
    m_new = torch.maximum(m, m_blk)
    alpha, beta = torch.exp(m - m_new), torch.exp(m_blk - m_new)
    return (m_new, l * alpha + p.sum(-1) * beta,
            o * alpha[..., None] + torch.matmul(p, vf) * beta[..., None])


def _pack(*ts):
    return torch.cat([t.reshape(-1).to(torch.float32) for t in ts])


def _unpack(flat, like):
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off: off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def _rotate(group, *ts):
    """Every tensor one step round the ring (rank j's to rank j - 1), as
    one flat buffer."""
    n, j = dist.get_world_size(group), dist.get_rank(group)
    flat = send_recv(_pack(*ts), group, (j - 1) % n, (j + 1) % n)
    return _unpack(flat, ts)


class _RingAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d) masked) v over the blocks of ``group``.
    q: (B, H, Tq, Dh) this rank's queries; k, v: (B, H, Tk, Dh) its K/V
    block; kv_mask: (B, Tk) bool. f32 inside, the output in q's type."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        qf, kf, vf = q.float(), k.float(), v.float()
        B, H, Tq, Dh = q.shape
        Tk = k.shape[2]
        acc = _empty_acc(B, H, Tq, Dh, q.device)
        mask = kv_mask
        for i in range(n):
            if i:
                kf, vf, mask = _rotate(group, kf, vf, mask)
            src = (me + i) % n
            bias = (_causal_bias(me * Tq, Tq, src * Tk, Tk, q.device)
                    if causal else None)
            acc = _merge(acc, qf, kf, vf, mask, bias)
        m, l, o = acc
        out = o / l[..., None]
        # the log-sum-exp as (max, sum): m + log(l) rounds to m at the
        # -1e9 of a fully masked row, where the softmax is uniform
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.group, ctx.causal = group, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = dist.get_world_size(group), dist.get_rank(group)
        qf, kf, vf = q.float(), k.float(), v.float()
        do = dout.float()
        Tq, Tk = q.shape[2], k.shape[2]
        scale = 1.0 / math.sqrt(q.shape[-1])
        delta = (do * out).sum(-1, keepdim=True)          # (B, H, Tq, 1)
        dq = torch.zeros_like(qf)
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        mask = kv_mask
        for i in range(n):
            if i:
                kf, vf, mask, dk, dv = _rotate(group, kf, vf, mask, dk, dv)
            src = (me + i) % n
            bias = (_causal_bias(me * Tq, Tq, src * Tk, Tk, q.device)
                    if causal else None)
            p = (torch.exp(_scores(qf, kf, mask, bias) - m[..., None])
                 / l[..., None])
            dv = dv + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
            ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
            dq = dq + torch.matmul(ds, kf) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf) * scale
        if n > 1:   # the accumulators are one step from home
            dk, dv = _rotate(group, dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, kv_mask, group, *, causal: bool = False):
    """Exact attention with K/V sharded over ``group`` (one rank's part).

    q:       (B, H, Tq_local, Dh)  queries of this rank's block
    k, v:    (B, H, Tk_local, Dh)  this rank's K/V block (rotates)
    kv_mask: (B, Tk_local) bool    key-padding mask (rotates with K/V)
    causal:  mask keys whose global position (group rank x local length
             + offset) is past the query's.

    Returns (B, H, Tq_local, Dh) in q's type, differentiable in q, k, v."""
    return _RingAttention.apply(q, k, v, kv_mask.bool(), group, causal)


def ring_attend(q, k, v, kv_mask, mesh, *, causal: bool = False):
    """:func:`ring_attention` in the model's mesh layout: q (B, H, T, Dh),
    k/v (B, H, S, Dh) and kv_mask (B, S) are this rank's rows at its heads
    (all of them without tensor parallelism); an all-to-all within the
    mesh's ``seq`` group gives each member the group's (row, heads) tiles
    at its T/s and S/s blocks, each tile with its rows' mask, and the
    reverse one brings the output tiles back whole. Returns (B, H, T, Dh)
    for this rank's rows and heads."""
    group = mesh.group(SEQ_AXIS)
    qb, kb, vb = (reshard(x, group, 2, 0) for x in (q, k, v))
    mask = reshard(kv_mask.to(torch.float32), group, 1, 0) > 0.5
    out = ring_attention(qb, kb, vb, mask, group, causal=causal)
    return reshard(out, group, 0, 2)


class MeshRing:
    """The ring of a bound training mesh (``seq_shards`` > 1): the model's
    cross-attention on this rank runs as :func:`ring_attend` over its
    ``seq`` group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.seq_shards = mesh.seq_shards

    def applicable(self, rows: int, q_len: int, kv_len: int) -> bool:
        """JAX's test over its ring mesh ``(data = W / s, seq = s)`` of
        the ``W`` devices: both lengths divide ``s`` and the global rows
        (this rank's times the data axis) divide ``W / s``."""
        m, s = self.mesh, self.seq_shards
        return (q_len % s == 0 and kv_len % s == 0
                and (rows * m.n_data) % (m.world // s) == 0)

    def attend(self, q, k, v, kv_mask):
        return ring_attend(q, k, v, kv_mask, self.mesh)


class DeviceRing:
    """A one-process ring over ``devices`` (``len(devices) / seq_shards``
    groups of ``seq_shards`` consecutive devices; a device may repeat).
    :meth:`attend` splits the rows over the groups and the sequence over
    each group's devices, rotates the K/V blocks round the group by
    device-to-device copies, and returns the output on q's device."""

    def __init__(self, devices: Sequence, seq_shards: int):
        self.devices = [torch.device(d) for d in devices]
        self.seq_shards = seq_shards
        self.n_data = len(self.devices) // seq_shards

    def applicable(self, rows: int, q_len: int, kv_len: int) -> bool:
        """JAX's ``_ring_applicable``: both lengths divide the seq axis
        and the rows divide the data axis."""
        s = self.seq_shards
        return q_len % s == 0 and kv_len % s == 0 and rows % self.n_data == 0

    def attend(self, q, k, v, kv_mask):
        """Exact attention of q (B, H, T, Dh) over k/v (B, H, S, Dh) with
        the key-padding mask (B, S) bool: f32 inside, the output in q's
        type on q's device. Device j of a group starts with its own K/V
        block and merges block j + i at step i, as :func:`ring_attention`'s
        rank j."""
        s, nd = self.seq_shards, self.n_data
        B, H, T, Dh = q.shape
        rb, tq, tk = B // nd, T // s, k.shape[2] // s
        out = []
        for d in range(nd):
            devs = self.devices[d * s:(d + 1) * s]
            rows = slice(d * rb, (d + 1) * rb)

            def blocks(x, n, dim):
                return [x[rows].narrow(dim, j * n, n).to(devs[j])
                        for j in range(s)]

            qs = [x.float() for x in blocks(q, tq, 2)]
            kv = [(kb.float(), vb.float(), mb.bool()) for kb, vb, mb in zip(
                blocks(k, tk, 2), blocks(v, tk, 2), blocks(kv_mask, tk, 1))]
            accs = [_empty_acc(rb, H, tq, Dh, devs[j]) for j in range(s)]
            for i in range(s):
                if i:   # device j receives device j + 1's block
                    kv = [tuple(x.to(devs[j]) for x in kv[(j + 1) % s])
                          for j in range(s)]
                accs = [_merge(accs[j], qs[j], *kv[j], None)
                        for j in range(s)]
            out.append(torch.cat([(o / l[..., None]).to(q.device)
                                  for _m, l, o in accs], 2))
        return torch.cat(out, 0).to(q.dtype)


def visible_device_count(kind: str) -> int:
    """The devices a one-process ring may use: every visible card for
    ``cuda``, one device for ``cpu``."""
    return torch.cuda.device_count() if kind == "cuda" else 1


def make_ring(cfg, mesh=None, devices=None, device=None):
    """The ring of a model under ``cfg.seq_shards`` > 1, or None: a bound
    training ``mesh``'s (:class:`MeshRing`), else a :class:`DeviceRing`
    over ``devices`` (default the visible devices of ``device``'s kind).
    Raises the JAX model's ValueError when ``seq_shards`` does not divide
    the devices (the mesh's ranks)."""
    s = cfg.seq_shards
    if s <= 1:
        return None
    if mesh is None and devices is None:
        kind = torch.device(device if device is not None else "cpu").type
        n = visible_device_count(kind)
        devices = ([f"cuda:{i}" for i in range(n)] if kind == "cuda"
                   else [kind] * n)
    errs = seq_shards_errors(cfg, mesh.world if mesh else len(devices))
    if errs:
        raise ValueError("; ".join(errs))
    if mesh is None:
        return DeviceRing(devices, s)
    if mesh.seq_shards != s:
        raise ValueError(f"seq_shards={s}: the mesh was bound for "
                         f"seq_shards={mesh.seq_shards}")
    return MeshRing(mesh)


def dense_reference_attention(q, k, v, kv_mask, *, causal: bool = False):
    """Single-device oracle with the masking semantics ring_attention
    must reproduce (tests)."""
    qf, kf = q.float(), k.float()
    s = _scores(qf, kf, kv_mask.bool(), None)
    if causal:
        s = s + _causal_bias(0, q.shape[2], 0, k.shape[2], q.device)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)

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
full length, so the rest of the model sees whole tensors.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from fira_tpu_torch.parallel.mesh import SEQ_AXIS, reshard, send_recv

NEG_INF = -1e9


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
        m = torch.full((B, H, Tq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, Tq), device=q.device)
        o = torch.zeros((B, H, Tq, Dh), device=q.device)
        mask = kv_mask
        for i in range(n):
            if i:
                kf, vf, mask = _rotate(group, kf, vf, mask)
            src = (me + i) % n
            bias = (_causal_bias(me * Tq, Tq, src * Tk, Tk, q.device)
                    if causal else None)
            s = _scores(qf, kf, mask, bias)
            m_blk = s.amax(-1)
            p = torch.exp(s - m_blk[..., None])
            m_new = torch.maximum(m, m_blk)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_blk - m_new)
            l = l * alpha + p.sum(-1) * beta
            o = o * alpha[..., None] + torch.matmul(p, vf) * beta[..., None]
            m = m_new
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
    """:func:`ring_attention` in the model's data-parallel layout: q
    (B, H, T, Dh), k/v (B, H, S, Dh) and kv_mask (B, S) are this rank's
    rows; an all-to-all within the mesh's ``seq`` group gives each member
    the group's rows at its T/s and S/s blocks, and the reverse one
    brings the output rows back whole. Returns (B, H, T, Dh) for this
    rank's rows."""
    group = mesh.group(SEQ_AXIS)
    qb, kb, vb = (reshard(x, group, 2, 0) for x in (q, k, v))
    mask = reshard(kv_mask.to(torch.float32), group, 1, 0) > 0.5
    out = ring_attention(qb, kb, vb, mask, group, causal=causal)
    return reshard(out, group, 0, 2)


def ring_applicable(mesh, q_len: int, kv_len: int) -> bool:
    """The JAX Attention's test (``_ring_applicable``): both lengths
    divide the seq axis. Its third condition, the global batch dividing
    the ring's data axis (``W / s``), always holds here: each of the
    ``W`` ranks holds the same number of rows. The caller checks that the
    mask is a 2-D key-padding mask and the attention is not causal."""
    return q_len % mesh.seq_shards == 0 and kv_len % mesh.seq_shards == 0


def dense_reference_attention(q, k, v, kv_mask, *, causal: bool = False):
    """Single-device oracle with the masking semantics ring_attention
    must reproduce (tests)."""
    qf, kf = q.float(), k.float()
    s = _scores(qf, kf, kv_mask.bool(), None)
    if causal:
        s = s + _causal_bias(0, q.shape[2], 0, k.shape[2], q.device)
    w = torch.softmax(s, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)

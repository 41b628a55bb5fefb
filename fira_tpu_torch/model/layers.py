"""Building-block modules of the FIRA graph encoder / decoder (counterpart
of ``fira_tpu/model/layers.py``).

Post-LN residuals, additive -1e9 masking, interleaved sin/cos positions and
the closed-form two-channel combination gate, as in the reference
(gnn_transformer.py, combination_layer.py). Submodule names follow the JAX
package's parameter tree (q_proj/k_proj/v_proj/out_proj/norm, fc1/fc2), so
``convert`` maps weights by name.

Dropout sits at the JAX package's five sites (inside the combination gate
and after its output projection, after the GCN's fc2, after attention's
output projection, after the FFN's fc2). It is active only in a module's
``training`` mode at a rate above 0, and then draws its masks from the
``torch.Generator`` the caller passes down; in ``eval()`` mode, or at rate
0, every module is deterministic. The rates default to 0 here; the model
passes the config's (0.1, and 0.2 for the GCN, as the JAX package).

Parameters are created on ``device`` and left uninitialised; the model's
``init_parameters`` fills them from an explicit ``torch.Generator``.

Under a (data, model) mesh (``parallel/mesh.py``) with ``n_model`` > 1 the
layers hold tensor-parallel shards under the JAX package's rules:
q/k/v_proj and fc1 are column-parallel (their output features and biases
split over the model axis, so attention keeps ``num_heads / n_model``
heads a rank), out_proj and fc2 row-parallel (the contraction split, one
all-reduce, the bias added once after it), the embeddings split on the
feature dim and all-gathered after the lookup. Every dropout mask is
drawn at the global shape and cut to the rank's part (:func:`dropout`).

Precision follows the JAX layers' contract, with the casts written out (not
``torch.autocast``, whose op lists are not flax's): parameters stay f32;
each ``dense`` casts its input, weight and bias to the module's compute
``dtype``; LayerNorm, the attention softmax and the combination gate's
sigmoid run in ``stable_dtype`` (f32 for bf16 compute); a post-LN output
stays in the stable dtype unless ``residual_dtype`` (the
``stable_residual=False`` knob) narrows it (``PostLN``). Mixed operands promote as
JAX's do: bf16 with f32 gives f32. In f32 every cast is a no-op.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

NEG_INF = -1e9   # the reference's additive mask fill (never -inf: a fully
                 # masked row stays uniform instead of turning NaN)


def stable_dtype(dtype: torch.dtype) -> torch.dtype:
    """Numerics-sensitive ops (LayerNorm, softmax, log) run in at least
    f32: bf16 compute promotes to f32 (``fira_tpu/model/layers.py``'s
    ``stable_dtype``)."""
    return torch.promote_types(dtype, torch.float32)


def matmul(a, b):
    """``a @ b`` with JAX's promotion of mixed operands (bf16 with f32
    gives f32; torch's matmul refuses mixed types)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


class Dense(nn.Linear):
    """Counterpart of the JAX package's ``TorchDense``: f32 parameters
    (weight (out, in)); the input, weight and bias are cast to
    ``compute_dtype``, multiplied, and the bias added in that dtype.

    Below ``NARROW`` outputs (the copy head's 2-way gate) the product is
    an elementwise multiply and a sum over the input features, in the
    stable dtype: MKL's sgemm at so few columns gives a row a result that
    depends on the row's place among the others, and the slot engine's
    per-sample bitwise contract needs every row independent of its
    neighbours. For the same reason a CPU product of fewer than
    ``CPU_MIN_ROWS`` rows is padded with zero rows to that many: below a
    row count that grows with the input width (6 rows at 128 inputs, 16
    at 1024) MKL takes a path whose rounding differs, so a one-slot
    engine step would not match the batched beam's bits."""

    NARROW = 4
    CPU_MIN_ROWS = 16

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype
        # tensor parallelism (``dense``): "column" or "row", the model
        # axis' group, and for a row-parallel layer fed a replicated input
        # whether to cut its feature slice first
        self.parallel = self.tp_group = None
        self.scatter_input = False

    def forward(self, x):
        if self.parallel is None:
            return self._local(x, self.bias)
        from fira_tpu_torch.parallel import mesh as pmesh

        if self.parallel == "column":
            return self._local(pmesh.copy_to(x, self.tp_group), self.bias)
        if self.scatter_input:
            x = pmesh.scatter_to(x, self.tp_group, -1)
        y = pmesh.reduce_from(self._local(x, None), self.tp_group)
        return y if self.bias is None else y + self.bias.to(
            self.compute_dtype)

    def _local(self, x, bias):
        dt = self.compute_dtype
        b = None if bias is None else bias.to(dt)
        x, w = x.to(dt), self.weight.to(dt)
        if self.out_features < self.NARROW:
            sd = stable_dtype(dt)
            y = (x.to(sd)[..., None, :] * w.to(sd)).sum(-1).to(dt)
            return y if b is None else y + b
        rows = x.numel() // max(1, x.shape[-1])
        if x.device.type == "cpu" and 0 < rows < self.CPU_MIN_ROWS:
            flat = x.reshape(rows, -1)
            pad = flat.new_zeros((self.CPU_MIN_ROWS - rows, flat.shape[1]))
            y = F.linear(torch.cat([flat, pad]), w, b)[:rows]
            return y.reshape(*x.shape[:-1], -1)
        return F.linear(x, w, b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) in the stable dtype of its input; the output
    stays there."""

    def forward(self, x):
        dt = stable_dtype(x.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


class PostLN(nn.Module):
    """Base of the post-LN blocks: ``post_ln(x, residual)`` is
    LayerNorm(x + residual) in the stable dtype. The sum is taken in the
    stable dtype, so two bf16 operands are not rounded to bf16 first (XLA
    fuses the sum into the f32 LayerNorm). The output stays in the stable
    dtype unless ``residual_dtype`` (``stable_residual=False``) narrows
    the stored residual stream."""

    residual_dtype = None

    def post_ln(self, x, residual):
        sd = stable_dtype(x.dtype)
        y = self.norm(x.to(sd) + residual.to(sd))
        return y if self.residual_dtype is None else y.to(self.residual_dtype)


def _tp(mesh):
    """The mesh when it splits the model axis, else None."""
    return mesh if mesh is not None and mesh.n_model > 1 else None


def dense(d_in: int, d_out: int, *, bias: bool = True, device=None,
          dtype: torch.dtype = torch.float32, mesh=None,
          parallel=None, scatter_input: bool = False) -> Dense:
    """A :class:`Dense` computing in ``dtype``, left uninitialised (no draw
    from the global generator); ``init_parameters`` fills it. Under a mesh
    that splits the model axis, ``parallel="column"`` keeps this rank's
    ``d_out / n_model`` outputs and ``"row"`` its ``d_in / n_model``
    inputs (``scatter_input``: the input arrives whole and is cut)."""
    tp = _tp(mesh) if parallel else None
    if tp is not None:
        if parallel == "column":
            d_out //= tp.n_model
        else:
            d_in //= tp.n_model
    m = skip_init(Dense, d_in, d_out, bias=bias, device=device or "cpu",
                  compute_dtype=dtype)
    if tp is not None:
        from fira_tpu_torch.parallel.mesh import MODEL_AXIS

        m.parallel, m.tp_group = parallel, tp.group(MODEL_AXIS)
        m.scatter_input = scatter_input
    return m


def layer_norm(d: int, device=None) -> LayerNorm:
    return skip_init(LayerNorm, d, eps=1e-5, device=device or "cpu")


def embedding(n: int, d: int, device=None, mesh=None) -> nn.Embedding:
    """An embedding table, left uninitialised. Under a mesh that splits
    the model axis it holds this rank's ``d / n_model`` features, and
    ``tp_group`` names the group its lookups are gathered over."""
    tp = _tp(mesh)
    table = skip_init(nn.Embedding, n, d // (tp.n_model if tp else 1),
                      device=device or "cpu")
    if tp is not None:
        from fira_tpu_torch.parallel.mesh import MODEL_AXIS

        table.tp_group = tp.group(MODEL_AXIS)
    return table


def position_encoding(length: int, dmodel: int) -> np.ndarray:
    """Interleaved sin/cos positions (gnn_transformer.py:10-19): for each
    frequency j the pair (sin, cos) is laid out adjacently — NOT the usual
    all-sin-then-all-cos layout."""
    pos = np.zeros((length, dmodel), dtype=np.float32)
    i = np.arange(length)[:, None].astype(np.float64)
    j = np.arange(dmodel // 2)[None, :].astype(np.float64)
    angle = i / np.power(10000.0, 2.0 * j / dmodel)
    pos[:, 0::2] = np.sin(angle)
    pos[:, 1::2] = np.cos(angle)
    return pos


def dropout(x, p: float, generator, *, training: bool = True, mesh=None,
            cols: bool = False):
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1-p and scale it by 1/(1-p). The mask comes from
    ``torch.rand`` on ``generator`` (``F.dropout`` takes none). The
    identity when not ``training`` or at p=0.

    Under a ``mesh`` ``x`` holds this rank's rows of the global batch
    (dim 0) and, with ``cols``, its model-axis slice of the features (the
    last dim): the mask is drawn at the global shape and cut to that part,
    so the ranks draw the single-process mask between them."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    if mesh is None:
        r = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        shape = list(x.shape)
        shape[0] *= mesh.n_data
        if cols:
            shape[-1] *= mesh.n_model
        r = torch.rand(shape, generator=generator, device=x.device).narrow(
            0, mesh.data_index * x.shape[0], x.shape[0])
        if cols:
            r = r.narrow(-1, mesh.model_index * x.shape[-1], x.shape[-1])
    keep = r >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def combination_gate(query, key, value, *, scale: float):
    """combination_layer.py:6-17: per element, softmax over the pair
    (q*k*scale, q*v*scale) weights k and v. The two-way softmax is written
    in closed form: softmax([a, b]) = (sigmoid(a-b), sigmoid(b-a)).

    Products, difference and sigmoids run in the stable dtype, and so does
    the output: the JAX package's numpy-float64 ``scale`` promotes bf16 to
    f32 there, and XLA fuses the bf16 products into that f32 work."""
    sd = stable_dtype(query.dtype)
    q, k, v = query.to(sd), key.to(sd), value.to(sd)
    diff = q * k * scale - q * v * scale
    return torch.sigmoid(diff) * k + torch.sigmoid(-diff) * v


class Combination(PostLN):
    """Multi-head combination (gnn_transformer.py:176-205): three input
    projections, the gate with scale 1/sqrt(d_head) in the merged
    (B, S, d_model) layout (the gate is elementwise, so the head split is a
    layout no-op), output projection, post-LN residual on the query.
    Dropout inside the gate and after the output projection."""

    def __init__(self, num_heads: int, d_model: int,
                 dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None,
                 mesh=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        self.dropout_rate = dropout_rate
        self.residual_dtype = residual_dtype
        self.mesh = mesh
        self.scale = 1.0 / math.sqrt(d_model // num_heads)
        kw = dict(device=device, dtype=dtype, mesh=mesh)
        self.q_proj = dense(d_model, d_model, parallel="column", **kw)
        self.k_proj = dense(d_model, d_model, parallel="column", **kw)
        self.v_proj = dense(d_model, d_model, parallel="column", **kw)
        self.out_proj = dense(d_model, d_model, parallel="row", **kw)
        self.norm = layer_norm(d_model, device)

    def forward(self, query, key, value, generator=None):
        p, on, mesh = self.dropout_rate, self.training, self.mesh
        x = combination_gate(self.q_proj(query), self.k_proj(key),
                             self.v_proj(value), scale=self.scale)
        x = dropout(x, p, generator, training=on, mesh=mesh,
                    cols=_tp(mesh) is not None)
        out = dropout(self.out_proj(x), p, generator, training=on, mesh=mesh)
        return self.post_ln(out, query)


class GCN(PostLN):
    """One graph-convolution round (gnn_transformer.py:64-86):
    fc1 -> A.x -> fc2 -> dropout -> residual -> LayerNorm. ``adj`` takes
    the JAX GCN's three forms:

    - a dense (B, N, N) normalized adjacency, cast to the compute dtype
      (one bmm);
    - a callable applying A.x from the COO triplets (``model.coo_matvec``,
      ``adjacency_impl="segment"``);
    - with ``graph_em`` a (top, rest) pair (``encoder_buffer="split"``),
      the pair of column slabs (A[:, :, :s], A[:, :, s:]): A.x is the sum
      of two slab bmms, fc1/fc2/norm are shared, and dropout is ONE call
      over the full (B, N, d) width, so its random stream is the single
      buffer's."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None,
                 mesh=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.mesh = mesh
        kw = dict(device=device, dtype=dtype, mesh=mesh)
        self.fc1 = dense(d_model, d_model, parallel="column", **kw)
        self.fc2 = dense(d_model, d_model, parallel="row", **kw)
        self.norm = layer_norm(d_model, device)

    def forward(self, graph_em, adj, generator=None):
        if isinstance(graph_em, tuple):
            top, rest = graph_em
            adj_top, adj_rest = adj
            x = (torch.bmm(adj_top.to(self.dtype), self.fc1(top))
                 + torch.bmm(adj_rest.to(self.dtype), self.fc1(rest)))
            x = dropout(self.fc2(x), self.dropout_rate, generator,
                        training=self.training, mesh=self.mesh)
            s = top.shape[1]
            return self.post_ln(x[:, :s], top), self.post_ln(x[:, s:], rest)
        x = self.fc1(graph_em)
        x = adj(x) if callable(adj) else torch.bmm(adj.to(self.dtype), x)
        x = dropout(self.fc2(x), self.dropout_rate, generator,
                    training=self.training, mesh=self.mesh)
        return self.post_ln(x, graph_em)


class Attention(PostLN):
    """Post-LN multi-head attention (gnn_transformer.py:124-161): additive
    -1e9 masking where mask==0, softmax, output projection, dropout,
    residual on the original query, LayerNorm. ``project_kv`` and
    ``attend`` are separate so the cached decode projects each new position
    once and attends over the cache."""

    def __init__(self, num_heads: int, d_model: int,
                 dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None,
                 mesh=None, ring=None):
        super().__init__()
        n = _tp(mesh).n_model if _tp(mesh) else 1
        if num_heads % n:
            raise ValueError(f"num_heads={num_heads} not divisible by the "
                             f"mesh's model axis (n_model={n})")
        # this rank's heads and their width (all of them without a mesh)
        self.num_heads = num_heads // n
        self.d_model = d_model // n
        self.dropout_rate = dropout_rate
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.mesh = mesh
        # a mesh bound with seq_shards > 1: ring attention (``attend``)
        self.ring = ring
        kw = dict(device=device, dtype=dtype, mesh=mesh)
        self.q_proj = dense(d_model, d_model, parallel="column", **kw)
        self.k_proj = dense(d_model, d_model, parallel="column", **kw)
        self.v_proj = dense(d_model, d_model, parallel="column", **kw)
        self.out_proj = dense(d_model, d_model, parallel="row", **kw)
        self.norm = layer_norm(d_model, device)

    def _split_heads(self, x):
        B, length = x.shape[0], x.shape[1]
        d_head = self.d_model // self.num_heads
        return x.reshape(B, length, self.num_heads, d_head).transpose(1, 2)

    def project_kv(self, key, value):
        """(B, L, D) inputs -> head-split (B, H, L, d_head) K and V."""
        return (self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))

    def attend(self, query, k, v, mask, *, causal: bool = False,
               generator=None):
        """Attention over pre-projected K/V. ``mask``: (B, kv_len) key
        padding or a (B, 1, q_len|1, kv_len) mask, nonzero = attend.
        ``causal`` adds the lower-triangular mask (q_len must equal kv_len:
        offset decode goes through the cache path). K and V may be in the
        stable dtype (the decode caches); the logits, the mask fill and the
        softmax run in the stable dtype, as the JAX package's numpy-float64
        ``1/sqrt(d_head)`` promotes them there. The logits' product runs
        there too, from bf16 operands, unrounded: XLA keeps a bf16 product
        that is promoted right after in f32 (its default excess
        precision), and rounding it would make the cached decode (K in a
        cache of the stable dtype) and the full prefix (K in bf16) see
        different logits.

        With a ring mesh (cross-attention under ``seq_shards`` > 1) a
        non-causal attention over a 2-D key-padding mask whose lengths
        divide the seq axis runs as ring attention
        (``parallel/ring.ring_attend``), as the JAX Attention's
        ``_ring_applicable`` routes it: the same -1e9 semantics, in the
        stable dtype."""
        B, q_len = query.shape[0], query.shape[1]
        d_head = self.d_model // self.num_heads
        q = self._split_heads(self.q_proj(query))
        sd = stable_dtype(q.dtype)
        if not causal and self._ring_applicable(q, k, mask):
            from fira_tpu_torch.parallel.ring import ring_attend

            out = ring_attend(q.to(sd), k.to(sd), v.to(sd), mask != 0,
                              self.ring).to(self.dtype)
        else:
            weight = matmul(q.to(sd), k.to(sd).transpose(-1, -2)) / math.sqrt(
                d_head)
            if mask.dim() < 4:
                mask = mask[:, None, None, :]
            weight = weight.masked_fill(mask == 0, NEG_INF)
            if causal:
                if q_len != k.shape[2]:
                    raise ValueError(
                        f"causal=True requires q_len == kv_len (got {q_len} "
                        f"vs {k.shape[2]}); offset decode must use the "
                        f"cache path")
                tri = torch.ones(q_len, q_len, dtype=torch.bool,
                                 device=query.device).tril()
                weight = weight.masked_fill(~tri, NEG_INF)
            out = matmul(torch.softmax(weight, dim=-1).to(self.dtype), v)
        out = out.transpose(1, 2).reshape(B, q_len, self.d_model)
        out = dropout(self.out_proj(out), self.dropout_rate, generator,
                      training=self.training, mesh=self.mesh)
        return self.post_ln(out, query)

    def _ring_applicable(self, q, k, mask) -> bool:
        if self.ring is None or mask.dim() != 2:
            # the ring carries key-padding semantics only
            return False
        from fira_tpu_torch.parallel.ring import ring_applicable

        return ring_applicable(self.ring, q.shape[2], k.shape[2])

    def forward(self, query, key, value, mask, *, causal: bool = False,
                generator=None):
        k, v = self.project_kv(key, value)
        return self.attend(query, k, v, mask, causal=causal,
                           generator=generator)


class FeedForward(PostLN):
    """Post-LN 4x ReLU FFN (gnn_transformer.py:163-174), dropout after
    fc2."""

    def __init__(self, d_model: int, mult: int = 4,
                 dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None,
                 mesh=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.residual_dtype = residual_dtype
        self.mesh = mesh
        kw = dict(device=device, dtype=dtype, mesh=mesh)
        self.fc1 = dense(d_model, mult * d_model, parallel="column", **kw)
        self.fc2 = dense(mult * d_model, d_model, parallel="row", **kw)
        self.norm = layer_norm(d_model, device)

    def forward(self, x, generator=None):
        h = dropout(self.fc2(torch.relu(self.fc1(x))), self.dropout_rate,
                    generator, training=self.training, mesh=self.mesh)
        return self.post_ln(h, x)


def gather_block_kv(pool_l, block_tab):
    """One layer's per-row K (or V) cache view out of a paged block pool
    (the slot engine's arena, decode/engine.py).

    pool_l: one layer's pool, (P + 1, K, H, BS, d_head): P blocks of BS
    positions for all K beams of the slot that holds them, and the
    scratch block P. block_tab: (S, W) int64; slot s's positions
    [w*BS, (w+1)*BS) live in block ``block_tab[s, w]``, and the sentinel
    id P marks an unmapped entry, which reads the scratch block. The JAX
    package's gather clamps such an id to block P - 1 instead; either way
    the position lies past the row's own and the validity mask's -1e9
    gives it a weight of exactly 0 (``beam.step_valid_mask``).

    Returns (S*K, H, W*BS, d_head) in the stable dtype: (slot, beam) rows
    in the layout ``Attention.attend`` reads, equal at every written
    position to the whole-sequence cache it replaces."""
    _P1, K, H, BS, d_head = pool_l.shape
    S, W = block_tab.shape
    blocks = pool_l[block_tab]                      # (S, W, K, H, BS, dh)
    blocks = blocks.permute(0, 2, 3, 1, 4, 5)       # (S, K, H, W, BS, dh)
    return blocks.reshape(S * K, H, W * BS, d_head).to(
        stable_dtype(pool_l.dtype))


def gather_block_kv_beam(pool_l, block_tab, beam: int):
    """One beam lane's dense cache view out of the paged pool: the (S, H,
    W*BS, d_head) lane ``beam`` of :func:`gather_block_kv`, gathered
    without the other K - 1 lanes. The speculative ``draft`` tier
    (decode/spec.py) copies each slot's top-beam lane into a scratch cache
    once a draft dispatch and rolls on that; the pool is never written by
    a drafter. Read in the stable dtype, as :func:`gather_block_kv`."""
    _P1, _K, H, BS, d_head = pool_l.shape
    S, W = block_tab.shape
    blocks = pool_l[:, beam][block_tab]             # (S, W, H, BS, dh)
    blocks = blocks.permute(0, 2, 1, 3, 4)          # (S, H, W, BS, dh)
    return blocks.reshape(S, H, W * BS, d_head).to(
        stable_dtype(pool_l.dtype))


def append_block_kv(pool, layer: int, blk, krow, off, new) -> None:
    """Write one decode position into the paged pool, in place: row r's K
    (or V) lands at ``pool[layer, blk[r], krow[r], :, off[r], :]``.
    pool: (L, P + 1, K, H, BS, d_head); blk/krow/off: (B,) int64 block
    id, beam lane and offset in the block; new: (B, H, d_head), cast to
    the pool's type. A sentinel block id P (an idle or settled slot the
    engine masked out) writes the scratch block, where the JAX package's
    ``mode="drop"`` writes nothing: no real block, which harvest may have
    granted to another slot, is touched either way."""
    pool[layer, blk, krow, :, off, :] = new.to(pool.dtype)


@torch.no_grad()
def init_parameters(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` from ``gen``, in module order,
    with PyTorch's defaults: Linear weight and bias U(+-1/sqrt(fan_in)),
    Embedding N(0, 1), LayerNorm ones/zeros. Drawn on the CPU, so a seed
    gives the same weights on every device."""
    def draw(t, fn):
        t.copy_(fn(torch.empty(t.shape)))

    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                if p is not None:
                    draw(p, lambda x: x.uniform_(-bound, bound, generator=gen))
        elif isinstance(m, nn.Embedding):
            draw(m.weight, lambda x: x.normal_(generator=gen))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module

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
    ``compute_dtype``, multiplied, and the bias added in that dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


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


def dense(d_in: int, d_out: int, *, bias: bool = True, device=None,
          dtype: torch.dtype = torch.float32) -> Dense:
    """A :class:`Dense` computing in ``dtype``, left uninitialised (no draw
    from the global generator); ``init_parameters`` fills it."""
    return skip_init(Dense, d_in, d_out, bias=bias, device=device or "cpu",
                     compute_dtype=dtype)


def layer_norm(d: int, device=None) -> LayerNorm:
    return skip_init(LayerNorm, d, eps=1e-5, device=device or "cpu")


def embedding(n: int, d: int, device=None) -> nn.Embedding:
    return skip_init(nn.Embedding, n, d, device=device or "cpu")


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


def dropout(x, p: float, generator, *, training: bool = True):
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1-p and scale it by 1/(1-p). The mask comes from
    ``torch.rand`` on ``generator`` (``F.dropout`` takes none). The
    identity when not ``training`` or at p=0."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
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
                 dtype: torch.dtype = torch.float32, residual_dtype=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by "
                             f"num_heads={num_heads}")
        self.dropout_rate = dropout_rate
        self.residual_dtype = residual_dtype
        self.scale = 1.0 / math.sqrt(d_model // num_heads)
        self.q_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.k_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.v_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.out_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.norm = layer_norm(d_model, device)

    def forward(self, query, key, value, generator=None):
        p, on = self.dropout_rate, self.training
        x = combination_gate(self.q_proj(query), self.k_proj(key),
                             self.v_proj(value), scale=self.scale)
        x = dropout(x, p, generator, training=on)
        out = dropout(self.out_proj(x), p, generator, training=on)
        return self.post_ln(out, query)


class GCN(PostLN):
    """One graph-convolution round (gnn_transformer.py:64-86):
    fc1 -> A.x -> fc2 -> dropout -> residual -> LayerNorm, over a dense
    (B, N, N) normalized adjacency, cast to the compute dtype."""

    def __init__(self, d_model: int, dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.fc1 = dense(d_model, d_model, device=device, dtype=dtype)
        self.fc2 = dense(d_model, d_model, device=device, dtype=dtype)
        self.norm = layer_norm(d_model, device)

    def forward(self, graph_em, adj, generator=None):
        x = torch.bmm(adj.to(self.dtype), self.fc1(graph_em))
        x = dropout(self.fc2(x), self.dropout_rate, generator,
                    training=self.training)
        return self.post_ln(x, graph_em)


class Attention(PostLN):
    """Post-LN multi-head attention (gnn_transformer.py:124-161): additive
    -1e9 masking where mask==0, softmax, output projection, dropout,
    residual on the original query, LayerNorm. ``project_kv`` and
    ``attend`` are separate so the cached decode projects each new position
    once and attends over the cache."""

    def __init__(self, num_heads: int, d_model: int,
                 dropout_rate: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float32, residual_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.d_model = d_model
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.q_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.k_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.v_proj = dense(d_model, d_model, device=device, dtype=dtype)
        self.out_proj = dense(d_model, d_model, device=device, dtype=dtype)
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
        ``1/sqrt(d_head)`` promotes them there."""
        B, q_len = query.shape[0], query.shape[1]
        d_head = self.d_model // self.num_heads
        q = self._split_heads(self.q_proj(query))
        weight = matmul(q, k.transpose(-1, -2))
        weight = weight.to(stable_dtype(weight.dtype)) / math.sqrt(d_head)
        if mask.dim() < 4:
            mask = mask[:, None, None, :]
        weight = weight.masked_fill(mask == 0, NEG_INF)
        if causal:
            if q_len != k.shape[2]:
                raise ValueError(
                    f"causal=True requires q_len == kv_len (got {q_len} vs "
                    f"{k.shape[2]}); offset decode must use the cache path")
            tri = torch.ones(q_len, q_len, dtype=torch.bool,
                             device=query.device).tril()
            weight = weight.masked_fill(~tri, NEG_INF)
        out = matmul(torch.softmax(weight, dim=-1).to(self.dtype), v)
        out = out.transpose(1, 2).reshape(B, q_len, self.d_model)
        out = dropout(self.out_proj(out), self.dropout_rate, generator,
                      training=self.training)
        return self.post_ln(out, query)

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
                 dtype: torch.dtype = torch.float32, residual_dtype=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.residual_dtype = residual_dtype
        self.fc1 = dense(d_model, mult * d_model, device=device, dtype=dtype)
        self.fc2 = dense(mult * d_model, d_model, device=device, dtype=dtype)
        self.norm = layer_norm(d_model, device)

    def forward(self, x, generator=None):
        h = dropout(self.fc2(torch.relu(self.fc1(x))), self.dropout_rate,
                    generator, training=self.training)
        return self.post_ln(h, x)


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

"""Low-precision serving tiers of the slot engine (counterpart of
``fira_tpu/decode/quant.py``).

Two independent knobs; f32 is the default and the contract path (output
bytes, digests and the engine's program labels unchanged when both are
"f32"):

- ``cfg.kv_dtype`` ("f32" | "bf16"): the storage type of the decode
  self-attention K/V arena, the paged pool's blocks and the unpaged
  stripes alike. The prefill's ``cache_seed`` takes :func:`kv_seed_dtype`,
  so the arena and ``kv_bytes_per_slot`` follow it; writes cast on append
  (``layers.append_block_kv`` and the dense cache writes) and reads
  upcast on gather, so the attention math stays in the compute dtype.
  Cross-attention K/V and the copy head's source projection are
  request-lifetime activations, not the per-step arena: they stay f32.

- ``cfg.serve_precision`` ("f32" | "bf16" | "int8w"): the weight tier of
  the decode-only dispatches (step, spec draft and verify); prefill and
  the encoder keep the original weights. The engine builds the tier once
  at construction (:func:`quantize_decode_params`); a fleet respawn or
  spare builds a fresh engine from the original weights, so it
  re-quantizes by construction.

The decode side is a module of its own, not a functional parameter tree:
:func:`quantize_decode_params` returns a copy of the model that shares
every submodule outside :data:`DECODE_WEIGHT_SCOPES` (the encoder, the
typed-edge gains) and holds its own tensors inside them. Under "f32" it is
the model itself (no copy). Under "bf16" the eligible leaves are stored
bf16, and the layers' own ``weight.to(dtype)`` upcast consumes them
(``layers.Dense``, the embeddings, the copy head's score weights). Under
"int8w" they are stored as int8 codes with per-channel f32 scales, and
:func:`decode_call` dequantizes them once at the top of each dispatch
(``torch.func.functional_call`` over the decode module with the f32
reconstructions), so every micro-step or verify frame of the dispatch
reuses one reconstructed set, and the f32 tensors live only for the
dispatch.

Per-channel means per output feature, the JAX package's last axis: a
``Linear`` weight (out, in) is quantized as its (in, out) transpose, the
flax kernel's layout, so codes and scales equal the JAX package's bit for
bit; an embedding table (rows, features) is quantized as it is.

The quality contract is measured, not assumed: within a tier the output
bytes are a function of the input stream only; against f32 the lines
that differ, the BLEU delta and the log-probability divergence are
measured (``chip_smoke.py``'s ``[tiers]`` phase).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

KV_DTYPES = ("f32", "bf16")
SERVE_PRECISIONS = ("f32", "bf16", "int8w")

# the submodules whose weights the tier rewrites: the decode-side matmul
# owners. The encoder (prefill only) and every 1-D parameter (biases,
# LayerNorm) keep the original f32 weights.
DECODE_WEIGHT_SCOPES = ("decoder", "out_fc", "copy_net")


def quant_errors(cfg, *, train: bool = False) -> List[str]:
    """Parse-time validation of the serving-tier knobs, in the JAX
    package's words. ``train=True`` is the training path, where any
    non-f32 tier is refused: quantized serving reads frozen weights."""
    errs: List[str] = []
    if cfg.kv_dtype not in KV_DTYPES:
        errs.append(f"kv_dtype {cfg.kv_dtype!r} not in "
                    f"{{{', '.join(map(repr, KV_DTYPES))}}}")
    if cfg.serve_precision not in SERVE_PRECISIONS:
        errs.append(f"serve_precision {cfg.serve_precision!r} not in "
                    f"{{{', '.join(map(repr, SERVE_PRECISIONS))}}}")
    armed = cfg.kv_dtype != "f32" or cfg.serve_precision != "f32"
    if train and armed:
        errs.append(
            "kv_dtype/serve_precision are serving-tier knobs; the training "
            "path runs full precision — leave both 'f32'")
        return errs
    if cfg.kv_dtype in KV_DTYPES and cfg.kv_dtype != "f32" \
            and not cfg.decode_engine:
        errs.append(
            f"kv_dtype {cfg.kv_dtype!r} requires the slot engine "
            f"(--engine / decode_engine=True): the low-precision KV "
            f"arena is the engine's slot arena")
    if cfg.serve_precision in SERVE_PRECISIONS \
            and cfg.serve_precision != "f32" and not cfg.decode_engine:
        errs.append(
            f"serve_precision {cfg.serve_precision!r} requires the slot "
            f"engine (--engine / decode_engine=True): the weight tier "
            f"quantizes the decode-only program family")
    return errs


def kv_seed_dtype(cfg, compute_dtype: torch.dtype) -> torch.dtype:
    """The type of the prefill's ``cache_seed``, which the engine
    allocates its K/V arena at: "f32" keeps the encoder states' type
    (wider than the compute dtype under ``stable_residual``), "bf16" pins
    the arena half-width whatever the compute dtype."""
    return torch.bfloat16 if cfg.kv_dtype == "bf16" else compute_dtype


def tier_tag(cfg) -> str:
    """The tier's label fragment ("" on the f32/f32 path, so the default
    labels are unchanged): ``engine_step[bf16kv.int8w.r1]``."""
    parts = []
    if cfg.kv_dtype != "f32":
        parts.append(f"{cfg.kv_dtype}kv")
    if cfg.serve_precision != "f32":
        sp = cfg.serve_precision
        parts.append(sp if sp.endswith("w") else sp + "w")
    return ".".join(parts)


def tier_namespace(cfg) -> bytes:
    """The digest namespace of prefix-cache and dedup addressing:
    artifacts carry their tier, so a cached f32 artifact never seats a
    bf16 slot (and back). Empty, digests unchanged, on the f32/f32
    path."""
    tag = tier_tag(cfg)
    return tag.encode("ascii") if tag else b""


# --- per-channel symmetric int8 --------------------------------------------

def quantize_int8(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int8 over the LAST axis (the JAX package's
    numpy code): scale[c] = amax(|w[..., c]|) / 127, a zero column scale
    1.0 (so the divide is exact); values rounded to nearest, then clipped.
    The error of an element is at most scale / 2. ``w``: numpy or a
    tensor (copied to the host)."""
    if torch.is_tensor(w):
        # firacheck: allow[HOST-SYNC] engine-BUILD-time quantization (once per engine/respawn/spare prewarm, before any serving dispatch); never runs inside the step loop
        w = w.detach().cpu().float().numpy()
    # firacheck: allow[HOST-SYNC] same engine-BUILD-time quantization as the line above
    a = np.asarray(w, np.float32)
    reduce_axes = tuple(range(a.ndim - 1))
    scale = np.max(np.abs(a), axis=reduce_axes) / 127.0
    scale = np.where(scale == 0.0, np.float32(1.0), scale).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q, scale):
    """The f32 reconstruction: codes times their channel's scale (numpy
    or tensors; ``scale`` broadcasts against ``q``)."""
    if torch.is_tensor(q):
        return q.to(torch.float32) * scale
    return q.astype(np.float32) * scale


def _eligible(t: torch.Tensor) -> bool:
    """Float parameters of rank >= 2: the matmul weights and embedding
    tables. 1-D ones (biases, LayerNorm) stay f32."""
    return t.is_floating_point() and t.dim() >= 2


def _decode_module(model: nn.Module) -> nn.Module:
    """A copy of ``model`` sharing every submodule and parameter outside
    :data:`DECODE_WEIGHT_SCOPES` (the encoder is not copied)."""
    memo = {id(m): m for name, m in model.named_children()
            if name not in DECODE_WEIGHT_SCOPES}
    memo.update({id(p): p for _n, p in model.named_parameters(recurse=False)})
    memo.update({id(b): b for _n, b in model.named_buffers(recurse=False)})
    return copy.deepcopy(model, memo)


def _scoped_leaves(model: nn.Module):
    """(full name, owning module, leaf name, tensor) of every eligible
    parameter under the scopes."""
    for scope in DECODE_WEIGHT_SCOPES:
        root = getattr(model, scope)
        for mod_name, mod in root.named_modules():
            for leaf, p in list(mod.named_parameters(recurse=False)):
                if _eligible(p):
                    full = ".".join(x for x in (scope, mod_name, leaf) if x)
                    yield full, mod, leaf, p


def quantize_decode_params(model: nn.Module, cfg
                           ) -> Tuple[nn.Module, Optional[Dict]]:
    """The decode-side module for ``cfg.serve_precision`` and its scales:

    - "f32": ``(model, None)``, the model itself (no copy: the f32
      contract rides on identity);
    - "bf16": a decode module whose eligible scoped leaves are stored
      bf16; scales None;
    - "int8w": a decode module whose eligible scoped leaves are int8
      codes; ``scales`` maps each one's full name to its per-channel f32
      scale on the model's device (shaped to broadcast against the
      codes).

    Built once an engine, from the weights ``model`` holds."""
    sp = cfg.serve_precision
    if sp == "f32":
        return model, None
    dm = _decode_module(model)
    scales: Optional[Dict[str, torch.Tensor]] = {} if sp == "int8w" else None
    with torch.no_grad():
        for full, mod, leaf, p in _scoped_leaves(dm):
            if sp == "bf16":
                new = p.detach().to(torch.bfloat16)
            else:
                # the flax layout: a Linear's (out, in) weight is the
                # (in, out) kernel transposed
                linear = isinstance(mod, nn.Linear)
                q, s = quantize_int8(p.t() if linear else p)
                if linear:
                    q, s = q.T, s[:, None]
                new = torch.from_numpy(np.ascontiguousarray(q)).to(p.device)
                scales[full] = torch.from_numpy(s).to(p.device)
            mod._parameters[leaf] = nn.Parameter(new, requires_grad=False)
    return dm, scales


def dequant_tree(decode_model: nn.Module, scales: Optional[Dict]
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """The f32 reconstruction of every int8 leaf of ``decode_model``, by
    full name (None when ``scales`` is None: the f32 and bf16 tiers)."""
    if scales is None:
        return None
    params = dict(decode_model.named_parameters())
    return {name: dequantize_int8(params[name], s)
            for name, s in scales.items()}


class _Call(nn.Module):
    """Holds the decode module so ``functional_call`` can stand f32
    tensors in for its int8 leaves around an arbitrary call."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn()


def decode_call(decode_model: nn.Module, scales: Optional[Dict], fn):
    """Run ``fn`` (one dispatch on ``decode_model``) under the weight
    tier: directly for f32 and bf16; for int8w with every int8 leaf
    replaced by its f32 reconstruction, made once here, for the whole
    dispatch."""
    if scales is None:
        return fn()
    deq = dequant_tree(decode_model, scales)
    return torch.func.functional_call(
        _Call(decode_model), {f"model.{k}": v for k, v in deq.items()},
        (fn,))

"""Fused Bahdanau pointer scoring: score[b,t,s] = w . tanh(src[b,s] + tgt[b,t]) + bias.

The copy head's hot op (reference CopyNet, Model.py:7-20). Counterpart of
``fira_tpu/ops/copy_score.py``: :func:`copy_scores` launches the hand-written
Hopper kernel ``csrc/copy_score.cu``, which replaces the TPU kernel
``_copy_scores_fwd_impl`` (its ``pl.pallas_call`` at
fira_tpu/ops/copy_score.py:119). The kernel never writes the (B, T, S, D)
tanh intermediate; at the decode shape it is bound by reading src (the
source's comment gives the numbers and the design).

:func:`copy_scores_reference` is the plain PyTorch version: it materialises
the intermediate and follows the same type rules (tanh and dot in f32, the
result in src's type, the bias added after in src's type). The wrapper
takes it only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises. The backward kernel (the JAX package's ``_bwd_kernel``)
comes with the training path, so a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fira_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_D = (64, 128, 256, 512)


def copy_scores_reference(src, tgt, w, bias):
    """Plain version: materialises the (B, T, S, D) tanh in f32."""
    inter = torch.tanh(src.float()[:, None, :, :] + tgt.float()[:, :, None, :])
    out = (inter @ w.float().reshape(-1, 1))[..., 0]
    return out.to(src.dtype) + bias.reshape(-1)[0].to(src.dtype)


def _check_cuda_inputs(src, tgt, w, bias):
    dev = src.device
    for name, x in (("tgt", tgt), ("w", w), ("bias", bias)):
        if x.device != dev:
            raise ValueError(f"copy_scores: {name} on {x.device}, src on {dev}")
    if src.dtype not in _DTYPE_CODE:
        raise TypeError(f"copy_scores: src dtype {src.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if tgt.dtype != src.dtype:
        raise TypeError(f"copy_scores: tgt dtype {tgt.dtype} != src dtype "
                        f"{src.dtype}")
    if src.dim() != 3 or tgt.dim() != 3:
        raise ValueError(f"copy_scores: src {tuple(src.shape)} and tgt "
                         f"{tuple(tgt.shape)} must be (B,S,D) and (B,T,D)")
    B, S, D = src.shape
    if tgt.shape[0] != B or tgt.shape[2] != D:
        raise ValueError(f"copy_scores: tgt {tuple(tgt.shape)} does not match "
                         f"src {tuple(src.shape)}")
    if D not in _SUPPORTED_D:
        raise ValueError(f"copy_scores: D={D} not in {_SUPPORTED_D}")
    if w.numel() != D or bias.numel() != 1:
        raise ValueError(f"copy_scores: w {tuple(w.shape)} and bias "
                         f"{tuple(bias.shape)} must hold D={D} and 1 values")
    if not (src.is_contiguous() and tgt.is_contiguous()):
        raise ValueError("copy_scores: src and tgt must be contiguous")
    if min(B, S, tgt.shape[1]) == 0 or B > 65535:
        raise ValueError(f"copy_scores: batch {B}, S {S}, T {tgt.shape[1]} "
                         f"outside the kernel's grid")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (src, tgt, w, bias)):
        raise NotImplementedError(
            "copy_scores: no backward kernel on CUDA yet (it comes with the "
            "training path); call under torch.no_grad()/inference_mode()")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use."""
    fn = build.load("copy_score").fira_copy_score_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(src, tgt, w, out) -> None:
    """Launch the kernel on the current stream: out (B,T,S) = the scores
    without bias. Inputs as checked by ``copy_scores``; ``w`` is a
    contiguous f32 (D,). Counts the launch."""
    B, S, D = src.shape
    fn = _kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tgt.data_ptr(), w.data_ptr(), out.data_ptr(),
                 B, tgt.shape[1], S, D, _DTYPE_CODE[src.dtype], stream)
    if err != 0:
        raise RuntimeError(f"copy_score kernel launch failed: CUDA error {err}")
    copy_scores.launches += 1


def copy_scores(src, tgt, w, bias):
    """Fused pointer scores. src: (B,S,D), tgt: (B,T,D), w: (D,1),
    bias: (1,). Returns (B,T,S) in src.dtype."""
    if src.device.type == "cpu":
        return copy_scores_reference(src, tgt, w, bias)
    if src.device.type != "cuda":
        raise ValueError(f"copy_scores: no kernel for device {src.device}")
    _check_cuda_inputs(src, tgt, w, bias)
    out = torch.empty((src.shape[0], tgt.shape[1], src.shape[1]),
                      dtype=src.dtype, device=src.device)
    launch(src, tgt, w.reshape(-1).to(torch.float32).contiguous(), out)
    return out + bias.reshape(-1)[0].to(src.dtype)


copy_scores.launches = 0   # kernel launches; the CPU path never counts

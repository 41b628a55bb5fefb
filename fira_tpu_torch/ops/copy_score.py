"""Fused Bahdanau pointer scoring: score[b,t,s] = w . tanh(src[b,s] + tgt[b,t]) + bias.

The copy head's hot op (reference CopyNet, Model.py:7-20). Counterpart of
``fira_tpu/ops/copy_score.py``: on CUDA tensors :func:`copy_scores` runs a
``torch.autograd.Function`` whose forward launches the hand-written Hopper
kernel ``csrc/copy_score.cu`` (K1, replacing the TPU kernel
``_copy_scores_fwd_impl``, its ``pl.pallas_call`` at
fira_tpu/ops/copy_score.py:119) and whose backward launches
``csrc/copy_score_bwd.cu`` (K2, replacing ``_bwd_kernel``, launched by
``_copy_scores_bwd`` at :148). Neither kernel writes the (B, T, S, D) tanh
intermediate; the backward recomputes it from the saved src, tgt and w, as
the JAX custom VJP does. The bias is added outside the Function, as the JAX
code adds it outside its kernel, so autograd forms dbias = sum(dout).

:func:`copy_scores_reference` is the plain PyTorch version: it materialises
the intermediate and follows the same type rules (tanh and dot in f32, or
in f64 for f64 inputs, the result in src's type, the bias added after in
src's type); its backward is its own autograd. The wrappers take it only
for tensors on the CPU; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from fira_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SUPPORTED_D = (64, 128, 256, 512)


def copy_scores_reference(src, tgt, w, bias):
    """Plain version: materialises the (B, T, S, D) tanh in f32, or in
    src's type where that is wider (f64 inputs give an f64 oracle)."""
    ct = torch.promote_types(src.dtype, torch.float32)
    inter = torch.tanh(src.to(ct)[:, None, :, :] + tgt.to(ct)[:, :, None, :])
    out = (inter @ w.to(ct).reshape(-1, 1))[..., 0]
    return out.to(src.dtype) + bias.reshape(-1)[0].to(src.dtype)


def _check_cuda_inputs(src, tgt, w, bias):
    dev = src.device
    for name, x in (("tgt", tgt), ("w", w), ("bias", bias)):
        if x is not None and x.device != dev:
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
    if w.numel() != D or (bias is not None and bias.numel() != 1):
        raise ValueError(f"copy_scores: w {tuple(w.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} "
                         f"must hold D={D} and 1 values")
    if not (src.is_contiguous() and tgt.is_contiguous()):
        raise ValueError("copy_scores: src and tgt must be contiguous")
    if min(B, S, tgt.shape[1]) == 0 or B > 65535:
        raise ValueError(f"copy_scores: batch {B}, S {S}, T {tgt.shape[1]} "
                         f"outside the kernel's grid")


def copy_scores_backward_reference(src, tgt, w, dout):
    """Plain backward: (dsrc, dtgt, dw) of sum(dout * scores) by autograd
    through :func:`copy_scores_reference` (which materialises the
    intermediate); dw in w's shape."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (src, tgt, w)]
        out = copy_scores_reference(*leaves, torch.zeros(
            1, dtype=w.dtype, device=w.device))
        return torch.autograd.grad(out, leaves, dout)


@functools.lru_cache(maxsize=None)
def _kernel():
    """K1's C entry point, built and loaded at first use."""
    fn = build.load("copy_score").fira_copy_score_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    """K2's C entry points, built and loaded at first use: the launch and
    the number of s-chunks whose partials it writes."""
    lib = build.load("copy_score_bwd")
    fn = lib.fira_copy_score_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chunks = lib.fira_copy_score_bwd_chunks
    chunks.argtypes = [ctypes.c_int]
    chunks.restype = ctypes.c_int
    return fn, chunks


def launch(src, tgt, w, out) -> None:
    """Launch K1 on the current stream: out (B,T,S) = the scores without
    bias. Inputs as checked by ``copy_scores``; ``w`` is a contiguous f32
    (D,). The kernel reads src, tgt and w in 16-byte loads, so they must
    start on 16-byte boundaries (fresh allocations do). Counts the launch."""
    if (src.data_ptr() | tgt.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("copy_scores: src, tgt and w must be 16-byte aligned")
    B, S, D = src.shape
    fn = _kernel()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tgt.data_ptr(), w.data_ptr(), out.data_ptr(),
                 B, tgt.shape[1], S, D, _DTYPE_CODE[src.dtype], stream)
    if err != 0:
        raise RuntimeError(f"copy_score kernel launch failed: CUDA error {err}")
    copy_scores.launches += 1


def launch_backward(src, tgt, w, dout):
    """Launch K2 on the current stream: one pass over the (b, t, s, d)
    elements that writes dsrc and per-(b, s-chunk) partials of dtgt and
    dw, then a fixed-order sum of the dtgt partials into dtgt. Inputs as
    checked by ``copy_scores_backward``; ``w`` is a contiguous f32 (D,).
    Returns dsrc (B,S,D), dtgt (B,T,D) in src's type and the dw partials
    (B, n_chunks, D) f32. Counts one launch for the two kernels."""
    B, S, D = src.shape
    T = tgt.shape[1]
    fn, chunks = _bwd_kernel()
    n_c = chunks(S)
    dsrc, dtgt = torch.empty_like(src), torch.empty_like(tgt)
    dtgt_part = torch.empty((B, n_c, T, D), dtype=torch.float32,
                            device=src.device)
    dw_part = torch.empty((B, n_c, D), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tgt.data_ptr(), w.data_ptr(),
                 dout.data_ptr(), dsrc.data_ptr(), dtgt.data_ptr(),
                 dtgt_part.data_ptr(), dw_part.data_ptr(), B, T, S, D,
                 _DTYPE_CODE[src.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"copy_score backward kernel launch failed: CUDA error {err}")
    copy_scores_backward.launches += 1
    return dsrc, dtgt, dw_part


def copy_scores_backward(src, tgt, w, dout):
    """(dsrc, dtgt, dw) of sum(dout * copy_scores(src, tgt, w, bias)):
    dsrc and dtgt in src's type, dw in w's shape and type. CPU tensors take
    the plain version; CUDA tensors launch K2, and dw is the sum of its
    per-(b, s-chunk) partials."""
    if src.device.type == "cpu":
        return copy_scores_backward_reference(src, tgt, w, dout)
    if src.device.type != "cuda":
        raise ValueError(f"copy_scores: no kernel for device {src.device}")
    _check_cuda_inputs(src, tgt, w, None)
    want = (src.shape[0], tgt.shape[1], src.shape[1])
    if tuple(dout.shape) != want or dout.dtype != src.dtype:
        raise ValueError(f"copy_scores_backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype}, expected {want} {src.dtype}")
    if dout.device != src.device or not dout.is_contiguous():
        raise ValueError("copy_scores_backward: dout must be a contiguous "
                         f"tensor on {src.device}")
    dsrc, dtgt, dw_part = launch_backward(
        src, tgt, w.reshape(-1).to(torch.float32).contiguous(), dout)
    # the partials' sum over (b, s-chunk), as the JAX code sums dw_part
    dw = dw_part.sum(dim=(0, 1)).to(w.dtype).reshape(w.shape)
    return dsrc, dtgt, dw


class _CopyScoreFn(torch.autograd.Function):
    """The scores without bias on CUDA tensors: K1 forward, K2 backward.
    Saves (src, tgt, w), the JAX custom VJP's residuals, not the output."""

    @staticmethod
    def forward(ctx, src, tgt, w):
        out = torch.empty((src.shape[0], tgt.shape[1], src.shape[1]),
                          dtype=src.dtype, device=src.device)
        launch(src, tgt, w.reshape(-1).to(torch.float32).contiguous(), out)
        ctx.save_for_backward(src, tgt, w)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        src, tgt, w = ctx.saved_tensors
        return copy_scores_backward(src, tgt, w, dout.contiguous())


def copy_scores(src, tgt, w, bias):
    """Fused pointer scores. src: (B,S,D), tgt: (B,T,D), w: (D,1),
    bias: (1,). Returns (B,T,S) in src.dtype, differentiable in all four."""
    if src.device.type == "cpu":
        return copy_scores_reference(src, tgt, w, bias)
    if src.device.type != "cuda":
        raise ValueError(f"copy_scores: no kernel for device {src.device}")
    _check_cuda_inputs(src, tgt, w, bias)
    return _CopyScoreFn.apply(src, tgt, w) + bias.reshape(-1)[0].to(src.dtype)


copy_scores.launches = 0            # K1 launches; the CPU path never counts
copy_scores_backward.launches = 0   # K2 launches; the CPU path never counts

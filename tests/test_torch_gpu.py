"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the wrappers' refusals. Tests that need the card carry the
``gpu`` marker and skip without one; run them on a machine with an NVIDIA
H100 with ``python -m pytest tests/test_torch_gpu.py -m gpu``. This file
imports no JAX, so it also runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from fira_tpu_torch.ops import copy_score as cs


@pytest.fixture
def cuda():
    """The card, with TF32 off so f32 products are full f32; skips the
    test on a host without one (decided here, never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, S, D, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.standard_normal((B, S, D), np.float32))
    tgt = torch.from_numpy(rng.standard_normal((B, T, D), np.float32))
    w = torch.from_numpy(rng.standard_normal((D, 1), np.float32) * 0.1)
    b = torch.from_numpy(rng.standard_normal((1,), np.float32))
    return (src.to(device, dtype), tgt.to(device, dtype), w.to(device),
            b.to(device))


# decode (B=20x3 beams, T=1), unaligned S and T, every supported width;
# the dev batch (20) and the training batch (170) at the training T and S;
# a batch of 85, where the tile kernel takes 64 s a block and 2 slices of
# d (20 takes 32 and 4, 170 takes 128 and 1); T above one tile of 32
SHAPES = [(60, 1, 370, 256), (2, 13, 37, 64), (2, 7, 130, 128),
          (3, 30, 370, 256), (2, 17, 33, 512), (1, 40, 5, 256),
          (20, 30, 370, 256), (170, 30, 370, 256), (85, 30, 370, 256),
          (2, 70, 37, 256), (2, 33, 130, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_copy_scores_kernel_matches_plain_f32(cuda, shape):
    """f32 at rtol/atol 1e-5: the kernel sums D in another order than the
    plain version's matmul."""
    src, tgt, w, b = _inputs(*shape, device=cuda)
    before = cs.copy_scores.launches
    got = cs.copy_scores(src, tgt, w, b)
    torch.cuda.synchronize()
    assert cs.copy_scores.launches == before + 1
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.shape == want.shape == (shape[0], shape[1], shape[2])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_copy_scores_kernel_matches_plain_bf16(cuda):
    """bf16 inputs, f32 math, bf16 output: 1e-2 covers one bf16 rounding
    of the result and of the bias add."""
    src, tgt, w, b = _inputs(60, 3, 370, 256, dtype=torch.bfloat16,
                             device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 30])
def test_copy_scores_kernel_bf16_decode_and_train(cuda, T):
    """bf16 at the decode step (T=1, 60 rows) and the training T (30): f32
    math, bf16 output, 1e-2 as above."""
    src, tgt, w, b = _inputs(60 if T == 1 else 3, T, 370, 256,
                             dtype=torch.bfloat16, device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [170, 20], ids=["train", "dev"])
def test_copy_scores_kernel_bf16_train_and_dev_shapes(cuda, B):
    """bf16 at the main path's shapes of the tile kernel, the training
    batch (170, 30, 370, 256) and the dev batch (20, ...): f32 math, bf16
    output, 1e-2 as above; bitwise equal over two launches."""
    src, tgt, w, b = _inputs(B, 30, 370, 256, dtype=torch.bfloat16,
                             device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 30, 370)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert torch.equal(got, cs.copy_scores(src, tgt, w, b))


@pytest.mark.gpu
def test_copy_scores_kernel_large_inputs(cuda):
    """Entries of src (5 %) and tgt (2 %) of magnitude 15 to 60 beside
    ordinary ones: a pair of d with such an entry in its s or anywhere in
    its t tile takes the precise tanhf, the others (about a quarter of the
    pairs here) the identity; both against the plain version at f32's
    rtol/atol 1e-5."""
    src, tgt, w, b = _inputs(3, 30, 370, 256, device=cuda)
    src, tgt = _large(src, 2, 0.05), _large(tgt, 3, 0.02)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 30])
def test_copy_scores_kernel_is_deterministic(cuda, T):
    """No float atomics: two launches on the same inputs give the same
    bits, at the decode T and the training T."""
    src, tgt, w, b = _inputs(60 if T == 1 else 20, T, 370, 256, device=cuda)
    assert torch.equal(cs.copy_scores(src, tgt, w, b),
                       cs.copy_scores(src, tgt, w, b))


@pytest.mark.gpu
def test_copy_scores_kernel_refuses_what_it_does_not_take(cuda):
    """The wrapper refuses what the kernels do not take; an input that
    requires grad is taken (since K2), and its backward launches K2."""
    src, tgt, w, b = _inputs(2, 3, 37, 64, device=cuda)
    out = cs.copy_scores(src.requires_grad_(), tgt, w, b)
    assert out.grad_fn is not None
    before = cs.copy_scores_backward.launches
    out.sum().backward()
    torch.cuda.synchronize()
    assert cs.copy_scores_backward.launches == before + 1
    assert src.grad is not None and src.grad.shape == src.shape
    src = src.detach()
    with pytest.raises(TypeError):
        cs.copy_scores(src, tgt.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        cs.copy_scores(src.transpose(0, 1).contiguous().transpose(0, 1),
                       tgt, w, b)
    with pytest.raises(ValueError, match="D="):
        s2, t2, w2, b2 = _inputs(2, 3, 37, 96, device=cuda)
        cs.copy_scores(s2, t2, w2, b2)
    with pytest.raises(ValueError, match="on cpu"):
        cs.copy_scores(src, tgt.cpu(), w, b)
    shifted = torch.empty(src.numel() + 1, device=cuda)[1:].view_as(src)
    shifted.copy_(src)
    with pytest.raises(ValueError, match="aligned"):
        cs.copy_scores(shifted, tgt, w, b)


# the training shape's T and S at a small batch, then unaligned shapes at
# every other supported width, and T above one tile of 32 t values
BWD_SHAPES = [(3, 30, 370, 256), (2, 13, 37, 64), (2, 7, 130, 128),
              (2, 17, 33, 512), (2, 70, 37, 256)]


def _dout(B, T, S, device, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((B, T, S), np.float32)).to(
        device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_copy_scores_backward_kernel_matches_plain(cuda, shape):
    """K2 through autograd (dsrc, dtgt, dw, and dbias formed by autograd
    outside the kernel) against the plain version's autograd, f32 at rtol
    5e-4 / atol 5e-5, the JAX package's gradient tolerance; one K2 launch
    per backward."""
    src, tgt, w, b = _inputs(*shape, device=cuda)
    dout = _dout(shape[0], shape[1], shape[2], cuda)
    grads = {}
    for name, fn in (("kernel", cs.copy_scores),
                     ("plain", cs.copy_scores_reference)):
        leaves = [x.clone().requires_grad_() for x in (src, tgt, w, b)]
        before = cs.copy_scores_backward.launches
        (fn(*leaves) * dout).sum().backward()
        torch.cuda.synchronize()
        launched = cs.copy_scores_backward.launches - before
        assert launched == (1 if name == "kernel" else 0)
        grads[name] = [x.grad for x in leaves]
    for label, got, want in zip(("dsrc", "dtgt", "dw", "dbias"),
                                grads["kernel"], grads["plain"]):
        assert got.shape == want.shape and got.dtype == want.dtype, label
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-5,
                                   msg=lambda m: f"{label}: {m}")


def _large(x, seed, frac):
    """x with a share ``frac`` of its entries replaced by values of both
    signs: half of them of magnitude 25 to 60, half of 15 to 20 (float32,
    same device)."""
    rng = np.random.default_rng(seed)
    pick = rng.random(x.shape) < frac
    mag = np.where(rng.random(x.shape) < 0.5, rng.uniform(25.0, 60.0, x.shape),
                   rng.uniform(15.0, 20.0, x.shape))
    big = mag * rng.choice([-1.0, 1.0], x.shape)
    out = np.where(pick, big, x.cpu().numpy()).astype(np.float32)
    return torch.from_numpy(out).to(x.device)


@pytest.mark.gpu
def test_copy_scores_backward_kernel_large_inputs(cuda):
    """Entries of src and tgt of magnitude 15 to 60 (tanh saturated, and
    above 20 its exponentials near or past f32's range) beside ordinary
    ones: K2 against the plain version's autograd at the same f32
    tolerance, rtol 5e-4 / atol 5e-5."""
    src, tgt, w, _ = _inputs(3, 30, 370, 256, device=cuda)
    src, tgt = _large(src, 2, 0.05), _large(tgt, 3, 0.02)
    dout = _dout(3, 30, 370, cuda)
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(src, tgt, w, dout)
    for label, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
        assert bool(torch.isfinite(g).all()), label
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-5,
                                   msg=lambda m: f"{label}: {m}")


@pytest.mark.gpu
def test_copy_scores_backward_kernel_is_deterministic(cuda):
    """No float atomics: two runs on the same inputs give the same bits."""
    src, tgt, w, _ = _inputs(3, 30, 370, 256, device=cuda)
    dout = _dout(3, 30, 370, cuda)
    first = cs.copy_scores_backward(src, tgt, w, dout)
    second = cs.copy_scores_backward(src, tgt, w, dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_copy_scores_backward_kernel_bf16(cuda):
    """bf16 inputs, f32 math, dsrc/dtgt in bf16 (one rounding each): 2e-2
    of the plain f32 autograd on the same bf16 values."""
    src, tgt, w, _ = _inputs(2, 13, 37, 256, dtype=torch.bfloat16,
                             device=cuda)
    dout = _dout(2, 13, 37, cuda).bfloat16()
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(src.float(), tgt.float(), w,
                                             dout.float())
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    for g, r in zip(got, want):
        torch.testing.assert_close(g.float(), r, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_copy_scores_backward_kernel_bf16_train_shape(cuda):
    """K2 in bf16 at the training shape (170, 30, 370, 256), as the bf16
    training step runs it: against the plain f32 autograd on the same
    bf16 values at 2e-2, as above; bitwise equal over two runs."""
    src, tgt, w, _ = _inputs(170, 30, 370, 256, dtype=torch.bfloat16,
                             device=cuda)
    dout = _dout(170, 30, 370, cuda).bfloat16()
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(src.float(), tgt.float(), w,
                                             dout.float())
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    for g, r in zip(got, want):
        torch.testing.assert_close(g.float(), r, rtol=2e-2, atol=2e-2)
    again = cs.copy_scores_backward(src, tgt, w, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_copy_scores_other_device_raises():
    src, tgt, w, b = _inputs(2, 3, 37, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cs.copy_scores(src, tgt, w, b)
    with pytest.raises(ValueError, match="no kernel"):
        cs.copy_scores_backward(src, tgt, w, _dout(2, 3, 37, "meta"))

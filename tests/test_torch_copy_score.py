"""The port's copy_scores on CPU tensors (its plain version) against the
JAX package's copy_scores (the Pallas kernel, interpreted on the CPU) and
its XLA oracle, on the same numpy inputs: f32, rtol/atol 1e-6, the JAX
package's own kernel tolerance. The gradients (autograd through the plain
version) against ``jax.grad`` through the JAX custom VJP, whose backward
runs the interpreted ``_bwd_kernel``: rtol 5e-4, atol 5e-5, the JAX
package's own gradient tolerance. The CPU path never counts a launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.ops import copy_score as jax_cs
from fira_tpu_torch.ops import copy_score as cs

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(B, T, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D), np.float32),
            rng.standard_normal((B, T, D), np.float32),
            (rng.standard_normal((D, 1)) * 0.1).astype(np.float32),
            rng.standard_normal((1,), np.float32))


@pytest.mark.parametrize("shape", [(2, 13, 37, 64), (2, 7, 130, 64),
                                   (3, 1, 37, 64)],
                         ids=["aligned", "unaligned", "decode_T1"])
def test_copy_scores_matches_jax(shape):
    arrays = _inputs(*shape)
    before = cs.copy_scores.launches
    got = cs.copy_scores(*map(torch.from_numpy, arrays)).numpy()
    assert cs.copy_scores.launches == before
    j = [jnp.asarray(a) for a in arrays]
    pallas = np.asarray(jax.jit(jax_cs.copy_scores)(*j))
    oracle = np.asarray(jax_cs.copy_scores_reference(*j))
    B, T, S, _ = shape
    assert got.shape == (B, T, S) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_reference_keeps_src_dtype():
    src, tgt, w, b = map(torch.from_numpy, _inputs(2, 3, 5, 64))
    out = cs.copy_scores_reference(src.bfloat16(), tgt.bfloat16(), w, b)
    assert out.dtype == torch.bfloat16


GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 13, 37, 64), (2, 7, 130, 64),
                                   (3, 1, 37, 64)],
                         ids=["aligned", "unaligned", "decode_T1"])
def test_copy_scores_gradients_match_jax(shape):
    arrays = _inputs(*shape)
    B, T, S, _ = shape
    dout = np.random.default_rng(7).standard_normal((B, T, S), np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = cs.copy_scores_backward.launches
    (cs.copy_scores(*leaves) * torch.from_numpy(dout)).sum().backward()
    assert cs.copy_scores_backward.launches == before
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_cs.copy_scores(*a) * dout),
        argnums=(0, 1, 2, 3)))(*map(jnp.asarray, arrays))
    for name, leaf, w in zip(("dsrc", "dtgt", "dw", "dbias"), leaves, want):
        assert leaf.grad.shape == leaf.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_copy_scores_backward_is_the_plain_autograd():
    """``copy_scores_backward`` on CPU tensors gives the gradients that
    autograd forms through ``copy_scores``, dw in w's (D, 1) shape."""
    src, tgt, w, b = map(torch.from_numpy, _inputs(2, 5, 11, 64))
    dout = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(1))
    dsrc, dtgt, dw = cs.copy_scores_backward(src, tgt, w, dout)
    leaves = [x.clone().requires_grad_() for x in (src, tgt, w)]
    (cs.copy_scores(*leaves, b) * dout).sum().backward()
    assert dw.shape == w.shape
    for got, leaf in zip((dsrc, dtgt, dw), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=0, atol=0)

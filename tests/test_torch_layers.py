"""The port's layers against the JAX package's flax modules with the same
(transplanted) weights on the same numpy inputs: Combination, GCN,
Attention (causal full prefix, key padding, and the cached ``attend`` at
one position) and FeedForward. f32, rtol/atol 1e-5: the frameworks sum
matmuls, softmaxes and LayerNorm variances in different orders.

Dropout cannot match across frameworks (the streams differ), so it is held
on its own: in training mode at p > 0 it draws from the generator it is
given (the same seed gives the same output bit for bit; the share of zeros
is near p; the kept values are scaled by 1/(1-p)), and in eval mode or at
p = 0 every module equals its deterministic output bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.model import layers as jl
from fira_tpu_torch import convert
from fira_tpu_torch.model import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, D, H = 2, 7, 32, 4


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _transplant(flax_module, torch_module, *args, **kw):
    """Init the flax module, load its weights into the torch module, and
    return the flax apply closure."""
    variables = flax_module.init(jax.random.PRNGKey(3),
                                 *map(jnp.asarray, args), **kw)
    sd = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    torch_module.load_state_dict(sd)
    return lambda *a, **k: np.asarray(
        flax_module.apply(variables, *map(jnp.asarray, a), **k))


def test_position_encoding_matches_jax():
    np.testing.assert_array_equal(tl.position_encoding(30, 64),
                                  jl.position_encoding(30, 64))


def test_combination_matches_jax():
    q, m = _rand(B, L, D, seed=1), _rand(B, L, D, seed=2)
    mod = tl.Combination(H, D)
    apply = _transplant(jl.Combination(num_heads=H, d_model=D), mod,
                        q, q, m, deterministic=True)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (q, q, m))).numpy()
    np.testing.assert_allclose(got, apply(q, q, m, deterministic=True), **TOL)


def test_gcn_matches_jax():
    x = _rand(B, L, D, seed=4)
    adj = np.abs(_rand(B, L, L, seed=5)) * (_rand(B, L, L, seed=6) > 0)
    mod = tl.GCN(D)
    apply = _transplant(jl.GCN(d_model=D), mod, x, adj, deterministic=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    np.testing.assert_allclose(got, apply(x, adj, deterministic=True), **TOL)


def test_feedforward_matches_jax():
    x = _rand(B, L, D, seed=7)
    mod = tl.FeedForward(D)
    apply = _transplant(jl.FeedForward(d_model=D), mod, x, deterministic=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, apply(x, deterministic=True), **TOL)


def _attention_pair(x, mask):
    mod = tl.Attention(H, D)
    apply = _transplant(jl.Attention(num_heads=H, d_model=D), mod,
                        x, x, x, mask, deterministic=True)
    return mod, apply


def test_attention_causal_full_prefix_matches_jax():
    x = _rand(B, L, D, seed=8)
    pad = np.ones((B, L), bool)
    pad[1, 5:] = False          # a padded tail on row 1
    mod, apply = _attention_pair(x, pad)
    with torch.no_grad():
        t = torch.from_numpy(x)
        got = mod(t, t, t, torch.from_numpy(pad), causal=True).numpy()
    want = apply(x, x, x, pad, deterministic=True, causal=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_key_padding_matches_jax():
    q, kv = _rand(B, 3, D, seed=9), _rand(B, L, D, seed=10)
    pad = np.ones((B, L), bool)
    pad[0, 4:] = False
    pad[1, :] = False           # a fully masked row: uniform, never NaN
    mod, apply = _attention_pair(kv, pad)
    with torch.no_grad():
        got = mod(*map(torch.from_numpy, (q, kv, kv, pad))).numpy()
    want = apply(q, kv, kv, pad, deterministic=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_cached_attend_matches_jax():
    """``attend`` on one query position over a (B, H, T, d_head) cache
    with a (B, 1, 1, T) validity mask — the decode step's call."""
    x = _rand(B, L, D, seed=11)
    q = _rand(B, 1, D, seed=12)
    valid = np.zeros((B, 1, 1, L), bool)
    valid[..., :4] = True
    mod, _ = _attention_pair(x, np.ones((B, L), bool))
    jmod = jl.Attention(num_heads=H, d_model=D)
    params = {"params": convert.params_to_flax(mod.state_dict())}
    jk, jv = jmod.apply(params, jnp.asarray(x), jnp.asarray(x),
                        method=jl.Attention.project_kv)
    want = jmod.apply(params, jnp.asarray(q), jk, jv, jnp.asarray(valid),
                      deterministic=True, method=jl.Attention.attend)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        k, v = mod.project_kv(tx, tx)
        got = mod.attend(torch.from_numpy(q), k, v, torch.from_numpy(valid))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropout_draws_from_the_generator():
    x = torch.from_numpy(np.abs(_rand(64, 1000, seed=13)) + 0.5)
    p = 0.2
    a = tl.dropout(x, p, torch.Generator().manual_seed(5))
    b = tl.dropout(x, p, torch.Generator().manual_seed(5))
    c = tl.dropout(x, p, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeros = (a == 0).float().mean().item()
    assert abs(zeros - p) < 0.01        # 64,000 draws: sd 0.0016
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert tl.dropout(x, p, None, training=False) is x
    assert tl.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        tl.dropout(x, p, None)


def _modules(p):
    return {
        "combination": (tl.Combination(H, D, p), lambda m, x, g:
                        m(x, x, x, g)),
        "gcn": (tl.GCN(D, p), lambda m, x, g: m(
            x, torch.from_numpy(np.abs(_rand(B, L, L, seed=14))), g)),
        "attention": (tl.Attention(H, D, p), lambda m, x, g: m(
            x, x, x, torch.ones(B, L, dtype=torch.bool), causal=True,
            generator=g)),
        "ffn": (tl.FeedForward(D, 4, p), lambda m, x, g: m(x, g)),
    }


@pytest.mark.parametrize("name", ["combination", "gcn", "attention", "ffn"])
def test_module_dropout_train_and_eval(name):
    x = torch.from_numpy(_rand(B, L, D, seed=15))
    mod, call = _modules(0.3)[name]
    tl.init_parameters(mod, torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod.eval()
        det = call(mod, x, None)
        mod.train()
        a = call(mod, x, torch.Generator().manual_seed(1))
        b = call(mod, x, torch.Generator().manual_seed(1))
        c = call(mod, x, torch.Generator().manual_seed(2))
        assert torch.equal(a, b)
        assert not torch.equal(a, c) and not torch.equal(a, det)
        # p = 0 in training mode: the deterministic output, bit for bit
        zero, call0 = _modules(0.0)[name]
        zero.load_state_dict(mod.state_dict())
        zero.train()
        assert torch.equal(call0(zero, x, None), det)

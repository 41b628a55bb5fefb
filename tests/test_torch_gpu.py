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


def _bf16_ulp(x):
    """One bf16 step at each |x| of the f64 tensor x (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8).clamp(min=2.0 ** -133)


def _assert_bf16_close(got, want, src, tgt, w, b):
    """bf16 K1 against its plain version, with limits from the roundings
    both make. Each sums the D terms in f32 (error at most delta = (D + 8)
    u sum|w_d|, u = 2^-24), rounds the sum to bf16 and adds the bias in
    bf16. So the kernel's score without bias is within ulp(z) + delta of
    the exact f64 sum z, and with the bias |got - want| <= ulp(z) +
    ulp(max(|got|, |want|)) + 2 delta. A fixed 1e-2 of the result does not
    hold where the bias cancels most of the sum."""
    pre = torch.empty_like(got)
    cs.launch(src, tgt, w.reshape(-1).contiguous(), pre)
    w64 = w.reshape(-1).double()
    z = torch.empty(pre.shape, dtype=torch.float64, device=pre.device)
    for i in range(0, src.shape[0], 8):
        z[i:i + 8] = torch.tanh(src[i:i + 8].double()[:, None]
                                + tgt[i:i + 8].double()[:, :, None]) @ w64
    delta = (w.numel() + 8) * 2.0 ** -24 * w64.abs().sum().item()
    ulp_z = _bf16_ulp(z)
    assert ((pre.double() - z).abs() <= ulp_z + delta).all()
    g, v = got.double(), want.double()
    limit = ulp_z + _bf16_ulp(torch.maximum(g.abs(), v.abs())) + 2 * delta
    assert ((g - v).abs() <= limit).all()


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
    """bf16 inputs, f32 math, bf16 output: within the limits of
    ``_assert_bf16_close``."""
    src, tgt, w, b = _inputs(60, 3, 370, 256, dtype=torch.bfloat16,
                             device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want, src, tgt, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 30])
def test_copy_scores_kernel_bf16_decode_and_train(cuda, T):
    """bf16 at the decode step (T=1, 60 rows) and the training T (30): f32
    math, bf16 output, limits as above."""
    src, tgt, w, b = _inputs(60 if T == 1 else 3, T, 370, 256,
                             dtype=torch.bfloat16, device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want, src, tgt, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [170, 20], ids=["train", "dev"])
def test_copy_scores_kernel_bf16_train_and_dev_shapes(cuda, B):
    """bf16 at the main path's shapes of the tile kernel, the training
    batch (170, 30, 370, 256) and the dev batch (20, ...): f32 math, bf16
    output, limits as above; bitwise equal over two launches."""
    src, tgt, w, b = _inputs(B, 30, 370, 256, dtype=torch.bfloat16,
                             device=cuda)
    got = cs.copy_scores(src, tgt, w, b)
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 30, 370)
    _assert_bf16_close(got, want, src, tgt, w, b)
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


# the bucketed training shape: T is the bucket's tar_len (8 on the smoke's
# corpus) while S = 370 and B = 170 stay; a partial t tile of 8 in 32
BUCKET_SHAPE = (170, 8, 370, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_copy_scores_kernel_at_bucket_tar_len(cuda, dtype):
    """K1 at the bucketed training shape (170, 8, 370, 256): f32 at rtol /
    atol 1e-5, bf16 as at T = 30; bitwise equal over two
    launches; one launch a call."""
    src, tgt, w, b = _inputs(*BUCKET_SHAPE, dtype=dtype, device=cuda)
    before = cs.copy_scores.launches
    got = cs.copy_scores(src, tgt, w, b)
    assert cs.copy_scores.launches == before + 1
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == dtype and got.shape == BUCKET_SHAPE[:3]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(got, want, src, tgt, w, b)
    assert torch.equal(got, cs.copy_scores(src, tgt, w, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_copy_scores_backward_kernel_at_bucket_tar_len(cuda, dtype):
    """K2 at the bucketed training shape (170, 8, 370, 256): against the
    plain autograd on the same values in f64 (dw sums 503,200 terms of
    both signs, and a plain f32 sum rounds a near-zero entry by more than
    the tolerance), f32 at rtol 5e-4 / atol 5e-5, bf16 at 2e-2; bitwise
    equal over two runs."""
    B, T, S, D = BUCKET_SHAPE
    src, tgt, w, _ = _inputs(B, T, S, D, dtype=dtype, device=cuda)
    dout = _dout(B, T, S, cuda).to(dtype)
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(
        *(x.double() for x in (src, tgt, w, dout)))
    rtol, atol = (5e-4, 5e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    for label, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
        assert g.shape == r.shape, label
        torch.testing.assert_close(g.double(), r, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{label}: {m}")
    again = cs.copy_scores_backward(src, tgt, w, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the full-prefix beam (beam_kv_cache=False): the whole (test batch x beam,
# tar_len) prefix scored every step
PREFIX_SHAPE = (60, 30, 370, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_copy_scores_kernel_at_full_prefix_beam_shape(cuda, dtype):
    """K1 at (60, 30, 370, 256): f32 at rtol / atol 1e-5, bf16 within
    the limits of ``_assert_bf16_close``;
    bitwise equal over two launches; one launch a call."""
    src, tgt, w, b = _inputs(*PREFIX_SHAPE, dtype=dtype, device=cuda)
    before = cs.copy_scores.launches
    got = cs.copy_scores(src, tgt, w, b)
    assert cs.copy_scores.launches == before + 1
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == dtype and got.shape == PREFIX_SHAPE[:3]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(got, want, src, tgt, w, b)
    assert torch.equal(got, cs.copy_scores(src, tgt, w, b))


@pytest.mark.gpu
def test_factored_top_k_repairs_ties_on_the_card(cuda):
    """The factored beam's per-side top-k on the card, on rows full of
    ties (a padded copy side shares one value): the k largest, lower
    index first among equal values, as ``jax.lax.top_k``."""
    from fira_tpu_torch.decode.beam import stable_top_k

    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(60, 24650)).astype(np.float32) / 8
    x[:, 5000:] = 1e-9
    for k in (1, 3, 6):
        vals, idx = stable_top_k(torch.from_numpy(x).to(cuda), k)
        want = np.argsort(-x, axis=-1, kind="stable")[:, :k]
        np.testing.assert_array_equal(idx.cpu().numpy(), want)
        np.testing.assert_array_equal(
            vals.cpu().numpy(), np.take_along_axis(x, want, axis=-1))


@pytest.mark.gpu
def test_coo_matvec_on_the_card_equals_dense(cuda):
    """The segment adjacency's A.x on the card against the dense bmm (the
    sums run in another order: a tolerance), f32 and bf16 (accumulated in
    f32)."""
    from fira_tpu_torch.model.model import coo_matvec, dense_adjacency

    rng = np.random.default_rng(1)
    B, N, E, D = 4, 650, 6144, 256
    s, r = (torch.from_numpy(rng.integers(0, N, (B, E))).to(cuda)
            for _ in range(2))
    v = torch.from_numpy(rng.random((B, E), np.float32) * 0.1).to(cuda)
    x = torch.from_numpy(rng.standard_normal((B, N, D), np.float32)).to(cuda)
    want = torch.bmm(dense_adjacency(s, r, v, N), x)
    torch.testing.assert_close(coo_matvec(s, r, v, x), want, rtol=1e-5,
                               atol=1e-5)
    got16 = coo_matvec(s, r, v, x.bfloat16())
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16.float(), want, rtol=2e-2, atol=2e-2)


# the slot engine's step at 64 slots: (64 x beam 3, T = 1)
ENGINE_SHAPE = (192, 1, 370, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_copy_scores_kernel_at_engine_shape(cuda, dtype):
    """K1's row kernel at (192, 1, 370, 256): f32 at rtol / atol 1e-5,
    bf16 within the limits of ``_assert_bf16_close``; one launch a call."""
    src, tgt, w, b = _inputs(*ENGINE_SHAPE, dtype=dtype, device=cuda)
    before = cs.copy_scores.launches
    got = cs.copy_scores(src, tgt, w, b)
    assert cs.copy_scores.launches == before + 1
    want = cs.copy_scores_reference(src, tgt, w, b)
    assert got.dtype == dtype and got.shape == ENGINE_SHAPE[:3]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _assert_bf16_close(got, want, src, tgt, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_engine_on_the_card_writes_the_batched_beam_bits(cuda, tmp_path,
                                                         paged):
    """The slot engine on the card, fira-tiny widths, <eos>-biased random
    weights (samples settle at mixed depths): per sample the batched
    beam's tokens and scores bit for bit at the batch's slot count; K1
    launches R times a step dispatch; the allocator is healthy."""
    from fira_tpu_torch.config import fira_tiny
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data import synthetic
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.data.feeder import Feeder
    from fira_tpu_torch.decode import beam, engine
    from fira_tpu_torch.model.model import FiraModel

    synthetic.write_corpus_dir(str(tmp_path), n_commits=60, seed=5)
    ds = FiraDataset(str(tmp_path), fira_tiny(test_batch_size=4,
                                              engine_paged_kv=paged))
    cfg, data = ds.cfg, ds.splits["train"]
    model = FiraModel(cfg).init_parameters(torch.Generator().manual_seed(1))
    model.load_state_dict(beam.eos_biased(model.state_dict(), 2.0))
    model = model.to(cuda).eval()

    def feed():
        return Feeder(B.bucketed_assembly_tasks(
            data, B.output_plan(data, cfg), cfg, batch_size=4),
            num_workers=0, depth=1, device=cuda)

    want = {}
    with feed() as f:
        search = beam.make_beam_search(model, cfg)
        for item in f:
            toks, probs = (t.cpu().numpy() for t in search(item.device))
            for i in np.flatnonzero(item.host["valid"]):
                want[int(item.host["_positions"][i])] = (toks[i], probs[i])
    eng = engine.SlotEngine(model, cfg)
    before = cs.copy_scores.launches
    with feed() as f:
        got = {it.position: (it.tokens, it.probs) for it in eng.run(f)}
    st = eng.stats
    assert cs.copy_scores.launches - before == 4 * st.step_dispatches
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0])
        assert got[p][1].tobytes() == want[p][1].tobytes(), p
    assert eng.allocator_invariants() == []
    assert st.step_dispatches < st.host_syncs <= 2 * st.step_dispatches


@pytest.mark.gpu
def test_serve_on_the_card_writes_the_drain_bits(cuda, tmp_path):
    """``serve_split`` on the card, 8 requests of a replayed trace (the
    virtual clock), fira-tiny widths, <eos>-biased random weights: the
    drain engine's output bytes with the prefix cache off and on (each
    sample twice in the second run, so hits and coalesced followers
    happen); K1 launches R times a step dispatch."""
    from fira_tpu_torch.config import fira_tiny
    from fira_tpu_torch.data import synthetic
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.decode import beam
    from fira_tpu_torch.decode.runner import run_test
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.serve import poisson_times, serve_split

    synthetic.write_corpus_dir(str(tmp_path / "d"), n_commits=60, seed=5)
    ds = FiraDataset(str(tmp_path / "d"), fira_tiny(test_batch_size=4,
                                                    decode_engine=True))
    cfg = ds.cfg
    model = FiraModel(cfg).init_parameters(torch.Generator().manual_seed(1))
    model.load_state_dict(beam.eos_biased(model.state_dict(), 2.0))
    model = model.to(cuda).eval()
    drain = run_test(model, ds, cfg, out_dir=str(tmp_path / "drain"),
                     split="train")
    lines = open(drain["output_path"]).read().split("\n")
    times = poisson_times(8, rate=0.5, seed=3)
    before = cs.copy_scores.launches
    m = serve_split(model, ds, cfg, arrival_times=times, split="train",
                    out_dir=str(tmp_path / "off"), clock="virtual")
    st = m["engine"]
    assert cs.copy_scores.launches - before == 4 * (
        st["step_dispatches"] + st["warm_step_dispatches"])
    assert m["serve"]["completed"] == 8
    assert open(m["output_path"]).read().split("\n") == lines[:8] + [""]
    mix = np.arange(8) // 2
    m = serve_split(model, ds, cfg.replace(prefix_cache=True),
                    arrival_times=times, split="train",
                    out_dir=str(tmp_path / "on"), clock="virtual",
                    request_mix=mix)
    got = open(m["output_path"]).read().split("\n")
    assert got == [lines[j] for j in mix] + [""]
    assert m["engine"]["cache_hits"] + m["engine"]["dedup_fanout"] > 0


def test_copy_scores_other_device_raises():
    src, tgt, w, b = _inputs(2, 3, 37, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cs.copy_scores(src, tgt, w, b)
    with pytest.raises(ValueError, match="no kernel"):
        cs.copy_scores_backward(src, tgt, w, _dout(2, 3, 37, "meta"))


@pytest.mark.gpu
def test_astdiff_in_a_process_on_the_card_equals_its_cli(cuda, tmp_path):
    """The astdiff library, built by the machine's C++ compiler and loaded
    in a process that holds torch on the card, parses and diffs as its CLI
    binary does in a process of its own (a toolchain that links libstdc++
    statically once crashed the first parse here)."""
    import json
    import subprocess

    from fira_tpu_torch.preprocess import astdiff_binding as ad

    torch.zeros(1, device=cuda)
    old = "class A { int f(int x) { return x + 1; } }"
    new = "class A { int g(int x) { return x * 2; } }"
    a, b = tmp_path / "A.java", tmp_path / "B.java"
    a.write_text(old)
    b.write_text(new)
    cli_bin = str(ad.cli_path())
    out = subprocess.run([cli_bin, "parse", str(a)], capture_output=True,
                         text=True, check=True)
    assert ad.parse_json(old) == json.loads(out.stdout)
    out = subprocess.run([cli_bin, "diff", str(a), str(b)],
                         capture_output=True, text=True, check=True)
    assert ad.diff_lines(old, new) == [
        ln for ln in out.stdout.splitlines() if ln.strip()]
    assert ad.parse_json("%%% not java") is None
    assert ad.tokenize("int x = 1;") == ["int", "x", "=", "1", ";"]


# the spec drafter's K1 call: the copy tier's (and the draft tier's)
# beam-0 rows at --engine-slots 20, T = 1
DRAFT_SHAPE = (20, 1, 370, 256)


@pytest.mark.gpu
def test_copy_scores_kernel_at_drafter_shape(cuda):
    """K1's row kernel at the drafter's (20, 1, 370, 256) in f32, at
    rtol / atol 1e-5, from the contiguous beam-0 rows the drafter hands
    it; one launch a call."""
    src, tgt, w, b = _inputs(60, 1, 370, 256, device=cuda, seed=3)
    src0 = src[0::3].contiguous()       # a slot's beam-0 row of 3 beams
    tgt0 = tgt[:20]
    before = cs.copy_scores.launches
    got = cs.copy_scores(src0, tgt0, w, b)
    assert cs.copy_scores.launches == before + 1
    assert got.shape == DRAFT_SHAPE[:3]
    torch.testing.assert_close(got, cs.copy_scores_reference(src0, tgt0, w,
                                                             b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["copy", "draft"])
def test_spec_on_the_card_writes_the_plain_engine_bits(cuda, tmp_path, tier):
    """Speculative decode on the card, fira-tiny widths, <eos>-biased
    random weights: per sample the plain engine's tokens and scores bit
    for bit; K1 launches once a plain micro-step, once a verify frame and
    k times a draft."""
    from fira_tpu_torch.config import fira_tiny
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data import synthetic
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.data.feeder import Feeder
    from fira_tpu_torch.decode import beam, engine
    from fira_tpu_torch.model.model import FiraModel

    synthetic.write_corpus_dir(str(tmp_path), n_commits=60, seed=5)
    ds = FiraDataset(str(tmp_path), fira_tiny(test_batch_size=4,
                                              decode_engine=True))
    cfg, data = ds.cfg, ds.splits["train"]
    model = FiraModel(cfg).init_parameters(torch.Generator().manual_seed(1))
    model.load_state_dict(beam.eos_biased(model.state_dict(), 2.0))
    model = model.to(cuda).eval()

    def run(c):
        eng = engine.SlotEngine(model, c)
        before = cs.copy_scores.launches
        with Feeder(B.bucketed_assembly_tasks(
                data, B.output_plan(data, c), c, batch_size=4),
                num_workers=0, depth=1, device=cuda) as f:
            got = {it.position: (it.tokens, it.probs) for it in eng.run(f)}
        return got, eng.stats, cs.copy_scores.launches - before

    want, _st, _n = run(cfg)
    got, st, launched = run(cfg.replace(spec_decode=tier))
    assert st.verify_dispatches > 0
    plain = st.step_dispatches - st.verify_dispatches
    assert launched == (4 * plain + st.spec_frames
                        + cfg.engine_spec_k * st.verify_dispatches)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_array_equal(got[p][0], want[p][0])
        assert got[p][1].tobytes() == want[p][1].tobytes(), p


@pytest.mark.gpu
def test_training_gradients_are_reproducible(cuda, tmp_path):
    """Two backward passes of one batch give bitwise equal gradients on
    the card. The small tables are looked up by a one-hot product
    (model._embed): the embedding kernel's backward gave the mark and AST
    tables (many repeats of few ids) gradients whose last bits changed
    from run to run."""
    from fira_tpu_torch.config import fira_tiny
    from fira_tpu_torch.data import synthetic
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.train.state import init_state
    from fira_tpu_torch.train.step import loss_fn

    synthetic.write_corpus_dir(str(tmp_path), n_commits=80, seed=1)
    ds = FiraDataset(str(tmp_path), fira_tiny(batch_size=64))
    host = make_batch(ds.splits["train"], np.arange(64), ds.cfg,
                      batch_size=64)
    batch = batch_to_device(host, cuda, TRAIN_FIELDS)
    model = init_state(ds.cfg, cuda).model.train()
    runs = []
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch, torch.Generator(device=cuda).manual_seed(0)
                ).backward()
        runs.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for other in runs[1:]:
        for k, g in runs[0].items():
            assert torch.equal(g, other[k]), k

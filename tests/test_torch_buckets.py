"""The port's bucketed geometry (``fira_tpu_torch/data/buckets.py`` and
``make_batch(geom=...)``) against the JAX package's, on the same synthetic
corpus written by each package's own generator (fira-tiny):

- ``sample_extents``, ``bucket_table``, ``assign_buckets``,
  ``choose_buckets``, ``packed_plan`` (shuffled over 3 epochs, and not),
  ``decode_table`` and ``padding_report``: equal, exactly;
- ``make_batch(geom=)`` for every plan entry: every array byte-equal,
  with the f32 edge-value wire and with the bf16 one (the port's uint16
  bits against the ``ml_dtypes`` view); a sample that does not fit raises
  ``ValueError`` in both;
- the loss and every gradient at a bucket's geometry against the same
  samples at full padding (the port in f64: 1e-12; in f32: 1e-6, each
  gradient relative to its norm), and against the JAX package at the
  bucket's geometry (loss rtol 1e-5, gradients rtol 5e-4 / atol 1e-5, the
  tolerances of ``tests/test_torch_train.py``). The copy-score bias and
  every attention's key bias have gradients that are zero in exact
  arithmetic (a softmax ignores a constant shift of its logits), so
  theirs are rounding noise, held relative to the whole gradient's norm;
- a bucketed ``run_test`` writes ``output_fira`` byte-identical to the
  unbucketed decode and to the JAX package's bucketed decode (Pallas copy
  head, interpreted on the CPU) of the same weights;
- the dev gate's text and BLEU are the same bucketed and not.
"""

import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fira_tpu.cli import _load_var_maps
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import buckets as JB
from fira_tpu.data import synthetic as jax_synthetic
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.decode.runner import run_test as jax_run_test
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import convert
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
from fira_tpu_torch.decode.runner import run_test
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.train.loop import run_dev

N_COMMITS, SEED, BS, TEST_BS = 120, 3, 8, 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax_corpus"))
    tdir = str(tmp_path_factory.mktemp("torch_corpus"))
    jax_synthetic.write_corpus_dir(jdir, n_commits=N_COMMITS, seed=SEED)
    synthetic.write_corpus_dir(tdir, n_commits=N_COMMITS, seed=SEED)
    kw = dict(batch_size=BS, test_batch_size=TEST_BS)
    jds = JaxDataset(jdir, jax_fira_tiny(copy_head_impl="pallas", **kw))
    tds = FiraDataset(tdir, fira_tiny(**kw))
    buckets = B.choose_buckets(tds.splits["train"], tds.cfg)
    assert len(buckets) >= 2, buckets   # a real table, not just the full
    return dict(jdir=jdir, tdir=tdir, jds=jds, tds=tds, buckets=buckets,
                jcfg=jds.cfg.replace(buckets=buckets),
                tcfg=tds.cfg.replace(buckets=buckets))


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_tables_and_extents_match_jax(corpus, split):
    js, ts = corpus["jds"].splits[split], corpus["tds"].splits[split]
    jcfg, tcfg = corpus["jds"].cfg, corpus["tds"].cfg
    assert B.choose_buckets(ts, tcfg) == JB.choose_buckets(js, jcfg)
    for n in (1, 2, 4):
        assert (B.choose_buckets(ts, tcfg, n_buckets=n)
                == JB.choose_buckets(js, jcfg, n_buckets=n))
    je, te = JB.sample_extents(js, jcfg), B.sample_extents(ts, tcfg)
    for f in ("ast", "edges", "msg"):
        np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
    for buckets in (corpus["buckets"], ((8, 192, 8),),
                    ((16, 256, 4), (8, 128, 8), (8, 128, 8))):
        jc, tc = jcfg.replace(buckets=buckets), tcfg.replace(buckets=buckets)
        table = B.bucket_table(tc)
        assert table == JB.bucket_table(jc)
        assert B.decode_table(tc) == JB.decode_table(jc)
        for use_msg in (True, False):
            np.testing.assert_array_equal(
                B.assign_buckets(te, table, use_msg=use_msg),
                JB.assign_buckets(je, table, use_msg=use_msg))
            assert (B.padding_report(ts, tc, use_msg=use_msg)
                    == JB.padding_report(js, jc, use_msg=use_msg))
    assert B.geom_tag(B.BucketGeom(8, 192, 8)) == "a8.e192.t8"


def test_bucket_table_validation_matches_jax(corpus):
    jcfg, tcfg = corpus["jds"].cfg, corpus["tds"].cfg
    for bad, match in (((0, 256, 8), "ast_len"), ((8, 16, 8), "self-loop"),
                       ((8, 192, tcfg.tar_len + 1), "tar_len")):
        with pytest.raises(ValueError, match=match) as te:
            B.bucket_table(tcfg.replace(buckets=(bad,)))
        with pytest.raises(ValueError) as je:
            JB.bucket_table(jcfg.replace(buckets=(bad,)))
        assert str(te.value) == str(je.value)


def _plans(corpus, module, cfg, split, shuffle, epoch):
    return module.packed_plan(corpus["jds" if module is JB else "tds"]
                              .splits[split], cfg, batch_size=BS,
                              shuffle=shuffle, seed=7, epoch=epoch)


@pytest.mark.parametrize("shuffle,epoch", [(True, 0), (True, 1), (True, 2),
                                           (False, 0)])
def test_packed_plan_matches_jax(corpus, shuffle, epoch):
    want = _plans(corpus, JB, corpus["jcfg"], "train", shuffle, epoch)
    got = _plans(corpus, B, corpus["tcfg"], "train", shuffle, epoch)
    assert len(got) == len(want) > 2
    assert len({g for _, g in got}) >= 2
    for (gc, gg), (wc, wg) in zip(got, want):
        assert gg == wg
        np.testing.assert_array_equal(gc, wc)
    # the decode-side plan (decode table, admissibility without msg)
    for split in ("valid", "test"):
        js, ts = corpus["jds"].splits[split], corpus["tds"].splits[split]
        want = JB.packed_plan(js, corpus["jcfg"], batch_size=TEST_BS,
                              table=JB.decode_table(corpus["jcfg"]),
                              use_msg=False)
        got = B.decode_plan(ts, corpus["tcfg"])
        assert [g for _, g in got] == [g for _, g in want]
        for (gc, _), (wc, _) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_batch_at_bucket_geometry_matches_jax(corpus, dtype):
    jcfg = corpus["jcfg"].replace(compute_dtype=dtype, sort_edges=True)
    tcfg = corpus["tcfg"].replace(compute_dtype=dtype, sort_edges=True)
    js, ts = corpus["jds"].splits["train"], corpus["tds"].splits["train"]
    plan = B.packed_plan(ts, tcfg, batch_size=BS, shuffle=True, seed=1)
    assert len({g for _, g in plan}) >= 2
    for chunk, geom in plan:
        want = jax_make_batch(js, chunk, jcfg, batch_size=BS, geom=geom)
        got = make_batch(ts, chunk, tcfg, batch_size=BS, geom=geom)
        assert sorted(got) == sorted(want)
        assert got["ast_change"].shape[1] == geom.ast_len
        assert got["msg"].shape[1] == geom.tar_len
        assert got["senders"].shape[1] == geom.max_edges
        for k, w in want.items():
            if w.dtype == ml_dtypes.bfloat16:
                w = w.view(np.uint16)
            assert got[k].dtype == w.dtype, k
            assert got[k].shape == w.shape, k
            assert got[k].tobytes() == w.tobytes(), k


def test_unfitting_samples_raise_in_both(corpus):
    jcfg, tcfg = corpus["jds"].cfg, corpus["tds"].cfg
    js, ts = corpus["jds"].splits["train"], corpus["tds"].splits["train"]
    tight = B.BucketGeom(2, tcfg.sou_len + tcfg.sub_token_len + 2, 4)
    ext = B.sample_extents(ts, tcfg)
    bad = np.where(~ext.admissible(tight))[0][:2]
    assert len(bad) == 2
    with pytest.raises(ValueError) as te:
        make_batch(ts, bad, tcfg, batch_size=2, geom=tight)
    with pytest.raises(ValueError) as je:
        jax_make_batch(js, bad, jcfg, batch_size=2, geom=tight)
    assert str(te.value) == str(je.value)
    assert "does not fit" in str(te.value) or "edges" in str(te.value)
    with pytest.raises(ValueError, match="bucket"):
        make_batch(ts, np.arange(2), tcfg, batch_size=2,
                   geom=(tcfg.ast_change_len + 1, tcfg.max_edges,
                         tcfg.tar_len))


def _bucket_samples(corpus):
    """A batch's worth of train samples that fit the smallest bucket, and
    that bucket."""
    cfg, split = corpus["tcfg"], corpus["tds"].splits["train"]
    geom = B.bucket_table(cfg)[0]
    idx = np.where(B.sample_extents(split, cfg).admissible(geom))[0][:BS - 1]
    assert len(idx) == BS - 1
    return idx, geom


def _port_loss_grads(model, batch, dtype):
    b = batch_to_device(batch, torch.device("cpu"), TRAIN_FIELDS)
    b["values"] = b["values"].to(dtype)
    model.zero_grad()
    nll, cnt = model(b)
    (nll / cnt.clamp(min=1)).backward()
    return (nll.item(), int(cnt),
            {n: p.grad.clone() for n, p in model.named_parameters()})


# gradients that are zero in exact arithmetic: a softmax ignores a
# constant shift of its logits, and these biases add one
SHIFT_ONLY = re.compile(r"(k_proj\.bias|^copy_net\.score\.bias)$")


def _assert_grads_close(got, want, tol):
    """Each gradient within ``tol`` of its norm; the ``SHIFT_ONLY`` ones
    within ``tol`` of the whole gradient's norm."""
    total = float(torch.sqrt(sum((w.double() ** 2).sum()
                                 for w in want.values())))
    for name, w in want.items():
        scale = total if SHIFT_ONLY.search(name) else float(w.norm())
        err = float((got[name] - w).norm())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_loss_and_gradients_bucket_vs_full_padding(corpus, dtype, tol):
    cfg, split = corpus["tcfg"], corpus["tds"].splits["train"]
    idx, geom = _bucket_samples(corpus)
    model = FiraModel(cfg, dtype=dtype).init_parameters(
        torch.Generator().manual_seed(0)).to(dtype)
    model.eval()
    nll_f, cnt_f, g_f = _port_loss_grads(
        model, make_batch(split, idx, cfg, batch_size=BS), dtype)
    nll_b, cnt_b, g_b = _port_loss_grads(
        model, make_batch(split, idx, cfg, batch_size=BS, geom=geom), dtype)
    assert cnt_b == cnt_f > 0
    assert abs(nll_b - nll_f) <= tol * abs(nll_f)
    _assert_grads_close(g_b, g_f, tol)


def test_loss_and_gradients_at_bucket_geometry_match_jax(corpus):
    jcfg, tcfg = corpus["jcfg"], corpus["tcfg"]
    idx, geom = _bucket_samples(corpus)
    model = FiraModel(tcfg).init_parameters(torch.Generator().manual_seed(1))
    model.eval()
    nll, cnt, grads = _port_loss_grads(
        model, make_batch(corpus["tds"].splits["train"], idx, tcfg,
                          batch_size=BS, geom=geom), torch.float32)
    jb = {k: jnp.asarray(v) for k, v in jax_make_batch(
        corpus["jds"].splits["train"], idx, jcfg, batch_size=BS,
        geom=geom).items()}
    jmodel = JaxModel(jcfg)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_flax(model.state_dict()))

    def loss(p):
        n, c = jmodel.apply({"params": p}, jb, deterministic=True)
        return n / jnp.maximum(c, 1), (n, c)

    (_, (jnll, jcnt)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    assert cnt == int(jcnt)
    np.testing.assert_allclose(nll, float(jnll), rtol=1e-5)
    want = {k: v.numpy() for k, v in convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-4,
                                   atol=1e-5, err_msg=name)


def test_bucketed_decode_file_matches_unbucketed_and_jax(corpus, tmp_path):
    tds, jds = corpus["tds"], corpus["jds"]
    test_buckets = B.choose_buckets(tds.splits["test"], tds.cfg)
    assert test_buckets == JB.choose_buckets(jds.splits["test"], jds.cfg)
    tcfg = tds.cfg.replace(buckets=test_buckets)
    jcfg = jds.cfg.replace(buckets=test_buckets)
    # the test split really packs into more than one geometry
    plan = B.decode_plan(tds.splits["test"], tcfg)
    assert len({g for _, g in plan}) >= 2
    model = FiraModel(tds.cfg).init_parameters(
        torch.Generator().manual_seed(0))
    var_maps = _load_var_maps(corpus["tdir"])
    outs = {}
    for name, cfg in (("plain", tds.cfg), ("bucketed", tcfg)):
        out = str(tmp_path / name)
        run_test(model, tds, cfg, out_dir=out, var_maps=var_maps)
        with open(os.path.join(out, "output_fira"), "rb") as f:
            outs[name] = f.read()
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_flax(model.state_dict()))
    jout = str(tmp_path / "jax")
    jax_run_test(JaxModel(jcfg), params, jds, jcfg, out_dir=jout,
                 var_maps=_load_var_maps(corpus["jdir"]))
    with open(os.path.join(jout, "output_fira"), "rb") as f:
        outs["jax"] = f.read()
    assert outs["plain"].count(b"\n") == len(tds.splits["test"])
    assert len(outs["plain"].split()) > 5 * len(tds.splits["test"])
    assert outs["bucketed"] == outs["plain"]
    assert outs["bucketed"] == outs["jax"]


def test_dev_gate_text_equal_bucketed_and_not(corpus):
    tds = corpus["tds"]
    model = FiraModel(tds.cfg).init_parameters(
        torch.Generator().manual_seed(2))
    var_maps = _load_var_maps(corpus["tdir"])
    plain = run_dev(model, tds, tds.cfg, var_maps)
    bucketed = run_dev(model, tds, corpus["tcfg"], var_maps)
    assert plain[1] == bucketed[1]
    assert plain[0] == bucketed[0]
    assert plain[1].count("\n") == len(tds.splits["valid"])
    # the bucketed pass ran its batches at a smaller geometry
    plan = B.decode_plan(tds.splits["valid"], corpus["tcfg"])
    assert bucketed[2] == len(plan)
    assert any(g != B.full_geom(tds.cfg) for _, g in plan)


def test_decode_tar_buckets_is_refused(corpus):
    """The tar-bucketed decode runs now; what is refused is a paged block
    size that does not tile a bucket's tar budget, in the JAX package's
    words. Its decode table keeps each bucket's tar, as the JAX one."""
    from fira_tpu.decode.paging import paging_errors as jax_paging_errors
    from fira_tpu_torch.config import unsupported
    from fira_tpu_torch.decode.paging import paging_errors

    buckets = ((8, 192, 6),)
    tc = corpus["tcfg"].replace(buckets=buckets, decode_tar_buckets=True,
                                decode_engine=True)
    jc = corpus["jcfg"].replace(buckets=buckets, decode_tar_buckets=True,
                                decode_engine=True)
    assert not unsupported(tc)
    assert B.decode_table(tc) == JB.decode_table(jc)
    assert B.decode_table(tc)[0].tar_len == 6
    bad = paging_errors(tc.replace(kv_block_size=4))
    assert bad and "kv_block_size 4 does not divide decode tar budget 6" \
        in bad[0]
    assert bad == jax_paging_errors(jc.replace(kv_block_size=4))
    assert not paging_errors(tc)

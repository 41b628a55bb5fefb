"""The paged KV arena of the port's slot engine: ``gather_block_kv`` and
``append_block_kv`` (``fira_tpu_torch/model/layers.py``) against the JAX
package's on the same arrays, sentinel ids included (the port's pool has
one scratch block more, which sentinel ids address where the JAX gather
clamps and the JAX scatter drops); the paged engine bitwise equal to the
unpaged one, also with tar-bucketed reservations that leave table
entries unmapped; insert zeroes nothing and a dirty arena reused after
harvest gives the same bits; an undersized pool seats its head-of-line
row only after harvests free blocks; ``allocator_invariants()`` stays
empty and catches a double release; ``paging_errors`` and
``kv_bytes_per_slot`` equal the JAX package's on a table of configs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.decode import paging as jax_paging
from fira_tpu.model import layers as jax_layers
from fira_tpu_torch.config import FiraConfig, fira_tiny
from fira_tpu_torch.data import buckets as B
from fira_tpu_torch.data import synthetic
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder
from fira_tpu_torch.decode import beam, engine, paging
from fira_tpu_torch.model import layers
from fira_tpu_torch.model.model import FiraModel

GEOM = dict(embedding_dim=32, num_head=4, num_layers=2, sou_len=24,
            tar_len=8, att_len=6, ast_change_len=16, sub_token_len=16,
            max_edges=256, batch_size=4, test_batch_size=4)
SPLIT = "train"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: the engine runs thousands of
    tiny ops, and with the suite's parallel workers each sharing the cores
    a full thread pool a worker makes them many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    synthetic.write_corpus_dir(d, n_commits=40, seed=5)
    ds = FiraDataset(d, FiraConfig(**GEOM))
    model = FiraModel(ds.cfg).init_parameters(torch.Generator().manual_seed(1))
    model.load_state_dict(beam.eos_biased(model.state_dict(), 2.0))
    return dict(ds=ds, cfg=ds.cfg, model=model.eval())


def run(setup, cfg, eng=None, **kw):
    """({split position: (tokens, probs)}, the engine) of one drain."""
    eng = eng or engine.SlotEngine(setup["model"], cfg, **kw)
    data = setup["ds"].splits[SPLIT]
    tasks = B.bucketed_assembly_tasks(data, B.output_plan(data, cfg), cfg,
                                      batch_size=cfg.test_batch_size)
    with Feeder(tasks, num_workers=0, depth=1, device="cpu") as feed:
        got = {it.position: (it.tokens, it.probs.tobytes())
               for it in eng.run(feed)}
    return got, eng


def assert_same(a, b):
    assert set(a) == set(b)
    for p in a:
        np.testing.assert_array_equal(a[p][0], b[p][0])
        assert a[p][1] == b[p][1], p


def test_gather_and_append_match_jax_with_sentinels():
    rng = np.random.default_rng(0)
    L, P, K, H, BS, dh, S, W = 2, 5, 3, 2, 4, 8, 3, 2
    pool = rng.standard_normal((L, P, K, H, BS, dh)).astype(np.float32)
    scratch = rng.standard_normal((L, 1, K, H, BS, dh)).astype(np.float32)
    tpool = torch.from_numpy(np.concatenate([pool, scratch], axis=1))
    tab = np.array([[3, 0], [1, P], [P, P]])     # partial, and unmapped
    for i in range(L):
        want = np.asarray(jax_layers.gather_block_kv(jnp.asarray(pool[i]),
                                                     jnp.asarray(tab)))
        got = layers.gather_block_kv(tpool[i], torch.from_numpy(tab)).numpy()
        assert got.shape == want.shape == (S * K, H, W * BS, dh)
        rows = got.reshape(S, K, H, W, BS, dh)
        mapped = tab < P
        np.testing.assert_array_equal(
            rows.transpose(0, 3, 1, 2, 4, 5)[mapped],
            want.reshape(S, K, H, W, BS, dh).transpose(0, 3, 1, 2, 4, 5)
            [mapped])
        # a sentinel entry reads the scratch block
        np.testing.assert_array_equal(rows[1, :, :, 1], scratch[i, 0])
    blk = np.array([4, P, 0, P, 2])
    krow, off = np.array([0, 1, 2, 0, 1]), np.array([3, 0, 1, 2, 3])
    new = rng.standard_normal((5, H, dh)).astype(np.float32)
    want = np.asarray(jax_layers.append_block_kv(
        jnp.asarray(pool), 1, jnp.asarray(blk), jnp.asarray(krow),
        jnp.asarray(off), jnp.asarray(new)))
    layers.append_block_kv(tpool, 1, torch.from_numpy(blk),
                           torch.from_numpy(krow), torch.from_numpy(off),
                           torch.from_numpy(new))
    np.testing.assert_array_equal(tpool[:, :P].numpy(), want)
    # the sentinel rows wrote the scratch block, nothing else
    assert not np.array_equal(tpool[1, P].numpy(), scratch[1, 0])
    np.testing.assert_array_equal(tpool[0, P].numpy(), scratch[0, 0])


@pytest.mark.parametrize("fac,prob", list(itertools.product(
    [False, True], [True, False])))
def test_paged_bitwise_equals_unpaged(setup, fac, prob):
    cfg = setup["cfg"].replace(beam_factored_topk=fac,
                               beam_compat_prob_space=prob)
    paged, eng = run(setup, cfg)
    unpaged, _ = run(setup, cfg.replace(engine_paged_kv=False))
    assert_same(paged, unpaged)
    assert eng.allocator_invariants() == []
    assert eng.stats.pool_blocks > 0 and eng.stats.peak_blocks > 0


def test_tar_buckets_reserve_fewer_blocks_bitwise(setup):
    """Under ``decode_tar_buckets`` a short-bucket sample is granted only
    its budget's blocks (the rest of its table row is the sentinel) and
    generates at most that many positions; paged equals unpaged."""
    data = setup["ds"].splits[SPLIT]
    cfg = setup["cfg"].replace(buckets=((16, 256, 4), (16, 256, 6)),
                               decode_tar_buckets=True)
    assert paging.declared_decode_tars(cfg) == (4, 6, 8)
    paged, eng = run(setup, cfg)
    unpaged, _ = run(setup, cfg.replace(engine_paged_kv=False))
    assert_same(paged, unpaged)
    assert eng.allocator_invariants() == []
    plan = B.output_plan(data, cfg)
    limit = {int(i): g.tar_len for chunk, g in plan for i in chunk}
    assert min(limit.values()) < cfg.tar_len
    for p, (toks, _probs) in paged.items():
        assert not toks[:, limit[p]:].any(), p     # capped at its budget


def test_insert_zeroes_nothing_and_a_dirty_arena_gives_the_same_bits(setup):
    cfg = setup["cfg"]
    for paged, fields in ((True, ("k_pool", "v_pool")),
                          (False, ("k_cache", "v_cache"))):
        c = cfg.replace(engine_paged_kv=paged)
        first, eng = run(setup, c)
        ptrs = {f: eng._state[f].data_ptr() for f in fields}
        second, _ = run(setup, c, eng=eng)       # the same, dirty arena
        assert_same(first, second)
        data = setup["ds"].splits[SPLIT]
        host = next(iter(B.bucketed_assembly_tasks(
            data, B.output_plan(data, c), c, batch_size=4)))()
        eng.begin_stream()
        before = {f: eng._state[f].clone() for f in fields}
        eng.admit(host, 0)
        eng.refill()
        for f in fields:
            assert eng._state[f].data_ptr() == ptrs[f]
            assert torch.equal(eng._state[f], before[f]), f


def test_undersized_pool_waits_for_harvests(setup):
    """A pool for two of six slots: at most two slots are seated at once,
    the head row waits for a harvest to free blocks, and the bytes are
    those of full residency."""
    cfg = setup["cfg"].replace(engine_slots=6)
    full, full_eng = run(setup, cfg)
    W = paging.blocks_per_seq(cfg.tar_len, paging.resolve_block_size(cfg))
    eng = engine.SlotEngine(setup["model"], cfg, pool_blocks=2 * W)
    seated = []
    refill = eng.refill

    def watched(order="fifo"):
        refill(order)
        seated.append(eng.in_flight())
        assert eng.allocator_invariants() == []

    eng.refill = watched
    small, _ = run(setup, cfg, eng=eng)
    assert_same(small, full)
    assert max(seated) == 2 and eng.stats.peak_blocks == 2 * W
    assert full_eng.stats.peak_blocks > 2 * W
    assert eng.stats.pool_utilization > full_eng.stats.pool_utilization


def test_allocator_invariants_catch_a_double_release(setup):
    eng = engine.SlotEngine(setup["model"], setup["cfg"])
    assert eng.allocator_invariants() == []
    grant = eng._acquire_blocks(3)
    eng._slot_blocks[0] = grant
    assert eng.allocator_invariants() == []
    eng._release_blocks(grant)
    with pytest.raises(AssertionError, match="released while not granted"):
        eng._release_blocks(grant[:1])
    errs = eng.allocator_invariants()   # slot 0 still names freed blocks
    assert errs and "both free and granted" in " ".join(errs)


CONFIGS = [
    dict(),
    dict(kv_block_size=5),
    dict(kv_block_size=4),
    dict(engine_paged_kv=False, kv_block_size=5),
    dict(buckets=((16, 400, 8),), decode_tar_buckets=True, kv_block_size=6),
    dict(buckets=((16, 400, 8),), decode_tar_buckets=True),
    dict(kv_pool_blocks=10),
    dict(kv_pool_blocks=16),
    dict(engine_slots=1, kv_pool_blocks=1),
    dict(engine_replicas=2, kv_pool_blocks=7),
    dict(engine_replicas=2, engine_slots=8, kv_pool_blocks=16),
    dict(kv_block_size=-1),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_paging_errors_match_jax(kw):
    tc = fira_tiny(decode_engine=True, **kw)
    jc = jax_fira_tiny(decode_engine=True, **kw)
    assert paging.paging_errors(tc) == jax_paging.paging_errors(jc)
    assert paging.declared_decode_tars(tc) == jax_paging.declared_decode_tars(
        jc)
    assert paging.resolve_block_size(tc) == jax_paging.resolve_block_size(jc)
    assert paging.resolved_slots(tc) == jax_paging.resolved_slots(jc)
    assert paging.kv_itemsize(tc) == jax_paging.kv_itemsize(jc)
    for paged, bs, pool, slots in itertools.product(
            (True, False), (1, 4, 6), (0, 8, 24), (1, 8)):
        args = dict(paged=paged, block_size=bs, pool_blocks=pool,
                    slots=slots, itemsize=4)
        assert (paging.kv_bytes_per_slot(tc, **args)
                == jax_paging.kv_bytes_per_slot(jc, **args))


def test_prefix_cache_errors_match_jax():
    for kw in (dict(prefix_cache=True),
               dict(prefix_cache=True, decode_engine=True,
                    prefix_cache_entries=0, prefix_cache_bytes=-1),
               dict()):
        assert (paging.prefix_cache_errors(fira_tiny(**kw))
                == jax_paging.prefix_cache_errors(jax_fira_tiny(**kw)))
    for t in ((12,), (8, 12), (30,), (30, 64), (7,)):
        assert paging.auto_block_size(t) == jax_paging.auto_block_size(t)

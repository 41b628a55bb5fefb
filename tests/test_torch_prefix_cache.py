"""The port's prefix cache and in-flight dedup
(``fira_tpu_torch/decode/prefix_cache.py`` and the engine's two reuse
passes) against the JAX package's (tests/test_prefix_cache.py), on the
same corpus and weights at the JAX tests' widths:

- ``payload_digests`` hex strings equal JAX's for 16 samples' packed
  payloads; the digest addresses content (host-only fields and the pad
  rows out, dtype and shape in);
- ``extract_payloads`` / ``build_chunk`` give JAX's arrays;
- a cache hit or a coalesced row decodes bitwise as its cold prefill
  (tokens and probabilities), in the four kv-cache x factored-top-k modes,
  paged and unpaged (and the two full-prefix ones), with the reuse
  metered as the JAX engine meters it;
- dedup fan-out records one seat, with the JAX package's records; a shed
  follower leaves its leader alive; a flood of one digest respects the
  queue cap;
- LRU and byte-budget eviction; grants released on harvest and on
  retire, with every owed request handed back."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.batching import make_batch as jax_make_batch
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.feeder import Feeder as JaxFeeder
from fira_tpu.data.feeder import assembly_tasks as jax_assembly_tasks
from fira_tpu.data.synthetic import write_corpus_dir
from fira_tpu.decode import engine as jax_engine
from fira_tpu.decode import prefix_cache as jax_pc
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu_torch import convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.feeder import Feeder, assembly_tasks
from fira_tpu_torch.decode import engine, prefix_cache
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.serve import poisson_times, serve_split

KNOBS = dict(batch_size=8, test_batch_size=4, decode_engine=True)
# in-flight duplicates (within and across adjacent chunks) and repeats of
# samples already harvested: both reuse passes fire
REPEAT_CHUNKS = [np.array([0, 1, 2, 3]), np.array([0, 1, 2, 3]),
                 np.array([4, 5, 0, 1]), np.array([2, 3, 4, 5]),
                 np.array([0, 1, 2, 3])]
# (kv cache, factored top-k, paged arena)
MODES = [(True, False, True), (True, False, False), (True, True, True),
         (True, True, False), (False, False, False), (False, True, False)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tests' corpus (24 commits, seed 13), widths and <eos>
    bias, in both packages."""
    d = str(tmp_path_factory.mktemp("prefix_corpus"))
    write_corpus_dir(d, n_commits=24, seed=13)
    jds = JaxDataset(d, jax_fira_tiny(**KNOBS))
    tds = FiraDataset(d, fira_tiny(**KNOBS))
    batch = make_batch(tds.splits["train"], np.arange(4), tds.cfg)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(0), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = eos_biased_params(params, delta=4.0)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    return dict(jds=jds, tds=tds, params=params, model=model)


def drain(setup, cfg, chunks=REPEAT_CHUNKS):
    """({stream position: (tokens bytes, probs bytes)}, the engine) of the
    port's engine over a chunk stream with repeats."""
    eng = engine.SlotEngine(setup["model"], cfg)
    out = {}
    with Feeder(assembly_tasks(setup["tds"].splits["train"], chunks, cfg,
                               batch_size=4),
                num_workers=0, depth=1, device="cpu") as feed:
        for it in eng.run(feed):
            out[it.position] = (it.tokens.tobytes(), it.probs.tobytes())
    assert len(out) == sum(len(c) for c in chunks)
    return out, eng


# --------------------------------------------------------------------------
# content addressing
# --------------------------------------------------------------------------

def test_payload_digests_equal_jax_for_16_samples(setup):
    for split in ("train", "test"):
        tdata, jdata = setup["tds"].splits[split], setup["jds"].splits[split]
        n = min(16, len(tdata))
        idx = np.arange(n)
        got = prefix_cache.payload_digests(
            make_batch(tdata, idx, setup["tds"].cfg, batch_size=16))
        want = jax_pc.payload_digests(
            jax_make_batch(jdata, idx, setup["jds"].cfg, batch_size=16))
        assert got == want
        assert all(d is not None for d in got[:n])
        assert all(d is None for d in got[n:])


def test_digest_is_content_addressed():
    host = {"diff": np.arange(12, dtype=np.int16).reshape(2, 6),
            "msg": np.ones((2, 3), np.int16),
            "valid": np.array([True, True]),
            "_positions": np.array([5, 6])}
    a = prefix_cache.payload_digests(host)
    assert a == jax_pc.payload_digests(host)
    assert prefix_cache.payload_digests(
        dict(host, _positions=np.array([9, 1]))) == a
    host2 = dict(host, diff=host["diff"].copy())
    host2["diff"][1, 0] += 1
    c = prefix_cache.payload_digests(host2)
    assert a[0] == c[0] and a[1] != c[1]
    d = prefix_cache.payload_digests(
        dict(host, diff=host["diff"].astype(np.int32)))
    assert d[0] != a[0]                   # the dtype takes part
    pad = prefix_cache.payload_digests(
        dict(host, valid=np.array([True, False])))
    assert pad[1] is None                 # a pad row has no digest
    assert prefix_cache.tier_namespace(fira_tiny()) == b""
    stamped = prefix_cache.stamp_digests(dict(host))
    assert stamped["_digests"] == a


@pytest.mark.parametrize("kv", [True, False])
def test_extract_and_build_equal_jax(kv):
    rng = np.random.default_rng(1)
    C, K, L = 3, 3, 2
    host = {"src_mask": rng.random((C, 7)) > 0.5,
            "diff": rng.integers(0, 9, (C, 5)),
            "sub_token": rng.integers(0, 9, (C, 4))}
    if kv:
        for f in ("cross_k", "cross_v"):
            host[f] = np.repeat(rng.standard_normal(
                (L, C, 2, 7, 4)).astype(np.float32), K, axis=1)
        host["src_proj"] = np.repeat(rng.standard_normal(
            (C, 7, 8)).astype(np.float32), K, axis=0)
        host["cache_seed"] = np.zeros((), np.float32)
    else:
        host["states"] = np.repeat(rng.standard_normal(
            (C, 7, 8)).astype(np.float32), K, axis=0)
    got = prefix_cache.extract_payloads(host, [0, 2], K)
    want = jax_pc.extract_payloads(host, [0, 2], K)
    assert got.keys() == want.keys()
    for r in got:
        assert got[r].keys() == want[r].keys()
        for f in got[r]:
            assert got[r][f].dtype == want[r][f].dtype
            np.testing.assert_array_equal(got[r][f], want[r][f])
        assert (prefix_cache.payload_checksum(got[r])
                == jax_pc.payload_checksum(want[r]))
    built = prefix_cache.build_chunk(got, C, K)
    jbuilt = jax_pc.build_chunk(want, C, K)
    assert built.keys() == jbuilt.keys()
    for f in built:
        np.testing.assert_array_equal(built[f], jbuilt[f])
    for f in ("cross_k", "states"):
        if f in host:    # the rows with a payload rebuild bitwise
            ax = 1 if f == "cross_k" else 0
            sl = [slice(None)] * host[f].ndim
            sl[ax] = slice(0, K)
            np.testing.assert_array_equal(built[f][tuple(sl)],
                                          host[f][tuple(sl)])


# --------------------------------------------------------------------------
# bitwise reuse in every mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv,fac,paged", MODES)
def test_cache_hit_bit_exact_vs_cold(setup, kv, fac, paged):
    cfg = setup["tds"].cfg.replace(beam_kv_cache=kv, beam_factored_topk=fac,
                                   engine_paged_kv=paged)
    cold, cold_eng = drain(setup, cfg)
    warm, warm_eng = drain(setup, cfg.replace(prefix_cache=True))
    assert cold == warm
    st = warm_eng.stats
    assert st.cache_hits > 0 and st.dedup_fanout > 0
    assert st.prefills_saved > 0
    assert st.prefills < cold_eng.stats.prefills
    assert st.cache_hbm_bytes_saved > 0
    assert 0.0 < st.summary()["cache_hit_rate"] <= 1.0
    # the fills are stored after harvest's done-mask read, with no read
    # of their own: at most the two of every dispatch
    assert st.host_syncs <= 2 * st.step_dispatches
    # the comparator carries no cache state at all
    assert cold_eng.stats.cache_hits == cold_eng.stats.cache_misses == 0
    assert cold_eng.stats.dedup_fanout == 0 and cold_eng._cache is None
    if paged and kv:
        assert warm_eng.allocator_invariants() == []
        assert len(warm_eng._free_blocks) == warm_eng._pool_blocks
        assert warm_eng._block_refs == {}


def test_bf16_cache_hit_bit_exact_vs_cold(setup):
    """bf16 compute: the cached artifacts are bf16 tensors, held on the
    host as their int16 bits and viewed back, bitwise."""
    cfg = setup["tds"].cfg.replace(compute_dtype="bfloat16")
    model = FiraModel(cfg, dtype="bfloat16")
    model.load_state_dict(setup["model"].state_dict())
    model.eval()
    bf16 = dict(setup, model=model)
    cold, _ = drain(bf16, cfg)
    warm, eng = drain(bf16, cfg.replace(prefix_cache=True))
    assert cold == warm
    assert eng.stats.cache_hits > 0
    assert eng._artifact_dtypes["cross_k"] == torch.bfloat16


def test_reuse_meters_equal_the_jax_engines(setup):
    """The JAX engine over the same repeated stream: the same hits,
    misses, fan-out, prefills and saved prefills, and the same per-sample
    tokens."""
    cfg = setup["tds"].cfg.replace(prefix_cache=True)
    got, eng = drain(setup, cfg)
    jcfg = setup["jds"].cfg.replace(prefix_cache=True)
    jeng = jax_engine.SlotEngine(JaxModel(jcfg), setup["params"], jcfg)
    want = {}
    with JaxFeeder(jax_assembly_tasks(setup["jds"].splits["train"],
                                      REPEAT_CHUNKS, jcfg, batch_size=4),
                   num_workers=0, depth=1) as feed:
        for it in jeng.run(feed):
            want[it.position] = np.asarray(it.tokens)
    assert {p: np.frombuffer(t, np.int64).tolist()
            for p, (t, _) in got.items()} == {
        p: t.reshape(-1).tolist() for p, t in want.items()}
    for key in ("cache_hits", "cache_misses", "cache_evictions",
                "prefills", "prefills_saved", "dedup_fanout", "commits",
                "slots_refilled", "shared_block_peak"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key


def test_lru_eviction_under_undersized_cache_deterministic(setup):
    cfg = setup["tds"].cfg
    cold, _ = drain(setup, cfg)
    tiny, eng = drain(setup, cfg.replace(prefix_cache=True,
                                         prefix_cache_entries=2))
    assert cold == tiny
    assert eng.stats.cache_evictions > 0 and eng.cache_len() <= 2


def test_cache_faults_are_misses_never_wrong_answers(setup):
    """``cache.lookup`` corrupt: the checksum catches every scrambled read
    and the entry is dropped; raise: the lookup is a miss. The bytes stay
    the cold run's."""
    from fira_tpu_torch.robust.faults import FaultInjector, parse_fault_specs

    cfg = setup["tds"].cfg.replace(prefix_cache=True)
    cold, _ = drain(setup, setup["tds"].cfg)
    for spec, meter in (("cache.lookup:corrupt:1:0", "cache_integrity_drops"),
                        ("cache.lookup:raise:1:0", None)):
        eng = engine.SlotEngine(setup["model"], cfg, faults=FaultInjector(
            parse_fault_specs(spec)))
        out = {}
        with Feeder(assembly_tasks(setup["tds"].splits["train"],
                                   REPEAT_CHUNKS, cfg, batch_size=4),
                    num_workers=0, depth=1, device="cpu") as feed:
            for it in eng.run(feed):
                out[it.position] = (it.tokens.tobytes(), it.probs.tobytes())
        assert out == cold
        assert eng.stats.cache_hits == 0
        if meter:
            assert getattr(eng.stats, meter) > 0


def test_refcount_release_on_harvest_and_retire(setup):
    cfg = setup["tds"].cfg.replace(prefix_cache=True)
    eng = engine.SlotEngine(setup["model"], cfg)
    feed = Feeder(assembly_tasks(setup["tds"].splits["train"], REPEAT_CHUNKS,
                                 cfg, batch_size=4),
                  num_workers=0, depth=1, put=False)
    it = iter(feed)
    eng.begin_stream()
    for _ in range(3):
        item = next(it)
        eng.admit(item.host, item.index, None)
    eng.refill()
    assert eng.in_flight() > 0
    assert eng._pool_blocks - len(eng._free_blocks) > 0
    assert eng.allocator_invariants() == []
    owed = set(eng.pending_positions())
    # duplicates coalesced: more owed than seated and staged
    assert len(owed) > eng.in_flight() + eng.staged_rows
    payloads = eng.retire()
    feed.close()
    assert eng.retired
    assert len(eng._free_blocks) == eng._pool_blocks
    assert eng._block_refs == {} and eng.allocator_invariants() == []
    requeued = set()
    for p in payloads:
        v = np.asarray(p["valid"], dtype=bool)
        requeued.update(int(x) for x in np.asarray(p["_positions"])[v])
    assert requeued == owed       # followers survive into the hand-back
    # a retired engine does nothing when an abandoned call wakes
    eng.admit(item.host, item.index, None)
    eng.refill()
    eng.step_dispatch()
    assert eng.harvest() == [] and eng.pending_positions() == []


# --------------------------------------------------------------------------
# serving with the cache: dedup fan-out, repeats, sheds
# --------------------------------------------------------------------------

def serve_pair(setup, tmp_path, times, mix, **knobs):
    """The port's serve with the cache on, its cache-off comparator, and
    the JAX package's with the cache on."""
    tcfg = setup["tds"].cfg.replace(**knobs)
    jcfg = setup["jds"].cfg.replace(**knobs)
    kw = dict(arrival_times=times, split="train", clock="virtual",
              request_mix=mix)
    off = serve_split(setup["model"], setup["tds"], tcfg,
                      out_dir=str(tmp_path / "off"), **kw)
    on = serve_split(setup["model"], setup["tds"],
                     tcfg.replace(prefix_cache=True),
                     out_dir=str(tmp_path / "on"), **kw)
    jon = jax_serve_split(JaxModel(jcfg), setup["params"], setup["jds"],
                          jcfg.replace(prefix_cache=True),
                          out_dir=str(tmp_path / "jax"), **kw)
    return off, on, jon


def read(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def records_equal(a, b):
    for x, y in zip(a, b, strict=True):
        for k in x:
            if isinstance(x[k], float) and math.isnan(x[k]):
                assert math.isnan(y[k]), (k, x, y)
            else:
                assert x[k] == y[k], (k, x, y)


def test_serve_dedup_fanout_records_one_seat(setup, tmp_path):
    n, distinct = 30, 6
    mix = np.array([i % distinct for i in range(n)])
    off, m, jm = serve_pair(setup, tmp_path, np.zeros(n), mix)
    assert read(m) == read(off) == read(jm)
    sv = m["serve"]
    assert sv["completed"] == n
    assert sv["dedup_coalesced"] > 0 and sv["dedup_groups"] > 0
    assert sv["dedup_fanout_max"] >= 2
    assert sv == jm["serve"]
    records_equal(m["request_records"], jm["request_records"])
    followers = [r for r in m["request_records"]
                 if r["coalesced_into"] is not None]
    assert len(followers) == sv["dedup_coalesced"]
    assert all(r["coalesced_into"] != r["position"] for r in followers)
    # one seat a group: the seated rows are the leaders only
    assert m["engine"]["slots_refilled"] < n
    assert m["engine"]["slots_refilled"] + sv["dedup_coalesced"] >= n


def test_serve_repeats_bytes_equal_and_dispatches_drop(setup, tmp_path):
    n = 30
    mix = np.array([i % 6 for i in range(n)])
    times = poisson_times(n, rate=0.5, seed=3)
    off, m, jm = serve_pair(setup, tmp_path, times, mix)
    assert read(m) == read(off) == read(jm)
    eng = m["engine"]
    assert eng["prefills"] < off["engine"]["prefills"]
    assert eng["cache_hits"] > 0 and eng["prefills_saved"] > 0
    assert eng["cache_hbm_bytes_saved"] > 0
    records_equal(m["request_records"], jm["request_records"])
    for key in ("cache_hits", "prefills", "prefills_saved", "dedup_fanout"):
        assert eng[key] == jm["engine"][key], key


def test_shed_follower_detaches_leader_survives(setup, tmp_path):
    n = 24
    mix = np.array([i % 3 for i in range(n)])
    off, m, jm = serve_pair(setup, tmp_path, np.zeros(n), mix,
                            engine_slots=2, serve_deadline_steps=3)
    sv = m["serve"]
    assert sv["completed"] + sv["shed_deadline"] == n
    assert sv["completed"] > 0
    assert sv == jm["serve"]
    records_equal(m["request_records"], jm["request_records"])
    lines = open(m["output_path"]).read().split("\n")
    done_by_sample = {}
    for r in m["request_records"]:
        if r["status"] == "done":
            done_by_sample.setdefault(int(mix[r["position"]]),
                                      set()).add(lines[r["position"]])
        else:
            assert lines[r["position"]] == ""
    assert all(len(outs) == 1 for outs in done_by_sample.values())


def test_dedup_flood_respects_queue_cap(setup, tmp_path):
    n = 24
    mix = np.zeros(n, dtype=np.int64)        # every request one sample
    cfg = setup["tds"].cfg.replace(prefix_cache=True, serve_queue_cap=4)
    m = serve_split(setup["model"], setup["tds"], cfg,
                    arrival_times=np.zeros(n), out_dir=str(tmp_path),
                    split="train", clock="virtual", request_mix=mix)
    sv = m["serve"]
    assert sv["shed_queue_full"] > 0
    assert sv["completed"] + sv["shed_queue_full"] == n
    assert sv["dedup_coalesced"] <= cfg.serve_queue_cap
    lines = open(m["output_path"]).read().split("\n")
    assert len({lines[r["position"]] for r in m["request_records"]
                if r["status"] == "done"}) == 1


# --------------------------------------------------------------------------
# the LRU itself
# --------------------------------------------------------------------------

def test_prefix_cache_lru_unit():
    cache = prefix_cache.PrefixCache(2)
    p = {"diff": np.arange(4, dtype=np.int16),
         "sub_token": np.arange(3, dtype=np.int16)}
    assert cache.put("a", p) == 0
    assert cache.put("b", p) == 0
    assert cache.contains("a") and cache.take("a")[1] == "hit"  # touch a
    assert cache.put("c", p) == 1          # evicts b, the least recent
    assert not cache.contains("b")
    assert cache.contains("a") and cache.contains("c")
    assert cache.take("zzz") == (None, "miss")
    assert not cache.contains(None)
    assert cache.nbytes > 0
    with pytest.raises(ValueError, match=">= 1"):
        prefix_cache.PrefixCache(0)


def test_prefix_cache_byte_budget():
    p = {"diff": np.arange(64, dtype=np.int16)}      # 128 bytes
    per = prefix_cache.payload_nbytes(p)
    cache = prefix_cache.PrefixCache(100, max_bytes=2 * per)
    assert cache.put("a", p) == 0
    assert cache.put("b", p) == 0
    assert cache.nbytes == 2 * per
    assert cache.put("c", p) == 1          # the byte budget evicts a
    assert not cache.contains("a")
    assert cache.put("c", p) == 0          # a refresh counts once
    assert cache.nbytes == 2 * per
    big = {"diff": np.arange(4096, dtype=np.int16)}  # alone over budget
    assert cache.put("big", big) == 2
    assert cache.contains("big") and len(cache) == 1
    cache.clear()
    assert cache.nbytes == 0
    with pytest.raises(ValueError, match=">= 0"):
        prefix_cache.PrefixCache(2, max_bytes=-1)

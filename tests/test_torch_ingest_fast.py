"""The port's ingest fast path (``fira_tpu_torch/ingest/cache.py`` and the
hooks of ``ingest/service.py``) against the JAX package's on the same
inputs, on the round-trip corpus ``write_extracted_corpus_dir(…, 24,
seed=13)`` at fira-tiny widths. Tolerance: none; every comparison is of
bytes, hex strings, counters or outcomes, which must be equal.

- ``text_digest`` and ``_payload_checksum`` give the JAX package's hex;
- ``IngestCache``: the same operation sequence gives the same outcomes,
  ``summary()`` and LRU order under an entry budget, a byte budget and
  both; a digest in flight coalesces its takers onto one leader, and
  ``abandon`` releases them (both packages, the same script);
- ``HunkMemo`` and ``LexMemo``: a partial hit gives the cold payload bit
  for bit, with the JAX package's ``memo_hits``/``memo_misses``;
- ``ingest_exec=process``: whole-request and parse-stage offload give the
  thread-mode bytes, the worker's memo warms, and the spawned worker has
  not imported torch;
- the ``ingest.cache`` fault site: an injected raise is a miss, an
  injected corrupt read a checksum drop, as in the JAX package;
- ``ingest_request_tasks`` with the cache: a repeat replays the cold
  payload with ``cached: True``, stamps and meters equal to JAX's."""

import threading

import numpy as np
import pytest

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import \
    write_extracted_corpus_dir as jax_write_extracted
from fira_tpu.ingest import cache as jax_cache
from fira_tpu.ingest import difftext as jax_difftext
from fira_tpu.ingest import service as jax_service
from fira_tpu.robust import faults as jax_faults
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.synthetic import write_extracted_corpus_dir
from fira_tpu_torch.ingest import cache, difftext, service
from fira_tpu_torch.robust import faults

N_COMMITS, SEED = 24, 13
KNOBS = dict(batch_size=8, test_batch_size=4, engine_slots=4)


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """The round-trip corpus written by each package, and each package's
    dataset over its own copy."""
    d = str(tmp_path_factory.mktemp("port_corpus"))
    jd = str(tmp_path_factory.mktemp("jax_corpus"))
    corpus = write_extracted_corpus_dir(d, N_COMMITS, seed=SEED)
    jax_write_extracted(jd, N_COMMITS, seed=SEED)
    ds = FiraDataset(d, fira_tiny(**KNOBS))
    jds = JaxDataset(jd, jax_fira_tiny(**KNOBS))
    texts = [difftext.reconstruct_request(corpus.record(int(i)))
             for i in ds.split_indices["train"]]
    return dict(ds=ds, jds=jds, texts=texts)


def wire(host):
    return {k: (np.asarray(v).dtype.str, np.asarray(v).shape,
                np.asarray(v).tobytes())
            for k, v in host.items() if not k.startswith("_")}


def stamps(host):
    """The ``_ingest`` stamps but for the stage seconds."""
    return {k: v for k, v in host["_ingest"].items() if not k.endswith("_s")}


# --------------------------------------------------------------------------
# digests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "", "diff --git a/A.java b/A.java\n", "é ü — 漢字\n", "x" * 10_000])
def test_text_digest_is_jax_hex(text):
    assert cache.text_digest(text) == jax_cache.text_digest(text)


def test_payload_checksum_and_nbytes_are_jax(extracted):
    ds, jds = extracted["ds"], extracted["jds"]
    for text in extracted["texts"][:3]:
        host = service.ingest_request(text, ds.word_vocab,
                                      ds.ast_change_vocab, ds.cfg)
        jhost = jax_service.ingest_request(text, jds.word_vocab,
                                           jds.ast_change_vocab, jds.cfg)
        assert cache._payload_checksum(host) == \
            jax_cache._payload_checksum(jhost)
        assert cache.payload_nbytes(host) == jax_cache.payload_nbytes(jhost)
    # a host-only key is left out, one wire byte is not
    host2 = dict(host, _ingest={"other": 1})
    assert cache._payload_checksum(host2) == cache._payload_checksum(host)
    host2["diff"] = host["diff"].copy()
    host2["diff"].flat[0] += 1
    assert cache._payload_checksum(host2) != cache._payload_checksum(host)


# --------------------------------------------------------------------------
# the result cache
# --------------------------------------------------------------------------

def cache_script(mod, entries, max_bytes, seed=7, n_ops=60):
    """A seeded sequence of takes over 6 digests of varied payload sizes;
    a miss is followed by a put (or, one time in five, an abandon), as
    the task generator follows it. Returns (outcomes, summary, LRU order).
    """
    rng = np.random.default_rng(seed)
    c = mod.IngestCache(entries, max_bytes=max_bytes)
    events = []
    for _ in range(n_ops):
        key = f"d{int(rng.integers(6))}"
        host, outcome = c.take(key)
        events.append((key, outcome))
        if host is None:
            if rng.random() < 0.2:
                c.abandon(key)
                events.append((key, "abandon"))
            else:
                n = 8 * int(rng.integers(1, 12))
                payload = {"diff": np.arange(n, dtype=np.int64),
                           "_ingest": {"lex_s": 0.5, "tag": key}}
                events.append((key, "put", c.put(key, payload)))
        else:
            events.append((key, host["_ingest"]["cached"]))
    return events, c.summary(), list(c._lru)


@pytest.mark.parametrize("entries,max_bytes", [
    (2, 0), (3, 0), (0, 1500), (0, 100), (4, 2000), (0, 0)])
def test_ingest_cache_sequence_equals_jax(entries, max_bytes):
    got = cache_script(cache, entries, max_bytes)
    want = cache_script(jax_cache, entries, max_bytes)
    assert got == want
    summary = got[1]
    if entries:
        assert summary["entries"] <= entries
    assert summary["hits"] > 0 and summary["misses"] > 0
    if entries or max_bytes:
        assert summary["evictions"] > 0


def test_ingest_cache_lru_order_and_budgets_equal_jax():
    """The JAX package's eviction example: capacity two evicts in LRU
    order, a byte budget evicts LRU-first until the bytes fit, and an
    over-budget entry alone still lives."""
    def payload(tag, nbytes=64):
        return {"diff": np.zeros(nbytes // 8, np.int64),
                "_ingest": {"tag": tag}}

    def run(mod):
        c = mod.IngestCache(2)
        events = [("put", t, c.put(t, payload(t))) for t in "abc"]
        events.append(("take_a", c.take("a")[1]))
        c.abandon("a")
        events.append(("take_b", c.take("b")[1]))
        events.append(("put", "d", c.put("d", payload("d"))))
        events.append(("take_c", c.take("c")[1]))
        c.abandon("c")
        events.append(("take_b2", c.take("b")[1]))
        b = mod.IngestCache(0, max_bytes=100)
        b.put("x", payload("x", 64))
        events.append(b.put("y", payload("y", 64)))
        events.append(b.put("big", payload("big", 400)))
        return events, list(c._lru), list(b._lru), c.summary(), b.summary()

    got = run(cache)
    assert got == run(jax_cache)
    assert got[1] == ["d", "b"] and got[2] == ["big"]   # LRU first
    assert got[0][:8] == [("put", "a", 0), ("put", "b", 0), ("put", "c", 1),
                          ("take_a", "miss"), ("take_b", "hit"),
                          ("put", "d", 1), ("take_c", "miss"),
                          ("take_b2", "hit")]
    with pytest.raises(ValueError) as err:
        cache.IngestCache(-1)
    with pytest.raises(ValueError) as jerr:
        jax_cache.IngestCache(-1)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("mod", [cache, jax_cache], ids=["port", "jax"])
def test_ingest_cache_coalesces_inflight_duplicates(mod):
    """A digest taken while its leader computes parks the takers (one
    miss, every follower a hit, ``coalesced`` counted), and a leader that
    abandons wakes its follower to lead (a fresh miss, never a hang). The
    same script and results for both packages."""
    c = mod.IngestCache(8)
    payload = {"diff": np.arange(4, dtype=np.int64)}
    results = []
    # put() runs only once every follower has reached its wait: the
    # leader's Event is swapped for one that signals on wait-entry
    parked = threading.Semaphore(0)

    class SignalingEvent(threading.Event):
        def wait(self, timeout=None):
            parked.release()
            return super().wait(timeout)

    def taker():
        host, outcome = c.take("d")
        results.append((outcome, host is not None))

    assert c.take("d") == (None, "miss")     # this thread leads
    with c._lock:
        c._pending["d"] = SignalingEvent()
    followers = [threading.Thread(target=taker) for _ in range(4)]
    for t in followers:
        t.start()
    for _ in followers:
        assert parked.acquire(timeout=10.0)
    c.put("d", payload)
    for t in followers:
        t.join(10.0)
        assert not t.is_alive()
    assert results == [("hit", True)] * 4
    assert (c.misses, c.hits, c.coalesced) == (1, 4, 4)

    assert c.take("e") == (None, "miss")
    with c._lock:
        c._pending["e"] = SignalingEvent()
    woke = []
    t = threading.Thread(target=lambda: woke.append(c.take("e",
                                                           wait_s=10.0)))
    t.start()
    assert parked.acquire(timeout=10.0)
    c.abandon("e")
    t.join(10.0)
    assert not t.is_alive() and woke == [(None, "miss")]
    c.put("e", payload)
    assert c.summary()["misses"] == 3 and not c._pending


def test_ingest_cache_stress_one_ingest_per_digest():
    """16 threads (more than the cores) take 8 digests 200 times each
    with a short switch interval: each digest is computed exactly once
    (every other take a hit, coalesced or not), and the meters add up;
    a lost update in the leadership map would compute a digest twice."""
    import collections
    import sys
    import time

    c = cache.IngestCache(0)
    computed = collections.Counter()
    lock = threading.Lock()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            d = f"d{int(rng.integers(8))}"
            host, _outcome = c.take(d, wait_s=30.0)
            if host is None:
                with lock:
                    computed[d] += 1
                time.sleep(0.002)       # the ingest the takers wait for
                c.put(d, {"diff": np.arange(4, dtype=np.int64)})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert computed == {f"d{i}": 1 for i in range(8)}
    summary = c.summary()
    assert (summary["misses"], summary["hits"]) == (8, 16 * 200 - 8)
    assert summary["fault_misses"] == summary["integrity_drops"] == 0
    assert not c._pending


@pytest.mark.parametrize("kind", ["raise", "corrupt"])
def test_ingest_cache_fault_outcomes_equal_jax(kind):
    """``ingest.cache``: an injected raise demotes the lookup to a miss
    (entry intact), an injected corrupt read fails the entry's checksum
    and drops it; the stored payload is never scrambled in place."""
    spec = f"ingest.cache:{kind}:1.0:7"

    def run(mod, fmod):
        payload = {"diff": np.arange(8, dtype=np.int64),
                   "sub_token": np.arange(4, dtype=np.int64),
                   "_ingest": {"lex_s": 0.1}}
        inj = fmod.FaultInjector(fmod.parse_fault_specs(spec))
        c = mod.IngestCache(8, faults=inj)
        c.put("d", payload)
        got, outcome = c.take("d", fault_key=3)
        assert payload["diff"].tolist() == list(range(8))
        return got, outcome, "d" in c._lru, c.summary(), inj.summary()

    got = run(cache, faults)
    assert got == run(jax_cache, jax_faults)
    want = {"raise": ("fault_miss", True), "corrupt": ("integrity_drop",
                                                        False)}[kind]
    assert got[0] is None and got[1:3] == want
    assert got[4] == {"ingest.cache": 1}


# --------------------------------------------------------------------------
# the memos
# --------------------------------------------------------------------------

SHARED = ("@@ -1,2 +1,2 @@ class Shared\n"
          "-int count = 1 ;\n"
          "+int count = 2 ;\n")
HEAD = "diff --git a/A.java b/A.java\n--- a/A.java\n+++ b/A.java\n"
D1 = HEAD + SHARED
D2 = (HEAD + SHARED
      + "@@ -9,2 +9,2 @@ class Other\n-int x = 3 ;\n+int y = 4 ;\n")


def test_hunk_memo_partial_hit_bit_exact_like_jax(extracted):
    """Two different diffs sharing a hunk: the second reuses the first's
    parsed chunk (a whole-diff miss with memo hits), its payload is the
    memo-off bytes, and the memo counts are the JAX package's."""
    ds, jds = extracted["ds"], extracted["jds"]
    got, want = [], []
    with cache.IngestExecutor("thread", memo=cache.HunkMemo()) as ex, \
            jax_cache.IngestExecutor("thread",
                                     memo=jax_cache.HunkMemo()) as jex:
        for text in (D1, D2, D2):
            got.append(service.ingest_request(
                text, ds.word_vocab, ds.ast_change_vocab, ds.cfg,
                executor=ex))
            want.append(jax_service.ingest_request(
                text, jds.word_vocab, jds.ast_change_vocab, jds.cfg,
                executor=jex))
    assert [stamps(h) for h in got] == [stamps(h) for h in want]
    assert got[0]["_ingest"]["memo_hits"] == 0
    assert got[1]["_ingest"]["memo_hits"] > 0       # the shared hunk
    assert got[1]["_ingest"]["memo_misses"] > 0     # the new hunk
    assert got[2]["_ingest"]["memo_misses"] == 0
    for text, g, w in zip((D1, D2, D2), got, want):
        cold = service.ingest_request(text, ds.word_vocab,
                                      ds.ast_change_vocab, ds.cfg)
        assert wire(g) == wire(cold) == wire(w)
        assert "memo_hits" not in cold["_ingest"]


def test_lex_memo_tokens_and_counts_equal_jax(extracted):
    """The lexer memo: the bare lexer's request, each distinct line lexed
    once, the JAX package's hit and miss counts."""
    memo, jmemo = cache.LexMemo(), jax_cache.LexMemo()
    texts = [D1, D2, D2] + extracted["texts"][:4]
    for text in texts:
        req = difftext.parse_request(text, lex=memo)
        jreq = jax_difftext.parse_request(text, lex=jmemo)
        assert req == difftext.parse_request(text)
        assert (req.tokens, req.marks) == (jreq.tokens, jreq.marks)
    assert (memo.hits, memo.misses) == (jmemo.hits, jmemo.misses)
    assert memo.hits > 0 and memo.misses > 0
    small = cache.LexMemo(entries=2)
    for text in ("int a ;", "int b ;", "int c ;", "int a ;"):
        small(text)
    assert (small.hits, small.misses, len(small._lru)) == (0, 4, 2)


# --------------------------------------------------------------------------
# the process executor
# --------------------------------------------------------------------------

def test_process_exec_bit_exact_and_worker_imports_no_torch(extracted):
    """One spawned worker: whole-request offload (the serve path) and
    parse-stage offload give the thread-mode bytes and stamps; its own
    memo warms across requests; and the worker has not imported torch,
    even after ingesting (the parent holds a CUDA context on the card)."""
    ds = extracted["ds"]
    texts = extracted["texts"][:3]
    ref = [service.ingest_request(t, ds.word_vocab, ds.ast_change_vocab,
                                  ds.cfg) for t in texts]
    with cache.IngestExecutor("thread", memo=cache.HunkMemo()) as tex:
        inline = [service.ingest_request(t, ds.word_vocab,
                                         ds.ast_change_vocab, ds.cfg,
                                         executor=tex) for t in texts]
    context = (ds.word_vocab, ds.ast_change_vocab, ds.cfg, None)
    with cache.IngestExecutor("process", workers=1, context=context) as ex:
        assert ex.offloads_requests
        whole = [ex.ingest(t) for t in texts]
        again = ex.ingest(texts[0])
        staged = service.ingest_request(texts[1], ds.word_vocab,
                                        ds.ast_change_vocab, ds.cfg,
                                        executor=ex)
        # a function of this module would make the worker import this
        # module (and with it torch and JAX); the builtin eval does not
        has_torch = ex._pool.submit(
            eval, "'torch' in __import__('sys').modules").result()
    assert has_torch is False
    for w, i, r in zip(whole, inline, ref):
        assert wire(w) == wire(i) == wire(r)
        assert stamps(w) == stamps(i)
        assert w["_var"] == r["_var"] and w["_bucket"] == r["_bucket"]
    assert wire(again) == wire(ref[0])
    assert again["_ingest"]["memo_misses"] == 0
    assert again["_ingest"]["memo_hits"] > 0
    assert wire(staged) == wire(ref[1])
    assert staged["_ingest"]["memo_misses"] == 0   # the same worker's memo
    with pytest.raises(RuntimeError, match="needs process mode"):
        cache.IngestExecutor("thread").ingest(texts[0])
    with pytest.raises(ValueError) as err:
        cache.IngestExecutor("fork")
    with pytest.raises(ValueError) as jerr:
        jax_cache.IngestExecutor("fork")
    assert str(err.value) == str(jerr.value)


# --------------------------------------------------------------------------
# the task generator with the fast path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ingest_cache", [True, False])
def test_fast_path_tasks_replay_cached_like_jax(extracted, ingest_cache):
    """``build_fast_path`` + ``ingest_request_tasks`` over [a, b, a]: with
    the cache the repeat replays the cold payload with ``cached: True``
    and the original stage seconds; the stamps, the cache meter and the
    prefix-cache digests equal the JAX package's; without it all three
    are computed and carry no memo stamps."""
    ds, jds = extracted["ds"], extracted["jds"]
    a, b = extracted["texts"][:2]
    knobs = dict(ingest_cache=ingest_cache, prefix_cache=True)
    cfg, jcfg = ds.cfg.replace(**knobs), jds.cfg.replace(**knobs)
    fast = service.build_fast_path(cfg)
    jfast = jax_service.build_fast_path(jcfg)
    try:
        got = [t() for t in service.ingest_request_tasks(
            [a, b, a], cfg, ds.word_vocab, ds.ast_change_vocab, None,
            cache=fast[0], lex=fast[1], executor=fast[2])]
        want = [t() for t in jax_service.ingest_request_tasks(
            [a, b, a], jcfg, jds.word_vocab, jds.ast_change_vocab, None,
            cache=jfast[0], lex=jfast[1], executor=jfast[2])]
    finally:
        for f in (fast, jfast):
            if f[2] is not None:
                f[2].close()
    assert [stamps(h) for h in got] == [stamps(h) for h in want]
    assert [h["_digests"] for h in got] == [h["_digests"] for h in want]
    assert [wire(h) for h in got] == [wire(h) for h in want]
    assert wire(got[0]) == wire(got[2])
    assert got[0]["_digests"] == got[2]["_digests"]
    if ingest_cache:
        assert got[2]["_ingest"]["cached"] is True
        assert got[2]["_ingest"]["lex_s"] == got[0]["_ingest"]["lex_s"]
        assert got[2]["_ingest"]["memo_hits"] == 0
        assert "cached" not in got[0]["_ingest"]
        assert fast[0].summary() == jfast[0].summary()
        assert fast[0].summary()["hits"] == 1
    else:
        assert fast == (None, None, None)
        assert not any("cached" in h["_ingest"] or "memo_hits" in h["_ingest"]
                       for h in got)


@pytest.mark.parametrize("spec", [
    "ingest.parse:raise:0.5:3", "ingest.parse:corrupt:0.5:3",
    "ingest.cache:corrupt:1.0:5", "ingest.cache:raise:1.0:5"])
def test_fault_sites_fire_on_the_tasks_like_jax(extracted, spec):
    """The two ingest sites on the task generator over [a, b, a, b, a]
    (cache on): the same tasks raise, the same payloads are scrambled or
    re-ingested, and the same events fire as in the JAX package."""
    ds, jds = extracted["ds"], extracted["jds"]
    texts = extracted["texts"][:2] * 2 + extracted["texts"][:1]

    def run(svc, fmod, d):
        c = d.cfg.replace(inject_faults=spec)
        inj = fmod.injector_from(c)
        fast = svc.build_fast_path(c, faults=inj)
        out = []
        try:
            for t in svc.ingest_request_tasks(
                    texts, c, d.word_vocab, d.ast_change_vocab, None,
                    faults=inj, cache=fast[0], lex=fast[1],
                    executor=fast[2]):
                try:
                    h = t()
                    out.append((wire(h), stamps(h)))
                except fmod.InjectedFault as e:
                    out.append(str(e))
        finally:
            fast[2].close()
        return out, fast[0].summary(), inj.summary(), \
            dict(inj.fired_keys)

    got = run(service, faults, extracted["ds"])
    want = run(jax_service, jax_faults, extracted["jds"])
    assert got == want
    assert sum(got[2].values()) > 0
    if spec.startswith("ingest.cache"):
        # every repeat re-ingested, never served from a bad read
        assert got[1]["hits"] == 0 and got[1]["misses"] == 2
        clean = [service.ingest_request(t, ds.word_vocab,
                                        ds.ast_change_vocab, ds.cfg)
                 for t in texts]
        assert [w for w, _ in got[0]] == [wire(h) for h in clean]

"""The port's raw-diff ingest (``fira_tpu_torch/ingest``) against the JAX
package's on the same inputs: ``parse_request`` / ``reconstruct_*`` and
the diff-trace I/O, the ``DiffParseError`` messages of malformed diffs,
``ingest_errors`` on a table of bad knobs, and on the round-trip corpus
``write_extracted_corpus_dir(…, 24, seed=13)`` (the same files from both
packages): ``ingest_request`` payloads byte-identical (dtype, shape,
bytes) to the JAX package's and to the port's own ``make_batch`` row,
the ``_ingest`` stamps equal but for the ``*_s`` timings, clip/shed
truncation and the OOV counts, and the bucket assignment under
``decode_tar_buckets``."""

import dataclasses
import os

import numpy as np
import pytest

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data import buckets as jax_buckets
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import generate_corpus as jax_generate_corpus
from fira_tpu.data.synthetic import \
    write_extracted_corpus_dir as jax_write_extracted
from fira_tpu.ingest import difftext as jax_difftext
from fira_tpu.ingest import service as jax_service
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data import buckets
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.synthetic import (generate_corpus,
                                           write_extracted_corpus_dir)
from fira_tpu_torch.ingest import difftext, service

N_COMMITS, SEED = 24, 13

# --------------------------------------------------------------------------
# text front end
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus40():
    corpus = generate_corpus(40, seed=SEED)
    assert corpus.streams == jax_generate_corpus(40, seed=SEED).streams
    return corpus


@pytest.mark.parametrize("part", range(4))
def test_parse_and_reconstruct_equal_jax(corpus40, part):
    for i in range(part * 10, part * 10 + 10):
        rec = corpus40.record(i)
        text = difftext.reconstruct_request(rec)
        assert text == jax_difftext.reconstruct_request(rec)
        assert difftext.reconstruct_diff(rec.diff_tokens, rec.diff_marks) \
            == jax_difftext.reconstruct_diff(rec.diff_tokens, rec.diff_marks)
        got = difftext.parse_request(text)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jax_difftext.parse_request(text))
        assert (got.tokens, got.marks) == (rec.diff_tokens, rec.diff_marks)


MALFORMED = {
    "not_a_diff": "this is not a diff\n",
    "body_before_hunk": "+int x = 1 ;\n",
    "headers_only": "diff --git a/F b/F\n--- a/F\n+++ b/F\n",
    "var_not_json": "#! var: not-json\n@@ -1,1 +1,1 @@\n+int x ;\n",
    "var_not_map": '#! var: ["a"]\n@@ -1,1 +1,1 @@\n+int x ;\n',
    "unknown_meta": "#! color: red\n@@ -1,1 +1,1 @@\n+int x ;\n",
    "empty": "",
    "bad_marker": "@@ -1,1 +1,1 @@\n*int x ;\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_diffs_raise_jax_messages(name):
    with pytest.raises(difftext.DiffParseError) as got:
        difftext.parse_request(MALFORMED[name])
    with pytest.raises(jax_difftext.DiffParseError) as want:
        jax_difftext.parse_request(MALFORMED[name])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tokens,marks", [
    (["<nb>", "<nl>"], [2, 2]), (["<nl>"], [2]), (["x"], [7]),
    (["<nb>", "a"], [2, 2]), (["<nb>", "a", "<nl>"], [2, 3, 2]),
    (["a", "b"], [2])])
def test_reconstruct_rejections_equal_jax(tokens, marks):
    with pytest.raises(ValueError) as got:
        difftext.reconstruct_diff(tokens, marks)
    with pytest.raises(ValueError) as want:
        jax_difftext.reconstruct_diff(tokens, marks)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("raw", [
    # header look-alikes inside a hunk, and two files' sections
    difftext.reconstruct_diff(
        ["x", "=", "1", ";", "--", "count", ";", "++", "n", ";"],
        [2, 2, 2, 2, 1, 1, 1, 3, 3, 3]),
    "diff --git a/A.java b/A.java\n--- a/A.java\n+++ b/A.java\n"
    "@@ -1,1 +1,1 @@ class A\n--- count ;\n"
    "diff --git a/B.java b/B.java\n--- a/B.java\n+++ b/B.java\n"
    "@@ -2,1 +2,1 @@ class B\n+int y ;\n\\ No newline at end of file\n"])
def test_header_lookalikes_parse_like_jax(raw):
    assert dataclasses.asdict(difftext.parse_request(raw)) == \
        dataclasses.asdict(jax_difftext.parse_request(raw))


def test_diff_trace_io_equals_jax(corpus40, tmp_path):
    reqs = [difftext.reconstruct_request(corpus40.record(i))
            for i in range(4)]
    path = difftext.write_diff_trace(str(tmp_path / "port.trace"), reqs)
    jpath = jax_difftext.write_diff_trace(str(tmp_path / "jax.trace"), reqs)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    assert difftext.read_diff_trace(path) == jax_difftext.read_diff_trace(path)
    d = tmp_path / "dir"
    d.mkdir()
    for i, r in enumerate(reqs):
        (d / f"{i:03d}.diff").write_text(r)
    headless = tmp_path / "headless.trace"
    headless.write_text(reqs[0] + "#! request 1\n" + reqs[1])
    for src in (str(d), str(headless)):
        assert difftext.read_diff_trace(src) == \
            jax_difftext.read_diff_trace(src)
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty.trace").write_text("")
    for bad in ("empty", "empty.trace"):
        with pytest.raises(ValueError) as got:
            difftext.read_diff_trace(str(tmp_path / bad))
        with pytest.raises(ValueError) as want:
            jax_difftext.read_diff_trace(str(tmp_path / bad))
        assert str(got.value) == str(want.value)


BAD_KNOBS = [   # (config knobs, keyword arguments, errors expected)
    ({}, {}, 0), ({"ingest_workers": -1}, {}, 1),
    ({"ingest_truncate": "bogus"}, {}, 1),
    ({"ingest_cache_entries": -1}, {}, 1), ({"ingest_cache_bytes": -1}, {}, 1),
    ({"ingest_exec": "fork"}, {}, 1),
    ({"ingest_exec": "fork", "ingest_workers": -2}, {"command": "message"},
     2),
    ({}, {"input_mode": "diffs", "command": "message"}, 0),
    ({}, {"input_mode": "diffs"}, 1),
    ({}, {"input_mode": "diffs", "diff_trace": "/no/such/path"}, 1),
    ({}, {"input_mode": "graphs", "diff_trace": __file__}, 1),
    ({}, {"input_mode": "bogus"}, 1),
]


@pytest.mark.parametrize("i", range(len(BAD_KNOBS)))
def test_ingest_errors_equal_jax(i):
    knobs, kw, n_errors = BAD_KNOBS[i]
    got = service.ingest_errors(fira_tiny(**knobs), **kw)
    assert got == jax_service.ingest_errors(jax_fira_tiny(**knobs), **kw)
    assert len(got) == n_errors


# --------------------------------------------------------------------------
# wire payloads on the round-trip corpus
# --------------------------------------------------------------------------

KNOBS = dict(batch_size=8, test_batch_size=4, engine_slots=4)


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """The round-trip corpus written by each package (the same bytes),
    and each package's dataset over its own copy."""
    d = str(tmp_path_factory.mktemp("port_corpus"))
    jd = str(tmp_path_factory.mktemp("jax_corpus"))
    corpus = write_extracted_corpus_dir(d, N_COMMITS, seed=SEED)
    jax_write_extracted(jd, N_COMMITS, seed=SEED)
    names = sorted(os.listdir(d))
    assert names == sorted(os.listdir(jd)) and "ast.json" in names
    for name in names:
        with open(os.path.join(d, name), "rb") as a, \
                open(os.path.join(jd, name), "rb") as b:
            assert a.read() == b.read(), name
    ds = FiraDataset(d, fira_tiny(**KNOBS))
    jds = JaxDataset(jd, jax_fira_tiny(**KNOBS))
    return corpus, ds, jds


def _wire_equal(got, want, what):
    for k in want:
        if k.startswith("_"):
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes(), f"{what} field {k}"
    assert sorted(k for k in got if not k.startswith("_")) == \
        sorted(k for k in want if not k.startswith("_"))


def _stamps(host):
    return {k: v for k, v in host["_ingest"].items() if not k.endswith("_s")}


def _ingest_both(extracted, text, cfg_knobs=None, table=None, jtable=None,
                 **kw):
    _corpus, ds, jds = extracted
    cfg, jcfg = ds.cfg, jds.cfg
    if cfg_knobs:
        cfg, jcfg = cfg.replace(**cfg_knobs), jcfg.replace(**cfg_knobs)
    got = service.ingest_request(text, ds.word_vocab, ds.ast_change_vocab,
                                 cfg, table=table, **kw)
    want = jax_service.ingest_request(text, jds.word_vocab,
                                      jds.ast_change_vocab, jcfg,
                                      table=jtable, **kw)
    return got, want


@pytest.mark.parametrize("pos", range(8))
def test_payload_bytes_equal_jax_and_corpus_row(extracted, pos):
    corpus, ds, _jds = extracted
    split, idx = ds.splits["train"], ds.split_indices["train"]
    text = difftext.reconstruct_request(corpus.record(int(idx[pos])))
    got, want = _ingest_both(extracted, text)
    _wire_equal(got, want, f"sample {pos} vs JAX")
    _wire_equal(got, make_batch(split, np.asarray([pos]), ds.cfg,
                                batch_size=1), f"sample {pos} vs make_batch")
    assert _stamps(got) == _stamps(want)
    assert got["_ingest"]["truncated"] is None
    assert got["_ingest"]["degraded"] is None
    assert got["_bucket"] == want["_bucket"] == 0
    assert got["_var"] == want["_var"]
    assert set(got["_ingest"]) == set(want["_ingest"])


def test_batch_size_rows_are_padding_like_jax(extracted):
    """The one-shot batch: the request in row 0, test_batch_size - 1 pad
    rows, exactly the JAX package's payload."""
    corpus, ds, _jds = extracted
    text = difftext.reconstruct_request(
        corpus.record(int(ds.split_indices["test"][0])))
    got, want = _ingest_both(extracted, text, batch_size=4)
    _wire_equal(got, want, "test_batch_size rows")
    assert got["valid"].tolist() == [True, False, False, False]
    assert got["_var"] == want["_var"] and len(got["_var"]) == 4


OOV_DIFF = (
    "diff --git a/src/Foo.java b/src/Foo.java\n"
    "--- a/src/Foo.java\n+++ b/src/Foo.java\n"
    "@@ -10,4 +10,4 @@ class WeirdNewClazz\n"
    " public void frobnicateWidget ( ) {\n"
    "-int legacyCounterXyz = 42 ;\n"
    "+for ( int qq = 0 ; qq < 9 ; qq ++ ) { zorp ( qq ) ; }\n"
    " }\n")


def _big_diff(n):
    body = "".join(f"+int var{i} = {i} ;\n" for i in range(n))
    return ("diff --git a/F.java b/F.java\n--- a/F.java\n+++ b/F.java\n"
            "@@ -1,1 +1,1 @@ class Big\n" + body)


def test_oov_counts_equal_jax(extracted):
    got, want = _ingest_both(extracted, OOV_DIFF)
    _wire_equal(got, want, "OOV diff")
    assert _stamps(got) == _stamps(want)
    assert got["_ingest"]["oov_words"] > 0


@pytest.mark.parametrize("mode", ["clip", "shed"])
def test_truncation_policy_equals_jax(extracted, mode):
    """An over-budget diff: clipped with the same record and payload, or
    shed with the same message; and a cut inside a header block."""
    raw = _big_diff(extracted[1].cfg.sou_len)
    if mode == "shed":
        with pytest.raises(service.IngestError) as got:
            _ingest_both(extracted, raw, {"ingest_truncate": "shed"})
        with pytest.raises(jax_service.IngestError) as want:
            jax_service.ingest_request(
                raw, extracted[2].word_vocab, extracted[2].ast_change_vocab,
                extracted[2].cfg.replace(ingest_truncate="shed"))
        assert str(got.value) == str(want.value)
        return
    got, want = _ingest_both(extracted, raw)
    _wire_equal(got, want, "clipped diff")
    assert _stamps(got) == _stamps(want)
    assert got["_ingest"]["truncated"]["diff_tokens_dropped"] > 0
    cfg = extracted[1].cfg
    req = difftext.parse_request(raw)
    n = cfg.sou_len - 4
    cut = dataclasses.replace(
        req, tokens=req.tokens[:n] + ["<nb>", "class", "X", "<nl>"],
        marks=req.marks[:n] + [2, 2, 2, 2])
    rec, info = service.ingest_record(cut, cfg)
    jrec, jinfo = jax_service.ingest_record(
        jax_difftext.DiffRequest(**dataclasses.asdict(cut)),
        extracted[2].cfg)
    assert dataclasses.asdict(rec) == dataclasses.asdict(jrec)
    assert info == jinfo and info["truncated"]["diff_tokens_dropped"] >= 4


def test_sub_token_and_node_clipping_equals_jax(extracted):
    """A diff whose sub-token and AST node needs exceed tiny's budgets:
    the same clip records and payload; under shed the same message."""
    names = " ".join(f"fooBar{i}Baz" for i in range(14))
    raw = ("@@ -1,1 +1,1 @@\n"
           f"-int x = call ( {names.replace(' ', ' , ')} ) ;\n"
           f"+int y = call ( {names.replace(' ', ' + ')} , 1 ) ;\n")
    got, want = _ingest_both(extracted, raw)
    _wire_equal(got, want, "clipped sub-tokens")
    assert _stamps(got) == _stamps(want)
    assert set(got["_ingest"]["truncated"]) >= {"sub_tokens_dropped"}
    with pytest.raises(service.IngestError) as err:
        _ingest_both(extracted, raw, {"ingest_truncate": "shed"})
    with pytest.raises(jax_service.IngestError) as jerr:
        jax_service.ingest_request(
            raw, extracted[2].word_vocab, extracted[2].ast_change_vocab,
            extracted[2].cfg.replace(ingest_truncate="shed"))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("tar_buckets", [False, True])
def test_bucket_assignment_equals_jax(extracted, tar_buckets):
    corpus, ds, _jds = extracted
    knobs = dict(buckets=((16, 400, 4), (16, 400, 12)),
                 decode_tar_buckets=tar_buckets)
    cfg = ds.cfg.replace(**knobs)
    table = buckets.decode_table(cfg)
    jtable = jax_buckets.decode_table(extracted[2].cfg.replace(**knobs))
    assert [tuple(g) for g in table] == [tuple(g) for g in jtable]
    idx = ds.split_indices["train"]
    seen = set()
    for pos in range(8):
        text = difftext.reconstruct_request(corpus.record(int(idx[pos])))
        bare = "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("#!")) + "\n"
        for t in (text, bare):
            got, want = _ingest_both(extracted, t, knobs, table=table,
                                     jtable=jtable)
            assert got["_bucket"] == want["_bucket"]
            _wire_equal(got, want, f"sample {pos} bucketed")
            seen.add(got["_bucket"])
            if tar_buckets and t is bare:
                # a diff with no reference reserves the full tar budget
                assert table[got["_bucket"]].tar_len == cfg.tar_len
    assert len(seen) > 1, "the table must split the samples"

"""The port's preprocessing (``fira_tpu_torch/preprocess``) against the
JAX package's on the same inputs: the native astdiff library (``tokenize``,
``parse_json``, ``diff_lines`` on every input of tests/test_astdiff.py and
tests/test_astdiff_coverage.py and on seeded random sources; its build
raced from three processes), the hunk FSM and the graph extraction
(dataclass fields and error messages, on the inputs of tests/test_fsm.py
and tests/test_extract.py, the streams of ``generate_corpus(40)`` and the
reference's commit-70 case), ``process_commits`` streams (JSON bytes), and
``run_pipeline`` / ``cli preprocess`` output files, byte for byte, with the
spawned worker pool."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fira_tpu import cli as jax_cli
from fira_tpu.data.synthetic import generate_corpus
from fira_tpu.preprocess import astdiff_binding as jax_ad
from fira_tpu.preprocess import extract as jax_extract
from fira_tpu.preprocess import fsm as jax_fsm
from fira_tpu.preprocess import pipeline as jax_pipeline
from fira_tpu_torch import cli
from fira_tpu_torch.preprocess import astdiff_binding as ad
from fira_tpu_torch.preprocess import extract, fsm, pipeline
from scripts.astdiff_coverage import (CONTEXTUAL_IDENT_CASES, DEGRADE_CASES,
                                      JDT316_CASES, POST_JAVA13_CASES,
                                      one_token_edit)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------------------------
# astdiff
# --------------------------------------------------------------------------

OLD_SRC = """
public class Foo {
    private int count;
    public int getCount() { return count; }
    public void reset() { count = 0; }
}
"""

NEW_SRC = """
public class Foo {
    private int count;
    public int getCount() { return this.count; }
    public void reset(int base) { count = base; }
}
"""

# the sources of tests/test_astdiff.py, deep nesting included
ASTDIFF_CASES = {
    "old_src": OLD_SRC,
    "new_src": NEW_SRC,
    "null_this": "class A { Object f() { if (this == null) return null; "
                 "return this; } }",
    "garbage": "%%% not java @@@ ((((",
    "qualified_super": "class A extends B { int y; "
                       "int f() { return A.super.g() + A.super.y; } }",
    "tokenize": "int x = foo(1, \"s\");",
    "literal": 'class A { String s = "a"; }',
    "literal_ws": 'class A { String s = "a b"; }',
    "rename_old": "class A { int foo() { return 1; } }",
    "rename_new": "class A { int bar() { return 1; } }",
    "insert_old": "class A { int x; }",
    "insert_new": "class A { int x; int y; }",
    "deep_paren": "class A { int x = " + "(" * 20000 + "1" + ")" * 20000
                  + "; }",
    "deep_block": "class A { void f() " + "{" * 20000 + "}" * 20000 + " }",
    "deep_class": "class A { " + "class B { " * 20000 + "}" * 20000 + " }",
    "deep_array": "class A { int[] x = " + "{" * 20000 + "1" + "}" * 20000
                  + "; }",
    "deep_annotation": "@X(" * 20000 + "1" + ")" * 20000 + " class A { }",
    "deep_enum": "enum E { ; " * 20000 + "}" * 20000,
    "deep_assign": "class A { void f() { x = " + "x = " * 100000 + "1; } }",
    "deep_ternary": "class A { int x = " + "1 ? 1 : " * 100000 + "1; }",
    "bounded_nesting": "class A { int x = " + "(" * 50 + "1" + ")" * 50
                       + "; }",
}
ASTDIFF_CASES.update({f"coverage_{k}": v for k, v in {
    **JDT316_CASES, **POST_JAVA13_CASES, **CONTEXTUAL_IDENT_CASES,
    **DEGRADE_CASES}.items()})
# (old, new) pairs of tests/test_astdiff.py's diff contract
DIFF_PAIRS = [("old_src", "new_src"), ("old_src", "old_src"),
              ("literal", "literal_ws"), ("rename_old", "rename_new"),
              ("insert_old", "insert_new"), ("insert_new", "insert_old")]


def _edit(src: str) -> str:
    """``one_token_edit``, or for text with no editable token a suffix."""
    try:
        return one_token_edit(src)
    except AssertionError:
        return src + " x"


def _same_library_outputs(src: str, other: str) -> None:
    assert ad.tokenize(src) == jax_ad.tokenize(src)
    assert ad.parse_json(src) == jax_ad.parse_json(src)
    assert ad.diff_lines(src, other) == jax_ad.diff_lines(src, other)


@pytest.mark.parametrize("name", sorted(ASTDIFF_CASES))
def test_astdiff_equals_jax(name):
    src = ASTDIFF_CASES[name]
    _same_library_outputs(src, _edit(src))


@pytest.mark.parametrize("old,new", DIFF_PAIRS)
def test_astdiff_diff_pairs_equal_jax(old, new):
    a, b = ASTDIFF_CASES[old], ASTDIFF_CASES[new]
    got = ad.diff_lines(a, b)
    assert got and got == jax_ad.diff_lines(a, b)


_SOUP = ("int", "x", "y", "=", "(", ")", "{", "}", ";", "+", "if", "else",
         "return", "new", "class", "public", "void", "1", '"s"', ".", "<",
         ">", "[", "]", ",", "?", ":", "->", "@", "Override", "'c'",
         "/* c */", "0x1F", "3.5f", "this", "null", "for", "while", "try",
         "catch", "switch", "case", "default", "static", "final", "List")
_IDENTS = ("a", "b", "count", "getX", "list", "Foo", "bar_baz", "i", "$v")


def random_sources(seed: int, n: int = 12):
    """Token soups (most of which do not parse) and templated programs
    with random names and expressions."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2:
            out.append(" ".join(rng.choice(_SOUP,
                                           size=int(rng.integers(1, 60)))))
            continue
        name, arg, other = rng.choice(_IDENTS, size=3)
        expr = " ".join(rng.choice([arg, other, "1", "+", "*", "-"],
                                   size=2 * int(rng.integers(1, 6)) - 1))
        out.append(f"class C{i} {{ int {name}(int {arg}) {{ "
                   f"int {other} = {expr}; "
                   f"if ({arg} > {other}) {{ return {arg}; }} "
                   f"return {other} + {i}; }} }}")
    return out


@pytest.mark.parametrize("seed", range(6))
def test_astdiff_equals_jax_on_random_sources(seed):
    srcs = random_sources(seed)
    for src, other in zip(srcs, srcs[1:] + srcs[:1]):
        _same_library_outputs(src, other)
        _same_library_outputs(src, _edit(src))


def _code_lines(path):
    """A C++ source's lines with its whole-line ``//`` comments left out."""
    with open(path) as f:
        return [ln for ln in f if not ln.lstrip().startswith("//")]


@pytest.mark.parametrize("name", ad.HEADERS + ad.UNITS)
def test_astdiff_sources_equal_jax_apart_from_comments(name):
    """The port's C++ sources are the JAX package's: only the header
    comments differ (they name no absolute path in the port)."""
    jax_src = os.path.join(os.path.dirname(jax_ad.__file__), "astdiff", name)
    assert _code_lines(ad.SRC_DIR / name) == _code_lines(jax_src)


def test_astdiff_cli_binary_equals_library(tmp_path):
    a, b = tmp_path / "A.java", tmp_path / "B.java"
    a.write_text(OLD_SRC)
    b.write_text(NEW_SRC)
    cli_bin = str(ad.cli_path())
    out = subprocess.run([cli_bin, "parse", str(a)], capture_output=True,
                         text=True, check=True)
    assert json.loads(out.stdout) == jax_ad.parse_json(OLD_SRC)
    out = subprocess.run([cli_bin, "diff", str(a), str(b)],
                         capture_output=True, text=True, check=True)
    got = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert got == jax_ad.diff_lines(OLD_SRC, NEW_SRC)


_BUILD_PROBE = r"""
import os, sys
from pathlib import Path
from fira_tpu_torch.preprocess import astdiff_binding as ad
ad.BUILD_DIR = Path(sys.argv[1])
lib = ad.load()
path = ad.build()
toks = ad.take(lib, lib.astdiff_tokenize(b"int x = 1;"))
print(path, os.stat(path).st_ino, toks.split())
"""


def test_concurrent_builds_load_one_library(tmp_path, monkeypatch):
    """Three processes build into one empty directory at once: the file
    lock lets one compile, the others wait and load what it renamed into
    place. One library and one CLI binary remain, no temporary file."""
    d = str(tmp_path / "astdiff")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE, d],
                              cwd=REPO_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1, outs
    assert outs[0].endswith("['int', 'x', '=', '1', ';']")
    monkeypatch.setattr(ad, "BUILD_DIR", Path(d))
    lib, cli_bin = ad.artifact_paths()
    assert sorted(os.listdir(d)) == sorted(
        [".astdiff.lock", lib.name, cli_bin.name])


def test_missing_compiler_raises_named_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    monkeypatch.setattr(ad, "BUILD_DIR", tmp_path / "none")
    with pytest.raises(ad.AstdiffBuildError, match="no-such-compiler-xyz"):
        ad.build()


def test_import_builds_nothing(tmp_path):
    """Importing the binding (as every module of the package is imported
    by tests/test_torch_imports.py) compiles and loads nothing."""
    probe = ("import sys; from fira_tpu_torch.preprocess import "
             "astdiff_binding as ad; print(ad._lib is None, "
             "any('libastdiff' in m for m in open('/proc/self/maps')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO_ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["True", "False"]


# --------------------------------------------------------------------------
# fsm and extract
# --------------------------------------------------------------------------

def _split(tokens_marks):
    return [t for t, _ in tokens_marks], [m for _, m in tokens_marks]


# the (tokens, marks) inputs of tests/test_fsm.py, malformed ones included
FSM_CASES = {
    "header_block": _split([("<nb>", 2), ("class", 2), ("A", 2), ("<nl>", 2),
                            ("x", 2), (";", 2)]),
    "delete_add_runs": _split([("a", 2), ("b", 1), ("c", 1), ("d", 2),
                               ("e", 3)]),
    "update_pair": _split([("x", 1), ("y", 3), ("z", 2)]),
    "delete_flushed": _split([("x", 1), ("c", 2), ("y", 3)]),
    "interleaved": _split([("d1", 1), ("a1", 3), ("d2", 1), ("a2", 3)]),
    "update_at_nb": _split([("d", 1), ("a", 3), ("<nb>", 2), ("h", 2),
                            ("<nl>", 2)]),
    "update_at_eos": _split([("d", 1), ("a", 3)]),
    "add_then_delete": _split([("a", 3), ("d", 1)]),
    "nb_non_context": _split([("<nb>", 2), ("class", 1), ("<nl>", 2)]),
    "nb_bad_mark": _split([("<nb>", 3), ("<nl>", 2)]),
    "nb_unclosed": _split([("<nb>", 2), ("class", 2)]),
    "flatten": (["<nb>", "f", "<nl>", "k", "d1", "d2", "a1", "c", "x", "y"],
                [2, 2, 2, 2, 1, 1, 3, 2, 3, 3]),
    "length_mismatch": (["a"], [1, 2]),
    "mark_zero": (["x", "y"], [0, 2]),
    "mark_four": (["x", "y"], [2, 4]),
    "extract_commit": (["<nb>", "file", "<nl>", "int", "x", "=", "1", ";",
                        "int", "y", "=", "1", ";", "return", ";"],
                       [2, 2, 2] + [1] * 5 + [3] * 5 + [2, 2]),
    "all_context": (["<nb>", "f", "<nl>", "return", ";"], [2] * 5),
}


def _outcome(fn, *args, **kw):
    """A call's result, or its error's type name and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:   # the error itself is what is compared
        return ("raised", type(e).__name__, str(e))


def _commit_outcome(mod, fsm_mod, tokens, marks, commit_index=None):
    def run():
        chunks, types = fsm_mod.split_hunks(tokens, marks)
        flat = fsm_mod.flatten_chunks(chunks, types)
        g = mod.extract_commit(chunks, types, tokens,
                               commit_index=commit_index)
        return chunks, types, flat, dataclasses.asdict(g)
    return _outcome(run)


@pytest.mark.parametrize("name", sorted(FSM_CASES))
def test_fsm_and_extract_equal_jax(name):
    tokens, marks = FSM_CASES[name]
    got = _commit_outcome(extract, fsm, tokens, marks)
    assert got == _commit_outcome(jax_extract, jax_fsm, tokens, marks)
    assert fsm.NB == jax_fsm.NB and fsm.NL == jax_fsm.NL


# the fragments of tests/test_extract.py
FRAGMENTS = [
    ["}", "a"], ["if", "(", "x", ")", "{", "y", ";"], ["a", ";", "}", "}"],
    ["{", "a", ";", "}"], ["x", "=", "1", ";"],
    ["public", "int", "f", "(", ")", "{", "return", "1", ";", "}"],
    ["public", "void", "g", "(", ")"], ["private", "int", "x", "=", "1", ";"],
    ["public", "class", "A", "{", "}"], ["import", "a", ".", "b", ";"],
    ["<nb>", "x", "=", "1", ";", "COMMENT", "<nl>"], ["COMMENT", "<nl>"],
    ["if", "(", "x", ")"], ["x", "=", "compute", "(", "y", ")", ";"],
    ["{", "y", "++", ";", "}"],
    ["@", "Override", "public", "void", "g", "(", ")", "{", "}"],
    ["x", "=", "x", "+", "x", ";"],
    ["foo", "(", "foo", "(", "bar", ")", ")", ";"],
    ["int", "r", "=", "switch", "(", "x", ")", "{", "case", "1", "->", "2",
     ";", "default", "->", "3", ";", "}", ";"],
    ["boolean", "b", "=", "o", "instanceof", "String", "s", ";"],
]
UPDATE_PAIRS = [
    (["x", "=", "compute", "(", ")", ";"], ["y", "=", "compute", "(", ")",
                                            ";"]),
    (["x", "=", "1", ";"], ["x", "=", "1", ";", "y", "=", "2", ";"]),
    (["COMMENT"], ["x", "=", "1", ";"]),
    (["x", "=", "compute", "(", ")", ";"], ["z", "=", "compute", "(", "1",
                                            ")", ";"]),
    (FRAGMENTS[18], FRAGMENTS[18][:11] + ["9"] + FRAGMENTS[18][12:]),
]


@pytest.mark.parametrize("i", range(len(FRAGMENTS)))
def test_fragment_extraction_equals_jax(i):
    toks = FRAGMENTS[i]
    for fn in ("balance_brackets", "reconstruct_java", "parse_fragment",
               "normal_chunk_edges"):
        got = _outcome(getattr(extract, fn), toks)
        want = _outcome(getattr(jax_extract, fn), toks)
        if got[0] == "ok" and dataclasses.is_dataclass(got[1]):
            got = ("ok", dataclasses.asdict(got[1]))
            want = ("ok", dataclasses.asdict(want[1]))
        elif fn == "parse_fragment" and got[0] == "ok":
            got = ("ok", got[1][0], dataclasses.asdict(got[1][1]))
            want = ("ok", want[1][0], dataclasses.asdict(want[1][1]))
        assert got == want, fn


@pytest.mark.parametrize("i", range(len(UPDATE_PAIRS)))
def test_update_chunk_equals_jax(i):
    old, new = UPDATE_PAIRS[i]
    got = dataclasses.asdict(extract.update_chunk_edges(old, new))
    assert got == dataclasses.asdict(jax_extract.update_chunk_edges(old, new))


def test_classify_actions_errors_equal_jax():
    for lines in (["Bogus line"], ["Update Foo(1) to x"],
                  ["Match SimpleName: a(1) to SimpleName: b(2)",
                   "Update SimpleName: a(1) to c"]):
        assert _outcome(extract.classify_actions, lines)[1:] == \
            _outcome(jax_extract.classify_actions, lines)[1:]


def test_commit_70_special_case_equals_jax():
    """The reference maps commit 70's first 'nextParent' leaf to the
    'nextParent:' token; both packages keep that, and nowhere else."""
    tokens = ["<nb>", "f", "<nl>", "nextParent:", "x", "=", "nextParent",
              ";", "y", "=", "nextParent", ";"]
    marks = [2, 2, 2] + [1] * 5 + [3] * 4
    at70 = _commit_outcome(extract, fsm, tokens, marks, commit_index=70)
    other = _commit_outcome(extract, fsm, tokens, marks, commit_index=71)
    assert at70[0] == "ok" and at70 != other
    assert at70 == _commit_outcome(jax_extract, jax_fsm, tokens, marks,
                                   commit_index=70)
    assert other == _commit_outcome(jax_extract, jax_fsm, tokens, marks,
                                    commit_index=71)


@pytest.fixture(scope="module")
def corpus40():
    return generate_corpus(40, seed=7).streams


@pytest.mark.parametrize("part", range(4))
def test_generate_corpus_commits_equal_jax(corpus40, part):
    for m in range(part * 10, part * 10 + 10):
        tokens, marks = corpus40["difftoken"][m], corpus40["diffmark"][m]
        got = _commit_outcome(extract, fsm, tokens, marks, commit_index=m)
        assert got[0] == "ok"
        assert got == _commit_outcome(jax_extract, jax_fsm, tokens, marks,
                                      commit_index=m)


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------

def test_split_sub_tokens_and_diffatt_equal_jax(corpus40):
    for tok in ("doWork", "max_value", "HTTPServer", "return", ";", "<nb>",
                "STRING0", "NUMBER3", "getHTTPResponseCode", "snake_caseMix",
                "A_B", "$x", "a$b"):
        assert pipeline.split_sub_tokens(tok) == \
            jax_pipeline.split_sub_tokens(tok)
    assert pipeline.derive_diffatt(corpus40["difftoken"]) == \
        jax_pipeline.derive_diffatt(corpus40["difftoken"])


@pytest.mark.parametrize("offset", [0, 60])
def test_process_commits_streams_equal_jax(corpus40, offset):
    """Streams and error records, JSON bytes; offset 60 puts commit 10 at
    the reference's corpus index 70, and commit 3's marks are broken so
    one commit degrades."""
    marks = [list(m) for m in corpus40["diffmark"]]
    marks[3] = [9] * len(marks[3])
    args = (corpus40["difftoken"], marks, 0, 40)
    got = pipeline.process_commits(*args, index_offset=offset)
    want = jax_pipeline.process_commits(*args, index_offset=offset)
    assert json.dumps(got).encode() == json.dumps(want).encode()
    assert len(got[1]) == 1 and got[1][0]["commit"] == 3 + offset


def _raw_corpus_dir(d: str) -> str:
    """tests/test_pipeline.py's raw corpus: an update hunk, a pure
    addition, all-context."""
    t0 = (["<nb>", "Foo.java", "<nl>"]
          + ["int", "x", "=", "compute", "(", ")", ";"]
          + ["int", "y", "=", "compute", "(", ")", ";"] + ["return", ";"])
    m0 = [2, 2, 2] + [1] * 7 + [3] * 7 + [2, 2]
    t1 = (["<nb>", "Bar.java", "<nl>"]
          + ["public", "void", "doWork", "(", ")", "{", "}"])
    m1 = [2, 2, 2] + [3] * 7
    t2 = ["<nb>", "Baz.java", "<nl>", "return", ";"]
    commits = [(t0, m0, ["rename", "variable"]),
               (t1, m1, ["add", "doWork", "method"]),
               (t2, [2] * 5, ["noop"])]
    os.makedirs(d)
    for name, col in (("difftoken", 0), ("diffmark", 1), ("msg", 2)):
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump([c[col] for c in commits], f)
    with open(os.path.join(d, "variable.json"), "w") as f:
        json.dump([{} for _ in commits], f)
    return d


OUTPUT_FILES = [f"{s}.json" for s in pipeline.GRAPH_STREAMS] + [
    "diffatt.json", "word_vocab.json", "ast_change_vocab.json"]


def _files(d):
    out = {}
    for name in OUTPUT_FILES:
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_run_pipeline_files_equal_jax(tmp_path):
    port = _raw_corpus_dir(str(tmp_path / "port"))
    jax_dir = _raw_corpus_dir(str(tmp_path / "jax"))
    got = pipeline.run_pipeline(port, shard_size=2, num_procs=2)
    want = jax_pipeline.run_pipeline(jax_dir, shard_size=2, num_procs=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_shards == 2 and got.n_errors == 0
    assert _files(port) == _files(jax_dir)
    # an idempotent re-run skips both shards, as the JAX package's does
    again = pipeline.run_pipeline(port, shard_size=2, num_procs=1)
    assert again.skipped_shards == 2


def test_cli_preprocess_equals_jax(tmp_path, capsys):
    """``cli preprocess`` of both packages on the same raw corpus: the
    same files byte for byte and the same report, the port's through two
    spawned workers; no device is touched (``--device cuda`` is the
    default and this machine has no card)."""
    port = _raw_corpus_dir(str(tmp_path / "port"))
    jax_dir = _raw_corpus_dir(str(tmp_path / "jax"))
    assert cli.main(["preprocess", "--data-dir", port, "--shard-size", "2",
                     "--num-procs", "2"]) == 0
    port_out = capsys.readouterr().out
    assert jax_cli.main(["preprocess", "--data-dir", jax_dir,
                         "--shard-size", "2", "--num-procs", "1"]) == 0
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert "3 commits, 2 shards (0 already done), 0 degraded" in port_out
    assert _files(port) == _files(jax_dir)

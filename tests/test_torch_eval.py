"""The port's paper metrics (``fira_tpu_torch.eval``) against the JAX
package's (``fira_tpu.eval``): the same floats, exactly, on the in-repo
decode outputs ``fullscale/OUTPUT`` (7,661 lines) and ``rehearsal/OUTPUT``,
METEOR on its native path (no wordnet) too, the human-evaluation
aggregation on a small rater CSV, and the metric CLI's output."""

import contextlib
import importlib
import io
import os
import subprocess
import sys

import pytest

from fira_tpu import eval as jax_eval
from fira_tpu.eval import cli as jax_cli
from fira_tpu.eval import human_eval as jax_human_eval
from fira_tpu_torch import eval as port_eval
from fira_tpu_torch.eval import cli as port_cli
from fira_tpu_torch.eval import human_eval as port_human_eval

# the packages export the function ``meteor`` under the module's name
jax_meteor = importlib.import_module("fira_tpu.eval.meteor")
port_meteor = importlib.import_module("fira_tpu_torch.eval.meteor")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = ("fullscale/OUTPUT", "rehearsal/OUTPUT")
METRICS = ("bnorm_bleu_files", "penalty_bleu_files", "rouge_l_files",
           "meteor_files")
# the JAX package's values on fullscale/OUTPUT
FULLSCALE = {"bnorm_bleu_files": 16.248159003611445,
             "penalty_bleu_files": 18.221180691718946,
             "rouge_l_files": 17.879219215859358}


def _paths(pair):
    d = os.path.join(REPO_ROOT, pair)
    return os.path.join(d, "output_fira"), os.path.join(d, "ground_truth")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("pair", PAIRS)
def test_metric_equals_jax(pair, metric):
    hyp, ref = _paths(pair)
    got = getattr(port_eval, metric)(hyp, ref)
    want = getattr(jax_eval, metric)(hyp, ref)
    assert isinstance(got, float)
    assert got == want
    if pair == "fullscale/OUTPUT" and metric in FULLSCALE:
        assert got == FULLSCALE[metric]


def test_line_functions_equal_jax():
    hyp, ref = _paths("rehearsal/OUTPUT")
    with open(hyp) as h, open(ref) as r:
        hyps, refs = h.readlines(), r.readlines()
    for name in ("bnorm_bleu", "penalty_bleu", "meteor"):
        assert getattr(port_eval, name)(hyps, refs) == \
            getattr(jax_eval, name)(hyps, refs), name
    assert port_eval.rouge_l(hyps, refs) == jax_eval.rouge_l(hyps, refs)
    # the in-loop sentence BLEU, the copy both packages gate on
    for a, b in zip(hyps[:50], refs[:50]):
        assert port_eval.nltk_sentence_bleu([b.split()], a.split()) == \
            jax_eval.nltk_sentence_bleu([b.split()], a.split())


def test_meteor_native_path_equals_jax():
    """The native exact+stem alignment (the path taken without wordnet),
    line by line, whatever this host's NLTK data."""
    hyp, ref = _paths("rehearsal/OUTPUT")
    with open(hyp) as h, open(ref) as r:
        pairs = list(zip(h.read().split("\n"), r.read().split("\n")))
    got = [port_meteor._native_single(r.split(), h.split()) for h, r in pairs]
    want = [jax_meteor._native_single(r.split(), h.split()) for h, r in pairs]
    assert got == want
    assert any(g > 0 for g in got)


def test_human_eval_equals_jax(tmp_path):
    rows = [(3, 2, 0), (4, 1, 1), (0, 4, 2), (2, 2, 3)]
    for rater, shift in ((1, 0), (2, 1)):
        with open(tmp_path / f"scores_{rater}.csv", "w",
                  encoding="utf-8-sig") as f:
            f.write("id,approach1,approach2,approach3\n")
            for i, (a, b, c) in enumerate(rows):
                f.write(f"{i},{a},{(b + shift) % 5},{c}\n")
    got = port_human_eval.aggregate(str(tmp_path))
    assert got == jax_human_eval.aggregate(str(tmp_path))
    assert got["FIRA"]["n"] == 8


def _stdout(main, argv, stdin_path=None):
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        if stdin_path is not None:
            f = stack.enter_context(open(stdin_path))
            stack.enter_context(_swap_stdin(f))
        stack.enter_context(contextlib.redirect_stdout(buf))
        assert main(argv) == 0
    return buf.getvalue()


@contextlib.contextmanager
def _swap_stdin(f):
    old, sys.stdin = sys.stdin, f
    try:
        yield
    finally:
        sys.stdin = old


@pytest.mark.parametrize("cmd", ("bnorm", "penalty", "rouge", "meteor"))
def test_cli_prints_what_jax_cli_prints(cmd):
    hyp, ref = _paths("rehearsal/OUTPUT")
    if cmd in ("bnorm", "penalty"):
        argv, stdin = [cmd, ref], hyp
    else:
        argv, stdin = [cmd, "-r", ref, "-g", hyp], None
    got = _stdout(port_cli.main, argv, stdin)
    assert got == _stdout(jax_cli.main, argv, stdin)
    assert float(got) > 0


def test_cli_runs_as_a_module():
    hyp, ref = _paths("fullscale/OUTPUT")
    with open(hyp) as f:
        proc = subprocess.run(
            [sys.executable, "-m", "fira_tpu_torch.eval.cli", "bnorm", ref],
            stdin=f, capture_output=True, text=True, cwd=REPO_ROOT,
            timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == repr(FULLSCALE["bnorm_bleu_files"])

"""``serve_diffs`` and ``cli serve --input diffs`` of the port against the
JAX package's ``serve_diffs`` and the port's own graphs path, on the
round-trip corpus ``write_extracted_corpus_dir(…, 24, seed=13)`` at
fira-tiny widths with the same weights (``convert.params_from_flax``),
under the virtual clock. Tolerance: none; output files are compared as
bytes, request records field for field (the ingest stage seconds, which
are wall time, left out) and the ``serve`` summaries key for key.

- raw-diff serving writes the bytes of the JAX package's and of the
  port's ``serve_split`` on the corpus graphs, with the ingest cache on
  and off and the parse stage on threads and on a spawned process pool;
- a trace holding every diff twice hits the result cache, each line its
  first pass's line, as in the JAX package;
- malformed diffs are shed at the same positions with the JAX package's
  reasons, every other line unchanged;
- the ``ingest.parse`` and ``ingest.cache`` fault sites fire at the JAX
  package's events with its records;
- ``cli serve --input diffs`` writes the bytes of ``--input graphs``, and
  bad ingest knobs exit 2 with the JAX package's messages."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import \
    write_extracted_corpus_dir as jax_write_extracted
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.ingest import service as jax_service
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.data.synthetic import write_extracted_corpus_dir
from fira_tpu_torch.ingest import difftext, service
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import faults
from fira_tpu_torch.serve import arrivals, serve_split

N_COMMITS, SEED = 24, 13
# one ingest worker: requests are ingested in arrival order, so the hunk
# memo's per-request counts do not depend on the thread schedule
KNOBS = dict(batch_size=8, test_batch_size=4, engine_slots=4,
             decode_engine=True, prefix_cache=True, ingest_workers=1)
# the ingest summary's wall-time keys
TIMED = ("mean_lex_s", "mean_parse_s", "mean_assemble_s", "p50_total_s",
         "p99_total_s", "stall_s", "stall_frac")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The round-trip corpus from each package, seeded JAX weights biased
    toward <eos> and the port's model on them, the train split's diffs and
    a Poisson trace over them (rate 0.7, seed 3)."""
    d = str(tmp_path_factory.mktemp("port_corpus"))
    jd = str(tmp_path_factory.mktemp("jax_corpus"))
    corpus = write_extracted_corpus_dir(d, N_COMMITS, seed=SEED)
    jax_write_extracted(jd, N_COMMITS, seed=SEED)
    tds = FiraDataset(d, fira_tiny(**KNOBS))
    jds = JaxDataset(jd, jax_fira_tiny(**KNOBS))
    batch = make_batch(tds.splits["train"], np.arange(4), tds.cfg)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(0), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    # an <eos> bias of 3 settles the beams at mixed depths: 11 of the 20
    # messages are not empty (4 leaves every one empty)
    params = eos_biased_params(params, delta=3.0)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    requests = [difftext.reconstruct_request(corpus.record(int(i)))
                for i in tds.split_indices["train"]]
    with open(os.path.join(d, "variable.json")) as f:
        var_maps = json.load(f)
    return dict(tds=tds, jds=jds, params=params, model=model,
                requests=requests, var_maps=var_maps, dir=d,
                trace=arrivals.poisson_times(len(requests), 0.7, seed=3),
                tmp=tmp_path_factory, runs={})


def port_diffs(setup, out, requests=None, times=None, **knobs):
    return service.serve_diffs(
        setup["model"], setup["tds"].word_vocab,
        setup["tds"].ast_change_vocab, setup["tds"].cfg.replace(**knobs),
        requests=setup["requests"] if requests is None else requests,
        arrival_times=setup["trace"] if times is None else times,
        out_dir=str(out), clock="virtual",
        metrics_path=os.path.join(str(out), "serve_metrics.json"))


def jax_diffs(setup, out, requests=None, times=None, **knobs):
    cfg = setup["jds"].cfg.replace(**knobs)
    return jax_service.serve_diffs(
        JaxModel(cfg), setup["params"], setup["jds"].word_vocab,
        setup["jds"].ast_change_vocab, cfg,
        requests=setup["requests"] if requests is None else requests,
        arrival_times=setup["trace"] if times is None else times,
        out_dir=str(out), clock="virtual")


def cached_run(setup, name, fn):
    if name not in setup["runs"]:
        setup["runs"][name] = fn(setup["tmp"].mktemp(name))
    return setup["runs"][name]


def read(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def records(m):
    """Request records with the ingest stage seconds left out."""
    out = []
    for r in m["request_records"]:
        r = dict(r)
        if r["ingest"] is not None:
            r["ingest"] = {k: v for k, v in r["ingest"].items()
                           if not k.endswith("_s")}
        out.append(r)
    return out


def summary(m):
    """The serve summary with the ingest block's wall-time keys left out
    (their presence is kept)."""
    sv = dict(m["serve"])
    if "ingest" in sv:
        sv["ingest"] = {k: (k if k in TIMED else v)
                        for k, v in sv["ingest"].items()}
    return sv


def assert_same_run(got, want):
    assert read(got) == read(want)
    assert records(got) == records(want)
    assert summary(got) == summary(want)


# --------------------------------------------------------------------------
# serve_diffs against the JAX package's and the graphs path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ingest_cache,ingest_exec", [
    (True, "thread"), (False, "thread"), (True, "process"),
    (False, "process")])
def test_serve_diffs_equals_jax_and_graphs(setup, tmp_path, ingest_cache,
                                           ingest_exec):
    """The four fast-path modes write one set of bytes: the JAX package's
    raw-diff serve and the port's serve of the corpus graphs. Records and
    summary equal JAX's (its thread-mode run of the same cache knob: the
    parse stage's process is not visible in them), the metrics artifact
    is written atomically with every record's ingest stamps."""
    graphs = cached_run(setup, "graphs", lambda out: serve_split(
        setup["model"], setup["tds"], setup["tds"].cfg,
        arrival_times=setup["trace"], out_dir=str(out), split="train",
        clock="virtual", var_maps=setup["var_maps"]))
    want = cached_run(setup, f"jax_cache_{ingest_cache}",
                      lambda out: jax_diffs(setup, out,
                                            ingest_cache=ingest_cache))
    got = port_diffs(setup, tmp_path, ingest_cache=ingest_cache,
                     ingest_exec=ingest_exec)
    assert_same_run(got, want)
    assert read(got) == read(graphs)
    n = len(setup["requests"])
    # not a vacuous comparison: the weights write messages on most lines
    assert sum(bool(x) for x in read(got).decode().split("\n")) >= n // 2
    sv = got["serve"]
    assert sv["completed"] == n and sv["shed_error"] == 0
    ing = sv["ingest"]
    assert ing["requests_ingested"] == n and ing["cache_hits"] == 0
    assert (ing["workers"], ing["pipeline_depth"]) == (1, 4)
    assert ("cache" in ing) == ingest_cache
    assert (ing["memo_hits"] + ing["memo_misses"] > 0) == ingest_cache
    art = json.load(open(tmp_path / "serve_metrics.json"))
    assert all(r["ingest"] is not None for r in art["request_records"])
    assert art["serve"]["ingest"]["requests_ingested"] == n
    assert not os.path.exists(tmp_path / "serve_metrics.json.partial")


@pytest.mark.parametrize("tar_buckets", [False, True])
def test_bucketed_serve_diffs_equals_jax_and_graphs(setup, tmp_path,
                                                    tar_buckets):
    """With a bucket table each raw-diff request carries its own decode
    bucket (assigned by its measured extents; under tar buckets a diff
    with a reference is bucketed by it), packed at that geometry: the
    bytes, records and summary of the JAX package, and the bytes of the
    bucketed graphs path."""
    from fira_tpu_torch.data import buckets as buckets_lib

    table = buckets_lib.choose_buckets(setup["tds"].splits["train"],
                                       setup["tds"].cfg)
    knobs = dict(buckets=table, decode_tar_buckets=tar_buckets)
    graphs = serve_split(setup["model"], setup["tds"],
                         setup["tds"].cfg.replace(**knobs),
                         arrival_times=setup["trace"],
                         out_dir=str(tmp_path / "graphs"), split="train",
                         clock="virtual", var_maps=setup["var_maps"])
    got = port_diffs(setup, tmp_path / "port", **knobs)
    want = jax_diffs(setup, tmp_path / "jax", **knobs)
    assert_same_run(got, want)
    assert read(got) == read(graphs)
    assert len(table) > 1 and got["serve"]["completed"] == len(
        setup["requests"])


def doubled(setup):
    """Every diff twice: the second pass reversed, arriving after the
    first pass's last arrival."""
    reqs, times = setup["requests"], setup["trace"]
    return (reqs + reqs[::-1],
            np.concatenate([times, times[-1] + 1.0 + times]))


def test_repeats_hit_the_result_cache_like_jax(setup, tmp_path):
    """With one ingest worker every second-pass diff is a result-cache
    hit (its stamps replayed with ``cached``); each line is its first
    pass's, and the records, summary and cache meter are JAX's."""
    reqs, times = doubled(setup)
    n = len(setup["requests"])
    got = port_diffs(setup, tmp_path / "port", reqs, times)
    want = jax_diffs(setup, tmp_path / "jax", reqs, times)
    assert_same_run(got, want)
    lines = read(got).decode().split("\n")
    assert lines[n:2 * n] == lines[:n][::-1]
    ing = got["serve"]["ingest"]
    assert ing["cache_hits"] == n == ing["cache"]["hits"]
    assert ing["cache"]["misses"] == n
    assert all(r["ingest"]["cached"] for r in got["request_records"][n:])
    assert got["serve"]["completed"] == 2 * n


def test_each_request_deanonymized_with_its_own_var_map(setup, tmp_path):
    """Each request's ``#! var:`` map travels with its payload into the
    packed batch (or a dedup follower's own payload) and de-anonymizes
    its own line: request i's map gains an entry ``r<i>_w`` for each word
    w of its clean line (no diff token, so the payload is unchanged), and
    line i reads through request i's map, as in the JAX package."""
    clean = cached_run(setup, "jax_cache_True",
                       lambda out: jax_diffs(setup, out, ingest_cache=True))
    words = [line.split() for line in read(clean).decode().split("\n")]
    reqs, maps = [], []
    for i, text in enumerate(setup["requests"]):
        req = difftext.parse_request(text)
        vm = dict(req.var_map, **{f"r{i}_{w}": w for w in words[i]})
        maps.append(vm)
        body = [x for x in text.splitlines(keepends=True)
                if not x.startswith("#! var:")]
        reqs.append(f"#! var: {json.dumps(vm, sort_keys=True)}\n"
                    + "".join(body))
    got = port_diffs(setup, tmp_path / "port", reqs)
    want = jax_diffs(setup, tmp_path / "jax", reqs)
    assert read(got) == read(want)
    lines = read(got).decode().split("\n")
    assert any(words)
    for i, vm in enumerate(maps):
        reverse = {v: k for k, v in json.loads(
            json.dumps(vm, sort_keys=True)).items()}
        assert lines[i].split() == [reverse.get(w, w) for w in words[i]]


def test_malformed_diffs_shed_like_jax(setup, tmp_path):
    """Three malformed requests: exactly those positions are shed with the
    JAX package's recorded reasons and an empty line; every other line is
    the clean run's."""
    n = len(setup["requests"])
    broken = list(setup["requests"])
    bad = {1: "garbage that is not a diff\n",
           5: "diff --git a/A.java b/A.java\n+int x = 1 ;\n",
           n - 2: "@@ -1,1 +1,1 @@ class A\n?int x ;\n"}
    for pos, text in bad.items():
        broken[pos] = text
    got = port_diffs(setup, tmp_path / "port", broken)
    want = jax_diffs(setup, tmp_path / "jax", broken)
    assert_same_run(got, want)
    clean = cached_run(setup, "jax_cache_True",
                       lambda out: jax_diffs(setup, out, ingest_cache=True))
    lines = read(got).decode().split("\n")
    ref = read(clean).decode().split("\n")
    shed = [r["position"] for r in got["request_records"]
            if r["status"] == "shed_error"]
    assert shed == sorted(bad)
    for pos in range(n):
        if pos in bad:
            assert lines[pos] == ""
            assert "DiffParseError" in got["request_records"][pos]["error"]
        else:
            assert lines[pos] == ref[pos], f"position {pos}"
    assert got["serve"]["shed_error"] == len(bad)


@pytest.mark.parametrize("spec,retries", [
    ("ingest.parse:raise:0.15:3", 0), ("ingest.parse:raise:0.3:4", 1),
    ("ingest.parse:corrupt:0.15:3", 1), ("ingest.cache:corrupt:0.5:3", 1),
    ("ingest.cache:raise:0.5:3", 1)])
def test_ingest_fault_sites_serve_like_jax(setup, tmp_path, spec, retries):
    """The doubled trace with one ingest site armed: the same events fire,
    the same requests are shed (with JAX's reasons) or scrambled, and the
    bytes, records and summary are the JAX package's. A line that moved
    from the clean run's is a shed one (empty) or one whose payload the
    site's keyed draw scrambled."""
    reqs, times = doubled(setup)
    knobs = dict(inject_faults=spec, robust_retries=retries)
    got = port_diffs(setup, tmp_path / "port", reqs, times, **knobs)
    want = jax_diffs(setup, tmp_path / "jax", reqs, times, **knobs)
    assert_same_run(got, want)
    assert got["faults"] == want["faults"] and sum(got["faults"].values())
    clean = port_diffs(setup, tmp_path / "clean", reqs, times)
    lines = read(got).decode().split("\n")
    ref = read(clean).decode().split("\n")
    recs = got["request_records"]
    moved = {i for i in range(len(reqs)) if lines[i] != ref[i]}
    shed = {r["position"] for r in recs if r["status"] == "shed_error"}
    assert all(lines[p] == "" for p in shed)
    if spec.startswith("ingest.cache"):
        # an absorbed lookup fault re-ingests: never a shed, never a move
        assert not moved and not shed
        block = got["serve"]["ingest"]["cache"]
        kind = "integrity_drops" if "corrupt" in spec else "fault_misses"
        assert block[kind] == got["faults"]["ingest.cache"] > 0
    elif "raise" in spec:
        assert shed and moved <= shed
        assert all("InjectedFault" in recs[p]["error"]
                   and "ingest.parse" in recs[p]["error"] for p in shed)
    else:
        # scrambled payloads: the positions the keyed draw picks, no shed
        (fs,) = faults.parse_fault_specs(spec)
        scrambled = {i for i in range(len(reqs))
                     if faults.FaultInjector._draw(fs, i)}
        assert not shed and moved <= scrambled
        assert len(scrambled) == got["faults"]["ingest.parse"] > 0


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_serve_diffs_writes_the_graphs_bytes(setup, tmp_path, capsys):
    """``cli serve --input diffs`` on the test split's reconstructed diffs
    writes the bytes of ``cli serve --input graphs`` on the same
    checkpoint and trace (cache on, and off with the process pool), with
    its ``ingest:`` line and metrics; an arrival trace longer than the
    diffs exits 2 naming them."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(setup["model"].state_dict(), str(ckpt / "best.pt"))
    base = ["--config", "fira-tiny", "--device", "cpu", "--data-dir",
            setup["dir"], "--ckpt-dir", str(ckpt), "--serve-clock",
            "virtual"]
    from fira_tpu_torch.data.schema import Corpus

    corpus = Corpus.load(setup["dir"])
    texts = [difftext.reconstruct_request(corpus.record(int(i)))
             for i in setup["tds"].split_indices["test"]]
    dtrace = str(tmp_path / "diffs.trace")
    difftext.write_diff_trace(dtrace, texts)
    trace = str(tmp_path / "trace.txt")
    arrivals.write_trace(trace, arrivals.poisson_times(len(texts), 0.5,
                                                       seed=1))
    assert cli.main(["serve", "--out-dir", str(tmp_path / "graphs"),
                     "--serve-trace", trace, *base]) == 0
    ref = open(tmp_path / "graphs" / "output_fira", "rb").read()
    assert ref.count(b"\n") == len(texts)
    for name, flags in (("on", []), ("off_process", [
            "--ingest-cache", "off", "--ingest-exec", "process",
            "--ingest-workers", "2"])):
        out = tmp_path / f"diffs_{name}"
        capsys.readouterr()
        assert cli.main(["serve", "--input", "diffs", "--diff-trace",
                         dtrace, "--out-dir", str(out), "--serve-trace",
                         trace, *flags, *base]) == 0
        printed = capsys.readouterr().out
        assert f"serve: {len(texts)}/{len(texts)} completed" in printed
        assert f"ingest: {len(texts)} requests (0 truncated" in printed
        assert open(out / "output_fira", "rb").read() == ref
        ing = json.load(open(out / "serve_metrics.json"))["serve"]["ingest"]
        assert ("cache" in ing) == (name == "on")
        assert ing["workers"] == 2
    arrivals.write_trace(trace, arrivals.poisson_times(len(texts) + 2, 0.5,
                                                       seed=1))
    capsys.readouterr()
    assert cli.main(["serve", "--input", "diffs", "--diff-trace", dtrace,
                     "--out-dir", str(tmp_path / "long"), "--serve-trace",
                     trace, *base]) == 2
    assert (f"--serve-trace has {len(texts) + 2} arrivals but the request "
            f"source holds only {len(texts)} diffs"
            in capsys.readouterr().err)


@pytest.mark.parametrize("flags,knobs,kw", [
    (["--ingest-cache-entries", "-1"], {"ingest_cache_entries": -1}, {}),
    (["--ingest-cache-bytes", "-5"], {"ingest_cache_bytes": -5}, {}),
    (["--ingest-workers", "-1"], {"ingest_workers": -1}, {}),
    (["--diff-trace", __file__], {},
     {"input_mode": "graphs", "diff_trace": __file__}),
    (["--input", "diffs", "--diff-trace", "EMPTY"], {},
     {"input_mode": "diffs", "diff_trace": "EMPTY"})])
def test_cli_bad_ingest_knobs_exit_2_with_jax_messages(setup, tmp_path,
                                                       capsys, flags, knobs,
                                                       kw):
    (tmp_path / "EMPTY").mkdir()
    flags = [str(tmp_path / f) if f == "EMPTY" else f for f in flags]
    if kw.get("diff_trace") == "EMPTY":
        kw = dict(kw, diff_trace=str(tmp_path / "EMPTY"))
    rc = cli.main(["serve", "--config", "fira-tiny", "--device", "cpu",
                   "--data-dir", setup["dir"], "--out-dir",
                   str(tmp_path / "OUT"), "--serve-rate", "1", *flags])
    assert rc == 2
    want = jax_service.ingest_errors(jax_fira_tiny(**knobs),
                                     command="serve", **kw)
    err = capsys.readouterr().err
    assert len(want) == 1 and f"parse-time validation: {want[0]}" in err

"""The port's self-healing fleet and crash-resume
(``fira_tpu_torch/robust/recovery.py``, the serve loop's healing and
journal) against the JAX package's (tests/test_recovery.py) on the same
corpus and weights (``convert.params_from_flax``):

- respawn under a seeded ``engine.step`` fault at 1 replica (every
  replica lost, then healed instead of shedding) and at 2, a respawn
  storm that exhausts its budget and degrades like retirement, and a
  warm-spare attach: the
  bytes, request records, recovery record, fleet summary and journal of
  the JAX serve;
- a drain fleet that respawns (a spare first) and completes, with the
  JAX fleet's summary;
- a dedup follower whose leader's replica dies still completes;
- the journal: the JAX package's bytes for the same calls, a torn tail,
  the resume admission messages, the begin record's fsync failure;
  ``times_digest`` gives JAX's hex strings; ``recover_output`` on a crash
  pair with torn lines;
- ``serve_split(resume=True)`` on a fabricated kill state serves exactly
  the suffix, with JAX's records, bytes and journal; a SIGKILLed
  wall-clock ``cli serve`` subprocess resumes to the uninterrupted bytes;
- ``recovery_errors``, ``respawn_backoff_s`` and the CLI's exit-2
  messages in the JAX package's words.

Tolerance: none. Bytes, records (times included: the virtual clock) and
summaries compare exactly; ``respawn_backoff_s`` to 1e-12."""

import builtins
import json
import math
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache as cc

from fira_tpu import cli as jax_cli
from fira_tpu.config import fira_tiny as jax_fira_tiny
from fira_tpu.data.dataset import FiraDataset as JaxDataset
from fira_tpu.data.synthetic import write_corpus_dir
from fira_tpu.decode.beam import eos_biased_params
from fira_tpu.decode.runner import run_test as jax_run_test
from fira_tpu.model.model import FiraModel as JaxModel
from fira_tpu.robust import recovery as jax_recovery
from fira_tpu.serve import serve_split as jax_serve_split
from fira_tpu_torch import cli, convert
from fira_tpu_torch.config import fira_tiny
from fira_tpu_torch.data.batching import make_batch
from fira_tpu_torch.data.dataset import FiraDataset
from fira_tpu_torch.decode.runner import run_test
from fira_tpu_torch.model.model import FiraModel
from fira_tpu_torch.robust import recovery
from fira_tpu_torch.serve import poisson_times, serve_split

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = dict(batch_size=8, test_batch_size=6, decode_engine=True)
SCHEDULE_KEYS = ("replicas", "slots", "prefills", "refills",
                 "slots_refilled", "steps_run", "step_dispatches",
                 "commits", "dispatches", "per_replica_commits",
                 "retirements", "retired_replicas", "requeues", "respawns",
                 "respawned_replicas", "spare_attaches")
SERVE_KEYS = ("offered", "completed", "completion_order", "shed_error",
              "replica_retirements", "retired_replicas", "requeued_requests",
              "respawns", "respawned_replicas", "spare_attaches",
              "replicas_alive_over_time", "heartbeats",
              "admission_paused_rounds", "resumed", "rounds", "admits",
              "max_admits_per_round")


@pytest.fixture(scope="module", autouse=True)
def xla_cache(tmp_path_factory):
    """A persistent XLA compilation cache for this module: each JAX engine
    jits its own programs, so every engine the JAX fleets build (replicas,
    replacements, spares) would compile the same programs again; with the
    cache each compiles once. The process's settings come back after."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    cc.reset_cache()
    jax.config.update("jax_compilation_cache_dir",
                      str(tmp_path_factory.mktemp("xla_cache")))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])
    cc.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engines run many tiny ops, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX tests' corpus (40 commits, seed 13), widths, weights biased
    toward <eos> in both packages, trace (rate 0.4, seed 3), and the
    port's drain bytes of the train split."""
    d = str(tmp_path_factory.mktemp("recovery_corpus"))
    write_corpus_dir(d, n_commits=40, seed=13)
    jds = JaxDataset(d, jax_fira_tiny(**KNOBS))
    tds = FiraDataset(d, fira_tiny(**KNOBS))
    batch = make_batch(tds.splits["train"], np.arange(6), tds.cfg)
    params = jax.jit(lambda b: JaxModel(jds.cfg).init(
        jax.random.PRNGKey(0), b, deterministic=True))(
            {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = eos_biased_params(params, delta=4.0)
    model = FiraModel(tds.cfg)
    model.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    trace = poisson_times(len(tds.splits["train"]), rate=0.4, seed=3)
    drain = run_test(model, tds, tds.cfg, split="train",
                     out_dir=str(tmp_path_factory.mktemp("drain")))
    return dict(jds=jds, tds=tds, params=params, model=model, trace=trace,
                dir=d, drain=read(drain))


def read(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def both_serves(setup, tmp, times=None, mix=None, journal=False, **knobs):
    """The port's and the JAX package's ``serve_split`` of the train split
    under the virtual clock, each with its journal when asked."""
    times = setup["trace"] if times is None else times
    out = []
    for name in ("port", "jax"):
        d = os.path.join(str(tmp), name)
        jp = os.path.join(d, "output_fira.journal") if journal else None
        os.makedirs(d, exist_ok=True)
        if name == "port":
            out.append(serve_split(
                setup["model"], setup["tds"],
                setup["tds"].cfg.replace(**knobs), arrival_times=times,
                out_dir=d, split="train", clock="virtual", request_mix=mix,
                journal_path=jp))
        else:
            cfg = setup["jds"].cfg.replace(**knobs)
            out.append(jax_serve_split(
                JaxModel(cfg), setup["params"], setup["jds"], cfg,
                arrival_times=times, out_dir=d, split="train",
                clock="virtual", request_mix=mix, journal_path=jp))
    return out


def assert_serves_equal(got, want):
    """Bytes, serve record, fleet schedule and request records, field for
    field."""
    assert read(got) == read(want)
    assert ({k: got["serve"][k] for k in SERVE_KEYS}
            == {k: want["serve"][k] for k in SERVE_KEYS})
    if "replicas" in want["engine"]:
        assert ({k: got["engine"][k] for k in SCHEDULE_KEYS}
                == {k: want["engine"][k] for k in SCHEDULE_KEYS})
    assert got.get("faults") == want.get("faults")
    assert len(got["request_records"]) == len(want["request_records"])
    for a, b in zip(got["request_records"], want["request_records"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k]), (k, a, b)
            else:
                assert a[k] == b[k], (k, a, b)


# --------------------------------------------------------------------------
# respawn, exhaustion, spares
# --------------------------------------------------------------------------

RECOVERY_CASES = {
    # tests/test_recovery.py:88 at 1 and 2 replicas
    "respawn-1": dict(engine_replicas=1,
                      inject_faults="engine.step:raise:0.02:18",
                      max_respawns=3, respawn_backoff_s=0.05),
    "respawn-2": dict(engine_replicas=2,
                      inject_faults="engine.step:raise:0.02:18",
                      max_respawns=3, respawn_backoff_s=0.05),
    # :119, the storm that exhausts the budget
    "exhausted": dict(engine_replicas=2,
                      inject_faults="engine.step:raise:0.5:5",
                      max_respawns=1, respawn_backoff_s=0.05),
    # :153, a warm spare attached
    "spare": dict(engine_replicas=2,
                  inject_faults="engine.step:raise:0.02:18",
                  max_respawns=2, engine_spares=1, respawn_backoff_s=0.05),
}


@pytest.mark.parametrize("case", list(RECOVERY_CASES))
def test_recovery_serve_equals_jax(setup, tmp_path, case):
    knobs = RECOVERY_CASES[case]
    got, want = both_serves(setup, tmp_path, journal=True, **knobs)
    assert_serves_equal(got, want)
    with open(got["output_path"] + ".journal", "rb") as a, \
            open(want["output_path"] + ".journal", "rb") as b:
        assert a.read() == b.read()
    sv = got["serve"]
    assert sv["replica_retirements"] >= 1 and sv["respawns"] >= 1
    n = len(setup["trace"])
    if case == "exhausted":
        # degraded like a retirement: recorded sheds, every completed
        # position the no-fault line, every shed one empty
        assert sv["shed_error"] > 0 and sv["replica_retirements"] >= 2
        assert sv["completed"] + sv["shed_error"] == n
        ref = setup["drain"].decode().split("\n")
        lines = read(got).decode().split("\n")
        shed = {r["position"] for r in got["request_records"]
                if r["status"] != "done"}
        assert len(lines) == len(ref)
        for p, (a, b) in enumerate(zip(ref, lines)):
            assert b == ("" if p in shed else a), p
        return
    assert sv["completed"] == n and read(got) == setup["drain"]
    # the replacement served, and the alive trace stepped down and up
    assert sv["heartbeats"][sv["respawned_replicas"][0]]["rounds"] > 0
    alive = [e["alive"] for e in sv["replicas_alive_over_time"]]
    assert min(alive) < knobs["engine_replicas"] and alive[-1] >= 1
    if case == "respawn-1":
        assert 0 in alive   # every replica lost, then healed, not shed
    if case == "spare":
        assert sv["spare_attaches"] >= 1
        assert sv["respawned_replicas"][0].startswith("sp")


def test_drain_fleet_respawns_and_completes_like_jax(setup, tmp_path):
    """``run_test`` on a 2-replica fleet with respawn and a warm spare: a
    ``fleet.replica`` fault retires a replica, a spare replaces it, the
    bytes are the no-fault run's, the summary JAX's."""
    knobs = dict(engine_replicas=2,
                 inject_faults="fleet.replica:raise:0.05:8",
                 max_respawns=2, engine_spares=1, respawn_backoff_s=0.05)
    got = run_test(setup["model"], setup["tds"],
                   setup["tds"].cfg.replace(**knobs), split="train",
                   out_dir=str(tmp_path / "port"))
    cfg = setup["jds"].cfg.replace(**knobs)
    want = jax_run_test(JaxModel(cfg), setup["params"], setup["jds"], cfg,
                        split="train", out_dir=str(tmp_path / "jax"))
    assert read(got) == read(want) == setup["drain"]
    eng = got["engine"]
    assert ({k: eng[k] for k in SCHEDULE_KEYS}
            == {k: want["engine"][k] for k in SCHEDULE_KEYS})
    assert eng["retirements"] >= 1 and eng["spare_attaches"] >= 1
    assert eng["respawned_replicas"][0].startswith("sp")
    # every engine built prewarmed once: 2 replicas and the spare
    assert eng["warm_step_dispatches"] == 3


def test_dedup_follower_completes_after_leader_death(setup, tmp_path):
    """A replica serving coalesced groups dies; leaders and followers
    requeue and the healed fleet completes each request once, with each
    sample's drain line (tests/test_recovery.py:202)."""
    mix = [i % 7 for i in range(40)]
    knobs = dict(prefix_cache=True, engine_replicas=2,
                 engine_harvest_every=1,
                 inject_faults="engine.step:raise:0.1:3", max_respawns=2,
                 respawn_backoff_s=0.05)
    got, want = both_serves(setup, tmp_path, times=np.zeros(len(mix)),
                            mix=mix, **knobs)
    assert_serves_equal(got, want)
    sv = got["serve"]
    assert sv["replica_retirements"] >= 1 and sv["respawns"] >= 1
    assert sv["completed"] == len(mix) and sv["dedup_coalesced"] > 0
    assert any(r["coalesced_into"] is not None and r["status"] == "done"
               for r in got["request_records"])
    ref = setup["drain"].decode().splitlines(keepends=True)
    assert read(got) == "".join(ref[j] for j in mix).encode()


# --------------------------------------------------------------------------
# the journal and crash-pair recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize("times", [[0.0, 0.5, 1.25], [], [1e-9, 3.0],
                                   [0.1 * i for i in range(50)]])
def test_times_digest_equals_jax(times):
    assert recovery.times_digest(times) == jax_recovery.times_digest(times)


def test_journal_bytes_torn_tail_and_resume_messages_equal_jax(tmp_path):
    times = np.array([0.0, 0.5, 1.25])
    paths = []
    for lib, name in ((recovery, "port"), (jax_recovery, "jax")):
        path = str(tmp_path / f"{name}.journal")
        with lib.Journal(path, n=3, times=times, mix=[0, 0, 1]) as j:
            j.admit([0, 1])
            j.done([0])
            j.shed(2, "shed_error", "boom")
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    path = paths[0]
    meta, term = recovery.read_journal(path)
    assert (meta, term) == jax_recovery.read_journal(path)
    assert term[2] == {"kind": "shed", "pos": 2, "status": "shed_error",
                       "error": "boom"} and 1 not in term
    with open(path, "a") as f:
        f.write('{"kind":"done","pos"')   # a kill mid-write
    assert recovery.read_journal(path) == (meta, term)
    for args in ((3, times), (5, times), (3, times + 1.0),
                 (3, times, [0, 1, 1])):
        assert (recovery.resume_errors(path, *args)
                == jax_recovery.resume_errors(path, *args))
    assert recovery.resume_errors(path, 3, times, [0, 0, 1]) == []
    missing = str(tmp_path / "nope")
    assert (recovery.resume_errors(missing, 3, times)
            == jax_recovery.resume_errors(missing, 3, times)
            == [recovery.missing_journal_error(missing)])
    empty = str(tmp_path / "empty.journal")
    open(empty, "w").close()
    assert (recovery.resume_errors(empty, 3, times)
            == jax_recovery.resume_errors(empty, 3, times))


def test_journal_begin_fsync_failure_closes_the_handle(tmp_path,
                                                       monkeypatch):
    opened = []
    real_open = builtins.open

    def spy_open(*a, **k):
        f = real_open(*a, **k)
        opened.append(f)
        return f

    def full_disk(fd):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(recovery.os, "fsync", full_disk)
    with pytest.raises(OSError):
        recovery.Journal(str(tmp_path / "j.jsonl"), n=3,
                         times=[0.0, 1.0, 2.0])
    assert opened and all(f.closed for f in opened)


def test_recover_output_crash_pair_equals_jax(tmp_path):
    out = str(tmp_path / "output_fira")
    lines = [f"line {i}\n" for i in range(6)] + ["a\x0bb c\n"]
    with open(out + ".partial", "w") as f:
        f.writelines(lines[:3] + [lines[6]])
        f.write("torn")             # no newline: dropped
    with open(out + ".partial.tail", "w") as f:
        f.write(f"5\t{lines[5]}")
        f.write("x\tbad position\n")
        f.write("4\ttorn")          # a torn tail record: dropped
    got = recovery.recover_output(out, 7)
    assert got == jax_recovery.recover_output(out, 7)
    assert got == {0: lines[0], 1: lines[1], 2: lines[2], 3: lines[6],
                   5: lines[5]}
    final = str(tmp_path / "done" / "output_fira")
    os.makedirs(os.path.dirname(final))
    with open(final, "w") as f:
        f.writelines(lines[:6])
    assert (recovery.recover_output(final, 6)
            == jax_recovery.recover_output(final, 6)
            == dict(enumerate(lines[:6])))


def fabricate_kill_state(out_dir, ref_lines, n, trace, lib):
    """A killed run's files: the .partial prefix and tagged tail and a
    journal, each ending in a torn record."""
    os.makedirs(out_dir)
    out = os.path.join(out_dir, "output_fira")
    with open(out + ".partial", "w") as f:
        f.writelines(ref_lines[:8])
        f.write("torn-prefix-line")
    with open(out + ".partial.tail", "w") as f:
        f.write(f"12\t{ref_lines[12]}")
        f.write("15\ttorn")
    j = lib.Journal(out + ".journal", n=n, times=trace)
    j.admit(list(range(10)))
    j.done(list(range(8)) + [12])
    j._f.write('{"kind":"done",')
    j.close()
    return out + ".journal"


def test_serve_resume_serves_exact_suffix_like_jax(setup, tmp_path):
    """A fabricated kill state resumed: only the 24 unfinished positions
    are served, with JAX's records and journal, and the file is the
    uninterrupted run's; a second resume serves nothing."""
    trace, n = setup["trace"], len(setup["trace"])
    ref_lines = setup["drain"].decode().splitlines(keepends=True)
    got = want = None
    for name, lib in (("port", recovery), ("jax", jax_recovery)):
        d = str(tmp_path / name)
        jp = fabricate_kill_state(d, ref_lines, n, trace, lib)
        if name == "port":
            got = serve_split(setup["model"], setup["tds"], setup["tds"].cfg,
                              arrival_times=trace, out_dir=d, split="train",
                              clock="virtual", journal_path=jp, resume=True)
            again = serve_split(setup["model"], setup["tds"],
                                setup["tds"].cfg, arrival_times=trace,
                                out_dir=d, split="train", clock="virtual",
                                journal_path=jp, resume=True)
        else:
            cfg = setup["jds"].cfg
            want = jax_serve_split(JaxModel(cfg), setup["params"],
                                   setup["jds"], cfg, arrival_times=trace,
                                   out_dir=d, split="train", clock="virtual",
                                   journal_path=jp, resume=True)
    assert_serves_equal(got, want)
    sv = got["serve"]
    assert sv["resumed"] == 9 and sv["offered"] == sv["completed"] == n - 9
    assert [r["position"] for r in got["request_records"]] == [
        p for p in range(n) if p >= 8 and p != 12]
    assert read(got) == setup["drain"]
    with open(got["output_path"] + ".journal", "rb") as a, \
            open(want["output_path"] + ".journal", "rb") as b:
        assert a.read() == b.read()
    assert again["serve"]["resumed"] == n and again["serve"]["offered"] == 0
    assert read(again) == setup["drain"]
    with pytest.raises(recovery.ResumeError, match="digest mismatch"):
        serve_split(setup["model"], setup["tds"], setup["tds"].cfg,
                    arrival_times=trace + 1.0, out_dir=str(tmp_path / "port"),
                    split="train", clock="virtual",
                    journal_path=got["output_path"] + ".journal",
                    resume=True)


def test_sigkill_resume_subprocess(tmp_path, capsys):
    """A wall-clock ``cli serve --device cpu`` subprocess killed with
    SIGKILL mid-run, then ``cli serve --resume``: the recovered lines plus
    the re-served rest are ``cli test --engine``'s bytes, no position
    written twice, no crash pair left; a resume at another rate exits 2
    with the digest-mismatch message."""
    data = str(tmp_path / "DataSet")
    write_corpus_dir(data, n_commits=300, seed=5)
    ds = FiraDataset(data, fira_tiny())
    model = FiraModel(ds.cfg).init_parameters(
        torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save(model.state_dict(), str(ckpt / "best.pt"))
    n = len(ds.splits["test"])
    base = ["--config", "fira-tiny", "--device", "cpu", "--data-dir", data,
            "--ckpt-dir", str(ckpt)]
    out = tmp_path / "serve"
    serve = ["serve", "--out-dir", str(out), "--serve-rate", "6",
             "--prefix-cache", "off", *base]
    jp = str(out / "output_fira.journal")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO_ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "fira_tpu_torch.cli",
                             *serve], cwd=REPO_ROOT, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    done_at_kill = -1
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120 and proc.poll() is None:
            done_at_kill = len(recovery.read_journal(jp)[1])
            if done_at_kill >= 3:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            proc.kill()
        err = proc.communicate()[1]
    assert proc.returncode == -signal.SIGKILL, err.decode()[-2000:]
    assert 3 <= done_at_kill < n
    recovered = recovery.recover_output(str(out / "output_fira"), n)
    assert len(recovered) >= done_at_kill
    assert cli.main(serve + ["--resume"]) == 0
    ref = tmp_path / "ref"
    assert cli.main(["test", "--engine", "--out-dir", str(ref), *base]) == 0
    assert ((out / "output_fira").read_bytes()
            == (ref / "output_fira").read_bytes())
    assert not os.path.exists(str(out / "output_fira.partial"))
    assert not os.path.exists(str(out / "output_fira.partial.tail"))
    with open(out / "serve_metrics.json") as f:
        metrics = json.load(f)
    assert metrics["serve"]["resumed"] == len(recovered)
    assert metrics["serve"]["offered"] == n - len(recovered)
    # a resume under another arrival schedule is refused, named
    other = [a if a != "6" else "7" for a in serve]
    assert cli.main(other + ["--resume"]) == 2
    assert "digest mismatch" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the knob checks and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    {}, dict(max_respawns=2, engine_spares=1), dict(engine_spares=-1),
    dict(max_respawns=-1), dict(respawn_backoff_s=0.0),
    dict(engine_spares=2), dict(engine_spares=-1, max_respawns=-1,
                                respawn_backoff_s=-1.0)])
def test_recovery_errors_equal_jax(knobs):
    assert (recovery.recovery_errors(fira_tiny(**knobs))
            == jax_recovery.recovery_errors(jax_fira_tiny(**knobs)))


def test_respawn_backoff_and_origins_equal_jax():
    for base in (0.05, 0.2, 0.25):
        for a in range(0, 9):
            assert recovery.respawn_backoff_s(a, base) == pytest.approx(
                jax_recovery.respawn_backoff_s(a, base), abs=1e-12)
    assert [recovery.respawn_backoff_s(a, 0.2) for a in (1, 2, 5, 9)] \
        == pytest.approx([0.2, 0.4, 1.0, 1.0])
    for tag in (None, "r0", "r1~2", "sp3", "r12~1"):
        assert recovery.origin_of(tag) == jax_recovery.origin_of(tag)
    assert recovery.RESPAWN_TAG_SEP == jax_recovery.RESPAWN_TAG_SEP


def test_cli_recovery_validation_exit2_in_jax_words(tmp_path, capsys):
    """Every recovery knob misuse exits 2 in both CLIs, the port's error
    output holding each message the JAX CLI prints."""
    data = str(tmp_path / "DataSet")
    write_corpus_dir(data, n_commits=16, seed=5)
    diff = str(tmp_path / "one.diff")
    with open(diff, "w") as f:
        f.write("#! request\n")
    base = ["serve", "--config", "fira-tiny", "--data-dir", data,
            "--out-dir", str(tmp_path / "OUT"), "--serve-rate", "5"]
    dbase = base + ["--input", "diffs", "--diff-trace", diff]
    for flags in (base + ["--max-respawns", "-1"],
                  base + ["--respawn-backoff-s", "0"],
                  base + ["--engine-spares", "2"],
                  base + ["--resume"],
                  dbase + ["--resume"],
                  dbase + ["--max-respawns", "2"]):
        assert jax_cli.main(flags) == 2
        want = [line.split("parse-time validation: ", 1)[1]
                for line in capsys.readouterr().err.splitlines()
                if "parse-time validation: " in line]
        assert want, flags
        assert cli.main(flags + ["--device", "cpu"]) == 2
        err = capsys.readouterr().err
        for msg in want:
            assert msg in err, (flags, msg, err)

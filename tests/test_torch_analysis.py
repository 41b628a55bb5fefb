"""The port's static analyzer (fira_tpu_torch/analysis), the counterpart
of tests/test_firacheck.py.

Four contracts:
- every shipped rule FIRES in its torch form: the planted-hazard corpus
  tests/fixtures/torch_firacheck_hazards.py (torch idiom) and the
  framework-neutral v2/v3 corpora mark each hazard line with
  ``HAZARD[RULE-ID]``; every rule is SUPPRESSIBLE, rule-exactly;
- the analyzer is ARMED on the port: every path-scoped registry names a
  file of fira_tpu_torch, and a read-back in a driver loop of the port is
  flagged (the JAX analyzer, keyed on fira_tpu/ paths, never was);
- the framework-neutral rules give the same (rule, line) as the JAX
  package's analyzer on the same sources, each at its own package's path;
- the port itself is CLEAN: the self-scan below, with every driver module
  named, exits 0 with no error and no unused waiver.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from fira_tpu.analysis import engine as jax_engine
from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis import cli as firacheck_cli
from fira_tpu_torch.analysis import engine, rules_concurrency, rules_purity
from fira_tpu_torch.analysis.findings import NOT_CHECKED, RULES, Severity

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "fira_tpu_torch")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_firacheck_hazards.py")
# the v2/v3 corpora hold framework-neutral hazards (threads, clocks,
# files, stats): both analyzers read them
FIXTURE_V2 = os.path.join(FIXTURES, "firacheck_hazards_v2.py")
FIXTURE_V3 = os.path.join(FIXTURES, "firacheck_hazards_v3.py")
# virtual driver paths: decode/beam.py arms the driver loops, the beam's
# step programs and GEOMETRY-DRIFT; serve/server.py arms the driver-scoped
# concurrency rules and the WALL-CLOCK scope
VIRTUAL_PATH = "virtual_fixture/fira_tpu_torch/decode/beam.py"
VIRTUAL_DRIVER_PATH = "virtual_fixture/fira_tpu_torch/serve/server.py"
JAX_DRIVER_PATH = "virtual_fixture/fira_tpu/serve/server.py"
# the corpus outside the driver registry: DRIVER-REG's module half arms
NON_DRIVER_PATH = "virtual_fixture/fira_tpu_torch/model/hazards.py"

# Every driver module of the port, named one by one: the self-scan passes
# each explicitly besides the package directory, and DRIVER-REG holds
# astutil._DRIVER_FILES against this list.
DRIVER_FILES = (
    "fira_tpu_torch/train/loop.py", "fira_tpu_torch/train/step.py",
    "fira_tpu_torch/decode/runner.py", "fira_tpu_torch/decode/beam.py",
    "fira_tpu_torch/decode/engine.py", "fira_tpu_torch/decode/paging.py",
    "fira_tpu_torch/decode/prefix_cache.py", "fira_tpu_torch/decode/spec.py",
    "fira_tpu_torch/decode/quant.py",
    "fira_tpu_torch/data/feeder.py", "fira_tpu_torch/data/buckets.py",
    "fira_tpu_torch/data/grouping.py",
    "fira_tpu_torch/parallel/fleet.py",
    "fira_tpu_torch/serve/server.py", "fira_tpu_torch/serve/disagg.py",
    "fira_tpu_torch/ingest/difftext.py", "fira_tpu_torch/ingest/service.py",
    "fira_tpu_torch/ingest/cache.py",
    "fira_tpu_torch/robust/faults.py", "fira_tpu_torch/robust/watchdog.py",
    "fira_tpu_torch/robust/recovery.py",
)

V1_RULES = {"HOST-SYNC", "RETRACE", "PRNG-REUSE", "DISCARDED-AT",
            "GEOMETRY-DRIFT"}
V2_FIXTURE_RULES = {"SHARED-MUT", "RETIRED-RECHECK", "SCHED-BLOCK",
                    "WALL-CLOCK", "FLOAT-ORDER", "KNOB-VALIDATE",
                    "FAULT-SITE"}
V3_FIXTURE_RULES = {"RES-LEAK", "DET-TAINT", "STATS-SCHEMA"}

_MARKER = re.compile(r"HAZARD\[([A-Z-]+)\]")

# a finding must NAME the discipline it enforces
_V2_MESSAGE_PINS = {
    "SHARED-MUT": ("written under a lock", "thread-entry path"),
    "RETIRED-RECHECK": ("without re-checking `self.retired`",),
    "SCHED-BLOCK": ("blocks uncancellably",),
    "WALL-CLOCK": ("virtual-clock replay",),
    "FLOAT-ORDER": ("float addition does not reassociate",),
    "KNOB-VALIDATE": ("named exit-2 rejection",),
    "FAULT-SITE": ("robust.faults.SITES", "CORRUPT_SITES"),
}
_V3_MESSAGE_PINS = {
    "RES-LEAK": ("never released or handed off on the fall-through path",
                 "can raise before the release of",
                 "_stamp_header() at server.py:",
                 "JournalHazard._begin() at server.py:"),
    "DET-TAINT": ("flows into byte sink",
                  "settle order", "os.listdir() scan order",
                  "_settled_tags() -> set() iteration order",
                  "json.dump() serialization inside _write_summary()"),
    "STATS-SCHEMA": ("is never serialized: summary()",
                     "the workers/pipeline_depth drift class"),
}


def _source(path=FIXTURE):
    with open(path) as f:
        return f.read()


def _expected_markers(source):
    out = set()
    for i, line in enumerate(source.splitlines(), start=1):
        for rule in _MARKER.findall(line):
            if rule in RULES:  # skips the docstring's HAZARD[RULE-ID] example
                out.add((rule, i))
    return out


def _rule_lines(findings, skip=("BAD-SUPPRESS",)):
    return {(f.rule, f.line) for f in findings if f.rule not in skip}


def _silenced_lines(source):
    return {i + 1  # the standalone waiver targets the NEXT code line
            for i, line in enumerate(source.splitlines(), start=1)
            if "SILENCED" in line and "firacheck: allow[" in line}


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f.message)
    return out


# --- every rule fires, in its torch form ---------------------------------

@pytest.mark.parametrize("fixture,path,fired_rules,pins", [
    (FIXTURE, VIRTUAL_PATH, V1_RULES, {}),
    (FIXTURE_V2, VIRTUAL_DRIVER_PATH, V2_FIXTURE_RULES, _V2_MESSAGE_PINS),
    (FIXTURE_V3, VIRTUAL_DRIVER_PATH, V3_FIXTURE_RULES, _V3_MESSAGE_PINS),
], ids=["v1-torch", "v2", "v3"])
def test_rules_fire_and_match_golden_markers(fixture, path, fired_rules,
                                             pins):
    source = _source(fixture)
    expected = _expected_markers(source)
    findings = engine.check_source(path, source)
    actual = _rule_lines(findings)
    assert actual == expected, (
        f"unexpected: {sorted(actual - expected)}; "
        f"missing: {sorted(expected - actual)}")
    assert {rule for rule, _ in actual} == fired_rules
    by_rule = _by_rule(findings)
    for rule, phrases in pins.items():
        for pin in phrases:
            assert any(pin in m for m in by_rule.get(rule, [])), (
                f"{rule}: no finding message contains {pin!r}")


@pytest.mark.parametrize("fixture,path,least", [
    (FIXTURE, VIRTUAL_PATH, 4),
    (FIXTURE_V2, VIRTUAL_DRIVER_PATH, 1),
    (FIXTURE_V3, VIRTUAL_DRIVER_PATH, 3),
], ids=["v1-torch", "v2", "v3"])
def test_silenced_twins_are_suppressed_but_fire_raw(fixture, path, least):
    source = _source(fixture)
    silenced = _silenced_lines(source)
    assert len(silenced) >= least, "corpus lost its SILENCED twins"
    suppressed = {line for _, line in
                  _rule_lines(engine.check_source(path, source))}
    raw = {line for _, line in _rule_lines(
        engine.check_source(path, source, suppress=False))}
    for line in silenced:
        assert line not in suppressed, (
            f"waiver on line {line - 1} did not silence its finding")
        assert line in raw, (
            f"SILENCED twin near line {line} stopped firing raw — the "
            f"waiver now waives nothing")


def test_v3_cross_function_leak_needs_the_call_graph():
    """The cross-function hazards exist BECAUSE the call graph carries
    facts across frames: blinding the helpers' bodies must lose them."""
    source = _source(FIXTURE_V3)
    full = _rule_lines(engine.check_source(VIRTUAL_DRIVER_PATH, source),
                       skip=())
    blinded = source.replace(
        '    fh.write("header\\n")\n    os.fsync(fh.fileno())\n',
        "    return None\n").replace(
        '    with open(path, "w") as fh:\n        json.dump(payload, fh)\n',
        "    return None\n")
    assert blinded != source, "fixture helper bodies moved; update test"
    blind = _rule_lines(engine.check_source(VIRTUAL_DRIVER_PATH, blinded),
                        skip=())
    lost = full - blind
    assert any(r == "RES-LEAK" for r, _ in lost)
    assert any(r == "DET-TAINT" for r, _ in lost)


@pytest.mark.parametrize("snippet,flagged", [
    ("torch.rand((2,))", True),
    ("torch.rand((2,), generator=gen)", False),
    ("torch.multinomial(p, 1)", True),
    ("x.uniform_()", True),
    ("x.uniform_(generator=gen)", False),
    ("np.random.rand(3)", True),
    ("np.random.default_rng(0)", False),
    ("rng.integers(0, 5)", False),
    ("random.random()", False),
])
def test_prng_reuse_is_a_draw_without_a_generator(snippet, flagged):
    """Torch's PRNG hazard is the draw that takes no generator: it reads
    and advances the process-global stream."""
    source = f"def draw(x, p, gen, rng):\n    return {snippet}\n"
    rules = [f.rule for f in engine.check_source("pkg/m.py", source)]
    assert rules == (["PRNG-REUSE"] if flagged else [])


def test_geometry_scope_is_package_segment_based(tmp_path):
    """A checkout directory named fira_tpu_torch must not arm the rule for
    its tests/ tree, and no path of the JAX package arms it; the port's
    sub-packages do."""
    src = "LIMIT = 650\n"
    tests_dir = tmp_path / "fira_tpu_torch" / "tests"
    tests_dir.mkdir(parents=True)
    (tests_dir / "test_x.py").write_text(src)
    assert not engine.check_paths([str(tests_dir / "test_x.py")])
    jax_dir = tmp_path / "fira_tpu" / "model"
    jax_dir.mkdir(parents=True)
    (jax_dir / "m.py").write_text(src)
    assert not engine.check_paths([str(jax_dir / "m.py")])
    pkg_dir = tmp_path / "fira_tpu_torch" / "fira_tpu_torch" / "model"
    pkg_dir.mkdir(parents=True)
    (pkg_dir / "m.py").write_text(src)
    found = engine.check_paths([str(pkg_dir / "m.py")])
    assert [f.rule for f in found] == ["GEOMETRY-DRIFT"]


def test_unparseable_file_gates_as_error():
    findings = engine.check_source("pkg/broken.py", "def broken(:\n")
    assert [f.rule for f in findings] == ["PARSE-ERROR"]
    assert findings[0].severity is Severity.ERROR


def test_wrong_rule_waiver_silences_nothing():
    source = _source()
    (line,) = [i for i, text in enumerate(source.splitlines(), start=1)
               if "a DISCARDED-AT waiver must NOT silence" in text]
    findings = engine.check_source(VIRTUAL_PATH, source)
    assert any(f.rule == "HOST-SYNC" and f.line == line for f in findings)
    assert any(f.rule == "BAD-SUPPRESS" and f.line == line
               and f.severity is Severity.WARNING for f in findings)


def test_reasonless_waiver_is_an_error():
    source = _source()
    (line,) = [i for i, text in enumerate(source.splitlines(), start=1)
               if re.search(r"firacheck: allow\[PRNG-REUSE\]\s*$", text)]
    findings = engine.check_source(VIRTUAL_PATH, source)
    assert any(f.rule == "BAD-SUPPRESS" and f.line == line
               and f.severity is Severity.ERROR for f in findings)


def test_donation_is_registered_but_not_checked(capsys):
    """torch donates no buffers: DONATION stays a known id (a waiver
    naming it parses), list-rules says why it is not checked, and no
    source ever produces it."""
    assert "DONATION" in RULES and "DONATION" in NOT_CHECKED
    assert firacheck_cli.main(["list-rules"]) == 0
    out = capsys.readouterr().out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("DONATION:")]
    assert "not checked" in line and "donates no buffers" in line
    source = ("def run(step, state, batch):\n"
              "    new = step(state, batch)\n"
              "    return new, state\n")
    assert not engine.check_source("fira_tpu_torch/train/loop.py", source)


_DRIVE = ("def drive(step, batches):\n"
          "    for b in batches:\n"
          "        m = step(b)\n"
          "        host = m.cpu()\n")


def test_driver_loop_designation_is_path_scoped():
    hot = engine.check_source("fira_tpu_torch/train/loop.py", _DRIVE)
    assert [f.rule for f in hot] == ["HOST-SYNC"]
    assert not engine.check_source("somepkg/driver.py", _DRIVE)
    # the JAX package's path of the same module does not arm the port
    assert not engine.check_source("fira_tpu/train/loop.py", _DRIVE)


def test_path_scoping_survives_subdirectory_cwd(monkeypatch):
    """Rule scoping normalizes to absolute paths: invoking the checker
    from inside the package must not silently disarm the driver rules."""
    monkeypatch.chdir(PACKAGE)
    hot = engine.check_source("train/loop.py", _DRIVE)
    assert any(f.rule == "HOST-SYNC" for f in hot)


def test_multi_rule_waiver_reports_stale_half():
    """allow[A,B] where only A matches must flag B as unused."""
    source = ("def drive(step, batches):\n"
              "    for b in batches:\n"
              "        # firacheck: allow[HOST-SYNC,RETRACE] boundary reason here\n"
              "        v = float(b.loss)\n"
              "        w = float(b)\n")
    findings = engine.check_source("fira_tpu_torch/train/loop.py", source)
    assert [(f.rule, f.line) for f in findings
            if f.rule == "HOST-SYNC"] == [("HOST-SYNC", 5)]  # A waived
    stale = [f for f in findings if f.rule == "BAD-SUPPRESS"]
    assert len(stale) == 1 and "RETRACE" in stale[0].message \
        and "HOST-SYNC" not in stale[0].message


# --- the CLI --------------------------------------------------------------

def test_cli_format_exit_codes_and_fixture_walk_skip(capsys):
    rc = firacheck_cli.main(["check", "--quiet", FIXTURE])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and out
    pattern = re.compile(r"^.+:\d+ \[[A-Z-]+\] (error|warning): .+$")
    for line in out:
        assert pattern.match(line), line
    files = engine.iter_py_files([os.path.dirname(FIXTURES)])
    assert FIXTURE not in files and FIXTURE_V2 not in files
    assert any(f.endswith("test_torch_analysis.py") for f in files)


def test_cli_json_output_and_rules_filter(capsys):
    rc = firacheck_cli.main(["check", "--quiet", "--json",
                             "--rules", "FAULT-SITE", FIXTURE_V2])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["files"] == 1
    # under its REAL (non-driver) path only the path-independent rules
    # fire: the two planted FAULT-SITE hazards survive the filter
    assert doc["per_rule"]["FAULT-SITE"] == 2
    assert doc["errors"] == 2
    assert set(doc["per_rule"]) == {"FAULT-SITE", "BAD-SUPPRESS",
                                    "PARSE-ERROR"}
    # the corpus's driver-scoped SILENCED waivers are unused under the
    # real path — the dead-waiver lint reports them even filtered
    assert doc["warnings"] >= 1
    for f in doc["findings"]:
        assert set(f) == {"path", "line", "rule", "severity", "message"}


def test_cli_rules_filter_rejects_unknown_rule(capsys):
    rc = firacheck_cli.main(["check", "--rules", "NOT-A-RULE", FIXTURE_V2])
    assert rc == 2
    err = capsys.readouterr().err
    assert "unknown rule id" in err and "'NOT-A-RULE'" in err
    for rule in RULES:
        assert rule in err, f"valid id {rule} missing from the error"


def test_cli_sarif_output(tmp_path, capsys):
    driver_copy = tmp_path / "fira_tpu_torch" / "serve" / "server.py"
    driver_copy.parent.mkdir(parents=True)
    driver_copy.write_text(_source(FIXTURE_V3))
    out = tmp_path / "v3.sarif"
    rc = firacheck_cli.main(["check", "--quiet", "--sarif", str(out),
                             "--rules", "RES-LEAK,DET-TAINT",
                             "--no-suppress", str(driver_copy)])
    capsys.readouterr()
    assert rc == 1
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    assert doc["$schema"].endswith("sarif-schema-2.1.0.json")
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "firacheck"
    assert {r["id"] for r in driver["rules"]} == {
        "RES-LEAK", "DET-TAINT", "BAD-SUPPRESS", "PARSE-ERROR"}
    assert all(r["shortDescription"]["text"] == RULES[r["id"]]
               for r in driver["rules"])
    results = run["results"]
    assert {r["ruleId"] for r in results} == {"RES-LEAK", "DET-TAINT"}
    for r in results:
        (loc,) = r["locations"]
        phys = loc["physicalLocation"]
        assert phys["artifactLocation"]["uri"].endswith(
            "fira_tpu_torch/serve/server.py")
        assert phys["region"]["startLine"] >= 1 and r["message"]["text"]
    raw = engine.check_source(VIRTUAL_DRIVER_PATH, _source(FIXTURE_V3),
                              suppress=False)
    expected = {(f.rule, f.line) for f in raw
                if f.rule in ("RES-LEAK", "DET-TAINT")}
    got = {(r["ruleId"],
            r["locations"][0]["physicalLocation"]["region"]["startLine"])
           for r in results}
    assert got == expected


def test_empty_or_mistyped_path_gates(capsys, tmp_path):
    assert firacheck_cli.main(["check", "--quiet",
                               str(tmp_path / "no_such_dir")]) == 1
    assert "no Python files" in capsys.readouterr().err


def test_list_rules_covers_registry(capsys):
    assert firacheck_cli.main(["list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out


def test_docs_cover_every_rule():
    with open(os.path.join(REPO_ROOT, "docs", "ANALYSIS_TORCH.md")) as f:
        doc = f.read()
    for rule in RULES:
        if rule not in ("BAD-SUPPRESS", "PARSE-ERROR"):
            assert rule in doc, f"{rule} missing from docs/ANALYSIS_TORCH.md"


# --- DRIVER-REG -------------------------------------------------------------

def test_driver_reg_fires_raw_on_the_corpus_outside_the_registry():
    """The v1 corpus builds programs: outside the driver registry it IS
    an unregistered program module, flagged once at the earliest build
    and swallowed by the corpus's reasoned waiver."""
    source = _source()
    raw = engine.check_source(NON_DRIVER_PATH, source, suppress=False)
    assert len([f for f in raw if f.rule == "DRIVER-REG"]) == 1
    suppressed = engine.check_source(NON_DRIVER_PATH, source)
    assert not any(f.rule == "DRIVER-REG" for f in suppressed)


@pytest.mark.parametrize("body,phrase", [
    ("from fira_tpu_torch.decode.engine import SlotEngine\n"
     "def drive(model, cfg):\n"
     "    return SlotEngine(model, cfg)\n", "steppables"),
    ("from fira_tpu_torch.analysis.sanitizer import program_label\n"
     "def drive(guard, step, batch):\n"
     "    guard.step(program_label('train_step'), step(batch))\n",
     "program_label"),
    ("import torch\n"
     "def make_step(fn):\n"
     "    return torch.compile(fn)\n", "torch.compile"),
], ids=["steppable", "program_label", "compile"])
def test_driver_reg_flags_unregistered_module(tmp_path, body, phrase):
    pkg = tmp_path / "fira_tpu_torch" / "extra"
    pkg.mkdir(parents=True)
    (pkg / "newdriver.py").write_text(body)
    found = engine.check_paths([str(pkg / "newdriver.py")])
    assert [f.rule for f in found] == ["DRIVER-REG"]
    assert "_DRIVER_FILES" in found[0].message and phrase in found[0].message


def test_driver_reg_flags_driver_unnamed_in_the_self_scan(tmp_path):
    """The registry half: a _DRIVER_FILES entry the adjacent self-scan
    test does not name gates at the entry's line."""
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_analysis.py").write_text(
        'NAMED = ("fira_tpu_torch/named/mod.py",)\n')
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "reg.py").write_text(
        '_DRIVER_FILES = (\n'
        '    "named/mod.py",\n'
        '    "unnamed/mod.py",\n'
        ')\n')
    found = engine.check_paths([str(pkg / "reg.py")])
    assert [f.rule for f in found] == ["DRIVER-REG"]
    assert "unnamed" in found[0].message \
        and "test_torch_analysis.py" in found[0].message
    assert found[0].line == 3


# --- armed on the port ------------------------------------------------------

def test_every_path_scoped_registry_names_a_file_of_the_port():
    """A registry entry that matches no file of the port disarms its
    rule silently — the failure this analyzer was written to end."""
    assert tuple(f"fira_tpu_torch/{e}" for e in astutil._DRIVER_FILES) \
        == DRIVER_FILES
    for entry in astutil._DRIVER_FILES:
        assert os.path.isfile(os.path.join(PACKAGE, entry)), entry
    for entry in rules_concurrency._VIRTUAL_CLOCK_FILES:
        assert entry in astutil._DRIVER_FILES, entry
    for sub in rules_purity._GEOMETRY_SUBPACKAGES:
        assert os.path.isdir(os.path.join(PACKAGE, sub)), sub
    for entry, names in astutil._STEP_PROGRAMS.items():
        assert entry in astutil._DRIVER_FILES, entry
        with open(os.path.join(PACKAGE, entry)) as f:
            defs = astutil.qualified_defs(ast.parse(f.read()))
        for name in names:
            assert name in defs, f"{entry}: no step program {name}"


def test_a_readback_in_a_port_driver_loop_is_flagged(tmp_path):
    """A .cpu() inside a loop of the port's decode/engine.py is a
    HOST-SYNC finding; the same file under the JAX package's path is not
    a driver of the port."""
    for pkg, flagged in (("fira_tpu_torch", True), ("fira_tpu", False)):
        path = tmp_path / pkg / "decode" / "engine.py"
        path.parent.mkdir(parents=True)
        path.write_text(_DRIVE)
        found = [f for f in engine.check_paths([str(path)])
                 if f.rule == "HOST-SYNC"]
        assert bool(found) is flagged, pkg
        if flagged:
            assert ".cpu()" in found[0].message


# --- held against the JAX package's analyzer --------------------------------

@pytest.mark.parametrize("rule,fixture", [
    ("SHARED-MUT", FIXTURE_V2), ("RETIRED-RECHECK", FIXTURE_V2),
    ("SCHED-BLOCK", FIXTURE_V2), ("WALL-CLOCK", FIXTURE_V2),
    ("FLOAT-ORDER", FIXTURE_V2), ("DET-TAINT", FIXTURE_V3),
    ("RES-LEAK", FIXTURE_V3), ("KNOB-VALIDATE", FIXTURE_V2),
    ("FAULT-SITE", FIXTURE_V2),
])
def test_framework_neutral_rules_match_the_jax_analyzer(rule, fixture):
    """On one source, each at its own package's driver path, the port's
    analyzer and fira_tpu.analysis give the same (rule, line) pairs, raw
    and with the waivers folded in."""
    source = _source(fixture)
    for suppress in (False, True):
        port = {(f.rule, f.line) for f in engine.check_source(
            VIRTUAL_DRIVER_PATH, source, suppress=suppress)
            if f.rule == rule}
        ref = {(f.rule, f.line) for f in jax_engine.check_source(
            JAX_DRIVER_PATH, source, suppress=suppress) if f.rule == rule}
        assert port == ref and port, (rule, suppress, port, ref)


# --- the port itself is clean -----------------------------------------------

@pytest.fixture(scope="module")
def self_scan():
    """The documented invocation with every driver module named, as JSON:
    (exit code, document, stderr)."""
    proc = subprocess.run(
        [sys.executable, "-m", "fira_tpu_torch.analysis.cli", "check",
         "--json", "fira_tpu_torch", *DRIVER_FILES],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    return proc.returncode, json.loads(proc.stdout), proc.stderr


def test_cli_self_scan_contract(self_scan):
    rc, doc, err = self_scan
    assert rc == 0, err
    assert doc["errors"] == 0
    assert "firacheck: 0 error(s), 0 warning(s)" in err
    # the named driver files were deduped into the directory walk
    assert doc["files"] == len(engine.iter_py_files([PACKAGE]))


def test_repo_self_scan_is_clean(self_scan):
    errors = [f for f in self_scan[1]["findings"] if f["severity"] == "error"]
    assert not errors, errors


def test_repo_has_no_stale_waivers(self_scan):
    stale = [f for f in self_scan[1]["findings"]
             if f["rule"] == "BAD-SUPPRESS"]
    assert not stale, stale


def test_repo_v3_scan_is_warning_free(self_scan):
    v3 = [f for f in self_scan[1]["findings"]
          if f["rule"] in ("RES-LEAK", "DET-TAINT", "STATS-SCHEMA")]
    assert not v3, v3


def test_no_suppress_view_lists_every_waived_readback():
    """The audit view shows what the waivers hold: the armed scan's
    findings of the JAX analyzer's kinds and the torch read-backs, each
    waived (the clean self-scan above) or fixed (no GEOMETRY-DRIFT)."""
    raw = engine.check_paths([PACKAGE], suppress=False)
    counts = {}
    for f in raw:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    assert counts.get("HOST-SYNC", 0) >= 53
    assert counts.get("SCHED-BLOCK", 0) >= 5
    assert counts.get("WALL-CLOCK", 0) >= 5
    assert "GEOMETRY-DRIFT" not in counts and "KNOB-VALIDATE" not in counts
    seen = {(f.path.replace(os.sep, "/").split("fira_tpu_torch/")[-1],
             f.message.split(" inside hot region")[0]) for f in raw
            if f.rule == "HOST-SYNC"}
    for want in (("decode/beam.py", ".all() result used as a truth value"),
                 ("decode/spec.py", ".any() result used as a truth value"),
                 ("decode/engine.py", ".cpu()"),
                 ("decode/engine.py", ".numpy()"),
                 ("decode/runner.py", ".cpu()"),
                 ("decode/runner.py", ".tolist()"),
                 ("train/loop.py", ".cpu()"),
                 ("train/loop.py", ".tolist()")):
        assert want in seen, want

"""Importing every module of the port pulls in no JAX, flax, orbax and
nothing of the JAX package ``fira_tpu``. Checked in a fresh interpreter:
this test process has imported ``fira_tpu`` already (tests/conftest.py).
The JAX package's static analyzer (``fira_tpu.analysis.cli check``) finds
no error in the port."""

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import fira_tpu_torch
names = ["fira_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fira_tpu_torch.__path__,
                                          "fira_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "orbax", "fira_tpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in banned)
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# modules each slice added, which the walk must find and import
REQUIRED = ("fira_tpu_torch.robust.faults", "fira_tpu_torch.robust.watchdog",
            "fira_tpu_torch.serve.arrivals", "fira_tpu_torch.serve.server",
            "fira_tpu_torch.decode.prefix_cache",
            "fira_tpu_torch.decode.engine", "fira_tpu_torch.ingest.cache",
            "fira_tpu_torch.parallel.fleet",
            "fira_tpu_torch.robust.recovery", "fira_tpu_torch.cli",
            "fira_tpu_torch.decode.quant", "fira_tpu_torch.decode.spec",
            "fira_tpu_torch.serve.disagg", "fira_tpu_torch.parallel.mesh",
            "fira_tpu_torch.parallel.ring", "fira_tpu_torch.parallel.jobs",
            "fira_tpu_torch.model.ablate_embed")


def test_port_imports_no_jax_and_nothing_of_fira_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad, names = proc.stdout.split("\n")[:3]
    assert int(n_modules) >= 20          # the walk found the whole package
    assert bad == "", f"the port imported {bad}"
    assert not set(REQUIRED) - set(names.split(","))


def test_analyzer_finds_no_error_in_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "fira_tpu.analysis.cli", "check",
         "fira_tpu_torch"], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    summary = [line for line in (proc.stdout + proc.stderr).splitlines()
               if line.startswith("firacheck:")]
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert summary and summary[-1].startswith("firacheck: 0 error(s)"), \
        proc.stdout

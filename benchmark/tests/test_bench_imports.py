"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference loads nothing of the port."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RUN_TINY = """
import sys, tempfile, torch
sys.path[:0] = [{root!r}, {tests!r}]
import tiny
from benchmark.harness import bench
tmp = tempfile.TemporaryDirectory()
d = tmp.name
spec = tiny.write(d)
bench.run_cell("train.tiny", 3, 0.5, False, torch.device("cpu"), torch,
               bench=spec, bench_dir=d + "/benchmark")
import benchmark.control, benchmark.roofline
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.model, benchmark.reference.batch
import benchmark.harness.weights, benchmark.gen.commits, benchmark.roofline
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def top_level(code):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tests = os.path.join(ROOT, "benchmark", "tests")
    mods = top_level(RUN_TINY.format(root=ROOT, tests=tests))
    assert "fira_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "fira_tpu"}


def test_reference_loads_nothing_of_the_port():
    mods = top_level(REFERENCE.format(root=ROOT))
    assert not mods & {"jax", "jaxlib", "flax", "fira_tpu", "fira_tpu_torch"}

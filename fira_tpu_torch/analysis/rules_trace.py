"""RETRACE (counterpart of ``fira_tpu/analysis/rules_trace.py``): a
program built inside a loop.

JAX's RETRACE is the one-compile contract: a ``jax.jit`` constructed in
a loop body recompiles every iteration. Eager torch compiles nothing;
its programs are the ones a caller builds on purpose — a CUDA graph
captured with ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)``, or
a ``torch.compile(...)`` callable — and the hazard is the same: built in
a loop body, or anywhere inside a hot region (a driver loop or a step
program, astutil.hot_spans), one capture or compile runs per iteration
instead of one per run. None exists in the port yet; a CUDA graph of
the slot engine's step (ROADMAP.md A.5) will be held to this.

JAX's other two RETRACE forms have no torch counterpart: there are no
static arguments to hash, and an eager closure bakes nothing into a
trace. DONATION has none either (findings.NOT_CHECKED).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.findings import Finding, Severity

_PROGRAM_CALLS = {
    "torch.cuda.CUDAGraph": "torch.cuda.CUDAGraph()",
    "torch.cuda.graph": "torch.cuda.graph(...)",
    "torch.compile": "torch.compile(...)",
}


def program_construction(call: ast.Call) -> Optional[str]:
    """What program ``call`` builds, or None."""
    return _PROGRAM_CALLS.get(astutil.call_name(call) or "")


def _enclosing_loop_same_frame(node: ast.AST, parents) -> Optional[ast.AST]:
    for a in astutil.ancestors(node, parents):
        if isinstance(a, astutil.FunctionNode):
            return None
        if isinstance(a, (ast.For, ast.While)):
            return a
    return None


def check(path: str, tree: ast.AST, source: str, parents, spans,
          ) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = program_construction(node)
        if what is None:
            continue
        loop = _enclosing_loop_same_frame(node, parents)
        if loop is not None:
            where = f"inside the loop at line {loop.lineno}"
        else:
            region = astutil.hot_region_at(spans, node.lineno)
            if region is None:
                continue
            where = f"inside hot region [{region.desc}]"
        findings.append(Finding(
            path, node.lineno, "RETRACE", Severity.ERROR,
            f"{what} built {where}: every iteration captures or compiles "
            f"a fresh program instead of replaying one; build it once, "
            f"outside the loop"))
    return findings

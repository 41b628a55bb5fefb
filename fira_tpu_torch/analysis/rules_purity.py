"""PRNG-REUSE, DISCARDED-AT, GEOMETRY-DRIFT (counterpart of
``fira_tpu/analysis/rules_purity.py``): each JAX hazard in its torch form.

PRNG-REUSE — JAX's hazard is one key fed to two consumers; torch has no
keys, and its hazard is the draw that takes no generator at all: a
``torch.rand*``/``randint``/``randperm``/``bernoulli``/``multinomial``/
``normal``/``x.normal_()``-style call, or an ``np.random.<fn>`` module
function, without an explicit ``generator=`` (or a ``Generator`` object
to draw from) reads and advances the process-global stream. Any other
draw in between (a data loader, a library, another thread) shifts it,
so two runs from one seed diverge — the correlation bug's torch twin.

DISCARDED-AT — ``x.at[i].set(v)``'s torch twin runs the other way: the
out-of-place ``x.index_put(...)`` / ``scatter`` / ``masked_fill`` /
``index_fill`` / ``clamp`` returns a NEW tensor, so as a bare expression
statement it is a silent no-op where the in-place ``_`` form was meant.

GEOMETRY-DRIFT — the fixed geometry (210/30/25/280/160/650, config.py)
is the one-signature contract's unit of account. A re-typed literal in
package code silently diverges when a config scales; the named field
must be referenced. Scoped to ``fira_tpu_torch/``'s subpackages (minus
config.py, where the numbers are DEFINED, and this analysis package).
"""

from __future__ import annotations

import ast
from typing import List, Optional

from fira_tpu_torch.analysis import astutil
from fira_tpu_torch.analysis.findings import Finding, Severity

# torch functions that draw from a generator (the `generator=` keyword)
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
# in-place tensor methods that draw from a generator
_INPLACE_DRAWS = {
    "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}
# np.random names that build a Generator (or seed one), not draws
_NP_CONSTRUCTORS = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937", "BitGenerator",
}
_NP_RANDOM = ("np.random.", "numpy.random.")

_GEOMETRY = {
    210: "sou_len", 30: "tar_len", 25: "att_len", 280: "ast_change_len",
    160: "sub_token_len", 650: "graph_len",
}
_OUT_OF_PLACE = {
    "index_put", "scatter", "masked_fill", "index_fill", "clamp",
    "index_add", "index_copy", "scatter_add", "scatter_reduce",
    "masked_scatter", "clamp_min", "clamp_max", "clip",
}


def _global_draw(call: ast.Call) -> Optional[str]:
    """The draw ``call`` makes from the global generator, or None."""
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    name = astutil.call_name(call) or ""
    for prefix in _NP_RANDOM:
        if name.startswith(prefix):
            fn = name[len(prefix):]
            if "." not in fn and fn not in _NP_CONSTRUCTORS:
                return f"{name}(...)"
            return None
    if name.startswith("torch.") and name[len("torch."):] in _TORCH_DRAWS:
        return f"{name}(...)"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _INPLACE_DRAWS:
        return f".{call.func.attr}(...)"
    return None


def check_prng(path: str, tree: ast.AST, source: str, parents, spans,
               ) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _global_draw(node)
        if what:
            findings.append(Finding(
                path, node.lineno, "PRNG-REUSE", Severity.ERROR,
                f"{what} draws from the process-global generator: any "
                f"other draw in between shifts its stream, so one seed no "
                f"longer fixes the result — pass generator= (or draw from "
                f"a seeded Generator object)"))
    return findings


def check_discarded_at(path: str, tree: ast.AST, source: str, parents,
                       spans) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Expr) and isinstance(node.value,
                                                          ast.Call)):
            continue
        call = node.value
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _OUT_OF_PLACE:
            findings.append(Finding(
                path, node.lineno, "DISCARDED-AT", Severity.ERROR,
                f"result of .{call.func.attr}(...) is discarded — the "
                f"out-of-place update returns a new tensor; assign it, or "
                f"use the in-place .{call.func.attr}_(...)"))
    return findings


# sub-packages whose code must reference the named geometry; NOT analysis/
# (this package), config.py (where the numbers are DEFINED), or anything
# outside the package (tests/scripts assert literal geometry legitimately)
_GEOMETRY_SUBPACKAGES = {"model", "data", "decode", "train", "ops",
                         "parallel", "eval", "preprocess", "utils"}


def check_geometry(path: str, tree: ast.AST, source: str, parents, spans,
                   ) -> List[Finding]:
    rel = astutil.module_key(path)
    if rel is None or rel.split("/")[0] not in _GEOMETRY_SUBPACKAGES:
        return []
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and type(node.value) is int
                and node.value in _GEOMETRY):
            field = _GEOMETRY[node.value]
            findings.append(Finding(
                path, node.lineno, "GEOMETRY-DRIFT", Severity.ERROR,
                f"literal {node.value} shadows cfg.{field}; reference the "
                f"named geometry so scaled configs can't silently diverge "
                f"from the compiled shapes"))
    return findings

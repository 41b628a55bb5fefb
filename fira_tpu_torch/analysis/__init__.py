"""firacheck for the port (counterpart of ``fira_tpu/analysis``): the
static analyzer and the runtime sanitizer.

- static: ``python -m fira_tpu_torch.analysis.cli check fira_tpu_torch``
  walks the AST of every file and emits ``file:line [RULE-ID] severity:
  message`` findings (nonzero exit on errors; ``--json``, ``--sarif``,
  ``--rules`` and ``--no-suppress`` as in the JAX package's CLI). Its
  path-scoped rules key on the ``fira_tpu_torch`` segment of a path, so
  they arm on this package's own driver modules (astutil._DRIVER_FILES)
  and step programs (astutil._STEP_PROGRAMS); the JAX analyzer, keyed on
  ``fira_tpu/``, never arms them here. HOST-SYNC knows torch's
  read-backs (``.item()``/``.cpu()``/``.numpy()``/``.tolist()``/
  ``.to("cpu")``/``synchronize()``, a tensor truth value), PRNG-REUSE
  is a draw from the global generator, DISCARDED-AT a discarded
  out-of-place update, RETRACE a CUDA graph or ``torch.compile`` built in
  a loop; DONATION has no torch form. docs/ANALYSIS_TORCH.md holds each
  rule's torch form and the waiver triage.
- runtime: :mod:`fira_tpu_torch.analysis.sanitizer`, armed by
  ``--sanitize`` on the CLI.

Deliberate boundary syncs are waived in place with the JAX package's
directive, ``# firacheck: allow[RULE-ID] <reason naming the invariant>``:
a reason is mandatory, and only the JAX package's rule ids parse, so a
waiver holds under both analyzers.
"""

from fira_tpu_torch.analysis.findings import Finding, Severity  # noqa: F401
from fira_tpu_torch.analysis.engine import check_paths, check_source  # noqa: F401

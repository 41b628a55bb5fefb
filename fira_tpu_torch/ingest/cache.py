"""The ingest fast path's knobs (the JAX package's ``ingest/cache.py``).

The port holds only the execution modes ``ingest.service.ingest_errors``
validates ``cfg.ingest_exec`` against. The whole-diff result cache, the
hunk and lexer memos and the parse-stage process executor come with
serving raw diffs (ROADMAP A.8).
"""

# "thread": the AST parse stage runs inline on the ingest worker;
# "process": it runs on a spawned process pool
EXEC_MODES = ("thread", "process")

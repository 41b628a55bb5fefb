"""Raw-diff ingest (the port's ``fira_tpu/ingest``, docs/INGEST.md):
``difftext`` is the text front end (unified-diff parse/reconstruct + Java
lexing); ``service`` the per-request pipeline (FSM -> AST extraction ->
frozen-vocab encode -> wire payload), ``serve_diffs`` (``cli serve --input
diffs``) and ``one_shot_message`` (``cli message``); ``cache`` the ingest
fast path (the whole-diff result cache, the hunk and lexer memos, the
parse-stage process executor).
"""

from fira_tpu_torch.ingest.cache import (  # noqa: F401
    HunkMemo,
    IngestCache,
    IngestExecutor,
    LexMemo,
    text_digest,
)
from fira_tpu_torch.ingest.difftext import (  # noqa: F401
    DiffParseError,
    DiffRequest,
    parse_request,
    read_diff_trace,
    reconstruct_diff,
    reconstruct_request,
    write_diff_trace,
)
from fira_tpu_torch.ingest.service import (  # noqa: F401
    IngestError,
    build_fast_path,
    ingest_errors,
    ingest_record,
    ingest_request,
    ingest_request_tasks,
    one_shot_message,
    serve_diffs,
)

"""Raw-diff ingest (the port's ``fira_tpu/ingest``, docs/INGEST.md):
``difftext`` is the text front end (unified-diff parse/reconstruct + Java
lexing); ``service`` the per-request pipeline (FSM -> AST extraction ->
frozen-vocab encode -> wire payload) and ``one_shot_message``, the
diff-in, message-out path of ``cli message``.
"""

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
    ingest_errors,
    ingest_record,
    ingest_request,
    one_shot_message,
)

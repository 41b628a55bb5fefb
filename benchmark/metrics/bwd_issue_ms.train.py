"""Median host time of a training step's backward, in ms: the program's
``train.backward`` span (``fira_tpu_torch.utils.profiling``) around
``sanitizer.backward`` in ``train_step`` (autograd's issue of the
backward, K2's Python ``backward`` included), read from the program's
recorder in the benchmark's process after the driver returns. The
recorder holds set-up's steps beside the window's (5 beside about 550 at
fira-full), which a median does not feel. None where the program records
no such span (a program without the recorder)."""

SPAN = "train.backward"


def read(rec):
    if rec["driver"] != "train":
        return None
    from fira_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    got = spans().get(SPAN) if spans is not None else None
    if not got or not got["count"]:
        return None
    return 1e3 * got["median_s"]

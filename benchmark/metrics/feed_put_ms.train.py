"""Median host time of the Feeder's put a batch, in ms: the program's
``feeder.put`` span (``fira_tpu_torch.utils.profiling``): sharding,
pinning and queueing the batch's copies to the card on the consumer's
thread. The batch is padded to the full geometry, so its bytes do not
depend on the commits' lengths. Read from the program's recorder in the
benchmark's process after the driver returns; the recorder holds
set-up's batches beside the window's (5 beside about 550 at fira-full),
which a median does not feel. None where the program records no such
span (a program without the recorder)."""

SPAN = "feeder.put"


def read(rec):
    if rec["driver"] != "train":
        return None
    from fira_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    got = spans().get(SPAN) if spans is not None else None
    if not got or not got["count"]:
        return None
    return 1e3 * got["median_s"]

"""``torch.cuda.max_memory_allocated()`` from the start of set-up to the
window's end, read before the correctness check, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec["peak_bytes"] else None

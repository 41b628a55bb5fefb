"""K1's share of its roofline in training: its least time at the step's
shape (``roofline.k1_bound_s``) over its device time a launch
(``copy_score_tile_kernel``) in the traced steps, in %."""

from benchmark.harness.trace import kernel_time


def read(rec):
    hit = rec["driver"] == "train" and kernel_time(rec.get("trace"),
                                                   "copy_score_tile_kernel")
    if not hit:
        return None
    seconds, launches = hit
    return 100.0 * rec["k1_bound_s"] / (seconds / launches)

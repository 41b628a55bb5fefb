"""K2's share of its roofline: its least time at the step's shape
(``roofline.k2_bound_s``) over its device time a step (both of its
kernels, ``copy_score_bwd_kernel`` and ``copy_score_bwd_dtgt_kernel``)
in the traced steps, in %."""

from benchmark.harness.trace import kernel_time


def read(rec):
    tr = rec.get("trace")
    if rec["driver"] != "train":
        return None
    both = kernel_time(tr, "copy_score_bwd")
    main = kernel_time(tr, "copy_score_bwd_kernel")
    if not both or not main:
        return None
    return 100.0 * rec["k2_bound_s"] / (both[0] / main[1])

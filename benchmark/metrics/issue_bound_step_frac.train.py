"""Share of the training steps that began on a drained card, in %: the
program's ``train.issue_bound`` counter over its ``train.steps``
(``fira_tpu_torch.utils.profiling``). Each optimizer step on a CUDA device
records an event after its last launch, and the next step asks, without
blocking, whether that event has completed when its issue begins: if so,
the card had run all of the previous step and waited for the host. Read
in the benchmark's process after the driver returns; the counters hold
set-up's steps beside the window's (5 beside about 550 at fira-full).
None where the program counts no step (a program without the
recorder)."""


def read(rec):
    if rec["driver"] != "train":
        return None
    from fira_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    got = counters() if counters is not None else {}
    steps = got.get("train.steps", 0)
    if not steps:
        return None
    return 100.0 * got.get("train.issue_bound", 0) / steps

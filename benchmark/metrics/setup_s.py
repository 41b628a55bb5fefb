"""Seconds from the process's start to the window's start: imports, the
pool and its tensorisation, the weights, the kernels' build and first
launches, the warm steps or the engine's prewarm and ramp."""


def read(rec):
    return rec["setup_s"]

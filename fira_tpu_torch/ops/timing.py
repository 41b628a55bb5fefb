"""Device time of a kernel on the card, and the card's name and power
limit, for ``chip_smoke.py`` and the kernel ablations (``ablate_fwd``,
``ablate_bwd``). Needs a CUDA card."""

from __future__ import annotations

import subprocess

import torch

FLUSH_BYTES = 128 * 2**20     # over twice the H100's 50 MB L2


def time_ms(fn, n: int = 50) -> float:
    """Median device time of ``fn()`` in ms over ``n`` launches, each after
    a 128 MB write that evicts the inputs from L2 (the decode step finds
    the copy head's inputs cold: the decoder's weights and caches pass
    through L2 between two copy-score launches). The write leaves L2
    holding dirty lines, which a kernel's misses first write back, as
    after the activations a step writes. A long matrix product queued
    first keeps the device busy while the host queues every launch, so the
    events time the device alone, not the host's launch overhead."""
    buf = torch.ones(FLUSH_BYTES // 4, device="cuda")
    hold = torch.ones((8192, 8192), device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    hold @ hold
    for _ in range(n):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def smi_name_power() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]

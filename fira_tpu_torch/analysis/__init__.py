"""The runtime sanitizer (the port's copy of the runtime half of
``fira_tpu/analysis``): :mod:`fira_tpu_torch.analysis.sanitizer`, armed by
``--sanitize`` on the CLI.

The JAX package's static analyzer (the rest of ``fira_tpu/analysis``) is
not ported: its rules read JAX idioms (jit, donation, PRNG keys), and it
already runs over this package as it stands (``python -m
fira_tpu.analysis.cli check fira_tpu_torch``)."""

"""Host-side utilities of the port: :mod:`fira_tpu_torch.utils.profiling`
(the trace window, step annotations and the throughput meter).

The JAX package's ``utils/backend_guard.py`` pins JAX's platform before
its first import; torch picks its device per call, so it has no
counterpart here."""

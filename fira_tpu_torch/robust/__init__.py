"""Fault injection and graceful degradation for the serving stack (the
port's copy of ``fira_tpu/robust``):

- :mod:`fira_tpu_torch.robust.faults`: named injection sites armed by a
  parse-time-checked spec (``site:kind:rate:seed``), deterministic given
  the seed, off by default (every site check is one ``is not None``);
- :mod:`fira_tpu_torch.robust.watchdog`: a per-dispatch wall-clock
  watchdog (the call runs on a worker thread and is abandoned on expiry),
  behind the serve loop's replica retirement and the train loop's
  dev-gate skip;
- :mod:`fira_tpu_torch.robust.recovery`: the self-healing half, replica
  respawn and warm spares (``RecoveryManager``), the request journal and
  the crash-pair recovery behind ``cli serve --resume``.
"""

from fira_tpu_torch.robust.faults import (FaultInjector,  # noqa: F401
                                          FaultSpec, InjectedFault,
                                          injector_from, parse_fault_specs,
                                          robust_errors)
from fira_tpu_torch.robust.watchdog import (WatchdogTimeout,  # noqa: F401
                                            run_with_watchdog)

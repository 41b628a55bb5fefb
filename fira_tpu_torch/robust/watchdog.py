"""Per-dispatch wall-clock watchdog (counterpart of
``fira_tpu/robust/watchdog.py``).

A hung dispatch (a wedged device, an injected ``hang`` fault) cannot be
interrupted from Python, but it can be abandoned: run it on a worker
thread, wait the timeout, and on expiry raise :class:`WatchdogTimeout` to
the caller while the thread runs on. The caller must then retire whatever
state the abandoned call mutates (the serve loop retires the engine: its
``retired`` flag is set, and every piece of the engine returns early once
it sees it, so the abandoned thread queues no work on the card and
touches no arena state when it wakes; see decode/engine.py).

``timeout_s <= 0`` is the off switch: the callable runs inline on the
caller's thread. Armed, every guarded dispatch pays one thread start and
join.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from fira_tpu_torch.analysis.sanitizer import leak_guard


class WatchdogTimeout(RuntimeError):
    """A dispatch exceeded its wall-clock budget and was abandoned."""


def run_with_watchdog(fn: Callable[[], Any], timeout_s: float, *,
                      label: str = "",
                      cancel_event: "threading.Event" = None) -> Any:
    """Run ``fn()`` under a ``timeout_s`` wall-clock watchdog.

    ``timeout_s <= 0``: call inline. Otherwise the call runs on a daemon
    thread; if it has not returned within the timeout,
    :class:`WatchdogTimeout` raises here and the thread is abandoned (the
    caller retires the state it may still mutate). The callable's own
    exception, if it finishes in time, re-raises unchanged.

    ``cancel_event``: set on expiry before the timeout raises, a
    cooperative kill switch for callables that poll it (the dev gate
    checks it a batch, train/loop.py), so an abandoned call stops working
    instead of racing what runs after it."""
    if timeout_s <= 0:
        return fn()
    box: dict = {}

    def body() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            box["error"] = e

    t = threading.Thread(target=body, name="fira-dispatch-watchdog",
                         daemon=True)
    lg = leak_guard()
    t.start()
    if lg is not None:
        lg.track_thread(t, what="dispatch-watchdog thread")
    t.join(timeout_s)
    if t.is_alive():
        if lg is not None:
            # sanctioned: a blown dispatch is abandoned by design (the
            # thread stops at its next retired check); the ledger records
            # the reason instead of calling it a leak at teardown
            lg.abandon_thread(t, "watchdog expiry — abandoned by design")
        if cancel_event is not None:
            cancel_event.set()
        raise WatchdogTimeout(
            f"dispatch{f' {label}' if label else ''} exceeded the "
            f"{timeout_s:.3f}s wall-clock watchdog and was abandoned")
    if lg is not None:
        lg.note_joined(t)
    if "error" in box:
        raise box["error"]
    return box.get("value")

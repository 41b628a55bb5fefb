"""Online serving on the slot engine (the port's ``fira_tpu/serve``): an
open-loop load generator (``arrivals``: Poisson at an offered rate, or a
replayable arrival-trace file) feeds an arrival-timed admission queue;
the serving loop (``server``) forms prefill batches from live arrivals,
caps the prefills between step dispatches, sheds on backpressure (a
bounded queue, per-request deadlines: recorded, never a hang) and meters
each request's TTFT and end-to-end latency. The disaggregated prefill
tier (``disagg``) runs the prefills in worker processes that seed the
engines' prefix caches.
"""

from fira_tpu_torch.serve.arrivals import (poisson_times,  # noqa: F401
                                           read_trace, write_trace)
from fira_tpu_torch.serve.server import (RequestRecord,  # noqa: F401
                                         ServeStats, serve_errors,
                                         serve_split)

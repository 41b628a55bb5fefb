"""Rank jobs that only the port's mesh and ring tests send
(``tests/test_torch_mesh.py``, ``tests/test_torch_ring.py``): each runs
in every rank of a ``RankPool`` as ``fn(mesh, ...)``. A spawned rank
imports this module by name from the caller's ``sys.path``, so it imports
nothing but torch and the port, never JAX.

- :func:`ring_job`: ``parallel.ring.ring_attend`` on this rank's rows and
  the gradient of ``sum(out ** 2)`` through the ring's backward.
- :func:`modules_job`: the top-level packages a rank has imported.
"""

from __future__ import annotations

import sys
from typing import Dict, List


def ring_job(mesh, q, k, v, kv_mask, causal: bool = False) -> Dict:
    """:func:`ring_attend` on this rank's rows of q (B, H, T, Dh), k/v
    (B, H, S, Dh) and kv_mask (B, S), and the gradients of
    ``sum(out ** 2)``; summed over the ranks that is the whole output's."""
    from fira_tpu_torch.parallel.ring import ring_attend

    n = q.shape[0] // mesh.world
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    qr, kr, vr = (x[rows].to(mesh.device).clone().requires_grad_()
                  for x in (q, k, v))
    out = ring_attend(qr, kr, vr, kv_mask[rows].to(mesh.device), mesh,
                      causal=causal)
    (out ** 2).sum().backward()
    return {"out": out.detach().cpu(), "dq": qr.grad.cpu(),
            "dk": kr.grad.cpu(), "dv": vr.grad.cpu()}


def modules_job(mesh) -> List[str]:
    """The top-level packages imported in this rank's process."""
    return sorted({name.split(".")[0] for name in sys.modules})

"""Train and dev steps (counterpart of ``fira_tpu/train/step.py``).

Loss semantics as the reference: the model returns (nll_sum,
token_count) and the step normalises sum / max(count, 1)
(run_model.py:104-105). One eager step: forward, backward (the copy
score's through K2 on the card), Adam update. Grouped steps take a stacked
group (leading axis K or A, data/grouping.py) already on the device:
``multi_step`` runs K steps over its slices, ``accum_step`` one optimizer
step from its A micro-batches. Nothing here synchronises with the device:
losses come back as device tensors, and the caller reads them at its own
sync points.

Under a training mesh (``mesh``, a bound ``parallel.mesh.Mesh``) each
rank's batch is its rows of the global batch: the loss is normalised by
the global token count (``nll_sum`` and ``count`` all-reduced over the data
axis), so every rank reports the global loss, and the gradients are
summed over the data axis before Adam steps (``mesh.sync_grads``), as the
JAX package's jitted steps do on its mesh
(``fira_tpu/train/step.py`` ``jit_train_step``, ``_jit_stacked``).
"""

from __future__ import annotations

from typing import Dict

import torch

from fira_tpu_torch.model.model import FiraModel


def _data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the data axis (differentiable: the backward passes
    each rank's own gradient)."""
    from fira_tpu_torch.parallel.mesh import DATA_AXIS, reduce_from

    return reduce_from(x, mesh.group(DATA_AXIS))


def loss_fn(model: FiraModel, batch: Dict[str, torch.Tensor],
            generator=None, mesh=None) -> torch.Tensor:
    nll_sum, count = model(batch, generator)
    if mesh is not None:
        nll_sum, count = _data_sum(nll_sum, mesh), _data_sum(count, mesh)
    return nll_sum / count.clamp(min=1)


def train_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], generator,
               mesh=None) -> torch.Tensor:
    """One optimizer step in training mode, dropout from ``generator``.
    Returns the loss (before the update) as a detached device tensor."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, generator, mesh)
    loss.backward()
    if mesh is not None:
        from fira_tpu_torch.parallel.mesh import sync_grads

        sync_grads(model, mesh)
    optimizer.step()
    return loss.detach()


def _member(stacked: Dict[str, torch.Tensor], i: int
            ) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in stacked.items()}


def multi_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               stacked: Dict[str, torch.Tensor], generator,
               mesh=None) -> torch.Tensor:
    """K ``train_step``s over the slices of one stacked group on the
    device (the JAX package's ``lax.scan`` over the same step): one copy to
    the card for K steps, no host wait inside. Returns the (K,) losses."""
    k = next(iter(stacked.values())).shape[0]
    return torch.stack([train_step(model, optimizer, _member(stacked, i),
                                   generator, mesh) for i in range(k)])


def accum_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               stacked: Dict[str, torch.Tensor], generator,
               mesh=None) -> torch.Tensor:
    """One optimizer step from the A micro-batches of a stacked group,
    normalised over the group's summed token count, as one step on the A
    batches together (the reference's DataParallel global batch,
    run_model.py:102-105): each micro-batch back-propagates its raw
    nll_sum into the summed gradients, the gradients are divided once by
    max(sum of counts, 1), then Adam steps. Dropout draws from
    ``generator`` in micro-batch order. Returns the loss sum(nll) /
    max(sum(count), 1), detached, on the device. Under a mesh both sums
    and the gradients run over the data axis too."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    a = next(iter(stacked.values())).shape[0]
    nll_sum = count = None
    for i in range(a):
        nll, cnt = model(_member(stacked, i), generator)
        nll.backward()
        nll_sum = nll.detach() if nll_sum is None else nll_sum + nll.detach()
        count = cnt if count is None else count + cnt
    if mesh is not None:
        from fira_tpu_torch.parallel.mesh import sync_grads

        nll_sum, count = _data_sum(nll_sum, mesh), _data_sum(count, mesh)
        sync_grads(model, mesh)
    denom = count.clamp(min=1).to(nll_sum.dtype)
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(denom)
    optimizer.step()
    return nll_sum / denom


def dev_step(model: FiraModel, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """Teacher-forced greedy ids (Model.py:86 'dev' stage)."""
    return model.dev_predict(batch)

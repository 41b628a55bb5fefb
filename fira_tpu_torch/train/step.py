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
"""

from __future__ import annotations

from typing import Dict

import torch

from fira_tpu_torch.model.model import FiraModel


def loss_fn(model: FiraModel, batch: Dict[str, torch.Tensor],
            generator=None) -> torch.Tensor:
    nll_sum, count = model(batch, generator)
    return nll_sum / count.clamp(min=1)


def train_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], generator) -> torch.Tensor:
    """One optimizer step in training mode, dropout from ``generator``.
    Returns the loss (before the update) as a detached device tensor."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


def _member(stacked: Dict[str, torch.Tensor], i: int
            ) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in stacked.items()}


def multi_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               stacked: Dict[str, torch.Tensor], generator) -> torch.Tensor:
    """K ``train_step``s over the slices of one stacked group on the
    device (the JAX package's ``lax.scan`` over the same step): one copy to
    the card for K steps, no host wait inside. Returns the (K,) losses."""
    k = next(iter(stacked.values())).shape[0]
    return torch.stack([train_step(model, optimizer, _member(stacked, i),
                                   generator) for i in range(k)])


def accum_step(model: FiraModel, optimizer: torch.optim.Optimizer,
               stacked: Dict[str, torch.Tensor], generator) -> torch.Tensor:
    """One optimizer step from the A micro-batches of a stacked group,
    normalised over the group's summed token count, as one step on the A
    batches together (the reference's DataParallel global batch,
    run_model.py:102-105): each micro-batch back-propagates its raw
    nll_sum into the summed gradients, the gradients are divided once by
    max(sum of counts, 1), then Adam steps. Dropout draws from
    ``generator`` in micro-batch order. Returns the loss sum(nll) /
    max(sum(count), 1), detached, on the device."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    a = next(iter(stacked.values())).shape[0]
    nll_sum = count = None
    for i in range(a):
        nll, cnt = model(_member(stacked, i), generator)
        nll.backward()
        nll_sum = nll.detach() if nll_sum is None else nll_sum + nll.detach()
        count = cnt if count is None else count + cnt
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

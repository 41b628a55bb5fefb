"""Train and dev steps (counterpart of ``fira_tpu/train/step.py``).

Loss semantics as the reference: the model returns (nll_sum,
token_count) and the step normalises sum / max(count, 1)
(run_model.py:104-105). One eager step: forward, backward (the copy
score's through K2 on the card), Adam update. Nothing here synchronises
with the device: the loss comes back as a device tensor, and the caller
reads it at its own sync points.
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


def dev_step(model: FiraModel, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """Teacher-forced greedy ids (Model.py:86 'dev' stage)."""
    return model.dev_predict(batch)

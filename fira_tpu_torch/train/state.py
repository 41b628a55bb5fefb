"""Train state and checkpoints (counterpart of ``fira_tpu/train/state.py``).

The state is the model, its Adam optimizer, the dropout generator and the
step count. Checkpoints are ``torch.save`` files in the checkpoint
directory:

- ``best.pt``: the model's ``state_dict``, written on a strict dev-BLEU
  improvement (the reference's best_model.pt, run_model.py:94-96); the
  file ``cli test`` decodes;
- ``latest.pt``: everything a resume needs, written at each epoch's end:
  model, optimizer, step, epoch, best dev BLEU and the dropout generator's
  state, so a resumed run draws the same masks.

Both are written to a private name and renamed, so a reader never sees a
half-written file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.model.model import FiraModel


@dataclasses.dataclass
class TrainState:
    model: FiraModel
    optimizer: torch.optim.Adam
    generator: torch.Generator   # dropout masks, on the model's device
    step: int = 0


def make_optimizer(model: FiraModel, cfg: FiraConfig) -> torch.optim.Adam:
    """Adam(lr=cfg.lr) with betas (0.9, 0.999) and eps 1e-8: torch's
    defaults (run_model.py:396) and optax.adam's, as the JAX package's
    ``make_optimizer``."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def init_state(cfg: FiraConfig, device, seed: Optional[int] = None
               ) -> TrainState:
    """Weights drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same weights on every device), a fresh optimizer, and a dropout
    generator on ``device`` seeded from ``seed`` (default ``cfg.seed``)."""
    s = cfg.seed if seed is None else seed
    device = torch.device(device)
    model = FiraModel(cfg, device=device).init_parameters(
        torch.Generator().manual_seed(s))
    # a seed apart from the weights' own
    gen = torch.Generator(device=device).manual_seed(s * 1_000_003 + 1)
    return TrainState(model=model, optimizer=make_optimizer(model, cfg),
                      generator=gen)


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """``best.pt`` and ``latest.pt`` under ``ckpt_dir`` (made at the
    first save)."""

    BEST = "best.pt"
    LATEST = "latest.pt"

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)

    def path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name)

    def has(self, name: str) -> bool:
        return os.path.isfile(self.path(name))

    def save_best(self, model: FiraModel) -> None:
        _atomic_save(model.state_dict(), self.path(self.BEST))

    def save_latest(self, state: TrainState, *, best_bleu: float,
                    epoch: int) -> None:
        _atomic_save({"model": state.model.state_dict(),
                      "optimizer": state.optimizer.state_dict(),
                      "generator": state.generator.get_state(),
                      "step": int(state.step), "epoch": int(epoch),
                      "best_bleu": float(best_bleu)},
                     self.path(self.LATEST))

    def load_latest(self) -> Dict[str, Any]:
        """The ``latest.pt`` payload, tensors on the CPU."""
        return torch.load(self.path(self.LATEST), map_location="cpu",
                          weights_only=True)

    def restore_latest(self, state: TrainState) -> Dict[str, Any]:
        """Load ``latest.pt`` into ``state`` in place; returns
        {"epoch", "best_bleu"}."""
        payload = self.load_latest()
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"])
        state.step = payload["step"]
        return {"epoch": payload["epoch"], "best_bleu": payload["best_bleu"]}

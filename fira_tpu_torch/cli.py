"""Command-line entry point of the port (counterpart of ``fira_tpu/cli.py``):

- ``train`` fits the model with Adam, runs the dev gate, and writes
  ``<ckpt-dir>/best.pt`` (on a dev-BLEU improvement) and
  ``<ckpt-dir>/latest.pt`` (each epoch; a later call resumes from it);
- ``test`` beam-decodes the test split with ``<ckpt-dir>/best.pt`` (or,
  when dev BLEU never improved, the model in ``latest.pt``) and writes
  OUTPUT/output_fira.

``best.pt`` is a ``torch.save``d state_dict of ``FiraModel``
(``fira_tpu_torch.convert`` also makes one from a flax tree). The run is on
the CUDA card unless ``--device cpu`` is given; with no card it raises
instead of carrying on on the CPU. ``--dtype bfloat16`` computes in bf16
(training and decoding; parameters, Adam and checkpoints stay f32, so an
f32 ``best.pt`` decodes in bf16). A config the port does not run, or a
bad knob, exits 2 with the knob named.

Example:
    python -m fira_tpu_torch.cli train --config fira-full --data-dir DataSet
    python -m fira_tpu_torch.cli test --config fira-full --data-dir DataSet
    python -m fira_tpu_torch.cli train --dtype bfloat16 --feeder-workers 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fira_tpu_torch", description=__doc__)
    p.add_argument("command", choices=["train", "test"],
                   help="train: fit + dev-gate; test: beam-decode the test "
                        "split")
    p.add_argument("--config", default="fira-full",
                   help="named config: fira-tiny | fira-full | fira-large")
    p.add_argument("--ablation", default=None,
                   choices=["no_edit", "no_subtoken", "nothing"],
                   help="paper Table 3 ablations")
    p.add_argument("--data-dir", default="DataSet",
                   help="corpus directory (reference DataSet/ layout)")
    p.add_argument("--out-dir", default="OUTPUT")
    p.add_argument("--ckpt-dir", default=None,
                   help="default: <out-dir>/ckpt[_<ablation>]")
    p.add_argument("--epochs", type=int, default=None,
                   help="override config epoch count")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--test-batch-size", type=int, default=None)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore an existing latest checkpoint")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype override (params stay f32)")
    p.add_argument("--feeder-workers", type=int, default=None, metavar="N",
                   help="threads assembling batches ahead of the loop "
                        "(0: on the loop's thread); must be >= 0")
    return p


def resolve_device(name: str) -> torch.device:
    """The run's device. ``cuda`` without a card raises. On the card, f32
    matmuls and convolutions run in full f32 (no TF32), so results match
    the f32 reference."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _load_var_maps(data_dir: str) -> Optional[List[dict]]:
    path = os.path.join(data_dir, "variable.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from fira_tpu_torch.config import apply_ablation, get_config, unsupported
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.decode.runner import output_name, run_test
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.train.state import CheckpointManager

    cfg = apply_ablation(get_config(args.config.replace("_", "-")),
                         args.ablation)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.test_batch_size:
        cfg = cfg.replace(test_batch_size=args.test_batch_size)
    if args.dtype:
        cfg = cfg.replace(compute_dtype=args.dtype)
    if args.feeder_workers is not None:
        cfg = cfg.replace(feeder_workers=args.feeder_workers)
    errs = unsupported(cfg)
    if errs:
        for e in errs:
            print(f"fira_tpu_torch: config error: {e}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    suffix = f"_{args.ablation}" if args.ablation else ""
    ckpt_dir = args.ckpt_dir or os.path.join(args.out_dir, f"ckpt{suffix}")

    if args.command == "train":
        from fira_tpu_torch.train.loop import train

        dataset = FiraDataset(args.data_dir, cfg)
        result = train(dataset, dataset.cfg, device=device,
                       out_dir=args.out_dir, ckpt_dir=ckpt_dir,
                       epochs=args.epochs,
                       var_maps=_load_var_maps(args.data_dir),
                       resume=not args.no_resume)
        print(f"best dev bleu: {result.best_bleu:.4f}  "
              f"throughput: {result.commits_per_sec:.1f} "
              f"commits/sec/chip  "
              f"feed_stall_frac: {result.feed_stall_frac:.3f}")
        return 0

    ckpt = CheckpointManager(ckpt_dir)
    use_best = ckpt.has(CheckpointManager.BEST)
    if not use_best and not ckpt.has(CheckpointManager.LATEST):
        print(f"no checkpoint under {ckpt_dir}; train first", file=sys.stderr)
        return 1
    if use_best:
        state_dict = torch.load(ckpt.path(CheckpointManager.BEST),
                                map_location=device, weights_only=True)
    else:
        # the dev gate saves best only on strict improvement (reference
        # run_model.py:94-96), so a short run whose dev BLEU never left
        # 0.0 has no best yet: decode the latest state instead of refusing
        print("no best checkpoint (dev BLEU never improved); "
              "decoding the LATEST training state", file=sys.stderr)
        state_dict = ckpt.load_latest()["model"]

    dataset = FiraDataset(args.data_dir, cfg)
    cfg = dataset.cfg
    model = FiraModel(cfg, device=device, dtype=cfg.compute_dtype)
    model.load_state_dict(state_dict)
    metrics = run_test(model, dataset, cfg, out_dir=args.out_dir,
                       ablation=args.ablation,
                       var_maps=_load_var_maps(args.data_dir))
    print(f"test sentence-bleu: {metrics['sentence_bleu']:.4f} "
          f"({int(metrics['n'])} commits) -> "
          f"{os.path.join(args.out_dir, output_name(args.ablation))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

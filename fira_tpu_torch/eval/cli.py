"""Metric CLIs, drop-in equivalents of the reference Metrics/ scripts.

Usage (mirrors the reference README.md:44-52):
    python -m fira_tpu_torch.eval.cli bnorm   REF < HYP
    python -m fira_tpu_torch.eval.cli penalty REF < HYP
    python -m fira_tpu_torch.eval.cli rouge   -r REF -g HYP
    python -m fira_tpu_torch.eval.cli meteor  -r REF -g HYP
"""

from __future__ import annotations

import argparse
import sys

from fira_tpu_torch.eval import bnorm_bleu, penalty_bleu, rouge_l_files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="fira-metrics")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_bnorm = sub.add_parser("bnorm", help="B-Norm BLEU (ref file, hyps on stdin)")
    p_bnorm.add_argument("ref")
    p_pen = sub.add_parser("penalty", help="Penalty-BLEU (ref file, hyps on stdin)")
    p_pen.add_argument("ref")
    for name in ("rouge", "meteor"):
        p = sub.add_parser(name)
        p.add_argument("-r", "--ref_path", required=True)
        p.add_argument("-g", "--gen_path", required=True)

    args = parser.parse_args(argv)
    if args.cmd == "bnorm":
        with open(args.ref) as rf:
            print(bnorm_bleu(sys.stdin.readlines(), rf.readlines()))
    elif args.cmd == "penalty":
        with open(args.ref) as rf:
            print(penalty_bleu(sys.stdin.readlines(), rf.readlines()))
    elif args.cmd == "rouge":
        print(rouge_l_files(args.gen_path, args.ref_path))
    elif args.cmd == "meteor":
        from fira_tpu_torch.eval.meteor import meteor_detail_files

        d = meteor_detail_files(args.gen_path, args.ref_path)
        if not d["wordnet"]:
            print("WARNING: wordnet corpus unavailable - native exact+stem "
                  "METEOR (strict lower bound, ~0.5 below the "
                  "wordnet-complete value; see eval/meteor.py)",
                  file=sys.stderr)
        print(d["value"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

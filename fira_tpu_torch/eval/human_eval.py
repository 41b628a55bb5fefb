"""Human-evaluation aggregation (reference C18).

The reference ships raw rater data only — HumanEvaluation/scores_{1..6}.csv,
one file per rater, 100 commits x 3 approaches, scores 0-4 — and reports the
per-approach means in the paper's Table 6 (FIRA 2.15 / CODISUM 2.06 /
NNGen 0.98). No aggregation code exists in the reference; this module is the
executable version of that table (the port's copy of
``fira_tpu/eval/human_eval.py``).

Column mapping (recovered by matching the means against Table 6):
approach1 = CODISUM, approach2 = FIRA, approach3 = NNGen.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict

APPROACH_NAMES = {"approach1": "CODISUM", "approach2": "FIRA",
                  "approach3": "NNGen"}


def aggregate(scores_dir: str) -> Dict[str, dict]:
    """Aggregate every scores_*.csv in ``scores_dir``.

    Returns {approach_name: {"mean": float, "n": int,
    "per_rater": {rater_file: mean}}}, scores averaged over
    commits x raters like the paper's Table 6.
    """
    paths = sorted(glob.glob(os.path.join(scores_dir, "scores_*.csv")))
    if not paths:
        raise FileNotFoundError(f"no scores_*.csv under {scores_dir}")
    totals = {k: 0 for k in APPROACH_NAMES}
    counts = {k: 0 for k in APPROACH_NAMES}
    per_rater: Dict[str, Dict[str, float]] = {k: {} for k in APPROACH_NAMES}
    for path in paths:
        rater = os.path.basename(path)
        r_tot = {k: 0 for k in APPROACH_NAMES}
        r_n = 0
        # utf-8-sig: the shipped files carry a BOM before the header
        with open(path, encoding="utf-8-sig") as f:
            for row in csv.DictReader(f):
                for k in APPROACH_NAMES:
                    score = int(row[k])
                    if not 0 <= score <= 4:
                        raise ValueError(f"{rater}: score {score} out of 0-4")
                    totals[k] += score
                    counts[k] += 1
                    r_tot[k] += score
                r_n += 1
        for k in APPROACH_NAMES:
            per_rater[k][rater] = r_tot[k] / max(r_n, 1)
    return {
        APPROACH_NAMES[k]: {
            "mean": totals[k] / max(counts[k], 1),
            "n": counts[k],
            "per_rater": per_rater[k],
        }
        for k in APPROACH_NAMES
    }


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        description="aggregate FIRA human-evaluation rater CSVs (Table 6)")
    p.add_argument("scores_dir", help="directory holding scores_*.csv")
    args = p.parse_args(argv)
    result = aggregate(args.scores_dir)
    print(json.dumps(
        {k: {"mean": round(v["mean"], 4), "n": v["n"]}
         for k, v in result.items()}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

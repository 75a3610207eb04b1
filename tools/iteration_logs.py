"""Iteration-indexed copies of training logs, for ``tools/compare_curves.py``.

    python3 tools/iteration_logs.py --key running_score --out DIR RUN [RUN ...]
    python3 tools/compare_curves.py DIR/<ours>... --ref DIR/<ref>... --key running_score --at 24 49 99

``compare_curves.py`` puts its marks on the env-step axis (the logs'
``total_env_steps``), where runs whose episodes terminate (hopper) reach a
given iteration at different steps. Each RUN (a job directory or a
``log.csv``, of either package) is copied to ``DIR/<name>/log.csv`` with
only the ``--key`` column, so ``compare_curves.py`` falls back to the
iteration index and its ``--at`` marks are iterations. ``<name>`` is the
job directory's name (``--prefix`` prepended, so two sides with the same
names stay apart).
"""

from __future__ import annotations

import argparse
import csv
import os


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("runs", nargs="+")
    p.add_argument("--key", default="running_score")
    p.add_argument("--out", required=True)
    p.add_argument("--prefix", default="")
    args = p.parse_args()
    for run in args.runs:
        path = os.path.join(run, "logs", "log.csv") if os.path.isdir(run) else run
        name = os.path.basename(os.path.normpath(run if os.path.isdir(run) else os.path.dirname(
            os.path.dirname(path))))
        with open(path, newline="") as f:
            values = [row[args.key] for row in csv.DictReader(f) if row.get(args.key)]
        out = os.path.join(args.out, args.prefix + name)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "log.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow([args.key])
            writer.writerows([v] for v in values)
        print(f"{path}: {len(values)} rows of {args.key} -> {out}/log.csv")


if __name__ == "__main__":
    main()

"""Learning runs of the PyTorch port side by side on one GPU, through its
entry point (``python -m mjrl_tpu_torch.train``), for comparison with the
JAX package's runs in ``runs/`` (``tools/compare_curves.py``).

    python3 tools/torch_learning_runs.py --out DIR [--demos DIR] [--jobs 8] [--only NAME ...] \
        [--device cpu --extra num_traj=2 horizon=2 niter=2]

Each run is a config of ``examples/`` with ``--set`` overrides; its log and
checkpoints go to ``<out>/<name>``. A run that names another in
``after`` starts when that one has ended (relocate's second generation
warm starts from the first's checkpoint with ``init_policy_from``). At
most ``--jobs`` runs at once, each a process of its own with one CPU
thread; the longest start first. ``--demos DIR`` reads each config's demo
pickle of that name from DIR (a copy of the repo without ``demos/``).
``--device cpu`` and ``--extra`` overrides rehearse the runs at a tiny
size on the CPU. Prints each run's exit code, wall time and last logged
row; exits non-zero if any run failed.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name: (config, overrides, after, expected seconds alone on one H100: the order to start in)
RUNS = {
    "relocate_dapg_s300": ("adroit_relocate_dapg.json", [], None, 340),
    "relocate_dapg2_s301": ("adroit_relocate_dapg.json",
                            ["seed=301", 'demo_file="demos/adroit_relocate_self2.pickle"',
                             "init_policy_from={relocate_dapg_s300}", "bc_init=false"],
                            "relocate_dapg_s300", 340),
    **{f"hopper_newton_s{s}": ("hopper_npg_newton.json", [f"seed={s}"], None, 440)
       for s in (3, 4, 5)},
    **{f"pen_npg_s{s}": ("adroit_pen_npg.json", [f"seed={s}"], None, 300) for s in (101, 102)},
    **{f"hammer_dapg_s{s}": ("adroit_hammer_dapg.json", [f"seed={s}"], None, 200)
       for s in (200, 201, 202)},
    **{f"door_dapg_s{s}": ("adroit_door_dapg.json", [f"seed={s}"], None, 180)
       for s in (200, 201, 202)},
    "pen_dapg_newton_s210": ("adroit_pen_dapg.json",
                             ["seed=210", 'env_kwargs={"constraint_solver": "newton"}'], None, 150),
    "hopper_dapg_s0": ("hopper_dapg.json", ["seed=0"], None, 120),
    **{f"pen_dapg_s{s}": ("adroit_pen_dapg.json", [f"seed={s}"], None, 100)
       for s in (200, 201, 202)},
    **{f"point_mass_s{s}": ("point_mass_npg.json", [f"seed={s}"], None, 20) for s in (0, 1, 2)},
    # model-based NPG: runs/hopper_model_npg{,_s1,_s2} are seeds 33-35; 36-38
    # widen the port's own spread
    **{f"hopper_model_npg_s{s}": ("hopper_model_npg.json", [f"seed={s}"], None, 1000)
       for s in (33, 34, 35, 36, 37, 38)},
    **{f"point_mass_model_s{s}": ("point_mass_model_npg.json", [f"seed={s}"], None, 30)
       for s in (0, 1, 2)},
}


def _last_row(job):
    path = os.path.join(job, "logs", "log.csv")
    if not os.path.exists(path):
        return None
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows[-1] if rows else None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--demos", default=None)
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--only", nargs="*", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--extra", nargs="*", default=[], help="overrides added to every run")
    args = p.parse_args()
    names = [n for n in RUNS if args.only is None or n in args.only]
    os.makedirs(args.out, exist_ok=True)
    jobs = {n: os.path.abspath(os.path.join(args.out, n)) for n in RUNS}
    ended = {n: None for n in names}

    def run(name):
        config, overrides, after, _ = RUNS[name]
        while after in ended and ended[after] is None:
            time.sleep(5)
        for other, job in jobs.items():  # "{name}" stands for that run's directory
            overrides = [o.replace("{" + other + "}", job) for o in overrides]
        path = ROOT / "examples" / config
        demo = json.load(open(path)).get("demo_file")
        for o in overrides:
            if o.startswith("demo_file="):
                demo = json.loads(o.split("=", 1)[1])
        if demo and args.demos:
            overrides.append(f'demo_file="{os.path.join(args.demos, os.path.basename(demo))}"')
        cmd = [sys.executable, "-m", "mjrl_tpu_torch.train", "--device", args.device,
               "--config", str(path), "--output", jobs[name], "--set", *overrides, *args.extra]
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        t0 = time.perf_counter()
        with open(os.path.join(args.out, f"{name}.log"), "w") as log:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=ROOT).returncode
        ended[name] = (rc, time.perf_counter() - t0)
        print(json.dumps({"run": name, "rc": rc, "seconds": ended[name][1],
                          "last": _last_row(jobs[name])}), flush=True)

    # a run waits for the one it follows, so the pool starts the followed one first
    names.sort(key=lambda n: (RUNS[n][2] is not None, -RUNS[n][3]))
    with ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(run, names))
    return 0 if all(rc == 0 for rc, _ in ended.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

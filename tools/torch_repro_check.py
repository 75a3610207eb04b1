"""Does a model-based NPG run repeat bit for bit? Where do two runs of one
seed part?

    python3 tools/torch_repro_check.py --niter 100 --seed 35 --out repro
    python3 tools/torch_repro_check.py --niter 100 --seed 35 --deterministic --out ...
    python3 tools/torch_repro_check.py --device cpu --niter 2 --out /tmp/repro \\
        --set num_traj=2 horizon=20 agent_kwargs.img_traj=8 agent_kwargs.img_horizon=20

Runs ``--config`` (default ``examples/hopper_model_npg.json``) with one seed
through the port's entry point (``mjrl_tpu_torch.train.run_job``) for
``--niter`` iterations, in two processes one after the other. After every
iteration each process writes checksums (the float64 sum and sum of
squares) of, in the order one train step makes them:

- ``real_obs``, ``real_act``: the real batch's observations and actions;
- ``ensemble``: the dynamics ensemble's parameters and normalizers after
  its fit; ``ensemble_adam``: its Adam moments and step counts;
- ``img_start``, ``img_member``: the imagined episodes' start indices into
  the real batch and their ensemble members (``ModelEnv.reset_noise``);
- ``img_obs``: the imagined batch's observations and rewards;
- ``advantages``: the imagined batch's advantages, as the update reads them;
- ``policy``, ``baseline``: the parameters after the update and the fit.

Then it names the first iteration and the first quantity whose checksums
differ between the two processes, or says that all agree. With ``--against
RECORD`` it runs one process and compares it with ``RECORD``, a
``run_<a|b>.json`` of an earlier call (another machine, another card).
``--deterministic``
runs both processes under ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``. The per-iteration checksums of each
process go to ``<out>/run_<a|b>.json``, the verdict to ``<out>/verdict.json``
and to the last line of stdout. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANTITIES = ("real_obs", "real_act", "ensemble", "ensemble_adam", "img_start", "img_member",
              "img_obs", "advantages", "policy", "baseline")


def checksum(tensors) -> list:
    """``[sum, sum of squares]`` in float64 over every element of ``tensors``."""
    import torch

    parts = [t.detach().reshape(-1).double() for t in tensors]
    flat = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float64)
    return torch.stack([flat.sum(), torch.square(flat).sum()]).tolist()


def run_child(args) -> None:
    """One run, its checksums after every iteration into ``args.record``."""
    sys.path.insert(0, ROOT)
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    from mjrl_tpu_torch import train
    from mjrl_tpu_torch.algos.model_npg import ModelAccelNPG, ModelEnv
    from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble

    rows, step = [], {}
    finish, fit, reset_noise = (ModelAccelNPG.finish_model_step, DynamicsEnsemble.fit,
                                ModelEnv.reset_noise)
    update = ModelAccelNPG.update

    def hooked_finish(agent, real, *a, **kw):
        step.clear()
        step["real_obs"] = checksum([real.observations])
        step["real_act"] = checksum([real.actions])
        out = finish(agent, real, *a, **kw)
        step["policy"] = checksum(list(agent.policy.state_dict().values()))
        step["baseline"] = checksum(list(agent.baseline.state_dict().values()))
        rows.append({k: step[k] for k in QUANTITIES})
        return out

    def hooked_fit(dyn, *a, **kw):
        out = fit(dyn, *a, **kw)
        step["ensemble"] = checksum(list(dyn.state_dict().values()))
        moments = [v for st in dyn.optimizer.state_dict()["state"].values() for v in st.values()]
        step["ensemble_adam"] = checksum([torch.as_tensor(v, device="cpu") for v in moments])
        return out

    def hooked_reset_noise(env, *a, **kw):
        index, member = reset_noise(env, *a, **kw)
        step["img_start"], step["img_member"] = checksum([index]), checksum([member])
        return index, member

    def hooked_update(agent, batch, *a, **kw):
        step["img_obs"] = checksum([batch.observations, batch.rewards])
        step["advantages"] = checksum([batch.advantages])
        return update(agent, batch, *a, **kw)

    ModelAccelNPG.finish_model_step, DynamicsEnsemble.fit = hooked_finish, hooked_fit
    ModelEnv.reset_noise, ModelAccelNPG.update = hooked_reset_noise, hooked_update
    cfg = train.load_config(args.config, [*args.set, f"seed={args.seed}", f"niter={args.niter}",
                                          f"save_freq={args.niter}"])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        train.run_job(cfg, out, device=args.device)
        with open(os.path.join(out, "logs", "log.csv"), newline="") as f:
            log = list(csv.DictReader(f))
    for row, logged in zip(rows, log):
        row["running_score"] = float(logged["running_score"])
    with open(args.record, "w") as f:
        json.dump({"seconds": time.perf_counter() - t0, "deterministic": args.deterministic,
                   "torch": torch.__version__, "iterations": rows}, f)


def first_difference(a: list, b: list):
    """``(iteration, quantity)`` where the two runs' checksums first part, in
    the step's order, or None."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        for q in QUANTITIES:
            if ra[q] != rb[q]:
                return i, q
    return None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=os.path.join(ROOT, "examples", "hopper_model_npg.json"))
    p.add_argument("--seed", type=int, default=35)
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--out", required=True, help="directory for the checksums and the verdict")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE", help="config overrides")
    p.add_argument("--against", help="compare one run with this earlier run_<a|b>.json")
    p.add_argument("--record", help=argparse.SUPPRESS)  # set in the two child processes
    args = p.parse_args()
    if args.record:
        run_child(args)
        return 0

    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ)
    if args.deterministic:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    runs = {}
    if args.against:
        with open(args.against) as f:
            runs["b"] = json.load(f)
    for tag in ("a",) if args.against else ("a", "b"):
        record = os.path.join(args.out, f"run_{tag}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--record", record, "--config",
               args.config, "--seed", str(args.seed), "--niter", str(args.niter), "--device",
               args.device, "--out", args.out, "--set", *args.set]
        if args.deterministic:
            cmd.append("--deterministic")
        subprocess.run(cmd, env=env, check=True)
        with open(record) as f:
            runs[tag] = json.load(f)
    a, b = runs["a"]["iterations"], runs["b"]["iterations"]
    part = first_difference(a, b)
    verdict = {"config": os.path.relpath(args.config, ROOT), "seed": args.seed,
               "niter": args.niter, "deterministic": args.deterministic,
               "against": args.against, "torch": [runs["a"]["torch"], runs["b"]["torch"]],
               "iterations_compared": min(len(a), len(b)),
               "seconds": [runs["a"]["seconds"], runs["b"]["seconds"]],
               "running_score_last": [a[-1]["running_score"], b[-1]["running_score"]]}
    if part is None:
        verdict["first_difference"] = None
        print(f"the two runs agree in every checksum over {verdict['iterations_compared']} "
              f"iterations")
    else:
        i, q = part
        verdict["first_difference"] = {"iteration": i, "quantity": q, "a": a[i][q], "b": b[i][q],
                                       "differ_at_that_iteration": [
                                           k for k in QUANTITIES if a[i][k] != b[i][k]]}
        print(f"the two runs first part at iteration {i} in {q}: {a[i][q]} against {b[i][q]}")
    with open(os.path.join(args.out, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=1)
    print(json.dumps(verdict))
    return 0


if __name__ == "__main__":
    sys.exit(main())

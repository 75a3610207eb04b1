"""Write ``mjrl_tpu_torch/envs/assets/adroit_<task>.npz``: an Adroit model
compiled by the port's bridge.

    python tools/torch_gen_adroit_model.py [TASK ...] [--out DIR]   # pen (default), hammer, door, relocate

The port's Adroit envs load no ``mujoco`` and no ``gymnasium_robotics``
(the card's machine has neither); they read these files. This tool runs
on a host that has both: ``envs/adroit.py::compile_adroit_model`` (the
installed wheel's ``adroit_<task>.xml`` through ``physics/bridge.py``
after the reference's servo retuning), then
``physics/model.py::save_model_npz``, which ``load_model_npz`` reads back.
The env-level settings (contact gains, substeps, limit gains) are not
stored: the env applies them. ``--out`` writes into another directory.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASKS = ("pen", "hammer", "door", "relocate")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tasks", nargs="*", default=["pen"], choices=TASKS, metavar="TASK")
    p.add_argument("--out", default=os.path.join(ROOT, "mjrl_tpu_torch", "envs", "assets"))
    args = p.parse_args()
    from mjrl_tpu_torch.envs.adroit import compile_adroit_model
    from mjrl_tpu_torch.physics.model import save_model_npz

    os.makedirs(args.out, exist_ok=True)
    for task in args.tasks:
        path = os.path.join(args.out, f"adroit_{task}.npz")
        save_model_npz(compile_adroit_model(task), path)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()

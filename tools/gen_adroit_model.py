"""Write ``mjrl_tpu_torch/envs/assets/adroit_<task>.npz``: an Adroit model
as the JAX package compiles it, for the PyTorch port.

    JAX_PLATFORMS=cpu python tools/gen_adroit_model.py [TASK]   # pen (default), hammer, door, relocate

The port loads no ``mujoco`` and no ``gymnasium_robotics``. This tool runs
the JAX package's bridge once: ``physics/bridge.py::load_mj_model`` on the
installed wheel's ``adroit_<task>.xml``, the env's servo retuning
(``AdroitEnv._apply_gain_overrides``) and ``model_from_mujoco``, and
stores every field of the resulting ``Model`` as numpy arrays
(``mjrl_tpu_torch/physics/model.py::load_model_npz`` reads them back). The
env-level settings (contact gains, substeps, limit gains) are not stored:
the port's env applies them, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASKS = ("pen", "hammer", "door", "relocate")


def out_path(task: str) -> str:
    return os.path.join(ROOT, "mjrl_tpu_torch", "envs", "assets", f"adroit_{task}.npz")


def model_arrays(model) -> dict:
    """Every set field of a ``Model`` as a numpy array; dicts keyed by
    geom pairs become ``<name>__keys`` (P, 2) and ``<name>__values``."""
    out = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if v is None:
            continue
        if isinstance(v, dict):
            keys = sorted(v)
            out[f"{f.name}__keys"] = np.asarray(keys, np.int64).reshape(-1, 2)
            out[f"{f.name}__values"] = np.asarray([v[k] for k in keys])
        elif isinstance(v, str):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = np.asarray(v)
    return out


def main() -> None:
    from mjrl_tpu.envs.adroit import AdroitEnv, _adroit_asset
    from mjrl_tpu.physics.bridge import load_mj_model, model_from_mujoco

    task = sys.argv[1] if len(sys.argv) > 1 else "pen"
    if task not in TASKS:
        raise SystemExit(f"task must be one of {TASKS}")
    mj = load_mj_model(_adroit_asset(task))
    AdroitEnv._apply_gain_overrides(mj)
    out = out_path(task)
    np.savez_compressed(out, **model_arrays(model_from_mujoco(mj)))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()

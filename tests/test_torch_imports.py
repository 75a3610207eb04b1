"""The port stands without JAX: with jax, jaxlib, gymnasium and mjrl_tpu
blocked, every mjrl_tpu_torch module imports and the ant env steps on the
CPU. (The card's machine has none of those packages.)"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
BLOCKED = ("jax", "jaxlib", "gymnasium", "mjrl_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
sys.path.insert(0, sys.argv[1])

import importlib, pkgutil
import torch
import mjrl_tpu_torch

names = [m.name for m in pkgutil.walk_packages(mjrl_tpu_torch.__path__, "mjrl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules if sys.modules[m] is not None)

from mjrl_tpu_torch.envs import make
env = make("ant", horizon=4)
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert obs.shape == (2, 27) and torch.isfinite(reward).all()
print("imported", len(names), "modules")
"""


def test_port_imports_and_steps_without_jax():
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, ROOT], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout

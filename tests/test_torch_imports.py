"""The port stands without JAX: with jax, jaxlib, gymnasium,
gymnasium_robotics, mujoco and mjrl_tpu blocked, every mjrl_tpu_torch
module imports (the harness in ``utils``, the ``train`` entry point, TRPO
and PPO among them), the ant env steps on the CPU with either solver and
the hopper, swimmer and humanoid envs (its 376-dim observation from
physics/engine.py, contact.py and comfeat.py) with their shipped assets,
and Adroit pen (envs/adroit.py, kernel K3's plain version) with its
shipped model, and the door, hammer (its nail sensor: physics/contact.py's
box kinds) and relocate envs reset with theirs; BC, DAPG, the demos, the
ridge solve and the least-squares baselines import and point_mass steps;
model-based NPG (algos/model_npg.py, models/dynamics.py) takes a train
step on point_mass, pendulum and cartpole (envs/classic.py) step, and
the linear policy and utils/plots.py import (matplotlib only inside
``make_train_plots``); parallel/dist.py imports, and with no group its
helpers are the identity; utils/evaluation.py imports, the per-env engine
(physics/engine.py, csolve.py) steps the ball-joint chain through the
frame stepper and pen on Newton contacts with ``use_soa=False``. (The card's machine has none of those
packages.)"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
BLOCKED = ("jax", "jaxlib", "gymnasium", "gymnasium_robotics", "mujoco", "mjrl_tpu")
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
env = make("ant", horizon=4, device="cpu")
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert obs.shape == (2, 27) and torch.isfinite(reward).all()
env = make("ant", horizon=4, device="cpu", constraint_solver="newton", n_substeps=1)
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert torch.isfinite(reward).all() and env.model.dof_invweight0 is not None
assert "mjrl_tpu_torch.physics.soa_newton" in names and "mjrl_tpu_torch.physics.csolve" in names
for name in ("train", "utils.configs", "utils.train_agent", "utils.logger", "utils.checkpoint"):
    assert "mjrl_tpu_torch." + name in names, name
for name, obs_dim in (("hopper", 11), ("swimmer", 8)):
    env = make(name, horizon=4, device="cpu")
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
    assert obs.shape == (2, obs_dim) and torch.isfinite(reward).all()
env = make("humanoid", horizon=4, device="cpu")
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert obs.shape == (2, 376) and torch.isfinite(reward).all()
env = make("adroit_pen", device="cpu")
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert obs.shape == (2, 45) and torch.isfinite(reward).all() and "success" in info
for name, obs_dim in (("adroit_door", 39), ("adroit_hammer", 46), ("adroit_relocate", 39)):
    env = make(name, device="cpu")
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    assert obs.shape == (2, obs_dim) and torch.isfinite(obs).all() and state.link_delta.any()
for name in ("algos.trpo", "algos.ppo", "physics.engine", "physics.contact", "physics.comfeat",
             "physics.math3d", "envs.adroit", "physics.probe", "physics.dispatch"):
    assert "mjrl_tpu_torch." + name in names, name
for name in ("algos.bc", "algos.dapg", "utils.demos", "ops.lstsq", "envs.point_mass"):
    assert "mjrl_tpu_torch." + name in names, name
from mjrl_tpu_torch.models import LinearBaseline, QuadraticBaseline, ZeroBaseline
env = make("point_mass", device="cpu")
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.ones(2, 2))
assert obs.shape == (2, 6) and torch.isfinite(reward).all() and "success" in info
assert QuadraticBaseline(env.spec).coef.shape == (37,) and LinearBaseline(env.spec).coef.shape == (16,)
for name in ("algos.model_npg", "models.dynamics", "envs.classic", "utils.plots"):
    assert "mjrl_tpu_torch." + name in names, name
assert "matplotlib" not in sys.modules
from mjrl_tpu_torch.algos import ModelAccelNPG
from mjrl_tpu_torch.models import GaussianLinear
env = make("point_mass", horizon=5, device="cpu")
agent = ModelAccelNPG(env, GaussianLinear(env.spec), QuadraticBaseline(env.spec), num_traj=4,
                      img_traj=8, ensemble_size=2, dyn_hidden_sizes=(8,), dyn_fit_epochs=1)
metrics = agent.train_step(torch.Generator().manual_seed(0))
assert all(torch.isfinite(v) for v in metrics.values()) and "dyn_error" in metrics
for name, obs_dim in (("pendulum", 3), ("cartpole", 4)):
    env = make(name, device="cpu")
    state, obs = env.reset(2, torch.Generator().manual_seed(0))
    state, obs, reward, term, info = env.step(state, torch.ones(2, 1))
    assert obs.shape == (2, obs_dim) and torch.isfinite(reward).all()
assert "mjrl_tpu_torch.parallel.dist" in names
from mjrl_tpu_torch.parallel import dist
x = torch.arange(6.0)
assert dist.world_size() == 1 and dist.all_sum(x) is x and dist.local_rows(x) is x
assert dist.gather_rows(x) is x and dist.row_block(5, 1, 2) == (3, 5)
assert "mjrl_tpu_torch.utils.evaluation" in names
from mjrl_tpu_torch.physics import dispatch, probe
from mjrl_tpu_torch.utils import evaluate_policy, export_rollout
step = dispatch.make_frame_stepper(probe.ball_chain_model(), 2)
q, qd = step(*(torch.as_tensor(x) for x in probe.engine_states(probe.ball_chain_model(), 2,
                                                                 __import__("numpy").random.default_rng(0))))
assert step.path == "engine" and torch.isfinite(q).all() and torch.isfinite(qd).all()
env = make("adroit_pen", device="cpu", constraint_solver="newton", use_soa=False)
state, obs = env.reset(2, torch.Generator().manual_seed(0))
state, obs, reward, term, info = env.step(state, torch.zeros(2, env.spec.action_dim))
assert env._frame_step.path == "engine" and torch.isfinite(reward).all()
print("imported", len(names), "modules")
"""


def test_port_imports_and_steps_without_jax():
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, ROOT], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout


_BRIDGE_SCRIPT = r"""
import sys
BLOCKED = ("jax", "jaxlib", "gymnasium", "gymnasium_robotics", "mujoco", "mjrl_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import importlib.util
from mjrl_tpu_torch.physics import bridge
from mjrl_tpu_torch.envs import adroit
for path in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location("tool", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules if sys.modules[m] is not None)
for call in (lambda: bridge.load_mj_model("model.xml"), lambda: adroit.compile_adroit_model("pen")):
    try:
        call()
    except ImportError:
        continue
    raise AssertionError("compiled a model with mujoco blocked")
print("bridge imported without mujoco")
"""

_HOST_FILES = ("mjrl_tpu_torch/physics/bridge.py", "tools/torch_gen_adroit_model.py",
               "tools/torch_repro_check.py")


def test_bridge_imports_with_mujoco_blocked():
    """The bridge and the Adroit env module import with mujoco, jax and
    mjrl_tpu blocked (mujoco only inside the bridge's functions, which then
    raise ImportError), and so do the two host tools."""
    env = {**os.environ, "PYTHONPATH": "", "OMP_NUM_THREADS": "1"}
    tools = [os.path.join(ROOT, p) for p in _HOST_FILES[1:]]
    proc = subprocess.run([sys.executable, "-c", _BRIDGE_SCRIPT, ROOT, *tools],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bridge imported without mujoco" in proc.stdout


def test_bridge_and_host_tools_import_no_jax():
    """No import statement of the bridge or of the two host tools, at any
    depth (inside functions too), names jax or the JAX package."""
    import ast

    for rel in _HOST_FILES:
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "mjrl_tpu")]
        assert not bad, (rel, bad)
        assert "mjrl_tpu_torch" in " ".join(names) or rel.startswith("mjrl_tpu_torch"), rel


def test_gen_adroit_model_tool_writes_the_committed_pen(tmp_path):
    """``tools/torch_gen_adroit_model.py pen`` (the port's bridge on the
    installed wheel's asset) writes the committed ``adroit_pen.npz``: every
    array the same dtype, shape and bits."""
    import numpy as np
    import pytest

    pytest.importorskip("mujoco")
    pytest.importorskip("gymnasium_robotics")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "torch_gen_adroit_model.py"),
                           "pen", "--out", str(tmp_path)], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp_path / "adroit_pen.npz") as got, np.load(
            os.path.join(ROOT, "mjrl_tpu_torch", "envs", "assets", "adroit_pen.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k

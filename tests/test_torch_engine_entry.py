"""The per-env engine behind the port's entry points: the frame stepper's
routing, pen DAPG on Newton contacts with ``use_soa: false`` through
``run_job``, Adroit's ``reward_variant``, ``utils/evaluation.py`` and
``tools/torch_make_demos.py``.

Routing (physics/dispatch.py, the reference's ``dispatch.py:69``): a
stepper asked for with ``use_soa=False``, or a model with a ball joint or
a plane on a moving link, runs the engine; every other model runs its
kernel (on the CPU, the kernel's plain version, bit for bit); an unknown
solver raises. ``runs/adroit_pen_dapg_newton_s1/config.json`` (the JAX
package's engine-path run) builds and trains an iteration at 2 envs x 3
steps with the kernels' plain version patched to raise, so no kernel path
runs. The rewards of ``reward_variant="gymnasium_v1"`` and the statistics
of ``evaluate_policy`` (on an injected batch) are held against the JAX
package's; ``export_rollout`` writes the reference's keys and shapes.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.envs.adroit import AdroitState as JAdroitState
from mjrl_tpu.models.gaussian_mlp import GaussianMLP as JGaussianMLP
from mjrl_tpu.physics.engine import PhysicsState as JPhysicsState
from mjrl_tpu.utils import evaluation as jevaluation
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.models import GaussianMLP
from mjrl_tpu_torch.physics import dispatch, pkernel, probe, soa
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.utils import evaluate_policy, export_rollout
from mjrl_tpu_torch.utils import evaluation
from mjrl_tpu_torch.utils.demos import load_demo_pickle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "runs", "adroit_pen_dapg_newton_s1", "config.json")

_BALL_MJCF = """<mujoco model="ball_pendulum">
  <option timestep="0.01"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="bob" pos="0 0 1">
      <joint name="ball" type="ball" damping="0.1"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.5" size="0.02" mass="0.1"/>
      <geom name="mass" type="sphere" size="0.1" pos="0 0 -0.5" mass="1"/>
    </body>
  </worldbody>
  <actuator><motor joint="ball" gear="1" ctrlrange="-1 1" ctrllimited="true"/></actuator>
</mujoco>
"""


def test_frame_stepper_routes_to_the_engine_only_where_asked_or_needed():
    hopper = make("hopper", horizon=4, device="cpu").model
    assert dispatch.make_frame_stepper(hopper, 4).path == "K1"
    assert dispatch.make_frame_stepper(hopper, 4, use_soa=True).path == "K1"
    on_engine = dispatch.make_frame_stepper(hopper, 4, use_soa=False)
    assert on_engine.path == "engine" and on_engine.check() is None
    for build in (probe.ball_chain_model, probe.link_plane_model):
        model = build()
        assert not soa.soa_supported(model)
        assert dispatch.make_frame_stepper(model, 2, use_soa=True).path == "engine"
        with pytest.raises(NotImplementedError):
            soa.check_supported(model)  # the kernels' own gate stays
        dispatch.check_model(model)  # the engine takes it
    pen = make("adroit_pen", device="cpu", constraint_solver="newton")
    assert pen._frame_step.path == "K4"
    assert make("adroit_pen", device="cpu")._frame_step.path == "K3"
    assert make("adroit_pen", device="cpu", use_soa=False)._frame_step.path == "engine"
    odd = make("hopper", horizon=4, device="cpu").model
    odd.constraint_solver = "pgs"
    with pytest.raises(NotImplementedError, match="solver"):
        dispatch.make_frame_stepper(odd, 4, use_soa=False)
    # the K-path on the CPU is the kernel's plain version, bit for bit
    rng = np.random.default_rng(0)
    q = torch.as_tensor(np.tile(hopper.default_qpos, (3, 1)) + rng.uniform(-0.1, 0.1, (3, 6)),
                        dtype=torch.float32)
    qd = torch.as_tensor(rng.uniform(-1, 1, (3, 6)), dtype=torch.float32)
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (3, 3)), dtype=torch.float32)
    got = dispatch.make_frame_stepper(hopper, 4)(q, qd, ctrl)
    want = soa.multistep(hopper, q.T.contiguous(), qd.T.contiguous(), ctrl.T.contiguous(), 4)
    assert all(torch.equal(g, w.T) for g, w in zip(got, want))


def test_asset_with_a_ball_joint_steps_on_the_engine(tmp_path):
    """A locomotion env built from an ``asset_path`` outside the kernels'
    set takes no new keyword: its frame stepper is the engine's."""
    path = tmp_path / "ball.xml"
    path.write_text(_BALL_MJCF)
    env = make("swimmer", horizon=4, device="cpu", asset_path=str(path))
    assert env._frame_step.path == "engine"
    state, obs = env.reset(3, torch.Generator().manual_seed(0))
    for _ in range(3):
        state, obs, reward, term, _ = env.step(state, torch.ones(3, env.spec.action_dim))
    assert torch.isfinite(obs).all() and torch.isfinite(reward).all()
    norms = torch.linalg.vector_norm(state.q[:, :4], dim=-1)
    torch.testing.assert_close(norms, torch.ones(3), rtol=0, atol=1e-5)


def test_pen_dapg_newton_run_config_trains_on_the_engine(tmp_path, monkeypatch):
    """The JAX package's ``use_soa: false`` run builds and trains an
    iteration in the port (BC warm start on the real demos, then DAPG) at
    a reduced width, without the kernels' plain version (patched to raise);
    unset, the same config runs kernel K4."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel path ran")

    monkeypatch.setattr(soa, "multistep", no_kernel)
    demos = os.path.join(ROOT, "demos", "adroit_pen_expert.pickle")
    cfg = load_config(RUN, ["num_traj=2", "horizon=3", "niter=1", "save_freq=1",
                            f"demo_file=\"{demos}\""])
    assert cfg.env_kwargs == {"constraint_solver": "newton", "use_soa": False}
    agent = run_job(cfg, str(tmp_path / "run"), device="cpu")
    assert agent.env._frame_step.path == "engine" and agent.iteration == 1
    assert all(k.launches == 0 for k in (pkernel.K1, pkernel.K2, pkernel.K3, pkernel.K4))
    with open(tmp_path / "run" / "logs" / "log.csv") as f:
        rows = f.read().splitlines()
    assert len(rows) == 2 and "nan" not in rows[1]
    env = make("adroit_pen", device="cpu", constraint_solver="newton")  # use_soa unset
    assert env._frame_step.path == "K4"


@pytest.mark.parametrize("task", ["relocate", "hammer", "door"])
def test_gymnasium_v1_reward_matches_reference(task):
    """One step each (both frame steppers stubbed to the same outcome)
    with the reach term's sign flipped, against the JAX env."""
    env = make(f"adroit_{task}", device="cpu", reward_variant="gymnasium_v1")
    jenv = jenvs.make(f"adroit_{task}", reward_variant="gymnasium_v1")
    st, _ = env.reset(2, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    q2 = st.q + torch.as_tensor(rng.uniform(-0.1, 0.1, st.q.shape), dtype=torch.float32)
    qd2 = torch.as_tensor(rng.uniform(-1, 1, st.qd.shape), dtype=torch.float32)
    action = torch.as_tensor(rng.uniform(-1, 1, (2, env.model.nu)), dtype=torch.float32)
    env._frame_step = lambda *_: (q2, qd2)
    rew = env.step(st, action)[2]
    want = []
    for i in range(2):
        jenv._frame_step = lambda *_, i=i: (jnp.asarray(q2[i].numpy()), jnp.asarray(qd2[i].numpy()))
        js = JAdroitState(ps=JPhysicsState(q=jnp.asarray(st.q[i].numpy()),
                                           qd=jnp.asarray(st.qd[i].numpy())),
                          link_delta=jnp.asarray(st.link_delta[i].numpy()),
                          target=jnp.asarray(st.target[i].numpy()))
        want.append(float(jenv.step(js, jnp.asarray(action[i].numpy()))[2]))
    np.testing.assert_allclose(rew.numpy(), want, rtol=1e-5, atol=1e-5)
    env.reward_variant = "dapg"
    assert (rew > env.step(st, action)[2]).all()  # +0.1 reach instead of -0.1
    with pytest.raises(ValueError):
        make(f"adroit_{task}", device="cpu", reward_variant="v2")


def test_evaluate_policy_statistics_match_reference(monkeypatch):
    """The reference's ``[mean, std, min, max]`` and percentiles of the
    per-episode discounted score, on an injected batch of ragged
    episodes."""
    rng = np.random.default_rng(6)
    N, T = 7, 9
    rewards = rng.standard_normal((N, T)).astype(np.float32)
    lengths = rng.integers(3, T + 1, N)
    valid = np.arange(T)[None, :] < lengths[:, None]
    done = np.arange(T)[None, :] == lengths[:, None] - 1
    batch = types.SimpleNamespace(rewards=torch.as_tensor(rewards * valid),
                                  done=torch.as_tensor(done), valid=torch.as_tensor(valid))
    jbatch = types.SimpleNamespace(rewards=jnp.asarray(rewards * valid), done=jnp.asarray(done),
                                   valid=jnp.asarray(valid))
    monkeypatch.setattr(evaluation, "sample_episodes", lambda *a, **k: batch)
    monkeypatch.setattr(jevaluation, "sample_episodes", lambda *a, **k: jbatch)
    env = types.SimpleNamespace(spec=types.SimpleNamespace(horizon=T))
    got = evaluate_policy(env, None, N, gamma=0.99, percentiles=(10, 50, 90))
    want = jevaluation.evaluate_policy(env, None, None, None, None, N, gamma=0.99,
                                       percentiles=(10, 50, 90))
    assert sorted(got) == sorted(want) == ["max", "mean", "min", "p10", "p50", "p90", "std"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_export_rollout_writes_the_reference_keys(tmp_path):
    """One hopper episode of 5 steps on each side: the same keys, shapes
    and dtypes; the port's first qpos is its env's reset, and replaying
    its actions from there reproduces its observations."""
    env = make("hopper", horizon=5, device="cpu")
    policy = GaussianMLP(env.spec, hidden_sizes=(8,), generator=torch.Generator().manual_seed(0))
    got = np.load(export_rollout(env, policy, str(tmp_path / "port.npz"),
                                 generator=torch.Generator().manual_seed(1)))
    jenv = jenvs.make("hopper", horizon=5)
    jpolicy = JGaussianMLP(jenv.spec, hidden_sizes=(8,))
    want = np.load(jevaluation.export_rollout(jenv, jpolicy, jpolicy.init(jax.random.PRNGKey(0)),
                                              jpolicy.init_transforms(), jax.random.PRNGKey(1),
                                              str(tmp_path / "jax.npz")))
    assert sorted(got.files) == sorted(want.files) == ["actions", "observations", "qpos",
                                                       "rewards"]
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    state, obs = env.reset(1, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got["qpos"][0], state.q[0].numpy())
    np.testing.assert_array_equal(got["observations"][0], obs[0].numpy())
    state, obs, reward, _, _ = env.step(state, torch.as_tensor(got["actions"][:1]))
    np.testing.assert_allclose(got["observations"][1], obs[0].numpy(), rtol=0, atol=0)
    assert float(reward[0]) == got["rewards"][0]


def test_torch_make_demos_writes_a_pickle_demos_load(tmp_path):
    """``tools/torch_make_demos.py`` on a point_mass run's ``best.pt``:
    the pickle loads through ``utils/demos.py`` with the episodes asked
    for."""
    run = str(tmp_path / "run")
    run_job(load_config(os.path.join(ROOT, "examples", "point_mass_npg.json"),
                        ["num_traj=4", "horizon=6", "niter=1", "save_freq=1",
                         "evaluation_rollouts=0"]), run, device="cpu")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_make_demos
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "demos.pickle")
    torch_make_demos.main(["--job", run, "--out", out, "--episodes", "3", "--device", "cpu",
                           "--max-demos", "2"])
    with open(out, "rb") as f:
        paths = pickle.load(f)
    assert len(paths) == 2 and set(paths[0]) == {"observations", "actions", "rewards",
                                                 "terminated"}
    batch = load_demo_pickle(out)
    assert batch.observations.shape[0] == 2 and batch.observations.shape[2] == 6
    assert batch.valid.sum() == sum(len(p["rewards"]) for p in paths)

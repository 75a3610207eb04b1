"""The reference agrees with the port's plain path on the CPU: the physics
and the env's observation and reward bit for bit at a tiny batch, returns,
GAE, the NPG step and the baseline's fit in float64 (in float32 NPG's CG
amplifies round-off); and it imports nothing of the port (~1 min)."""

import subprocess
import sys

import pytest
import torch

from gpubench import harness
from gpubench.checkers import npg as ck
from gpubench.reference.learn import Baseline, Policy, npg_update, returns_and_advantages


@pytest.mark.parametrize("env_name,solver,module", [
    ("adroit_relocate", "penalty", "adroit_relocate"), ("adroit_pen", "newton", "adroit_pen")])
def test_physics_obs_reward_bit_for_bit(env_name, solver, module):
    from mjrl_tpu_torch import envs

    torch.set_num_threads(1)
    env = envs.make(env_name, device="cpu", constraint_solver=solver)
    ref = __import__(f"gpubench.reference.envs.{module}", fromlist=["x"]).ReferenceEnv(
        solver, device="cpu")
    g = torch.Generator().manual_seed(0)
    st, _ = env.reset(3, g)
    action = torch.randn(3, env.spec.action_dim, generator=g)
    st2, obs2, r2, _, _ = env.step(st, action)
    q, qd = ref.physics(st._asdict(), action)
    obs, r = ref.obs_reward(st2._asdict())
    assert torch.equal(q, st2.q) and torch.equal(qd, st2.qd)
    assert torch.equal(obs, obs2) and torch.equal(r, r2)


def test_learning_in_float64():
    from mjrl_tpu_torch.train import load_config
    from mjrl_tpu_torch.types import TrajectoryBatch
    from mjrl_tpu_torch.utils.configs import build

    torch.set_num_threads(2)
    cell = harness.Cell("pen.newton")
    job = cell.config["job"]
    N, T = 16, 30
    cfg = load_config(None, cell.overrides({"num_traj": N, "horizon": T,
                                            "baseline_kwargs": {"epochs": 2, "batch_size": 64}}))
    env, policy, baseline, agent = build(cfg, device="cpu")
    policy.double()
    baseline.double()
    agent.running_score = agent.running_score.double()
    w = harness.make_weights(7, env.spec.observation_dim, env.spec.action_dim,
                             cell.config["job"], "cpu")
    w = {k: [x.double() for x in w[k]] for k in ("policy", "baseline")}
    harness.load_into(policy, w["policy"], True)
    harness.load_into(baseline, w["baseline"], False)
    g = torch.Generator().manual_seed(3)
    obs = torch.randn(N, T, env.spec.observation_dim, generator=g, dtype=torch.float64)
    with torch.no_grad():
        mean, log_std = policy(obs)
    done = torch.zeros(N, T, dtype=torch.bool)
    done[:, -1] = True
    z = torch.zeros(N, T, dtype=torch.float64)
    b = TrajectoryBatch(observations=obs, actions=mean + torch.randn(mean.shape, generator=g,
                                                                      dtype=torch.float64),
                        rewards=torch.randn(N, T, generator=g, dtype=torch.float64),
                        valid=torch.ones_like(done), done=done, terminated=torch.zeros_like(done),
                        mean=mean, log_std=log_std, log_prob=z,
                        time=torch.arange(T, dtype=torch.int32).expand(N, T).contiguous(),
                        returns=z, baseline=z, advantages=z, env_info={})
    pb = agent.process_batch(b)
    m = agent.update(pb)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    fm = baseline.fit(pb, generator=gen)
    P, B = Policy(w["policy"], job.get("min_log_std", -3.0)), Baseline(w["baseline"], 1e-3, 64, 2)
    bd = {f: getattr(b, f) for f in ck.BATCH_FIELDS}
    with torch.no_grad():
        values = B.predict(obs, bd["time"])
    ret, adv = returns_and_advantages(bd, values, 0.995, 0.97)
    assert torch.allclose(ret, pb.returns, rtol=0, atol=1e-12)
    assert torch.allclose(adv, pb.advantages, rtol=0, atol=1e-9)
    rm, grad = npg_update(P, bd, adv, job["agent_kwargs"]["normalized_step_size"])
    g2 = torch.Generator()
    g2.set_state(state)
    rf, fit_grad = B.fit(bd, ret, g2)
    assert float(m["alpha"]) == pytest.approx(float(rm["alpha"]), rel=1e-7)
    assert float(fm["VF_error_after"]) == pytest.approx(float(rf["VF_error_after"]), rel=1e-7)
    th = harness.module_leaves(policy, True)
    ph = harness.module_leaves(baseline, False)
    assert ck.leaf_gap([a - b for a, b in zip(th, w["policy"])],
                       [a - b for a, b in zip(P.leaves, w["policy"])], ck.kept(grad)) < 1e-7
    assert ck.leaf_gap([a - b for a, b in zip(ph, w["baseline"])],
                       [a.detach() - b for a, b in zip(B.leaves, w["baseline"])],
                       ck.kept(fit_grad)) < 1e-7


BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('mjrl_tpu_torch', 'mjrl_tpu', 'jax'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import gpubench.reference.learn, gpubench.checkers.npg, gpubench.yardstick, gpubench.counts
import gpubench.reference.envs.adroit_relocate, gpubench.reference.envs.adroit_pen
print('ok')
"""


def test_reference_imports_nothing_of_the_port():
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

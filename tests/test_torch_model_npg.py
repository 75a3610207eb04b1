"""Model-based NPG (mjrl_tpu_torch.algos.model_npg: ``ModelEnv``,
``ModelAccelNPG``) against the JAX package's, and
``examples/point_mass_model_npg.json`` through the port's entry point.

``ModelEnv``'s reset and step with the reference's start indices and
members injected, on point_mass and on hopper (whose imagined rows
terminate), to atol 1e-5. Two ``ModelAccelNPG`` train steps on
point_mass (16 real episodes x 20 steps, 64 imagined, K=2, ensemble hidden
(32, 32), quadratic baseline) with every draw injected (the real and
imagined resets and action noise, the ensemble's minibatch order):
``running_score``, ``dyn_error``, ``num_samples`` and the score to rtol
1e-3, with the linear policy and with a (16, 16) MLP one; the linear
policy's parameters to atol 1e-4 after the first step and 2e-3 after the
second. (The second update is ill conditioned: the reference's own update
on the same imagined batch, eager against inside its jitted train step,
differs by 6.5e-4 in the weights, and the port's in f32 and in f64 by
2e-2; the quadratic baseline's f32 ridge solve, 1e-3 relative apart from
the reference's (the tolerance of ``test_torch_point_mass.py``),
feeds the second step's advantages.) (With the MLP policy ten CG
iterations amplify f32 round-off: on one imagined batch the port's own
update in f32 and in f64 differ by up to 3e-4 in log_std at (16, 16) and
1.3e-2 at (32, 32), as much as the port and the reference differ; the
linear policy's Fisher is well conditioned, and there f32 and f64 agree
to 3e-7.) A run of the example config at 4 x 5 resumed from its
checkpoint is bit for bit a straight run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.algos import ModelAccelNPG as JModelAccelNPG
from mjrl_tpu.algos.model_npg import ModelEnv as JModelEnv
from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianLinear as JGaussianLinear
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import QuadraticBaseline as JQuadratic
from mjrl_tpu.models.dynamics import DynamicsEnsemble as JDynamics
from mjrl_tpu_torch.algos.model_npg import ModelAccelNPG, ModelEnv, ModelState
from mjrl_tpu_torch.convert import baseline_from_jax, dynamics_state_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble
from mjrl_tpu_torch.samplers import EpisodeNoise, run_episodes
from mjrl_tpu_torch.train import load_config, run_job
from mjrl_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, IMG, K, HIDDEN, EPOCHS, MB = 16, 20, 64, 2, (32, 32), 3, 64
to_np = lambda tree: jax.tree.map(np.array, tree)
t = lambda x: torch.as_tensor(np.array(x))


def _model_draws(key, valid, num_envs, horizon, da):
    """The reference's imagined ``sample_episodes(key)`` draws: each env's
    start index (``categorical`` over the valid rows) and member, and the
    action noise."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    key_reset, key_scan = jax.random.split(key)
    index, member = [], []
    for rk in jax.random.split(key_reset, num_envs):
        k_idx, k_member = jax.random.split(rk)
        index.append(jax.random.categorical(k_idx, logits))
        member.append(jax.random.randint(k_member, (), 0, K))
    eps, k = [], key_scan
    for _ in range(horizon):
        k, k_act = jax.random.split(k)
        eps.append(jax.random.normal(k_act, (num_envs, da)))
    return EpisodeNoise(reset_q=t(jnp.stack(index)).long(), reset_qd=t(jnp.stack(member)).long(),
                        action=t(jnp.stack(eps)))


def _point_mass_draws(jenv, key):
    """The reference's real ``sample_episodes(key)`` draws on point_mass."""
    key_reset, key_scan = jax.random.split(key)
    states, _ = jax.vmap(jenv.reset)(jax.random.split(key_reset, N))
    eps, k = [], key_scan
    for _ in range(T):
        k, k_act = jax.random.split(k)
        eps.append(jax.random.normal(k_act, (N, 2)))
    return EpisodeNoise(reset_q=t(states.pos), reset_qd=t(states.target), action=t(jnp.stack(eps)))


def _dyn_perms(key, m):
    num_mb = m // MB
    per = [[np.array(jax.random.permutation(ek, m)[: num_mb * MB].reshape(num_mb, MB))
            for ek in jax.random.split(mk, EPOCHS)] for mk in jax.random.split(key, K)]
    return torch.as_tensor(np.stack([np.stack([per[k][e] for k in range(K)])
                                     for e in range(EPOCHS)]))


@pytest.mark.parametrize("name", ["point_mass", "hopper"])
def test_model_env_matches_reference(name):
    """Reset from a pool with invalid rows (never drawn), then 6 steps of
    random actions through a fitted-looking ensemble (random normalizers):
    obs, reward and termination."""
    jenv = JPointMass() if name == "point_mass" else jenvs.make("hopper")
    env = make(name, device="cpu")
    do, da = env.spec.observation_dim, env.spec.action_dim
    rng = np.random.default_rng(1)
    jdyn = JDynamics(jenv.spec, ensemble_size=K, hidden_sizes=(16, 16))
    state = jdyn.init(jax.random.PRNGKey(2))
    state = {**state, "in_shift": jnp.asarray(rng.normal(size=do + da), jnp.float32),
             "in_scale": jnp.asarray(rng.uniform(0.5, 2.0, do + da), jnp.float32),
             "delta_shift": jnp.asarray(0.05 * rng.normal(size=do), jnp.float32),
             "delta_scale": jnp.asarray(rng.uniform(0.1, 1.0, do), jnp.float32)}
    # hopper's pool stands near its healthy bounds, so imagined rows end
    pool = rng.normal(scale=0.1, size=(40, do)).astype(np.float32)
    if name == "hopper":
        pool[:, 0] = rng.uniform(0.6, 0.9, 40)
        pool[:, 1] = rng.uniform(-0.25, 0.25, 40)
    valid = rng.random(40) < 0.6
    jmodel = JModelEnv(jenv, jdyn, state, jnp.asarray(pool),
                       jnp.where(jnp.asarray(valid), 0.0, -jnp.inf), horizon=6)
    keys = jax.random.split(jax.random.PRNGKey(3), 32)
    jstates, jobs = jax.vmap(jmodel.reset)(keys)
    draws = _model_draws(jax.random.PRNGKey(3), valid, 32, 6, da)  # not the same split
    dyn = DynamicsEnsemble(env.spec, ensemble_size=K, hidden_sizes=(16, 16))
    dynamics_state_from_jax(to_np(state), dyn)
    model = ModelEnv(env, dyn, torch.as_tensor(pool), torch.as_tensor(valid), horizon=6)
    index = torch.as_tensor(np.array([int(jnp.argmax(jnp.all(jnp.asarray(pool) == o, -1)))
                                      for o in jobs]))
    ms, obs = model.reset_from_noise(index, t(jstates[1]))
    assert isinstance(ms, ModelState) and valid[index.numpy()].all()
    np.testing.assert_array_equal(obs.numpy(), np.array(jobs))
    assert draws.reset_q.shape == (32,) and valid[draws.reset_q.numpy()].all()
    step = jax.jit(jax.vmap(jmodel.step))
    js, ended = jstates, np.zeros(32, bool)
    for _ in range(6):
        a = rng.normal(size=(32, da)).astype(np.float32)
        js, jo, jr, jt, _ = step(js, jnp.asarray(a))
        ms, o, r, term, info = model.step(ms, torch.as_tensor(a))
        np.testing.assert_allclose(o.numpy(), np.array(jo), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r.numpy(), np.array(jr), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(term.numpy(), np.array(jt))
        assert info == {} and torch.equal(ms.member, t(jstates[1]).long())
        ended |= term.numpy()
    if name == "hopper":
        assert 0 < ended.sum() < 32
    # the port's own draws start only from valid rows
    index, member = model.reset_noise(4096, torch.Generator().manual_seed(0))
    assert valid[index.numpy()].all() and set(member.tolist()) == set(range(K))
    assert len(set(index.tolist())) == int(valid.sum())


@pytest.fixture(scope="module", params=[(), (16, 16)], ids=["linear", "mlp"])
def ref(request):
    """Two train steps of the reference's ModelAccelNPG on point_mass, with
    the linear policy or a (16, 16) MLP one."""
    jenv = JPointMass(horizon=T)
    hidden = request.param
    policy = JGaussianMLP(jenv.spec, hidden_sizes=hidden) if hidden else JGaussianLinear(jenv.spec)
    agent = JModelAccelNPG(jenv, policy, JQuadratic(jenv.spec), num_traj=N, horizon=T, img_traj=IMG,
                           img_horizon=T, ensemble_size=K, dyn_hidden_sizes=HIDDEN,
                           dyn_fit_epochs=EPOCHS, dyn_batch_size=MB, normalized_step_size=0.1)
    state = agent.init(jax.random.PRNGKey(0))
    step = jax.jit(agent.train_step)
    states, metrics, keys = [to_np(state)], [], []
    for i in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        state, m = step(state, key)
        states.append(to_np(state))
        metrics.append({k: float(v) for k, v in m.items()})
        keys.append(key)
    return dict(jenv=jenv, states=states, metrics=metrics, keys=keys, linear=not hidden)


def test_two_train_steps_match_reference(ref):
    jenv, s0 = ref["jenv"], ref["states"][0]
    env = make("point_mass", horizon=T, device="cpu")
    policy = policy_from_jax(s0.params, env.spec)
    baseline = baseline_from_jax(s0.baseline_state, env.spec)
    agent = ModelAccelNPG(env, policy, baseline, num_traj=N, horizon=T, img_traj=IMG,
                          img_horizon=T, ensemble_size=K, dyn_hidden_sizes=HIDDEN,
                          dyn_fit_epochs=EPOCHS, dyn_batch_size=MB, normalized_step_size=0.1)
    dynamics_state_from_jax(s0.dynamics_state, agent.dynamics)
    for i, key in enumerate(ref["keys"]):
        k_real, k_fit, k_img, _, _ = jax.random.split(key, 5)
        real = run_episodes(env, agent.policy, _point_mass_draws(jenv, k_real))
        img_noise = _model_draws(k_img, np.array(real.valid).reshape(-1), IMG, T, 2)
        metrics = agent.finish_model_step(real, dyn_perms=_dyn_perms(k_fit, N * (T - 1)),
                                          img_noise=img_noise)
        want, state = ref["metrics"][i], ref["states"][i + 1]
        assert set(want) == set(metrics)
        for name in ("running_score", "dyn_error", "num_samples", "stoc_pol_mean"):
            np.testing.assert_allclose(float(metrics[name]), want[name], rtol=1e-3, err_msg=name)
        if not ref["linear"]:
            continue
        assert type(agent.policy).__name__ == "GaussianLinear"
        got = {k: v.detach().numpy() for k, v in agent.policy.state_dict().items()}
        atol = (1e-4, 2e-3)[i]
        np.testing.assert_allclose(got["log_std"], state.params["log_std"], rtol=0, atol=atol)
        for j, layer in enumerate(state.params["mlp"]):
            np.testing.assert_allclose(got[f"mlp.layers.{j}.weight"], layer["w"].T, rtol=0,
                                       atol=atol, err_msg=f"step {i} layer {j}")
            np.testing.assert_allclose(got[f"mlp.layers.{j}.bias"], layer["b"], rtol=0, atol=atol)
    assert agent.iteration == 2
    # running_score seeds at iteration 0 and then moves by the EMA
    m0, m1 = ref["metrics"]
    assert m0["running_score"] == m0["stoc_pol_mean"]
    np.testing.assert_allclose(m1["running_score"],
                               0.9 * m0["running_score"] + 0.1 * m1["stoc_pol_mean"], rtol=1e-6)


CONFIG = os.path.join(ROOT, "examples", "point_mass_model_npg.json")
SMALL = ["num_traj=4", "horizon=5", "save_freq=1"]


def test_config_resumes_bit_for_bit(tmp_path):
    """``point_mass_model_npg.json`` at 4 x 5 (256 imagined episodes of 5
    steps, the config's (256, 256) ensemble): 3 iterations straight, and 2
    then 1 more resumed from the checkpoint, end in the same policy,
    baseline, ensemble, Adam state and running score, bit for bit; the log
    has the ``dyn_*`` columns."""
    straight = run_job(load_config(CONFIG, [*SMALL, "niter=3"]), str(tmp_path / "a"), device="cpu")
    run_job(load_config(CONFIG, [*SMALL, "niter=2"]), str(tmp_path / "b"), device="cpu")
    resumed = run_job(load_config(CONFIG, [*SMALL, "niter=3"]), str(tmp_path / "b"), device="cpu")
    assert type(resumed).__name__ == "ModelAccelNPG" and resumed.iteration == 3
    sa, sb = straight.state_dict(), resumed.state_dict()
    for part in ("policy", "baseline", "dynamics"):
        for name, value in sa[part].items():
            torch.testing.assert_close(sb[part][name], value, rtol=0, atol=0, msg=name)
    oa, ob = sa["dynamics_optimizer"]["state"], sb["dynamics_optimizer"]["state"]
    assert len(oa) == 6 and float(oa[0]["step"]) == 3 * 10  # 3 fits x 10 epochs x 1 minibatch
    for i in oa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ob[i][name], oa[i][name], rtol=0, atol=0)
    torch.testing.assert_close(resumed.running_score, straight.running_score, rtol=0, atol=0)
    saved = CheckpointManager(str(tmp_path / "b")).restore(2)
    assert set(saved) >= {"dynamics", "dynamics_optimizer"}
    with open(tmp_path / "b" / "logs" / "log.csv") as f:
        header = f.readline().strip().split(",")
    assert {"dyn_error", "dyn_error_max", "dyn_num_pairs"} <= set(header)


def test_hopper_config_runs_through_the_entry_point(tmp_path):
    """``hopper_model_npg.json`` at 2 real envs x 4 steps (4 imagined x 4;
    the config's ensemble, baseline and step size) through ``run_job``:
    one iteration, every logged value finite, ``num_samples`` the real
    batch's valid steps."""
    cfg = load_config(os.path.join(ROOT, "examples", "hopper_model_npg.json"),
                      ["num_traj=2", "horizon=4", "agent_kwargs.img_traj=4",
                       "agent_kwargs.img_horizon=4", "niter=1", "save_freq=1"])
    agent = run_job(cfg, str(tmp_path), device="cpu")
    assert type(agent).__name__ == "ModelAccelNPG" and agent.iteration == 1
    assert agent.dynamics.fit_epochs == 20 and type(agent.baseline).__name__ == "MLPBaseline"
    with open(tmp_path / "logs" / "log.csv") as f:
        header, row = [line.strip().split(",") for line in f]
    values = {k: float(v) for k, v in zip(header, row)}
    assert all(np.isfinite(v) for v in values.values())
    assert 0 < values["num_samples"] <= 8 and values["dyn_num_pairs"] <= 6
    assert values["running_score"] == values["stoc_pol_mean"]

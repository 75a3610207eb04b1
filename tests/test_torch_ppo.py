"""Parity of the port's PPO (``mjrl_tpu_torch.algos.PPO``), the MLP
baseline's ``reg_coef`` and ``vf_clip_coef`` and ``obs_norm_init`` with the
JAX package's.

One reference ``TrajectoryBatch`` (N=6 rows x T=10 steps of
walker2d-sized observations drawn with numpy, two rows ending early; the
actions drawn from the policy's own Gaussian; random advantages and
returns) goes through the JAX ``PPO.update`` and the port's with the same
weights (``mjrl_tpu_torch.convert``) and JAX's per-epoch minibatch
permutations injected: with humanoid_ppo_v4.json's flags on (an annealed
learning rate at iteration 3 of 8, per-minibatch advantage normalization,
an entropy bonus) and with them off. The baseline fit and the
observation normalization are held the same way.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.algos import PPO as JPPO
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models import MLPBaseline as JMLPBaseline
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.types import TrajectoryBatch as JTrajectoryBatch
from mjrl_tpu.utils.configs import obs_norm_init as j_obs_norm_init
from mjrl_tpu_torch.algos import PPO
from mjrl_tpu_torch.convert import baseline_from_jax, policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.models import MLPBaseline
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.types import TrajectoryBatch
from mjrl_tpu_torch.utils import configs

torch.set_num_threads(1)

N, T, OBS = 6, 10, 17
EPOCHS, MB = 2, 16  # 3 minibatches of the 60 steps per epoch, 12 dropped
FLAGS = {
    "v4": dict(entropy_coef=0.01, lr_anneal_iters=8, norm_adv_per_minibatch=True),
    "plain": dict(),
}
ITERATION = 3


@pytest.fixture(scope="module")
def jenv():
    return jenvs.make("walker2d", horizon=T)


def _perms(key, m, epochs, mb):
    return [np.asarray(jax.random.permutation(k, m)[: m // mb * mb].reshape(-1, mb))
            for k in jax.random.split(key, epochs)]


def _batch(jagent, state, seed=0):
    """A reference batch of the agent's policy (numpy dict)."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(N, T, OBS)).astype(np.float32)
    mean, log_std = jagent.policy.apply(state.params, state.transforms, jnp.asarray(obs))
    mean = np.asarray(mean)
    log_std = np.broadcast_to(np.asarray(log_std), mean.shape).astype(np.float32)
    actions = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    valid = np.ones((N, T), bool)
    valid[1, 6:] = valid[4, 3:] = False
    adv = (rng.normal(size=(N, T)) * valid).astype(np.float32)
    returns = (rng.normal(size=(N, T)) * 5.0 + 3.0).astype(np.float32)
    zero = np.zeros((N, T), np.float32)
    time = np.tile(np.arange(T, dtype=np.int32), (N, 1))
    return dict(observations=obs, actions=actions, rewards=zero, valid=valid,
                done=zero.astype(bool), terminated=zero.astype(bool), mean=mean,
                log_std=log_std, log_prob=zero, time=time, returns=returns, baseline=zero,
                advantages=adv)


def _jbatch(batch):
    return JTrajectoryBatch(**{k: jnp.asarray(v) for k, v in batch.items()}, env_info={})


def _tbatch(batch):
    return TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in batch.items()}, env_info={})


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_update_matches_reference(jenv, flags):
    kw = dict(clip_coef=0.2, epochs=EPOCHS, mb_size=MB, learn_rate=3e-3, **FLAGS[flags])
    jagent = JPPO(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(16, 16)),
                  JMLPBaseline(jenv.spec), num_traj=N, horizon=T, **kw)
    state = jagent.init(jax.random.PRNGKey(0)).replace(iteration=jnp.asarray(ITERATION))
    batch = _batch(jagent, state)
    key = jax.random.PRNGKey(1)
    new_state, want = jagent.update(state, _jbatch(batch), key)
    want = {k: float(v) for k, v in want.items()}

    env = make("walker2d", horizon=T, device="cpu")
    params0 = jax.tree.map(np.asarray, state.params)
    agent = PPO(env, policy_from_jax(params0, env.spec), MLPBaseline(env.spec), num_traj=N,
                horizon=T, **kw)
    agent.iteration = ITERATION
    perms = [torch.as_tensor(p) for p in _perms(key, N * T, EPOCHS, MB)]
    got = {k: float(v) for k, v in agent.update(_tbatch(batch), perms=perms).items()}
    assert set(got) == set(want)
    lr = 3e-3 * (1.0 - ITERATION / 8) if flags == "v4" else 3e-3
    np.testing.assert_allclose(got["alpha"], lr, rtol=1e-6)
    np.testing.assert_allclose(want["alpha"], lr, rtol=1e-6)
    # six Adam steps of f32 gradients in another summation order
    for name, rtol, atol in (("kl_dist", 1e-3, 1e-7), ("surr_improvement", 1e-3, 1e-6),
                             ("log_std_mean", 1e-4, 1e-6)):
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol, err_msg=name)
    assert got["kl_dist"] > 1e-5 and got["surr_improvement"] > 0.0  # the policy moved
    got_flat, _ = ravel({k: v.detach() for k, v in agent.policy.named_parameters()})
    want_flat = policy_flat_from_jax(np.asarray(ravel_pytree(new_state.params)[0]), agent.policy)
    # each Adam step moves a weight by at most about lr
    np.testing.assert_allclose(got_flat.numpy(), want_flat.numpy(), rtol=0, atol=3e-5)


def test_update_draws_its_minibatches_from_a_generator(jenv):
    """Without injected permutations the update draws them from the
    generator: the same seed gives the same policy; the Adam state goes
    into the agent's checkpoint state."""
    env = make("walker2d", horizon=T, device="cpu")
    jagent = JPPO(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(16, 16)), JMLPBaseline(jenv.spec),
                  num_traj=N, horizon=T)
    state = jagent.init(jax.random.PRNGKey(0))
    batch = _tbatch(_batch(jagent, state))
    params0 = jax.tree.map(np.asarray, state.params)
    flats = []
    for _ in range(2):
        agent = PPO(env, policy_from_jax(params0, env.spec), MLPBaseline(env.spec), epochs=EPOCHS,
                    mb_size=MB, num_traj=N, horizon=T)
        agent.update(batch, generator=torch.Generator().manual_seed(5))
        flats.append(ravel({k: v.detach() for k, v in agent.policy.named_parameters()})[0])
    assert torch.equal(flats[0], flats[1])
    assert "policy_optimizer" in agent.state_dict()
    assert agent.state_dict()["policy_optimizer"]["state"]


def test_baseline_fit_with_clip_and_reg_matches_reference(jenv):
    """``MLPBaseline.fit`` with ``vf_clip_coef`` and ``reg_coef`` against
    the JAX fit, with its permutations injected."""
    # eps = 1e-4 x std(targets) ~ 5e-4: a few Adam steps move the
    # predictions past it, so the clip bites
    kw = dict(epochs=EPOCHS, batch_size=MB, vf_clip_coef=1e-4, reg_coef=1e-2)
    jbase = JMLPBaseline(jenv.spec, hidden_sizes=(16, 16), **kw)
    jstate = jbase.init(jax.random.PRNGKey(2))
    jagent = JPPO(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(16, 16)), jbase, num_traj=N,
                  horizon=T)
    batch = _batch(jagent, jagent.init(jax.random.PRNGKey(0)), seed=1)
    key = jax.random.PRNGKey(3)
    new_state, want = jbase.fit(jstate, _jbatch(batch), key)
    base = baseline_from_jax(jax.tree.map(np.asarray, jstate), jenv.spec, **kw)
    perms = [torch.as_tensor(p) for p in _perms(key, N * T, EPOCHS, MB)]
    got = base.fit(_tbatch(batch), perms=perms)
    for name in ("VF_error_before", "VF_error_after"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4, err_msg=name)
    assert float(got["VF_error_after"]) < float(got["VF_error_before"])
    for lin, layer in zip(base.mlp.layers, new_state["mlp"]):
        np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(layer["w"]).T,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(layer["b"]),
                                   rtol=0, atol=1e-5)
    # each option changes the fit: neither is silently ignored
    for off in ("vf_clip_coef", "reg_coef"):
        other = baseline_from_jax(jax.tree.map(np.asarray, jstate), jenv.spec,
                                  **{**kw, off: 0.0})
        other.fit(_tbatch(batch), perms=perms)
        moved = max(float((a.weight - b.weight).abs().max())
                    for a, b in zip(other.mlp.layers, base.mlp.layers))
        assert moved > 1e-6, off


def test_obs_norm_init_matches_reference(jenv, monkeypatch):
    """The policy's in_shift and in_scale from one batch: the valid steps'
    mean and std (floored at 1e-2), as the JAX ``obs_norm_init`` sets them
    from the same batch; the carry of a samples-mode agent is untouched."""
    jagent = JPPO(jenv, JGaussianMLP(jenv.spec, hidden_sizes=(16, 16)), JMLPBaseline(jenv.spec),
                  num_traj=N, horizon=T)
    state = jagent.init(jax.random.PRNGKey(0))
    batch = _batch(jagent, state, seed=2)
    batch["observations"][..., 3] = 0.25  # a constant channel: the scale floor
    batch["observations"][4, 5:] = 1e3  # invalid steps (row 4 ends at 3) do not count
    jagent._sample_batch_inner = lambda s, k: _jbatch(batch)
    want = j_obs_norm_init(jagent, state, jax.random.PRNGKey(4)).transforms

    env = make("walker2d", horizon=T, device="cpu")
    for mode in ("trajectories", "samples"):
        agent = PPO(env, policy_from_jax(jax.tree.map(np.asarray, state.params), env.spec),
                    MLPBaseline(env.spec), num_traj=N, horizon=T, num_samples=N * T,
                    sample_mode=mode)
        sampler = "sample_episodes" if mode == "trajectories" else "sample_autoreset"
        fake = (lambda *a, **k: _tbatch(batch)) if mode == "trajectories" else \
            (lambda *a, **k: (_tbatch(batch), None))
        monkeypatch.setattr(configs, sampler, fake)
        configs.obs_norm_init(agent, torch.Generator().manual_seed(0))
        mlp = agent.policy.mlp
        np.testing.assert_allclose(mlp.in_shift.numpy(), np.asarray(want["in_shift"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mlp.in_scale.numpy(), np.asarray(want["in_scale"]),
                                   rtol=1e-5, atol=1e-6)
        assert float(mlp.in_scale[3]) == pytest.approx(1e-2) and agent.sampler_carry is None


def test_ppo_configs_build(tmp_path):
    """The PPO configs of examples/ build with their baseline options."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("humanoid_ppo_v4.json", "ant_ppo3.json", "ant_ppo_v5.json"):
        cfg = configs.RunConfig.from_json(os.path.join(root, "examples", name))
        cfg.num_traj, cfg.num_samples, cfg.hidden_sizes = 2, 4, (8, 8)
        cfg.baseline_kwargs = {**cfg.baseline_kwargs, "hidden_sizes": (8, 8)}
        _, _, baseline, agent = configs.build(cfg, device="cpu")
        assert isinstance(agent, PPO) and baseline.vf_clip_coef == 0.2 and agent.epochs == 4
        assert agent.lr_anneal_iters == cfg.niter and agent.norm_adv_per_minibatch

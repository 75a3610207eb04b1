"""Parity of the port's ops and models (mjrl_tpu_torch.ops / .models) with
the JAX package on shared numpy inputs: DiagGaussian, returns and GAE with
masks, advantage normalization, CG, the MLP and policy forward with
converted weights, the baseline features, and the flat-vector order map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.models.baselines import _base_features
from mjrl_tpu.models.gaussian_mlp import GaussianMLP as JGaussianMLP
from mjrl_tpu.models.mlp import apply_mlp, identity_transforms, init_mlp
from mjrl_tpu.ops import cg as jcg
from mjrl_tpu.ops import gae as jgae
from mjrl_tpu.ops.distributions import DiagGaussian as JDiag
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.types import EnvSpec as JEnvSpec
from mjrl_tpu.types import zeros_trajectory_batch
from mjrl_tpu_torch.convert import policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.models.baselines import base_features
from mjrl_tpu_torch.models.mlp import MLP
from mjrl_tpu_torch.ops import cg, gae
from mjrl_tpu_torch.ops.distributions import DiagGaussian
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch

torch.set_num_threads(1)

T_ = torch.as_tensor
F32 = dict(rtol=1e-5, atol=1e-6)  # f32 elementwise math, different op order


def _gauss_inputs(seed=0, shape=(5, 7, 3)):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(*shape), f(*shape), 0.3 * f(*shape), f(*shape), 0.3 * f(*shape)


def test_diag_gaussian_matches_reference():
    a, m1, ls1, m2, ls2 = _gauss_inputs()
    np.testing.assert_allclose(DiagGaussian.log_prob(T_(a), T_(m1), T_(ls1)).numpy(),
                               np.asarray(JDiag.log_prob(a, m1, ls1)), **F32)
    np.testing.assert_allclose(
        DiagGaussian.likelihood_ratio(T_(a), T_(m1), T_(ls1), T_(m2), T_(ls2)).numpy(),
        np.asarray(JDiag.likelihood_ratio(a, m1, ls1, m2, ls2)), rtol=1e-4)
    np.testing.assert_allclose(DiagGaussian.kl(T_(m1), T_(ls1), T_(m2), T_(ls2)).numpy(),
                               np.asarray(JDiag.kl(m1, ls1, m2, ls2)), **F32)
    # the reparameterized sample with shared standard-normal noise
    eps = np.array(jax.random.normal(jax.random.PRNGKey(0), m1.shape))
    want = JDiag.sample(jax.random.PRNGKey(0), m1, ls1)
    np.testing.assert_allclose(DiagGaussian.sample(T_(m1), T_(ls1), T_(eps)).numpy(),
                               np.asarray(want), **F32)


def _masked_rollout(seed, N=6, T=9):
    """Random rewards/values with episode masks: some rows terminate early
    (frozen afterwards), the rest are truncated at the horizon."""
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(N, T)).astype(np.float32)
    values = rng.normal(size=(N, T)).astype(np.float32)
    end = rng.integers(2, T + 3, size=N)  # >= T: truncated
    t = np.arange(T)[None]
    valid = t <= np.minimum(end, T - 1)[:, None]
    done = t == np.minimum(end, T - 1)[:, None]
    terminated = done & (end < T)[:, None]
    return rewards, values, done, terminated, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_returns_and_gae_match_reference(seed):
    r, v, done, term, valid = _masked_rollout(seed)
    got = gae.compute_returns(T_(r), T_(done), T_(valid), 0.99)
    want = jgae.compute_returns(r, done, valid, 0.99)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got = gae.compute_gae(T_(r), T_(v), T_(done), T_(term), T_(valid), 0.99, 0.95)
    want = jgae.compute_gae(r, v, done, term, valid, 0.99, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got_m, got_s = gae.masked_mean_std(T_(v), T_(valid))
    want_m, want_s = jgae.masked_mean_std(v, valid)
    np.testing.assert_allclose([float(got_m), float(got_s)], [float(want_m), float(want_s)], **F32)


@pytest.mark.parametrize("gae_lambda,normalize", [(0.97, True), (None, False)])
def test_compute_advantages_matches_reference(gae_lambda, normalize):
    r, v, done, term, valid = _masked_rollout(3)
    rets = np.array(jgae.compute_returns(r, done, valid, 0.995))
    N, T = r.shape
    jb = zeros_trajectory_batch(N, T, 2, 1).replace(
        rewards=r, done=done, terminated=term, valid=valid, returns=rets)
    want = jgae.compute_advantages(jb, v, 0.995, gae_lambda, normalize=normalize)
    zeros = torch.zeros(N, T)
    tb = TrajectoryBatch(
        observations=torch.zeros(N, T, 2), actions=torch.zeros(N, T, 1), rewards=T_(r),
        valid=T_(valid), done=T_(done), terminated=T_(term), mean=torch.zeros(N, T, 1),
        log_std=torch.zeros(N, T, 1), log_prob=zeros, time=torch.zeros(N, T, dtype=torch.int32),
        returns=T_(rets), baseline=zeros, advantages=zeros, env_info={})
    got = gae.compute_advantages(tb, T_(v), 0.995, gae_lambda, normalize=normalize)
    np.testing.assert_allclose(got.advantages.numpy(), np.asarray(want.advantages), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.baseline.numpy(), np.asarray(want.baseline), **F32)


@pytest.mark.parametrize("iters", [3, 10, 40])
def test_cg_matches_reference(iters):
    rng = np.random.default_rng(iters)
    Q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    A = (Q * np.linspace(1.0, 20.0, 12)) @ Q.T  # SPD, condition number 20
    A = (0.5 * (A + A.T)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    want = jcg.cg_solve(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), cg_iters=iters)
    got = cg.cg_solve(lambda x: T_(A) @ x, T_(b), cg_iters=iters)
    # f32 round-off carried through the CG recurrences
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    if iters == 40:  # past convergence: the early exit holds both at the solution
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, b), rtol=1e-3, atol=1e-3)


def test_mlp_and_policy_forward_match_reference():
    spec = EnvSpec(observation_dim=11, action_dim=3, horizon=5)
    jpol = JGaussianMLP(JEnvSpec(11, 3, 5), hidden_sizes=(16, 8))
    params = jpol.init(jax.random.PRNGKey(0))
    params = {**params, "log_std": jnp.asarray([-0.5, 0.1, -4.0])}
    rng = np.random.default_rng(0)
    tf = {k: np.asarray(v) for k, v in jpol.init_transforms().items()}
    tf["in_shift"] = rng.normal(size=11).astype(np.float32)
    tf["in_scale"] = rng.uniform(0.5, 2, size=11).astype(np.float32)
    obs = rng.normal(size=(4, 6, 11)).astype(np.float32)
    params_np = jax.tree.map(np.asarray, params)
    pol = policy_from_jax(params_np, spec, transforms_np=tf)
    mean, log_std = pol(T_(obs))
    jmean, jlog_std = jpol.apply(params, {k: jnp.asarray(v) for k, v in tf.items()}, obs)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(jlog_std))
    # project: the min_log_std clamp
    proj = pol.project({k: v.detach() for k, v in pol.named_parameters()})
    np.testing.assert_array_equal(proj["log_std"].numpy(), np.asarray(jpol.project(params)["log_std"]))
    # flat order: JAX's sorted-key ravel mapped into named_parameters() order
    jflat, _ = ravel_pytree(params)
    flat, _ = ravel({k: v.detach() for k, v in pol.named_parameters()})
    np.testing.assert_array_equal(policy_flat_from_jax(np.asarray(jflat), pol).numpy(), flat.numpy())
    # a bare MLP with the value-function scale
    layers = init_mlp(jax.random.PRNGKey(1), (11, 32, 1), final_scale=1.0)
    mlp = MLP((11, 32, 1))
    from mjrl_tpu_torch.convert import _load_mlp

    _load_mlp(mlp, jax.tree.map(np.asarray, layers))
    np.testing.assert_allclose(mlp(T_(obs)).detach().numpy(),
                               np.asarray(apply_mlp(layers, identity_transforms(11, 1), obs)),
                               rtol=1e-5, atol=1e-6)


def test_base_features_match_reference():
    rng = np.random.default_rng(0)
    obs = (rng.normal(size=(3, 7, 5)) * 8).astype(np.float32)  # some beyond the clip
    time = rng.integers(0, 1000, size=(3, 7)).astype(np.int32)
    np.testing.assert_allclose(base_features(T_(obs), T_(time)).numpy(),
                               np.asarray(_base_features(obs, time)), rtol=1e-6, atol=1e-9)


def test_mlp_init_is_seeded_and_bounded():
    a = MLP((10, 20, 3), generator=torch.Generator().manual_seed(0))
    b = MLP((10, 20, 3), generator=torch.Generator().manual_seed(0))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert float(a.layers[0].weight.detach().abs().max()) <= 1 / 10**0.5
    assert float(a.layers[1].weight.detach().abs().max()) <= 0.01 / 20**0.5

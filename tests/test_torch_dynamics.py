"""The dynamics ensemble of model-based NPG (mjrl_tpu_torch.models.dynamics)
against the JAX package's ``mjrl_tpu.models.dynamics``.

``transition_pairs`` on a point_mass batch with terminations planted is
bit for bit the reference's. ``DynamicsEnsemble.fit`` at K=2, hidden (32,
32), 3 epochs of 4 minibatches (a trailing partial minibatch dropped),
from the JAX init (``convert.dynamics_state_from_jax``) with the
reference's ``jax.random.permutation``s injected: parameters and
normalizers to rtol 1e-4 / atol 1e-5, the metrics to rtol 1e-4, and
``predict`` with a per-row member vector to atol 1e-5. A second fit from
the reference's fitted state (Adam's moments and count converted) holds
the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.point_mass import PointMassEnv as JPointMass
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.models.dynamics import DynamicsEnsemble as JDynamics
from mjrl_tpu.models.dynamics import transition_pairs as j_transition_pairs
from mjrl_tpu.samplers.rollout import sample_episodes as j_sample_episodes
from mjrl_tpu_torch.convert import dynamics_state_from_jax
from mjrl_tpu_torch.models.dynamics import DynamicsEnsemble, transition_pairs
from mjrl_tpu_torch.types import TrajectoryBatch

torch.set_num_threads(1)

N, T, K, HIDDEN, EPOCHS, MB = 10, 8, 2, (32, 32), 3, 16  # m = 70 pairs: 4 minibatches + 6
to_np = lambda tree: jax.tree.map(np.array, tree)
t = lambda x: torch.as_tensor(np.array(x))


def _to_torch(jb) -> TrajectoryBatch:
    return TrajectoryBatch(
        observations=t(jb.observations), actions=t(jb.actions), rewards=t(jb.rewards),
        valid=t(jb.valid), done=t(jb.done), terminated=t(jb.terminated), mean=t(jb.mean),
        log_std=t(jb.log_std), log_prob=t(jb.log_prob), time=t(jb.time), returns=t(jb.returns),
        baseline=t(jb.baseline), advantages=t(jb.advantages),
        env_info={k: t(v) for k, v in jb.env_info.items()})


def _terminate(jb, ends):
    """The batch with row n terminated at step ``ends[n]`` (None: runs to
    the horizon): done and terminated there, invalid after."""
    valid, done, term = (np.array(x) for x in (jb.valid, jb.done, jb.terminated))
    for n, end in enumerate(ends):
        if end is not None:
            valid[n, end + 1:] = False
            done[n] = False
            done[n, end] = True
            term[n, end] = True
    return jb.replace(valid=jnp.asarray(valid), done=jnp.asarray(done),
                      terminated=jnp.asarray(term))


@pytest.fixture(scope="module")
def ref():
    jenv = JPointMass(horizon=T)
    pol = JGaussianMLP(jenv.spec, hidden_sizes=(8,), init_log_std=0.5)
    params, tf = pol.init(jax.random.PRNGKey(7)), pol.init_transforms()
    batch = j_sample_episodes(jenv, pol, params, tf, jax.random.PRNGKey(1), N, T)
    batch = _terminate(batch, [3, None, 0, 6, None, 5, None, None, 2, None])
    dyn = JDynamics(jenv.spec, ensemble_size=K, hidden_sizes=HIDDEN, batch_size=MB,
                    fit_epochs=EPOCHS)
    state0 = dyn.init(jax.random.PRNGKey(0))
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    fit = jax.jit(dyn.fit)
    state1, metrics1 = fit(state0, batch, k1)
    state2, metrics2 = fit(state1, batch, k2)
    return dict(jenv=jenv, dyn=dyn, batch=batch, states=[to_np(s) for s in (state0, state1, state2)],
                metrics=[{k: float(v) for k, v in m.items()} for m in (metrics1, metrics2)],
                keys=(k1, k2), jstate1=state1)


def _perms(key, m):
    """The reference's per-member, per-epoch minibatch order of ``fit(key)``,
    as ``(epochs, K, num_mb, mb)``."""
    num_mb = m // MB
    per_member = [[np.array(jax.random.permutation(ek, m)[: num_mb * MB].reshape(num_mb, MB))
                   for ek in jax.random.split(mk, EPOCHS)] for mk in jax.random.split(key, K)]
    return torch.as_tensor(np.stack([np.stack([per_member[k][e] for k in range(K)])
                                     for e in range(EPOCHS)]))


def _port(ref, state_np) -> DynamicsEnsemble:
    dyn = DynamicsEnsemble(ref["jenv"].spec, ensemble_size=K, hidden_sizes=HIDDEN, batch_size=MB,
                           fit_epochs=EPOCHS)
    dynamics_state_from_jax(state_np, dyn)
    return dyn


def _assert_state(dyn, state_np):
    for i, layer in enumerate(state_np["params"]):
        for got, want, name in ((dyn.weights[i], layer["w"], "w"), (dyn.biases[i], layer["b"], "b")):
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"layer {i} {name}")
    for name in ("in_shift", "in_scale", "delta_shift", "delta_scale"):
        np.testing.assert_allclose(getattr(dyn, name).numpy(), state_np[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_transition_pairs_match_reference(ref):
    jb = ref["batch"]
    got = transition_pairs(_to_torch(jb))
    want = j_transition_pairs(jb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.array(w))
    w = got[3].numpy().reshape(N, T - 1)
    # a row terminated at step e keeps pairs 0..e-1; row 2 (e=0) keeps none
    assert w[0].tolist() == [1, 1, 1, 0, 0, 0, 0] and not w[2].any() and w[1].all()
    assert got[0].shape == (N * (T - 1), 6) and got[1].shape == (N * (T - 1), 2)


def test_fit_matches_reference(ref):
    """One fit from the JAX init, one more from the JAX fitted state (its
    Adam moments and step count carried over)."""
    batch = _to_torch(ref["batch"])
    m = N * (T - 1)
    for step in range(2):
        dyn = _port(ref, ref["states"][step])
        if step == 1:
            counts = np.array(ref["states"][1]["opt_state"][0].count)
            assert (counts == EPOCHS * (m // MB)).all()
            assert all(float(dyn.optimizer.state[p]["step"]) == counts[0] for p in dyn.parameters())
        perms = _perms(ref["keys"][step], m)
        assert perms.shape == (EPOCHS, K, m // MB, MB)
        metrics = dyn.fit(batch, perms=perms)
        _assert_state(dyn, ref["states"][step + 1])
        want = ref["metrics"][step]
        for name in ("dyn_error", "dyn_error_max", "dyn_num_pairs"):
            np.testing.assert_allclose(float(metrics[name]), want[name], rtol=1e-4, err_msg=name)
    assert want["dyn_num_pairs"] == 3 + 0 + 6 + 5 + 2 + 5 * (T - 1)  # the planted ends


def test_predict_with_a_member_per_row(ref):
    """``predict(obs, act, member)`` with each row's own member against the
    reference's ``predict`` of that member, and ``predict_all``."""
    dyn = _port(ref, ref["states"][1])
    jdyn, jstate = ref["dyn"], ref["jstate1"]
    rng = np.random.default_rng(0)
    obs = rng.normal(scale=2.0, size=(33, 6)).astype(np.float32)
    act = rng.normal(size=(33, 2)).astype(np.float32)
    member = rng.integers(0, K, 33)
    want = np.stack([np.array(jdyn.predict(jstate, obs[i], act[i], int(member[i])))
                     for i in range(33)])
    with torch.no_grad():
        got = dyn.predict(torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(member))
        every = dyn.predict_all(torch.as_tensor(obs), torch.as_tensor(act))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(every.numpy(), np.array(jdyn.predict_all(jstate, obs, act)),
                               rtol=0, atol=1e-5)
    assert every.shape == (K, 33, 6)


def test_fit_draws_each_members_own_permutation():
    """Without injected orders the fit draws ``(epochs, K, num_mb, mb)``:
    every member's row a permutation of its own, cut to whole
    minibatches."""
    spec = JPointMass().spec
    dyn = DynamicsEnsemble(spec, ensemble_size=3, hidden_sizes=(8,), batch_size=16, fit_epochs=2)
    perms = dyn.fit_perms(70, torch.Generator().manual_seed(0))
    assert perms.shape == (2, 3, 4, 16)
    flat = perms.reshape(2, 3, 64)
    assert all(len(set(row.tolist())) == 64 and int(row.max()) < 70 for row in flat.reshape(6, 64))
    assert not torch.equal(flat[0, 0], flat[0, 1]) and not torch.equal(flat[0, 0], flat[1, 0])
    assert dyn.fit_perms(10, torch.Generator()).shape == (2, 3, 1, 10)  # mb = min(16, m)

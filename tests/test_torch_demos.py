"""The port's demos and BC (mjrl_tpu_torch.utils.demos, .algos.bc) against
the JAX package.

``paths_to_batch`` packs each of the six demo pickles that the DAPG
configs read exactly as the reference does (hopper's 9 paths of 848-1000
steps exercise the masks). BC's transforms and 5 epochs of MSE and of MLE
on pen's 25 demos, with the reference's minibatch permutations injected,
match the reference's parameters, transforms and losses.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.bc import BC as JBC
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.ops.ravel import ravel_pytree
from mjrl_tpu.types import EnvSpec as JEnvSpec
from mjrl_tpu.utils.demos import paths_to_batch as j_paths_to_batch
from mjrl_tpu_torch.algos import BC
from mjrl_tpu_torch.convert import policy_flat_from_jax, policy_from_jax
from mjrl_tpu_torch.models import GaussianMLP
from mjrl_tpu_torch.ops.ravel import ravel
from mjrl_tpu_torch.types import EnvSpec
from mjrl_tpu_torch.utils.demos import batch_to_paths, load_demo_pickle, paths_to_batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKLES = ("adroit_pen_expert", "adroit_door_expert", "adroit_hammer_expert",
           "adroit_relocate_self", "adroit_relocate_self2", "hopper_expert")
FIELDS = ("observations", "actions", "rewards", "valid", "done", "terminated", "mean",
          "log_std", "log_prob", "time", "returns", "baseline", "advantages")


def _load(name):
    with open(os.path.join(ROOT, "demos", f"{name}.pickle"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", PICKLES)
def test_paths_to_batch_matches_reference_on_the_demo_pickles(name):
    """Every field bit for bit and of the same dtype; the batch round-trips
    through ``batch_to_paths``."""
    paths = _load(name)
    got, want = paths_to_batch(paths), j_paths_to_batch(paths)
    for field in FIELDS:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.env_info == {} and not want.env_info
    lengths = [len(p["observations"]) for p in paths]
    assert got.valid.sum(1).tolist() == lengths and int(got.done.sum()) == len(paths)
    if name == "hopper_expert":
        assert min(lengths) < max(lengths) == got.horizon  # ragged paths
    for p, q in zip(paths, batch_to_paths(got)):
        np.testing.assert_array_equal(q["observations"], np.asarray(p["observations"], np.float32))
        np.testing.assert_array_equal(q["actions"], np.asarray(p["actions"], np.float32))
        assert q["terminated"] == bool(p.get("terminated", False))


def test_paths_to_batch_cuts_to_a_horizon_and_fills_missing_rewards(tmp_path):
    """A horizon shorter than a path cuts it (its last kept step is done);
    paths without rewards get zeros; ``load_demo_pickle`` reads a pickle
    onto the device asked for (exact, against the reference)."""
    rng = np.random.default_rng(0)
    paths = [dict(observations=rng.normal(size=(L, 3)), actions=rng.normal(size=(L, 2)),
                  terminated=L == 5) for L in (5, 8, 3)]
    with open(tmp_path / "d.pickle", "wb") as f:
        pickle.dump(paths, f)
    got = load_demo_pickle(str(tmp_path / "d.pickle"), horizon=6, device="cpu")
    want = j_paths_to_batch(paths, horizon=6)
    assert got.observations.device.type == "cpu" and got.horizon == 6
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    assert got.valid.sum(1).tolist() == [5, 6, 3] and float(got.rewards.abs().sum()) == 0.0


@pytest.fixture(scope="module")
def pen_demos():
    return _load("adroit_pen_expert")


@pytest.mark.parametrize("loss_type", ["MSE", "MLE"])
def test_bc_matches_reference_on_pen_demos(pen_demos, loss_type):
    """BC on pen's 25 x 100 demos, 5 epochs of 39 minibatches of 64 (the
    trailing 4 slots dropped), from the same initial policy and with the
    reference's permutations: the transforms (rtol 1e-6), both losses and
    every parameter (rtol 1e-4, atol 1e-5) match; the loss falls."""
    jdemos = j_paths_to_batch(pen_demos)
    do, da = jdemos.observations.shape[-1], jdemos.actions.shape[-1]
    jpol = JGaussianMLP(JEnvSpec(do, da, 100), hidden_sizes=(64, 64))
    params0 = jpol.init(jax.random.PRNGKey(0))
    bc = JBC(jdemos, jpol, epochs=5, batch_size=64, loss_type=loss_type)
    key = jax.random.fold_in(jax.random.PRNGKey(200), 1)
    params, tf, jm = jax.jit(bc.train)(params0, jpol.init_transforms(), key)
    m = jdemos.num_envs * jdemos.horizon
    perms = [torch.as_tensor(np.array(jax.random.permutation(k, m)[: m // 64 * 64].reshape(-1, 64)))
             for k in jax.random.split(key, 5)]

    to_np = lambda tree: jax.tree.map(np.array, tree)
    policy = policy_from_jax(to_np(params0), EnvSpec(do, da, 100))
    port = BC(paths_to_batch(pen_demos), policy, epochs=5, batch_size=64, loss_type=loss_type)
    assert [p.shape for p in port.perms(torch.Generator().manual_seed(0))] == [(39, 64)] * 5
    metrics = port.train(perms=perms)
    for name in ("in_shift", "in_scale", "out_shift", "out_scale"):
        np.testing.assert_allclose(getattr(policy.mlp, name).numpy(), np.array(tf[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    for name in ("loss_before", "loss_after"):
        np.testing.assert_allclose(float(metrics[name]), float(jm[name]), rtol=1e-4, err_msg=name)
    assert float(metrics["loss_after"]) < float(metrics["loss_before"])
    got, _ = ravel({k: v.detach() for k, v in policy.named_parameters()})
    want = policy_flat_from_jax(np.asarray(ravel_pytree(params)[0]), policy)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    if loss_type == "MSE":  # the mean-squared error leaves log_std alone
        assert float(policy.log_std.abs().max()) == 0.0


def test_bc_clamps_log_std_and_draws_its_order_from_a_generator(pen_demos):
    """MLE pushes log_std down; ``min_log_std`` holds it after every step.
    Without ``perms`` the order comes from the generator: the same seed
    gives the same policy (exact)."""
    demos = paths_to_batch(pen_demos[:4])
    spec = EnvSpec(demos.observations.shape[-1], demos.actions.shape[-1], 100)
    out = []
    for _ in range(2):
        policy = GaussianMLP(spec, hidden_sizes=(8,), min_log_std=-0.01,
                             generator=torch.Generator().manual_seed(0))
        BC(demos, policy, epochs=3, loss_type="MLE", lr=1e-2).train(
            torch.Generator().manual_seed(5))
        assert float(policy.log_std.min()) == pytest.approx(-0.01)
        out.append(ravel({k: v.detach() for k, v in policy.named_parameters()})[0])
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)

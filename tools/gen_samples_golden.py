"""Write ``tests/golden/ant_newton_samples.npz``: the JAX package's
samples-mode sampler and train step on the Newton ant, for the port's
parity tests (``tests/test_torch_samples.py``).

    JAX_PLATFORMS=cpu python tools/gen_samples_golden.py

Runs the reference eagerly (``jax.disable_jit()``, about ten minutes on a
CPU): its Newton program is never compiled. The settings, the hand-made
sampler carry and the keys come from ``tests/test_torch_samples.py``, so
the tests re-derive the weights, the noise and the fit permutations from
the same keys and hold the port against the arrays stored here:

- ``carry_*``: ``agent.sample_batch_carry`` + ``_finish_train_step`` (=
  ``train_step_carry``) from the hand-made carry: the batch, the carry
  after the window, the processed batch, the metrics and the new policy;
- ``nocarry_*``: ``sample_autoreset`` with no carry and episode horizon 2.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_samples as S  # noqa: E402
from mjrl_tpu.ops.ravel import ravel_pytree  # noqa: E402
from mjrl_tpu.samplers import sample_autoreset  # noqa: E402

_BATCH = ("observations", "actions", "rewards", "valid", "done", "terminated", "mean",
          "log_std", "log_prob", "time")


def _batch_arrays(prefix, batch, out):
    for name in _BATCH:
        out[f"{prefix}_{name}"] = np.asarray(getattr(batch, name))
    for name, v in batch.env_info.items():
        out[f"{prefix}_info_{name}"] = np.asarray(v)


def main() -> int:
    out = {}
    agent, state0, carry0 = S.jax_agent_and_carry()
    k_sample, k_update, k_fit = S.train_keys()
    with jax.disable_jit():
        batch, carry1 = agent.sample_batch_carry(state0, k_sample, carry0)
        pbatch = agent.process_batch(state0, batch)
        state1, metrics = agent._finish_train_step(state0, batch, k_update, k_fit)
    _batch_arrays("carry", batch, out)
    ps, obs, t_in_ep, ep_ret, _ = carry1
    out.update(carry1_q=np.asarray(ps.q), carry1_qd=np.asarray(ps.qd), carry1_obs=np.asarray(obs),
               carry1_t_in_ep=np.asarray(t_in_ep), carry1_ep_return=np.asarray(ep_ret))
    for name in ("returns", "baseline", "advantages"):
        out[f"pbatch_{name}"] = np.asarray(getattr(pbatch, name))
    for name, v in metrics.items():
        out[f"metric_{name}"] = np.asarray(v)
    out["params1_flat"] = np.asarray(ravel_pytree(state1.params)[0])

    jenv, policy, params, transforms, key = S.nocarry_setup()
    with jax.disable_jit():
        batch = sample_autoreset(jenv, policy, params, transforms, key, S.N, S.T,
                                 episode_horizon=2)
    _batch_arrays("nocarry", batch, out)

    path = os.path.join(ROOT, "tests", "golden", "ant_newton_samples.npz")
    np.savez_compressed(path, **out)
    print("wrote", path, {k: v.shape for k, v in out.items()})
    return 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())

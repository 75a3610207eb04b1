"""Write ``tests/golden/adroit_pen_penalty_step.npz``: one control step of
the JAX package's batch-last physics on Adroit pen, for the port's parity
test (``tests/test_torch_adroit.py``).

    JAX_PLATFORMS=cpu python tools/gen_adroit_golden.py

Four envs: two after 3 control steps of random actions from reset (the
port's plain stepper warms them), two drawn by the port's
``physics/probe.py::overlapping_states`` (a pair of links overlapping);
a random control, and per-env link offsets uniform in +-5 mm on every
link. The reference steps them with ``soa.multistep(..., link_delta=...)``
under ``jax.disable_jit()`` (the program is never compiled: about a minute
on a CPU), 5 substeps of 2 ms, penalty contacts, tendons and frictionloss.
Stores the inputs and the outputs.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "golden", "adroit_pen_penalty_step.npz")


def inputs():
    """``(q (30, 4), qd (30, 4), ctrl (24, 4), link_delta (102, 4))``."""
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import probe

    env = make("adroit_pen", device="cpu")
    rng = np.random.default_rng(0)
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    for _ in range(3):
        action = torch.as_tensor(rng.uniform(-1, 1, (2, env.model.nu)), dtype=torch.float32)
        state, *_ = env.step(state, action)
    fq, fqd = probe.overlapping_states(env.model, 2, rng)
    q = np.concatenate([state.q.T.numpy(), fq], axis=1)
    qd = np.concatenate([state.qd.T.numpy(), fqd], axis=1)
    action = torch.as_tensor(rng.uniform(-1, 1, (4, env.model.nu)), dtype=torch.float32)
    ctrl = env._scaled_ctrl(action).T.numpy()
    delta = rng.uniform(-0.005, 0.005, (3 * env.model.nlink, 4)).astype(np.float32)
    return q, qd, np.ascontiguousarray(ctrl), delta


def main() -> None:
    from mjrl_tpu import envs
    from mjrl_tpu.physics import soa

    q, qd, ctrl, delta = inputs()
    model = envs.make("adroit_pen").model
    with jax.disable_jit():
        q2, qd2 = soa.multistep(model, jnp.asarray(q), jnp.asarray(qd), jnp.asarray(ctrl), 5,
                                link_delta=jnp.asarray(delta))
    np.savez_compressed(OUT, q=q, qd=qd, ctrl=ctrl, link_delta=delta, q_out=np.asarray(q2),
                        qd_out=np.asarray(qd2))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

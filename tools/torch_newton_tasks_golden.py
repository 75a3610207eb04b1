"""Writes the JAX package's Newton substep on Adroit door and relocate, where
every contact kind of the model holds rows, as goldens for the port's tests.

    python3 tools/torch_newton_tasks_golden.py [TASK ...]

For each task (default: door relocate) it draws four states from the port's
``probe.kind_states`` (numpy seed 4), one per kind of ``STATES[task]``,
each with that kind touching 0 to 1 cm deep, pushes two limited hinges per
env 1 to 3 cm past a bound and draws random servo targets. Door's four
states hold rows of its four kinds (760 contact points); relocate's hold
rows of all six, its three sphere kinds (sphere_plane, sphere_box,
sphere_capsule) among them, whose Newton rows no engine golden covers. The
reference is ``mjrl_tpu.physics.soa.multistep`` under ``jax.disable_jit()``
(never compiled, a minute or so a task on a CPU), one control frame of 3
Newton iterations, on the model ``soa_newton.prune_to_active_pairs`` cuts
to the pairs active at these states (exact there: a row outside its
margin has D = 0). It writes the inputs and the result to
``tests/golden/adroit_<task>_newton_kind_states.npz``, which
``tests/test_torch_adroit_newton_tasks.py`` holds the port's plain version
against. Needs the JAX package, as the tests do; run it again when the
models or the states change.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the four kind_states columns per task: their rows cover every kind
STATES = {"door": ("box_plane", "capsule_plane", "capsule_box", "box_box"),
          "relocate": ("box_plane", "sphere_plane", "box_box", "sphere_capsule")}
SOLVER_ITERS = 3


def golden_path(task: str) -> str:
    return os.path.join(ROOT, "tests", "golden", f"adroit_{task}_newton_kind_states.npz")


def kind_case(task: str):
    """``(q, qd, ctrl, delta)``, batch-last float32 numpy, B=4."""
    import torch

    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import probe
    from mjrl_tpu_torch.physics.model import HINGE
    from mjrl_tpu_torch.physics.tables import pair_groups

    env = make(f"adroit_{task}", device="cpu", constraint_solver="newton")
    m = env.model
    rng = np.random.default_rng(4)
    q, qd, delta = probe.kind_states(m, 1, rng)
    kinds = [k for k, _ in pair_groups(m).kinds]
    cols = [kinds.index(k) for k in STATES[task]]
    q, qd, delta = (np.ascontiguousarray(x[:, cols]) for x in (q, qd, delta))
    hinges = [i for i in range(m.nlink) if m.link_jnt_type[i] == HINGE and m.jnt_limited[i] > 0]
    for b in range(q.shape[1]):
        for i in rng.choice(hinges, 2, replace=False):
            lo, hi = m.jnt_range[i]
            past = rng.uniform(0.01, 0.03)
            q[m.link_qadr[i], b] = lo - past if rng.random() < 0.5 else hi + past
    ctrl = env._scaled_ctrl(torch.as_tensor(rng.uniform(-1, 1, (q.shape[1], m.nu)),
                                            dtype=torch.float32)).T.numpy()
    return q, qd, np.ascontiguousarray(ctrl), delta


def write(task: str) -> str:
    import jax
    import jax.numpy as jnp

    from mjrl_tpu import envs as jenvs
    from mjrl_tpu.physics import soa as jsoa
    from mjrl_tpu.physics.soa_newton import prune_to_active_pairs

    q, qd, ctrl, delta = kind_case(task)
    jmodel = jenvs.make(f"adroit_{task}", constraint_solver="newton").model
    pruned = prune_to_active_pairs(jmodel, q, jnp.asarray(delta))
    pruned.solver_iters = SOLVER_ITERS
    with jax.disable_jit():
        ref_q, ref_qd = jsoa.multistep(pruned, *map(jnp.asarray, (q, qd, ctrl)), 1,
                                       link_delta=jnp.asarray(delta))
    out = golden_path(task)
    np.savez(out, q=q, qd=qd, ctrl=ctrl, link_delta=delta,
             solver_iters=np.int32(SOLVER_ITERS), ref_q=np.asarray(ref_q, np.float32),
             ref_qd=np.asarray(ref_qd, np.float32),
             pairs=np.int32(len(pruned.contact_pairs)),
             model_pairs=np.int32(len(jmodel.contact_pairs)))
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    for task in sys.argv[1:] or sorted(STATES):
        print(f"wrote {write(task)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

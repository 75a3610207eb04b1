"""The frozen operation and byte counts of each configuration's kernel,
taken from the benchmark's frozen plain physics (``reference/physics``)
under a dispatch counter, so that a later change to the port's physics
moves neither a roofline's yardstick nor ``iter_mfu_pct``'s.

    python gpubench/counts.py relocate pen           # rewrite counts/<config>.json
    python gpubench/counts.py --check relocate pen   # exit 1 unless they repeat exactly

A count is of f32 arithmetic: elements produced by add, mul, div, sqrt,
sin, ... and reduced by sum, and the nonzeros of the tendons' sparse
products, of one substep of one env at the model's rest state. Under the
Newton solver the count depends on the rows held: the pipeline with no
row held (every contact point's narrow phase, the iterations' dense
algebra), plus one contact row's share (the plain version with a row for
every point of at most 16 of the model's pairs, evenly spaced) and one
limit row's (a model of one pair with and without its joint limits).
Runs on the CPU in a few seconds a configuration."""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import sys

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpubench import yardstick  # noqa: E402

ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "sin", "cos",
         "pow", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "reciprocal", "tanh"}
MAX_PAIRS = 16


def f32_ops_per_env_substep(model, q, qd, ctrl, link_delta=None) -> float:
    """f32 operations of one plain substep, per env (``q`` (nq, B))."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gpubench.reference.physics import soa

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ARITH and isinstance(out, torch.Tensor) and out.is_floating_point():
                Count.n += out.numel()
            elif name == "sum":
                Count.n += args[0].numel() - out.numel()
            elif name == "mm":  # the tendons' Jq q, Jv qd, Jv^T f: their nonzeros
                Count.n += 2 * int((args[0] != 0).sum()) * out.shape[1]
            return out

    with Count():
        soa.substep(model, q, qd, ctrl, model.dt / model.n_substeps, link_delta=link_delta)
    return Count.n / q.shape[1]


def rest_inputs(model):
    q = torch.as_tensor(np.asarray(model.default_qpos, np.float32)).reshape(-1, 1)
    return (q, torch.zeros(model.nv, 1), torch.zeros(model.nu, 1),
            torch.zeros(3 * model.nlink, 1))


def newton_counts(model) -> dict:
    from gpubench.reference.physics import soa_newton
    from gpubench.reference.physics.tables import num_contact_candidates

    inputs = rest_inputs(model)

    def ops(m, rows):
        held = soa_newton._in_margin_somewhere
        soa_newton._in_margin_somewhere = lambda _, cands: cands if rows else []
        try:
            return f32_ops_per_env_substep(m, *inputs)
        finally:
            soa_newton._in_margin_somewhere = held

    def variant(pairs, limited):
        m = copy.copy(model)
        m.contact_pairs, m._pair_groups = pairs, None
        m.jnt_limited = limited
        return m

    n_lim = sum(1 for v in model.jnt_limited if v > 0)
    one = model.contact_pairs[:1]
    per_lim = (ops(variant(one, model.jnt_limited), True)
               - ops(variant(one, tuple(0 for _ in model.jnt_limited)), True)) / n_lim
    step = max(1, -(-len(model.contact_pairs) // MAX_PAIRS))
    cut = variant(model.contact_pairs[::step], model.jnt_limited)
    per_row = (ops(cut, True) - ops(cut, False)) / num_contact_candidates(cut)
    return {"ops_no_row": ops(model, False) - n_lim * per_lim,
            "ops_per_contact_row": per_row, "ops_per_limit_row": per_lim}


def model_bytes(model) -> int:
    """Bytes of the model's numeric constants, as float32 or int32."""
    total = 0
    for v in vars(model).values():
        if isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
            total += 4 * v.size
    return total


def counts_for(config: str) -> dict:
    cfg = yardstick.load(f"configs/{config}.json")
    env_mod = importlib.import_module(f"gpubench.reference.envs.{cfg['reference_env']}")
    out = {"config": config, "tool": "python gpubench/counts.py " + config}
    for solver in ("penalty", "newton"):
        ref = env_mod.ReferenceEnv(solver, device="cpu")
        model = ref.model
        if solver == "penalty":
            out["penalty"] = {"ops_per_env_substep": f32_ops_per_env_substep(model,
                                                                            *rest_inputs(model))}
            out["substeps_per_control_step"] = ref.frame_skip * model.n_substeps
            out["io_bytes_per_env"] = 4 * (2 * model.nq + 2 * model.nv + model.nu
                                           + 3 * model.nlink)
            out["model_bytes"] = model_bytes(model)
        else:
            out["newton"] = newton_counts(model)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="+")
    p.add_argument("--check", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(1)
    bad = 0
    for name in args.configs:
        fresh = counts_for(name)
        path = os.path.join(yardstick.HERE, "counts", f"{name}.json")
        if args.check:
            with open(path) as f:
                same = json.load(f) == json.loads(json.dumps(fresh))
            print(name, "repeats" if same else "DIFFERS")
            bad += not same
        else:
            with open(path, "w") as f:
                json.dump(fresh, f, indent=1)
                f.write("\n")
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())

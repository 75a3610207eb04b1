"""K3 on the Adroit models on one NVIDIA GPU: the spread that sets its
tolerance on each, and two faulty tables that must fail that tolerance.

    python3 tools/torch_adroit_check.py [pen|hammer|door|relocate ...]

Needs one CUDA card and nvcc; run it from the root of a checkout. On each
task's env (all four by default; chip_smoke.py's ``adroit_states``: 512
envs, half after 10 control steps of random actions from the env's reset,
with its scene offsets, hammer's board, door's frame or relocate's ball,
and every link offset by up to 5 mm more, half drawn so that each of the
model's contact kinds touches, then 3 chained control steps; and the first
506 of them) it reads, per env-step, the max |err| of q and of qd of:

1. spread: the plain version (physics/soa.py) on the card against the
   plain version on the CPU;
2. kernel: K3 against the plain version on the card;
3. box_halfsize_x1.02: K3 with every box's half-sizes 2% too large in its
   pair rows;
4. tendon_limit_stiffness_x1.02: K3 with every tendon's limit stiffness 2%
   too large in its tendon block (the Adroit tendons are limit-only: their
   spring stiffness is 0, so a 2% error there changes nothing);

all from the same state and link offsets at every step, the kernel's own
(the chain follows K3), as chip_smoke.py holds it. It prints, for q and qd
and each variant, the max, the 99% quantile and how many env-steps exceed
each power of ten, and the tolerance chip_smoke.py takes for the model:
ten times the spread's max, rounded up to a power of ten. The last lines:
one JSON object with every reading, per model, and the card's name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import adroit_states  # noqa: E402
from mjrl_tpu_torch.envs import make  # noqa: E402
from mjrl_tpu_torch.physics import pkernel, probe, soa  # noqa: E402
from mjrl_tpu_torch.physics.tables import pair_groups  # noqa: E402

TASKS = ("pen", "hammer", "door", "relocate")
SCALE = 1.02
QUANTILE = 0.99
_BOX_KINDS = {5: (1,), 7: (11,), 8: (1, 11)}  # mj_substep.h kind -> box size slots


def faulty_tables(model, kernel, device, edit):
    """A copy of ``model`` whose K3 tables are ``edit(mf, mi, L)``'s."""
    L = kernel.build(pkernel.size_class(model)).layout
    mf, mi = (t.cpu().numpy().copy() for t in kernel.tables(model, device))
    edit(mf, mi, L)
    faulty = copy.copy(model)
    pkernel.set_tables(faulty, kernel, device, (torch.from_numpy(mf).to(device),
                                                torch.from_numpy(mi).to(device)))
    return faulty


def larger_boxes(mf, mi, L):
    npair = mi[L["I_NPAIR"]]
    kinds = mi[L["I_PAIR"] : L["I_PAIR"] + L["PAIR_I"] * npair].reshape(-1, L["PAIR_I"])[:, 0]
    rows = mf[L["F_PAIR"] : L["F_PAIR"] + L["PAIR_F"] * npair].reshape(-1, L["PAIR_F"])
    for kind, slots in _BOX_KINDS.items():
        for slot in slots:
            rows[kinds == kind, slot : slot + 3] *= np.float32(SCALE)


def stiffer_tendon_limits(mf, mi, L):
    nt, off = mi[L["I_NTEN"]], mi[L["I_TEN_F"]]
    mf[off : off + 8 * nt].reshape(nt, 8)[:, 5] *= np.float32(SCALE)


def per_env(variants, q, qd, delta, ctrls):
    """Per variant ``name: (step, against)``, the per env-step max |err|
    ``(q (steps, B), qd (steps, B))`` over the chained control steps, all
    from the kernel's state (the first variant's ``step``)."""
    errs = {name: ([], []) for name in variants}
    for ctrl in ctrls:
        outs, ran = {}, {}

        def run(fn):  # each function once per step: the plain version is slow
            if fn not in ran:
                ran[fn] = fn(q, qd, ctrl, delta)
            return ran[fn]

        for name, (step, against) in variants.items():
            got, want = run(step), run(against)
            for k in range(2):
                errs[name][k].append((got[k].cpu() - want[k].cpu()).abs().amax(dim=0))
            outs[name] = got
        q, qd = outs[next(iter(variants))]
    return {name: tuple(torch.stack(e) for e in pair) for name, pair in errs.items()}


def check(task, kernel):
    """Every reading on ``task``, and its tolerance."""
    env = make(f"adroit_{task}")
    model, frames = env.model, env.frame_skip
    kernel.build(pkernel.size_class(model))
    q0, qd0, d0, ctrls = adroit_states(env, 512, 3)
    cut = lambda x: x[:, :506].contiguous()  # noqa: E731
    cases = {"512": (q0, qd0, d0, ctrls),
             "506": (cut(q0), cut(qd0), cut(d0), [cut(c) for c in ctrls])}

    def plain(device=None):
        def run(q, qd, ctrl, d):
            if device is not None:
                q, qd, ctrl, d = (x.to(device) for x in (q, qd, ctrl, d))
            return soa.multistep(model, q, qd, ctrl, frames, link_delta=d)
        return run

    def k3(m):
        return lambda q, qd, c, d: kernel(m, q, qd, c, frames, link_delta=d)

    on_card = plain()
    dev = q0.device
    variants = {"kernel": (k3(model), on_card), "spread": (on_card, plain("cpu")),
                "box_halfsize_x1.02": (k3(faulty_tables(model, kernel, dev, larger_boxes)), on_card),
                "tendon_limit_stiffness_x1.02": (
                    k3(faulty_tables(model, kernel, dev, stiffer_tendon_limits)), on_card)}
    out = {"contacts": {k: int((v > 0).sum()) for k, v in probe.kind_depth(model, q0, d0).items()}}
    print(f"[{task}] 512: envs with a point at depth > 0 (first state): {out['contacts']}")
    assert set(out["contacts"]) == {k for k, _ in pair_groups(model).kinds}
    for case in cases:
        errs = per_env(variants, *cases[case])
        entry = {}
        for variant, pair in errs.items():
            for name, e in zip(("q", "qd"), pair):
                e = e.reshape(-1)
                entry[f"{variant}_{name}"] = {
                    "max": float(e.max()), "quantile": float(torch.quantile(e, QUANTILE)),
                    "env_steps": e.numel(),
                    "above": {f"1e{p}": int((e > 10.0 ** p).sum()) for p in range(-8, 2)}}
        out[case] = entry
        print(f"[{task}] {case}: {json.dumps(entry)}", flush=True)
    tol = {}
    for name in ("q", "qd"):
        s = max(out[c][f"spread_{name}"]["max"] for c in cases)
        tol[name] = 10.0 ** math.ceil(math.log10(10 * s)) if s > 0 else 1e-6
    out["tolerance"] = tol
    print(f"[{task}] tolerance (10 x the spread's max, up to a power of ten): {tol}")
    for case in cases:
        for variant in variants:
            held = {n: out[case][f"{variant}_{n}"]["max"] for n in ("q", "qd")}
            verdict = "passes" if all(held[n] <= tol[n] for n in tol) else "fails"
            print(f"[{task}] {case} {variant}: max q {held['q']:.3e} qd {held['qd']:.3e}: "
                  f"{verdict} the tolerance")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_adroit_check: no CUDA device", file=sys.stderr)
        return 2
    tasks = sys.argv[1:] or list(TASKS)
    if set(tasks) - set(TASKS):
        raise SystemExit(f"unknown tasks {tasks}; choose from {', '.join(TASKS)}")
    kernel = pkernel.PhysicsKernel("penalty", True)
    out = {task: check(task, kernel) for task in tasks}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

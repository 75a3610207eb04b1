"""K4 on Adroit pen with the Newton solver on one NVIDIA GPU: the spread that
sets its tolerance, and three faulty stages that must fail that tolerance.

    python3 tools/torch_adroit_newton_check.py [--batch 512]

Needs one CUDA card and nvcc; run it from the root of a checkout. On pen
with ``constraint_solver="newton"`` (chip_smoke.py's ``adroit_states``: BATCH
envs, half after 10 control steps of random actions from reset on the
card with every link offset by up to 5 mm, half drawn so that each of
pen's five contact kinds touches, then 3 chained control steps; and the
first BATCH - 6 of them) it reads, per env-step, the max |err| of q and of
qd of:

1. spread: the plain version (physics/soa.py, physics/soa_newton.py) on
   the card against the plain version on the CPU;
2. kernel: K4 against the plain version on the card;
3. no_fric_diag_in_metric: K4 built from a copy of the sources in a
   temporary directory whose substep leaves frictionloss's diagonal out of
   the Newton metric (it still enters the unconstrained solve);
4. box_solref_x1.02: K4 with every box geom's solref 2% too large (its
   rows' stiffness and damping);
5. torsional_mu_x1.02: K4 with every geom's torsional friction 2% too
   large, which only the condim-4 contacts (six facets) read;

all from the same state and link offsets at every step, the kernel's own
(the chain follows K4), as chip_smoke.py holds it. It also counts the
env-steps whose line search picked another fraction in K4 and in the plain
version on the card, the rows held per env at each step's entry state (the
mean and the max), and K4's overflow counter, which must stay 0. It prints,
for q and qd and each variant, the max, the 99% quantile and how many
env-steps exceed each power of ten, and the tolerance chip_smoke.py takes:
ten times the spread's max, rounded up to a power of ten, and the one it
takes for the 99% quantile (ten times the spread's quantile, likewise),
with each variant's verdict on both. The last lines:
one JSON object with every reading, and the card's name and power limit
from nvidia-smi.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import PEN_KINDS, adroit_states  # noqa: E402
from mjrl_tpu_torch.envs import make  # noqa: E402
from mjrl_tpu_torch.physics import pkernel, probe, soa  # noqa: E402
from mjrl_tpu_torch.physics.model import BOX  # noqa: E402

SCALE = 1.02
QUANTILE = 0.99
# in mj_warp_stages.h (mj_warp_crb's METRIC branch), which K4 builds on
_FRIC_METRIC = "S.Mf[i][i] = S.Mf[i][i] + S.fdiag[i];"
_FRIC_HEADER = "mj_warp_stages.h"


def faulty_model(model, edit):
    """A copy of ``model`` with ``edit(copy)`` applied and no packed tables."""
    faulty = copy.copy(model)
    pkernel.drop_tables(faulty)
    edit(faulty)
    return faulty


def box_solref(m):
    box = np.asarray(m.geom_type) == BOX
    m.geom_solref = np.asarray(m.geom_solref, np.float32).copy()
    m.geom_solref[box] *= np.float32(SCALE)


def torsional_mu(m):
    m.geom_friction_tor = np.asarray(m.geom_friction_tor, np.float32) * np.float32(SCALE)


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=512)
    full = p.parse_args().batch
    if not torch.cuda.is_available():
        print("torch_adroit_newton_check: no CUDA device", file=sys.stderr)
        return 2
    env = make("adroit_pen", constraint_solver="newton")
    model, frames = env.model, env.frame_skip
    iters = int(model.solver_iters)
    kernel = pkernel.PhysicsKernel("newton", True)
    size = pkernel.size_class(model)
    kernel.build(size)
    with tempfile.TemporaryDirectory() as tmp:
        csrc = Path(tmp) / "csrc"
        shutil.copytree(pkernel.CSRC, csrc)
        header = (csrc / _FRIC_HEADER).read_text()
        assert header.count(_FRIC_METRIC) == 1
        (csrc / _FRIC_HEADER).write_text(header.replace(_FRIC_METRIC, ""))
        no_fric = pkernel.PhysicsKernel("newton", True, csrc=csrc, build_dir=Path(tmp) / "build")
        no_fric.build(size)

        q0, qd0, d0, ctrls = adroit_states(env, full, 3)
        pkernel.K4.check()  # the warm-up's launches
        cut = lambda x: x[:, : full - 6].contiguous()  # noqa: E731
        cases = {str(full): (q0, qd0, d0, ctrls),
                 str(full - 6): (cut(q0), cut(qd0), cut(d0), [cut(c) for c in ctrls])}

        def plain(device=None):
            def run(q, qd, ctrl, d):
                if device is not None:
                    q, qd, ctrl, d = (x.to(device) for x in (q, qd, ctrl, d))
                return soa.multistep(model, q, qd, ctrl, frames, link_delta=d)
            return run

        def k4(m, k=kernel):
            return lambda q, qd, c, d: k(m, q, qd, c, frames, link_delta=d)

        on_card = plain()
        variants = {
            "kernel": (k4(model), on_card), "spread": (on_card, plain("cpu")),
            "no_fric_diag_in_metric": (k4(model, no_fric), on_card),
            "box_solref_x1.02": (k4(faulty_model(model, box_solref)), on_card),
            "torsional_mu_x1.02": (k4(faulty_model(model, torsional_mu)), on_card)}
        out = {"contacts": {k: int((v > 0).sum())
                            for k, v in probe.kind_depth(model, q0, d0).items()}}
        print(f"[pen newton] {full}: envs with a point at depth > 0 (first state): "
              f"{out['contacts']}")
        assert set(out["contacts"]) == set(PEN_KINDS)
        for case, (q, qd, d, cs) in cases.items():
            errs = per_env(variants, q, qd, d, cs)
            entry = {}
            for variant, pair in errs.items():
                for name, e in zip(("q", "qd"), pair):
                    e = e.reshape(-1)
                    entry[f"{variant}_{name}"] = {
                        "max": float(e.max()), "quantile": float(torch.quantile(e, QUANTILE)),
                        "env_steps": e.numel(),
                        "above": {f"1e{p}": int((e > 10.0 ** p).sum()) for p in range(-8, 2)}}
            # rows held and line-search flips along K4's chain
            held, flips, flips_first = [], 0, 0
            B = q.shape[1]
            for ctrl in cs:
                rows = probe.held_rows(model, q, d)
                held.append(rows["contacts"])
                picks = torch.full((frames * iters, B), -1, dtype=torch.int32, device=q.device)
                kq, kqd = kernel(model, q, qd, ctrl, frames, link_delta=d, picks=picks)
                plain_picks = []
                soa.multistep(model, q, qd, ctrl, frames, picks=plain_picks, link_delta=d)
                differ = picks != torch.cat(plain_picks)
                flips += int(differ.any(dim=0).sum())
                flips_first += int(differ[::iters].any(dim=0).sum())
                q, qd = kq, kqd
            held = torch.stack(held).float()
            entry["held_rows_mean"], entry["held_rows_max"] = float(held.mean()), float(held.max())
            entry["line_search_flips"], entry["line_search_flips_first"] = flips, flips_first
            out[case] = entry
            print(f"[pen newton] {case}: {json.dumps(entry)}", flush=True)
        kernel.check()
        no_fric.check()
    out["overflow"] = 0
    tol = {}
    for name in ("q", "qd"):
        s = max(out[c][f"spread_{name}"]["max"] for c in cases)
        tol[name] = 10.0 ** math.ceil(math.log10(10 * s)) if s > 0 else 1e-6
    tol_quantile = {}
    for name in ("q", "qd"):
        s = max(out[c][f"spread_{name}"]["quantile"] for c in cases)
        tol_quantile[name] = 10.0 ** math.ceil(math.log10(10 * s)) if s > 0 else 1e-6
    out["tolerance"], out["tolerance_quantile"] = tol, tol_quantile
    print(f"[pen newton] tolerance (10 x the spread's max, up to a power of ten): {tol}; "
          f"of the {QUANTILE:.0%} quantile: {tol_quantile}")
    for case in cases:
        for variant in variants:
            for what, limit in (("max", tol), ("quantile", tol_quantile)):
                held = {n: out[case][f"{variant}_{n}"][what] for n in ("q", "qd")}
                verdict = "passes" if all(held[n] <= limit[n] for n in limit) else "fails"
                print(f"[pen newton] {case} {variant}: {what} q {held['q']:.3e} qd "
                      f"{held['qd']:.3e}: {verdict} its tolerance")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

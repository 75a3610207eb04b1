"""K1 on humanoid on one NVIDIA GPU: the spread that sets its tolerance,
faulty sphere-capsule and sphere-sphere narrow phases that must fail that
tolerance, and the plain version in f64 where K1 exceeds it.

    python3 tools/torch_humanoid_check.py

Needs one CUDA card and nvcc; run it from the root of a checkout. On
humanoid (chip_smoke.py's ``start_states``: 1024 envs after 10 control
steps of random actions from reset, half of them replaced by folded states
where a pair of links overlaps, then 3 chained control steps; the first
1018 of them; and 4096 such envs, one control step) it reads, per
env-step, the max |err| of q and of qd of:

1. spread: the plain version (physics/soa.py) on the card against the
   plain version on the CPU;
2. kernel: K1 against the plain version on the card;
3. controls: K1 with every sphere-capsule pair's sphere radius, or every
   sphere-sphere pair's first radius, 2% too large (its pair rows edited)
   against the plain version on the card;
4. f64: K1, K1 built with ``-fmad=false`` (no fused multiply-adds, the
   plain version's rounding of each product) and the plain version (f32,
   on the card) each against the plain version run in f64 on the card;

all from the same state at every step, the kernel's own (the chain
follows K1), as chip_smoke.py holds it.

Humanoid's penalty forces jump where a contact's depth crosses 0 while it
closes (the damper's ``-kd v_n``) and where a joint crosses its limit (the
limit damper), so an env-step near such an event can take either side of
it from round-off alone, and the plain version disagrees with itself
across devices there by far more than elsewhere. The tool prints, for q
and qd and each variant, how many env-steps exceed each power of ten, the
max and the QUANTILE (99%) quantile of the per env-step max |err|, over
all env-steps and over those where each sphere kind touches (as
chip_smoke.py now holds it). chip_smoke.py's tolerance for K1 on humanoid
is ten times the spread's quantile, rounded up to a power of ten and no
looser than K1's (q 1e-3, qd 5e-2), and it holds that quantile of K1's per
env-step error to it. For each env-step where K1 exceeds that tolerance it
prints K1's, K1-without-FMA's and the f32 plain version's distance to the
f64 plain version: if the f32 plain version is as far from f64 as K1 is,
the excess is f32 round-off near a contact or limit event, not a fault of
K1; if K1 without FMA is as close to f64 as the plain version, the rest
of K1's excess is the contraction's rounding. It also
counts the envs with a sphere-sphere and with a sphere-capsule contact
point at depth > 0. The last lines: one JSON object with every reading,
and the card's name and power limit from nvidia-smi.
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

from chip_smoke import SPHERE_KINDS, TOL, kind_contacts, start_states  # noqa: E402
from mjrl_tpu_torch.envs import make  # noqa: E402
from mjrl_tpu_torch.physics import pkernel, probe, soa  # noqa: E402

RADIUS_SCALE = 1.02
QUANTILE = 0.99


def per_env(model, variants, q, qd, ctrls):
    """Per variant ``name: (step, against)``, the per env-step max |err|
    ``(q (steps, B), qd (steps, B))`` of ``step`` against ``against`` over
    the chained control steps, all from the kernel's state (the first
    variant's ``step``); and per sphere kind, the ``(steps, B)`` mask of the
    env-steps where it touches."""
    errs = {name: ([], []) for name in variants}
    masks = {k: [] for k in SPHERE_KINDS}
    for ctrl in ctrls:
        depth = probe.kind_depth(model, q)
        for k in SPHERE_KINDS:
            masks[k].append((depth[k] > 0).cpu())
        outs, memo = {}, {}
        run = lambda f: memo[f] if f in memo else memo.setdefault(f, f(q, qd, ctrl))  # noqa: E731
        for name, (step, against) in variants.items():
            got, want = run(step), run(against)
            for k in range(2):
                errs[name][k].append((got[k].cpu() - want[k].cpu()).abs().amax(dim=0))
            outs[name] = got
        q, qd = outs[next(iter(variants))]
    return ({name: tuple(torch.stack(e) for e in pair) for name, pair in errs.items()},
            {k: torch.stack(m) for k, m in masks.items()})


def plain(model, frames, device=None, dtype=None):
    """The plain control step, on ``device`` and in ``dtype`` if given
    (else the inputs')."""
    def run(q, qd, ctrl):
        if device is not None or dtype is not None:
            q, qd, ctrl = (x.to(device=device, dtype=dtype) for x in (q, qd, ctrl))
        return soa.multistep(model, q, qd, ctrl, frames)
    return run


def larger_radius(model, kernel, device, kind):
    """A copy of ``model`` whose K1 pair rows give geom i of every pair of
    ``kind`` (mj_substep.h: 3 sphere-sphere, 4 sphere-capsule, geom i the
    sphere) a radius ``RADIUS_SCALE`` times its own."""
    L = kernel.build(pkernel.size_class(model)).layout
    mf, mi = (t.cpu().numpy().copy() for t in kernel.tables(model, device))
    kinds = mi[L["I_PAIR"] :].reshape(-1, L["PAIR_I"])[:, 0]
    rows = mf[L["F_PAIR"] :].reshape(-1, L["PAIR_F"])
    rows[kinds == kind, 1] *= np.float32(RADIUS_SCALE)  # slot 1: geom i's radius
    faulty = copy.copy(model)
    pkernel.set_tables(faulty, kernel, device, (torch.from_numpy(mf).to(device),
                                                torch.from_numpy(mi).to(device)))
    return faulty


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_humanoid_check: no CUDA device", file=sys.stderr)
        return 2
    kernel = pkernel.PhysicsKernel("penalty", False)
    env = make("humanoid", horizon=1000)
    model, frames = env.model, env.frame_skip
    kernel.build(pkernel.size_class(model))
    # the same kernel without fused multiply-adds, in a build directory of its own
    nofma = pkernel.PhysicsKernel("penalty", False, build_dir=pkernel.BUILD_DIR / "nofma")
    flags = pkernel.NVCC_FLAGS
    pkernel.NVCC_FLAGS = flags + ("-fmad=false",)
    try:
        nofma.build(pkernel.size_class(model))
    finally:
        pkernel.NVCC_FLAGS = flags
    q0, qd0, ctrls = start_states(env, 1024, 3, fold=True)
    q4, qd4, ctrls4 = start_states(env, 4096, 1, fold=True)
    cases = {"1024": (q0, qd0, ctrls),
             "1018": (q0[:, :1018].contiguous(), qd0[:, :1018].contiguous(),
                      [c[:, :1018].contiguous() for c in ctrls]),
             "4096": (q4, qd4, ctrls4)}
    on_card = plain(model, frames)
    f64 = plain(model, frames, dtype=torch.float64)
    k1 = lambda m: lambda q, qd, c: kernel(m, q, qd, c, frames)  # noqa: E731
    dev = q0.device
    controls = {"sphere_capsule_radius_x1.02": larger_radius(model, kernel, dev, 4),
                "sphere_sphere_radius_x1.02": larger_radius(model, kernel, dev, 3)}
    k1_model = k1(model)
    variants = {"kernel": (k1_model, on_card), "spread": (on_card, plain(model, frames, "cpu")),
                **{name: (k1(m), on_card) for name, m in controls.items()},
                "kernel_vs_f64": (k1_model, f64), "plain_vs_f64": (on_card, f64),
                "kernel_nofma_vs_f64": (lambda q, qd, c: nofma(model, q, qd, c, frames), f64)}
    out = {"contacts": {}}
    for case, (q, qd, cs) in cases.items():
        out["contacts"][case] = kind_contacts(model, q)
        print(f"[humanoid] {case}: envs with a point at depth > 0 (first state): "
              f"{out['contacts'][case]}")
    cap = TOL["K1"]
    errs_of, masks_of = {}, {}
    for case in cases:
        errs, masks = per_env(model, variants, *cases[case])
        errs_of[case], masks_of[case] = errs, masks
        entry = {}
        for variant, pair in errs.items():
            for name, e in zip(("q", "qd"), pair):
                e = e.reshape(-1)
                entry[f"{variant}_{name}"] = {
                    "max": float(e.max()), "quantile": float(torch.quantile(e, QUANTILE)),
                    "env_steps": e.numel(),
                    "above": {f"1e{p}": int((e > 10.0 ** p).sum()) for p in range(-7, 2)},
                    "by_kind": {k: {"env_steps": int(m.sum()),
                                    "quantile": float(torch.quantile(e[m.reshape(-1)], QUANTILE)),
                                    "max": float(e[m.reshape(-1)].max())}
                                for k, m in masks.items() if bool(m.any())}}
        out[case] = entry
        print(f"[humanoid] {case}: {json.dumps(entry)}", flush=True)
    tol = {}
    for name in ("q", "qd"):
        s = max(out[c][f"spread_{name}"]["quantile"] for c in cases)
        tol[name] = min(10.0 ** math.ceil(math.log10(10 * s)), cap[name]) if s > 0 else cap[name]
    out["tolerance"] = tol
    print(f"[humanoid] tolerance (10 x the spread's {QUANTILE:.0%} quantile, up to a power of "
          f"ten, at most K1's): {tol}")
    for case in cases:
        for variant in ("kernel", *controls):
            held = {n: out[case][f"{variant}_{n}"]["quantile"] for n in ("q", "qd")}
            verdict = "passes" if all(held[n] <= tol[n] for n in tol) else "fails"
            print(f"[humanoid] {case} {variant}: {QUANTILE:.0%} quantile q {held['q']:.3e} "
                  f"qd {held['qd']:.3e}: {verdict} the tolerance")
            for k, r in out[case][f"{variant}_q"]["by_kind"].items():
                rd = out[case][f"{variant}_qd"]["by_kind"][k]
                verdict = "passes" if r["quantile"] <= tol["q"] and rd["quantile"] <= tol["qd"] \
                    else "fails"
                print(f"[humanoid] {case} {variant} over the {r['env_steps']} env-steps where "
                      f"{k} touches: {QUANTILE:.0%} quantile q {r['quantile']:.3e} qd "
                      f"{rd['quantile']:.3e}: {verdict} the tolerance")
        # the env-steps where K1 exceeds the tolerance, against f64
        over = []
        errs = errs_of[case]
        for i, name in enumerate(("q", "qd")):
            idx = torch.nonzero(errs["kernel"][i] > tol[name])
            for step, env_i in idx.tolist():
                over.append({"var": name, "step": step, "env": env_i,
                             "kernel_vs_plain": float(errs["kernel"][i][step, env_i]),
                             "kernel_vs_f64": float(errs["kernel_vs_f64"][i][step, env_i]),
                             "kernel_nofma_vs_f64": float(
                                 errs["kernel_nofma_vs_f64"][i][step, env_i]),
                             "plain_vs_f64": float(errs["plain_vs_f64"][i][step, env_i])})
        out[case]["over_tolerance_vs_f64"] = over
        for o in over:
            print(f"[humanoid] {case} over tolerance: {json.dumps(o)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1's fluid stage on one NVIDIA GPU: the spread that sets its tolerance on
swimmer, and faulty fluid stages that must fail that tolerance.

    python3 tools/torch_fluid_check.py

Needs one CUDA card and nvcc; run it from the root of a checkout. On
swimmer (256 and a ragged 250 envs from chip_smoke.py's ``start_states``:
10 control steps of random actions from reset, then 6 chained control
steps; and 250 envs from the lively states of
tests/test_torch_kernel_body.py's swimmer ``cuda`` test, one control step)
it prints the max |err| of q and qd over the steps of:

1. spread: the plain version (physics/soa.py) on the card against the
   plain version on the CPU, from the same state at every step (the chain
   follows the card);
2. kernel: K1 against the plain version on the card, from the kernel's own
   state at every step, as chip_smoke.py holds it;
3. controls, K1 with a faulty fluid stage against the plain version: the
   fluid off (``I_HAS_FLUID`` 0 in its table) and every drag constant 1%
   or 3% too large (its ``F_FLUID`` rows scaled).

Swimmer turns about z only, so the order of the product ``quat (x) iquat``
cannot show there. On ant in air (density 1.2, viscosity 2e-5; 256 envs
from reset with qd + U(-0.5, 0.5), one control step) it prints the effect
of the fluid on the plain version, K1 against plain, and K1 built from a
copy of ``csrc/`` in a temporary directory with that product's two factors
swapped.

chip_smoke.py's tolerance for K1 on swimmer is ten times the spread,
rounded up to a power of ten. The last lines: one JSON object with every
reading, and the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import copy
import json
import math
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import start_states  # noqa: E402
from mjrl_tpu_torch.envs import make  # noqa: E402
from mjrl_tpu_torch.physics import pkernel, soa  # noqa: E402

QMUL = "mj_qmul(k.quat[i], mf + MJ_F_IQUAT + 4 * i, q_wp);"
QMUL_SWAPPED = "mj_qmul(mf + MJ_F_IQUAT + 4 * i, k.quat[i], q_wp);"
AIR = (1.2, 2e-5)  # density, viscosity


def held(step, against, q, qd, ctrls):
    """``[max |err| of q, of qd]`` over the chained control steps of
    ``step``, each against ``against`` from the same state."""
    worst = [0.0, 0.0]
    for ctrl in ctrls:
        got, want = step(q, qd, ctrl), against(q, qd, ctrl)
        for k in range(2):
            worst[k] = max(worst[k], float((got[k].cpu() - want[k].cpu()).abs().max()))
        q, qd = got
    return worst


def with_tables(model, kernel, device, edit):
    """A copy of ``model`` whose K1 tables ``edit(mf, mi)`` has changed."""
    mf, mi = (t.cpu().numpy().copy() for t in kernel.tables(model, device))
    edit(mf, mi)
    faulty = copy.copy(model)
    pkernel.set_tables(faulty, kernel, device, (torch.from_numpy(mf).to(device),
                                                torch.from_numpy(mi).to(device)))
    return faulty


def swapped_kernel(tmp: Path) -> pkernel.PhysicsKernel:
    """K1 built from a copy of csrc/ with ``quat (x) iquat`` swapped."""
    src = tmp / "csrc"
    shutil.copytree(pkernel.CSRC, src)
    header = src / "mj_warp_stages.h"
    text = header.read_text()
    if text.count(QMUL) != 1:
        raise RuntimeError("the fluid stage's quaternion product was not found")
    header.write_text(text.replace(QMUL, QMUL_SWAPPED))
    return pkernel.PhysicsKernel("penalty", False, csrc=src, build_dir=tmp / "build")


def plain(model, frames, device=None):
    """The plain control step, on ``device`` if given (else the inputs')."""
    def run(q, qd, ctrl):
        if device is not None:
            q, qd, ctrl = (x.to(device) for x in (q, qd, ctrl))
        return soa.multistep(model, q, qd, ctrl, frames)
    return run


def launch(kernel, model, frames):
    return lambda q, qd, ctrl: kernel(model, q, qd, ctrl, frames)


def check_swimmer(kernel) -> dict:
    env = make("swimmer", horizon=1000)
    model, frames, L = env.model, env.frame_skip, kernel.build(0).layout
    q0, qd0, ctrls = start_states(env, 256, 6)
    rng = np.random.default_rng(0)  # the cuda test's states
    lively = [torch.as_tensor(x, dtype=torch.float32, device=env.device) for x in (
        model.default_qpos[:, None] + rng.uniform(-0.5, 0.5, (model.nq, 250)),
        rng.uniform(-2, 2, (model.nv, 250)), rng.uniform(-1, 1, (model.nu, 250)))]
    cases = {"warm_256": (q0, qd0, ctrls),
             "warm_250": (q0[:, :250].contiguous(), qd0[:, :250].contiguous(),
                          [c[:, :250].contiguous() for c in ctrls]),
             "lively_250": (lively[0], lively[1], [lively[2]])}

    def scaled(s):
        def edit(mf, mi):
            mf[L["F_FLUID"] : L["F_FLUID"] + L["FLUID_F"] * model.nlink] *= np.float32(s)
        return edit

    def fluid_off(mf, mi):
        mi[L["I_HAS_FLUID"]] = 0

    on_card = plain(model, frames)
    variants = {"spread": (on_card, plain(model, frames, "cpu")),
                "kernel": (launch(kernel, model, frames), on_card)}
    for name, edit in (("fluid_off", fluid_off), ("drag_x1.01", scaled(1.01)),
                       ("drag_x1.03", scaled(1.03))):
        faulty = with_tables(model, kernel, q0.device, edit)
        variants[name] = (launch(kernel, faulty, frames), on_card)
    out = {}
    for name, (step, against) in variants.items():
        for case, (q, qd, cs) in cases.items():
            out.setdefault(name, {})[case] = held(step, against, q, qd, cs)
            print(f"[swimmer] {name} {case}: max|err| q {out[name][case][0]:.3e} "
                  f"qd {out[name][case][1]:.3e}")
    spread = [max(v[k] for v in out["spread"].values()) for k in range(2)]
    out["tolerance"] = {n: 10.0 ** math.ceil(math.log10(10 * s)) if s > 0 else None
                        for n, s in zip(("q", "qd"), spread)}
    print(f"[swimmer] tolerance (10 x spread, up to a power of ten): {out['tolerance']}")
    return out


def check_ant_in_air(kernel, swapped) -> dict:
    ant = make("ant", horizon=100)
    air = copy.copy(ant.model)
    air.__dict__.pop("_torch_consts", None)
    pkernel.drop_tables(air)
    air.density, air.viscosity = AIR
    frames, dev = ant.frame_skip, ant.device
    state, _ = ant.reset(256, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(1)
    q = state.q.T.contiguous()
    noise = rng.uniform(-0.5, 0.5, (air.nv, 256))
    qd = (state.qd.T + torch.as_tensor(noise, dtype=torch.float32, device=dev)).contiguous()
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (air.nu, 256)), dtype=torch.float32, device=dev)
    in_air = plain(air, frames)
    out = {
        "fluid_effect": held(plain(ant.model, frames), in_air, q, qd, [ctrl]),
        "kernel": held(launch(kernel, air, frames), in_air, q, qd, [ctrl]),
        "quat_order_swapped": held(launch(swapped, air, frames), in_air, q, qd, [ctrl]),
    }
    for name, (eq, eqd) in out.items():
        print(f"[ant in air] {name}: max|err| q {eq:.3e} qd {eqd:.3e}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fluid_check: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        kernel, swapped = pkernel.PhysicsKernel("penalty", False), swapped_kernel(Path(tmp))
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda k: k.build(), (kernel, swapped)))
        out = {"swimmer": check_swimmer(kernel), "ant_air": check_ant_in_air(kernel, swapped)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

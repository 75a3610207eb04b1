"""Where kernel K4's time goes, stage by stage, on a GPU.

    python3 tools/torch_k4_stages.py

Builds K4 (``mjrl_tpu_torch/csrc/mj_ext_newton_kernel.cu``) in the Adroit
size class with ``-DMJ_STAGE_CLOCKS``, a build only this tool makes: lane 0
of each warp reads ``clock64()`` at the end of each stage of a substep
(``mj_ext_newton.h``'s ``MJ_ST_*``: kinematics, rows, RNE, forces, mass
matrix, L^T D L, gradient, H, Cholesky, triangular solves, line search,
integration) and the launch writes each env's cycles per stage, summed
over the control step, into a ``(stages, B)`` output. Runs one control
step of Adroit pen with the Newton solver at B=512 from ``chip_smoke.py``'s
``pen_states`` and ``pen_train_states`` and prints, per state set, each
stage's mean and max cycles per env and its share, the mean held rows per
env-substep, and the build's time per launch (CUDA events; the stamps cost
a little), with the card's name, power limit and SM clock; one JSON line
at the end.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("kinematics", "rows", "rne", "forces", "mass_matrix", "ltdl", "gradient", "hessian",
          "cholesky", "triangular", "line_search", "integrate")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k4_stages: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _cuda_ms, pen_states, pen_train_states
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import pkernel, probe

    env = make("adroit_pen", horizon=100, constraint_solver="newton")
    m, dev = env.model, env.device
    size = pkernel.size_class(m)
    path = pkernel.build_library(
        "mj_ext_newton_kernel.cu", (pkernel.nvcc_path(), *pkernel.NVCC_FLAGS,
                                    *pkernel.size_flags(size), "-DMJ_STAGE_CLOCKS"),
        pkernel.BUILD_DIR / "stages")
    lib = ctypes.CDLL(str(path))
    launch = lib.mj_ext_newton_launch
    launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    WL = pkernel.read_warp_layout(lib)
    if WL["N_STAGES"] != len(STAGES):
        raise RuntimeError(f"the build has {WL['N_STAGES']} stages, the tool names {len(STAGES)}")
    tables = [torch.from_numpy(a).to(dev) for a in (*pkernel.pack_tables(m, L, ext=True),
                                                    *pkernel.pack_newton_tables(m, L, NL, ext=True))]
    warps = min(WL["MAX_WARPS"], pkernel.SHARED_BYTES_PER_BLOCK // WL["BYTES"])
    n_sub, iters = env.frame_skip * m.n_substeps, int(m.solver_iters)
    dt = float(np.float32(m.dt / m.n_substeps))
    B = 512
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    out = {}
    for states in (pen_states, pen_train_states):
        q, qd, d, ctrls = states(env, B, 1)
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        clocks = torch.zeros(len(STAGES), B, dtype=torch.int64, device=dev)

        def step():
            err = launch(*(t.data_ptr() for t in (*tables, q, qd, ctrls[0], d, q_out, qd_out)), 0,
                         overflow.data_ptr(), B, n_sub, iters, dt, warps,
                         torch.cuda.current_stream().cuda_stream, clocks.data_ptr())
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        for _ in range(3):
            step()
        ms = _cuda_ms(step, 20)
        if int(overflow.item()):
            raise RuntimeError("held-row overflow")
        c = clocks.double()
        total = c.sum(dim=0)
        held = float(probe.held_rows(m, q, d)["contacts"].float().mean())
        print(f"{states.__name__}: {ms:.4f} ms per launch (this build), mean held rows per env "
              f"{held:.3f}, cycles per env and control step: mean {float(total.mean()):.0f}, "
              f"max {float(total.max()):.0f}")
        rows = {}
        for k, name in enumerate(STAGES):
            rows[name] = {"mean": float(c[k].mean()), "max": float(c[k].max()),
                          "share": float(c[k].sum() / total.sum())}
            print(f"  {name:12s} mean {rows[name]['mean']:12.0f}  max {rows[name]['max']:12.0f}  "
                  f"share {rows[name]['share']:.3f}")
        out[states.__name__] = {"ms": ms, "held_rows_mean": held,
                                "cycles_mean": float(total.mean()),
                                "cycles_max": float(total.max()), "stages": rows}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

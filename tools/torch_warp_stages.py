"""Where the warp kernels' time goes, stage by stage, on a GPU.

    python3 tools/torch_warp_stages.py [ROW ...]

Builds kernels K1 (``mjrl_tpu_torch/csrc/mj_kernel.cu``), K2
(``mj_newton_kernel.cu``), K3 (``mj_ext_kernel.cu``) and K4
(``mj_ext_newton_kernel.cu``) with
``-DMJ_STAGE_CLOCKS``, a build only this tool makes: lane 0 of each warp
reads ``clock64()`` at the end of each stage of a substep
(``mj_warp_stages.h``'s ``MJ_ST_*``: kinematics, rows (K1: its contact
wrenches and fluid drag; K3: its rounds of contact wrenches), RNE,
forces, mass matrix, L^T D L, gradient, H, Cholesky, triangular solves,
line search, integration; K1 and K3 have no Newton stages) and the
launch writes each env's cycles per stage, summed over the
control step, into a ``(stages, B)`` output. Runs one control step of each
row (default: all) from ``chip_smoke.py``'s states, at the launch's
default warps per block:

- ``ant_K1``: ant, B=1024 (``start_states``);
- ``humanoid_K1``: humanoid, B=1024, half the batch folded;
- ``ant_K2``: ant with the Newton solver, B=1024, settled on the floor;
- ``pen_K3``: Adroit pen, B=512 (``adroit_states``, with their link
  offsets);
- ``pen_states_K4``, ``pen_train_states_K4``: Adroit pen with the Newton
  solver, B=512.

Prints, per row, each stage's mean and max cycles per env and its share,
and the build's time per launch (CUDA events; the stamps cost a little),
with the card's name, power limit and SM clock; one JSON line at the end.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("kinematics", "rows", "rne", "forces", "mass_matrix", "ltdl", "gradient", "hessian",
          "cholesky", "triangular", "line_search", "integrate")
ROWS = ("ant_K1", "humanoid_K1", "ant_K2", "pen_K3", "pen_states_K4", "pen_train_states_K4")


def _clocked(kernel, size: int):
    """The MJ_STAGE_CLOCKS build of ``kernel``'s source in size class
    ``size`` (``pkernel.load_library``) and its launch's parameters: the
    kernel's, then ``clocks``."""
    from mjrl_tpu_torch.physics import pkernel

    params = (*kernel.params, "clocks")
    built = pkernel.load_library(kernel.file, size, {kernel.launch_fn: params},
                                 ("-DMJ_STAGE_CLOCKS",), build_dir=pkernel.BUILD_DIR / "stages")
    if built.warp_layout["N_STAGES"] != len(STAGES):
        raise RuntimeError(f"the build has {built.warp_layout['N_STAGES']} stages, the tool names "
                           f"{len(STAGES)}")
    return getattr(built.lib, kernel.launch_fn), params


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_warp_stages: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _cuda_ms, adroit_states, pen_train_states, start_states
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import pkernel, probe

    wanted = sys.argv[1:] or list(ROWS)
    unknown = set(wanted) - set(ROWS)
    if unknown:
        raise SystemExit(f"unknown rows {sorted(unknown)}; choose from {ROWS}")
    out = {}
    for row in wanted:
        kname = row.rsplit("_", 1)[1]
        kernel = getattr(pkernel, kname)
        if kname == "K1":
            env = make(row.split("_")[0], horizon=1000)
        elif kname == "K3":
            env = make("adroit_pen", horizon=100)
        elif kname == "K2":
            env = make("ant", horizon=100, constraint_solver="newton", n_substeps=1)
        else:
            env = make("adroit_pen", horizon=100, constraint_solver="newton")
        m, dev = env.model, env.device
        size = pkernel.size_class(m)
        B = 512 if kernel.ext else 1024
        if kname == "K1":
            q, qd, ctrls = start_states(env, B, 1, fold=row.startswith("humanoid"))
            d = None
        elif kname == "K2":
            q, qd, ctrls = start_states(env, B, 1, warm_steps=15, warm_scale=0.0)
            d = None
        else:
            states = pen_train_states if row.startswith("pen_train") else adroit_states
            q, qd, d, ctrls = states(env, B, 1)
        launch, params = _clocked(kernel, size)
        warps = kernel.launch_warps(size, B, dev)
        held = (float(probe.held_rows(m, q, d)["contacts"].float().mean()) if kernel.newton
                else None)
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        clocks = torch.zeros(len(STAGES), B, dtype=torch.int64, device=dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        # the kernel's tables and launch arguments by name, no picks and no stats
        values = dict(zip(("mf", "mi", "nf", "ni"), kernel.tables(m, dev)), q=q, qd=qd,
                      ctrl=ctrls[0], delta=d, q_out=q_out, qd_out=qd_out, picks=None,
                      overflow=overflow, stats=None, slab=kernel.slab(size, B, dev), B=B,
                      n_sub=env.frame_skip * m.n_substeps, iters=int(m.solver_iters),
                      dt=float(np.float32(m.dt / m.n_substeps)), warps=warps,
                      stream=torch.cuda.current_stream().cuda_stream, clocks=clocks)
        args = [v.data_ptr() if isinstance(v, torch.Tensor) else 0 if v is None else v
                for v in (values[p] for p in params)]

        def step():
            err = launch(*args)
            if err:
                raise RuntimeError(f"{row}: launch failed: CUDA error {err}")

        for _ in range(3):
            step()
        c = clocks.double()
        ms = _cuda_ms(step, 20)
        if int(overflow.item()):
            raise RuntimeError(f"{row}: held-row overflow")
        total = c.sum(dim=0)
        extra = "" if held is None else f", mean held rows per env {held:.3f}"
        print(f"{row}: {ms:.4f} ms per launch (this build), {warps} warps per block{extra}, "
              f"cycles per env and control step: mean {float(total.mean()):.0f}, "
              f"max {float(total.max()):.0f}")
        stages = {}
        for k, name in enumerate(STAGES):
            if float(c[k].sum()) == 0.0:
                continue
            stages[name] = {"mean": float(c[k].mean()), "max": float(c[k].max()),
                            "share": float(c[k].sum() / total.sum())}
            print(f"  {name:12s} mean {stages[name]['mean']:12.0f}  max {stages[name]['max']:12.0f}"
                  f"  share {stages[name]['share']:.3f}")
        out[row] = {"ms": ms, "warps_per_block": warps, "cycles_mean": float(total.mean()),
                    "cycles_max": float(total.max()), "stages": stages}
        if held is not None:
            out[row]["held_rows_mean"] = held
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

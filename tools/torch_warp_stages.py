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

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGES = ("kinematics", "rows", "rne", "forces", "mass_matrix", "ltdl", "gradient", "hessian",
          "cholesky", "triangular", "line_search", "integrate")
ROWS = ("ant_K1", "humanoid_K1", "ant_K2", "pen_K3", "pen_states_K4", "pen_train_states_K4")


def _clocked(source: str, size: int, launch_fn: str, n_ptr: int, ints: int = 2):
    """The MJ_STAGE_CLOCKS build of ``source`` in size class ``size``, its
    launch function (``n_ptr`` pointers, then ``ints`` ints: B, n_sub[,
    iters], then dt, warps, stream, clocks) and its layouts."""
    from mjrl_tpu_torch.physics import pkernel

    path = pkernel.build_library(source, (pkernel.nvcc_path(), *pkernel.NVCC_FLAGS,
                                          *pkernel.size_flags(size), "-DMJ_STAGE_CLOCKS"),
                                 pkernel.BUILD_DIR / "stages")
    lib = ctypes.CDLL(str(path))
    launch = getattr(lib, launch_fn)
    launch.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * ints + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    wl = pkernel.read_warp_layout(lib)
    if wl["N_STAGES"] != len(STAGES):
        raise RuntimeError(f"the build has {wl['N_STAGES']} stages, the tool names {len(STAGES)}")
    return lib, launch, wl


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
        n_sub, iters = env.frame_skip * m.n_substeps, int(m.solver_iters)
        dt = float(np.float32(m.dt / m.n_substeps))
        stream = torch.cuda.current_stream().cuda_stream
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        held = None
        if kname == "K1":
            B = 1024
            lib, launch, wl = _clocked("mj_kernel.cu", size, "mj_multistep_launch", 7)
            L = pkernel.read_layout(lib)
            tables = [torch.from_numpy(a).to(dev) for a in
                      pkernel.pack_tables(m, L, max_points=wl["MAX_POINTS"])]
            q, qd, ctrls = start_states(env, B, 1, fold=row.startswith("humanoid"))
            pkernel.K1.build(size)
            warps = pkernel.K1.launch_warps(size, B, dev)
            ptrs = lambda: (*tables, q, qd, ctrls[0], q_out, qd_out)  # noqa: E731
            tail = lambda clocks: (B, n_sub, dt, warps, stream, clocks.data_ptr())  # noqa: E731
        elif kname == "K3":
            B = 512
            lib, launch, wl = _clocked("mj_ext_kernel.cu", size, "mj_ext_launch", 8)
            pkernel.K3.build(size)
            pkernel.check_tendons(m, wl)
            tables = [torch.from_numpy(a).to(dev) for a in
                      pkernel.pack_tables(m, pkernel.read_layout(lib), ext=True)]
            q, qd, d, ctrls = adroit_states(env, B, 1)
            warps = pkernel.K3.launch_warps(size, B, dev)
            ptrs = lambda: (*tables, q, qd, ctrls[0], d, q_out, qd_out)  # noqa: E731
            tail = lambda clocks: (B, n_sub, dt, warps, stream, clocks.data_ptr())  # noqa: E731
        else:
            if kname == "K2":
                B = 1024
                source, fn, n_ptr, ext = "mj_newton_kernel.cu", "mj_newton_launch", 12, False
                q, qd, ctrls = start_states(env, B, 1, warm_steps=15, warm_scale=0.0)
                d = None
                pkernel.K2.build(size)
                warps = pkernel.K2.launch_warps(size, B, dev)
            else:
                B = 512
                source, fn, n_ptr, ext = "mj_ext_newton_kernel.cu", "mj_ext_newton_launch", 14, True
                states = adroit_states if row.startswith("pen_states") else pen_train_states
                q, qd, d, ctrls = states(env, B, 1)
                pkernel.K4.build(size)
                warps = pkernel.K4.launch_warps(size, B, dev)
            lib, launch, wl = _clocked(source, size, fn, n_ptr, ints=3)
            L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
            tables = [torch.from_numpy(a).to(dev) for a in
                      (*pkernel.pack_tables(m, L, ext=ext),
                       *pkernel.pack_newton_tables(m, L, NL, ext=ext))]
            held = float(probe.held_rows(m, q, d)["contacts"].float().mean())
            # K4: after the stats (none), the slab of the held rows past SHARED_HELD
            k4_args = ((d,), (pkernel.K4.slab(size, B, dev),)) if ext else ((), ())

            def ptrs():
                return (*tables, q, qd, ctrls[0], *k4_args[0], q_out, qd_out, None, overflow,
                        None, *k4_args[1])

            tail = lambda clocks: (B, n_sub, iters, dt, warps, stream, clocks.data_ptr())  # noqa: E731
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        clocks = torch.zeros(len(STAGES), B, dtype=torch.int64, device=dev)

        def step():
            args = [t if isinstance(t, int) else 0 if t is None else t.data_ptr() for t in ptrs()]
            err = launch(*args, *tail(clocks))
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

"""Times of the port's kernels, to compare two versions on one card.

    python3 tools/torch_kernel_times.py LABEL [--smoke PATH]

Run from the root of a checkout (it imports that checkout's
``mjrl_tpu_torch``), with one CUDA card. First, in the fresh process, the
card's free memory (``torch.cuda.mem_get_info``) just before and after K4's
first launch, less what PyTorch's allocator reserved in between: what
the CUDA driver sets aside for that launch (local memory for every resident
thread, as a kernel's stack needs). Then times one control step, CUDA
events over 20 launches after 3, of: K4 on Adroit pen with the Newton
solver (B=512, 5 x 1) from ``pen_states`` and from ``pen_train_states``
(the training path's states), K1 on ant (B=1024, 5 frames x 4 substeps),
K2 on ant with the Newton solver (B=1024, 5 x 1, states settled on the
floor), K1 on hopper (B=256, 4 x 1, half the batch folded) and K3 on
Adroit pen (B=512, 5 x 1, ``pen_states`` with their link offsets). The
states come from ``chip_smoke.py``: the checkout's, or the one at PATH.
To compare an older version, copy this file into its checkout and run
both in turns in one call (older, newer, newer, older), each older run
with ``--smoke`` naming the newer checkout's ``chip_smoke.py``, so that
both time the same states. Prints one JSON line with LABEL, the times,
the memory and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("label", nargs="?", default=str(ROOT))
    p.add_argument("--smoke", default=str(ROOT / "chip_smoke.py"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", args.smoke)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.pkernel import K1, K2, K3, K4, size_class

    out = {"label": args.label}
    pen_newton = make("adroit_pen", horizon=100, constraint_solver="newton")
    m, dev, frames = pen_newton.model, pen_newton.device, pen_newton.frame_skip
    # K4's first launch, from reset states (a reset launches no kernel)
    K4.build(size_class(m))
    K4._tables(m, dev)
    state, _ = pen_newton.reset(512, torch.Generator(device=dev).manual_seed(0))
    q, qd = state.q.T.contiguous(), state.qd.T.contiguous()
    d = state.link_delta.reshape(512, -1).T.contiguous()
    ctrl = torch.zeros(m.nu, 512, device=dev)
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    K4(m, q, qd, ctrl, frames, link_delta=d)
    torch.cuda.synchronize()
    free1, reserved1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    out["K4_first_launch_reserved_bytes"] = (free0 - free1) - (reserved1 - reserved0)
    out["free_bytes_before_K4"], out["free_bytes_after_K4"] = free0, free1
    sets = {"pen_states": smoke.pen_states(pen_newton, 512, 1),
            "pen_train_states": smoke.pen_train_states(pen_newton, 512, 1)}
    for name, (q, qd, d, ctrls) in sets.items():
        step = lambda: K4(m, q, qd, ctrls[0], frames, link_delta=d)  # noqa: E731
        for _ in range(3):
            step()
        out[f"{name}_K4_ms"] = smoke._cuda_ms(step, 20)
    K4.check()

    rows = {"ant_K1": (make("ant", horizon=100), K1, 1024, {}),
            "ant_K2": (make("ant", horizon=100, constraint_solver="newton", n_substeps=1), K2,
                       1024, dict(warm_steps=15, warm_scale=0.0)),
            "hopper_K1": (make("hopper", horizon=1000), K1, 256, dict(fold=True))}
    for name, (env, kernel, batch, kw) in rows.items():
        q, qd, ctrls = smoke.start_states(env, batch, 1, **kw)
        step = lambda: kernel(env.model, q, qd, ctrls[0], env.frame_skip)  # noqa: E731
        for _ in range(3):
            step()
        out[name + "_ms"] = smoke._cuda_ms(step, 20)
    pen = make("adroit_pen", horizon=100)
    q, qd, d, ctrls = smoke.pen_states(pen, 512, 1)
    step = lambda: K3(pen.model, q, qd, ctrls[0], pen.frame_skip, link_delta=d)  # noqa: E731
    for _ in range(3):
        step()
    out["pen_K3_ms"] = smoke._cuda_ms(step, 20)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

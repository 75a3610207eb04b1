"""Times of the small models' kernels, to compare two versions on one card.

    python3 tools/torch_kernel_times.py LABEL

Run from the root of a checkout (it imports that checkout's
``mjrl_tpu_torch`` and ``chip_smoke.py``), with one CUDA card. Times one
control step, CUDA events over 20 launches after 3, from chip_smoke.py's
start states, of: K1 on ant (B=1024, 5 frames x 4 substeps), K2 on ant
with the Newton solver (B=1024, 5 x 1, states settled on the floor), K1
on hopper (B=256, 4 x 1, half the batch folded) and K3 on Adroit pen
(B=512, 5 x 1, ``pen_states`` with their link offsets). To compare an older
version, copy this file into its checkout and run both in turns in one
call (older, newer, newer, older). Prints one JSON line with LABEL, the
times and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _cuda_ms, pen_states, start_states
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.pkernel import K1, K2, K3

    rows = {"ant_K1": (make("ant", horizon=100), K1, 1024, {}),
            "ant_K2": (make("ant", horizon=100, constraint_solver="newton", n_substeps=1), K2,
                       1024, dict(warm_steps=15, warm_scale=0.0)),
            "hopper_K1": (make("hopper", horizon=1000), K1, 256, dict(fold=True))}
    out = {"label": sys.argv[1] if len(sys.argv) > 1 else str(ROOT)}
    for name, (env, kernel, batch, kw) in rows.items():
        q, qd, ctrls = start_states(env, batch, 1, **kw)
        step = lambda: kernel(env.model, q, qd, ctrls[0], env.frame_skip)  # noqa: E731
        for _ in range(3):
            step()
        out[name + "_ms"] = _cuda_ms(step, 20)
    pen = make("adroit_pen", horizon=100)
    q, qd, d, ctrls = pen_states(pen, 512, 1)
    step = lambda: K3(pen.model, q, qd, ctrls[0], pen.frame_skip, link_delta=d)  # noqa: E731
    for _ in range(3):
        step()
    out["pen_K3_ms"] = _cuda_ms(step, 20)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

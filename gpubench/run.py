"""Run one cell of the benchmark of ``mjrl_tpu_torch`` once.

    python gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (iterations of the window), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number the check compared with its limit (also the last lines on standard
error). Exits non-zero with no result line without a CUDA device, with
fewer devices than the cell asks for, or if JAX or the JAX package was
loaded. Builds and caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".gpubench_cache", sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):  # one process, few threads: a steadier host
    os.environ[var] = "1"
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    import torch

    import mjrl_tpu_torch
    from gpubench import harness

    if not os.path.abspath(mjrl_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"gpubench: the port under test is not this checkout's: {mjrl_tpu_torch.__file__}",
              file=sys.stderr)
        return 4

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    except harness.ImportGuardError as e:
        print(f"gpubench: forbidden modules {e}", file=sys.stderr)
        return 3
    out.pop("_numbers", None)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Register and stack use of the port's CUDA kernels, as ptxas reports them.

    python3 tools/torch_ptxas.py [CSRC_DIR ...]

Compiles every ``*.cu`` in each directory (default: the port's
``mjrl_tpu_torch/csrc``) with the kernels' own nvcc flags plus
``-Xptxas -v`` into ``mjrl_tpu_torch/_build/ptxas/`` and prints, per
kernel, ptxas's registers, stack frame, spill stores and loads. Give it a
second directory, such as an older checkout's ``csrc``, to compare two
versions in one run. Needs nvcc (the CUDA toolkit); no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mjrl_tpu_torch.physics.pkernel import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path  # noqa: E402

_FUNC = re.compile(r"Compiling entry function '(\w+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(source: Path, out_dir: Path) -> str:
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out_dir / (source.stem + ".so")),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lines, func, stack = [], None, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := _FUNC.search(line):
            func = m.group(1)
        elif m := _STACK.search(line):
            stack = m.groups()
        elif (m := _REGS.search(line)) and func:
            lines.append(f"{source}: {func}: {m.group(1)} registers, {stack[0]} bytes stack frame, "
                         f"{stack[1]} bytes spill stores, {stack[2]} bytes spill loads")
            func = None
    return "\n".join(lines)


def main() -> int:
    dirs = [Path(d) for d in sys.argv[1:]] or [CSRC]
    jobs = [(src, BUILD_DIR / "ptxas" / str(i)) for i, d in enumerate(dirs)
            for src in sorted(d.glob("*.cu"))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for report in pool.map(lambda job: ptxas_report(*job), jobs):
            print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Register and stack use of the port's CUDA kernels, as ptxas reports them.

    python3 tools/torch_ptxas.py [CSRC_DIR ...]

Compiles every ``*.cu`` in each directory (default: the port's
``mjrl_tpu_torch/csrc``) with the kernels' own nvcc flags plus
``-Xptxas -v`` into ``mjrl_tpu_torch/_build/ptxas/`` and prints, per
kernel and size class (K1, ``mj_kernel.cu``, in the two classes its
models use; K2 in the small one; K3, ``mj_ext_kernel.cu``, and K4,
``mj_ext_newton_kernel.cu``, in the Adroit class), ptxas's registers,
stack frame, spill stores and loads, and for a build that exports
``mj_warp_layout()`` (the kernels that run one warp per env) the dynamic
shared memory per warp and the warps per block at most. Give it a
second directory, such as an older checkout's ``csrc``, to compare two
versions in one run. Needs nvcc (the CUDA toolkit); no card.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mjrl_tpu_torch.physics.pkernel import (  # noqa: E402
    BUILD_DIR,
    CSRC,
    NVCC_FLAGS,
    SIZE_CLASSES,
    nvcc_path,
    size_flags,
)

# the size classes each source is built in (pkernel.SIZE_CLASSES)
_CLASSES = {"mj_kernel.cu": (0, 1), "mj_ext_kernel.cu": (2,), "mj_ext_newton_kernel.cu": (2,)}
_FUNC = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(source: Path, out_dir: Path, size: int = 0) -> str:
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{source.stem}_{size}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, *size_flags(size), "-Xptxas", "-v", "-o", str(lib),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # each function's stack line follows its "Function properties" line (or
    # the entry's "Compiling entry function" line); the registers line ends
    # the entry's block
    lines, entries, entry, props, stacks = [], set(), None, None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        if m := _FUNC.search(line):
            entry = props = m.group(1)
            entries.add(entry)
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif m := _STACK.search(line):
            stacks[props] = m.groups()
        elif (m := _REGS.search(line)) and entry:
            stack = stacks[entry]
            lines.append(f"{source} (size class {SIZE_CLASSES[size]}): {entry}: {m.group(1)} "
                         f"registers, {stack[0]} bytes stack frame, "
                         f"{stack[1]} bytes spill stores, {stack[2]} bytes spill loads")
            entry = None
    for func, stack in stacks.items():  # the functions the entries call, not inlined
        if func not in entries:
            lines.append(f"{source} (size class {SIZE_CLASSES[size]}): device function {func}: "
                         f"{stack[0]} bytes stack frame, {stack[1]} bytes spill stores, "
                         f"{stack[2]} bytes spill loads")
    loaded = ctypes.CDLL(str(lib))
    if hasattr(loaded, "mj_warp_layout"):
        # bytes per warp and warps per block lead the layout in every version
        buf = (ctypes.c_int * 16)()
        loaded.mj_warp_layout(buf)
        lines.append(f"{source} (size class {SIZE_CLASSES[size]}): {buf[0]} bytes of dynamic "
                     f"shared memory per warp, at most {buf[2]} warps per block")
    return "\n".join(lines)


def main() -> int:
    dirs = [Path(d) for d in sys.argv[1:]] or [CSRC]
    jobs = [(src, BUILD_DIR / "ptxas" / str(i), size) for i, d in enumerate(dirs)
            for src in sorted(d.glob("*.cu"))
            for size in _CLASSES.get(src.name, (0,))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        for report in pool.map(lambda job: ptxas_report(*job), jobs):
            print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times of the port's kernels, to compare two versions on one card.

    python3 tools/torch_kernel_times.py LABEL [--smoke PATH] [--inputs FILE]
        [--save FILE] [--compare FILE ...] [--memory K1|K2|K3|K4]

Run from the root of a checkout (it imports that checkout's
``mjrl_tpu_torch``), with one CUDA card. First, in the fresh process, the
card's free memory (``torch.cuda.mem_get_info``) just before and after the
first launch of one kernel (K4 unless ``--memory`` names another; a reset
launches no kernel), less what PyTorch's allocator reserved in between:
what the CUDA driver sets aside for that launch (local memory for every
resident thread, as a kernel's stack needs). With ``--memory`` it stops
there. Then times one control step, CUDA events over 20 launches after 3,
of: K4 on Adroit pen with the Newton solver (B=512, 5 x 1) from
``adroit_states`` and from ``pen_train_states`` (the training path's
states); K1 on ant (B=1024, 5 frames x 4 substeps); K2 on ant with the
Newton solver (B=1024, 5 x 1, states settled on the floor); K1 and K2 on
hopper (B=256, 4 x 1, half the batch folded); K1 on swimmer (B=256); K1
on walker2d (B=4096, the walker2d TRPO path's); K1 on humanoid (B=1024,
half the batch folded); and K3 on Adroit pen (B=512, 5 x 1, ``adroit_states``
with their link offsets) and on Adroit hammer (B=512, ``hammer_states``,
with theirs). The states come from ``chip_smoke.py``: the
checkout's, or the one at PATH; ``--inputs FILE`` loads them from FILE if
it exists and else saves them there, so that every run of a comparison
steps the same inputs. ``--save FILE`` keeps each kernel's outputs of one
launch; ``--compare FILE`` (one or more) reads another run's and reports,
per kernel, whether they are bit for bit the same and the max |diff| of q
and qd. To compare an older version, copy this file into its checkout and
run both in turns in one call (older, newer, newer, older), each older run
with ``--smoke`` naming the newer checkout's ``chip_smoke.py`` and all
with one ``--inputs`` file. Prints one JSON line with LABEL, the times,
the memory, the comparisons and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def _rows(smoke, make, adroit_model, saved=None):
    """name -> (env, kernel name, inputs: dict of tensors) of every timed
    row, the inputs from ``saved`` (name -> dict of CPU tensors) or else
    made by ``chip_smoke.py``'s state functions."""
    import torch

    pen_newton = make("adroit_pen", horizon=100, constraint_solver="newton")
    pen = make("adroit_pen", horizon=100)
    envs = {"pen_states_K4": (pen_newton, "K4"), "pen_train_states_K4": (pen_newton, "K4")}
    kinds = (("ant_K1", make("ant", horizon=100), "K1", 1024, {}),
             ("ant_K2", make("ant", horizon=100, constraint_solver="newton", n_substeps=1), "K2",
              1024, dict(warm_steps=15, warm_scale=0.0)),
             ("hopper_K1", make("hopper", horizon=1000), "K1", 256, dict(fold=True)),
             ("hopper_K2", make("hopper", horizon=1000, constraint_solver="newton"), "K2", 256,
              dict(fold=True)),
             ("swimmer_K1", make("swimmer", horizon=1000), "K1", 256, {}),
             ("walker2d_K1", make("walker2d", horizon=1000), "K1", 4096, {}),
             ("humanoid_K1", make("humanoid", horizon=1000), "K1", 1024, dict(fold=True)))
    envs.update({name: (env, k) for name, env, k, _, _ in kinds})
    # Adroit hammer's model with the Adroit envs' frame skip, not the env:
    # checkouts from before the hammer env have only the model
    hammer = types.SimpleNamespace(model=adroit_model("hammer"), frame_skip=5)
    envs["pen_K3"] = (pen, "K3")
    envs["hammer_K3"] = (hammer, "K3")
    if saved is not None:
        dev = torch.device("cuda")
        return {name: (env, k, {a: t.to(dev) for a, t in saved[name].items()})
                for name, (env, k) in envs.items()}
    rows = {}
    for name, states in (("pen_states_K4", smoke.adroit_states),
                         ("pen_train_states_K4", smoke.pen_train_states)):
        q, qd, d, ctrls = states(pen_newton, 512, 1)
        rows[name] = (pen_newton, "K4", dict(q=q, qd=qd, ctrl=ctrls[0], link_delta=d))
    for name, env, kernel, batch, kw in kinds:
        q, qd, ctrls = smoke.start_states(env, batch, 1, **kw)
        rows[name] = (env, kernel, dict(q=q, qd=qd, ctrl=ctrls[0]))
    q, qd, d, ctrls = smoke.adroit_states(pen, 512, 1)
    rows["pen_K3"] = (pen, "K3", dict(q=q, qd=qd, ctrl=ctrls[0], link_delta=d))
    from mjrl_tpu_torch.physics.pkernel import K3

    q, qd, d, ctrls = smoke.hammer_states(hammer.model, K3, 512, 1)
    rows["hammer_K3"] = (hammer, "K3", dict(q=q, qd=qd, ctrl=ctrls[0], link_delta=d))
    return rows


def _first_launch_bytes(make, kernels, which: str) -> dict:
    """The driver's reservation at ``which``'s first launch in this
    process, from reset states."""
    import torch

    from mjrl_tpu_torch.physics.pkernel import size_class

    env = {"K1": lambda: make("ant", horizon=100),
           "K2": lambda: make("ant", horizon=100, constraint_solver="newton", n_substeps=1),
           "K3": lambda: make("adroit_pen", horizon=100),
           "K4": lambda: make("adroit_pen", horizon=100, constraint_solver="newton")}[which]()
    adroit = which in ("K3", "K4")
    kernel, m, dev, B = kernels[which], env.model, env.device, 512 if adroit else 1024
    kernel.build(size_class(m))
    kernel.tables(m, dev)
    state, _ = env.reset(B, torch.Generator(device=dev).manual_seed(0))
    q, qd = state.q.T.contiguous(), state.qd.T.contiguous()
    kw = {}
    if adroit:
        kw["link_delta"] = state.link_delta.reshape(B, -1).T.contiguous()
    ctrl = torch.zeros(m.nu, B, device=dev)
    torch.cuda.synchronize()
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    kernel(m, q, qd, ctrl, env.frame_skip, **kw)
    torch.cuda.synchronize()
    free1, reserved1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()
    return {f"{which}_first_launch_reserved_bytes": (free0 - free1) - (reserved1 - reserved0),
            f"free_bytes_before_{which}": free0, f"free_bytes_after_{which}": free1}


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("label", nargs="?", default=str(ROOT))
    p.add_argument("--smoke", default=str(ROOT / "chip_smoke.py"))
    p.add_argument("--inputs", default=None)
    p.add_argument("--save", default=None)
    p.add_argument("--compare", nargs="*", default=[])
    p.add_argument("--memory", choices=("K1", "K2", "K3", "K4"), default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", args.smoke)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.envs.adroit import adroit_model
    from mjrl_tpu_torch.physics.pkernel import K1, K2, K3, K4

    kernels = {"K1": K1, "K2": K2, "K3": K3, "K4": K4}
    out = {"label": args.label}
    out.update(_first_launch_bytes(make, kernels, args.memory or "K4"))
    if args.memory is None:
        have = bool(args.inputs) and os.path.exists(args.inputs)
        rows = _rows(smoke, make, adroit_model, torch.load(args.inputs) if have else None)
        if args.inputs and not have:
            torch.save({n: {a: t.cpu() for a, t in x.items()} for n, (_, _, x) in rows.items()},
                       args.inputs)
        outputs = {}
        for name, (env, k, x) in rows.items():
            kernel = kernels[k]
            kw = {"link_delta": x["link_delta"]} if "link_delta" in x else {}
            step = lambda: kernel(env.model, x["q"], x["qd"], x["ctrl"], env.frame_skip, **kw)  # noqa: E731
            outputs[name] = tuple(t.cpu() for t in step())
            for _ in range(3):
                step()
            out[name + "_ms"] = smoke._cuda_ms(step, 20)
        K2.check()
        K4.check()
        if args.save:
            torch.save(outputs, args.save)
        for other in args.compare:
            theirs = torch.load(other)
            cmp = {}
            for name, mine in outputs.items():
                diff = [float((a.double() - b.double()).abs().nan_to_num(float("inf")).max())
                        for a, b in zip(mine, theirs[name])]
                cmp[name] = {"bit_for_bit": all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                                for a, b in zip(mine, theirs[name])),
                             "max_abs_diff_q": diff[0], "max_abs_diff_qd": diff[1]}
            out[f"against {other}"] = cmp
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

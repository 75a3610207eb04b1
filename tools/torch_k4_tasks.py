"""K4 on Adroit door, hammer and relocate with the Newton solver, on one card:
the plain version's spread behind the tolerances ``chip_smoke.py`` holds K4
to there, K4 against the plain version, and one iteration of each task
through the entry point.

    python3 tools/torch_k4_tasks.py [TASK ...] [--batch 256] [--no-entry] [--faults]
                                    [--entry-held] [--held-ab [--all-shared-csrc DIR]]

For each task (default: door hammer relocate), from ``chip_smoke.adroit_states``
at ``--batch`` envs (half from the env's reset warmed by K4, half from
``probe.kind_states``, where each contact kind touches), one control step:

- the spread: the plain version (physics/soa.py with soa_newton.py) on the
  card against the plain version on the CPU from the same inputs, per env
  max |err| of q and qd, its max and its 99% quantile, and the tolerances
  ``chip_smoke.py``'s rule would make of them (ten times the spread,
  rounded up to a power of ten, on the max and on the quantile, none
  tighter than K4's on pen; free-running, they are looser than pen's);
- K4 against the plain version on the card: the same readings, the envs
  whose line search picked other fractions, the rows held per env (mean,
  max) and the overflow count;
- with the line search's ties taken out, as ``chip_smoke.py`` holds K4 on
  these tasks: the plain version on the CPU stepping by the fractions of
  the plain version on the card (the spread) and by K4's (the check), and
  the envs where its own pick at K4's iterates differs from K4's;
- with ``--faults``, the same check of three faulty K4s (as
  tools/torch_adroit_newton_check.py plants them on pen: frictionloss's
  diagonal left out of the Newton metric, every box geom's solref 2% too
  large, every geom's torsional friction 2% too large), each against pen's
  tolerances, which each must fail;
- K4's ms (CUDA events) at ``--batch`` and twice that, the plain version's
  on the card and on the CPU, and the bound by operations
  (``chip_smoke._newton_op_count``), with the seconds each piece took.

Then (unless ``--no-entry``) one iteration each of examples/adroit_door_npg.json,
adroit_hammer_npg.json and adroit_relocate_scratch.json with
``env_kwargs.constraint_solver="newton"`` through ``run_job``
(``chip_smoke.phase_entry``: 200 K4 launches per iteration and none of
K1-K3; the iteration's ms and valid env-steps/s); with ``--entry-held``, one
more such iteration of each whose K4 launches first read the rows held at
their entry state (``probe.held_rows``: mean, max, and envs over 64). With
``--held-ab``, and nothing else unless TASKs are named, K4's two layouts of
the held rows in the Adroit class: all 96 in shared memory (3 envs a block;
the same sources with ``-DMJ_SHARED_HELD=96``, or with ``--all-shared-csrc``
the K4 of another source tree, such as the commit before the slab, whose
launch takes no slab) and the first 14 in shared memory and the rest in
the env's slab in device memory (8 envs a block at most, K1's launch rule).
On pen, relocate, door and hammer at 512 envs and relocate at 2048, from
the probe states (``chip_smoke.adroit_states``, 512 of them repeated at
2048) and the training states (``chip_smoke.pen_train_states``): each
build's q, qd, picks, overflow
count and counters (those both have) bit for bit, K4's ms a launch (CUDA
events) in turns all-shared / two-tier / two-tier / all-shared, each
build's warps a block, the rows held (mean, max) and the share of
env-substeps that hold a row in the slab. Prints the card's name and power
limit and, last, one JSON line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TASKS = ("door", "hammer", "relocate")


def up_to_power_of_ten(x: float) -> float:
    return 10.0 ** math.ceil(math.log10(x)) if x > 0 else 0.0


def per_env_errors(a, b):
    """Per env max |a - b| over the rows of ``(rows, B)`` tensors: (max,
    99% quantile) of it."""
    import torch

    e = (a.cpu().double() - b.cpu().double()).abs().amax(dim=0)
    return float(e.max()), float(torch.quantile(e, cs.HUMANOID_QUANTILE))


def faulty_k4s(model, tmp: str):
    """The three faulty K4s of tools/torch_adroit_newton_check.py, each
    ``(name, kernel, model)``; the one without frictionloss's diagonal in
    the metric is built (once) from a copy of the sources in ``tmp``."""
    import shutil
    from pathlib import Path

    import torch_adroit_newton_check as planted
    from mjrl_tpu_torch.physics import pkernel

    csrc = Path(tmp) / "csrc"
    if not csrc.exists():
        shutil.copytree(pkernel.CSRC, csrc)
        header = (csrc / planted._FRIC_HEADER).read_text()
        assert header.count(planted._FRIC_METRIC) == 1
        (csrc / planted._FRIC_HEADER).write_text(header.replace(planted._FRIC_METRIC, ""))
    no_fric = pkernel.PhysicsKernel("newton", True, csrc=csrc, build_dir=Path(tmp) / "build")
    no_fric.build(pkernel.size_class(model))
    return (("no_fric_diag_in_metric", no_fric, model),
                 ("box_solref_x1.02", pkernel.K4, planted.faulty_model(model, planted.box_solref)),
                 ("torsional_mu_x1.02", pkernel.K4,
                  planted.faulty_model(model, planted.torsional_mu)))


def replayed(kernel, kernel_model, model, q, qd, ctrl, frames, d):
    """``kernel``'s step of ``kernel_model`` and the plain version's of
    ``model`` on the CPU stepping by its line-search fractions: ``(kq,
    kqd, pq, pqd, differ)``, ``differ`` where the plain version's own pick
    at the kernel's iterate is another."""
    import torch

    from mjrl_tpu_torch.physics import soa

    n = frames * model.n_substeps * int(model.solver_iters)
    picks = torch.full((n, q.shape[1]), -1, dtype=torch.int32, device=q.device)
    kq, kqd = kernel(kernel_model, q, qd, ctrl, frames, link_delta=d, picks=picks)
    own = []
    pq, pqd = soa.multistep(model, q.cpu(), qd.cpu(), ctrl.cpu(), frames, picks=own,
                            link_delta=d.cpu(), replay=picks.cpu())
    return kq, kqd, pq, pqd, picks.cpu() != torch.cat(own)


def check_task(task: str, batch: int, faults: Optional[str] = None) -> dict:
    """The readings of one task; ``faults``: a directory for the faulty
    build, or None for no faults."""
    import torch

    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import probe, soa
    from mjrl_tpu_torch.physics.pkernel import K4, size_class

    t0 = time.perf_counter()
    env = make(f"adroit_{task}", constraint_solver="newton")
    model, frames = env.model, env.frame_skip
    n_sub, iters = frames * model.n_substeps, int(model.solver_iters)
    q, qd, d, ctrls = cs.adroit_states(env, batch, 1)
    ctrl = ctrls[0]
    rows = probe.held_rows(model, q, d)
    out = {"states_s": time.perf_counter() - t0,
           "held_rows_mean": float(rows["contacts"].float().mean()),
           "held_rows_max": int(rows["contacts"].max()),
           "kind_env_steps": {k: int((rows[k] > 0).sum()) for k in rows if k != "contacts"}}
    picks = torch.full((n_sub * iters, batch), -1, dtype=torch.int32, device=q.device)
    kq, kqd = K4(model, q, qd, ctrl, frames, link_delta=d, picks=picks)
    K4.check()  # raises on an env-substep with more rows than MAX_HELD
    plain_picks = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pq, pqd = soa.multistep(model, q, qd, ctrl, frames, picks=plain_picks, link_delta=d)
    end.record()
    torch.cuda.synchronize()
    out["plain_ms"] = start.elapsed_time(end)
    t1 = time.perf_counter()
    cq, cqd = soa.multistep(model, *(x.cpu() for x in (q, qd, ctrl)), frames, link_delta=d.cpu())
    out["plain_cpu_ms"] = (time.perf_counter() - t1) * 1e3
    flipped = (picks != torch.cat(plain_picks))
    out["line_search_flips"] = int(flipped.any(dim=0).sum())
    out["flips_in_first_iteration"] = int(flipped[::iters].any(dim=0).sum())
    for name, (a, b) in {"spread_q": (pq, cq), "spread_qd": (pqd, cqd), "k4_q": (kq, pq),
                         "k4_qd": (kqd, pqd)}.items():
        out[name], out[name + "_quantile"] = per_env_errors(a, b)
    # the line search's ties out: the plain version on the CPU stepping by
    # the card's plain version's fractions (the spread) and by K4's
    rq, rqd = soa.multistep(model, *(x.cpu() for x in (q, qd, ctrl)), frames,
                            link_delta=d.cpu(), replay=torch.cat(plain_picks).cpu())
    out["spread_replay_q"], out["spread_replay_q_quantile"] = per_env_errors(pq, rq)
    out["spread_replay_qd"], out["spread_replay_qd_quantile"] = per_env_errors(pqd, rqd)
    pen_tol, pen_quant = cs.TOL["K4 pen"], cs.TOL["K4 pen quantile"]

    def verdict(kq, kqd, pq, pqd, differ, key):
        r = {"flips_at_k4_iterates": int(differ.any(dim=0).sum()),
             "flips_at_k4_iterates_first": int(differ[::iters].any(dim=0).sum())}
        ok = True
        for name, a, b in (("q", kq, pq), ("qd", kqd, pqd)):
            r[name], r[name + "_quantile"] = per_env_errors(a, b)
            ok &= r[name] <= pen_tol[name] and r[name + "_quantile"] <= pen_quant[name]
        r["within_pen_tolerances"] = bool(ok)
        print(f"[K4 {task}] {key}, K4's fractions replayed: " + json.dumps(r), flush=True)
        return r

    out["k4_replay"] = verdict(*replayed(K4, model, model, q, qd, ctrl, frames, d), "kernel")
    K4.check()
    if faults:
        variants = faulty_k4s(model, faults)
        out["faults"] = {name: verdict(*replayed(k, m, model, q, qd, ctrl, frames, d), name)
                         for name, k, m in variants}
        for _, k, _ in variants:
            k.check()
    out["tol_by_rule"] = {
        x: max(up_to_power_of_ten(10 * out[f"spread_{x}"]), pen_tol[x]) for x in ("q", "qd")}
    out["tol_quantile_by_rule"] = {
        x: max(up_to_power_of_ten(10 * out[f"spread_{x}_quantile"]), pen_quant[x])
        for x in ("q", "qd")}
    out["tol_replay_by_rule"] = {
        x: {"max": up_to_power_of_ten(10 * out[f"spread_replay_{x}"]),
            "quantile": up_to_power_of_ten(10 * out[f"spread_replay_{x}_quantile"])}
        for x in ("q", "qd")}
    for _ in range(3):
        K4(model, q, qd, ctrl, frames, link_delta=d)
    out["ms"] = cs._cuda_ms(lambda: K4(model, q, qd, ctrl, frames, link_delta=d), 20)
    q2, qd2, d2, c2 = (x.repeat(1, 2).contiguous() for x in (q, qd, d, ctrl))
    out["ms_twice_the_batch"] = cs._cuda_ms(lambda: K4(model, q2, qd2, c2, frames, link_delta=d2),
                                            20)
    K4.check()
    out["warps_per_block"] = K4.warps_per_block(size_class(model))
    t2 = time.perf_counter()
    ops = cs._newton_op_count(model, q, qd, ctrl, out["held_rows_mean"],
                              float(rows["limits"].float().mean()), d)
    out["op_count_s"] = time.perf_counter() - t2
    out["ops_per_env_substep"] = ops
    for key, b in (("bound", batch), ("bound_twice_the_batch", 2 * batch)):
        out[key + "_ms"], out[key + "_by"] = cs._bound_ms(
            model, n_sub, ops, K4.tables(model, q.device), b, extra_rows=3 * model.nlink)
    out["seconds"] = time.perf_counter() - t0
    print(f"[K4 {task}] " + json.dumps(out))
    return out


class _Build:
    """One build of K4 in the Adroit class, ``csrc``'s sources with
    ``flags`` after the class's (``pkernel.load_library``), launched on
    this tree's K4 tables of the model (``K4.tables``) through its C
    function. It keeps a launch of its own, not K4's wrapper, for trees
    older than the slab: their Newton layout has 14 values and their
    launch takes no slab."""

    def __init__(self, label: str, csrc, build_dir, *flags):
        import ctypes

        from mjrl_tpu_torch.physics import pkernel

        K4 = pkernel.K4
        built = pkernel.load_library(K4.file, 2, {}, flags, csrc, build_dir)
        lib = built.lib
        buf = (ctypes.c_int * 64)()
        lib.mj_newton_layout.argtypes = [ctypes.c_void_p]
        n = lib.mj_newton_layout(ctypes.cast(buf, ctypes.c_void_p))
        self.label, self.lib = label, lib
        self.NL = dict(zip(pkernel.NEWTON_LAYOUT_NAMES, list(buf)[:n]))
        self.NL.setdefault("SHARED_HELD", self.NL["MAX_HELD"])
        self.takes_slab = "ROW_BYTES" in self.NL
        self.L, self.WL = built.layout, built.warp_layout
        here = K4.build(2)
        if self.L != here.layout or any(self.NL[k] != here.newton_layout[k] for k in (
                "MAX_CHAIN", "LIM_I", "LIM_F", "NPAIR_I", "NPAIR_F", "N_I_NLIM", "N_I_LIM",
                "N_I_PAIR", "N_F_LIM", "N_F_PAIR")):
            raise RuntimeError(f"{label}: its tables' layout is not this tree's K4's")
        self.most = min(self.WL["MAX_WARPS"], pkernel.SHARED_BYTES_PER_BLOCK // self.WL["BYTES"])
        lib.mj_ext_newton_launch.argtypes = pkernel.argtypes(
            [p for p in K4.params if self.takes_slab or p != "slab"])
        lib.mj_ext_newton_launch.restype = ctypes.c_int
        self._slab = None

    def warps(self, batch: int) -> int:
        """The all-shared build's launches take a full block; the two-tier
        build's K1's rule (the fewest that spread the batch over the SMs in
        one wave)."""
        import torch

        if not self.takes_slab or self.NL["SHARED_HELD"] == self.NL["MAX_HELD"]:
            return self.most
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return min(self.most, -(-batch // sms))

    def __call__(self, model, q, qd, ctrl, frames, d, count=False):
        """``(q, qd, picks, overflow, stats or None)`` of one control step."""
        import numpy as np
        import torch

        from mjrl_tpu_torch.physics import pkernel

        dev, B = q.device, q.shape[1]
        n_sub, iters = frames * model.n_substeps, int(model.solver_iters)
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        picks = torch.full((n_sub * iters, B), -1, dtype=torch.int32, device=dev)
        over = torch.zeros(1, dtype=torch.int32, device=dev)
        stats = torch.zeros(self.NL["N_STATS"], dtype=torch.int64, device=dev) if count else None
        slab = ()
        if self.takes_slab:
            need = B * (self.NL["MAX_HELD"] - self.NL["SHARED_HELD"]) * self.NL["ROW_BYTES"]
            if need and (self._slab is None or self._slab.numel() < need):
                self._slab = torch.empty(need, dtype=torch.uint8, device=dev)
            slab = (self._slab.data_ptr() if need else 0,)
        dt = float(np.float32(model.dt / model.n_substeps))
        err = self.lib.mj_ext_newton_launch(
            *(t.data_ptr() for t in pkernel.K4.tables(model, dev)), q.data_ptr(), qd.data_ptr(),
            ctrl.data_ptr(), d.data_ptr(), q_out.data_ptr(), qd_out.data_ptr(), picks.data_ptr(),
            over.data_ptr(), 0 if stats is None else stats.data_ptr(), *slab, B, n_sub, iters, dt,
            self.warps(B), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.label}: K4 launch failed: CUDA error {err}")
        return q_out, qd_out, picks, over, stats


HELD_AB_SETS = (("pen", 512), ("relocate", 512), ("door", 512), ("hammer", 512),
                ("relocate", 2048))
HELD_AB_PROBE_ENVS = 512  # wider probe sets repeat these states (kind_states runs short at 2048)


def held_ab(tmp: str, all_shared_csrc: Optional[str] = None) -> dict:
    """K4 with every held row in shared memory against the two tiers, in
    turns, on each of ``HELD_AB_SETS`` from the probe and the training
    states."""
    import torch

    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import pkernel, probe

    t0 = time.perf_counter()
    a = (_Build("all-shared", all_shared_csrc, os.path.join(tmp, "all_shared")) if all_shared_csrc
         else _Build("all-shared", pkernel.CSRC, os.path.join(tmp, "all_shared"),
                     f"-DMJ_SHARED_HELD={pkernel.HELD_CLASSES[2]}"))
    b = _Build("two-tier", pkernel.CSRC, os.path.join(tmp, "two_tier"))
    out = {"all_shared_csrc": all_shared_csrc or "this tree, -DMJ_SHARED_HELD=96",
           "shared_held": {"all_shared": a.NL["SHARED_HELD"], "two_tier": b.NL["SHARED_HELD"]},
           "bytes_per_warp": {"all_shared": a.WL["BYTES"], "two_tier": b.WL["BYTES"]},
           "build_s": time.perf_counter() - t0}
    envs = {}
    for task, batch in HELD_AB_SETS:
        env = envs.setdefault(task, make(f"adroit_{task}", constraint_solver="newton"))
        m, frames = env.model, env.frame_skip
        for label, states in (("probe", cs.adroit_states), ("train", cs.pen_train_states)):
            t1 = time.perf_counter()
            reps = batch // HELD_AB_PROBE_ENVS if label == "probe" else 1
            q, qd, d, ctrls = states(env, batch // reps, 1)
            q, qd, d, c = (x.repeat(1, reps).contiguous() for x in (q, qd, d, ctrls[0]))
            ra, rb = a(m, q, qd, c, frames, d, count=True), b(m, q, qd, c, frames, d, count=True)
            n = a.NL["N_STATS"]
            same = (all(torch.equal(x, y) for x, y in zip(ra[:4], rb[:4]))
                    and torch.equal(ra[4], rb[4][:n]))
            stats = dict(zip(pkernel.STAT_NAMES, rb[4].tolist()))
            env_substeps = batch * frames * m.n_substeps
            rows = probe.held_rows(m, q, d)["contacts"].float()
            times = []
            for build in (a, b, b, a):
                for _ in range(3):
                    build(m, q, qd, c, frames, d)
                times.append(cs._cuda_ms(lambda: build(m, q, qd, c, frames, d), 20))
            if int(ra[3]) or int(rb[3]):
                raise RuntimeError(f"{task} B={batch} {label}: held-row overflow")
            r = {"ms_all_shared_two_tier_two_tier_all_shared": times,
                 "warps_per_block": {"all_shared": a.warps(batch), "two_tier": b.warps(batch)},
                 "bit_for_bit": bool(same), "held_rows_mean": float(rows.mean()),
                 "held_rows_max": int(rows.max()),
                 "held_rows_mean_launch": stats["held_rows"] / env_substeps,
                 "held_rows_max_launch": stats["held_rows_max"],
                 "spill_share_pct": 100.0 * stats["spill_substeps"] / env_substeps,
                 "spilled_rows_per_env_substep": stats["spilled_rows"] / env_substeps,
                 "seconds": time.perf_counter() - t1}
            out[f"{task}_{batch}_{label}"] = r
            print(f"[K4 held rows A/B] {task} B={batch} {label} states: all-shared "
                  f"({r['warps_per_block']['all_shared']} warps) / two-tier "
                  f"({r['warps_per_block']['two_tier']} warps) in turns: "
                  + " / ".join(f"{x:.4f}" for x in times) + f" ms; bit for bit: {same}; "
                  f"held rows mean {r['held_rows_mean_launch']:.3f}, max "
                  f"{r['held_rows_max_launch']}; env-substeps with a row in the slab "
                  f"{r['spill_share_pct']:.3f}%", flush=True)
            if not same:
                raise RuntimeError(f"{task} B={batch} {label}: the two layouts' outputs differ")
    return out


def entry_held(tag, config, n, steps, overrides) -> dict:
    """One iteration of ``config`` through the entry point whose K4
    launches first read the rows held at their entry state."""
    import torch

    from mjrl_tpu_torch.physics import pkernel, probe

    held = []
    launch = pkernel.PhysicsKernel.__call__

    def spy(self, model, q, qd, ctrl, n_frames=1, link_delta=None, **kw):
        if self is pkernel.K4:
            held.append(probe.held_rows(model, q, link_delta)["contacts"])
        return launch(self, model, q, qd, ctrl, n_frames, link_delta=link_delta, **kw)

    pkernel.PhysicsKernel.__call__ = spy
    try:
        cs.phase_entry(tag, config, pkernel.K4, [pkernel.K1, pkernel.K2, pkernel.K3], n, steps,
                       (1,), overrides, {})
    finally:
        pkernel.PhysicsKernel.__call__ = launch
    pkernel.K4.check()
    rows = torch.stack(held).float()
    out = {"launches": len(held), "held_rows_mean": float(rows.mean()),
           "held_rows_max": int(rows.max()), "env_steps_over_64": int((rows > 64).sum())}
    print(f"[K4 entry held rows] {config}: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tasks", nargs="*", metavar="TASK", help=f"some of {TASKS} (default: all)")
    p.add_argument("--batch", type=int, default=cs.K4_TASK_ENVS)
    p.add_argument("--no-entry", action="store_true")
    p.add_argument("--held-ab", action="store_true")
    p.add_argument("--all-shared-csrc", default=None,
                   help="--held-ab's all-shared K4: this csrc directory's (default: this tree's, "
                        "every held row in shared memory)")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--entry-held", action="store_true")
    args = p.parse_args()
    args.tasks = args.tasks or ([] if args.held_ab else list(TASKS))
    if set(args.tasks) - set(TASKS):
        p.error(f"tasks must be among {TASKS}")
    import torch

    from mjrl_tpu_torch.physics.pkernel import K1, K2, K3, K4

    if not torch.cuda.is_available():
        print("torch_k4_tasks: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    K4.build(2)
    with tempfile.TemporaryDirectory() as tmp:
        result = {"card": smi, "tasks": {t: check_task(t, args.batch, tmp if args.faults else None)
                                         for t in args.tasks}}
    if not args.no_entry:
        every = {"K1": K1, "K2": K2, "K3": K3, "K4": K4}
        for tag, config, k, n, steps, niters, overrides in cs.ENTRY_PATHS:
            task = tag[len("adroit_"):-len("_newton")]
            if overrides == (cs.NEWTON,) and task in args.tasks:
                rows = {}
                t0 = time.perf_counter()
                launches = cs.phase_entry(tag, config, every[k], [v for name, v in every.items()
                                                                  if name != k],
                                          n, steps, niters, overrides, rows)
                result["tasks"][task]["entry"] = {
                    "envs": n, "steps": steps, "launches": launches,
                    "iteration_ms": rows[tag][0]["time_step"] * 1e3,
                    "valid_env_steps_per_s": rows[tag][0]["steps_per_sec"],
                    "seconds": time.perf_counter() - t0}
                if args.entry_held:
                    result["tasks"][task]["entry_held"] = entry_held(tag, config, n, steps,
                                                                     overrides)
    if args.held_ab:
        with tempfile.TemporaryDirectory() as tmp:
            result["held_ab"] = held_ab(tmp, args.all_shared_csrc)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

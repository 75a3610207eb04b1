"""Smoke test of the PyTorch port (mjrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one it
exits non-zero and prints no result. Phases, any failure exits non-zero:

1. Build: kernels K1 (mjrl_tpu_torch/csrc/mj_kernel.cu, penalty solver)
   and K2 (csrc/mj_newton_kernel.cu, Newton solver) with nvcc for sm_90a
   from the checkout's sources, the two builds side by side.
2. K1 against plain: K1 against its plain PyTorch version (physics/soa.py)
   on the card, ant (penalty, 4 substeps per frame) at B=1024 and a ragged
   B=1000, one control step (5 frames x 4 substeps) and 6 chained control
   steps from warmed states, each step held against the plain version from
   the same state; prints max |err| of q and qd against the tolerances
   below and both times (CUDA events).
3. K2 against plain: the same for K2 and the plain Newton version
   (physics/soa.py + physics/soa_newton.py) on ant with the Newton solver,
   n_substeps=1, 10 iterations (5 substeps per control step), from states
   settled on the floor, one control step and 3 chained ones at B=1024 and
   B=1000; also counts the envs whose line search picked another fraction
   than the plain version's in any iteration, and in the first (full-size)
   iteration of a substep.
4. K1 on hopper against plain (slide joints, capsule-capsule contacts
   between links): B=256 and a ragged B=250, one control step (4 frames x
   1 substep) and 6 chained ones, from states warmed by random actions and,
   in half the batch, folded so a capsule-capsule pair overlaps
   (physics/probe.py); counts the env-steps with a capsule-capsule
   candidate at depth > 0 and fails if there is none; both times at B=256.
5. K1 on walker2d and half_cheetah against plain: one control step each at
   B=1024 from states warmed by random actions.
6. The penalty slice: 3 full Ant NPG iterations at the bench's width (1024
   envs x 100 steps, episodes mode, policy (64, 64),
   MLPBaseline(epochs=2, batch_size=1024), normalized_step_size=0.05);
   every metric finite, all state on the card, exactly 100 K1 launches per
   iteration.
7. The Newton slice: 3 iterations of the bench's Newton row (newton,
   n_substeps=1, samples mode with the persistent sampler carry, 1024 envs
   x 100-step windows, the same policy, baseline and step size); every
   metric finite, all state and the carry on the card, exactly 100 K2 and
   0 K1 launches per iteration, and rows mid-episode carried into the next
   window.
8. The hopper slice through the entry point: ``run_job`` of
   mjrl_tpu_torch.train on examples/hopper_npg.json at full width (256
   envs x 1000 steps) with niter=1 and then niter=2, save_freq=1, into a
   temporary directory, the second call resuming from the first one's
   checkpoint; exactly 1000 K1 and 0 K2 launches per iteration, every
   logged value finite, the agent's state on the card, log.csv and the
   checkpoints written; prints each iteration's ms, valid and computed
   env-steps/s and score.
9. The card's name and power limit from nvidia-smi.

Each kernel's launch count in the JSON line is its count over the slice
that runs it (phase 6 for K1, phase 7 for K2; K1's ``hopper`` entry:
phase 8), reset to 0 just before. ``bound_ms`` is the least time the card
could take for one control step at the check's batch: the larger of the
bytes the kernel must move (state in and out, its tables) over 3.35 TB/s
and its f32 operations over 67 TFLOP/s, with the operations counted per
env-substep on the plain version (which does the kernel's arithmetic) and,
for K2, for the rows this run's states hold. No single PyTorch call
computes either function, so ``library_ms`` is null. The line before the
last two holds one JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Kernel vs plain on the card, max |err| of one control step from the same
# state. Both are f32 with the same formulas in another order (nvcc
# contracts to FMA). K1: the stiff penalty contacts grow that round-off
# within a control step (the plain version on the card and on the CPU
# already differ by up to 6.4e-3 in qd on warmed ants; PERF.md); the same
# tolerances hold for every model K1 runs, hopper's stiffer contacts
# between links included. K2: the soft constraints are implicit and do not
# grow it, but a converged Newton iteration's five line-search costs can
# tie to round-off, and the two then pick other fractions of a step of
# round-off size; the tolerances are those of
# tests/test_torch_newton_kernel.py's card test. The chained checks step
# the kernel and hold every step against the plain version started from
# the kernel's own state; free-running trajectories diverge from round-off
# alone, so they are not compared.
TOL = {"K1": {"q": 1e-3, "qd": 5e-2}, "K2": {"q": 1e-4, "qd": 1e-2}}
NUM_ENVS, HORIZON, ITERS = 1024, 100, 3
HOPPER_ENVS, HOPPER_HORIZON = 256, 1000  # examples/hopper_npg.json
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12  # H100 SXM data sheet
ROOT = Path(__file__).resolve().parent

_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "sin", "cos",
          "pow", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "reciprocal"}


def _cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _f32_ops_per_env_substep(model, q, qd, ctrl) -> float:
    """f32 arithmetic operations of one plain substep per env (elements
    produced by add/mul/div/sqrt/sin/... and reduced by sum), counted by
    running the plain version on the CPU under a dispatch counter."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from mjrl_tpu_torch.physics import soa

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ARITH and isinstance(out, torch.Tensor) and out.is_floating_point():
                Count.n += out.numel()
            elif name == "sum":
                Count.n += args[0].numel() - out.numel()
            return out

    q, qd, ctrl = (x.cpu() for x in (q, qd, ctrl))
    with Count():
        soa.substep(model, q, qd, ctrl, model.dt / model.n_substeps)
    return Count.n / q.shape[1]


def _bound_ms(model, n_sub: int, ops_per_env_substep: float, tables, batch: int) -> tuple:
    io = (2 * model.nq + 2 * model.nv + model.nu) * 4 * batch
    t_bytes = (io + sum(t.numel() * 4 for t in tables)) / HBM_BYTES_PER_S
    t_ops = ops_per_env_substep * n_sub * batch / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _k2_op_count(model, q, qd, ctrl, held_cand: float, held_lim: float) -> float:
    """K2's operations per env-substep for the rows this run holds: the
    plain version's count with no rows, plus the count of one held
    contact and of one held limit row, from the plain version with all
    rows (the kernel holds only the rows inside their margin)."""
    from mjrl_tpu_torch.physics.tables import num_contact_candidates

    B = 1
    q, qd, ctrl = q[:, :B], qd[:, :B], ctrl[:, :B]
    full = _f32_ops_per_env_substep(model, q, qd, ctrl)
    no_pairs = copy.copy(model)
    no_pairs.contact_pairs = ()
    no_pairs._pair_groups = None
    no_lim = copy.copy(no_pairs)
    no_lim.jnt_limited = tuple(0 for _ in model.jnt_limited)
    with_lim = _f32_ops_per_env_substep(no_pairs, q, qd, ctrl)
    base = _f32_ops_per_env_substep(no_lim, q, qd, ctrl)
    n_lim = sum(1 for v in model.jnt_limited if v > 0)
    per_lim = (with_lim - base) / n_lim
    per_cand = (full - with_lim) / num_contact_candidates(model)
    return base + held_cand * per_cand + held_lim * per_lim


def _held_rows(model, q):
    """Mean rows inside their margin per env at the states ``q`` (nq, B):
    contact candidates with depth > -margin, limit rows out of range."""
    from mjrl_tpu_torch.physics import soa, soa_newton
    from mjrl_tpu_torch.physics.model import HINGE, SLIDE

    pos, quat = soa._fk(model, q)
    cands = soa._contact_candidates(model, pos, quat)
    margins = [soa_newton.contact_params(model, c.gi, c.gj, c.mu)[2] for c in cands]
    cand = sum(float((-c.depth - m < 0).float().mean()) for c, m in zip(cands, margins))
    lim = 0.0
    for i in range(model.nlink):
        if model.link_jnt_type[i] in (HINGE, SLIDE) and model.jnt_limited[i] > 0:
            lo, hi = model.jnt_range[i]
            qi = q[model.link_qadr[i]]
            lim += float(((qi < lo) | (qi > hi)).float().mean())
    return cand, lim


def phase_kernel_vs_plain(tag, env, kernel, n_chain, batches, warm_steps=10, warm_scale=1.0,
                          fold=False, timed=True):
    """Holds ``kernel`` against the plain version over ``n_chain`` chained
    control steps at each batch size of ``batches`` (the first the full
    one), from states after ``warm_steps`` control steps of random actions
    times ``warm_scale``; with ``fold``, half the batch is replaced by
    states where a pair of links overlaps. ``timed``: both times and the
    bound at the full batch."""
    import numpy as np
    import torch

    from mjrl_tpu_torch.physics import probe, soa

    model, dev, frames = env.model, env.device, env.frame_skip
    newton = model.constraint_solver == "newton"
    tol = TOL["K2" if newton else "K1"]
    rng = np.random.default_rng(0)
    n_sub = frames * model.n_substeps
    full = batches[0]

    def rand_ctrl():
        return torch.as_tensor(rng.uniform(-1, 1, (model.nu, full)), dtype=torch.float32, device=dev)

    def in_contact(q):
        pos, quat = soa._fk(model, q)
        depth = torch.cat([c.depth for c in soa._contact_candidates(model, pos, quat)])
        return int((depth > 0).any(dim=0).sum())

    state, _ = env.reset(full, torch.Generator(device=dev).manual_seed(0))
    for _ in range(warm_steps):
        state, *_ = env.step(state, rand_ctrl().T * warm_scale)
    q0, qd0 = state.q.T.contiguous(), state.qd.T.contiguous()
    if fold:
        half = full // 2
        fq, fqd = probe.overlapping_states(model, full - half, rng)
        q0[:, half:], qd0[:, half:] = torch.as_tensor(fq, device=dev), torch.as_tensor(fqd, device=dev)
    ctrls = [rand_ctrl() for _ in range(n_chain)]
    max_err, flips, held = 0.0, 0, []
    for B in batches:
        q, qd = q0[:, :B].contiguous(), qd0[:, :B].contiguous()
        worst = {"q": 0.0, "qd": 0.0}
        contact = pair_contact = 0
        flipped = torch.zeros(B, dtype=torch.bool, device=dev)
        flipped_first = torch.zeros(B, dtype=torch.bool, device=dev)
        for step, ctrl in enumerate(ctrls):
            ctrl = ctrl[:, :B].contiguous()
            kw, plain_picks = {}, None
            if newton:
                held.append(_held_rows(model, q))
                kw["picks"] = torch.full((n_sub * model.solver_iters, B), -1, dtype=torch.int32,
                                         device=dev)
                plain_picks = []
            else:
                contact += in_contact(q)
                if fold:
                    pair_contact += int((probe.link_pair_depth(model, q) > 0).sum())
            kq, kqd = kernel(model, q, qd, ctrl, frames, **kw)
            pq, pqd = soa.multistep(model, q, qd, ctrl, frames, picks=plain_picks)
            torch.cuda.synchronize()
            if newton:
                differ = kw["picks"] != torch.cat(plain_picks)
                flipped |= differ.any(dim=0)
                flipped_first |= differ[::model.solver_iters].any(dim=0)
            for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
                if not bool(torch.isfinite(want).all()):
                    raise RuntimeError(f"{tag}: plain {name} not finite at B={B}")
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                if step == 0:
                    print(f"[{tag}] B={B} one control step {name}: max|err|={err:.3e} "
                          f"tol={tol[name]:.0e}")
            q, qd = kq, kqd
        for name in ("q", "qd"):
            ok = worst[name] <= tol[name]
            max_err = max(max_err, worst[name])
            print(f"[{tag}] B={B} {n_chain} chained control steps {name}: max per-step "
                  f"|err|={worst[name]:.3e} tol={tol[name]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{tag} disagrees with the plain version: {name} at B={B}")
        if not newton:  # Newton feet rest inside the margin: see the rows below
            print(f"[{tag}] B={B} bodies touching the floor or each other in {contact} of "
                  f"{n_chain * B} env-steps")
        if fold:
            print(f"[{tag}] B={B} a capsule-capsule candidate at depth > 0 in {pair_contact} of "
                  f"{n_chain * B} env-steps")
            if pair_contact == 0:
                raise RuntimeError(f"{tag}: no capsule-capsule contact at B={B}")
        if newton:
            cand = sum(h[0] for h in held[-n_chain:]) / n_chain
            lim = sum(h[1] for h in held[-n_chain:]) / n_chain
            print(f"[{tag}] B={B} rows inside their margin per env-step: {cand:.3f} contact "
                  f"points, {lim:.3f} limits")
            flips += int(flipped.sum())
            print(f"[{tag}] B={B} envs with another line-search fraction in some iteration: "
                  f"{int(flipped.sum())} of {B}; in a substep's first iteration: "
                  f"{int(flipped_first.sum())}")
    result = dict(max_abs_err=max_err, line_search_flips=flips)
    if not timed:
        return result
    ctrl = ctrls[0]
    for _ in range(3):
        kernel(model, q0, qd0, ctrl, frames)
    ms = _cuda_ms(lambda: kernel(model, q0, qd0, ctrl, frames), 20)
    soa.multistep(model, q0, qd0, ctrl, frames)
    plain_ms = _cuda_ms(lambda: soa.multistep(model, q0, qd0, ctrl, frames), 2)
    if newton:
        cand = sum(h[0] for h in held) / len(held)
        lim = sum(h[1] for h in held) / len(held)
        ops = _k2_op_count(model, q0, qd0, ctrl, cand, lim)
    else:
        ops = _f32_ops_per_env_substep(model, q0[:, :1], qd0[:, :1], ctrl[:, :1])
    bound_ms, bound_by = _bound_ms(model, n_sub, ops, kernel._tables(model, dev), full)
    print(f"[{tag}] B={full} one control step ({n_sub} substeps): {kernel.name} {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({ops:.0f} f32 operations per env-substep)")
    return dict(result, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _agent(env, **kw):
    import torch

    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline

    dev = env.device
    init = torch.Generator().manual_seed(0)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
    baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
    return NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=NUM_ENVS, **kw)


def phase_slice(tag, env, agent, kernel, other):
    """ITERS train steps; returns the kernel's launches over them."""
    import torch

    gen = torch.Generator(device=env.device).manual_seed(1)
    kernel.launches = other.launches = 0
    t_in_ep = None
    for it in range(ITERS):
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = agent.train_step(gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernel.launches - before
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite metrics {bad}")
        if launches != HORIZON or other.launches:
            raise RuntimeError(f"iteration {it}: {launches} {kernel.name} and {other.launches} "
                               f"{other.name} launches, expected {HORIZON} and 0")
        print(f"[{tag}] iter {it}: {dt * 1e3:.1f} ms, valid {values['num_samples'] / dt:.1f} "
              f"env-steps/s, computed {NUM_ENVS * HORIZON / dt:.1f} env-steps/s, launches "
              f"{launches}, score {values['stoc_pol_mean']:.3f}, kl {values['kl_dist']:.5f}, "
              f"alpha {values['alpha']:.4f}, VF {values['VF_error_before']:.3f}->"
              f"{values['VF_error_after']:.3f}")
        carry = agent.sampler_carry
        if carry is not None:
            # rows whose episode began inside the window are mid-episode
            # at its end and go on into the next one
            t_in_ep = carry.t_in_ep.clone()
            print(f"[{tag}] iter {it}: {int((t_in_ep > 0).sum())} of {NUM_ENVS} rows carry "
                  f"t_in_ep > 0 (max {int(t_in_ep.max())}) into the next window")
    tensors = [*agent.policy.parameters(), *agent.baseline.parameters(), env.qpos0]
    state, obs = env.reset(2, gen)
    tensors += [state.q, state.qd, obs]
    if agent.sample_mode == "samples":
        if t_in_ep is None or not bool((t_in_ep > 0).any()):
            raise RuntimeError("no row carried an episode into the next window")
        c = agent.sampler_carry
        tensors += [c.state.q, c.state.qd, c.obs, c.t_in_ep, c.ep_return]
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("state, carry or parameters off the card")
    return kernel.launches


def phase_hopper_entry(kernel, other):
    """Hopper NPG through ``mjrl_tpu_torch.train.run_job`` at full width:
    niter=1, then niter=2 resuming from the first call's checkpoint; returns
    the kernel's launches over both."""
    import torch

    from mjrl_tpu_torch.train import load_config, run_job

    config = ROOT / "examples" / "hopper_npg.json"
    kernel.launches = other.launches = 0
    per_iter = []
    with tempfile.TemporaryDirectory() as out:
        for niter in (1, 2):
            before = kernel.launches
            agent = run_job(load_config(config, [f"niter={niter}", "save_freq=1"]), out)
            per_iter.append(kernel.launches - before)
        if per_iter != [HOPPER_HORIZON] * 2 or other.launches:
            raise RuntimeError(f"{per_iter} {kernel.name} and {other.launches} {other.name} "
                               f"launches, expected {HOPPER_HORIZON} and 0 per iteration")
        with open(os.path.join(out, "logs", "log.csv"), newline="") as f:
            rows = [{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)]
        if len(rows) != 2:
            raise RuntimeError(f"log.csv has {len(rows)} rows, expected 2")
        for row, launches in zip(rows, per_iter):
            bad = [k for k, v in row.items() if not math.isfinite(v)]
            if bad:
                raise RuntimeError(f"non-finite logged values {bad}")
            dt = row["time_step"]
            print(f"[hopper] iter {int(row['iteration'])}: {dt * 1e3:.1f} ms, valid "
                  f"{row['steps_per_sec']:.1f} env-steps/s ({row['num_samples']:.0f} valid "
                  f"samples), computed {HOPPER_ENVS * HOPPER_HORIZON / dt:.1f} env-steps/s, "
                  f"launches {launches}, score {row['stoc_pol_mean']:.3f}, running score "
                  f"{row['running_score']:.3f}, kl {row['kl_dist']:.5f}, alpha {row['alpha']:.4f}, "
                  f"VF {row['VF_error_before']:.3f}->{row['VF_error_after']:.3f}")
        if sorted(os.listdir(os.path.join(out, "iterations"))) != ["1.pt", "2.pt"] or \
                not os.path.exists(os.path.join(out, "best.pt")):
            raise RuntimeError("checkpoints missing")
        state, obs = agent.env.reset(2)
        tensors = [*agent.policy.parameters(), *agent.baseline.parameters(), agent.running_score,
                   agent.env.qpos0, state.q, state.qd, obs]
        if not all(t.is_cuda for t in tensors):
            raise RuntimeError("state or parameters off the card")
    print(f"[hopper] 2 iterations through the entry point, checkpointed and resumed; "
          f"{torch.cuda.get_device_name(0)}")
    return kernel.launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.pkernel import K1, K2

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda k: k.build(), (K1, K2)))
    print(f"[1] built {K1.source} and {K2.source} in {time.perf_counter() - t0:.1f} s")

    env = make("ant", horizon=HORIZON)  # on the card by default
    newton_env = make("ant", horizon=HORIZON, constraint_solver="newton", n_substeps=1)
    hopper = make("hopper", horizon=HOPPER_HORIZON)
    walkers = [make(name, horizon=HORIZON) for name in ("walker2d", "half_cheetah")]
    if any(e.device.type != "cuda" for e in (env, newton_env, hopper, *walkers)):
        raise RuntimeError("envs must default to the card")
    ragged = (NUM_ENVS, NUM_ENVS - 24)  # the second not a multiple of the block
    k1 = phase_kernel_vs_plain("K1", env, K1, 6, ragged)
    k2 = phase_kernel_vs_plain("K2", newton_env, K2, 3, ragged, warm_steps=15, warm_scale=0.0)
    k1_hopper = phase_kernel_vs_plain("K1 hopper", hopper, K1, 6, (HOPPER_ENVS, HOPPER_ENVS - 6),
                                      fold=True)
    k1_walkers = {e.asset[:-4]: phase_kernel_vs_plain(f"K1 {e.asset[:-4]}", e, K1, 1, (NUM_ENVS,),
                                                      timed=False)
                  for e in walkers}
    k1["launches"] = phase_slice("penalty", env, _agent(env, horizon=HORIZON), K1, K2)
    newton_agent = _agent(newton_env, num_samples=NUM_ENVS * HORIZON, sample_mode="samples")
    k2["launches"] = phase_slice("newton", newton_env, newton_agent, K2, K1)
    k1_hopper["launches"] = phase_hopper_entry(K1, K2)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernels = []
    for kernel, r in ((K1, k1), (K2, k2)):
        kernels.append({
            "name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    kernels[0]["hopper"] = {k: k1_hopper[k] for k in
                            ("ms", "plain_ms", "bound_ms", "launches", "max_abs_err")}
    for name, r in k1_walkers.items():
        kernels[0][name] = {"max_abs_err": r["max_abs_err"]}
    kernels[1]["line_search_flips"] = k2["line_search_flips"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

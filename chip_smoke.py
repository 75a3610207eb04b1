"""Smoke test of the PyTorch port (mjrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; without one it
exits non-zero and prints no result. Phases, any failure exits non-zero:

1. Build: kernel K1 (mjrl_tpu_torch/csrc/mj_kernel.cu) with nvcc for
   sm_90a from the checkout's sources.
2. Kernel against plain: K1 against its plain PyTorch version
   (physics/soa.py) on the card, ant at B=1024 and a ragged B=1000, one
   control step (5 frames x 4 substeps) and 10 chained control steps from
   warmed states, each step held against the plain version from the same
   state; prints max |err| of q and qd against the tolerance below and
   both times (CUDA events).
3. The slice: 3 full Ant NPG iterations at the bench's width (1024 envs x
   100 steps, policy (64, 64), MLPBaseline(epochs=2, batch_size=1024),
   normalized_step_size=0.05); every metric finite, all state on the card,
   exactly 100 K1 launches per iteration; prints iteration times and the
   valid and computed env-steps/s.
4. The card's name and power limit from nvidia-smi.

The line before those two holds one JSON object describing each kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Kernel vs plain on the card, max |err| of one control step (20 substeps)
# from the same state. Both are f32 with the same formulas in another order
# (nvcc contracts to FMA); the stiff penalty contacts grow that round-off
# within a control step: the plain version on the card and on the CPU
# already differ by up to 6.4e-3 in qd on these warmed states (PERF.md).
# The chain check steps the kernel 10 times and holds every step against
# the plain version started from the kernel's own state; free-running
# trajectories diverge chaotically from round-off alone, so they are not
# compared.
TOL = {"q": 1e-3, "qd": 5e-2}
NUM_ENVS, HORIZON, ITERS = 1024, 100, 3


def _cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_plain(env, K1, soa):
    import numpy as np
    import torch

    model, dev, frames = env.model, env.device, env.frame_skip
    rng = np.random.default_rng(0)

    def rand_ctrl():
        return torch.as_tensor(rng.uniform(-1, 1, (model.nu, NUM_ENVS)), dtype=torch.float32, device=dev)

    def in_contact(q):
        pos, quat = soa._fk(model, q)
        depth = torch.cat([c.depth for c in soa._contact_candidates(model, pos, quat)])
        return int((depth > 0).any(dim=0).sum())

    # warm: 10 control steps of random actions, so the ants have fallen onto
    # their legs and feet touch the floor
    state, _ = env.reset(NUM_ENVS, torch.Generator(device=dev).manual_seed(0))
    for _ in range(10):
        state, *_ = env.step(state, rand_ctrl().T)
    ctrls = [rand_ctrl() for _ in range(10)]
    max_err = 0.0
    for B in (NUM_ENVS, 1000):
        q, qd = state.q[:B].T.contiguous(), state.qd[:B].T.contiguous()
        worst = {"q": 0.0, "qd": 0.0}
        contact = 0
        for step, ctrl in enumerate(ctrls):
            ctrl = ctrl[:, :B].contiguous()
            contact += in_contact(q)
            kq, kqd = K1(model, q, qd, ctrl, frames)
            pq, pqd = soa.multistep(model, q, qd, ctrl, frames)
            torch.cuda.synchronize()
            for name, got, want in (("q", kq, pq), ("qd", kqd, pqd)):
                if not bool(torch.isfinite(want).all()):
                    raise RuntimeError(f"plain {name} not finite at B={B}")
                err = float((got - want).abs().max())
                worst[name] = max(worst[name], err)
                if step == 0:
                    print(f"[2] B={B} one control step {name}: max|err|={err:.3e} tol={TOL[name]:.0e}")
            q, qd = kq, kqd
        for name in ("q", "qd"):
            ok = worst[name] <= TOL[name]
            max_err = max(max_err, worst[name])
            print(f"[2] B={B} 10 chained control steps {name}: max per-step |err|={worst[name]:.3e} "
                  f"tol={TOL[name]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"K1 disagrees with the plain version: {name} at B={B}")
        print(f"[2] B={B} feet on the floor in {contact} of {10 * B} env-steps")
    q0, qd0, ctrl = state.q.T.contiguous(), state.qd.T.contiguous(), ctrls[0]
    for _ in range(3):
        K1(model, q0, qd0, ctrl, frames)
    ms = _cuda_ms(lambda: K1(model, q0, qd0, ctrl, frames), 20)
    soa.multistep(model, q0, qd0, ctrl, frames)
    plain_ms = _cuda_ms(lambda: soa.multistep(model, q0, qd0, ctrl, frames), 2)
    print(f"[2] B={NUM_ENVS} one control step ({frames * model.n_substeps} substeps): "
          f"K1 {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return max_err, ms, plain_ms


def phase_slice(env, K1):
    import torch

    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.models import GaussianMLP, MLPBaseline

    dev = env.device
    init = torch.Generator().manual_seed(0)
    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64), generator=init).to(dev)
    baseline = MLPBaseline(env.spec, epochs=2, batch_size=1024, generator=init).to(dev)
    agent = NPG(env, policy, baseline, normalized_step_size=0.05, num_traj=NUM_ENVS, horizon=HORIZON)
    gen = torch.Generator(device=dev).manual_seed(1)
    K1.launches = 0
    launches = []
    for it in range(ITERS):
        before = K1.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = agent.train_step(gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches.append(K1.launches - before)
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"non-finite metrics {bad}")
        if launches[-1] != HORIZON:
            raise RuntimeError(f"iteration {it}: {launches[-1]} K1 launches, expected {HORIZON}")
        valid = values["num_samples"]
        print(f"[3] iter {it}: {dt * 1e3:.1f} ms, valid {valid / dt:.1f} env-steps/s, "
              f"computed {NUM_ENVS * HORIZON / dt:.1f} env-steps/s, launches {launches[-1]}, "
              f"score {values['stoc_pol_mean']:.3f}, kl {values['kl_dist']:.5f}, "
              f"alpha {values['alpha']:.4f}, VF {values['VF_error_before']:.3f}->"
              f"{values['VF_error_after']:.3f}")
    tensors = [*policy.parameters(), *baseline.parameters(), env.qpos0]
    state, obs = env.reset(2, gen)
    tensors += [state.q, state.qd, obs]
    if not all(t.is_cuda for t in tensors):
        raise RuntimeError("state or parameters off the card")
    return sum(launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics import soa
    from mjrl_tpu_torch.physics.pkernel import K1

    t0 = time.perf_counter()
    K1.build()
    print(f"[1] built {K1.source} in {time.perf_counter() - t0:.1f} s")

    env = make("ant", horizon=HORIZON, device="cuda")
    max_err, ms, plain_ms = phase_kernel_vs_plain(env, K1, soa)
    launches = phase_slice(env, K1)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": [{
        "name": K1.name, "route": "cuda", "source": K1.source, "replaces": K1.replaces,
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

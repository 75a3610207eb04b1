"""One run of one cell: set-up, the measured window, the traced extras and
the check of ``correct``, driven by data.

A cell of ``BENCHMARK.json`` names its configuration (``configs/<name>.json``:
the job's published keys, its reference env, its checker and the program
calls its phase spans wrap) and its traffic (``traffic/<name>.json``:
``num_traj``, ``horizon``, ``sample_mode``, ``constraint_solver`` and any
further ``overrides`` of the job); ``limits/<cell>.json`` holds the check's
sampling and limits, ``counts/<config>.json`` the frozen operation counts,
and each metric is read by ``metrics/<name>.py``. Adding a cell, a traffic
mix or a metric adds files and entries and edits none.

The window drives the port's own entry path: the job goes through
``mjrl_tpu_torch.train.load_config`` and ``utils.configs.build``, the
benchmark's seeded weights are loaded into the policy and baseline, and
each iteration is ``agent.train_step(generator)`` followed by the single
read-back of its metrics that ``utils/train_agent.py`` makes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from gpubench import yardstick

HERE = yardstick.HERE
ROOT = os.path.dirname(HERE)
SETUP_ITERATIONS = 3  # the first steps, which the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "mjrl_tpu")
CHECK_SEED = 0x5EED  # mixed with --seed for the check's sample of steps and rows


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def seed_state(*words: int) -> int:
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1)[0])


def iteration_generator(seed: int, i: int, device) -> torch.Generator:
    """Iteration ``i``'s generator: the same for every run of ``seed``."""
    return torch.Generator(device=device).manual_seed(seed_state(seed, i))


# -- the cell ---------------------------------------------------------------

class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench or yardstick.load(os.path.join("..", "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, self.workload = name, cells[name]
        self.config = yardstick.load(f"configs/{self.workload['config']}.json")
        self.traffic = yardstick.load(f"traffic/{self.workload['traffic']}.json")
        self.check = yardstick.load(f"limits/{name}.json")
        self.counts = yardstick.load(f"counts/{self.workload['config']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.chips = int(self.workload["chips"])

    @property
    def solver(self) -> str:
        return self.traffic["constraint_solver"]

    def overrides(self, extra: Optional[Dict[str, Any]] = None) -> List[str]:
        """The job as ``load_config`` overrides: the configuration's keys,
        then the traffic's, then ``extra`` (tests shrink a cell so)."""
        t = self.traffic
        keys = dict(self.config["job"])
        keys.update(num_traj=t["num_traj"], horizon=t["horizon"], sample_mode=t["sample_mode"])
        keys.update(t.get("overrides", {}))
        keys.update(extra or {})
        out = [f"{k}={json.dumps(v)}" for k, v in keys.items()]
        return out + [f"env_kwargs.constraint_solver={json.dumps(self.solver)}"]


# -- weights ------------------------------------------------------------------

def mlp_leaves(sizes, final_scale: float, generator: torch.Generator, device) -> List[torch.Tensor]:
    """``[w0, b0, w1, b1, ...]`` (``w`` as ``(out, in)``), uniform in
    +-1/sqrt(fan_in), the last layer scaled by ``final_scale``: one draw for
    the whole network on ``device``."""
    shapes = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        shapes += [(b, a), (b,)]
    u = torch.rand(sum(math.prod(s) for s in shapes), generator=generator, device=device)
    leaves, k = [], 0
    for j, s in enumerate(shapes):
        n = math.prod(s)
        layer = j // 2
        bound = 1.0 / math.sqrt(sizes[layer]) * (final_scale if layer == len(sizes) - 2 else 1.0)
        leaves.append(((2.0 * u[k:k + n] - 1.0) * bound).reshape(s))
        k += n
    return leaves


def make_weights(seed: int, obs_dim: int, act_dim: int, job: dict, device) -> Dict[str, Any]:
    """The run's initial policy and baseline from ``seed``, made on the
    device; handed alike to the port and to the reference."""
    g = torch.Generator(device=device).manual_seed(seed_state(seed, 1_000_001))
    hidden = tuple(job.get("hidden_sizes", (64, 64)))
    policy = mlp_leaves((obs_dim, *hidden, act_dim), 0.01, g, device)
    policy.append(torch.full((act_dim,), float(job.get("init_log_std", 0.0)), device=device))
    bkw = job.get("baseline_kwargs", {})
    bhidden = tuple(bkw.get("hidden_sizes", (128, 128)))
    baseline = mlp_leaves((2 * obs_dim + 4, *bhidden, 1), 1.0, g, device)
    return {"policy": policy, "baseline": baseline, "policy_sizes": (obs_dim, *hidden, act_dim),
            "baseline_sizes": (2 * obs_dim + 4, *bhidden, 1)}


def policy_keys(n_layers: int) -> List[str]:
    keys = []
    for i in range(n_layers):
        keys += [f"mlp.layers.{i}.weight", f"mlp.layers.{i}.bias"]
    return keys


def load_into(module: torch.nn.Module, leaves: List[torch.Tensor], with_log_std: bool) -> None:
    n_layers = (len(leaves) - with_log_std) // 2
    keys = policy_keys(n_layers) + (["log_std"] if with_log_std else [])
    state = module.state_dict()
    state.update({k: v.clone() for k, v in zip(keys, leaves)})
    module.load_state_dict(state)


def module_leaves(module: torch.nn.Module, with_log_std: bool) -> List[torch.Tensor]:
    n_layers = len(module.mlp.layers)
    state = module.state_dict()
    keys = policy_keys(n_layers) + (["log_std"] if with_log_std else [])
    return [state[k].detach().clone() for k in keys]


# -- hooks on the program's instances -------------------------------------------

@contextlib.contextmanager
def patched(obj, name: str, wrapper: Callable[[Callable], Callable]):
    """``obj.name`` replaced on the instance by ``wrapper(original)``."""
    had = name in vars(obj)
    original = getattr(obj, name)
    setattr(obj, name, wrapper(original))
    try:
        yield
    finally:
        if had:
            setattr(obj, name, original)
        else:
            delattr(obj, name)


def resolve(agent, path: str):
    """``(owner, attribute)`` of a dotted path from the agent."""
    owner = agent
    *parts, last = path.split(".")
    for p in parts:
        owner = getattr(owner, p)
    return owner, last


class StepRecorder:
    """Wraps ``env.step``: at the planned control steps of an iteration
    keeps the planned rows' input state and action and the step's output
    state, observation and reward."""

    def __init__(self, plan: Dict[int, Optional[torch.Tensor]]):
        self.plan, self.t, self.records = plan, 0, []

    def __call__(self, step):
        def recorded(st, action):
            out = step(st, action)
            rows = self.plan.get(self.t)
            if self.t in self.plan:
                pick = (lambda x: x.detach().clone()) if rows is None else (
                    lambda x: x.detach()[rows.to(x.device)].clone())
                self.records.append({
                    "t": self.t, "in": {k: pick(v) for k, v in st._asdict().items()},
                    "action": pick(action), "out": {k: pick(v) for k, v in out[0]._asdict().items()},
                    "obs": pick(out[1]), "reward": pick(out[2])})
            self.t += 1
            return out
        return recorded


class Capture:
    """What the set-up's iterations hand the check: each iteration's
    sampled control steps, raw and processed batch, the fit's generator
    state, metrics and the parameters after it."""

    def __init__(self):
        self.iterations: List[Dict[str, Any]] = []

    def hooks(self, agent, plan):
        rec = StepRecorder(plan)
        it: Dict[str, Any] = {"steps": rec.records}

        def process(orig):
            def wrapped(batch):
                out = orig(batch)
                it["batch"], it["processed"] = batch, out
                return out
            return wrapped

        def fit(orig):
            def wrapped(batch, generator=None, **kw):
                it["fit_generator_state"] = None if generator is None else generator.get_state()
                return orig(batch, generator=generator, **kw)
            return wrapped

        stack = contextlib.ExitStack()
        stack.enter_context(patched(agent.env, "step", rec))
        stack.enter_context(patched(agent, "process_batch", process))
        stack.enter_context(patched(agent.baseline, "fit", fit))
        self.iterations.append(it)
        return stack, it


def check_plan(cell: Cell, seed: int, iteration: int, num_traj: int, horizon: int):
    """The control steps (and rows: None for all) the check samples in one
    set-up iteration, drawn from the seed alone."""
    rng = np.random.default_rng([seed_state(seed, CHECK_SEED), iteration])
    spec = cell.check
    steps = rng.choice(horizon, size=min(int(spec["steps_per_iteration"]), horizon), replace=False)
    rows = spec.get("rows", "all")
    plan = {}
    for t in sorted(int(s) for s in steps):
        plan[t] = None if rows == "all" or int(rows) >= num_traj else torch.as_tensor(
            np.sort(rng.choice(num_traj, size=int(rows), replace=False)))
    return plan


# -- spans and the profiler (--trace 1) -----------------------------------------------

class Spans:
    """Phase spans around the program's calls named by the configuration's
    ``spans`` (host clock between ``torch.cuda.synchronize()`` calls, with
    a ``record_function`` range for the profiler); ``rollout`` runs from
    the iteration's start to the first of them."""

    def __init__(self, spans: Dict[str, str], sync: Callable[[], None]):
        self.spans, self.sync = spans, sync
        self.current: Dict[str, float] = {}

    def hooks(self, agent):
        stack = contextlib.ExitStack()
        for name, path in self.spans.items():
            owner, attr = resolve(agent, path)
            stack.enter_context(patched(owner, attr, self._wrap(name)))
        return stack

    def _wrap(self, name):
        def wrapper(orig):
            def wrapped(*a, **kw):
                self.sync()
                t0 = time.perf_counter()
                if "rollout" not in self.current:
                    self.current["rollout"] = (t0 - self.current["_start"]) * 1e3
                with torch.profiler.record_function(f"gpubench.{name}"):
                    out = orig(*a, **kw)
                self.sync()
                self.current[name] = self.current.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
                return out
            return wrapped
        return wrapper

    def start(self):
        self.sync()
        self.current = {"_start": time.perf_counter()}

    def finish(self) -> Dict[str, float]:
        wall = (time.perf_counter() - self.current.pop("_start")) * 1e3
        out, self.current = dict(self.current, wall=wall), {}
        return out


def _ev(e, *names):
    for n in names:
        v = getattr(e, n, None)
        if v is not None:
            return v() if callable(v) else v
    return None


def profile_summary(prof, kernel_symbol: str) -> Dict[str, Any]:
    """From one profiled iteration: the union of the device's busy
    intervals, the iteration's length, the kernel's launches and device
    time, device time by operation, and the device's idle gaps summed by
    the phase the host was in (the harness's ranges; before the first,
    ``rollout``; after the last, ``statistics``)."""
    from torch.autograd import DeviceType

    dev, ranges = [], {}
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a host range mirrored on the device's timeline is no device work
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("gpubench.")):
                dev.append((start, end, e.name))
        elif e.name.startswith("gpubench."):
            ranges.setdefault(e.name[len("gpubench."):], []).append((start, end))
    it = ranges.pop("iteration", [(0.0, 0.0)])[0]
    dev = sorted(d for d in dev if d[1] > it[0] and d[0] < it[1])
    by_op: Dict[str, float] = {}
    k_time, k_count = 0.0, 0
    merged: List[List[float]] = []
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
        if kernel_symbol and kernel_symbol in name:
            k_time, k_count = k_time + (e - s), k_count + 1
        s, e = max(s, it[0]), min(e, it[1])
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    named = [(n, a, b) for n, rs in ranges.items() for a, b in rs]
    first = min((a for _, a, _ in named), default=it[1])

    def phase(t):
        inside = [n for n, a, b in named if a <= t <= b]
        if inside:
            return inside[0]
        return "rollout" if t < first else "statistics"

    gaps: Dict[str, float] = {}
    prev = it[0]
    for s, e in merged + [[it[1], it[1]]]:
        if s > prev:
            p = phase(0.5 * (s + prev))
            gaps[p] = gaps.get(p, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(e - s for s, e in merged) * 1e-6, "window_s": (it[1] - it[0]) * 1e-6,
            "kernel_ms": (k_time / k_count * 1e-3) if k_count else None,
            "kernel_launches": k_count,
            "device_ops": [[n, t * 1e-6] for n, t in top],
            "idle_gaps": sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:10]}


def count_ops(fn) -> int:
    """The ATen ops ``fn()`` dispatches (views and in-place ops included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def host_ops_per_step(agent, generator: torch.Generator) -> float:
    """ATen ops the sampler dispatches per control step at the cell's
    batch: its count over 4 steps less its count over 2, over 2."""
    from mjrl_tpu_torch.samplers import sample_episodes

    def run(h):
        return count_ops(lambda: sample_episodes(agent.env, agent.policy, agent.num_traj, h,
                                                 generator))
    return (run(4) - run(2)) / 2.0


# -- the card -------------------------------------------------------------------------

def card_settings() -> Dict[str, str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    name, _, limit = (out[0] if out else "not read, not read").partition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def phase_mean(data: Dict[str, Any], name: str) -> Optional[float]:
    """A phase's mean span (ms) over the traced window's unprofiled
    iterations, or None without spans."""
    spans = [p[name] for p in data.get("phases") or [] if name in p]
    return sum(spans) / len(spans) if spans else None


def read_metric(name: str, data: Dict[str, Any]) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(data)``: a number, or None where it
    finds nothing to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(data)


def checker(cell: Cell):
    return importlib.import_module(f"gpubench.checkers.{cell.config['checker']}")


# -- one run --------------------------------------------------------------------------------

class Setup:
    """The program built from the cell, the benchmark's weights loaded,
    driven through its first iterations with the check's capture on."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 extra: Optional[Dict[str, Any]] = None, plant: Optional[Callable] = None):
        from mjrl_tpu_torch.physics import pkernel
        from mjrl_tpu_torch.train import load_config
        from mjrl_tpu_torch.utils.configs import build

        self.cell, self.seed, self.device = cell, seed, device
        cuda = device.type == "cuda"
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        cfg = load_config(None, cell.overrides(extra))
        self.env, self.policy, self.baseline, self.agent = build(cfg, device=device)
        env, agent = self.env, self.agent
        self.N, self.T = agent.num_traj, agent.horizon
        self.weights = make_weights(seed, env.spec.observation_dim, env.spec.action_dim,
                                    cell.config["job"], device)
        load_into(self.policy, self.weights["policy"], True)
        load_into(self.baseline, self.weights["baseline"], False)
        if plant is not None:
            plant(agent)
        path = getattr(getattr(env, "_frame_step", None), "path", None)
        kernel = {"K1": pkernel.K1, "K2": pkernel.K2, "K3": pkernel.K3, "K4": pkernel.K4}.get(path)
        self.settings = {
            "cell": cell.name, "seed": seed, "solver": env.model.constraint_solver,
            "n_substeps": env.model.n_substeps, "frame_skip": getattr(env, "frame_skip", None),
            "sample_mode": agent.sample_mode, "num_traj": self.N, "horizon": self.T,
            "kernel": path, "kernel_symbol": cell.config["kernel_symbols"].get(cell.solver),
            **(card_settings() if cuda else {"card": "cpu"})}
        self.capture = Capture()
        self.params = [(module_leaves(self.policy, True), module_leaves(self.baseline, False))]
        launches0 = kernel.launches if kernel is not None else 0
        for i in range(SETUP_ITERATIONS):
            stack, it = self.capture.hooks(agent, check_plan(cell, seed, i, self.N, self.T))
            with stack:
                metrics = agent.train_step(iteration_generator(seed, i, device))
                it["metrics"] = dict(zip(metrics, torch.stack(
                    [v.detach().float().reshape(()) for v in metrics.values()]).tolist()))
            self.params.append((module_leaves(self.policy, True),
                                module_leaves(self.baseline, False)))
        self.sync()
        self.settings["launches_per_iteration"] = (
            (kernel.launches - launches0) / SETUP_ITERATIONS if kernel is not None else 0)

    def free(self) -> None:
        """Drop the program's state, keeping what the check reads."""
        del self.env, self.policy, self.baseline, self.agent
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        return checker(self.cell).check(self.cell, self.capture, self.params, self.weights,
                                        self.device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", extra: Optional[Dict[str, Any]] = None,
        plant: Optional[Callable] = None, log=sys.stderr) -> Dict[str, Any]:
    """One run: the result's dict (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` ``breakdown``; ``check`` last).
    ``extra`` overrides job keys (the CPU tests' tiny cells); ``plant(agent)``
    breaks the program under test (the fault tests)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    su = Setup(cell, seed, dev, extra, plant)
    env, policy, baseline, agent, sync = su.env, su.policy, su.baseline, su.agent, su.sync
    N, T, settings = su.N, su.T, su.settings
    setup_s = time.perf_counter() - t_process
    found = forbidden_modules()
    if found:
        raise ImportGuardError(found)
    print("gpubench settings: " + json.dumps(settings), file=log, flush=True)

    # the window: whole iterations for `seconds`
    spans = Spans(cell.config["spans"], sync) if trace else None
    span_stack = spans.hooks(agent) if trace else contextlib.ExitStack()
    expected = float(N * T)
    keys = None
    attempted = failed = 0
    valid_steps = 0.0
    iter_s: List[float] = []
    phases: List[Dict[str, float]] = []
    prof_summary = profiled_run = None
    held_plan_records: List[dict] = []
    i = SETUP_ITERATIONS
    with span_stack:
        sync()
        t_start = time.perf_counter()
        while True:
            profiled = trace and attempted == 1
            gen = iteration_generator(seed, i, dev)
            t0 = time.perf_counter()
            if trace:
                spans.start()
            prof_ctx = contextlib.nullcontext()
            rec_ctx = contextlib.nullcontext()
            if profiled:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                prof_ctx = profile(activities=acts)
                rec = StepRecorder(check_plan(cell, seed, i, N, T))
                rec_ctx = patched(env, "step", rec)
            try:
                with prof_ctx as prof, rec_ctx:
                    with torch.profiler.record_function("gpubench.iteration"):
                        metrics = agent.train_step(gen)
                        flat = torch.cat([p.detach().reshape(-1) for p in policy.parameters()]
                                         + [p.detach().reshape(-1) for p in baseline.parameters()])
                        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()]
                                             + [torch.isfinite(flat).all().float()]).tolist()
                ok = True
            except RuntimeError as e:  # a kernel's fault flag (K4's held-row overflow)
                print(f"gpubench: iteration {i} raised: {e}", file=log, flush=True)
                values, ok = None, False
            t1 = time.perf_counter()
            attempted += 1
            i += 1
            if ok:
                keys = keys or list(metrics)
                row = dict(zip(keys, values[:-1]))
                n = row.get("num_samples", 0.0)
                valid_steps += n
                ok = values[-1] == 1.0 and all(math.isfinite(v) for v in values) and n == expected
            failed += not ok
            iter_s.append(t1 - t0)
            if trace:
                span = spans.finish()
                if profiled:  # read once the window has closed
                    profiled_run = prof
                    held_plan_records = rec.records
                else:
                    phases.append(span)
            if t1 - t_start >= seconds and (not trace or attempted >= 3):
                break
        window_s = t1 - t_start
    if profiled_run is not None:
        prof_summary = profile_summary(profiled_run, settings["kernel_symbol"])
        del profiled_run
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise ImportGuardError(found)
    print("gpubench window: " + json.dumps({"iteration_s": iter_s, "window_s": window_s,
                                            "memory_peak_bytes": memory_peak}), file=log, flush=True)

    data: Dict[str, Any] = {"cell": cell, "valid_steps": valid_steps, "window_s": window_s,
                            "setup_s": setup_s, "iteration_s": iter_s, "num_traj": N, "horizon": T,
                            "obs_dim": env.spec.observation_dim, "act_dim": env.spec.action_dim,
                            "kernel": settings["kernel"]}
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        data["phases"] = phases
        data["profile"] = prof_summary
        data["host_ops_per_step"] = host_ops_per_step(agent, iteration_generator(seed, i, dev))
        if cell.solver == "newton" and held_plan_records:
            held_model = checker(cell).reference_env(cell, dev).model
            qs = torch.cat([r["in"]["q"] for r in held_plan_records])
            deltas = torch.cat([r["in"]["link_delta"] for r in held_plan_records])
            data["held_rows"] = yardstick.held_rows(held_model, qs, deltas)
        result_device["busy_s"] = prof_summary["busy_s"] if prof_summary else 0.0
        result_device["window_s"] = prof_summary["window_s"] if prof_summary else 0.0
        if prof_summary:
            breakdown = {"device_ops": prof_summary["device_ops"],
                         "idle_gaps": prof_summary["idle_gaps"]}
    metric_list = cell.per_layer if trace else cell.end_to_end
    metrics_out = {}
    for m in metric_list:
        v = read_metric(m["name"], data)
        if v is not None:
            metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}

    # after the window: the program's state freed, then the check
    del env, policy, baseline, agent
    su.free()
    t_check = time.perf_counter()
    numbers = su.check()
    print(f"gpubench check: {time.perf_counter() - t_check!r} s", file=log)
    limits = cell.check["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k, v in compared.items():
        print(f"gpubench check {k}: {v['value']!r} limit {v['limit']!r}", file=log)
    correct = (failed == 0 and attempted > 0
               and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                       for v in compared.values()))
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics_out, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = compared
    out["_numbers"] = numbers
    return out


class ImportGuardError(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded: " + ", ".join(found))
        self.found = found

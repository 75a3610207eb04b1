"""The check of an NPG cell with an MLP baseline: what the set-up's first
iterations produced on the timed path, against the plain reference
(``reference/``), on the same inputs and the benchmark's weights.

The rollouts are chaotic through the contacts and take the plain physics
seconds a control step, so the reference follows the program's own
rollouts: it steps the sampled control steps' input states itself, and
runs returns, GAE, the NPG update and the baseline's fit on the program's
observations, actions and rewards with parameters it works out itself from
the initial weights. The numbers, each a widest gap:

- ``q_err``, ``qd_err``: the kernel's control step, by coordinate, over the
  sampled steps' rows (``qd_q99``: the 99% quantile of the velocity gaps);
- ``obs_err``, ``reward_err``: the env's observation and reward of the
  program's next state;
- ``mean_err``: the behaviour policy's mean over the whole batch;
- ``return_err`` (over the largest return), ``adv_err``: returns and
  normalized advantages;
- ``surr_err``, ``vf_err``: each step's surrogate improvement and fit
  error after, relative;
- ``policy_step_err``, ``baseline_step_err``: the worst leaf's gap between
  the norms of each step's change, over the reference's norm of that leaf
  or of the median leaf, whichever is larger; ``policy_change_err``,
  ``baseline_change_err`` the same of the change over all the steps.
  Leaves whose reference gradient at the first step is under a thousandth
  of the median leaf's are left out;
- ``policy_followed_median_leaf_err``: each later step's median leaf gap,
  where the reference's step starts from the program's own parameters
  before it (CG's f32 round-off compounds over a free-running chain, so
  step 1 is checked free-running and each later step from where the
  program stood);
  ``mean_followed_err``: the behaviour policy's mean against the
  program's own parameters before each step.
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
from typing import Any, Dict, List

import torch

from gpubench.reference.learn import Baseline, Policy, npg_update, returns_and_advantages

BATCH_FIELDS = ("observations", "actions", "rewards", "valid", "done", "terminated", "time")


def reference_env(cell, device):
    mod = importlib.import_module(f"gpubench.reference.envs.{cell.config['reference_env']}")
    return mod.ReferenceEnv(cell.solver, device=device)


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products with TF32 off (the configuration's
    precision), or on (the control's)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def program_side(capture, params) -> Dict[str, Any]:
    """The program's outputs, as the check reads them."""
    steps = [r for it in capture.iterations for r in it["steps"]]
    iters = []
    for k, it in enumerate(capture.iterations):
        iters.append({"mean": it["batch"].mean, "returns": it["processed"].returns,
                      "advantages": it["processed"].advantages,
                      "surr": it["metrics"]["surr_improvement"],
                      "vf": it["metrics"]["VF_error_after"],
                      "theta": params[k + 1][0], "phi": params[k + 1][1]})
    return {"q": torch.cat([r["out"]["q"] for r in steps]),
            "qd": torch.cat([r["out"]["qd"] for r in steps]),
            "out": {key: torch.cat([r["out"][key] for r in steps]) for key in steps[0]["out"]},
            "obs": torch.cat([r["obs"] for r in steps]),
            "reward": torch.cat([r["reward"] for r in steps]),
            "theta0": params[0][0], "phi0": params[0][1], "iterations": iters}


def reference_side(cell, capture, weights, device, tf32: bool = False,
                   judged_out: Dict[str, torch.Tensor] = None,
                   judged_thetas: List[List[torch.Tensor]] = None) -> Dict[str, Any]:
    """The reference's outputs on the captured inputs. ``judged_out``: the
    next states whose observation and reward the reference scores (the
    judged side's; its own where None). ``judged_thetas``: the judged
    side's policy before each step, from which the reference also takes
    each later step (``followed``) and the behaviour mean."""
    job = cell.config["job"]
    akw = job.get("agent_kwargs", {})
    bkw = job.get("baseline_kwargs", {})
    fim = {"iters": 10, "damping": 1e-4, **akw.get("FIM_invert_args", {})}
    with precision(tf32):
        env = reference_env(cell, device)
        steps = [r for it in capture.iterations for r in it["steps"]]
        st_in = {k: torch.cat([r["in"][k] for r in steps]).to(device) for k in steps[0]["in"]}
        action = torch.cat([r["action"] for r in steps]).to(device)
        q, qd = env.physics(st_in, action)
        own_out = dict(st_in, q=q, qd=qd)
        scored = own_out if judged_out is None else {k: v.to(device) for k, v in judged_out.items()}
        obs, reward = env.obs_reward(scored)
        policy = Policy([w.to(device) for w in weights["policy"]], job.get("min_log_std", -3.0))
        baseline = Baseline([w.to(device) for w in weights["baseline"]],
                            bkw.get("learn_rate", 1e-3), bkw.get("batch_size", 64),
                            bkw.get("epochs", 1))
        iters = []
        for it in capture.iterations:
            b = {f: getattr(it["batch"], f).to(device) for f in BATCH_FIELDS}
            with torch.no_grad():
                mean = Policy.forward(policy.leaves, b["observations"])[0]
                values = baseline.predict(b["observations"], b["time"])
            ret, adv = returns_and_advantages(b, values, job.get("gamma", 0.995),
                                              job.get("gae_lambda", 0.97))
            npg, grad = npg_update(policy, b, adv, akw.get("normalized_step_size", 0.01),
                                   cg_iters=int(fim["iters"]), damping=float(fim["damping"]))
            followed = followed_mean = None
            if judged_thetas is not None:
                start = [w.to(device) for w in judged_thetas[len(iters)]]
                with torch.no_grad():
                    followed_mean = Policy.forward(start, b["observations"])[0]
                if iters:
                    pf = Policy(start, job.get("min_log_std", -3.0))
                    npg_update(pf, b, adv, akw.get("normalized_step_size", 0.01),
                               cg_iters=int(fim["iters"]), damping=float(fim["damping"]))
                    followed = [x.detach().clone() for x in pf.leaves]
            gen = None
            if it.get("fit_generator_state") is not None:
                gen = torch.Generator(device=device)
                gen.set_state(it["fit_generator_state"])
            fit, fit_grad = baseline.fit(b, ret, gen)
            iters.append({"mean": mean, "returns": ret, "advantages": adv,
                          "surr": float(npg["surr_improvement"]), "vf": float(fit["VF_error_after"]),
                          "theta": [x.detach().clone() for x in policy.leaves],
                          "phi": [x.detach().clone() for x in baseline.leaves],
                          "grad": grad, "fit_grad": fit_grad, "followed": followed,
                          "followed_mean": followed_mean})
    return {"q": q, "qd": qd, "out": own_out, "obs": obs, "reward": reward,
            "theta0": [w.to(device) for w in weights["policy"]],
            "phi0": [w.to(device) for w in weights["baseline"]], "iterations": iters}


def kept(grads: List[torch.Tensor]) -> List[int]:
    """Leaves whose gradient norm is at least a thousandth of the median
    leaf's."""
    norms = [float(torch.linalg.vector_norm(g.float())) for g in grads]
    med = statistics.median(norms)
    return [i for i, n in enumerate(norms) if n >= 1e-3 * med]


def leaf_gaps(judged: List[torch.Tensor], ref: List[torch.Tensor], keep: List[int]) -> List[float]:
    """Each kept leaf's ``|norm(judged) - norm(ref)|`` over the larger of
    ``norm(ref)`` and the median leaf's."""
    jn = [float(torch.linalg.vector_norm(judged[i].double())) for i in keep]
    rn = [float(torch.linalg.vector_norm(ref[i].double())) for i in keep]
    med = statistics.median(rn)
    return [abs(a - b) / max(b, med, 1e-30) for a, b in zip(jn, rn)]


def leaf_gap(judged: List[torch.Tensor], ref: List[torch.Tensor], keep: List[int]) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(judged, ref, keep))


def _max(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def compare(j: Dict[str, Any], r: Dict[str, Any]) -> Dict[str, float]:
    dev = r["q"].device
    dqd = (j["qd"].to(dev) - r["qd"]).abs().flatten().float()
    out = {"q_err": _max(j["q"].to(dev) - r["q"]), "qd_err": _max(dqd),
           "qd_q99": float(torch.quantile(dqd, 0.99)) if dqd.numel() else 0.0,
           "obs_err": _max(j["obs"].to(dev) - r["obs"]),
           "reward_err": _max(j["reward"].to(dev) - r["reward"])}
    keep_p = kept(r["iterations"][0]["grad"])
    keep_b = kept(r["iterations"][0]["fit_grad"])
    worst = {k: 0.0 for k in ("mean_err", "return_err", "adv_err", "surr_err", "vf_err",
                              "policy_step_err", "baseline_step_err")}
    prev_j, prev_r = (j["theta0"], j["phi0"]), (r["theta0"], r["phi0"])
    for k, (ji, ri) in enumerate(zip(j["iterations"], r["iterations"])):
        gaps = leaf_gaps([a.to(dev) - b.to(dev) for a, b in zip(ji["theta"], prev_j[0])],
                         [a - b for a, b in zip(ri["theta"], prev_r[0])], keep_p)
        # where the policy's gap lies: by step, its worst leaf and its median leaf
        out[f"policy_step{k + 1}_err"] = max(gaps)
        out[f"policy_step{k + 1}_worst_leaf"] = float(keep_p[gaps.index(max(gaps))])
        out[f"policy_step{k + 1}_median_leaf_err"] = statistics.median(gaps)
        out[f"mean_step{k + 1}_err"] = _max(ji["mean"].to(dev) - ri["mean"])
        scale = max(_max(ri["returns"]), 1e-12)
        step = {"mean_err": _max(ji["mean"].to(dev) - ri["mean"]),
                "return_err": _max(ji["returns"].to(dev) - ri["returns"]) / scale,
                "adv_err": _max(ji["advantages"].to(dev) - ri["advantages"]),
                "surr_err": abs(ji["surr"] - ri["surr"]) / max(abs(ri["surr"]), 1e-30),
                "vf_err": abs(ji["vf"] - ri["vf"]) / max(abs(ri["vf"]), 1e-30),
                "policy_step_err": leaf_gap(
                    [a.to(dev) - b.to(dev) for a, b in zip(ji["theta"], prev_j[0])],
                    [a - b for a, b in zip(ri["theta"], prev_r[0])], keep_p),
                "baseline_step_err": leaf_gap(
                    [a.to(dev) - b.to(dev) for a, b in zip(ji["phi"], prev_j[1])],
                    [a - b for a, b in zip(ri["phi"], prev_r[1])], keep_b)}
        if ri.get("followed_mean") is not None:
            out["mean_followed_err"] = max(out.get("mean_followed_err", 0.0),
                                           _max(ji["mean"].to(dev) - ri["followed_mean"]))
        if ri.get("followed") is not None:
            fgaps = leaf_gaps([a.to(dev) - b.to(dev) for a, b in zip(ji["theta"], prev_j[0])],
                              [a - b.to(dev) for a, b in zip(ri["followed"], prev_j[0])], keep_p)
            out["policy_followed_median_leaf_err"] = max(
                out.get("policy_followed_median_leaf_err", 0.0), statistics.median(fgaps))
        worst = {k: max(worst[k], v) for k, v in step.items()}
        prev_j, prev_r = (ji["theta"], ji["phi"]), (ri["theta"], ri["phi"])
    last_j, last_r = j["iterations"][-1], r["iterations"][-1]
    out.update(worst)
    out["policy_change_err"] = leaf_gap(
        [a.to(dev) - b.to(dev) for a, b in zip(last_j["theta"], j["theta0"])],
        [a - b for a, b in zip(last_r["theta"], r["theta0"])], keep_p)
    out["baseline_change_err"] = leaf_gap(
        [a.to(dev) - b.to(dev) for a, b in zip(last_j["phi"], j["phi0"])],
        [a - b for a, b in zip(last_r["phi"], r["phi0"])], keep_b)
    return out


def check(cell, capture, params, weights, device) -> Dict[str, float]:
    """The numbers of the program against the reference."""
    judged = program_side(capture, params)
    ref = reference_side(cell, capture, weights, device, judged_out=judged["out"],
                         judged_thetas=[p[0] for p in params[:-1]])
    return compare(judged, ref)


def control(cell, capture, weights, device) -> Dict[str, float]:
    """The numbers of the control: the reference in the program's place,
    its matrix products in TF32, against the reference."""
    judged = reference_side(cell, capture, weights, device, tf32=True)
    thetas = [judged["theta0"]] + [it["theta"] for it in judged["iterations"][:-1]]
    ref = reference_side(cell, capture, weights, device, judged_out=judged["out"],
                         judged_thetas=thetas)
    return compare(judged, ref)

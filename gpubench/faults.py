"""Faults planted in the program under test, for the fault tests and the
readings that set the check's upper ends: each ``plant(agent)`` breaks
the timed path underneath a run, on the instance only."""

from __future__ import annotations

import dataclasses

import torch


def _half(batch):
    """The batch's first half of the env rows: the rest left out."""
    n = batch.num_envs // 2
    cut = {f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)
           if isinstance(getattr(batch, f.name), torch.Tensor)}
    return dataclasses.replace(batch, env_info={k: v[:n] for k, v in batch.env_info.items()},
                               **cut)


def half_batch(agent) -> None:
    """The policy update and the baseline's fit see half of the batch, the
    means taken over the rest."""
    update, fit = agent.update, agent.baseline.fit
    agent.update = lambda batch, *a, **kw: update(_half(batch), *a, **kw)
    agent.baseline.fit = lambda batch, *a, **kw: fit(_half(batch), *a, **kw)


def unchanged(agent) -> None:
    """The policy update and the fit return their metrics and leave the
    parameters as they were."""
    update, fit = agent.update, agent.baseline.fit

    def keep(module, fn):
        def wrapped(*a, **kw):
            saved = {k: v.detach().clone() for k, v in module.state_dict().items()}
            out = fn(*a, **kw)
            module.load_state_dict(saved)
            return out
        return wrapped

    agent.update = keep(agent.policy, update)
    agent.baseline.fit = keep(agent.baseline, fit)


def frozen_after_first(agent) -> None:
    """The first policy update moves the policy; every later one returns
    its metrics and leaves the policy as it was (the fit goes on)."""
    update, calls = agent.update, []

    def wrapped(*a, **kw):
        saved = {k: v.detach().clone() for k, v in agent.policy.state_dict().items()}
        out = update(*a, **kw)
        if calls:
            agent.policy.load_state_dict(saved)
        calls.append(1)
        return out

    agent.update = wrapped


def answer_swapped(agent) -> None:
    """The physics hands env 0 the answer of env 1 and env 1 that of env
    0, at every control step."""
    env = agent.env
    step = env._frame_step

    def swapped(q, qd, ctrl, *delta):
        q2, qd2 = step(q, qd, ctrl, *delta)
        order = torch.arange(q2.shape[0], device=q2.device)
        order[:2] = torch.tensor([1, 0], device=q2.device)
        return q2[order], qd2[order]

    swapped.path, swapped.check = step.path, step.check
    env._frame_step = swapped


FAULTS = {"half_batch": half_batch, "unchanged": unchanged, "frozen_after_first": frozen_after_first,
          "answer_swapped": answer_swapped}

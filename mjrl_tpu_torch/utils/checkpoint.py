"""Checkpoint and resume of the full train state with ``torch.save``.

Twin of ``mjrl_tpu/utils/checkpoint.py``, with a ``.pt`` file per saved
step in place of orbax: ``iterations/<step>.pt`` every ``save_freq``
iterations (the newest ``MAX_TO_KEEP`` stay) and ``best.pt`` for the best
policy so far. The state is the agent's ``state_dict()``: policy, baseline
and its Adam state, iteration, running score and the sampler carry. Each
file is written to a temporary name and renamed, so a crash leaves the
last complete checkpoint in place.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

MAX_TO_KEEP = 5


class CheckpointManager:
    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        self._iters = os.path.join(self._dir, "iterations")
        os.makedirs(self._iters, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._iters, f"{step}.pt")

    def _steps(self):
        return sorted(int(n[:-3]) for n in os.listdir(self._iters)
                      if n.endswith(".pt") and n[:-3].isdigit())

    def save(self, step: int, state: Any) -> None:
        _atomic_save(state, self._path(step))
        for old in self._steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))

    def save_best(self, state: Any) -> None:
        """The reference's ``best_policy.pickle`` equivalent."""
        _atomic_save(state, os.path.join(self._dir, "best.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, map_location=None) -> Any:
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def restore_latest(self, map_location=None) -> Optional[Any]:
        step = self.latest_step()
        return None if step is None else self.restore(step, map_location)

    def restore_best(self, map_location=None) -> Any:
        return torch.load(os.path.join(self._dir, "best.pt"), map_location=map_location,
                          weights_only=True)


def _atomic_save(state: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)

"""Training-curve plots: ``make_train_plots`` (twin of
``mjrl_tpu/utils/plots.py``).

Renders ``train_curves.png`` from logged keys with matplotlib's Agg
backend, one panel per key against the iteration. A CPU-side helper: it
imports matplotlib inside the function, and the training loop does not
call it (the card's machine has no matplotlib); point it at a run's
``logs/log.csv`` afterwards.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from mjrl_tpu_torch.utils.logger import DataLog


def make_train_plots(log: Optional[DataLog] = None, log_path: Optional[str] = None,
                     keys: Sequence[str] = ("stoc_pol_mean",), save_loc: str = ".") -> None:
    """Plot ``keys`` of ``log`` (or of the ``log.csv`` at ``log_path``) into
    ``save_loc/train_curves.png``; keys the log lacks are skipped, and
    nothing is written if none is left."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if log is None:
        if log_path is None:
            raise ValueError("make_train_plots needs log or log_path")
        log = DataLog()
        log.read_log(log_path)
    data = log.log
    keys = [k for k in keys if data.get(k)]
    if not keys:
        return
    ncols = min(2, len(keys))
    nrows = -(-len(keys) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 3.5 * nrows), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        ax.plot(range(len(data[k])), data[k])
        ax.set_xlabel("iteration")
        ax.set_title(k)
        ax.grid(True, alpha=0.3)
    for j in range(len(keys), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    os.makedirs(save_loc, exist_ok=True)
    fig.savefig(os.path.join(save_loc, "train_curves.png"), dpi=100)
    plt.close(fig)

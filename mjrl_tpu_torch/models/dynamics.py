"""Learned-dynamics ensemble of model-based NPG.

Twin of ``mjrl_tpu/models/dynamics.py`` (``transition_pairs``,
``DynamicsEnsemble``). The K members are one set of stacked parameters,
``(K, in, out)`` weights and ``(K, out)`` biases with ReLU hidden layers,
so every product runs all members in one batched matmul (``baddbmm``): the
counterpart of the reference's ``jax.vmap`` over members. Members differ by
init and by their own minibatch shuffles. The model predicts the
normalized delta ``s' - s``; the input and target normalizers are the
masked moments of each fit's batch, ``+1e-3`` on ``in_scale`` and ``+1e-6``
on ``delta_scale``, kept as buffers. One Adam over the stacked tensors is K
separate Adams (Adam works element by element; all members step together,
so the one step count is each member's). Under data parallelism
(``parallel/dist.py``) each rank holds its own rows' pairs: the normalizers
are the moments over every rank's pairs, and each Adam step takes from the
members' global minibatches the pairs in this rank's block, over the
minibatch's weight on every rank, and sums the gradient over the ranks (as
the MLP baseline's fit does).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mjrl_tpu_torch.parallel import dist
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch


def transition_pairs(batch: TrajectoryBatch):
    """``(obs, act, next_obs, weight)`` of every ``(t, t + 1)`` in the batch,
    flattened to ``N * (T - 1)`` rows; the weight is 1 where both steps are
    valid and ``t`` is not an episode's last step, else 0."""
    obs = batch.observations[:, :-1]
    act = batch.actions[:, :-1]
    nxt = batch.observations[:, 1:]
    ok = batch.valid[:, :-1] & batch.valid[:, 1:] & ~batch.done[:, :-1]
    do, da = obs.shape[-1], act.shape[-1]
    return (obs.reshape(-1, do), act.reshape(-1, da), nxt.reshape(-1, do),
            ok.reshape(-1).to(obs.dtype))


class DynamicsEnsemble(nn.Module):
    """K-member MLP ensemble predicting normalized next-state deltas
    (reference defaults: K 4, hidden (256, 256), lr 1e-3, minibatch 256, 10
    epochs per fit). Parameters ``weights[i]`` ``(K, in, out)`` (the JAX
    layer's ``w`` orientation) and ``biases[i]`` ``(K, out)``, uniform
    ``+-1/sqrt(fan_in)`` at init with the last layer scaled by 0.01."""

    def __init__(self, spec: EnvSpec, ensemble_size: int = 4,
                 hidden_sizes: Sequence[int] = (256, 256), learn_rate: float = 1e-3,
                 batch_size: int = 256, fit_epochs: int = 10,
                 generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        self.spec = spec
        self.K = int(ensemble_size)
        self.hidden_sizes = tuple(hidden_sizes)
        self.batch_size = int(batch_size)
        self.fit_epochs = int(fit_epochs)
        do, da = spec.observation_dim, spec.action_dim
        sizes = (do + da, *self.hidden_sizes, do)
        self.weights, self.biases = nn.ParameterList(), nn.ParameterList()
        for i in range(len(sizes) - 1):
            bound = 1.0 / float(sizes[i]) ** 0.5
            scale = 0.01 if i == len(sizes) - 2 else 1.0  # the last layer's, as the policy's
            for shape, params in (((self.K, sizes[i], sizes[i + 1]), self.weights),
                                  ((self.K, sizes[i + 1]), self.biases)):
                u = torch.rand(shape, generator=generator)
                params.append(nn.Parameter((2.0 * u - 1.0) * bound * scale))
        self.register_buffer("in_shift", torch.zeros(do + da))
        self.register_buffer("in_scale", torch.ones(do + da))
        self.register_buffer("delta_shift", torch.zeros(do))
        self.register_buffer("delta_scale", torch.ones(do))
        self.to(device)
        self.optimizer = torch.optim.Adam(self.parameters(), lr=learn_rate)

    # -- prediction ----------------------------------------------------------
    def net(self, x: torch.Tensor) -> torch.Tensor:
        """Every member on its own rows: ``x`` ``(K, B, in)`` normalized
        inputs -> ``(K, B, do)`` normalized deltas."""
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = torch.baddbmm(b[:, None, :], x, w)
            if i < last:
                x = torch.relu(x)
        return x

    def _inputs(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs, act], dim=-1)
        return (x - self.in_shift) / (self.in_scale + 1e-8)

    @torch.no_grad()
    def predict_all(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """``(K, B, do)``: every member's next-obs prediction for ``(B, ...)``
        rows (one batched product per layer; no gradient)."""
        x = self._inputs(obs, act)
        d = self.net(x.expand(self.K, *x.shape))
        return obs + d * self.delta_scale + self.delta_shift

    def predict(self, obs: torch.Tensor, act: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
        """``(B, do)``: each row's next obs by its own member ``member[b]``
        (int ``(B,)``). All K members run on the batch and each row keeps its
        member's: K times the products of one member, with no per-row
        weight gather."""
        every = self.predict_all(obs, act)
        return every[member, torch.arange(obs.shape[0], device=obs.device)]

    # -- fitting -------------------------------------------------------------
    def fit_perms(self, m: int, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(epochs, K, num_mb, mb)``: each member's own permutation of the
        ``m`` pairs (every rank's) per epoch, cut to whole minibatches."""
        mb = min(self.batch_size, m)
        num_mb = max(m // mb, 1)
        u = torch.rand(self.fit_epochs, self.K, m, generator=generator,
                       device=self.in_shift.device)
        return u.argsort(dim=-1)[..., : num_mb * mb].reshape(self.fit_epochs, self.K, num_mb, mb)

    def _member_errors(self, xn, yn, w, den) -> torch.Tensor:
        """``(K,)`` masked normalized squared errors of each member over the
        rows of ``(K, B, ...)`` inputs, targets and weights, summed, over
        ``den`` ``(K,)``."""
        pred = self.net(xn)
        return torch.sum(w[..., None] * torch.square(pred - yn), dim=(1, 2)) / den

    def fit(self, batch: TrajectoryBatch, generator: Optional[torch.Generator] = None,
            perms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Refresh the normalizers from ``batch``'s pairs and run
        ``fit_epochs`` epochs of minibatch Adam on every member at once (the
        trailing partial minibatch dropped); ``perms`` ``(epochs, K, num_mb,
        mb)`` fixes the order (else drawn from ``generator``). Returns
        ``dyn_error`` (mean over members of the masked normalized MSE over
        all pairs after the fit), ``dyn_error_max`` and ``dyn_num_pairs``,
        all over every rank's pairs."""
        obs, act, nxt, w = transition_pairs(batch)
        x = torch.cat([obs, act], dim=-1)
        delta = nxt - obs
        do = delta.shape[-1]
        with torch.no_grad():
            wc = w[:, None]
            sums = dist.all_sum_dict({"n": w.sum(), "x": torch.sum(x * wc, 0),
                                      "delta": torch.sum(delta * wc, 0)})
            n = torch.clamp(sums["n"], min=1.0)
            in_shift, d_shift = sums["x"] / n, sums["delta"] / n
            sq = dist.all_sum_dict({"x": torch.sum(torch.square(x - in_shift) * wc, 0),
                                    "delta": torch.sum(torch.square(delta - d_shift) * wc, 0)})
            in_scale = torch.sqrt(sq["x"] / n) + 1e-3
            d_scale = torch.sqrt(sq["delta"] / n) + 1e-6
            for name, value in (("in_shift", in_shift), ("in_scale", in_scale),
                                ("delta_shift", d_shift), ("delta_scale", d_scale)):
                getattr(self, name).copy_(value)
            xn = (x - in_shift) / (in_scale + 1e-8)
            yn = (delta - d_shift) / d_scale
        offset, m = dist.block(xn.shape[0], xn.device)
        if perms is None:
            perms = self.fit_perms(m, generator)
        for epoch in perms:
            epoch, weights = dist.local_index(epoch, offset, xn.shape[0], w)
            dens = torch.clamp(dist.all_sum(weights.sum(dim=-1)) * do, min=1.0)  # (K, num_mb)
            for j in range(epoch.shape[1]):
                idx = epoch[:, j]  # (K, mb), a row of pairs per member
                loss = self._member_errors(xn[idx], yn[idx], weights[:, j], dens[:, j]).sum()
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                dist.all_sum_grads(self.parameters())
                self.optimizer.step()
        with torch.no_grad():
            num = self._member_errors(xn.expand(self.K, *xn.shape), yn.expand(self.K, *yn.shape),
                                      w.expand(self.K, *w.shape), 1.0)
            errs = dist.all_sum(num) / torch.clamp(sums["n"] * do, min=1.0)
        return {"dyn_error": errs.mean(), "dyn_error_max": errs.max(), "dyn_num_pairs": n}

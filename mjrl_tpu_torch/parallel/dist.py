"""Env-axis data parallelism over ``torch.distributed`` (twin of
``mjrl_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a 1-D mesh whose ``"env"`` axis
shards the env batch, and XLA turns every masked mean over that axis into an
all-reduce. Here a run of ``mesh_devices: D`` is D processes (ranks) in one
``torch.distributed`` group: rank r holds a contiguous block of the env rows
(:func:`row_block`: ranks below ``N % D`` take one row more) and steps them
with its own kernel launches on its own device; parameters, optimizer state,
CG and the line search are replicated; every reduction over rows is one of
the collectives below.

The only collective is ``all_reduce`` (SUM, MAX, MIN): gloo serves it on
CUDA tensors as NCCL does, and not ``all_gather``, so rows meet by an
all-reduce of a zero-filled buffer in which each rank writes its own block
(:func:`gather_rows`).

The group is ``torch.distributed``'s default one. With none, every helper is
the identity, so a single-rank run is the same code and the same bits.

Batch invariance: every rank draws the whole batch's noise from the
iteration's generator and keeps its own rows (:func:`local_rows`), so the
generators stay in step across ranks and rank r's rows are those of the
single-rank run.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# a rank that waits longer than this in a collective raises
TIMEOUT = datetime.timedelta(minutes=10)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes and prints."""
    return rank() == 0


def row_block(n: int, r: Optional[int] = None, world: Optional[int] = None) -> Tuple[int, int]:
    """``[start, stop)`` of rank ``r``'s rows among ``n``: ``ceil(n / D)``
    rows on the first ``n % D`` ranks, ``floor(n / D)`` on the others."""
    r = rank() if r is None else r
    world = world_size() if world is None else world
    base, extra = divmod(n, world)
    start = r * base + min(r, extra)
    return start, start + base + (r < extra)


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x``'s rows along ``dim`` (``x`` holds all)."""
    if world_size() == 1:
        return x
    start, stop = row_block(x.shape[dim])
    return x.narrow(dim, start, stop - start)


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    if world_size() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=op)
    return y


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; ``x`` itself alone)."""
    return _reduce(x, dist.ReduceOp.SUM)


def all_max(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX)


def all_min(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MIN)


def all_sum_dict(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each tensor summed over the ranks, in one all-reduce of their
    concatenation."""
    if world_size() == 1:
        return tensors
    names = list(tensors)
    flat = all_sum(torch.cat([tensors[k].reshape(-1) for k in names]))
    parts = torch.split(flat, [tensors[k].numel() for k in names])
    return {k: p.reshape(tensors[k].shape) for k, p in zip(names, parts)}


def all_sum_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in place, in one
    all-reduce (a parameter without a gradient counts as zeros)."""
    if world_size() == 1:
        return
    params = list(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    summed = all_sum(torch.cat([g.reshape(-1) for g in grads]))
    for p, part in zip(params, torch.split(summed, [p.numel() for p in params])):
        p.grad = part.reshape(p.shape)


def block(n_local: int, device) -> Tuple[int, int]:
    """``(offset, total)``: where this rank's ``n_local`` rows start among
    all ranks' rows, and how many there are (one small all-reduce)."""
    if world_size() == 1:
        return 0, n_local
    counts = torch.zeros(world_size(), dtype=torch.int64, device=device)
    counts[rank()] = n_local
    counts = all_sum(counts).tolist()
    return sum(counts[: rank()]), sum(counts)


def local_index(idx: torch.Tensor, offset: int, n_local: int, weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local, w)`` for indices ``idx`` into every rank's rows, this
    rank's holding ``[offset, offset + n_local)``: the indices into this
    rank's rows (0 where another rank holds the row) and ``weights`` at
    them (0 there), shapes kept, so a minibatch drawn for all ranks is
    each rank's part of it without a sync."""
    if world_size() == 1:
        return idx, weights[idx]
    local = idx - offset
    inside = (local >= 0) & (local < n_local)
    local = torch.where(inside, local, torch.zeros_like(local))
    return local, weights[local] * inside.to(weights.dtype)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0), in rank order, on every rank:
    an all-reduce of a zero-filled buffer in which each rank writes its
    own block (bool and integer tensors go through their own dtype)."""
    if world_size() == 1:
        return x
    offset, total = block(x.shape[0], x.device)
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((total, *x.shape[1:]), dtype=dtype, device=x.device)
    buf[offset: offset + x.shape[0]] = x.to(dtype)
    return all_sum(buf).to(x.dtype)


def _checksum(x: torch.Tensor) -> torch.Tensor:
    """An int64 sum of the bits of ``x``, each weighted by its position,
    so that any changed bit or swapped pair of entries moves it."""
    x = x.detach().reshape(-1)
    if x.is_floating_point():
        x = x.float().view(torch.int32)
    x = x.to(torch.int64)
    pos = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 1_000_003 + 1
    return (x * pos).sum()


def check_replicated(tensors: Dict[str, torch.Tensor]) -> None:
    """Raise unless every rank holds the same bits in each tensor: an
    all-reduce MAX and MIN of a per-tensor checksum, whose difference must
    be exactly 0."""
    if world_size() == 1 or not tensors:
        return
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    sums = torch.stack([_checksum(t).to(dev) for t in tensors.values()])
    spread = (all_max(sums) - all_min(sums)).tolist()
    apart = [name for name, d in zip(tensors, spread) if d != 0]
    if apart:
        raise RuntimeError(f"rank {rank()}: replicated tensors differ across the "
                           f"{world_size()} ranks: {apart}")


# -- the group -----------------------------------------------------------------
def rank_device(device: torch.device, r: int) -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % device_count)``, or the CPU."""
    if device.type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return torch.device("cuda", r % torch.cuda.device_count())


def choose_backend(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own (the ranks on this host,
    ``LOCAL_WORLD_SIZE`` under torchrun, at most its cards), gloo when
    ranks share a card or run on the CPU (NCCL refuses two ranks on one
    card)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_group(r: int, world: int, device: torch.device, init_method: str) -> str:
    """Join the group of ``world`` ranks as rank ``r`` through
    ``init_method`` (``file://...`` or ``env://``); returns the backend.
    A rank that cannot join raises; so does a collective that waits longer
    than :data:`TIMEOUT`."""
    backend = choose_backend(device, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=r, world_size=world,
                            timeout=TIMEOUT)
    if r == 0:
        print(f"data parallel: {world} ranks on {device.type}, backend {backend}", flush=True)
    return backend


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(r: int, world: int, init_method: str, device_type: str,
               fn: Callable, args: tuple) -> None:
    device = rank_device(torch.device(device_type), r)
    if device.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_group(r, world, device, init_method)
    try:
        fn(device, *args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, device, args: tuple = ()) -> None:
    """Run ``fn(device, *args)`` in ``world`` new processes (the ``spawn``
    start method: CUDA cannot be forked once initialised), rank r on
    :func:`rank_device`, all joined in one group that meets through a file
    in a fresh temporary directory (so that parallel runs never meet).
    ``fn`` must be importable by name. Returns when every rank has finished;
    if one raises, the others are stopped and this raises an error that
    names the rank."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(world, init_method, torch.device(device).type, fn,
                                             args),
                           nprocs=world, join=True, start_method="spawn")

"""Data-parallel training on ``torch.distributed``.

Port of ``iv_slam_tpu/parallel/mesh.py``. The reference's distributed
machinery is nn.DataParallel with a vendored synchronized BatchNorm
(train_modular.py:305-315, lib/nn/modules/). The JAX package maps it onto a
('dp', 'mp') mesh: the batch sharded over dp, wide conv kernels over mp,
BatchNorm on global-batch statistics. Here the processes are the ranks of
one process group (``DataParallel``): rank r trains rows
[r B / n, (r + 1) B / n) of each batch, the gradients are summed over the
ranks (each rank's loss is its share of the whole batch's,
``train_state.train_step``), and the BatchNorms average their statistics
over the group (``models.set_process_group``).

dp is the world size and no kernel is sharded: the JAX package's mp axis
places wide kernels across chips, a memory placement that does not change
the result, and one H100 holds any zoo model whole.

Backend: NCCL when every rank has a card of its own, gloo otherwise (CPU
ranks, or several ranks on one card, which NCCL refuses).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the data-parallel group (the default
    process group)."""

    rank: int
    world: int

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n rows (the JAX package's dp
        sharding of the batch axis)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def items(self, n: int) -> range:
        """This rank's contiguous share of n items, the last ranks taking
        fewer when n does not divide."""
        per = -(-n // self.world)
        return range(min(self.rank * per, n), min((self.rank + 1) * per, n))


def backend_for(device: torch.device, world: int) -> str:
    """"nccl" when each of the `world` ranks has a card of its own, else
    "gloo"."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_data_parallel(rank: int, world: int, port: int,
                       device: torch.device) -> DataParallel:
    """Join the group of `world` ranks at tcp://localhost:`port`, over
    ``backend_for(device, world)``."""
    backend = backend_for(device, world)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return DataParallel(rank, world)


def rank_device(rank: int, world: int, device: str) -> torch.device:
    """The device of `rank`: its own card when there is one a rank, else the
    named device ("cuda" means card 0 for every rank)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return torch.device("cuda", rank)
    return dev


def all_reduce_sum(t: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """`t` summed over the ranks (in place)."""
    dist.all_reduce(t)
    return t


def all_reduce_grads(model: nn.Module, dp: DataParallel) -> None:
    """Sum every parameter's gradient over the ranks, as one flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def spawn(fn, world: int, *args) -> None:
    """Run fn(rank, world, port, *args) in `world` fresh processes (the
    spawn start method) and wait for all; raises when one fails."""
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, free_port()) + tuple(args), nprocs=world, join=True)

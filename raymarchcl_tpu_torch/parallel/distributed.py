"""Multi-process rendering: process-group set-up and the collectives of
parallel/tiling.py over torch.distributed.

Counterpart of `raymarchcl_tpu/parallel/distributed.py`. The reference is
strictly single-device (core.clj:121-123); this module is the scale-out
entry above `parallel/tiling.py` for one process per card, on one host or
many: call `initialize()` before building a mesh, and `tiling.make_mesh()`
then spans the ranks, each rank rendering its own tile on its own card,
the finished tiles gathered so that every rank holds the whole image.

The configuration comes from the arguments or from torchrun's variables
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card),
the counterpart of JAX_COORDINATOR_ADDRESS and its kin. Single-process
callers can skip this module: nothing here is needed for one process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .. import runtime

_initialized = False


def _setting(given, env_name):
    if given is not None:
        return int(given)
    if env_name not in os.environ:
        raise ValueError(f"{env_name} is not set: pass it to initialize() or set it")
    return int(os.environ[env_name])


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None) -> bool:
    """Join the process group (torch.distributed.init_process_group); True
    only on the call that initialises it.

    A no-op returning False when a group is already up or when nothing is
    configured: no coordinator_address ("host:port" or a tcp:// URL) and no
    MASTER_ADDR in the environment, so library callers can invoke it
    unconditionally. backend defaults to "nccl" with a CUDA card and
    "gloo" without one; an init that fails raises, and no other backend is
    tried."""
    global _initialized
    if _initialized or is_initialized():
        return False
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = _setting(num_processes, "WORLD_SIZE")
    rank = _setting(process_id, "RANK")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    _initialized = True
    if backend == "nccl":  # NCCL's collectives run on the current card: make it this rank's
        torch.cuda.set_device(local_device())
    return True


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def _local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def process_info() -> tuple:
    """(rank, world size, local device count): (0, 1, count) outside a
    group. The local devices are the CUDA cards, or the one CPU."""
    if not is_initialized():
        return 0, 1, _local_device_count()
    return dist.get_rank(), dist.get_world_size(), _local_device_count()


def local_device() -> torch.device:
    """This process's card: LOCAL_RANK's (torchrun), else the rank's modulo
    the cards of the host. Raises without a CUDA card."""
    cards = runtime.devices()
    rank = int(os.environ.get("LOCAL_RANK", process_info()[0]))
    return cards[rank % len(cards)]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: NCCL takes CUDA tensors; gloo's
    collectives take CUDA tensors in some torch builds only, so under gloo
    a CUDA tensor goes through host memory."""
    return t if dist.get_backend() == "nccl" else t.cpu()


def all_gather_rows(tile: torch.Tensor) -> torch.Tensor:
    """Every rank's tile (one shape on all ranks), concatenated in rank
    order along dim 0, on `tile`'s device."""
    x = _wire(tile.contiguous())
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts).to(tile.device)


def all_reduce_sum(buf: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `buf`, written into `buf`; returns it."""
    x = _wire(buf)
    dist.all_reduce(x)
    if x is not buf:
        buf.copy_(x)
    return buf

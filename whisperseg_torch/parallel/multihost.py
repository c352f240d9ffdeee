"""Joining a process group across hosts (the port of
``whisperseg_tpu/parallel/multihost.py``).

One process drives one device. After :func:`initialize` the default
process group spans every rank of every host, and the mesh and training
code (parallel/mesh.py, training/trainer.py) run unchanged: rank r drives
``mesh.devices.flat[r]``. ``torchrun`` sets the variables this reads.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the default process group; a no-op on a single host.

    ``coordinator_address`` is ``host:port`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size (default
    ``WORLD_SIZE``) and ``process_id`` this process's rank (default
    ``RANK``). With none of them given or set, or a world of one, nothing
    is done. ``backend`` defaults to ``nccl`` where CUDA is available and
    ``gloo`` on the CPU. A group that is already initialized is kept."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or not num_processes or num_processes <= 1:
        return
    if process_id is None:
        raise ValueError("a process group of several ranks needs process_id "
                         "(or RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port on ``host`` (bound to 0, then released), for the
    address of a process group started on this machine."""
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def per_host_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch that this process feeds."""
    idx, n = _rank_and_world()
    if global_batch % n:
        raise ValueError(
            f"global_batch={global_batch} is not divisible by the "
            f"{n} participating hosts — the tail samples would silently "
            f"never be fed; pad or trim the batch to a multiple of {n}")
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)

"""Process-group initialization (the port of
``rten_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize``, after which
``jax.devices()`` spans every process. The port's ranks are the processes
of one ``torch.distributed`` group, one device a rank: call
``init_distributed`` once in each process, then build meshes over the ranks
with ``parallel.make_mesh``.

Arguments left out are read from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``
through ``init_method="env://"``). The backend is the caller's choice:
``None`` means NCCL, and only where the card can give every rank of this
host a card of its own; anything else (two ranks on one card, where NCCL
refuses "Duplicate GPU detected", or no card at all) must name ``"gloo"``
itself. Nothing switches the backend quietly. The group's timeout is always
finite, so a rank that dies fails its peers' next collective instead of
hanging them.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it to init_distributed or run under torchrun")
    return int(os.environ[name])


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``, else
    the global rank modulo the host's cards)."""
    import torch.distributed as dist

    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return dist.get_rank() % n if n else dist.get_rank()


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join this process to the default process group.

    ``backend``: "nccl", "gloo", or None for NCCL where every rank of this
    host has a card of its own (else ValueError: name "gloo"). ``timeout``:
    seconds, finite."""
    import torch.distributed as dist

    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if init_method is None:
        init_method = "env://"
    if timeout is None or not 0 < float(timeout) < float("inf"):
        raise ValueError(f"the group's timeout must be finite and positive, got {timeout}")
    if backend is None:
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < ranks_here:
            raise ValueError(
                f"{ranks_here} ranks on this host and {cards} cards: NCCL needs a card a "
                f"rank; name the backend (backend='gloo') to share a card or run on the CPU")
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=float(timeout)))


def process_info():
    """The JAX package's keys: this process's index and the process count,
    its devices (one a rank) and every rank's."""
    import torch.distributed as dist

    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }

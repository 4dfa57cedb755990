"""The multi-process runtime: one process per GPU (the JAX package's
``dctseg/parallel/distributed.py``).

:func:`initialize` joins ``torch.distributed``: NCCL where the process
runs on a GPU, gloo on the CPU.  Its arguments come first; without them it
reads torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), as the JAX function reads
``JAX_COORDINATOR`` and its companions.  With neither it does nothing and
the program runs as one process.  Each process takes the GPU of its local
rank, ``cuda:{local_rank % device_count}``.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from dctseg_torch.utils.logging_utils import LOGGER

logger = logging.getLogger(LOGGER)

# how long a collective or a barrier waits for the other processes
TIMEOUT = timedelta(minutes=30)


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, backend: Optional[str] = None
               ) -> Optional[torch.device]:
    """Join the process group; returns this process's device, or None
    where there is nothing to join (one process).

    ``coordinator``: ``host:port`` of rank 0 (a TCP rendezvous), or any
    ``init_method`` URL (``tcp://...``, ``file://...``).  ``device``:
    'cuda' (the default) or 'cpu'.  ``backend`` defaults to NCCL on the
    GPU and gloo on the CPU."""
    env_addr = (f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
                if "MASTER_ADDR" in os.environ
                and "MASTER_PORT" in os.environ else None)
    explicit = coordinator or env_addr
    if not explicit and num_processes is None:
        return None
    if not explicit:
        raise ValueError("--num-processes without a coordinator address: "
                         "pass --coordinator host:port or set MASTER_ADDR "
                         "and MASTER_PORT")
    # `is not None`, not truthiness: process 0 passing --process-id 0 must
    # not fall through to a stale RANK in the environment
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    local = (int(os.environ["LOCAL_RANK"])
             if process_id is None and "LOCAL_RANK" in os.environ else rank)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    url = explicit if "://" in explicit else f"tcp://{explicit}"
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    # Make the backend's communicator now, while every process is still in
    # step from the rendezvous, rather than at the first training
    # all-reduce, which a slow first step on one rank can delay.
    warm = torch.ones(1, device=dev)
    dist.all_reduce(warm)
    if int(warm.item()) != world:
        raise RuntimeError(f"warm-up all-reduce gave {warm.item()}, "
                           f"expected {world}")
    logger.info("torch.distributed initialized: process %d/%d on %s (%s)",
                rank, world, dev, backend)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(name: str) -> None:
    """Every process waits here for the others (nothing with one)."""
    if world_size() <= 1:
        return
    logger.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def is_primary() -> bool:
    """The logging, output and checkpoint gate: rank 0, or the only
    process."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group (a driver's last step)."""
    if dist.is_initialized():
        dist.destroy_process_group()

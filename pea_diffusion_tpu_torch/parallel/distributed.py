"""Multi-process start-up (port of ``pea_diffusion_tpu/parallel/distributed.py``).

``initialize()`` joins this process to a ``torch.distributed`` process
group. With no address it reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): the
counterpart of a TPU pod's auto-discovery. With an address it meets the
other processes at ``tcp://<address>`` with the given size and rank (the JAX
CLI's ``--coordinator/--num-processes/--process-id``).

The backend is NCCL on a card and gloo on the CPU. ``PEA_DIST_BACKEND=gloo``
puts the ranks of a card on gloo instead: NCCL refuses two ranks on one
device, and gloo carries the collectives of CUDA tensors through the host
(``all_reduce`` and ``broadcast`` are what the tensor-parallel layers and the
data-parallel gradient reduce need). Under gloo more local ranks than cards
share them round robin.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# how long a collective waits for its peers before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda") -> None:
    """Starts the default process group (see the module's docstring) and,
    on a card, makes the rank's local card the current one. Raises if no
    process group can be made: it never carries on without one. A second
    call does nothing."""
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("initialize(device='cuda') but no CUDA device is available "
                           "(pass device='cpu' to run the ranks on the CPU)")
    backend = os.environ.get("PEA_DIST_BACKEND") or ("nccl" if cuda else "gloo")
    where = {}
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"initialize(): no coordinator address and {missing} unset: "
                               "launch under torchrun or pass coordinator_address, "
                               "num_processes and process_id")
        init_method, local = "env://", int(os.environ.get("LOCAL_RANK", "0"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method, local = f"tcp://{coordinator_address}", process_id
        where = {"world_size": num_processes, "rank": process_id}
    if cuda:
        n = torch.cuda.device_count()
        if local >= n and backend == "nccl":
            raise RuntimeError(f"local rank {local} but {n} CUDA device(s): NCCL takes one "
                               "rank a card (PEA_DIST_BACKEND=gloo shares the cards)")
        torch.cuda.set_device(local % n)
    dist.init_process_group(backend, init_method=init_method, timeout=TIMEOUT, **where)
    print(f"torch.distributed: process {dist.get_rank()}/{dist.get_world_size()} "
          f"local_devices={torch.cuda.device_count() if cuda else 1} backend={backend}",
          flush=True)


def is_main() -> bool:
    """True on rank 0, and in a process without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()

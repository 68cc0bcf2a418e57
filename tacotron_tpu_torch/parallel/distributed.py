"""Process-group initialization: the counterpart of
``tacotron_tpu/parallel/distributed.py``.

One process drives one device.  :func:`initialize` forms the
``torch.distributed`` process group the way ``jax.distributed.initialize``
forms the JAX one, and :mod:`.mesh` lays the ranks out as the
``(data, model)`` grid.  With no arguments it reads the environment a
``torchrun`` launch sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``):

    torchrun --nproc_per_node=N -m tacotron_tpu_torch.train --distributed ...

The backend is NCCL when the rank's device is a CUDA card and gloo on the
CPU.  Two ranks on one card need gloo (NCCL refuses a device twice in one
communicator), which ``backend="gloo"`` asks for.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_device: Optional[torch.device] = None


def local_device(device=None) -> torch.device:
    """The rank's device: ``device`` when given (a card without an index
    is ``cuda:LOCAL_RANK``), else the one :func:`initialize` recorded, else
    the card ``cuda:LOCAL_RANK``; raises when CUDA is absent (the CPU runs
    only when asked for)."""
    if device is None and _device is not None:
        return _device
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None, backend: Optional[str] = None) -> None:
    """Join the process group; a no-op for one process that was not asked
    for a group, and for a group that already exists.

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous.
    Without arguments the torchrun environment gives all three; without
    that either, the call does nothing.  ``device`` is the rank's device
    (default ``cuda:LOCAL_RANK``), ``backend`` overrides the choice of
    NCCL for a card and gloo for the CPU."""
    global _device
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" not in env:
        return
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    world = int(env["WORLD_SIZE"]) if num_processes is None \
        else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=world,
        rank=rank)
    _device = dev


def runtime_info() -> dict:
    """Process and device topology for logs, under the JAX keys."""
    on = dist.is_initialized()
    dev = _device if _device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if on else 1,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "backend": dist.get_backend() if on else None,
        "device": str(dev),
    }


def shutdown() -> None:
    """Leave the process group (if any) and forget the rank's device."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None

"""Joining a process to the process group of a sharded run.

Counterpart of ``dnmf_tpu/parallel/distributed.py``.  Every rank calls
:func:`initialize_distributed` once at start-up, before it builds an
engine with a mesh (``RuntimeConfig(mesh_time=..., mesh_pixel=...)``) or
calls :func:`~dnmf_tpu_torch.parallel.mesh.make_mesh`.  Under
``torchrun`` the arguments come from its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); otherwise pass
them.  The backend is ``nccl`` where CUDA is available and ``gloo`` on
the CPU, unless the caller names one: ranks that share one card (NCCL
refuses two ranks on one device) pass ``backend="gloo"`` and keep their
tensors on the card, and gloo moves them through the host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _init_method(address: Optional[str]) -> str:
    if address is None:
        return "env://"
    if "://" in address:  # tcp://host:port or file:///path
        return address
    return f"tcp://{address}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to the process group (once; a second call
    returns).

    Args:
      coordinator_address: ``"host:port"`` of rank 0 (or a
        ``tcp://``/``file://`` init URL); None reads ``torchrun``'s
        environment.
      num_processes: the world size (None: ``WORLD_SIZE``).
      process_id: this process's rank (None: ``RANK``).
      local_device_ids: the card(s) this process drives; the first
        becomes its current CUDA device (default: ``LOCAL_RANK``, else
        the rank modulo the cards of the host).
      backend: ``"nccl"``, ``"gloo"`` or None (``nccl`` with CUDA, else
        ``gloo``).
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    world = (int(num_processes) if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (int(process_id) if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if torch.cuda.is_available():
        if local_device_ids:
            local = int(local_device_ids[0])
        elif "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = rank % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=world, rank=rank)


def is_distributed() -> bool:
    """True when this process belongs to a process group of several
    ranks."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_summary() -> dict:
    """Small observability record for logs and metric sinks: the keys of
    the JAX package's (one device per rank here)."""
    group = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if group else 0,
        "process_count": dist.get_world_size() if group else 1,
        "local_device_count": local,
        "global_device_count": dist.get_world_size() if group else 1,
    }

"""Multi-process bootstrap on torch.distributed.

Counterpart of `safevla_tpu/parallel/distributed.py`. The JAX package
bootstraps one controller per host with `jax.distributed.initialize`; the
port runs one process per GPU (the reference's own layout: a TCP rendezvous
and torch.distributed, reference allenact_trainer.py:19-43), so this joins
the calling process to that group as one rank:

  * the coordinator comes from the arguments, else from the JAX package's
    env vars (SAFEVLA_COORDINATOR host:port, SAFEVLA_NUM_PROCESSES,
    SAFEVLA_PROCESS_ID), else from torchrun's (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE), where JAX would ask the Cloud TPU metadata server;
  * the rank's device is `cuda:(LOCAL_RANK % device_count)` unless the
    caller names one (two ranks may share a card);
  * the device group runs NCCL on a CUDA device and gloo on the CPU, or the
    backend asked for (gloo takes CUDA tensors for all_reduce and broadcast,
    the only device collectives the port issues; NCCL refuses two ranks on
    one card). NCCL is never swapped for gloo behind the caller's back: if it
    fails to initialise, this raises;
  * host objects (episode costs, metrics, barriers) go through a gloo group
    made beside the device group: NCCL takes no CPU tensors.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from safevla_tpu_torch import resolve_device

# what initialize_multihost set up for this process: "device", "cpu_group", "backend"
_STATE: dict = {}


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> dict:
    """Join this process to the run's process group as one rank.

    `device` is the rank's device ("cuda" picks the card from LOCAL_RANK,
    else the process id); `backend` None is NCCL on a CUDA device and gloo
    on the CPU; `timeout_s` bounds every collective (torch's default else).
    Returns the JAX function's dict: process_index, process_count,
    local_devices (1: a process drives one device) and global_devices (the
    ranks)."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised in this process")
    coordinator_address = coordinator_address or os.environ.get("SAFEVLA_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SAFEVLA_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SAFEVLA_PROCESS_ID")
    if coordinator_address or num_processes:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError(
                "a SAFEVLA coordinator needs all of coordinator_address, num_processes and "
                f"process_id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}"
            )
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                "no coordinator: pass coordinator_address / num_processes / process_id, set "
                f"SAFEVLA_COORDINATOR / SAFEVLA_NUM_PROCESSES / SAFEVLA_PROCESS_ID, or run under "
                f"torchrun (missing {missing})"
            )
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank

    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    timeout = datetime.timedelta(seconds=timeout_s) if timeout_s else None
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank, timeout=timeout, **kwargs
    )
    cpu_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    _STATE.update(device=device, cpu_group=cpu_group, backend=backend)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def shutdown_multihost() -> None:
    """Leave the process group initialize_multihost joined."""
    _STATE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary_host() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_state() -> dict:
    """The rank's device, host group and backend (initialize_multihost's)."""
    if not _STATE:
        raise RuntimeError("call initialize_multihost() first")
    return dict(_STATE)

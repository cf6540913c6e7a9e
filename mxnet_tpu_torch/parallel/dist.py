"""The multi-process runtime on ``torch.distributed``.

Counterpart of ``mxnet_tpu/parallel/dist.py`` (reference: ps-lite's
process fabric, the dmlc launcher's environment). :func:`init` forms one
process group from the same environment the JAX package reads:
``MXNET_TPU_COORDINATOR`` (``host:port`` of rank 0's rendezvous, or a
``file://`` path all ranks share),
``MXNET_TPU_NUM_PROCS`` and ``MXNET_TPU_PROC_ID``, which ``tools/launch.py
--launcher local`` sets; once a coordinator is named, a resource
manager's variables (OpenMPI, MPICH, SLURM, SGE array tasks) fill in the
rank and world size. With nothing configured it runs single-process, as
the JAX package does: :func:`rank` 0, :func:`size` 1, :func:`barrier` a
no-op.

The backend is ``nccl`` for a CUDA device and ``gloo`` on the CPU; the
caller may name it (``init(backend="gloo", device="cuda")`` reduces CUDA
tensors through gloo, which one card shared by two ranks needs: NCCL
refuses two ranks on one GPU). ``device`` None is the first card (it
raises without one) unless the backend is ``gloo``, which needs none.

There are no server processes here: the parameter server is
``kvstore_server``. A failed rank aborts the collectives of the others
(``torch.distributed`` has no degraded mode), so :func:`dead_nodes` is
empty and :func:`is_recovery` False, as the JAX package's are without a
fault plan (``resilience`` is not ported).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as _td

_initialized = False
_backend: Optional[str] = None
_device: Optional[torch.device] = None


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None,
         device=None, timeout_s: float = 300.0):
    """Join the process group (idempotent). Resolution order: the
    arguments, then ``MXNET_TPU_*``, then (with a coordinator named) the
    resource manager's variables. Single-process when no coordinator is
    named and the world is 1."""
    global _initialized, _backend, _device
    if _initialized:
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("MXNET_TPU_COORDINATOR")
                           or None)  # an empty string counts as unset
    if num_processes is None and os.environ.get("MXNET_TPU_NUM_PROCS"):
        num_processes = int(os.environ["MXNET_TPU_NUM_PROCS"])
    if process_id is None and os.environ.get("MXNET_TPU_PROC_ID"):
        process_id = int(os.environ["MXNET_TPU_PROC_ID"])
    if (coordinator_address is not None
            and (process_id is None or num_processes is None)):
        # a resource manager's variables only fill in rank and world once
        # a coordinator is named: alone they must not turn a plain run
        # into one that waits for peers nobody started
        rank_id, world = _resource_manager_rank()
        if process_id is None:
            process_id = rank_id
        if num_processes is None:
            num_processes = world
    if coordinator_address is None and num_processes in (None, 1):
        _initialized = True  # single-process
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("dist.init: %d processes need a coordinator "
                         "address and this process's id"
                         % (num_processes or 0))
    from ..context import resolve_device

    # gloo needs no device; any other backend runs on the card unless the
    # caller names the CPU
    dev = resolve_device(device) if device is not None or backend != "gloo" \
        else torch.device("cpu")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _td.init_process_group(
        backend=backend, init_method=(coordinator_address if "://" in coordinator_address
                     else "tcp://" + coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=timeout_s))
    _backend, _device, _initialized = backend, dev, True


def shutdown():
    """Leave the process group (a no-op single-process); :func:`init` may
    then form another."""
    global _initialized, _backend, _device
    if _td.is_initialized():
        _td.destroy_process_group()
    _initialized, _backend, _device = False, None, None


def _resource_manager_rank():
    """(rank, world) from the resource manager that started this process:
    OpenMPI (OMPI_COMM_WORLD_*), MPICH / hydra (PMI_*), SLURM
    (SLURM_PROCID / SLURM_NTASKS), SGE array jobs (SGE_TASK_ID, 1-based,
    with first / step / last). (None, None) when none applies."""
    env = os.environ
    if "OMPI_COMM_WORLD_RANK" in env:
        return (int(env["OMPI_COMM_WORLD_RANK"]),
                int(env.get("OMPI_COMM_WORLD_SIZE", "1")))
    if "PMI_RANK" in env:
        return int(env["PMI_RANK"]), int(env.get("PMI_SIZE", "1"))
    if "SLURM_PROCID" in env:
        return (int(env["SLURM_PROCID"]),
                int(env.get("SLURM_NTASKS", "1")))
    if "SGE_TASK_ID" in env and env["SGE_TASK_ID"].isdigit():
        first = int(env.get("SGE_TASK_FIRST", "1"))
        step = int(env.get("SGE_TASK_STEPSIZE", "1") or "1")
        last = int(env.get("SGE_TASK_LAST", env["SGE_TASK_ID"]))
        return ((int(env["SGE_TASK_ID"]) - first) // step,
                (last - first) // step + 1)
    return None, None


def is_distributed() -> bool:
    """Whether a process group is formed (a world of one included)."""
    return _td.is_available() and _td.is_initialized()


def backend() -> Optional[str]:
    """The group's backend ("nccl" / "gloo"), None single-process."""
    return _backend if is_distributed() else None


def rank() -> int:
    """This process's rank (reference KVStore::get_rank)."""
    return _td.get_rank() if is_distributed() else 0


def size() -> int:
    """The world size (reference KVStore::get_group_size)."""
    return _td.get_world_size() if is_distributed() else 1


def barrier(name: str = "barrier"):
    """Every rank reaches this point (reference Barrier); a no-op
    single-process."""
    del name
    if is_distributed():
        if _backend == "nccl":
            _td.barrier(device_ids=[_device.index or 0])
        else:
            _td.barrier()


def _staged(tensor: torch.Tensor, op):
    """``op`` on ``tensor`` in place; NCCL reduces device memory only, so
    a host tensor goes through the group's card and back."""
    if _backend == "nccl" and tensor.device.type != "cuda":
        tmp = tensor.to(_device)
        op(tmp)
        tensor.copy_(tmp)
    else:
        op(tensor)
    return tensor


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place (identity single-process).
    Every rank ends with the same bits. gloo reduces a CUDA tensor where
    it lies."""
    if is_distributed():
        _staged(tensor, lambda t: _td.all_reduce(t, op=_td.ReduceOp.SUM))
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``src``'s ``tensor`` on every rank, in place."""
    if is_distributed() and size() > 1:
        _staged(tensor, lambda t: _td.broadcast(t, src=src))
    return tensor


def dead_nodes(step: Optional[int] = None) -> set:
    """Ranks considered dead: none (a failed rank aborts the group's
    collectives; the parameter server's ``num_dead_node`` sees real
    deaths)."""
    del step
    return set()


def num_dead_nodes(timeout_s: float = 0.0) -> int:
    """Count of :func:`dead_nodes` (``timeout_s``, the JAX package's probe
    window, has nothing to wait for)."""
    del timeout_s
    return len(dead_nodes())


def is_recovery() -> bool:
    """Recovery flag (reference ps::Postoffice::is_recovery): a restarted
    collective job resumes from its checkpoints, never rejoins live."""
    return False

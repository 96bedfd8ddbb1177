"""Joining the ``torch.distributed`` world (port of
``deepspeed_tpu/utils/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` from its launcher's
environment; the port calls ``torch.distributed.init_process_group``
from the same environment, or from torchrun's:

- the launcher's ``DS_COORDINATOR`` (``host:port``),
  ``DS_NUM_PROCESSES``, ``DS_PROCESS_ID`` and ``DS_LOCAL_RANK`` (the
  JAX launcher's and the port's,
  :mod:`deepspeed_tpu_torch.launcher`), with the MPI library's
  rank and size variables for ranks that ``mpirun`` starts (JAX
  ``distributed.py:20-45``);
- torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
  and ``MASTER_PORT``.

An explicit ``init_method`` (a ``file://`` store, or ``tcp://``) with
``world_size`` and ``rank`` takes the place of both.  The backend
follows the device: NCCL for the card, gloo when the caller asks for
the CPU (``device="cpu"``); nothing switches backend on its own.
Without any of these a single process needs no process group, and
:func:`init_distributed` does nothing.
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# mpirun-scheduled ranks (JAX distributed.py:16-22), most specific first
_MPI_RANK_VARS = ("OMPI_COMM_WORLD_RANK", "MV2_COMM_WORLD_RANK", "PMI_RANK")
_MPI_SIZE_VARS = ("OMPI_COMM_WORLD_SIZE", "MV2_COMM_WORLD_SIZE", "PMI_SIZE")
_MPI_LOCAL_RANK_VARS = ("OMPI_COMM_WORLD_LOCAL_RANK",
                        "MV2_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID")
DEFAULT_TIMEOUT_SECS = 600.0


def _first_env(names):
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def _resolve_env(mpi=True):
    """``(init_method, world_size, rank)`` from the environment: the
    JAX launcher's ``DS_*`` contract, then torchrun's, then (for the
    rank and size) MPI's.  Any of the three may be None."""
    coordinator = os.environ.get("DS_COORDINATOR")
    world = _first_env(("DS_NUM_PROCESSES", "WORLD_SIZE"))
    rank = _first_env(("DS_PROCESS_ID", "RANK"))
    if mpi:
        world = world if world is not None else _first_env(_MPI_SIZE_VARS)
        rank = rank if rank is not None else _first_env(_MPI_RANK_VARS)
    if coordinator:
        method = f"tcp://{coordinator}"
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        method = "env://"
    else:
        method = None
    return method, world, rank


def backend_for(device):
    """NCCL for a CUDA device (``None`` means the card), gloo for the
    CPU."""
    device = torch.device(device) if device is not None else None
    return "gloo" if device is not None and device.type == "cpu" else "nccl"


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     init_method=None, world_size=None, rank=None,
                     timeout=None, device=None, verbose=True):
    """Join the process group the environment or the arguments describe;
    a no-op when one is already up or when nothing describes one (one
    process).  ``dist_backend`` defaults to :func:`backend_for`
    ``(device)``; ``timeout`` (seconds) bounds every collective and the
    rendezvous, default 600.  Under NCCL the rank's card (``device``'s
    index, else ``cuda:LOCAL_RANK``) becomes the current device and the
    group's own, so nothing that takes the current device lands on card
    0.  Returns True when a group is up."""
    if dist.is_initialized():
        return True
    env_method, env_world, env_rank = _resolve_env(mpi=auto_mpi_discovery)
    init_method = init_method or env_method
    world_size = world_size if world_size is not None else env_world
    rank = rank if rank is not None else env_rank
    if init_method is None:
        if world_size not in (None, 1):
            raise RuntimeError(
                f"a world of {world_size} processes needs a rendezvous: set "
                f"MASTER_ADDR/MASTER_PORT or DS_COORDINATOR, or pass "
                f"init_method")
        return False
    if world_size is None or rank is None:
        raise RuntimeError(f"init_method {init_method!r} needs the world "
                           f"size and this process's rank")
    backend = dist_backend or backend_for(device)
    if verbose:
        logger.info("torch.distributed: %s, rank %d of %d, %s", backend,
                    rank, world_size, init_method)
    secs = DEFAULT_TIMEOUT_SECS if timeout is None else float(timeout)
    kwargs = {}
    if backend == "nccl":
        card = torch.device(device) if device is not None else None
        if card is None or card.index is None:
            card = torch.device("cuda", get_local_rank())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=datetime.timedelta(seconds=secs),
                            **kwargs)
    return True


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank():
    """This process's index among the ranks of its host, the card it
    binds under NCCL: torchrun's ``LOCAL_RANK`` (which the port's
    launcher exports too), the JAX launcher's ``DS_LOCAL_RANK`` (the
    hostfile slot), MPI's local rank, else 0."""
    local = _first_env(("LOCAL_RANK", "DS_LOCAL_RANK",
                        *_MPI_LOCAL_RANK_VARS))
    return 0 if local is None else local


def fleet_identity():
    """``(rank, size)`` of this process in its fleet: the launcher's
    ``DS_PROCESS_ID`` and ``DS_NUM_PROCESSES`` where it set them (a fleet
    of full replicas runs each process without a process group), else
    the process group's rank and world size."""
    rank = os.environ.get("DS_PROCESS_ID", "")
    size = os.environ.get("DS_NUM_PROCESSES", "")
    return (int(rank) if rank else get_rank(),
            int(size) if size else get_world_size())

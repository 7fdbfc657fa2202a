"""The data axis of the JAX package's mesh, on torch.distributed.

The JAX package spreads a global batch over the ``data`` mesh axis and
GSPMD sums the gradients over it. Here each process owns one device
(a GPU, or the CPU when asked for by name) and its slice of the global
batch, and the collectives are explicit:

- ``init_distributed`` forms the group: ``tcp://host:port`` from the
  coordinator flags, or ``env://`` (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them) when they are
  not given, the counterpart of ``jax.distributed.initialize()`` with no
  arguments. NCCL for a CUDA device, gloo for the CPU, unless the caller
  names a backend; a failed init raises.
- ``rank`` / ``world_size`` (0 and 1 without a group); the collectives
  do nothing without a group and run at any size with one (NCCL at
  world size 1 leaves every bit as it is: counts travel exactly, a sum
  over one rank is a copy).
- ``all_reduce_sum_`` sums a list of tensors over the ranks in place,
  through one flat buffer (the gradients: one coalesced collective);
  ``broadcast_`` copies rank 0's tensors to every rank the same way.
- ``all_reduce_sum`` of a few Python numbers in float64 (the JAX
  evaluators' ``_allgather_sum``), ``sum_over_ranks`` of a small tensor
  (the losses' denominators), ``broadcast_scalar`` (``broadcast_one_to_all``),
  ``barrier``, ``destroy``.

The collectives act on torch.distributed's default group; small values
travel on the rank's GPU under NCCL, on the CPU under gloo. The JAX
mesh's model, expert, pipe and seq axes are not ported yet (their ``cli
train`` flags raise).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nabu_tpu_torch.device import resolve_device


def in_group() -> bool:
    """Whether this process belongs to a group (the collectives below do
    nothing without one, and run at any world size with one)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(process_id: int) -> torch.device:
    """The GPU of a rank: ``cuda:$LOCAL_RANK`` where torchrun sets it,
    else ``cuda:{process_id % device_count}`` (a cluster file lists a
    host with k cards k times, its processes in line order)."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        resolve_device("cuda")  # raises without a GPU
        local = process_id % torch.cuda.device_count()
    return resolve_device(f"cuda:{int(local)}")


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group; -> this rank's device. ``device`` "cpu"
    trains on the CPU (gloo); None or "cuda" takes the rank's GPU
    (``rank_device``); "cuda:i" that GPU."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        host_port = coordinator.split("://", 1)[-1]
        kwargs = {"init_method": f"tcp://{host_port}", "world_size": num_processes,
                  "rank": process_id}
    else:
        kwargs = {"init_method": "env://"}
        process_id = int(os.environ.get("RANK", 0))
    dev = torch.device(device) if device is not None else None
    if dev is None or (dev.type == "cuda" and dev.index is None):
        dev = rank_device(process_id)
    else:
        dev = resolve_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kwargs)
    return dev


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _small_device() -> torch.device:
    """Where small values travel: the rank's GPU under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"one flat buffer holds one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.detach().reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce_sum_(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, through one flat buffer
    (one collective). Every rank ends with the same bits."""
    if not in_group() or not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    _unflat_(flat, tensors)


def broadcast_(tensors: List[torch.Tensor]) -> None:
    """Rank 0's tensors to every rank, in place, through one flat buffer."""
    if not in_group() or not tensors:
        return
    flat = _flat(tensors)
    dist.broadcast(flat, src=0)
    _unflat_(flat, tensors)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """A small tensor summed over the ranks (float64 on the wire, back
    in its own dtype): exact for the counts it carries. Returned as given
    without a group."""
    if not in_group():
        return t
    buf = t.detach().to(torch.float64).clone()
    dist.all_reduce(buf)
    return buf.to(t.dtype)


def all_reduce_sum(values: Sequence[float]) -> Tuple[float, ...]:
    """Python numbers summed over the ranks in float64; the same tuple
    on every rank. Returned as given without a group."""
    if not in_group():
        return tuple(values)
    buf = torch.tensor([float(v) for v in values], dtype=torch.float64,
                       device=_small_device())
    dist.all_reduce(buf)
    return tuple(float(v) for v in buf.cpu())


def broadcast_scalar(value: float) -> float:
    """Rank 0's number on every rank (float64)."""
    if not in_group():
        return value
    buf = torch.tensor([float(value)], dtype=torch.float64, device=_small_device())
    dist.broadcast(buf, src=0)
    return float(buf.cpu()[0])


def barrier() -> None:
    """Every rank waits for the others (a one-number all-reduce, which
    needs no device argument under NCCL)."""
    all_reduce_sum((0.0,))
